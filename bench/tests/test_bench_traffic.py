"""Traffic is a function of the seed: the same seed gives the same
inputs, another seed other contents over the same sizes."""
import numpy as np
import torch

from bench.drivers import serve_wave, train_step
from bench.tests import tiny
from bench.work import tokens


def test_token_stream_is_the_ports():
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, sample_tokens
    cfg = get_config("olmoe-1b-7b")
    for seed in (0, 2 ** 31 + 5):
        want = sample_tokens(DataConfig(seed=seed), cfg, 3, 2, 300)
        got = tokens.sample_tokens(seed, cfg.raw_vocab_size, 3, 2, 300)
        assert np.array_equal(want, got)


def test_train_batches_follow_the_seed():
    _, a = tiny.context("olmoe-train-2k", seed=2 ** 32 + 3)
    _, b = tiny.context("olmoe-train-2k", seed=2 ** 32 + 4)
    x, y = train_step.batch(a, 1), train_step.batch(a, 1)
    assert torch.equal(x["tokens"], y["tokens"])
    assert torch.equal(x["targets"][:, :-1], x["tokens"][:, 1:])
    assert not torch.equal(x["tokens"], train_step.batch(b, 1)["tokens"])
    assert not torch.equal(x["tokens"], train_step.batch(a, 2)["tokens"])


def test_waves_keep_their_sizes_and_follow_the_seed():
    _, a = tiny.context("olmoe-code", seed=2 ** 33 + 1)
    _, b = tiny.context("olmoe-code", seed=7)
    sizes = serve_wave.wave_sizes(a.traffic)
    assert sizes == serve_wave.wave_sizes(b.traffic)
    lo, hi = a.traffic["lengths"]["lo"], a.traffic["lengths"]["hi"]
    assert all(lo <= n <= hi for w in sizes for n in w)
    w1, w2 = (serve_wave.make_wave(a, 5, sizes) for _ in range(2))
    w3 = serve_wave.make_wave(b, 5, sizes)
    m = a.traffic["pad_multiple"]
    assert w1["p"] == max(w1["lens"]) if max(w1["lens"]) <= m else \
        w1["p"] % m == 0
    assert all(np.array_equal(p, q) for p, q in zip(w1["prompts"],
                                                    w2["prompts"]))
    assert w1["lens"] == w3["lens"]
    assert not all(np.array_equal(p, q) for p, q in zip(w1["prompts"],
                                                        w3["prompts"]))
    for p, n in zip(w1["prompts"], w1["lens"]):
        assert (p[:len(p) - n] == 0).all() and (p[len(p) - n:] >= 2).all()


def test_patches_follow_the_seed():
    _, a = tiny.context("pixtral-vqa", seed=2 ** 33 + 1)
    _, b = tiny.context("pixtral-vqa", seed=2 ** 33 + 2)
    x = serve_wave.patches(a, 3, 2)
    assert torch.equal(x, serve_wave.patches(a, 3, 2))
    assert not torch.equal(x, serve_wave.patches(b, 3, 2))
    assert not torch.equal(x, serve_wave.patches(a, 4, 2))


def test_weights_follow_the_seed_in_the_ports_layout():
    from repro_torch import tree
    from repro_torch.models import init_model
    from bench.core import weights
    for wl in ("olmoe-train-2k", "pixtral-vqa"):
        _, ctx = tiny.context(wl, dtype="bfloat16")
        mine = weights.make_params(ctx.c, ctx.seed, "cpu")
        again = weights.make_params(ctx.c, ctx.seed, "cpu")
        other = weights.make_params(ctx.c, ctx.seed + 1, "cpu")
        ports = init_model(ctx.model_config(), seed=0, device="cpu")
        shape = lambda t: [(k, tuple(v.shape), v.dtype)
                           for k, v in tree.leaves_with_paths(t)]
        assert shape(mine) == shape(ports)
        assert all(torch.equal(a, b) for a, b in zip(tree.leaves(mine),
                                                     tree.leaves(again)))
        assert not torch.equal(mine["embed"], other["embed"])


def test_sorted_waves_hold_prompts_of_like_length():
    """The code mix's cycle is its sorted lengths cut into waves, served in
    an order drawn from the file: the same lengths as unsorted, far less
    padding, and no order by size."""
    import json
    from bench.core import harness
    t = json.loads((harness.BENCH / "traffic" / "azure-code.json"
                    ).read_text())
    sizes = serve_wave.wave_sizes(t)
    plain = serve_wave.wave_sizes(dict(t, sorted_waves=False))
    flat = sorted(n for w in sizes for n in w)
    assert flat == sorted(n for w in plain for n in w)
    pad = lambda ws: 1 - sum(map(sum, ws)) / sum(
        serve_wave.padded(t, w) * len(w) for w in ws)
    assert pad(sizes) < 0.25 < 0.4 < pad(plain)
    firsts = [min(w) for w in sizes]
    assert firsts != sorted(firsts) and firsts != sorted(firsts)[::-1]
    runs = sorted((sorted(w) for w in sizes), key=lambda w: (w[0], w[-1]))
    assert [n for w in runs for n in w] == flat     # waves cut from a sort
