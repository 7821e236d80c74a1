"""The port's LM serving path against the JAX reference, at smoke size in
float32 on the CPU: configs, layers, prefill logits and caches, chained
decode steps and ``ServeEngine`` waves, with the reference's weights carried
over by ``lm_params_from_numpy``.  Attention, the mLSTM and the Mamba scan
run through the kernels' plain versions here (the wrappers take them for
CPU tensors).  xlstm-350m's states and logits are held at 2e-4, the
reference's tolerance between two chunkwise forms of the mLSTM
(``tests/test_kernels.py:101``): its 16 recurrent layers carry each layer's
summation-order differences into the next.  jamba-v0.1-52b (16 smoke
layers: Mamba, attention, MoE and dense FFNs) is held at 2e-4 too: the
reference's model runs an associative scan where the port runs the strict
recurrence, the pair ``tests/test_new_substrate.py:51-52`` holds at 2e-4
(a value cached after 12 layers differs by 1.4e-5).  olmoe-1b-7b and
arctic-480b (attention with MoE, arctic's beside a dense FFN) are held at
1e-5, and so are whisper-medium (its encoder over the batch's frames, the
decoder's cross-attention, sinusoidal positions) and pixtral-12b (its
patches in front of the tokens, so the text decodes from n_patches + P)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import decode_step as ref_decode_step
from repro.models import init_model as ref_init_model
from repro.models import layers as ref_layers
from repro.models import param_count as ref_param_count
from repro.models import prefill as ref_prefill
from repro.serve.engine import Request as RefRequest
from repro.serve.engine import ServeEngine as RefServeEngine
from repro_torch.configs import get_config, list_archs, smoke_config
from repro_torch.convert import lm_cache_from_numpy, lm_params_from_numpy
from repro_torch.models import (apply_model, decode_step, frontend_input,
                                init_cache, init_model, param_count, prefill)
from repro_torch.models import layers
from repro_torch.models.transformer import cache_seq_len, pad_cache_to
from repro_torch.serve.engine import Request, ServeEngine

TOL = 1e-5
SSM_TOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the smoke configs' ops are small, and test
    processes sharing a host's cores slow one another down with full
    pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _extras(cfg, b, seed=11):
    """The stub frontend's inputs of a batch of ``b`` (the audio family's
    frames, the vlm's patches; float32 numpy, times 0.1 as the pipeline
    draws them), and the text's first position (n_patches for a vlm)."""
    fe = frontend_input(cfg)
    if fe.name is None:
        return {}, 0
    x = 0.1 * np.random.RandomState(seed).randn(b, fe.rows, cfg.d_model)
    return {fe.name: x.astype(np.float32)}, fe.text_offset


def _batches(tokens, extras):
    """The same batch for the port (tensors) and the reference (jnp)."""
    both = dict(extras, tokens=tokens)
    return ({k: torch.tensor(v) for k, v in both.items()},
            {k: jnp.asarray(v) for k, v in both.items()})


def _cfg(name):
    """A smoke config; "gemma2-2b-window" narrows gemma2's window to 5 so
    that it clips inside the test's sequences."""
    if name == "gemma2-2b-window":
        return dataclasses.replace(smoke_config(get_config("gemma2-2b")),
                                   sliding_window=5)
    return smoke_config(get_config(name))


def _ref_cfg(cfg):
    """The reference's ModelConfig with the same fields."""
    from repro.configs.base import ModelConfig
    return ModelConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("arch", list_archs())
def test_configs_equal_reference(arch):
    ref = ref_get_config(arch)
    from repro.configs import smoke_config as ref_smoke
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(ref)
    assert dataclasses.asdict(smoke_config(get_config(arch))) == \
        dataclasses.asdict(ref_smoke(ref))
    cfg = get_config(arch)
    assert [cfg.layer_kind(i) for i in range(cfg.n_layers)] == \
        [ref.layer_kind(i) for i in range(ref.n_layers)]
    assert [cfg.ffn_kind(i) for i in range(cfg.n_layers)] == \
        [ref.ffn_kind(i) for i in range(ref.n_layers)]


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "gemma2-2b"])
def test_layers_match_reference(arch):
    cfg = smoke_config(get_config(arch))
    rng = np.random.RandomState(0)
    x = rng.randn(2, 7, cfg.d_model).astype(np.float32)
    scale = (0.1 * rng.randn(cfg.d_model)).astype(np.float32)
    np.testing.assert_allclose(
        layers.rms_norm(torch.tensor(x), torch.tensor(scale), 1e-6).numpy(),
        np.asarray(ref_layers.rms_norm(jnp.asarray(x), jnp.asarray(scale),
                                       1e-6)), atol=TOL, rtol=TOL)
    qh = rng.randn(2, 7, 4, 16).astype(np.float32)
    positions = np.tile(np.arange(7) * 3, (2, 1))
    np.testing.assert_allclose(
        layers.apply_rope(torch.tensor(qh), torch.tensor(positions),
                          1e6).numpy(),
        np.asarray(ref_layers.apply_rope(jnp.asarray(qh),
                                         jnp.asarray(positions), 1e6)),
        atol=TOL, rtol=TOL)
    ffn_p = {k: (rng.randn(*s) / np.sqrt(s[0])).astype(np.float32)
             for k, s in (("w_gate", (cfg.d_model, cfg.d_ff)),
                          ("w_up", (cfg.d_model, cfg.d_ff)),
                          ("w_down", (cfg.d_ff, cfg.d_model)))}
    got = layers.ffn({k: torch.tensor(v) for k, v in ffn_p.items()}, cfg,
                     torch.tensor(x))
    ref = ref_layers.ffn({k: jnp.asarray(v) for k, v in ffn_p.items()},
                         _ref_cfg(cfg), jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)


MOE_ARCHS = ["jamba-v0.1-52b", "olmoe-1b-7b", "arctic-480b"]


@pytest.fixture(scope="module", params=["qwen3-0.6b", "gemma2-2b",
                                        "gemma2-2b-window", "xlstm-350m"]
                + MOE_ARCHS + ["whisper-medium", "pixtral-12b"])
def pair(request):
    """(cfg, port params, reference cfg, reference params) for one arch."""
    cfg = _cfg(request.param)
    rcfg = _ref_cfg(cfg)
    rparams = ref_init_model(jax.random.PRNGKey(0), rcfg)
    params = lm_params_from_numpy(_np_tree(rparams), cfg, device="cpu")
    return cfg, params, rcfg, rparams


def _tol(cfg):
    """1e-5 for attention-only models, 2e-4 for those with a scan."""
    scans = any(cfg.layer_kind(i) in ("mamba", "mlstm", "slstm")
                for i in range(cfg.n_layers))
    return SSM_TOL if scans else TOL


def test_prefill_and_decode_match_reference(pair):
    """Prefill logits and every layer's cache entry (K/V and whisper's
    encoder ck/cv, or the mLSTM's C, n, m and the sLSTM's h, c, n, m), then
    chained decode steps."""
    cfg, params, rcfg, rparams = pair
    tol = _tol(cfg)
    b, p, n_new, cache_len = 2, 11, 4, 20
    toks = np.random.RandomState(1).randint(0, cfg.raw_vocab_size,
                                            (b, p + n_new))
    extras, off = _extras(cfg, b)
    batch, rbatch = _batches(toks[:, :p], extras)
    logits, cache = prefill(params, cfg, batch, cache_len=cache_len + off)
    rlogits, rcache = ref_prefill(rparams, rcfg, rbatch,
                                  cache_len=cache_len + off)
    np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits), atol=tol,
                               rtol=tol)
    ref_layers_cache = lm_cache_from_numpy(_np_tree(rcache), cfg, "cpu")
    assert len(cache["layers"]) == cfg.n_layers
    assert cache_seq_len(cfg, cache) == \
        (cache_len + off if cfg.has_attention() else 0)
    attn = {"k", "v", "ck", "cv"} if cfg.family == "audio" else {"k", "v"}
    entry_keys = {"attn": attn, "attn_local": attn,
                  "mamba": {"h", "conv"}, "mlstm": {"C", "n", "m"},
                  "slstm": {"h", "c", "n", "m"}}
    for i, (got, ref) in enumerate(zip(cache["layers"],
                                       ref_layers_cache["layers"])):
        assert set(got) == set(ref) == entry_keys[cfg.layer_kind(i)]
        for key in got:
            assert got[key].shape == ref[key].shape
            np.testing.assert_allclose(got[key].numpy(), ref[key].numpy(),
                                       atol=tol, rtol=tol)
    for t in range(n_new):
        tok = toks[:, p + t:p + t + 1]
        logits, cache = decode_step(params, cfg, cache, torch.tensor(tok),
                                    off + p + t)
        rlogits, rcache = ref_decode_step(rparams, rcfg, rcache,
                                          jnp.asarray(tok),
                                          jnp.int32(off + p + t))
        np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits),
                                   atol=tol, rtol=tol)


def test_decode_from_reference_cache(pair):
    """The reference's prefill cache, converted, feeds the port's
    ``decode_step`` to the reference's logits."""
    cfg, params, rcfg, rparams = pair
    toks = np.random.RandomState(2).randint(0, cfg.raw_vocab_size, (2, 9))
    extras, off = _extras(cfg, 2, seed=12)
    _, rcache = ref_prefill(rparams, rcfg, _batches(toks[:, :8], extras)[1],
                            cache_len=12 + off)
    cache = lm_cache_from_numpy(_np_tree(rcache), cfg, "cpu")
    logits, _ = decode_step(params, cfg, cache, torch.tensor(toks[:, 8:]),
                            8 + off)
    rlogits, _ = ref_decode_step(rparams, rcfg, rcache,
                                 jnp.asarray(toks[:, 8:]), jnp.int32(8 + off))
    np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits),
                               atol=_tol(cfg), rtol=_tol(cfg))


def _ref_greedy_chain(rparams, rcfg, toks, extras, off, n, max_len):
    """Greedy tokens of a left-padded wave through the reference's
    ``prefill`` and ``decode_step`` at ``off + P + t``: the engine's loop
    with the reference model's positions."""
    logits, cache = ref_prefill(rparams, rcfg, _batches(toks, extras)[1],
                                cache_len=max_len)
    tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    out = [np.asarray(tok)[:, 0]]
    for t in range(n - 1):
        logits, cache = ref_decode_step(rparams, rcfg, cache, tok,
                                        jnp.int32(off + toks.shape[1] + t))
        tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
        out.append(np.asarray(tok)[:, 0])
    return np.stack(out, axis=1)


def test_serve_wave_matches_reference_tokens(pair):
    """The prompts of ``tests/test_runner_integration.py``'s serve test.
    whisper's frames go to both engines as ``extras``.  pixtral's tokens
    equal a greedy chain through the reference's model decoding from
    n_patches + P (its engine decodes at P, over the patch rows: ROADMAP
    queue 3's findings about the reference)."""
    cfg, params, rcfg, rparams = pair
    prompts = [(np.arange(5) + 2, 4), (np.arange(9) + 2, 6)]
    reqs = [Request(prompt=p, max_new_tokens=n) for p, n in prompts]
    extras, off = _extras(cfg, len(prompts), seed=13)
    stats = ServeEngine(cfg, params, max_len=48, device="cpu").serve_wave(
        reqs, extras)
    if cfg.family == "vlm":
        toks = np.zeros((2, 9), np.int64)
        for i, (p, _) in enumerate(prompts):
            toks[i, 9 - len(p):] = p
        chain = _ref_greedy_chain(rparams, rcfg, toks, extras, off, 6, 48)
        want = [list(chain[i, :n]) for i, (_, n) in enumerate(prompts)]
    else:
        rreqs = [RefRequest(prompt=p, max_new_tokens=n) for p, n in prompts]
        rstats = RefServeEngine(rcfg, rparams, max_len=48).serve_wave(
            rreqs, extras or None)
        want = [r.out_tokens for r in rreqs]
        assert rstats.tokens_out == 10
    assert [r.out_tokens for r in reqs] == want
    assert stats.tokens_out == 10
    assert stats.decode_steps == 6
    assert all(0 <= t < cfg.vocab_size for r in reqs for t in r.out_tokens)


def test_reference_engine_decodes_vlm_over_its_patch_rows():
    """ROADMAP queue 3's finding: the reference's engine decodes a vlm
    wave at P (``repro/serve/engine.py:71``), over the patch rows its
    prefill put first, so its tokens leave the greedy chain of its own
    ``forward``; the port's engine, from the same weights and patches,
    follows that chain (decoding from n_patches + P)."""
    from repro.models import apply_model as ref_apply_model
    cfg = _cfg("pixtral-12b")
    rcfg = _ref_cfg(cfg)
    rparams = ref_init_model(jax.random.PRNGKey(0), rcfg)
    params = lm_params_from_numpy(_np_tree(rparams), cfg, device="cpu")
    prompt = np.arange(12) + 2
    patches = np.asarray(jax.random.normal(
        jax.random.PRNGKey(1), (1, cfg.n_patches, cfg.d_model)))
    toks, forward = list(prompt), []
    for _ in range(4):
        logits, _ = ref_apply_model(rparams, rcfg, {
            "tokens": jnp.asarray([toks]), "patches": jnp.asarray(patches)})
        forward.append(int(jnp.argmax(logits[0, -1])))
        toks.append(forward[-1])
    chain = _ref_greedy_chain(rparams, rcfg, prompt[None],
                              {"patches": patches}, cfg.n_patches, 4, 40)
    rreq = RefRequest(prompt=prompt, max_new_tokens=4)
    RefServeEngine(rcfg, rparams, max_len=40).serve_wave(
        [rreq], {"patches": patches})
    req = Request(prompt=prompt, max_new_tokens=4)
    ServeEngine(cfg, params, max_len=40, device="cpu").serve_wave(
        [req], {"patches": patches})
    assert list(chain[0]) == forward
    assert rreq.out_tokens != forward
    assert req.out_tokens == forward


def test_serve_wave_stops_at_max_len():
    """The reference's ``pos + 1 >= max_len`` break: a 9-token prompt in a
    12-position cache decodes 2 steps and emits 3 tokens."""
    cfg = _cfg("qwen3-0.6b")
    params = init_model(cfg, seed=0, device="cpu")
    req = Request(prompt=np.arange(9) + 2, max_new_tokens=8)
    stats = ServeEngine(cfg, params, max_len=12, device="cpu").serve_wave([req])
    assert (len(req.out_tokens), stats.decode_steps) == (3, 2)


def test_init_cache_is_zero_and_decodable():
    """A zero cache from ``init_cache`` takes a decode step at pos 0 to the
    same logits as a one-token prefill."""
    cfg = _cfg("gemma2-2b")
    params = init_model(cfg, seed=1, device="cpu")
    cache = init_cache(cfg, 2, 6, dtype=torch.float32, device="cpu")
    assert cache_seq_len(cfg, cache) == 6
    assert all(not t.any() for e in cache["layers"] for t in e.values())
    tok = torch.tensor([[3], [7]])
    dec, _ = decode_step(params, cfg, cache, tok, 0)
    full, _ = apply_model(params, cfg, {"tokens": tok})
    torch.testing.assert_close(dec, full, atol=TOL, rtol=TOL)


def test_serve_engine_refuses_params_elsewhere():
    cfg = _cfg("qwen3-0.6b")
    with pytest.raises(ValueError, match="params lie on meta"):
        ServeEngine(cfg, init_model(cfg, device="meta"), device="cpu")


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "gemma2-2b", "gemma3-27b",
                                  "qwen2.5-14b", "xlstm-350m"] + MOE_ARCHS
                         + ["whisper-medium", "pixtral-12b"])
def test_param_count_matches_reference(arch):
    """On the meta device; the MoE's (E, d, f) leaves and the Mamba
    mixer's leaves sit one level down, as the attention's do; whisper's
    encoder and cross blocks count."""
    assert param_count(get_config(arch)) == ref_param_count(
        ref_get_config(arch))
    published = {"qwen3-0.6b": 596_049_920, "xlstm-350m": 232_207_528,
                 "whisper-medium": 1_012_525_056,
                 "pixtral-12b": 12_247_782_400}
    if arch in published:
        assert param_count(get_config(arch)) == published[arch]
    if arch == "jamba-v0.1-52b":          # tests/test_models_smoke.py:84
        assert round(param_count(get_config(arch)) / 1e9, 1) == 51.6


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "gemma2-2b-window",
                                  "gemma3-27b", "qwen2.5-14b", "xlstm-350m"]
                         + MOE_ARCHS + ["whisper-medium", "pixtral-12b"])
def test_prefill_decode_matches_forward(arch):
    """Port only: teacher-forced decode steps reproduce the full forward's
    logits (the reference's invariant, ``tests/test_cache_consistency.py``,
    at its 5e-3 relative to the largest logit; pixtral's text from
    n_patches + p, as there).  MoE archs run with capacity factor 16, as
    there: capacity drops legitimately differ between routing groups of
    other lengths."""
    cfg = _cfg(arch)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=16.0)
    params = init_model(cfg, seed=3, device="cpu")
    b, p, n_new = 2, 10, 3
    toks = np.random.RandomState(4).randint(0, cfg.raw_vocab_size,
                                            (b, p + n_new))
    extras, off = _extras(cfg, b, seed=14)
    full, _ = apply_model(params, cfg, _batches(toks, extras)[0])
    _, cache = prefill(params, cfg, _batches(toks[:, :p], extras)[0],
                       cache_len=off + p + n_new)
    toks = torch.tensor(toks)
    for t in range(n_new):
        dec, cache = decode_step(params, cfg, cache, toks[:, p + t:p + t + 1],
                                 off + p + t)
        a, d = full[:, off + p + t].numpy(), dec[:, 0].numpy()
        assert np.max(np.abs(a - d)) / (np.max(np.abs(a)) + 1e-9) < 5e-3


def test_pad_cache_to_leaves_recurrent_states():
    """Only K/V entries grow: an mLSTM state C (B, H, D, D) has no sequence
    axis (growing its dim 1 would pad the head axis), nor has n, m or the
    sLSTM's state; each passes through as the same tensor."""
    cfg = _cfg("xlstm-350m")
    params = init_model(cfg, seed=2, device="cpu")
    toks = torch.tensor(np.random.RandomState(5).randint(
        0, cfg.raw_vocab_size, (2, 6)))
    _, cache = prefill(params, cfg, {"tokens": toks})
    grown = pad_cache_to(cache, cfg, 64)
    for entry, before in zip(grown["layers"], cache["layers"]):
        assert set(entry) == set(before)
        assert all(entry[k] is before[k] for k in entry)
    assert cache["layers"][0]["C"].shape == (2, cfg.n_heads, cfg.d_head,
                                             cfg.d_head)
    assert cache_seq_len(cfg, grown) == 0


def test_init_cache_matches_reference_states():
    """xlstm-350m's zero cache equals the reference's (C, n zero, m at
    -1e30; the sLSTM's h, c, n zero, m at -1e30), and a decode step from it
    at pos 0 gives a one-token forward's logits."""
    from repro.models import init_cache as ref_init_cache
    cfg = _cfg("xlstm-350m")
    cache = init_cache(cfg, 2, 6, dtype=torch.float32, device="cpu")
    ref = lm_cache_from_numpy(_np_tree(ref_init_cache(_ref_cfg(cfg), 2, 6)),
                              cfg, "cpu")
    for got, want in zip(cache["layers"], ref["layers"]):
        assert set(got) == set(want)
        for key in got:
            assert torch.equal(got[key], want[key])
    params = init_model(cfg, seed=1, device="cpu")
    tok = torch.tensor([[3], [7]])
    dec, _ = decode_step(params, cfg, cache, tok, 0)
    full, _ = apply_model(params, cfg, {"tokens": tok})
    torch.testing.assert_close(dec, full, atol=TOL, rtol=TOL)


def test_converters_carry_jamba_pytrees():
    """``lm_params_from_numpy`` and ``lm_cache_from_numpy`` unstack jamba's
    groups (p0..p7: "mamba" or "attn", "ffn" or "moe") and its cache ({h,
    conv}, {k, v}) into one dict per layer, leaf for leaf: layer g * 8 + j
    is group g's "p{j}"."""
    cfg = _cfg("jamba-v0.1-52b")
    rcfg = _ref_cfg(cfg)
    rparams = ref_init_model(jax.random.PRNGKey(3), rcfg)
    tree = _np_tree(rparams)
    params = lm_params_from_numpy(tree, cfg, device="cpu")
    toks = jnp.asarray(np.random.RandomState(7).randint(
        0, cfg.raw_vocab_size, (2, 5)))
    cache = _np_tree(ref_prefill(rparams, rcfg, {"tokens": toks},
                                 cache_len=8)[1])
    layers = lm_cache_from_numpy(cache, cfg, "cpu")["layers"]
    period = cfg.layer_period
    assert period == 8 and len(params["layers"]) == len(layers) == 16
    for i, (lp, entry) in enumerate(zip(params["layers"], layers)):
        g, j = divmod(i, period)
        mixer = "mamba" if cfg.layer_kind(i) == "mamba" else "attn"
        ffn_key = "moe" if cfg.ffn_kind(i) == "moe" else "ffn"
        assert set(lp) == {"ln1", mixer, "ln2", ffn_key}
        for part in (mixer, ffn_key):
            assert set(lp[part]) == set(tree["groups"][f"p{j}"][part])
            for key, leaf in lp[part].items():
                want = tree["groups"][f"p{j}"][part][key][g]
                assert torch.equal(leaf, torch.from_numpy(np.array(want)))
        assert set(entry) == ({"h", "conv"} if mixer == "mamba"
                              else {"k", "v"})
        for key, leaf in entry.items():
            want = cache["groups"][f"p{j}"][key][g]
            assert torch.equal(leaf, torch.from_numpy(np.array(want)))


def test_pad_cache_to_leaves_mamba_states():
    """A Mamba layer's h (B, dI, N) and conv rows (B, dconv - 1, dI) pass
    through as the same tensors; the attention layers' K/V grow."""
    cfg = _cfg("jamba-v0.1-52b")
    params = init_model(cfg, seed=2, device="cpu")
    toks = torch.tensor(np.random.RandomState(5).randint(
        0, cfg.raw_vocab_size, (2, 6)))
    _, cache = prefill(params, cfg, {"tokens": toks})
    grown = pad_cache_to(cache, cfg, 64)
    di = cfg.mamba_expand * cfg.d_model
    for i, (entry, before) in enumerate(zip(grown["layers"],
                                            cache["layers"])):
        assert set(entry) == set(before)
        if cfg.layer_kind(i) == "mamba":
            assert all(entry[k] is before[k] for k in entry)
            assert entry["h"].shape == (2, di, cfg.mamba_d_state)
            assert entry["conv"].shape == (2, cfg.mamba_d_conv - 1, di)
        else:
            assert entry["k"].shape[1] == 64 and before["k"].shape[1] == 6
    assert cache_seq_len(cfg, grown) == 64


def test_init_cache_matches_reference_mamba_states():
    """jamba's zero cache equals the reference's (Mamba h float32, conv in
    the cache dtype; K/V), and a decode step from it at pos 0 gives a
    one-token forward's logits."""
    from repro.models import init_cache as ref_init_cache
    cfg = _cfg("jamba-v0.1-52b")
    cache = init_cache(cfg, 2, 6, dtype=torch.float32, device="cpu")
    ref = lm_cache_from_numpy(_np_tree(ref_init_cache(
        _ref_cfg(cfg), 2, 6, dtype=jnp.float32)), cfg, "cpu")
    for got, want in zip(cache["layers"], ref["layers"]):
        assert set(got) == set(want)
        for key in got:
            assert got[key].dtype == want[key].dtype
            assert torch.equal(got[key], want[key])
    assert init_cache(cfg, 1, 4, device="cpu")["layers"][0]["conv"].dtype \
        == torch.bfloat16
    params = init_model(cfg, seed=1, device="cpu")
    tok = torch.tensor([[3], [7]])
    dec, _ = decode_step(params, cfg, cache, tok, 0)
    full, _ = apply_model(params, cfg, {"tokens": tok})
    torch.testing.assert_close(dec, full, atol=TOL, rtol=TOL)


def test_forward_sums_the_moe_aux_loss(pair):
    """``apply_model``'s aux is the MoE layers' summed load-balancing loss,
    the reference's; 0 without MoE."""
    from repro.models import apply_model as ref_apply_model
    cfg, params, rcfg, rparams = pair
    toks = np.random.RandomState(6).randint(0, cfg.raw_vocab_size, (2, 12))
    batch, rbatch = _batches(toks, _extras(cfg, 2, seed=15)[0])
    _, aux = apply_model(params, cfg, batch)
    _, raux = ref_apply_model(rparams, rcfg, rbatch)
    assert aux.dtype == torch.float32 and aux.shape == ()
    np.testing.assert_allclose(float(aux), float(raux), atol=TOL, rtol=TOL)
    assert (float(aux) > 0) == bool(cfg.n_experts)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_group_contract_raises(arch):
    """A prompt longer than moe_group must be a multiple of it
    (``repro/models/moe.py:44-46``): the prefill and the engine raise
    ``ValueError``; a length at the group or a multiple of it serves."""
    cfg = dataclasses.replace(_cfg(arch), moe_group=8)
    params = init_model(cfg, seed=0, device="cpu")
    eng = ServeEngine(cfg, params, max_len=40, device="cpu")
    with pytest.raises(ValueError, match="moe.py:44-46"):
        prefill(params, cfg, {"tokens": torch.ones((1, 12), dtype=torch.long)})
    with pytest.raises(ValueError, match="moe.py:44-46"):
        eng.serve_wave([Request(prompt=np.arange(12) + 2, max_new_tokens=2)])
    req = Request(prompt=np.arange(16) + 2, max_new_tokens=2)
    eng.serve_wave([req])
    assert len(req.out_tokens) == 2


def test_sinusoidal_positions_match_reference():
    """The whisper table against the reference's: the smoke encoder's 12
    rows at d 64 at 1e-6, and whisper-medium's 1500 rows at d 1024 row by
    row within 1e-6 + pos * 2^-23.  The two packages' float32 ``exp`` give
    inverse frequencies one ulp apart at some entries (against a float64
    exp rounded to float32, XLA's CPU exp is one ulp off at 59 of the 512
    at d 1024, torch's at 3), and row pos multiplies that ulp, and the
    product's own rounding, by pos.  A row taken alone (decode's) equals
    the table's row bit for bit."""
    for n, d in ((12, 64), (1500, 1024)):
        got = layers.sinusoidal_positions(n, d)
        assert got.dtype == torch.float32 and got.shape == (n, d)
        want = np.asarray(ref_layers.sinusoidal_positions(n, d))
        err = np.abs(got.numpy() - want).max(axis=1)
        assert (err <= 1e-6 + np.arange(n) * 2.0 ** -23).all()
        if n == 12:
            np.testing.assert_allclose(got.numpy(), want, atol=1e-6,
                                       rtol=1e-6)
        for pos in (0, n // 2, n - 1):
            assert torch.equal(layers.sinusoidal_positions(1, d, start=pos),
                               got[pos:pos + 1])


def test_encoder_matches_reference():
    """``encode_audio`` over the same frames and weights gives the
    reference's encoder output at 1e-5."""
    from repro.models.transformer import encode_audio as ref_encode
    from repro_torch.models.transformer import encode_audio
    cfg = _cfg("whisper-medium")
    rcfg = _ref_cfg(cfg)
    rparams = ref_init_model(jax.random.PRNGKey(4), rcfg)
    params = lm_params_from_numpy(_np_tree(rparams), cfg, device="cpu")
    frames = _extras(cfg, 3, seed=16)[0]["frames"]
    got = encode_audio(params, cfg, torch.tensor(frames))
    want = ref_encode(rparams, rcfg, jnp.asarray(frames))
    assert got.shape == (3, cfg.enc_frames, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_converters_carry_whisper_pytrees():
    """``lm_params_from_numpy`` unstacks the encoder's groups (leading axis
    ``enc_layers``) into ``encoder["layers"]`` and carries each decoder
    layer's ``ln_cross`` / ``cross``; ``lm_cache_from_numpy`` carries
    ``ck`` / ``cv``; leaf for leaf."""
    cfg = _cfg("whisper-medium")
    rcfg = _ref_cfg(cfg)
    rparams = ref_init_model(jax.random.PRNGKey(5), rcfg)
    tree = _np_tree(rparams)
    params = lm_params_from_numpy(tree, cfg, device="cpu")
    enc = params["encoder"]
    assert set(enc) == {"layers", "final_norm"}
    assert len(enc["layers"]) == cfg.enc_layers == 2
    assert torch.equal(enc["final_norm"], torch.from_numpy(
        np.array(tree["encoder"]["final_norm"])))
    for i, lp in enumerate(enc["layers"]):
        assert set(lp) == {"ln1", "attn", "ln2", "ffn"}
        for part in ("attn", "ffn"):
            for key, leaf in lp[part].items():
                want = tree["encoder"]["groups"]["p0"][part][key][i]
                assert torch.equal(leaf, torch.from_numpy(np.array(want)))
    for g, lp in enumerate(params["layers"]):
        assert set(lp) == {"ln1", "attn", "ln_cross", "cross", "ln2", "ffn"}
        assert torch.equal(lp["ln_cross"], torch.from_numpy(
            np.array(tree["groups"]["p0"]["ln_cross"][g])))
        for key, leaf in lp["cross"].items():
            want = tree["groups"]["p0"]["cross"][key][g]
            assert torch.equal(leaf, torch.from_numpy(np.array(want)))
    frames = _extras(cfg, 2, seed=17)[0]
    toks = np.random.RandomState(8).randint(0, cfg.raw_vocab_size, (2, 5))
    cache = _np_tree(ref_prefill(rparams, rcfg,
                                 _batches(toks, frames)[1], cache_len=8)[1])
    for g, entry in enumerate(lm_cache_from_numpy(cache, cfg,
                                                  "cpu")["layers"]):
        assert set(entry) == {"k", "v", "ck", "cv"}
        assert entry["ck"].shape == (2, cfg.enc_frames, cfg.n_kv_heads,
                                     cfg.d_head)
        for key, leaf in entry.items():
            want = cache["groups"]["p0"][key][g]
            assert torch.equal(leaf, torch.from_numpy(np.array(want)))


def test_init_cache_and_pad_cache_to_keep_whisper_cross_entries():
    """whisper's zero cache holds (B, enc_frames, Kh, Dh) ``ck``/``cv``
    beside the self K/V, as the reference's; ``pad_cache_to`` grows only
    the self K/V and passes ck/cv on as the same tensors."""
    from repro.models import init_cache as ref_init_cache
    cfg = _cfg("whisper-medium")
    cache = init_cache(cfg, 2, 6, dtype=torch.float32, device="cpu")
    ref = lm_cache_from_numpy(_np_tree(ref_init_cache(
        _ref_cfg(cfg), 2, 6, dtype=jnp.float32)), cfg, "cpu")
    for got, want in zip(cache["layers"], ref["layers"]):
        assert set(got) == set(want) == {"k", "v", "ck", "cv"}
        for key in got:
            assert got[key].dtype == want[key].dtype
            assert torch.equal(got[key], want[key])
    params = init_model(cfg, seed=2, device="cpu")
    toks = torch.tensor(np.random.RandomState(9).randint(
        0, cfg.raw_vocab_size, (2, 5)))
    frames = torch.tensor(_extras(cfg, 2, seed=18)[0]["frames"])
    _, cache = prefill(params, cfg, {"tokens": toks, "frames": frames})
    grown = pad_cache_to(cache, cfg, 16)
    for entry, before in zip(grown["layers"], cache["layers"]):
        assert entry["ck"] is before["ck"] and entry["cv"] is before["cv"]
        assert entry["k"].shape[1] == 16 and before["k"].shape[1] == 5
    assert cache_seq_len(cfg, grown) == 16


def test_bf16_whisper_refuses_frames_of_another_dtype():
    """A bf16 whisper takes bf16 frames; float32 frames raise the
    ``TypeError`` the reference's scan raises there (citing
    ``repro/launch/specs.py:41``), in the forward and in the engine."""
    cfg = dataclasses.replace(_cfg("whisper-medium"), dtype="bfloat16",
                              param_dtype="bfloat16")
    params = init_model(cfg, seed=0, device="cpu")
    toks = torch.tensor([[3, 4, 5]])
    frames = torch.tensor(_extras(cfg, 1)[0]["frames"])
    with pytest.raises(TypeError, match="specs.py:41"):
        apply_model(params, cfg, {"tokens": toks, "frames": frames})
    eng = ServeEngine(cfg, params, max_len=8, device="cpu")
    with pytest.raises(TypeError, match="specs.py:41"):
        eng.serve_wave([Request(prompt=np.arange(3) + 2, max_new_tokens=2)],
                       {"frames": frames.numpy()})
    logits, _ = apply_model(params, cfg, {"tokens": toks,
                                          "frames": frames.bfloat16()})
    assert logits.dtype == torch.bfloat16
    assert bool(torch.isfinite(logits.float()).all())
    req = Request(prompt=np.arange(3) + 2, max_new_tokens=2)
    eng.serve_wave([req], {"frames": frames.bfloat16()})
    assert len(req.out_tokens) == 2


@pytest.mark.parametrize("arch", ["whisper-medium", "pixtral-12b"])
def test_serve_launcher_runs_the_new_families_on_cpu(arch, capsys):
    from repro_torch.launch.serve import main
    main(["--arch", arch, "--smoke", "--device", "cpu", "--waves", "1",
          "--batch", "2"])
    out = capsys.readouterr().out
    assert "[serve] wave 0: 16 tokens" in out


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "olmoe-1b-7b",
                                  "whisper-medium", "pixtral-12b",
                                  "jamba-v0.1-52b", "xlstm-350m"])
def test_quickstart_runs_each_family_on_cpu(arch, capsys):
    """``python -m repro_torch.launch.quickstart --device cpu``, one arch
    of each family: finite losses, a served wave where the reference's
    quickstart serves one, an Enel pick in range."""
    from repro_torch.launch.quickstart import main
    main(["--arch", arch, "--steps", "2", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    cfg = get_config(arch)
    assert out[0].startswith(f"arch={arch} (reduced: ")
    assert f"family={cfg.family})" in out[0]
    losses = [float(line.split("loss=")[1].split()[0]) for line in out
              if line.startswith("step ")]
    assert len(losses) == 2 and all(np.isfinite(losses))
    served = [line for line in out if line.startswith("served: ")]
    assert len(served) == (cfg.family in ("dense", "moe", "ssm", "hybrid"))
    pick = int(out[-1].split("scale-out ")[1].split()[0])
    assert out[-1].startswith("Enel recommendation") and 4 <= pick <= 36
