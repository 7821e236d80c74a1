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
1e-5."""
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
from repro_torch.models import (apply_model, decode_step, init_cache,
                                init_model, param_count, prefill)
from repro_torch.models import layers
from repro_torch.models.transformer import cache_seq_len, pad_cache_to
from repro_torch.serve.engine import Request, ServeEngine

TOL = 1e-5
SSM_TOL = 2e-4


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


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
                + MOE_ARCHS)
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
    """Prefill logits and every layer's cache entry (K/V, or the mLSTM's
    C, n, m and the sLSTM's h, c, n, m), then chained decode steps."""
    cfg, params, rcfg, rparams = pair
    tol = _tol(cfg)
    b, p, n_new, cache_len = 2, 11, 4, 20
    toks = np.random.RandomState(1).randint(0, cfg.raw_vocab_size,
                                            (b, p + n_new))
    logits, cache = prefill(params, cfg, {"tokens": torch.tensor(toks[:, :p])},
                            cache_len=cache_len)
    rlogits, rcache = ref_prefill(rparams, rcfg,
                                  {"tokens": jnp.asarray(toks[:, :p])},
                                  cache_len=cache_len)
    np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits), atol=tol,
                               rtol=tol)
    ref_layers_cache = lm_cache_from_numpy(_np_tree(rcache), cfg, "cpu")
    assert len(cache["layers"]) == cfg.n_layers
    assert cache_seq_len(cfg, cache) == \
        (cache_len if cfg.has_attention() else 0)
    entry_keys = {"attn": {"k", "v"}, "attn_local": {"k", "v"},
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
                                    p + t)
        rlogits, rcache = ref_decode_step(rparams, rcfg, rcache,
                                          jnp.asarray(tok), jnp.int32(p + t))
        np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits),
                                   atol=tol, rtol=tol)


def test_decode_from_reference_cache(pair):
    """The reference's prefill cache, converted, feeds the port's
    ``decode_step`` to the reference's logits."""
    cfg, params, rcfg, rparams = pair
    toks = np.random.RandomState(2).randint(0, cfg.raw_vocab_size, (2, 9))
    _, rcache = ref_prefill(rparams, rcfg, {"tokens": jnp.asarray(toks[:, :8])},
                            cache_len=12)
    cache = lm_cache_from_numpy(_np_tree(rcache), cfg, "cpu")
    logits, _ = decode_step(params, cfg, cache, torch.tensor(toks[:, 8:]), 8)
    rlogits, _ = ref_decode_step(rparams, rcfg, rcache,
                                 jnp.asarray(toks[:, 8:]), jnp.int32(8))
    np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits),
                               atol=_tol(cfg), rtol=_tol(cfg))


def test_serve_wave_matches_reference_tokens(pair):
    """The prompts of ``tests/test_runner_integration.py``'s serve test."""
    cfg, params, rcfg, rparams = pair
    prompts = [(np.arange(5) + 2, 4), (np.arange(9) + 2, 6)]
    reqs = [Request(prompt=p, max_new_tokens=n) for p, n in prompts]
    rreqs = [RefRequest(prompt=p, max_new_tokens=n) for p, n in prompts]
    stats = ServeEngine(cfg, params, max_len=48, device="cpu").serve_wave(reqs)
    rstats = RefServeEngine(rcfg, rparams, max_len=48).serve_wave(rreqs)
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in rreqs]
    assert stats.tokens_out == rstats.tokens_out == 10
    assert stats.decode_steps == 6
    assert all(0 <= t < cfg.vocab_size for r in reqs for t in r.out_tokens)


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
                                  "qwen2.5-14b", "xlstm-350m"] + MOE_ARCHS)
def test_param_count_matches_reference(arch):
    """On the meta device; the MoE's (E, d, f) leaves and the Mamba
    mixer's leaves sit one level down, as the attention's do."""
    assert param_count(get_config(arch)) == ref_param_count(
        ref_get_config(arch))
    published = {"qwen3-0.6b": 596_049_920, "xlstm-350m": 232_207_528}
    if arch in published:
        assert param_count(get_config(arch)) == published[arch]
    if arch == "jamba-v0.1-52b":          # tests/test_models_smoke.py:84
        assert round(param_count(get_config(arch)) / 1e9, 1) == 51.6


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "gemma2-2b-window",
                                  "gemma3-27b", "qwen2.5-14b", "xlstm-350m"]
                         + MOE_ARCHS)
def test_prefill_decode_matches_forward(arch):
    """Port only: teacher-forced decode steps reproduce the full forward's
    logits (the reference's invariant, ``tests/test_cache_consistency.py``,
    at its 5e-3 relative to the largest logit).  MoE archs run with
    capacity factor 16, as there: capacity drops legitimately differ
    between routing groups of other lengths."""
    cfg = _cfg(arch)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=16.0)
    params = init_model(cfg, seed=3, device="cpu")
    b, p, n_new = 2, 10, 3
    toks = torch.tensor(np.random.RandomState(4).randint(
        0, cfg.raw_vocab_size, (b, p + n_new)))
    full, _ = apply_model(params, cfg, {"tokens": toks})
    _, cache = prefill(params, cfg, {"tokens": toks[:, :p]},
                       cache_len=p + n_new)
    for t in range(n_new):
        dec, cache = decode_step(params, cfg, cache, toks[:, p + t:p + t + 1],
                                 p + t)
        a, d = full[:, p + t].numpy(), dec[:, 0].numpy()
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
    _, aux = apply_model(params, cfg, {"tokens": torch.tensor(toks)})
    _, raux = ref_apply_model(rparams, rcfg, {"tokens": jnp.asarray(toks)})
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


@pytest.mark.parametrize("arch", ["whisper-medium", "pixtral-12b"])
def test_unported_families_raise(arch):
    cfg = smoke_config(get_config(arch))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        init_model(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        param_count(cfg)
