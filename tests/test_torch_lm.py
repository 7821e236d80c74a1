"""The port's LM serving path against the JAX reference, at smoke size in
float32 on the CPU: configs, layers, prefill logits and caches, chained
decode steps and ``ServeEngine`` waves, with the reference's weights carried
over by ``lm_params_from_numpy``.  Attention and the mLSTM run through the
kernels' plain versions here (the wrappers take them for CPU tensors).
xlstm-350m's states and logits are held at 2e-4, the reference's tolerance
between two chunkwise forms of the mLSTM (``tests/test_kernels.py:101``):
its 16 recurrent layers carry each layer's summation-order differences
into the next."""
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


@pytest.fixture(scope="module", params=["qwen3-0.6b", "gemma2-2b",
                                        "gemma2-2b-window", "xlstm-350m"])
def pair(request):
    """(cfg, port params, reference cfg, reference params) for one arch."""
    cfg = _cfg(request.param)
    rcfg = _ref_cfg(cfg)
    rparams = ref_init_model(jax.random.PRNGKey(0), rcfg)
    params = lm_params_from_numpy(_np_tree(rparams), cfg, device="cpu")
    return cfg, params, rcfg, rparams


def _tol(cfg):
    return TOL if cfg.has_attention() else SSM_TOL


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
                  "mlstm": {"C", "n", "m"}, "slstm": {"h", "c", "n", "m"}}
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
                                  "qwen2.5-14b", "xlstm-350m"])
def test_param_count_matches_reference(arch):
    assert param_count(get_config(arch)) == ref_param_count(
        ref_get_config(arch))
    published = {"qwen3-0.6b": 596_049_920, "xlstm-350m": 232_207_528}
    if arch in published:
        assert param_count(get_config(arch)) == published[arch]


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "gemma2-2b-window",
                                  "gemma3-27b", "qwen2.5-14b", "xlstm-350m"])
def test_prefill_decode_matches_forward(arch):
    """Port only: teacher-forced decode steps reproduce the full forward's
    logits (the reference's invariant, ``tests/test_cache_consistency.py``,
    at its 5e-3 relative to the largest logit)."""
    cfg = _cfg(arch)
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


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "olmoe-1b-7b",
                                  "arctic-480b", "whisper-medium",
                                  "pixtral-12b"])
def test_unported_families_raise(arch):
    cfg = smoke_config(get_config(arch))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        init_model(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        param_count(cfg)
