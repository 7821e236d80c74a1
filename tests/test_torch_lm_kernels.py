"""The port's attention kernels' plain versions against the reference's
Pallas kernels (interpret mode) and jnp oracles, the wrappers' refusals, and
(on a card) each CUDA kernel against its plain version.

Inputs are seeded numpy arrays fed to both packages, float32 on the CPU, at
the reference's own tolerance (``tests/test_kernels.py``: 2e-5 in float32,
3e-2 in bfloat16).  The ``cuda``-marked tests need an NVIDIA card and
``nvcc`` and skip without them, naming what is missing; on a machine with a
card run them with ``python -m pytest -m cuda tests/test_torch_lm_kernels.py``
(the reference is imported inside the CPU tests, so this file also loads
where JAX is not installed).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.flash_decode import ops as fd


class _Elsewhere(torch.Tensor):
    """A CPU tensor that reports another device (xpu): the wrappers refuse
    any device but the CPU, a card and meta, which takes the card's route
    without launching."""

    @property
    def device(self):
        return torch.device("xpu")


def _elsewhere(t: torch.Tensor) -> torch.Tensor:
    return t.as_subclass(_Elsewhere)


TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}

# (B, S, H, Kh, D, causal, window, softcap): tests/test_kernels.py's sweep
MHA_SWEEP = [(2, 128, 4, 2, 32, True, 0, 0.0),
             (1, 256, 4, 4, 64, True, 64, 50.0),
             (2, 96, 8, 2, 32, False, 0, 0.0),
             (1, 64, 2, 1, 128, True, 32, 0.0),
             (1, 192, 6, 3, 32, True, 0, 30.0)]
# (B, S, H, Kh, D, pos, window): tests/test_kernels.py's decode sweep
DECODE_SWEEP = [(2, 256, 4, 2, 32, 100, 0),
                (1, 512, 8, 8, 64, 511, 128),
                (2, 128, 4, 1, 32, 0, 0),
                (1, 128, 2, 2, 128, 64, 32)]


# (B, S, H, Kh, D, causal, window, softcap, kv_len): the bfloat16 route's
# own cases on the card: every padded head dim, S ragged against the 128-row
# q-tile and the K/V tile (qwen3's prefill S = 812, and 1000), kv_len < S,
# window with softcap at D = 256, and D = 24, which the wrapper pads to 32
MHA_TC_CASES = [(2, 200, 4, 2, d, True, 0, 0.0, 0) for d in (32, 64, 128,
                                                              256)] + \
    [(8, 812, 16, 8, 128, True, 0, 0.0, 0),
     (2, 1000, 4, 2, 128, True, 0, 0.0, 0),
     (2, 300, 4, 2, 64, True, 0, 0.0, 263),
     (2, 300, 4, 2, 64, False, 0, 0.0, 263),
     (2, 520, 8, 4, 256, True, 128, 50.0, 0),
     (1, 150, 4, 2, 24, True, 0, 0.0, 0)]
# (B, S, H, Kh, D, pos, window, softcap): split-K decode on the card: pos 0,
# the model's shapes just below, at and above a chunk boundary of
# split_plan (1023 keys: 8 chunks of 128, the last one short; 1024: 8 full;
# 1025: 9, the last one key), a window whose first key starts a chunk
# mid-cache, group 4 (jamba) and 5 (qwen2.5), and D = 256 with a softcap
DECODE_SPLIT_CASES = [(8, 2048, 16, 8, 128, pos, 0, 0.0)
                      for pos in (0, 1022, 1023, 1024)] + \
    [(8, 2048, 16, 8, 128, 1500, 300, 0.0),
     (8, 2048, 32, 8, 128, 2047, 0, 0.0),
     (2, 300, 40, 8, 128, 299, 0, 0.0),
     (2, 1024, 8, 4, 256, 700, 512, 50.0)]


# (B, Sq, Sk, H, Kh, D): cross-attention and whisper's encoder, non-causal,
# k and v of their own length: whisper-medium's decoder over its 1500
# encoder rows (P up to 224), its encoder (1500 against 1500), and ragged
# tails of both tiles at another group and head dim
CROSS_CASES = [(8, 224, 1500, 16, 16, 64), (8, 4, 1500, 16, 16, 64),
               (8, 1500, 1500, 16, 16, 64), (2, 37, 300, 8, 2, 128),
               (2, 129, 77, 4, 4, 64)]
# (B, S, H, Kh, D, pos): whisper's cross decode over every encoder row and
# its self cache of 448 (max_target_positions)
CROSS_DECODE_CASES = [(8, 1500, 16, 16, 64, 1499), (8, 448, 16, 16, 64, 447),
                      (8, 448, 16, 16, 64, 231), (2, 77, 4, 4, 64, 76)]


def _mha_inputs(b, s, h, kh, d, seed, sk=None):
    rng = np.random.RandomState(seed)
    sk = s if sk is None else sk
    return (rng.randn(b, s, h, d).astype(np.float32),
            rng.randn(b, sk, kh, d).astype(np.float32),
            rng.randn(b, sk, kh, d).astype(np.float32))


def _decode_inputs(b, s, h, kh, d, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, 1, h, d).astype(np.float32),
            rng.randn(b, s, kh, d).astype(np.float32),
            rng.randn(b, s, kh, d).astype(np.float32))


def _t(*arrays, device="cpu", dtype=torch.float32):
    return tuple(torch.tensor(a, device=device, dtype=dtype) for a in arrays)


@pytest.mark.parametrize("b,s,h,kh,d,causal,win,cap", MHA_SWEEP)
def test_mha_plain_matches_reference(b, s, h, kh, d, causal, win, cap):
    import jax.numpy as jnp
    from repro.kernels.flash_attention.ops import mha as ref_mha
    from repro.kernels.flash_attention.ref import attention_ref
    q, k, v = _mha_inputs(b, s, h, kh, d, seed=s + d)
    got = fa.mha(*_t(q, k, v), causal=causal, window=win, softcap=cap)
    pallas = ref_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=causal, window=win, softcap=cap, block_q=64,
                     block_k=64)
    oracle = attention_ref(*(jnp.asarray(x).transpose(0, 2, 1, 3)
                             for x in (q, k, v)), causal=causal, window=win,
                           softcap=cap).transpose(0, 2, 1, 3)
    for ref in (pallas, oracle):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5,
                                   rtol=2e-5)


@pytest.mark.parametrize("causal,win,cap", [(True, 0, 0.0), (False, 48, 0.0),
                                            (True, 40, 20.0)])
def test_mha_plain_kv_len_matches_reference_kernel(causal, win, cap):
    """The ``kv_len`` tail mask against the reference kernel's, with more
    queries than keys so that some rows see no key at all (those come out
    as the mean of V over every key in both)."""
    import jax.numpy as jnp
    from repro.kernels.flash_attention.kernel import flash_attention
    b, sq, sk, h, kh, d, kv_len = 2, 192, 128, 4, 2, 32, 100
    q, k, v = _mha_inputs(b, sq, h, kh, d, seed=7, sk=sk)
    got = fa.mha(*_t(q, k, v), causal=causal, window=win, softcap=cap,
                 kv_len=kv_len)
    ref = flash_attention(*(jnp.asarray(x).transpose(0, 2, 1, 3)
                            for x in (q, k, v)), causal=causal, window=win,
                          softcap=cap, block_q=64, block_k=64, kv_len=kv_len)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(ref).transpose(0, 2, 1, 3),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("b,sq,sk,h,kh,d,bq,bk",
                         [(2, 11, 12, 4, 2, 16, 11, 12),
                          (1, 64, 192, 4, 2, 32, 32, 64),
                          (1, 37, 1500, 2, 2, 64, 37, 100)])
def test_mha_plain_cross_matches_reference_kernel(b, sq, sk, h, kh, d, bq,
                                                  bk):
    """Cross-attention's call, Sq != Sk and no mask, against the
    reference's Pallas kernel in interpret mode (Sk = 1500: whisper's
    encoder rows)."""
    import jax.numpy as jnp
    from repro.kernels.flash_attention.kernel import flash_attention
    q, k, v = _mha_inputs(b, sq, h, kh, d, seed=sq + sk, sk=sk)
    got = fa.mha(*_t(q, k, v), causal=False)
    ref = flash_attention(*(jnp.asarray(x).transpose(0, 2, 1, 3)
                            for x in (q, k, v)), causal=False, block_q=bq,
                          block_k=bk)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(ref).transpose(0, 2, 1, 3),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("b,t,h,kh,d,cap", [(2, 12, 4, 2, 16, 0.0),
                                            (2, 1500, 16, 16, 64, 0.0),
                                            (1, 40, 8, 2, 32, 20.0)])
def test_decode_attn_plain_cross_matches_reference(b, t, h, kh, d, cap):
    """Decode over every one of T encoder rows (pos = T - 1) against the
    reference model's cross decode: ``_sdpa`` with a zero bias over the
    expanded encoder k/v (``repro/models/attention.py:205-211``)."""
    import dataclasses
    import jax.numpy as jnp
    from repro.configs import get_config as ref_get_config
    from repro.models import attention as ref_attn
    rcfg = dataclasses.replace(ref_get_config("whisper-medium"), d_head=d,
                               attn_logit_softcap=cap)
    q, ck, cv = _decode_inputs(b, t, h, kh, d, seed=t + d)
    got = fd.decode_attn(*_t(q, ck, cv), t - 1, softcap=cap)
    ref = ref_attn._sdpa(rcfg, jnp.asarray(q),
                         ref_attn._expand_kv(jnp.asarray(ck), h),
                         ref_attn._expand_kv(jnp.asarray(cv), h),
                         jnp.zeros((1, t), jnp.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("b,s,h,kh,d,pos,win", DECODE_SWEEP)
def test_decode_attn_plain_matches_reference(b, s, h, kh, d, pos, win):
    import jax.numpy as jnp
    from repro.kernels.flash_decode.ops import decode_attn as ref_decode_attn
    from repro.kernels.flash_decode.ref import decode_ref
    q, ck, cv = _decode_inputs(b, s, h, kh, d, seed=s + pos)
    got = fd.decode_attn(*_t(q, ck, cv), pos, window=win)
    pallas = ref_decode_attn(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
                             jnp.int32(pos), window=win, block_k=64)
    oracle = decode_ref(jnp.asarray(q)[:, 0],
                        jnp.asarray(ck).transpose(0, 2, 1, 3),
                        jnp.asarray(cv).transpose(0, 2, 1, 3),
                        jnp.int32(pos), window=win)[:, None]
    for ref in (pallas, oracle):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5,
                                   rtol=2e-5)


@pytest.mark.parametrize("window,cap", [(0, 0.0), (5, 0.0), (0, 20.0),
                                        (6, 30.0)])
def test_decode_plain_is_the_last_row_of_mha_plain(window, cap):
    """Decoding position p against a cache holding keys 0..p gives row p of
    full causal attention, with the same window and softcap (the model's
    decode needs the cap, which the reference kernel lacks)."""
    q, k, v = _t(*_mha_inputs(2, 12, 4, 2, 16, seed=5))
    full = fa.mha_plain(q, k, v, window=window, softcap=cap)
    for pos in (0, 7, 11):
        row = fd.decode_attn_plain(q[:, pos:pos + 1], k, v, pos,
                                   window=window, softcap=cap)
        torch.testing.assert_close(row, full[:, pos:pos + 1], atol=2e-6,
                                   rtol=2e-6)


def test_wrappers_run_plain_on_cpu_without_a_launch():
    q, k, v = _t(*_mha_inputs(1, 16, 4, 2, 16, seed=1))
    qd, ck, cv = _t(*_decode_inputs(1, 16, 4, 2, 16, seed=1))
    before = (fa.LAUNCHES, fd.LAUNCHES)
    assert torch.equal(fa.mha(q, k, v, window=4, softcap=5.0),
                       fa.mha_plain(q, k, v, window=4, softcap=5.0))
    assert torch.equal(fd.decode_attn(qd, ck, cv, 9, window=3),
                       fd.decode_attn_plain(qd, ck, cv, 9, window=3))
    assert (fa.LAUNCHES, fd.LAUNCHES) == before


def test_mha_wrapper_refuses_bad_inputs():
    q, k, v = _t(*_mha_inputs(1, 16, 4, 2, 16, seed=2))
    with pytest.raises(ValueError, match="several devices"):
        fa.mha(q, k.to("meta"), v)
    with pytest.raises(ValueError, match="cpu or cuda"):
        fa.mha(*map(_elsewhere, (q, k, v)))
    with pytest.raises(TypeError, match="dtype"):
        fa.mha(q.half(), k.half(), v.half())
    with pytest.raises(TypeError, match="dtype"):
        fa.mha(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="multiple"):
        fa.mha(q[:, :, :3], k, v)
    with pytest.raises(ValueError, match="differ"):
        fa.mha(q, k, v[:, :8])
    with pytest.raises(ValueError, match=r"\(B, S, H, D\)"):
        fa.mha(q[0], k, v)
    with pytest.raises(ValueError, match="head dim"):
        big = torch.zeros(1, 4, 2, 272)
        fa.mha(big, big, big)
    with pytest.raises(ValueError, match="kv_len"):
        fa.mha(q, k, v, kv_len=17)


def test_decode_wrapper_refuses_bad_inputs():
    q, ck, cv = _t(*_decode_inputs(1, 16, 4, 2, 16, seed=3))
    with pytest.raises(ValueError, match="several devices"):
        fd.decode_attn(q, ck.to("meta"), cv, 3)
    with pytest.raises(ValueError, match="cpu or cuda"):
        fd.decode_attn(*map(_elsewhere, (q, ck, cv)), 3)
    with pytest.raises(TypeError, match="dtype"):
        fd.decode_attn(q, ck.bfloat16(), cv.bfloat16(), 3)
    with pytest.raises(ValueError, match="pos"):
        fd.decode_attn(q, ck, cv, 16)
    with pytest.raises(ValueError, match="pos"):
        fd.decode_attn(q, ck, cv, -1)
    with pytest.raises(ValueError, match=r"\(B, 1, H, D\)"):
        fd.decode_attn(ck, ck, cv, 3)
    with pytest.raises(ValueError, match="at most"):
        wide = torch.zeros(1, 1, 18, 16)
        fd.decode_attn(wide, ck, cv, 3)
    with pytest.raises(ValueError, match="one"):
        fd.decode_attn(q, ck, cv[:, :8], 3)


SPLIT_SHAPES = [(8, 8), (8, 1), (2, 4), (1, 1)]    # (B, Kh)
SPLIT_CHUNK = fd.split_plan(8, 8, 0, 2047)[0]      # the model's chunk at 2047


@pytest.mark.parametrize("window", [0, 5, 256])
@pytest.mark.parametrize("pos", [0, 1, SPLIT_CHUNK - 1, SPLIT_CHUNK, 875,
                                 2047])
def test_split_plan_covers_the_visible_keys_once(pos, window):
    """split_plan's chunks cover [kbeg, pos] exactly once, in order, none
    empty, each a multiple of CHUNK_ALIGN long, at most MAX_CHUNKS of them,
    and give at least the 64 blocks of one block per (batch, kv head) at the
    models' B = 8, Kh = 8."""
    kbeg = max(0, pos - window + 1) if window else 0
    for b, kh in SPLIT_SHAPES:
        chunk, n = fd.split_plan(b, kh, kbeg, pos)
        assert chunk % fd.CHUNK_ALIGN == 0 and 1 <= n <= fd.MAX_CHUNKS
        spans = [(kbeg + i * chunk, min(kbeg + (i + 1) * chunk, pos + 1))
                 for i in range(n)]
        assert spans[0][0] == kbeg and spans[-1][1] == pos + 1
        assert all(lo < hi for lo, hi in spans)
        assert all(a[1] == b_[0] for a, b_ in zip(spans, spans[1:]))
        assert fd.split_plan(b, kh, kbeg, pos) == (chunk, n)
    assert 8 * 8 * fd.split_plan(8, 8, kbeg, pos)[1] >= 64


@pytest.mark.parametrize("pos", [875, 2047])
def test_split_plan_fills_the_card_at_the_models_shapes(pos):
    """At qwen3's and jamba's decode (B = 8, Kh = 8, no window) the plan
    gives at least two blocks for each of the H100's 132 SMs."""
    chunk, n = fd.split_plan(8, 8, 0, pos)
    assert 8 * 8 * n >= 2 * fd.SMS
    assert (n - 1) * chunk < pos + 1 <= n * chunk


def test_split_plan_refuses_an_empty_range():
    with pytest.raises(ValueError, match="no visible key"):
        fd.split_plan(8, 8, 10, 9)


def test_bf16_hi_lo_split_keeps_p_to_2_pow_minus_16():
    """The premise of the bfloat16 route's P V product: p split into hi =
    bf16(p) and lo = bf16(p - hi), both exact in float32, gives back p to
    2^-16 relative (bf16 P alone keeps 2^-8)."""
    rng = np.random.RandomState(11)
    s = torch.tensor(rng.uniform(-60.0, 0.0, size=1 << 16).astype(np.float32))
    p = torch.exp(s)
    hi = p.bfloat16()
    lo = (p - hi.float()).bfloat16()
    back = hi.float() + lo.float()
    assert float(((back - p).abs() / p).max()) <= 2.0 ** -16
    assert float(((hi.float() - p).abs() / p).max()) > 2.0 ** -16


@pytest.fixture
def card():
    """The CUDA card and nvcc, or a skip naming what is missing."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is "
                    "False")
    try:
        build.find_nvcc()
    except RuntimeError as err:
        pytest.skip(f"needs nvcc: {err}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,kh,d,causal,win,cap", MHA_SWEEP)
def test_mha_kernel_matches_plain_on_card(card, b, s, h, kh, d, causal, win,
                                          cap, dtype):
    q, k, v = _t(*_mha_inputs(b, s, h, kh, d, seed=s + d), device=card,
                 dtype=dtype)
    launches = fa.LAUNCHES
    got = fa.mha(q, k, v, causal=causal, window=win, softcap=cap)
    again = fa.mha(q, k, v, causal=causal, window=win, softcap=cap)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == launches + 2
    assert torch.equal(got, again)
    ref = fa.mha_plain(q, k, v, causal=causal, window=win, softcap=cap)
    torch.testing.assert_close(got.float(), ref.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cap", [0.0, 30.0])
@pytest.mark.parametrize("b,s,h,kh,d,pos,win", DECODE_SWEEP)
def test_decode_kernel_matches_plain_on_card(card, b, s, h, kh, d, pos, win,
                                             cap, dtype):
    q, ck, cv = _t(*_decode_inputs(b, s, h, kh, d, seed=s + pos),
                   device=card, dtype=dtype)
    launches = fd.LAUNCHES
    got = fd.decode_attn(q, ck, cv, pos, window=win, softcap=cap)
    again = fd.decode_attn(q, ck, cv, pos, window=win, softcap=cap)
    torch.cuda.synchronize()
    assert fd.LAUNCHES == launches + 2
    assert torch.equal(got, again)
    ref = fd.decode_attn_plain(q, ck, cv, pos, window=win, softcap=cap)
    torch.testing.assert_close(got.float(), ref.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,kh,d,causal,win,cap,kv_len", MHA_TC_CASES)
def test_mha_tensor_core_route_matches_plain_on_card(card, b, s, h, kh, d,
                                                     causal, win, cap,
                                                     kv_len):
    q, k, v = _t(*_mha_inputs(b, s, h, kh, d, seed=s + d), device=card,
                 dtype=torch.bfloat16)
    kw = dict(causal=causal, window=win, softcap=cap, kv_len=kv_len)
    launches = fa.LAUNCHES
    got, again = fa.mha(q, k, v, **kw), fa.mha(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == launches + 2
    assert got.shape == q.shape and torch.equal(got, again)
    ref = fa.mha_plain(q, k, v, **kw)
    torch.testing.assert_close(got.float(), ref.float(),
                               atol=TOL[torch.bfloat16],
                               rtol=TOL[torch.bfloat16])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,kh,d,pos,win,cap", DECODE_SPLIT_CASES)
def test_decode_split_k_matches_plain_on_card(card, b, s, h, kh, d, pos,
                                              win, cap, dtype):
    q, ck, cv = _t(*_decode_inputs(b, s, h, kh, d, seed=s + pos),
                   device=card, dtype=dtype)
    launches = fd.LAUNCHES
    got = fd.decode_attn(q, ck, cv, pos, window=win, softcap=cap)
    again = fd.decode_attn(q, ck, cv, pos, window=win, softcap=cap)
    torch.cuda.synchronize()
    assert fd.LAUNCHES == launches + 2
    assert torch.equal(got, again)
    ref = fd.decode_attn_plain(q, ck, cv, pos, window=win, softcap=cap)
    torch.testing.assert_close(got.float(), ref.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,h,kh,d", CROSS_CASES)
def test_mha_cross_matches_plain_on_card(card, b, sq, sk, h, kh, d, dtype):
    """Sq != Sk, non-causal (cross-attention, whisper's encoder): one
    launch a call, repeats bit-equal, the plain version's values."""
    q, k, v = _t(*_mha_inputs(b, sq, h, kh, d, seed=sq + sk, sk=sk),
                 device=card, dtype=dtype)
    launches = fa.LAUNCHES
    got, again = fa.mha(q, k, v, causal=False), fa.mha(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == launches + 2
    assert got.shape == q.shape and torch.equal(got, again)
    ref = fa.mha_plain(q, k, v, causal=False)
    torch.testing.assert_close(got.float(), ref.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,kh,d,pos", CROSS_DECODE_CASES)
def test_decode_cross_matches_plain_on_card(card, b, s, h, kh, d, pos,
                                            dtype):
    q, ck, cv = _t(*_decode_inputs(b, s, h, kh, d, seed=s + pos),
                   device=card, dtype=dtype)
    launches = fd.LAUNCHES
    got = fd.decode_attn(q, ck, cv, pos)
    again = fd.decode_attn(q, ck, cv, pos)
    torch.cuda.synchronize()
    assert fd.LAUNCHES == launches + 2
    assert torch.equal(got, again)
    ref = fd.decode_attn_plain(q, ck, cv, pos)
    torch.testing.assert_close(got.float(), ref.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
