"""Partial attention over a slice of the keys or of the cache, merged across
ranks by log-sum-exp: the attention kernels' wrappers with ``k_offset`` /
``rows`` and ``return_lse`` (their plain versions on the CPU), and
``launch.collectives.merge_partials``.

Keys split as ``torch.chunk`` splits them (``models.sharding.
chunk_bounds``) into 2-4 slices; each slice's partial (0 and log-sum-exp
-inf for a row that sees none of its keys) merged by log-sum-exp equals
the plain version over every key, and the reference's jnp oracle
(``repro/kernels/flash_attention/ref.py``, ``flash_decode/ref.py``) in
float32, at the reference's tolerances (``tests/test_kernels.py``: 2e-5
in float32, 3e-2 in bfloat16).  The merge itself runs in a spawned gloo
world of 3 ranks, forward and gradient (atol 1e-4 / rtol 1e-3).  The
``cuda``-marked tests hold the kernels' new forms against their plain
versions on a card and skip without one, naming what is missing.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.flash_decode import ops as fd
from repro_torch.models.sharding import chunk_bounds

TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}

# (B, Sq, Sk, H, Kh, D, causal, window, softcap): causal rows that see no
# key of the later slices, a window narrower than a slice (rows that see
# none of the earlier ones), the softcap, GQA groups 1, 2 and 4, a
# cross-attention shape (Sq != Sk, non-causal)
MHA_CASES = [(2, 13, 13, 4, 2, 8, True, 0, 0.0),
             (2, 29, 29, 4, 1, 16, True, 5, 0.0),
             (1, 24, 24, 8, 2, 16, True, 9, 30.0),
             (2, 11, 23, 4, 4, 8, False, 0, 0.0),
             (1, 17, 17, 2, 2, 32, False, 0, 20.0)]
# (B, S, H, Kh, D, pos, window, softcap): the last row, mid-cache (later
# slices empty), a window inside one slice (earlier slices empty), GQA;
# the slices without a visible row are counted against the cut
DECODE_CASES = [(2, 16, 4, 2, 8, 15, 0, 0.0),
                (2, 16, 4, 2, 8, 6, 0, 0.0),
                (1, 24, 8, 2, 16, 20, 5, 0.0),
                (2, 20, 4, 1, 16, 13, 0, 30.0)]


def _t(rng, shape, dtype=torch.float32, device="cpu"):
    return torch.tensor(rng.randn(*shape).astype(np.float32),
                        device=device).to(dtype)


def _merge(outs, lses):
    """``merge_partials``'s formula over a list of partials on one
    process: sum_r w_r out_r / sum_r w_r, w_r = exp(lse_r - max_r lse_r)."""
    m = torch.stack(lses).amax(dim=0)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    w = [torch.exp(lse - m)[..., None] for lse in lses]
    num = sum(o.float() * wi for o, wi in zip(outs, w))
    den = sum(w)
    return num / torch.where(den > 0, den, torch.ones_like(den))


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,h,kh,d,causal,win,cap", MHA_CASES)
def test_mha_partials_merge_to_the_whole(b, sq, sk, h, kh, d, causal, win,
                                         cap, dtype, n):
    """Each slice's ``mha(..., k_offset=r0, return_lse=True)``: a row with
    no visible key of the slice is 0 with log-sum-exp -inf (some row of
    some slice is, in every case); merged, the partials equal ``mha`` over
    every key, and in float32 the reference's oracle."""
    import jax.numpy as jnp
    from repro.kernels.flash_attention.ref import attention_ref
    rng = np.random.RandomState(sq + sk + n)
    q = _t(rng, (b, sq, h, d), dtype)
    k, v = _t(rng, (b, sk, kh, d), dtype), _t(rng, (b, sk, kh, d), dtype)
    kw = dict(causal=causal, window=win, softcap=cap)
    outs, lses, empty = [], [], 0
    for r in range(n):
        lo, hi = chunk_bounds(sk, n, r)
        out, lse = fa.mha(q, k[:, lo:hi], v[:, lo:hi], k_offset=lo,
                          return_lse=True, **kw)
        assert out.dtype == dtype and lse.dtype == torch.float32
        assert lse.shape == (b, h, sq)
        none = torch.isinf(lse)
        assert bool((lse[none] < 0).all())
        assert float(out.float().permute(0, 2, 1, 3)[none].abs().max()
                     if none.any() else 0.0) == 0.0
        empty += int(none.any())
        outs.append(out)
        lses.append(lse.transpose(1, 2))
    assert empty or not causal and not win
    got = _merge(outs, lses)
    whole = fa.mha(q, k, v, **kw)
    torch.testing.assert_close(got, whole.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    _, lse_whole = fa.mha(q, k, v, return_lse=True, **kw)
    torch.testing.assert_close(
        torch.logsumexp(torch.stack(lses), dim=0), lse_whole.transpose(1, 2),
        atol=1e-5, rtol=1e-5)
    if dtype == torch.float32:
        oracle = attention_ref(*(jnp.asarray(x.numpy()).transpose(0, 2, 1, 3)
                                 for x in (q, k, v)), **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(oracle).transpose(
            0, 2, 1, 3), atol=2e-5, rtol=2e-5)


def test_mha_empty_slice_and_old_form():
    """A slice of no keys is answered without a launch (0, -inf); without
    ``return_lse`` a call with an offset keeps the mean-of-V convention
    for a row that sees no key, as ``k_offset=0`` does for ``kv_len``."""
    rng = np.random.RandomState(3)
    q = _t(rng, (1, 6, 2, 8))
    k, v = _t(rng, (1, 4, 2, 8)), _t(rng, (1, 4, 2, 8))
    out, lse = fa.mha(q, k[:, :0], v[:, :0], k_offset=4, return_lse=True)
    assert float(out.abs().max()) == 0.0 and bool(torch.isneginf(lse).all())
    with pytest.raises(ValueError, match="no keys"):
        fa.mha(q, k[:, :0], v[:, :0])
    late = fa.mha(q, k, v, k_offset=4)          # rows 0..3 see no key
    mean = v.float().mean(dim=1, keepdim=True).expand(1, 4, 2, 8)
    torch.testing.assert_close(late[:, :4], mean, atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="k_offset"):
        fa.mha(q, k, v, k_offset=-1)


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,kh,d,pos,win,cap", DECODE_CASES)
def test_decode_partials_merge_to_the_whole(b, s, h, kh, d, pos, win, cap,
                                            dtype, n):
    """Each slice's ``decode_attn(..., rows=visible_rows(...),
    return_lse=True)``, an empty range answered as 0 with -inf and no
    launch; merged, the partials equal ``decode_attn`` over the whole
    cache, and in float32 the reference's oracle (no softcap there)."""
    import jax.numpy as jnp
    from repro.kernels.flash_decode.ref import decode_ref
    rng = np.random.RandomState(s + pos + n)
    q = _t(rng, (b, 1, h, d), dtype)
    ck, cv = _t(rng, (b, s, kh, d), dtype), _t(rng, (b, s, kh, d), dtype)
    outs, lses, empty = [], [], 0
    for r in range(n):
        lo, hi = chunk_bounds(s, n, r)
        rows = fd.visible_rows(pos, win, lo, hi - lo)
        out, lse = fd.decode_attn(q, ck[:, lo:hi], cv[:, lo:hi], pos,
                                  window=win, softcap=cap, rows=rows,
                                  return_lse=True)
        assert lse.shape == (b, h) and lse.dtype == torch.float32
        if rows[0] == rows[1]:
            empty += 1
            assert float(out.abs().max()) == 0.0
            assert bool(torch.isneginf(lse).all())
        outs.append(out)
        lses.append(lse[:, None])
    kbeg = max(0, pos - win + 1) if win else 0
    assert empty == sum(lo > pos or hi <= kbeg for lo, hi in (
        chunk_bounds(s, n, r) for r in range(n)))
    got = _merge(outs, lses)
    whole = fd.decode_attn(q, ck, cv, pos, window=win, softcap=cap)
    torch.testing.assert_close(got, whole.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    if dtype == torch.float32 and not cap:
        oracle = decode_ref(jnp.asarray(q.numpy())[:, 0],
                            jnp.asarray(ck.numpy()).transpose(0, 2, 1, 3),
                            jnp.asarray(cv.numpy()).transpose(0, 2, 1, 3),
                            jnp.int32(pos), window=win)[:, None]
        np.testing.assert_allclose(got.numpy(), np.asarray(oracle),
                                   atol=2e-5, rtol=2e-5)


def test_visible_rows_and_range_checks():
    """``visible_rows`` clips the token's rows to a slice, local to it;
    ``rows`` outside the cache raise."""
    assert fd.visible_rows(10, 0, 8, 4) == (0, 3)
    assert fd.visible_rows(10, 0, 12, 4) == (0, 0)
    assert fd.visible_rows(10, 3, 0, 8) == (8, 8)
    assert fd.visible_rows(10, 3, 8, 4) == (0, 3)
    assert fd.visible_rows(9, 4, 4, 4) == (2, 4)
    rng = np.random.RandomState(0)
    q, ck = _t(rng, (1, 1, 2, 8)), _t(rng, (1, 4, 2, 8))
    with pytest.raises(ValueError, match="r0"):
        fd.decode_attn(q, ck, ck, 20, rows=(1, 5))
    with pytest.raises(ValueError, match="r0"):
        fd.decode_attn(q, ck, ck, 20, rows=(3, 2))


def _world_merge(rank, world, q, k, v, g, opts):
    """Rank ``rank``'s slice of the keys: its partial, merged over the
    world by ``merge_partials``, and the gradients of <merged, g>, as
    numpy arrays (a tensor would cross to the parent as a file descriptor
    of shared memory that the exiting child takes with it)."""
    import torch.distributed as dist
    from repro_torch.launch.collectives import merge_partials
    lo, hi = chunk_bounds(k.shape[1], world, rank)
    q = q.clone().requires_grad_(True)
    ks = k[:, lo:hi].clone().requires_grad_(True)
    vs = v[:, lo:hi].clone().requires_grad_(True)
    out, lse = fa.mha(q, ks, vs, k_offset=lo, return_lse=True, **opts)
    merged = merge_partials(out, lse.transpose(1, 2), (dist.group.WORLD,))
    gq, gk, gv = torch.autograd.grad((merged * g).sum(), (q, ks, vs))
    return tuple(t.detach().numpy() for t in (merged, gq, gk, gv))


@pytest.mark.parametrize("opts", [dict(causal=True, window=0, softcap=0.0),
                                  dict(causal=True, window=6, softcap=30.0)])
def test_merge_partials_forward_and_gradient_in_a_world(tmp_path, opts):
    """3 gloo ranks, 20 keys (7 / 7 / 6): every rank's merged output equals
    ``mha`` over every key, and the gradients equal the whole op's: q's
    summed over the ranks (each holds its part), k's and v's the ranks'
    slices in order."""
    from repro_torch.launch.world import run_world
    rng = np.random.RandomState(5)
    b, s, h, kh, d = 2, 20, 4, 2, 8
    q, k, v = _t(rng, (b, s, h, d)), _t(rng, (b, s, kh, d)), \
        _t(rng, (b, s, kh, d))
    g = _t(rng, (b, s, h, d))
    res = [[torch.from_numpy(a) for a in r] for r in run_world(
        _world_merge, 3, str(tmp_path), timeout=120, args=(q, k, v, g, opts))]
    qq, kk, vv = (x.clone().requires_grad_(True) for x in (q, k, v))
    whole = fa.mha(qq, kk, vv, **opts)
    gq, gk, gv = torch.autograd.grad((whole * g).sum(), (qq, kk, vv))
    for merged, *_ in res:
        torch.testing.assert_close(merged, whole.detach(), atol=1e-5,
                                   rtol=1e-5)
    torch.testing.assert_close(sum(r[1] for r in res), gq, atol=1e-4,
                               rtol=1e-3)
    torch.testing.assert_close(torch.cat([r[2] for r in res], dim=1), gk,
                               atol=1e-4, rtol=1e-3)
    torch.testing.assert_close(torch.cat([r[3] for r in res], dim=1), gv,
                               atol=1e-4, rtol=1e-3)


# ------------------------------------------------------------- on a card
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
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,h,kh,d,causal,win,cap", MHA_CASES + [
    (2, 300, 300, 8, 4, 128, True, 0, 0.0),
    (1, 400, 400, 4, 2, 256, True, 130, 50.0)])
def test_mha_partial_kernel_matches_plain_on_card(card, b, sq, sk, h, kh, d,
                                                  causal, win, cap, dtype):
    """Each of 3 slices: the kernel's (out, lse) against the plain
    version's, bit-equal twice, one launch a non-empty slice; the whole
    call's out unchanged by ``return_lse``."""
    rng = np.random.RandomState(sq + d)
    q = _t(rng, (b, sq, h, d), dtype, card)
    k, v = _t(rng, (b, sk, kh, d), dtype, card), \
        _t(rng, (b, sk, kh, d), dtype, card)
    kw = dict(causal=causal, window=win, softcap=cap)
    for r in range(3):
        lo, hi = chunk_bounds(sk, 3, r)
        args = (q, k[:, lo:hi], v[:, lo:hi])
        launches = fa.LAUNCHES
        got = fa.mha(*args, k_offset=lo, return_lse=True, **kw)
        again = fa.mha(*args, k_offset=lo, return_lse=True, **kw)
        torch.cuda.synchronize()
        assert fa.LAUNCHES == launches + 2
        assert all(torch.equal(a, b_) for a, b_ in zip(got, again))
        want = fa.mha_plain(*args, k_offset=lo, return_lse=True, **kw)
        torch.testing.assert_close(got[0].float(), want[0].float(),
                                   atol=TOL[dtype], rtol=TOL[dtype])
        fin = torch.isfinite(want[1])
        assert torch.equal(torch.isfinite(got[1]), fin)
        torch.testing.assert_close(got[1][fin], want[1][fin], atol=1e-3,
                                   rtol=1e-4)
    assert torch.equal(fa.mha(q, k, v, **kw),
                       fa.mha(q, k, v, return_lse=True, **kw)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,kh,d,pos,win,cap", DECODE_CASES + [
    (8, 1104, 16, 8, 128, 1000, 0, 0.0), (2, 1024, 8, 4, 256, 700, 300, 50.0)])
def test_decode_partial_kernel_matches_plain_on_card(card, b, s, h, kh, d,
                                                     pos, win, cap, dtype):
    """Each of 4 slices: the kernel's (out, lse) over its visible rows
    against the plain version's; an empty range launches nothing; the
    whole call's out unchanged by ``rows`` and ``return_lse``."""
    rng = np.random.RandomState(s + pos)
    q = _t(rng, (b, 1, h, d), dtype, card)
    ck, cv = _t(rng, (b, s, kh, d), dtype, card), \
        _t(rng, (b, s, kh, d), dtype, card)
    kw = dict(window=win, softcap=cap)
    for r in range(4):
        lo, hi = chunk_bounds(s, 4, r)
        rows = fd.visible_rows(pos, win, lo, hi - lo)
        args = (q, ck[:, lo:hi], cv[:, lo:hi], pos)
        launches = fd.LAUNCHES
        got = fd.decode_attn(*args, rows=rows, return_lse=True, **kw)
        again = fd.decode_attn(*args, rows=rows, return_lse=True, **kw)
        torch.cuda.synchronize()
        assert fd.LAUNCHES == launches + 2 * (rows[1] > rows[0])
        assert all(torch.equal(a, b_) for a, b_ in zip(got, again))
        want = fd.decode_attn_plain(*args, rows=rows, return_lse=True, **kw)
        torch.testing.assert_close(got[0].float(), want[0].float(),
                                   atol=TOL[dtype], rtol=TOL[dtype])
        torch.testing.assert_close(got[1], want[1], atol=1e-3, rtol=1e-4)
    kbeg = max(0, pos - win + 1) if win else 0
    assert torch.equal(
        fd.decode_attn(q, ck, cv, pos, **kw),
        fd.decode_attn(q, ck, cv, pos, rows=(kbeg, pos + 1),
                       return_lse=True, **kw)[0])


def test_lse_is_the_log_partition():
    """The whole call's log-sum-exp is log sum exp of the scaled, capped,
    masked logits (a row's normaliser), by a direct computation."""
    rng = np.random.RandomState(9)
    q, k, v = _t(rng, (1, 5, 2, 4)), _t(rng, (1, 5, 2, 4)), \
        _t(rng, (1, 5, 2, 4))
    _, lse = fa.mha(q, k, v, window=2, softcap=3.0, return_lse=True)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(4)
    s = torch.tanh(s / 3.0) * 3.0
    i = torch.arange(5)
    keep = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < 2)
    want = torch.logsumexp(s.masked_fill(~keep, -math.inf), dim=-1)
    torch.testing.assert_close(lse, want, atol=1e-6, rtol=1e-6)
