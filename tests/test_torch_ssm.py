"""The port's xLSTM mixers and the chunkwise mLSTM op against the JAX
reference, the op's wrapper refusals, and (on a card) the CUDA kernel
against its plain version.

Inputs are seeded numpy arrays fed to both packages, float32 on the CPU.
Tolerances: the reference's own 2e-4 (``tests/test_kernels.py:82,101``)
wherever two chunkwise forms of the mLSTM are compared (other chunk sizes
or another summation order over a chunk of up to 256 rows, and the
mLSTM mixer built on them), 1e-5 for the per-token recurrences (decode
steps, the sLSTM loop; ``tests/test_torch_lm.py``'s), and 1e-6 for the
elementwise gate functions.  The ``cuda``-marked tests need an
NVIDIA card and ``nvcc`` and skip without them, naming what is missing; on
a machine with a card run them with ``python -m pytest -m cuda
tests/test_torch_ssm.py`` (the reference is imported inside the CPU tests,
so this file also loads where JAX is not installed).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.kernels import build
from repro_torch.kernels.mlstm_chunk import ops
from repro_torch.models import ssm


class _Elsewhere(torch.Tensor):
    """A CPU tensor that reports another device (xpu): the wrappers refuse
    any device but the CPU, a card and meta, which takes the card's route
    without launching."""

    @property
    def device(self):
        return torch.device("xpu")


def _elsewhere(t: torch.Tensor) -> torch.Tensor:
    return t.as_subclass(_Elsewhere)


CHUNK_TOL = 2e-4        # the reference's, between two chunkwise forms
TOL = 1e-5              # per-token recurrences and mixers
# bf16 h: one bf16 step (2^-7 of the value) where the float32 results of
# two summation orders straddle a rounding boundary
BF16_STEP = 2.0 ** -7
# (B, S, H, D, chunk): tests/test_kernels.py's mLSTM sweep
SWEEP = [(2, 128, 2, 32, 32), (1, 256, 4, 64, 64), (1, 64, 1, 128, 16)]
# (B, S, H, D): one chunk of S < 256, several of 256, the model's D
SCAN_SHAPES = [(2, 64, 2, 32), (2, 512, 2, 16), (1, 256, 4, 64),
               (1, 512, 1, 256)]


def _inputs(b, s, h, d, seed):
    """q, k, v (B, S, H, D), log input gate, forget gate before its
    log-sigmoid (B, S, H), as tests/test_kernels.py draws them."""
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, s, h, d).astype(np.float32) for _ in range(3))
    ig = rng.randn(b, s, h).astype(np.float32)
    fg = (rng.randn(b, s, h) + 2).astype(np.float32)
    return q, k, v, ig, fg


def _t(*arrays, device="cpu", dtype=torch.float32):
    return tuple(torch.tensor(a, device=device, dtype=dtype) for a in arrays)


def _op_args(arrays, device="cpu", dtype=torch.float32):
    """The op's tensors: q, k, v in ``dtype``, gates float32."""
    q, k, v, ig, fg = arrays
    return _t(q, k, v, device=device, dtype=dtype) + \
        _t(ig, fg, device=device)


def _close(got, ref, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(ref, np.float32), atol=tol,
                               rtol=tol)


# Inputs that move the kernel off the common path: "floor" makes |den| < 1
# at almost every row, so h is num itself (the floor of max(|den|, 1)): q
# scaled by 1/8, since a constant shift of the gates cancels against the
# stabiliser m; "big_i" makes m_t the intra-chunk max (i_s dominates
# F_t + m_prev); "decay" drives f far below 0, so that the state decays to
# 0 within a chunk and g, w_t, e_s underflow
GATE_KINDS = ("floor", "big_i", "decay")


def _gated(arrays, kind):
    q, k, v, ig, fg = arrays
    if kind == "floor":
        q = q / 8.0
    elif kind == "big_i":
        ig = 8.0 * ig + 10.0
    elif kind == "decay":
        fg = fg - 40.0
    return q.astype(np.float32), k, v, ig.astype(np.float32), \
        fg.astype(np.float32)


def test_gate_functions_match_jax():
    """``log_sigmoid`` and ``silu`` agree with ``jax.nn`` at 1e-6, edge
    points included (0, -0, tiny, the exp overflow range)."""
    import jax
    import jax.numpy as jnp
    x = np.concatenate([np.linspace(-100, 100, 20001),
                        [0.0, -0.0, 1e-8, -1e-8, 88.7, -88.7, 104.0,
                         -104.0, 1e3, -1e3]]).astype(np.float32)
    got = ops.log_sigmoid(torch.tensor(x)).numpy()
    _close(got, jax.nn.log_sigmoid(jnp.asarray(x)), 1e-6)
    assert np.all(np.isfinite(got))
    _close(ssm.silu(torch.tensor(x)).numpy(), jax.nn.silu(jnp.asarray(x)),
           1e-6)


def _check_against_pallas(arrays, chunk):
    """``mlstm_plain`` against the reference's Pallas kernel (interpret
    mode) and its fully recurrent oracle, at CHUNK_TOL."""
    import jax.numpy as jnp
    from repro.kernels.mlstm_chunk.ops import mlstm as ref_mlstm
    from repro.kernels.mlstm_chunk.ref import mlstm_recurrent_ref
    got = ops.mlstm_plain(*_op_args(arrays), chunk=chunk)
    q, k, v, ig, fg = (jnp.asarray(a) for a in arrays)
    _close(got.numpy(), ref_mlstm(q, k, v, ig, fg, chunk=chunk), CHUNK_TOL)
    oracle = mlstm_recurrent_ref(
        q.transpose(0, 2, 1, 3), k.transpose(0, 2, 1, 3),
        v.transpose(0, 2, 1, 3), ig.transpose(0, 2, 1),
        fg.transpose(0, 2, 1)).transpose(0, 2, 1, 3)
    _close(got.numpy(), oracle, CHUNK_TOL)


@pytest.mark.parametrize("b,s,h,d,chunk", SWEEP)
def test_mlstm_plain_matches_pallas_reference(b, s, h, d, chunk):
    """Against the reference's Pallas kernel (interpret mode) and its
    fully recurrent oracle, as tests/test_kernels.py runs them."""
    _check_against_pallas(_inputs(b, s, h, d, seed=s + d), chunk)


@pytest.mark.parametrize("kind", GATE_KINDS)
@pytest.mark.parametrize("b,s,h,d,chunk", SWEEP)
def test_mlstm_plain_matches_pallas_reference_on_gate_kinds(b, s, h, d,
                                                            chunk, kind):
    """The same on the inputs that move the tensor-core route off its
    common path (|den| < 1, an intra-chunk m_t, a state that decays to
    0), so that the card's kernel, held against ``mlstm_plain`` on them,
    is held against the reference too."""
    _check_against_pallas(_gated(_inputs(b, s, h, d, seed=s + d), kind),
                          chunk)


def _check_against_chunk_scan(arrays):
    """h and the final state (C, n, m) of ``mlstm_plain`` against
    ``mlstm_chunk_scan`` at CHUNK_TOL."""
    import jax
    import jax.numpy as jnp
    from repro.models.ssm import mlstm_chunk_scan
    d = arrays[0].shape[-1]
    got, state = ops.mlstm_plain(*_op_args(arrays), chunk=ssm.CHUNK,
                                 return_state=True)
    q, k, v, ig, fg = (jnp.asarray(a) for a in arrays)
    ref, rstate = mlstm_chunk_scan(q, k / np.sqrt(d), v, ig,
                                   jax.nn.log_sigmoid(fg))
    _close(got.numpy(), ref, CHUNK_TOL)
    assert set(state) == set(rstate) == {"C", "n", "m"}
    for key in state:
        assert state[key].shape == rstate[key].shape
        _close(state[key].numpy(), rstate[key], CHUNK_TOL)


@pytest.mark.parametrize("b,s,h,d", SCAN_SHAPES)
def test_mlstm_plain_matches_chunk_scan(b, s, h, d):
    """h and the final state (C, n, m) against the model's jnp twin of the
    kernel, ``mlstm_chunk_scan``, which takes k scaled and the forget
    gate's log-sigmoid."""
    _check_against_chunk_scan(_inputs(b, s, h, d, seed=3 * s + d))


@pytest.mark.parametrize("kind", GATE_KINDS)
@pytest.mark.parametrize("b,s,h,d", SCAN_SHAPES)
def test_mlstm_plain_matches_chunk_scan_on_gate_kinds(b, s, h, d, kind):
    """The same on the tensor-core route's edge-case inputs."""
    _check_against_chunk_scan(_gated(_inputs(b, s, h, d, seed=3 * s + d),
                                     kind))


@pytest.mark.parametrize("b,s,h,d", [(2, 512, 2, 16), (1, 256, 3, 64)])
def test_mlstm_plain_chunk_invariance(b, s, h, d):
    """m_t is the recurrence's max(lf + m, i), so the result does not
    depend on the chunk: 64 against the model's 256, state included."""
    args = _op_args(_inputs(b, s, h, d, seed=s - d))
    a, sa = ops.mlstm_plain(*args, chunk=64, return_state=True)
    z, sz = ops.mlstm_plain(*args, chunk=256, return_state=True)
    torch.testing.assert_close(a, z, atol=CHUNK_TOL, rtol=CHUNK_TOL)
    for key in sa:
        torch.testing.assert_close(sa[key], sz[key], atol=CHUNK_TOL,
                                   rtol=CHUNK_TOL)


def test_mlstm_bf16_goes_through_float32():
    """bf16 q, k, v go through float32 and h comes back in bf16."""
    args = _op_args(_inputs(1, 64, 2, 32, seed=5), dtype=torch.bfloat16)
    out = ops.mlstm(*args, chunk=32)
    assert out.dtype == torch.bfloat16
    ref = ops.mlstm_plain(*(t.float() for t in args), chunk=32)
    torch.testing.assert_close(out, ref.to(torch.bfloat16), atol=0, rtol=0)


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _hi_lo(x):
    """float32 x as the two bf16 operands the tensor-core route feeds the
    tensor cores for it: hi = bf16(x), lo = bf16(x - hi)."""
    hi = _bf16(x)
    return hi, _bf16(x - hi)


def _mlstm_tensor_core_emulation(q, k, v, i, f, chunk=64):
    """The bf16 route of ``csrc/mlstm_chunk.cu`` in plain torch, with its
    roundings: chunks of 64; scores from the bf16 q, k (exact products)
    divided by sqrt(D); every float32 operand of a product (the weighted
    scores W before V, C before q, k e / sqrt(D) before V) split into bf16
    hi + lo and the two products summed in float32; q.n and n's update in
    float32.  Only the summation order inside a product differs from the
    card.  S must be a multiple of ``chunk``."""
    b, s, h, d = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    ig, lf = i.float(), ops.log_sigmoid(f.float())
    C = torch.zeros((b, h, d, d))
    n = torch.zeros((b, h, d))
    m = torch.full((b, h), ops.M_INIT)
    causal = torch.ones((chunk, chunk), dtype=torch.bool).tril()[None, :, :,
                                                                 None]
    outs = []
    for c0 in range(0, s, chunk):
        qc, kc, vc = (x[:, c0:c0 + chunk] for x in (qf, kf, vf))
        ic, lfc = ig[:, c0:c0 + chunk], lf[:, c0:c0 + chunk]
        F = torch.cumsum(lfc, dim=1)
        dm = F[:, :, None, :] - F[:, None, :, :] + ic[:, None, :, :]
        m_intra = torch.where(causal, dm, -torch.inf).amax(dim=2)
        m_inter = F + m[:, None, :]
        m_t = torch.maximum(m_intra, m_inter)
        scores = torch.einsum("blhd,bshd->blsh", qc, kc) / np.sqrt(d)
        ws = torch.where(causal, torch.exp(dm - m_t[:, :, None, :]) * scores,
                         0.0)
        w_inter = torch.exp(m_inter - m_t)
        qC = sum(torch.einsum("blhd,bhde->blhe", qc, part)
                 for part in _hi_lo(C))
        wV = sum(torch.einsum("blsh,bshd->blhd", part, vc)
                 for part in _hi_lo(ws))
        num = w_inter[..., None] * qC + wV
        den = ws.sum(dim=2) + w_inter * torch.einsum("blhd,bhd->blh", qc, n)
        outs.append(num / torch.clamp_min(den.abs(), 1.0)[..., None])
        f_tot, m_end = F[:, -1], m_t[:, -1]
        g_old = torch.exp(f_tot + m - m_end)
        e = torch.exp(f_tot[:, None] - F + ic - m_end[:, None]) / np.sqrt(d)
        ke = kc * e[..., None]
        C = g_old[:, :, None, None] * C + sum(
            torch.einsum("blhd,blhe->bhde", part, vc) for part in _hi_lo(ke))
        n = g_old[:, :, None] * n + ke.sum(dim=1)
        m = m_end
    return torch.cat(outs, dim=1).to(q.dtype), {"C": C, "n": n, "m": m}


@pytest.mark.parametrize("kind", ("random",) + GATE_KINDS)
def test_tensor_core_split_emulation_within_tolerance(kind):
    """xlstm-350m's head shape (H 4, D 256) in bf16: the tensor-core
    route's hi + lo products, emulated in plain torch, against
    ``mlstm_plain`` at the card's tolerances (h: 2e-4 plus one bf16 step;
    the float32 state: 2e-4)."""
    cfg = get_config("xlstm-350m")
    h, d = cfg.n_heads, cfg.d_head
    assert (h, d) == (4, 256)
    args = _op_args(_gated(_inputs(1, 512, h, d, seed=21), kind),
                    dtype=torch.bfloat16)
    got, state = _mlstm_tensor_core_emulation(*args)
    ref, rstate = ops.mlstm_plain(*args, chunk=ssm.CHUNK, return_state=True)
    torch.testing.assert_close(got.float(), ref.float(), atol=CHUNK_TOL,
                               rtol=BF16_STEP)
    for key in state:
        torch.testing.assert_close(state[key], rstate[key], atol=CHUNK_TOL,
                                   rtol=CHUNK_TOL)


# --------------------------------------------------------------- the mixers
@pytest.fixture(scope="module")
def cfgs():
    """(port cfg, reference cfg): xlstm-350m's smoke config, float32."""
    from repro.configs.base import ModelConfig
    cfg = smoke_config(get_config("xlstm-350m"))
    return cfg, ModelConfig(**dataclasses.asdict(cfg))


def _mixer(kind, rcfg, seed):
    """The reference's init of one mixer, and the same as tensors."""
    import jax
    from repro.models import ssm as ref_ssm
    init = {"mlstm": ref_ssm.init_mlstm, "slstm": ref_ssm.init_slstm}[kind]
    rp = init(jax.random.PRNGKey(seed), rcfg)
    return rp, {k: torch.tensor(np.asarray(v)) for k, v in rp.items()}


def _state(tree):
    return {k: torch.tensor(np.asarray(v)) for k, v in tree.items()}


def _assert_state(got, ref, tol=TOL):
    assert set(got) == set(ref)
    for key in got:
        _close(got[key].numpy(), ref[key], tol)


@pytest.mark.parametrize("s", [7, 256, 512])
def test_mlstm_forward_matches_reference(cfgs, s):
    """The mixer's prefill (projections, the op at chunk 256, the silu
    gate and the out projection), with its state."""
    import jax.numpy as jnp
    from repro.models import ssm as ref_ssm
    cfg, rcfg = cfgs
    rp, p = _mixer("mlstm", rcfg, seed=1)
    u = np.random.RandomState(s).randn(2, s, cfg.d_model).astype(np.float32)
    out, state = ssm.mlstm_forward(p, cfg, torch.tensor(u), return_state=True)
    rout, rstate = ref_ssm.mlstm_forward(rp, rcfg, jnp.asarray(u),
                                         return_state=True)
    _close(out.numpy(), rout, CHUNK_TOL)
    _assert_state(state, rstate, CHUNK_TOL)


def test_mlstm_forward_refuses_a_ragged_chunk(cfgs):
    cfg, rcfg = cfgs
    _, p = _mixer("mlstm", rcfg, seed=1)
    with pytest.raises(ValueError, match="ssm.py:177"):
        ssm.mlstm_forward(p, cfg, torch.zeros(1, 300, cfg.d_model))


def test_mlstm_step_matches_reference(cfgs):
    """Three chained decode steps from a prefill state of the reference."""
    import jax.numpy as jnp
    from repro.models import ssm as ref_ssm
    cfg, rcfg = cfgs
    rp, p = _mixer("mlstm", rcfg, seed=2)
    rng = np.random.RandomState(7)
    u = rng.randn(2, 9, cfg.d_model).astype(np.float32)
    _, rstate = ref_ssm.mlstm_forward(rp, rcfg, jnp.asarray(u[:, :6]),
                                      return_state=True)
    state = _state(rstate)
    for t in range(6, 9):
        out, state = ssm.mlstm_step(p, cfg, torch.tensor(u[:, t:t + 1]),
                                    state)
        rout, rstate = ref_ssm.mlstm_step(rp, rcfg, jnp.asarray(u[:, t:t + 1]),
                                          rstate)
        _close(out.numpy(), rout, TOL)
        _assert_state(state, rstate)


def test_mlstm_step_continues_the_forward(cfgs):
    """Port only: prefill over S tokens then one step equals the forward
    over S + 1 tokens at its last position."""
    cfg, rcfg = cfgs
    _, p = _mixer("mlstm", rcfg, seed=3)
    u = torch.tensor(np.random.RandomState(8).randn(2, 12, cfg.d_model)
                     .astype(np.float32))
    full = ssm.mlstm_forward(p, cfg, u)
    _, state = ssm.mlstm_forward(p, cfg, u[:, :11], return_state=True)
    out, _ = ssm.mlstm_step(p, cfg, u[:, 11:], state)
    torch.testing.assert_close(out[:, 0], full[:, 11], atol=TOL, rtol=TOL)


def test_slstm_forward_matches_reference(cfgs):
    """The sequential prefill loop, output and final (h, c, n, m)."""
    import jax.numpy as jnp
    from repro.models import ssm as ref_ssm
    cfg, rcfg = cfgs
    rp, p = _mixer("slstm", rcfg, seed=4)
    u = np.random.RandomState(9).randn(2, 13, cfg.d_model).astype(np.float32)
    out, state = ssm.slstm_forward(p, cfg, torch.tensor(u), return_state=True)
    rout, rstate = ref_ssm.slstm_forward(rp, rcfg, jnp.asarray(u),
                                         return_state=True)
    _close(out.numpy(), rout, TOL)
    _assert_state(state, rstate)
    assert set(state) == {"h", "c", "n", "m"}


def test_slstm_step_matches_reference(cfgs):
    """Chained steps from the zero state and from a prefill state."""
    import jax.numpy as jnp
    from repro.models import ssm as ref_ssm
    cfg, rcfg = cfgs
    rp, p = _mixer("slstm", rcfg, seed=5)
    u = np.random.RandomState(10).randn(2, 8, cfg.d_model).astype(np.float32)
    rstate = ref_ssm.slstm_init_state(rcfg, 2)
    state = ssm.slstm_init_state(cfg, 2, torch.device("cpu"))
    _assert_state(state, rstate, 0.0)
    for t in range(3):
        out, state = ssm.slstm_step(p, cfg, torch.tensor(u[:, t:t + 1]),
                                    state)
        rout, rstate = ref_ssm.slstm_step(rp, rcfg, jnp.asarray(u[:, t:t + 1]),
                                          rstate)
        _close(out.numpy(), rout, TOL)
        _assert_state(state, rstate)
    _, rstate = ref_ssm.slstm_forward(rp, rcfg, jnp.asarray(u[:, :5]),
                                      return_state=True)
    out, state = ssm.slstm_step(p, cfg, torch.tensor(u[:, 5:6]),
                                _state(rstate))
    rout, rstate = ref_ssm.slstm_step(rp, rcfg, jnp.asarray(u[:, 5:6]), rstate)
    _close(out.numpy(), rout, TOL)
    _assert_state(state, rstate)


def test_init_states_match_reference(cfgs):
    from repro.models import ssm as ref_ssm
    cfg, rcfg = cfgs
    cpu = torch.device("cpu")
    _assert_state(ssm.mlstm_init_state(cfg, 3, cpu),
                  ref_ssm.mlstm_init_state(rcfg, 3), 0.0)
    _assert_state(ssm.slstm_init_state(cfg, 3, cpu),
                  ref_ssm.slstm_init_state(rcfg, 3), 0.0)


# -------------------------------------------------------------- the wrapper
def test_wrapper_runs_plain_on_cpu_without_a_launch():
    args = _op_args(_inputs(2, 64, 2, 16, seed=11))
    before = ops.LAUNCHES
    got, state = ops.mlstm(*args, chunk=32, return_state=True)
    ref, rstate = ops.mlstm_plain(*args, chunk=32, return_state=True)
    assert torch.equal(got, ref)
    assert all(torch.equal(state[k], rstate[k]) for k in state)
    assert torch.equal(ops.mlstm(*args, chunk=32), ref)
    assert ops.LAUNCHES == before


def test_wrapper_refuses_bad_inputs():
    q, k, v, i, f = _op_args(_inputs(1, 64, 2, 16, seed=12))
    with pytest.raises(ValueError, match="several devices"):
        ops.mlstm(q, k.to("meta"), v, i, f)
    with pytest.raises(ValueError, match="several devices"):
        ops.mlstm(q, k, v, i, f.to("meta"))
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.mlstm(*map(_elsewhere, (q, k, v, i, f)))
    with pytest.raises(TypeError, match="dtype"):
        ops.mlstm(q.half(), k.half(), v.half(), i, f)
    with pytest.raises(TypeError, match="dtype"):
        ops.mlstm(q, k.bfloat16(), v, i, f)
    with pytest.raises(TypeError, match="gates"):
        ops.mlstm(q, k, v, i.double(), f)
    with pytest.raises(ValueError, match="ssm.py:177"):
        ops.mlstm(q, k, v, i, f, chunk=48)
    with pytest.raises(ValueError, match="ssm.py:177"):
        ops.mlstm(q, k, v, i, f, chunk=0)
    with pytest.raises(ValueError, match=r"\(B, S, H, D\)"):
        ops.mlstm(q, k, v[:, :32], i, f)
    with pytest.raises(ValueError, match=r"\(B, S, H, D\)"):
        ops.mlstm(q[0], k[0], v[0], i, f)
    with pytest.raises(ValueError, match="gates"):
        ops.mlstm(q, k, v, i[:, :32], f)
    with pytest.raises(ValueError, match="head dim"):
        ops.mlstm(q[..., :12], k[..., :12], v[..., :12], i, f)
    with pytest.raises(ValueError, match="contiguous"):
        qt = q.transpose(1, 2).contiguous().transpose(1, 2)
        ops.mlstm(qt, k, v, i, f)
    with pytest.raises(ValueError, match="empty"):
        ops.mlstm(q[:, :0], k[:, :0], v[:, :0], i[:, :0], f[:, :0])


# ----------------------------------------------------------------- the card
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


# the sweep, then a ragged last kernel chunk (S = 48) and the model's D
CARD_CASES = SWEEP + [(2, 48, 3, 32, 16), (2, 256, 4, 256, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,d,chunk", CARD_CASES)
def test_kernel_matches_plain_on_card(card, b, s, h, d, chunk, dtype):
    """h and the state against the plain version at its chunk (float32:
    the reference's 2e-4 between chunk sizes; bfloat16: one bf16 step of
    h, 2e-2 relative, and the state at 2e-4 as it is float32 from the same
    bf16 inputs), and two launches bit-equal."""
    args = _op_args(_inputs(b, s, h, d, seed=s + d), device=card,
                    dtype=dtype)
    launches = ops.LAUNCHES
    got, state = ops.mlstm(*args, chunk=chunk, return_state=True)
    again, state2 = ops.mlstm(*args, chunk=chunk, return_state=True)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == launches + 2
    assert torch.equal(got, again)
    assert all(torch.equal(state[k], state2[k]) for k in state)
    ref, rstate = ops.mlstm_plain(*args, chunk=chunk, return_state=True)
    tol = CHUNK_TOL if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=tol)
    for key in state:
        torch.testing.assert_close(state[key], rstate[key], atol=CHUNK_TOL,
                                   rtol=CHUNK_TOL)


# the bf16 route's own cases, (B, S, H, D, caller chunk, gates): S ragged
# against its 64-row chunk (48, 96, 1000), D in {16, 64, 256}, and the gate
# kinds that leave the common path
TC_CASES = [(2, 48, 3, 64, 16, "random"), (1, 96, 2, 64, 32, "random"),
            (1, 1000, 2, 64, 200, "random"), (2, 96, 2, 16, 32, "random"),
            (1, 96, 1, 256, 32, "random")] + \
    [(1, 256, 2, d, 64, kind) for d in (16, 64, 256) for kind in GATE_KINDS]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,d,chunk,kind", TC_CASES)
def test_tensor_core_route_on_card(card, b, s, h, d, chunk, kind):
    """bf16 q, k, v: h against the plain version within 2e-4 plus one bf16
    step, the float32 state within 2e-4, and two launches bit-equal."""
    args = _op_args(_gated(_inputs(b, s, h, d, seed=s + d + 7), kind),
                    device=card, dtype=torch.bfloat16)
    launches = ops.LAUNCHES
    got, state = ops.mlstm(*args, chunk=chunk, return_state=True)
    again, state2 = ops.mlstm(*args, chunk=chunk, return_state=True)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == launches + 2
    assert torch.equal(got, again)
    assert all(torch.equal(state[k], state2[k]) for k in state)
    ref, rstate = ops.mlstm_plain(*args, chunk=chunk, return_state=True)
    torch.testing.assert_close(got.float(), ref.float(), atol=CHUNK_TOL,
                               rtol=BF16_STEP)
    for key in state:
        torch.testing.assert_close(state[key], rstate[key], atol=CHUNK_TOL,
                                   rtol=CHUNK_TOL)


@pytest.mark.cuda
def test_wrapper_refuses_a_mix_on_card(card):
    q, k, v, i, f = _op_args(_inputs(1, 64, 2, 16, seed=13), device=card)
    with pytest.raises(ValueError, match="several devices"):
        ops.mlstm(q, k, v, i.cpu(), f)
    launches = ops.LAUNCHES
    with pytest.raises(ValueError, match="ssm.py:177"):
        ops.mlstm(q, k, v, i, f, chunk=48)
    assert ops.LAUNCHES == launches
