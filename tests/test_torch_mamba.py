"""The port's Mamba mixer, its selective-scan op and the MoE FFN against the
JAX reference, the op's wrapper refusals, and (on a card) the CUDA kernel
against its plain version.

Inputs are seeded numpy arrays fed to both packages, float32 on the CPU.
Tolerances: 1e-5 where two strict recurrences (or the same products) are
compared, step for step in float32; 2e-4, the reference's own
(``tests/test_new_substrate.py:29,51-52``), where the recurrence is held
against the reference model's associative scan or the chunked Pallas form,
which sum in another order; 1e-6 for the elementwise softplus; the MoE's
gradients at 1e-5 of each gradient's largest entry, and its bf16 output on
a card at 2^-6 of the largest |out| of the float32 call.  The
``cuda``-marked tests need an NVIDIA card and ``nvcc`` and skip without
them, naming what is missing; on a machine with a card run them with
``python -m pytest -m cuda tests/test_torch_mamba.py`` (the reference is
imported inside the CPU tests, so this file also loads where JAX is not
installed).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.kernels import build
from repro_torch.kernels.mamba_scan import ops
from repro_torch.models import moe, ssm


class _Elsewhere(torch.Tensor):
    """A CPU tensor that reports another device (xpu): the wrappers refuse
    any device but the CPU, a card and meta, which takes the card's route
    without launching."""

    @property
    def device(self):
        return torch.device("xpu")


def _elsewhere(t: torch.Tensor) -> torch.Tensor:
    return t.as_subclass(_Elsewhere)


TOL = 1e-5              # strict recurrences, step for step
SCAN_TOL = 2e-4         # against the associative scan / the chunked form
# (B, S, D, N, chunk, block_d): tests/test_new_substrate.py's sweep
SWEEP = [(2, 128, 64, 8, 32, 32), (1, 64, 128, 16, 64, 64),
         (1, 96, 32, 4, 16, 32)]


def _scan_inputs(b, s, d, n, seed, dt_range=(0.01, 0.04), a=None):
    """dt (B, S, D) in ``dt_range``; a (D, N), by default -(1..N) per
    channel, as ``init_mamba`` makes it; x (B, S, D); b, c (B, S, N).  At
    the default dt range exp(dt a) lies in (0.5, 1), the decay range of
    the reference's kernel sweep."""
    rng = np.random.RandomState(seed)
    dt = rng.uniform(*dt_range, (b, s, d)).astype(np.float32)
    if a is None:
        a = -np.tile(np.arange(1, n + 1, dtype=np.float32), (d, 1))
    x = rng.randn(b, s, d).astype(np.float32)
    bm = rng.randn(b, s, n).astype(np.float32)
    cm = rng.randn(b, s, n).astype(np.float32)
    return dt, a, x, bm, cm


def _t(*arrays, device="cpu"):
    return tuple(torch.tensor(v, device=device) for v in arrays)


def _decay_drive(dt, a, x, bm):
    """The reference kernel's inputs, (B, S, D, N) each, in numpy."""
    decay = np.exp(dt[..., None] * a)
    drive = (dt * x)[..., None] * bm[:, :, None, :]
    return decay, drive


def _close(got, ref, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(ref, np.float32), atol=tol,
                               rtol=tol)


# ------------------------------------------------------------ the scan op
@pytest.mark.parametrize("b,s,d,n,chunk,bd", SWEEP)
def test_scan_plain_matches_oracle(b, s, d, n, chunk, bd):
    """``selective_scan_plain`` against ``ref.py::mamba_scan_ref``, the
    strict per-step oracle, at 1e-5, and its final state against the
    oracle's recurrence run by hand."""
    import jax.numpy as jnp
    from repro.kernels.mamba_scan.ref import mamba_scan_ref
    dt, a, x, bm, cm = _scan_inputs(b, s, d, n, seed=s + d)
    y, h = ops.selective_scan_plain(*_t(dt, a, x, bm, cm), return_state=True)
    decay, drive = _decay_drive(dt, a, x, bm)
    ref = mamba_scan_ref(jnp.asarray(decay), jnp.asarray(drive),
                         jnp.asarray(cm))
    _close(y.numpy(), ref, TOL)
    h_ref = np.zeros((b, d, n), np.float32)
    for t in range(s):
        h_ref = decay[:, t] * h_ref + drive[:, t]
    _close(h.numpy(), h_ref, TOL)
    assert y.shape == (b, s, d) and h.shape == (b, d, n)


@pytest.mark.parametrize("b,s,d,n,chunk,bd", SWEEP)
def test_scan_plain_matches_pallas_kernel(b, s, d, n, chunk, bd):
    """Against the reference's Pallas ``mamba_scan`` (through its
    ``selective_scan`` wrapper, interpret mode) on its own sweep, where its
    chunked form is finite (decay in (0.5, 1)): the reference's 2e-4."""
    import jax.numpy as jnp
    from repro.kernels.mamba_scan.ops import selective_scan as ref_scan
    args = _scan_inputs(b, s, d, n, seed=2 * s + d)
    got = ops.selective_scan_plain(*_t(*args))
    ref = ref_scan(*(jnp.asarray(v) for v in args), chunk=chunk, block_d=bd,
                   interpret=True)
    _close(got.numpy(), ref, SCAN_TOL)


def test_scan_plain_matches_model_associative_scan():
    """Against the associative scan that the reference's ``mamba_forward``
    runs (``models/ssm.py:88-92``), as ``tests/test_new_substrate.py``
    holds its kernel, at its 2e-4."""
    import jax
    import jax.numpy as jnp
    rng = np.random.RandomState(5)
    b, s, d, n = 2, 64, 32, 4
    dt, _, x, bm, cm = _scan_inputs(b, s, d, n, seed=6,
                                    dt_range=(0.01, 0.5))
    a = -rng.uniform(0.5, 2.0, (d, n)).astype(np.float32)
    decay, drive = _decay_drive(dt, a, x, bm)

    def comb(l, r):
        return (l[0] * r[0], r[0] * l[1] + r[1])

    _, h = jax.lax.associative_scan(comb, (jnp.asarray(decay),
                                           jnp.asarray(drive)), axis=1)
    y_ref = jnp.einsum("bsdn,bsn->bsd", h, jnp.asarray(cm))
    y, h_last = ops.selective_scan_plain(*_t(dt, a, x, bm, cm),
                                         return_state=True)
    _close(y.numpy(), y_ref, SCAN_TOL)
    _close(h_last.numpy(), h[:, -1], SCAN_TOL)


def test_scan_plain_is_finite_where_the_chunk_form_overflows():
    """jamba's regime: dt up to 1.0 and A = -(1..16).  The TPU kernel's
    chunk form divides the drive by prefix decays exp(cumsum(log a)), and
    exp(-cum) overflows float32 once dt |A| summed over a 64-step chunk
    passes about 88: here its outputs turn non-finite.  The strict
    recurrence stays finite and equals ``mamba_scan_ref`` at 1e-5."""
    import jax.numpy as jnp
    from repro.kernels.mamba_scan.kernel import mamba_scan
    from repro.kernels.mamba_scan.ref import mamba_scan_ref
    b, s, d, n = 1, 128, 32, 16
    dt, a, x, bm, cm = _scan_inputs(b, s, d, n, seed=7,
                                    dt_range=(0.0, 1.0))
    y, h = ops.selective_scan_plain(*_t(dt, a, x, bm, cm), return_state=True)
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    decay, drive = _decay_drive(dt, a, x, bm)
    dec, drv, cc = (jnp.asarray(v) for v in (decay, drive, cm))
    _close(y.numpy(), mamba_scan_ref(dec, drv, cc), TOL)
    chunked = np.asarray(mamba_scan(dec, drv, cc, chunk=64, block_d=32))
    assert not np.isfinite(chunked).all()


def test_scan_plain_widens_bf16_x():
    """A bf16 x goes through the recurrence as its float32 value."""
    dt, a, x, bm, cm = _t(*_scan_inputs(2, 40, 16, 4, seed=8))
    xb = x.bfloat16()
    got = ops.selective_scan_plain(dt, a, xb, bm, cm)
    assert got.dtype == torch.float32
    assert torch.equal(got, ops.selective_scan_plain(dt, a, xb.float(), bm,
                                                     cm))


def test_softplus_matches_jax():
    """``softplus`` agrees with ``jax.nn.softplus`` at 1e-6, above the
    threshold of 20 where ``torch.nn.functional.softplus`` returns x too."""
    import jax
    import jax.numpy as jnp
    v = np.concatenate([np.linspace(-100, 100, 20001),
                        [0.0, -0.0, 19.99, 20.0, 20.01, 88.7, -88.7,
                         1e3, -1e3]]).astype(np.float32)
    got = ssm.softplus(torch.tensor(v)).numpy()
    _close(got, jax.nn.softplus(jnp.asarray(v)), 1e-6)
    assert np.all(np.isfinite(got))


# -------------------------------------------------------------- the mixer
@pytest.fixture(scope="module")
def cfgs():
    """(port cfg, reference cfg): jamba's smoke config, float32."""
    from repro.configs.base import ModelConfig
    cfg = smoke_config(get_config("jamba-v0.1-52b"))
    return cfg, ModelConfig(**dataclasses.asdict(cfg))


def _tensors(tree):
    return {k: torch.tensor(np.asarray(v)) for k, v in tree.items()}


def _mamba(rcfg, seed):
    """The reference's init of one Mamba mixer, and the same as tensors."""
    import jax
    from repro.models import ssm as ref_ssm
    rp = ref_ssm.init_mamba(jax.random.PRNGKey(seed), rcfg)
    return rp, _tensors(rp)


def _assert_state(got, ref, tol=TOL):
    assert set(got) == set(ref) == {"h", "conv"}
    for key in got:
        assert tuple(got[key].shape) == tuple(np.shape(ref[key]))
        _close(got[key].numpy(), ref[key], tol)


def test_init_mamba_matches_reference_layout(cfgs):
    """Same keys, shapes and dtypes as the reference's ``init_mamba``, and
    the same deterministic leaves (conv bias, A_log, D)."""
    cfg, rcfg = cfgs
    rp, _ = _mamba(rcfg, seed=0)
    p = ssm.init_mamba(torch.Generator().manual_seed(0), cfg,
                       torch.device("cpu"))
    assert set(p) == set(rp)
    for key in p:
        assert tuple(p[key].shape) == tuple(rp[key].shape), key
        assert str(p[key].dtype).split(".")[-1] == str(rp[key].dtype), key
    for key in ("conv_b", "A_log", "D"):
        _close(p[key].numpy(), rp[key], 1e-7)
    # the softplus of dt_bias lies in U(1e-3, 1e-1), as in the reference
    dt0 = ssm.softplus(p["dt_bias"])
    assert float(dt0.min()) >= 1e-3 - 1e-7 and float(dt0.max()) <= 0.1 + 1e-7
    assert ssm.mamba_dims(cfg) == (2 * cfg.d_model, 4)


@pytest.mark.parametrize("s", [3, 40])
def test_mamba_forward_matches_reference(cfgs, s):
    """The mixer's prefill (in_proj, the conv, softplus, the scan, the skip
    term, the silu gate, out_proj) and its state {h, conv}."""
    import jax.numpy as jnp
    from repro.models import ssm as ref_ssm
    cfg, rcfg = cfgs
    rp, p = _mamba(rcfg, seed=1)
    u = np.random.RandomState(s).randn(2, s, cfg.d_model).astype(np.float32)
    out, state = ssm.mamba_forward(p, cfg, torch.tensor(u),
                                   return_state=True)
    rout, rstate = ref_ssm.mamba_forward(rp, rcfg, jnp.asarray(u),
                                         return_state=True)
    _close(out.numpy(), rout, TOL)
    _assert_state(state, rstate)
    assert torch.equal(ssm.mamba_forward(p, cfg, torch.tensor(u)), out)


def test_mamba_step_matches_reference(cfgs):
    """Chained decode steps from the zero state and from a prefill state of
    the reference."""
    import jax.numpy as jnp
    from repro.models import ssm as ref_ssm
    cfg, rcfg = cfgs
    rp, p = _mamba(rcfg, seed=2)
    u = np.random.RandomState(9).randn(2, 10, cfg.d_model).astype(np.float32)
    rstate = ref_ssm.mamba_init_state(rcfg, 2)
    state = ssm.mamba_init_state(cfg, 2, torch.device("cpu"))
    _assert_state(state, rstate, 0.0)
    for t in range(3):
        out, state = ssm.mamba_step(p, cfg, torch.tensor(u[:, t:t + 1]),
                                    state)
        rout, rstate = ref_ssm.mamba_step(rp, rcfg, jnp.asarray(u[:, t:t + 1]),
                                          rstate)
        _close(out.numpy(), rout, TOL)
        _assert_state(state, rstate)
    _, rstate = ref_ssm.mamba_forward(rp, rcfg, jnp.asarray(u[:, :6]),
                                      return_state=True)
    state = _tensors(rstate)
    for t in range(6, 10):
        out, state = ssm.mamba_step(p, cfg, torch.tensor(u[:, t:t + 1]),
                                    state)
        rout, rstate = ref_ssm.mamba_step(rp, rcfg, jnp.asarray(u[:, t:t + 1]),
                                          rstate)
        _close(out.numpy(), rout, TOL)
        _assert_state(state, rstate)


def test_mamba_step_continues_the_forward(cfgs):
    """Port only: a prefill over S tokens, then steps, equal the forward
    over S + 3 tokens at its last positions."""
    cfg, rcfg = cfgs
    _, p = _mamba(rcfg, seed=3)
    u = torch.tensor(np.random.RandomState(10).randn(2, 15, cfg.d_model)
                     .astype(np.float32))
    full = ssm.mamba_forward(p, cfg, u)
    _, state = ssm.mamba_forward(p, cfg, u[:, :12], return_state=True)
    for t in range(12, 15):
        out, state = ssm.mamba_step(p, cfg, u[:, t:t + 1], state)
        torch.testing.assert_close(out[:, 0], full[:, t], atol=TOL, rtol=TOL)


# --------------------------------------------------------------- the MoE
def _moe_cfgs(name, **changes):
    from repro.configs.base import ModelConfig
    cfg = dataclasses.replace(smoke_config(get_config(name)), **changes)
    return cfg, ModelConfig(**dataclasses.asdict(cfg))


def _moe(rcfg, seed):
    import jax
    from repro.models import moe as ref_moe
    rp = ref_moe.init_moe(jax.random.PRNGKey(seed), rcfg)
    return rp, _tensors(rp)


def _routed_past_capacity(p, cfg, x) -> int:
    """How many (token, expert) routings exceed the expert's capacity in
    their group, from the port's router."""
    b, s, d = x.shape
    t = min(s, cfg.moe_group)
    _, _, idx = moe.route(p, cfg, x.reshape(-1, t, d))
    per = torch.nn.functional.one_hot(idx, cfg.n_experts).sum(dim=(1, 2))
    return int((per - moe.capacity(cfg, t)).clamp_min(0).sum())


@pytest.mark.parametrize("name,changes,drops", [
    ("jamba-v0.1-52b", {}, True),
    ("jamba-v0.1-52b", {"moe_combine_f32": True}, True),
    ("olmoe-1b-7b", {"capacity_factor": 16.0}, False),
    ("arctic-480b", {"moe_group": 16}, True)])
def test_moe_ffn_matches_reference(name, changes, drops):
    """``moe_ffn``'s out and aux loss against the reference's, with tokens
    dropped past an expert's capacity where ``drops`` (asserted, so the
    drop path runs), in several routing groups for arctic (S = 64 with
    moe_group 16)."""
    import jax.numpy as jnp
    from repro.models import moe as ref_moe
    cfg, rcfg = _moe_cfgs(name, **changes)
    rp, p = _moe(rcfg, seed=4)
    rng = np.random.RandomState(11)
    # one offset shared by every token skews the routing towards a few
    # experts, as a run of similar tokens does
    x = (rng.randn(2, 64, cfg.d_model) + 3 * rng.randn(cfg.d_model)).astype(
        np.float32)
    got = moe.moe_ffn(p, cfg, torch.tensor(x))
    ref = ref_moe.moe_ffn(rp, rcfg, jnp.asarray(x))
    assert set(got) == set(ref) == {"out", "aux_loss"}
    _close(got["out"].numpy(), ref["out"], TOL)
    _close(got["aux_loss"].numpy(), ref["aux_loss"], TOL)
    assert (_routed_past_capacity(p, cfg, torch.tensor(x)) > 0) == drops


def _ref_dispatch(monkeypatch, rp, rcfg, x) -> np.ndarray:
    """The reference's one-hot dispatch (G, T, E, C), caught at its
    einsum."""
    import jax.numpy as jnp
    from repro.models import moe as ref_moe
    seen = {}

    class _Jnp:
        def __getattr__(self, attr):
            return getattr(jnp, attr)

        @staticmethod
        def einsum(spec, *ops, **kw):
            if spec == "gtec,gtd->egcd":
                seen["dispatch"] = np.asarray(ops[0], np.float32)
            return jnp.einsum(spec, *ops, **kw)
    with monkeypatch.context() as m:
        m.setattr(ref_moe, "jnp", _Jnp())
        ref_moe.moe_ffn(rp, rcfg, jnp.asarray(x))
    return seen["dispatch"]


def _skewed(d, b=2, s=64, seed=11):
    """(B, S, d): one offset shared by every token skews the routing
    towards a few experts, as a run of similar tokens does."""
    rng = np.random.RandomState(seed)
    return (rng.randn(b, s, d) + 3 * rng.randn(d)).astype(np.float32)


@pytest.mark.parametrize("name,changes,b,s", [
    ("jamba-v0.1-52b", {}, 2, 64),
    ("olmoe-1b-7b", {"capacity_factor": 16.0}, 2, 64),
    ("arctic-480b", {"moe_group": 16}, 2, 64),
    ("jamba-v0.1-52b", {}, 5, 1)])
def test_moe_slots_are_the_references(name, changes, b, s, monkeypatch):
    """Token t of group g sits in slot c of expert e exactly where the
    reference's dispatch[g, t, e, c] is 1: the same pairs kept, in the same
    slots, with drops (jamba), several routing groups (arctic at moe_group
    16), none dropped (olmoe) and one-token decode groups (S = 1)."""
    cfg, rcfg = _moe_cfgs(name, **changes)
    rp, p = _moe(rcfg, seed=4)
    x = _skewed(cfg.d_model, b, s)
    ref = _ref_dispatch(monkeypatch, rp, rcfg, x)
    tables = []
    inner = moe._Dispatch.apply

    def recording(rows, table, at, mine):
        tables.append(table)
        return inner(rows, table, at, mine)
    monkeypatch.setattr(moe._Dispatch, "apply", recording)
    moe.moe_ffn(p, cfg, torch.tensor(x))
    g, t, e, c = ref.shape
    assert tables[0].shape == (e * g * c,)
    tok = tables[0].view(e, g, c)                      # g t, or g t: empty
    got = torch.nn.functional.one_hot(tok, g * t + 1)[..., :g * t]
    got = got.view(e, g, c, g, t).diagonal(dim1=1, dim2=3)   # (E, C, T, G)
    np.testing.assert_array_equal(got.permute(3, 2, 0, 1).numpy(), ref)
    assert ref.sum() > 0


def test_moe_gradients_match_reference():
    """The gradients of ``moe_ffn``'s out (against a fixed random
    cotangent) and of its aux loss with respect to x and every parameter
    against ``jax.grad`` of the reference's, on jamba's drop-heavy input,
    within TOL of each gradient's largest entry (the sums run in other
    orders); all finite."""
    import jax
    import jax.numpy as jnp
    from repro.models import moe as ref_moe
    cfg, rcfg = _moe_cfgs("jamba-v0.1-52b")
    rp, p = _moe(rcfg, seed=4)
    x = _skewed(cfg.d_model)
    assert _routed_past_capacity(p, cfg, torch.tensor(x)) > 0
    cot = np.random.RandomState(7).randn(*x.shape).astype(np.float32)
    names = sorted(p)
    for key, weight in (("out", cot), ("aux_loss", np.float32(1.0))):
        def ref_loss(params, xs):
            return jnp.sum(ref_moe.moe_ffn(params, rcfg, xs)[key] * weight)
        rg, rgx = jax.grad(ref_loss, argnums=(0, 1))(rp, jnp.asarray(x))
        ins = [p[n].clone().requires_grad_(True) for n in names] + \
            [torch.tensor(x, requires_grad=True)]
        loss = (moe.moe_ffn(dict(zip(names, ins)), cfg, ins[-1])[key] *
                torch.tensor(weight)).sum()
        got = torch.autograd.grad(loss, ins, allow_unused=True,
                                  materialize_grads=True)
        for n, gr, want in zip(names + ["x"], got,
                               [rg[n] for n in names] + [rgx]):
            assert torch.isfinite(gr).all(), (key, n)
            tol = TOL * float(np.abs(want).max())
            np.testing.assert_allclose(gr.numpy(), want, atol=tol, rtol=0,
                                       err_msg=f"{key} {n}")


def test_moe_capacity_and_init_match_reference():
    from repro.models import moe as ref_moe
    cfg, rcfg = _moe_cfgs("jamba-v0.1-52b")
    for group in (1, 3, 16, 64, 1000, 1024):
        assert moe.capacity(cfg, group) == ref_moe.capacity(rcfg, group)
    full = get_config("jamba-v0.1-52b")
    from repro.configs import get_config as ref_get_config
    assert moe.capacity(full, 1024) == \
        ref_moe.capacity(ref_get_config("jamba-v0.1-52b"), 1024) == 160
    rp, _ = _moe(rcfg, seed=0)
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg,
                     torch.device("cpu"))
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: tuple(v.shape) for k, v in rp.items()}


def test_moe_bf16_keeps_the_reference_dtypes():
    """In bf16 the router runs in float32 and the aux loss is float32;
    dispatch and the out are in x's dtype.  The combine, float32 with
    ``moe_combine_f32``, is cast to the experts' dtype before its product
    (``moe.py:92``), so the flag leaves a bf16 model's output unchanged."""
    cfg, _ = _moe_cfgs("jamba-v0.1-52b", dtype="bfloat16",
                       param_dtype="bfloat16")
    p = moe.init_moe(torch.Generator().manual_seed(5), cfg,
                     torch.device("cpu"))
    assert p["w_gate"].dtype == torch.bfloat16
    assert p["router"].dtype == torch.float32
    x = torch.tensor(np.random.RandomState(12).randn(2, 16, cfg.d_model)
                     .astype(np.float32)).bfloat16()
    out = moe.moe_ffn(p, cfg, x)
    out32 = moe.moe_ffn(p, dataclasses.replace(cfg, moe_combine_f32=True), x)
    assert out["out"].dtype == torch.bfloat16
    assert out["aux_loss"].dtype == torch.float32
    assert torch.equal(out["out"], out32["out"])
    assert torch.isfinite(out["out"].float()).all()


def test_moe_group_contract_raises():
    """A length above moe_group must be a multiple of it
    (``repro/models/moe.py:44-46``); a one-token decode never drops."""
    cfg, rcfg = _moe_cfgs("jamba-v0.1-52b", moe_group=8)
    _, p = _moe(rcfg, seed=6)
    with pytest.raises(ValueError, match="moe.py:44-46"):
        moe.moe_ffn(p, cfg, torch.zeros(1, 12, cfg.d_model))
    assert moe.moe_ffn(p, cfg, torch.zeros(1, 16, cfg.d_model))[
        "out"].shape == (1, 16, cfg.d_model)
    x = torch.tensor(np.random.RandomState(13).randn(5, 1, cfg.d_model)
                     .astype(np.float32))
    assert _routed_past_capacity(p, cfg, x) == 0


# -------------------------------------------------------------- the wrapper
def test_wrapper_runs_plain_on_cpu_without_a_launch():
    args = _t(*_scan_inputs(2, 33, 24, 8, seed=14))
    before = ops.LAUNCHES
    y, h = ops.selective_scan(*args, return_state=True)
    ry, rh = ops.selective_scan_plain(*args, return_state=True)
    assert torch.equal(y, ry) and torch.equal(h, rh)
    assert torch.equal(ops.selective_scan(*args), ry)
    assert ops.LAUNCHES == before


def test_wrapper_refuses_bad_inputs():
    dt, a, x, b, c = _t(*_scan_inputs(1, 16, 8, 4, seed=15))
    with pytest.raises(ValueError, match="several devices"):
        ops.selective_scan(dt, a, x.to("meta"), b, c)
    with pytest.raises(ValueError, match="several devices"):
        ops.selective_scan(dt, a.to("meta"), x, b, c)
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.selective_scan(*map(_elsewhere, (dt, a, x, b, c)))
    with pytest.raises(TypeError, match="float32"):
        ops.selective_scan(dt.double(), a, x, b, c)
    with pytest.raises(TypeError, match="float32"):
        ops.selective_scan(dt, a, x, b.bfloat16(), c)
    with pytest.raises(TypeError, match="x dtype"):
        ops.selective_scan(dt, a, x.half(), b, c)
    with pytest.raises(ValueError, match=r"\(B, S, D\)"):
        ops.selective_scan(dt, a, x[:, :8], b, c)
    with pytest.raises(ValueError, match=r"\(B, S, D\)"):
        ops.selective_scan(dt[0], a, x[0], b, c)
    with pytest.raises(ValueError, match=r"a must be \(D, N\)"):
        ops.selective_scan(dt, a[:4], x, b, c)
    with pytest.raises(ValueError, match=r"b and c"):
        ops.selective_scan(dt, a, x, b[:, :8], c)
    with pytest.raises(ValueError, match="state dim"):
        ops.selective_scan(dt, torch.cat([a, a[:, :2]], 1), x,
                           torch.cat([b, b[..., :2]], -1),
                           torch.cat([c, c[..., :2]], -1))
    with pytest.raises(ValueError, match="contiguous"):
        xt = x.transpose(1, 2).contiguous().transpose(1, 2)
        ops.selective_scan(dt, a, xt, b, c)
    with pytest.raises(ValueError, match="empty"):
        ops.selective_scan(dt[:, :0], a, x[:, :0], b[:, :0], c[:, :0])


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


# the sweep's shapes at its decay range, every supported N, a ragged block
# of channels, and jamba's shape at dt up to 1.0
CARD_CASES = [(b, s, d, n, (0.01, 0.04)) for b, s, d, n, _, _ in SWEEP] + \
    [(2, 50, 40, n, (0.0, 1.0)) for n in ops.STATE_DIMS] + \
    [(2, 256, 8192, 16, (0.0, 1.0))]


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,d,n,dt_range", CARD_CASES)
def test_kernel_matches_plain_on_card(card, b, s, d, n, dt_range, x_dtype):
    """y and the final h against the plain version at 1e-5 of the largest
    |y| and |h| (FMA contraction of decay h + drive and the kernel's tree
    order over N), and two launches bit-equal."""
    dt, a, x, bm, cm = _t(*_scan_inputs(b, s, d, n, seed=s + n,
                                        dt_range=dt_range), device=card)
    x = x.to(x_dtype)
    launches = ops.LAUNCHES
    y, h = ops.selective_scan(dt, a, x, bm, cm, return_state=True)
    y2, h2 = ops.selective_scan(dt, a, x, bm, cm, return_state=True)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == launches + 2
    assert torch.equal(y, y2) and torch.equal(h, h2)
    ry, rh = ops.selective_scan_plain(dt, a, x, bm, cm, return_state=True)
    for got, ref in ((y, ry), (h, rh)):
        assert torch.isfinite(got).all()
        tol = 1e-5 * float(ref.abs().max())
        torch.testing.assert_close(got, ref, atol=tol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", ops.STATE_DIMS)
def test_kernel_ragged_channels_and_steps_on_card(card, n, x_dtype):
    """One thread per channel in blocks of 128: D = 300 leaves a ragged
    block of 44 channels past two full ones, and S = 77 ends inside both a
    32-step tile of B_t, C_t and an 8-step group of dt, x loaded ahead.
    y and h against the plain version at 1e-5 of their largest value, two
    launches bit-equal."""
    dt, a, x, bm, cm = _t(*_scan_inputs(3, 77, 300, n, seed=n + 3,
                                        dt_range=(0.0, 1.0)), device=card)
    x = x.to(x_dtype)
    y, h = ops.selective_scan(dt, a, x, bm, cm, return_state=True)
    y2, h2 = ops.selective_scan(dt, a, x, bm, cm, return_state=True)
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and torch.equal(h, h2)
    ry, rh = ops.selective_scan_plain(dt, a, x, bm, cm, return_state=True)
    for got, ref in ((y, ry), (h, rh)):
        assert torch.isfinite(got).all()
        tol = 1e-5 * float(ref.abs().max())
        torch.testing.assert_close(got, ref, atol=tol, rtol=0)


@pytest.mark.cuda
def test_wrapper_refuses_a_mix_on_card(card):
    dt, a, x, b, c = _t(*_scan_inputs(1, 16, 8, 4, seed=16), device=card)
    launches = ops.LAUNCHES
    with pytest.raises(ValueError, match="several devices"):
        ops.selective_scan(dt, a.cpu(), x, b, c)
    with pytest.raises(ValueError, match="state dim"):
        ops.selective_scan(dt, torch.cat([a, a[:, :2]], 1), x,
                           torch.cat([b, b[..., :2]], -1),
                           torch.cat([c, c[..., :2]], -1))
    assert ops.LAUNCHES == launches


@pytest.mark.cuda
def test_moe_bf16_matches_float32_without_a_sync_on_card(card):
    """``moe_ffn`` in bf16 at olmoe's widths, 3 routing groups of 1024 on
    skewed input that drops pairs, against the same call in float32 on the
    bf16 weights and input: the router runs in float32 on the same values
    in both, so the same pairs take the same slots, and the outputs agree
    within 2^-6 of the largest |out| (the products' bf16 rounding).  With
    spans off the bf16 forward makes no host sync."""
    cfg = get_config("olmoe-1b-7b")
    p = moe.init_moe(torch.Generator(device=card).manual_seed(9),
                     dataclasses.replace(cfg, param_dtype="bfloat16"), card)
    x = torch.tensor(_skewed(cfg.d_model, 3, 1024), device=card).bfloat16()
    assert _routed_past_capacity(p, cfg, x) > 0
    p32 = {n: v.float() for n, v in p.items()}
    ref = moe.moe_ffn(p32, cfg, x.float())["out"]
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16", param_dtype="bfloat16")
    moe.moe_ffn(p, cfg16, x)                             # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = moe.moe_ffn(p, cfg16, x)["out"]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert got.dtype == torch.bfloat16
    assert torch.isfinite(got.float()).all()
    tol = 2 ** -6 * float(ref.abs().max())
    torch.testing.assert_close(got.float(), ref, atol=tol, rtol=0)
