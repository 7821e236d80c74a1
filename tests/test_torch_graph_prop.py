"""The graph-propagation kernels: their launch plan and their edge cases.

On the CPU: ``ops.launch_plan`` for every graph size and depth the kernels
take, and the port's plain route against the reference (its Pallas kernels
in interpret mode, forward and custom VJP) on the inputs the edge cases come
from: all-masked graphs as the training ring holds them, rows with no
predecessor, every row observed and no row observed.

The tests marked ``cuda`` hold both kernels against their plain versions on
the same kinds of input at every hidden-slice count S (N in {1, 2, 3, 5, 8,
9, 16}), levels {0, 1, 8} forward and {0, 1, 8, 64} backward (N = 16 with
64 levels fills the shared memory the most) and B in {1, 95, 96, 378}: the
forward at atol = rtol = 1e-5, the backward at the reference's gradient
tolerance (atol 1e-4, rtol 1e-3), two launches bit for bit equal, one
launch per call.  They need an NVIDIA card and ``nvcc`` and skip without
them; on a machine with a card: ``python -m pytest -m cuda
tests/test_torch_graph_prop.py``.  That machine has no JAX, so the
reference is imported inside the CPU tests' fixture, not by the module.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.convert import enel_params_from_numpy
from repro_torch.core import model
from repro_torch.core.graph import empty_graph, stack_graphs
from repro_torch.kernels import build
from repro_torch.kernels.graph_prop import ops

KINDS = ("random", "ring", "no_pred", "all_obs", "no_obs")
SIZES = (1, 2, 3, 5, 8, 9, 16)
BATCHES = (1, 95, 96, 378)
SMEM_LIMIT = 232448     # bytes of shared memory one H100 block may use


def _inputs(kind, b, n, seed):
    """numpy (x, adj, m_obs, valid) of ``b`` graphs of ``n`` nodes.

    ``ring``: every other graph all-masked as the training ring holds an
    empty slot (x lifted from ``empty_graph`` as the model lifts it, no
    edge, nothing observed, zero metrics); ``no_pred``: most rows without a
    predecessor; ``all_obs`` / ``no_obs``: every / no row observed."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, n, ops.X_DIM).astype(np.float32)
    adj = np.tril(rng.rand(b, n, n) < 0.35, -1)
    adj[:, min(1, n - 1), :] = False
    valid = rng.rand(b, n) < 0.4
    m = rng.rand(b, n, ops.N_METRICS).astype(np.float32)
    if kind == "ring":
        flat = {k: torch.as_tensor(v) for k, v in
                stack_graphs([empty_graph(n)]).items()}
        _, _, ex, eadj = model._prelude(flat)
        x[1::2] = ex.numpy()
        adj[1::2] = eadj.numpy()
        valid[1::2] = False
        m[1::2] = 0.0
    elif kind == "no_pred":
        adj &= rng.rand(b, n, 1) < 0.25
    elif kind == "all_obs":
        valid[:] = True
    elif kind == "no_obs":
        valid[:] = False
    return x, adj, m, valid


def _cotangents(b, n, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, n, n).astype(np.float32),
            rng.randn(b, n, ops.N_METRICS).astype(np.float32))


# ------------------------------------------------------------------- CPU
@pytest.mark.parametrize("n", range(1, ops.MAX_NODES + 1))
def test_launch_plan_fits_one_block(n):
    """One warp per row, S * W = 32 with W >= N, and both kernels' shared
    memory within one H100 block's 232,448 bytes at every depth."""
    slices = 8 if n <= 4 else 4 if n <= 8 else 2
    last = 0
    for levels in range(ops.MAX_BWD_LEVELS + 1):
        plan = ops.launch_plan(n, levels)
        assert plan.threads == 32 * n
        assert plan.threads % 32 == 0 and plan.threads <= 1024
        assert plan.slices == slices and plan.slices * plan.width == 32
        assert plan.width >= n
        assert 0 < plan.smem_fwd <= SMEM_LIMIT
        assert plan.smem_fwd < plan.smem_bwd <= SMEM_LIMIT
        assert plan.smem_fwd % 16 == 0 and plan.smem_bwd % 16 == 0
        assert plan.smem_bwd >= last
        last = plan.smem_bwd
    assert ops.launch_plan(n, 1000).smem_fwd == ops.launch_plan(n, 0).smem_fwd


def test_launch_plan_refuses_what_the_kernels_cannot_take():
    for n, levels in ((0, 1), (ops.MAX_NODES + 1, 1), (4, -1)):
        with pytest.raises(ValueError):
            ops.launch_plan(n, levels)


@pytest.fixture(scope="module")
def ref():
    """The reference (JAX) side: its params, its op, jax and jnp, and the
    port's params on the CPU from the same key."""
    import jax
    import jax.numpy as jnp
    from repro.core import model as jmodel
    from repro.kernels.graph_prop.ops import graph_prop
    jp = jmodel.init_enel(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return SimpleNamespace(jax=jax, jnp=jnp, graph_prop=graph_prop, jp=jp,
                           tp=enel_params_from_numpy(tree, device="cpu"))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,b,levels", [(8, 6, 8), (16, 5, 3)])
def test_plain_matches_reference_on_edge_cases(ref, kind, n, b, levels):
    x, adj, m, valid = _inputs(kind, b, n, seed=n + b)
    jnp = ref.jnp
    je, jm = ref.graph_prop(ref.jp, jnp.asarray(x), jnp.asarray(adj),
                            jnp.asarray(m), jnp.asarray(valid), levels=levels)
    te, tm = ops.graph_prop_plain(ref.tp,
                                  *map(torch.tensor, (x, adj, m, valid)),
                                  levels=levels)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=1e-5)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-5)
    if kind == "ring":
        assert not te.numpy()[1::2].any()
        np.testing.assert_array_equal(tm.numpy()[1::2], m[1::2])


@pytest.mark.parametrize("kind", KINDS)
def test_plain_vjp_matches_reference_on_edge_cases(ref, kind):
    """graph_prop_vjp_plain against the reference's custom VJP, which runs
    its backward Pallas kernel."""
    n, b, levels = 8, 4, 8
    x, adj, m, valid = _inputs(kind, b, n, seed=7)
    ce, cm = _cotangents(b, n, seed=8)
    jnp = ref.jnp

    def scalar(p, xx, mm):
        e, mh = ref.graph_prop(p, xx, jnp.asarray(adj), mm,
                               jnp.asarray(valid), levels=levels)
        return jnp.sum(e * ce) + jnp.sum(mh * cm)

    jg_p, jg_x, jg_m = ref.jax.grad(scalar, argnums=(0, 1, 2))(
        ref.jp, jnp.asarray(x), jnp.asarray(m))
    got = ops.graph_prop_vjp_plain(
        ref.tp, *map(torch.tensor, (x, adj, m, valid, ce, cm)),
        levels=levels)
    f3, f4 = jg_p["f3"], jg_p["f4"]
    want = [jg_x, jg_m, f3[0]["w"], f3[0]["b"], f3[1]["w"], f3[1]["b"],
            jg_p["attn_a"], f4[0]["w"], f4[0]["b"], f4[1]["w"], f4[1]["b"]]
    for i, (g, r) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4,
                                   rtol=1e-3, err_msg=str(i))


# ------------------------------------------------------------------ card
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


def _card_params(device):
    return model.init_enel(torch.Generator().manual_seed(0), device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", SIZES)
def test_fwd_kernel_matches_plain_on_card(card, n, kind):
    p = _card_params(card)
    for levels in (0, 1, 8):
        for b in BATCHES:
            x, adj, m, valid = (torch.tensor(a, device=card) for a in
                                _inputs(kind, b, n, seed=n * 1000 + b))
            before = ops.LAUNCHES
            e, mh = ops.graph_prop(p, x, adj, m, valid, levels=levels)
            e2, mh2 = ops.graph_prop(p, x, adj, m, valid, levels=levels)
            torch.cuda.synchronize()
            assert ops.LAUNCHES == before + 2
            assert torch.equal(e, e2) and torch.equal(mh, mh2)
            pe, pm = ops.graph_prop_plain(p, x, adj, m, valid, levels=levels)
            what = f"N={n} levels={levels} B={b} {kind}"
            torch.testing.assert_close(e, pe, atol=1e-5, rtol=1e-5,
                                       msg=lambda s: f"e {what}: {s}")
            torch.testing.assert_close(mh, pm, atol=1e-5, rtol=1e-5,
                                       msg=lambda s: f"m_hat {what}: {s}")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", SIZES)
def test_bwd_kernel_matches_plain_vjp_on_card(card, n, kind):
    p = _card_params(card)
    w = ops._weights(p)
    for levels in (0, 1, 8, ops.MAX_BWD_LEVELS):
        for b in BATCHES:
            x, adj, m, valid = (torch.tensor(a, device=card) for a in
                                _inputs(kind, b, n, seed=n * 1000 + b))
            g_e, g_m = (torch.tensor(a, device=card) for a in
                        _cotangents(b, n, seed=levels))
            before = ops.LAUNCHES_BWD
            got = ops._launch_bwd(x, adj, m, valid, w, g_e, g_m, levels)
            again = ops._launch_bwd(x, adj, m, valid, w, g_e, g_m, levels)
            torch.cuda.synchronize()
            assert ops.LAUNCHES_BWD == before + 2
            ref = ops.graph_prop_vjp_plain(p, x, adj, m, valid, g_e, g_m,
                                           levels=levels)
            what = f"N={n} levels={levels} B={b} {kind}"
            for i, (a, a2, r) in enumerate(zip(got, again, ref)):
                assert torch.equal(a, a2), f"gradient {i} {what}: repeat"
                torch.testing.assert_close(
                    a, r, atol=1e-4, rtol=1e-3,
                    msg=lambda s: f"gradient {i} {what}: {s}")
