"""PyTorch port vs JAX reference: the graph-propagation op and the model.

Inputs are made from seeded numpy and go through both packages on the CPU;
the JAX side runs its Pallas kernel in interpret mode (as its own tests do)
and through its numpy oracle.  Tolerances are the reference's own
(``tests/test_sweep.py``): float32 sums in another order differ in the last
few ulp, never more than 1e-5 at these magnitudes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import model as jmodel
from repro.core.graph import NodeAttrs as JNodeAttrs
from repro.core.graph import build_graph as jbuild_graph
from repro.core.graph import stack_graphs as jstack_graphs
from repro.kernels.graph_prop.ops import graph_prop as jgraph_prop
from repro.kernels.graph_prop.ref import graph_prop_ref
from repro_torch.convert import enel_params_from_numpy
from repro_torch.core import model
from repro_torch.core.graph import CTX_DIM, N_METRICS
from repro_torch.kernels.graph_prop import ops

ATOL = 1e-5


@pytest.fixture(scope="module")
def params():
    """(JAX params, numpy tree, port params on the CPU) from one key."""
    jp = jmodel.init_enel(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jp, tree, enel_params_from_numpy(tree, device="cpu")


def _random_inputs(b, n, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, n, model.X_DIM).astype(np.float32)
    adj = np.tril(rng.rand(b, n, n) < 0.35, -1)
    adj[:, 1, :] = False                 # a row with no predecessor
    valid = rng.rand(b, n) < 0.4
    m = rng.rand(b, n, N_METRICS).astype(np.float32)
    return x, adj, m, valid


@pytest.mark.parametrize("n,b,levels", [(4, 5, 2), (8, 3, 3), (16, 9, 8),
                                        (16, 1, 1)])
def test_graph_prop_plain_matches_jax(params, n, b, levels):
    jp, tree, tp = params
    x, adj, m, valid = _random_inputs(b, n, seed=n * 10 + b)
    je, jm = jgraph_prop(jp, jnp.asarray(x), jnp.asarray(adj), jnp.asarray(m),
                         jnp.asarray(valid), levels=levels)
    re, rm = graph_prop_ref(tree, x, adj, m, valid, levels=levels)
    te, tm = ops.graph_prop_plain(tp, torch.tensor(x), torch.tensor(adj),
                                  torch.tensor(m), torch.tensor(valid),
                                  levels=levels)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=ATOL)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=ATOL)
    np.testing.assert_allclose(te.numpy(), re, atol=ATOL)
    np.testing.assert_allclose(tm.numpy(), rm, atol=ATOL)
    # the CPU wrapper is the plain version, launches nothing
    launches = ops.LAUNCHES
    we, wm = ops.graph_prop(tp, torch.tensor(x), torch.tensor(adj),
                            torch.tensor(m), torch.tensor(valid),
                            levels=levels)
    assert ops.LAUNCHES == launches
    np.testing.assert_array_equal(we.numpy(), te.numpy())
    np.testing.assert_array_equal(wm.numpy(), tm.numpy())


def test_graph_prop_rejects_bad_inputs(params):
    _, _, tp = params
    x, adj, m, valid = (torch.tensor(a) for a in _random_inputs(2, 4, 0))
    with pytest.raises(ValueError, match="adj"):
        ops.graph_prop(tp, x, adj[:, :3], m, valid, levels=1)
    with pytest.raises(TypeError, match="bool"):
        ops.graph_prop(tp, x, adj.float(), m, valid, levels=1)
    with pytest.raises(TypeError, match="float32"):
        ops.graph_prop(tp, x.double(), adj, m, valid, levels=1)
    with pytest.raises(ValueError, match="levels"):
        ops.graph_prop(tp, x, adj, m, valid, levels=-1)


def _ctx(i):
    return np.tanh(np.random.RandomState(300 + i).randn(CTX_DIM)
                   ).astype(np.float32)


def _graphs(seed):
    """Three chain graphs with summary predecessors, some metrics seen."""
    rng = np.random.RandomState(seed)
    graphs = []
    for k in range(3):
        a, z = float(rng.randint(4, 37)), float(rng.randint(4, 37))
        nodes = [JNodeAttrs(
            f"st{i}", _ctx(i),
            rng.rand(N_METRICS).astype(np.float32) if k == 0 else None,
            a if i == 0 else z, z, 1.0 if a == z else 0.8)
            for i in range(3)]
        preds = [JNodeAttrs(f"P{k}", _ctx(9), rng.rand(N_METRICS).astype(
            np.float32), a, a, is_summary=True)] if k else []
        n = len(nodes)
        edges = [(i, i + 1) for i in range(n - 1)] + \
            [(n + j, 0) for j in range(len(preds))]
        graphs.append(jbuild_graph(nodes + preds, edges, k))
    return jstack_graphs(graphs)


KEYS = ("edges", "metrics", "overhead", "runtime", "acc_runtime",
        "total_runtime")


@pytest.mark.parametrize("levels", [2, model.MAX_LEVELS])
@pytest.mark.parametrize("t_kernel", [False, True])
def test_forward_stacked_matches_jax(params, levels, t_kernel):
    jp, _, tp = params
    stacked = _graphs(seed=levels)
    jbatch = {k: jnp.asarray(v) for k, v in stacked.items()}
    tbatch = {k: torch.tensor(v) for k, v in stacked.items()}
    out = model.forward_stacked(tp, tbatch, use_kernel=t_kernel,
                                levels=levels)
    for j_kernel in (False, True):
        ref = jmodel.forward_stacked(jp, jbatch, use_kernel=j_kernel,
                                     levels=levels)
        for key in KEYS:
            np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                       atol=1e-5, rtol=1e-5, err_msg=key)


def test_forward_single_graph_is_batch_row(params):
    _, _, tp = params
    tbatch = {k: torch.tensor(v) for k, v in _graphs(seed=3).items()}
    full = model.forward_stacked(tp, tbatch)
    one = model.forward(tp, {k: v[1] for k, v in tbatch.items()})
    for key in KEYS:
        np.testing.assert_allclose(one[key].numpy(), full[key][1].numpy(),
                                   atol=1e-6)


def _sweep_inputs(seed, c=4, k=3):
    """Template (K, N, ...) + per-candidate deltas (C, K, ...) from numpy."""
    stacked = _graphs(seed)
    base = {key: stacked[key][:k] for key in
            ("context", "metrics", "metrics_valid", "a_raw", "z_raw", "r",
             "adj", "mask", "is_summary")}
    rng = np.random.RandomState(seed)
    n = base["mask"].shape[1]
    h_onehot = np.zeros((k, n), np.float32)
    h_onehot[1:, 3] = 1.0
    deltas = {
        "a_raw": rng.randint(4, 37, (c, k, n)).astype(np.float32),
        "z_raw": rng.randint(4, 37, (c, k, n)).astype(np.float32),
        "r": np.where(rng.rand(c, k, n) < 0.5, 1.0, 0.8).astype(np.float32),
        "metrics_valid": np.broadcast_to(base["metrics_valid"],
                                         (c, k, n)).copy(),
        "h_context": rng.randn(c, k, CTX_DIM).astype(np.float32),
        "h_metrics": rng.rand(c, k, N_METRICS).astype(np.float32),
    }
    return base, h_onehot, deltas


@pytest.mark.parametrize("j_kernel", [False, True])
def test_sweep_per_component_matches_jax(params, j_kernel):
    jp, _, tp = params
    base, h_onehot, deltas = _sweep_inputs(seed=5)
    ref = jmodel.sweep_per_component(
        jp, {k: jnp.asarray(v) for k, v in base.items()},
        jnp.asarray(h_onehot), {k: jnp.asarray(v) for k, v in deltas.items()},
        use_kernel=j_kernel, levels=3)
    for t_kernel in (False, True):
        out = model.sweep_per_component(
            tp, {k: torch.tensor(v) for k, v in base.items()},
            torch.tensor(h_onehot),
            {k: torch.tensor(v) for k, v in deltas.items()},
            use_kernel=t_kernel, levels=3)
        assert out.shape == (4, 3)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("seed", range(4))
def test_pick_candidate_matches_jax(seed):
    rng = np.random.RandomState(seed)
    cand = np.arange(4, 37, 4).astype(np.float32)
    totals = np.round(rng.rand(len(cand)) * 4, 0).astype(np.float32)  # ties
    if seed % 2:
        totals[rng.randint(len(cand))] = np.nan
        totals[rng.randint(len(cand))] = np.inf
    valid = rng.rand(len(cand)) < 0.8
    valid[0] = True
    for target in (0.5, 2.0, 10.0):
        ref = jmodel.pick_candidate(jnp.asarray(cand), jnp.asarray(valid),
                                    jnp.asarray(totals), jnp.float32(target))
        out = model.pick_candidate(torch.tensor(cand), torch.tensor(valid),
                                   torch.tensor(totals),
                                   torch.tensor(np.float32(target)))
        assert int(out) == int(ref)
    ok = model.sweep_totals_ok(torch.tensor(totals), torch.tensor(valid))
    assert bool(ok) == bool(jmodel.sweep_totals_ok(jnp.asarray(totals),
                                                   jnp.asarray(valid)))


def test_init_enel_matches_reference_structure(params):
    jp, _, _ = params
    tp = model.init_enel(torch.Generator().manual_seed(0), device="cpu")
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jp)
    for name in ("f1", "f2", "f3", "f4"):
        assert [(tuple(l["w"].shape), tuple(l["b"].shape)) for l in tp[name]] \
            == [(l["w"], l["b"]) for l in shapes[name]]
    assert tuple(tp["attn_a"].shape) == shapes["attn_a"]
    assert model.n_params(tp) == jmodel.n_params(jp)
    again = model.init_enel(torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(again["f3"][0]["w"], tp["f3"][0]["w"])
