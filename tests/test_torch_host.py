"""PyTorch port vs JAX reference: the host-side layers.

The port keeps its own numpy copies of the encoding, workloads, simulator,
graph and decision helpers; given the same seeded inputs they must produce
the same arrays as the reference.  The context encoder's auto-encoder is the
one torch layer here: with the reference's weights carried across, its
embeddings agree to float32 rounding (atol 1e-6).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import bell as jbell
from repro.core import encoding as jencoding
from repro.core import graph as jgraph
from repro.core.autoencoder import init_autoencoder as jinit_ae
from repro.core.fallback import FallbackPolicy as JFallbackPolicy
from repro.dataflow import runner as jrunner
from repro.dataflow import workloads as jworkloads
from repro.dataflow.context import ContextEncoder as JContextEncoder
from repro.dataflow.simulator import ClusterSim as JClusterSim
from repro.sim import scenarios as jscenarios
from repro_torch.convert import (autoencoder_params_from_numpy,
                                 enel_params_from_numpy)
from repro_torch.core import autoencoder, bell, encoding, graph
from repro_torch.core.fallback import FallbackPolicy
from repro_torch.dataflow import runner, workloads
from repro_torch.dataflow.context import ContextEncoder
from repro_torch.dataflow.simulator import ClusterSim
from repro_torch.sim import scenarios

JOB_KEYS = ("lr", "mpc", "kmeans", "gbt")


@pytest.fixture(scope="module")
def jax_encoder():
    """The reference encoder of the kmeans job (its AE trained once)."""
    return JContextEncoder([jworkloads.JOBS["kmeans"]], seed=0)


def _ae_tree(enc):
    return jax.tree_util.tree_map(np.asarray, enc.ae_params)


def test_encoding_matches_reference():
    props = ["LR", "20 iterations", 27, 0, 64, "intel xeon 3.3 ghz",
             "spark 3.1", 10240, "tree-aggregate", 2 ** 30]
    np.testing.assert_array_equal(encoding.encode_properties(props),
                                  jencoding.encode_properties(props))
    for p in props[:-1]:
        np.testing.assert_array_equal(encoding.encode_property(p, L=15),
                                      jencoding.encode_property(p, L=15))


@pytest.mark.parametrize("job_key", JOB_KEYS)
def test_workloads_match_reference(job_key):
    ours, ref = workloads.JOBS[job_key], jworkloads.JOBS[job_key]
    assert dataclasses.astuple(ours) == dataclasses.astuple(ref)
    assert dataclasses.astuple(workloads.scale_job(ours, 1.5)) == \
        dataclasses.astuple(jworkloads.scale_job(ref, 1.5))
    assert workloads.SCALEOUT_RANGE == jworkloads.SCALEOUT_RANGE


@pytest.mark.parametrize("scenario", ["baseline", "node_failure",
                                      "stragglers", "spot_preemption"])
def test_simulator_records_match_reference(scenario):
    """Same seed, same scale-out schedule -> identical stage records."""
    for job_key in JOB_KEYS:
        sims = [ClusterSim(seed=3, scenario=scenarios.make_scenario(
                    scenario, seed=1)),
                JClusterSim(seed=3, scenario=jscenarios.make_scenario(
                    scenario, seed=1))]
        jobs = [workloads.JOBS[job_key], jworkloads.JOBS[job_key]]
        records = [[], []]
        for side, (sim, job) in enumerate(zip(sims, jobs)):
            rng = np.random.RandomState(7)
            for _run in range(2):
                sim.begin_run()
                clock, s_prev = 0.0, 8
                for k in range(job.n_components):
                    s = int(rng.randint(4, 37))
                    log = []
                    comp = sim.run_component(
                        job, k, clock=clock, start_scaleout=s_prev,
                        end_scaleout=s, inject_failures=True,
                        failures_log=log)
                    clock = float(comp.stages[-1].start +
                                  comp.stages[-1].runtime)
                    s_prev = s
                    records[side] += [(st.name, st.start, st.runtime,
                                       st.start_scaleout, st.end_scaleout,
                                       st.time_fraction, st.overhead,
                                       st.failures, tuple(st.metrics))
                                      for st in comp.stages] + [tuple(log)]
        assert records[0] == records[1]


def _node_lists(seed):
    rng = np.random.RandomState(seed)
    out = []
    for k in range(4):
        nodes = []
        for i in range(int(rng.randint(1, 6))):
            z = float(rng.randint(4, 37))
            seen = rng.rand() < 0.5
            nodes.append(dict(
                name=f"st{i}", context=rng.randn(graph.CTX_DIM).astype(
                    np.float32),
                metrics=rng.rand(graph.N_METRICS).astype(np.float32)
                if seen else None,
                start_scaleout=float(rng.randint(4, 37)), end_scaleout=z,
                time_fraction=0.8 if rng.rand() < 0.5 else 1.0,
                runtime=float(rng.rand() * 30) if seen else None,
                overhead=float(rng.rand() * 5) if rng.rand() < 0.3 else None,
                is_summary=i > 2))
        out.append(nodes)
    return out


def _build(mod, nodes, k):
    attrs = [mod.NodeAttrs(**n) for n in nodes]
    edges = [(i, i + 1) for i in range(len(attrs) - 1)]
    return mod.build_graph(attrs, edges, component_id=k)


@pytest.mark.parametrize("seed", [0, 1])
def test_graph_arrays_match_reference(seed):
    lists = _node_lists(seed)
    ours = [_build(graph, n, k) for k, n in enumerate(lists)]
    ref = [_build(jgraph, n, k) for k, n in enumerate(lists)]
    a, b = graph.stack_graphs(ours), jgraph.stack_graphs(ref)
    assert a.keys() == b.keys()
    for key in a:
        assert a[key].dtype == b[key].dtype, key
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    for g, h in zip(ours, ref):
        assert graph.propagation_depth(g.adj, g.mask) == \
            jgraph.propagation_depth(h.adj, h.mask)
    # summaries, scalar and batched over candidate scale-outs
    hist = [graph.summary_node([graph.NodeAttrs(**n) for n in nodes],
                               name=f"P{k}") for k, nodes in enumerate(lists)]
    jhist = [jgraph.summary_node([jgraph.NodeAttrs(**n) for n in nodes],
                                 name=f"P{k}")
             for k, nodes in enumerate(lists)]
    targets = np.array([4.0, 9.0, 17.0, 36.0], np.float32)
    hb = graph.historical_summaries_batch(hist, targets, beta=3)
    jb = jgraph.historical_summaries_batch(jhist, targets, beta=3)
    for key in jb:
        np.testing.assert_array_equal(hb[key], jb[key], err_msg=key)
    for t in targets:
        h = graph.historical_summary(hist, float(t))
        j = jgraph.historical_summary(jhist, float(t))
        assert (h.start_scaleout, h.end_scaleout) == \
            (j.start_scaleout, j.end_scaleout)
        np.testing.assert_array_equal(h.context, j.context)
        np.testing.assert_array_equal(h.metrics, j.metrics)
    assert graph.empty_graph().n_nodes == 0


def test_context_encoder_with_reference_weights(jax_encoder):
    """Contexts of the runner's node builders agree draw for draw."""
    job_key = "kmeans"
    ref = jax_encoder
    ref.rng = np.random.RandomState(5)
    ref._cache = {}
    ours = ContextEncoder([workloads.JOBS[job_key]], seed=5, device="cpu",
                          ae_params=_ae_tree(ref))
    sim, jsim = ClusterSim(seed=2), JClusterSim(seed=2)
    job, jjob = workloads.JOBS[job_key], jworkloads.JOBS[job_key]
    sim.begin_run()
    jsim.begin_run()
    comp = sim.run_component(job, 1, clock=0.0, start_scaleout=8,
                             end_scaleout=12, inject_failures=False,
                             failures_log=[])
    jcomp = jsim.run_component(jjob, 1, clock=0.0, start_scaleout=8,
                               end_scaleout=12, inject_failures=False,
                               failures_log=[])
    for _ in range(3):
        got = runner._component_nodes(ours, job, comp) + \
            runner._future_nodes(ours, job, 2, 8.0, 12.0)
        want = jrunner._component_nodes(ref, jjob, jcomp) + \
            jrunner._future_nodes(ref, jjob, 2, 8.0, 12.0)
        for a, b in zip(got, want):
            assert (a.name, a.start_scaleout, a.end_scaleout,
                    a.time_fraction) == (b.name, b.start_scaleout,
                                         b.end_scaleout, b.time_fraction)
            np.testing.assert_allclose(a.context, b.context, atol=1e-6)
    g = runner._to_graph(got[:2], got[2:3], 1)
    jg = jrunner._to_graph(want[:2], want[2:3], 1)
    np.testing.assert_array_equal(g.adj, jg.adj)
    np.testing.assert_allclose(g.context, jg.context, atol=1e-6)
    assert ours.rng.rand() == ref.rng.rand()      # same number of draws


def test_autoencoder_encode_matches_reference():
    tree = jax.tree_util.tree_map(np.asarray,
                                  jinit_ae(jax.random.PRNGKey(3)))
    from repro.core.autoencoder import embed_properties as jembed
    vecs = encoding.encode_properties(["spark 3.1", 64, "update-centers", 0])
    ours = autoencoder.embed_properties(
        autoencoder_params_from_numpy(tree, device="cpu"), vecs)
    np.testing.assert_allclose(ours, jembed(tree, vecs), atol=1e-6)


def test_train_autoencoder_reduces_loss():
    vecs = encoding.encode_properties(
        ["LR", "Multiclass", 27, "read-cache", "map-gradient", 64, 0,
         "spark 3.1", "scala 2.12.11", 10240])
    params, loss = autoencoder.train_autoencoder(vecs, steps=100,
                                                 device="cpu")
    untrained = autoencoder.init_autoencoder(
        torch.Generator().manual_seed(0), device="cpu")
    with torch.no_grad():
        start = float(autoencoder.recon_loss(untrained, torch.tensor(vecs)))
    assert np.isfinite(loss) and loss < 0.5 * start


def test_bell_initial_scaleout_matches_reference():
    rng = np.random.RandomState(0)
    hist = [(float(s), 400.0 / s + 20 + rng.rand()) for s in (4, 8, 11, 14)]
    for target in (30.0, 60.0, 200.0):
        assert bell.initial_scaleout(hist, target, (4, 36)) == \
            jbell.initial_scaleout(hist, target, (4, 36))


def test_fallback_matches_reference():
    rng = np.random.RandomState(1)
    cands = list(range(4, 37, 4))
    for _ in range(50):
        totals = list(rng.rand(len(cands)) * 100)
        for i in rng.randint(0, len(cands), rng.randint(0, len(cands) + 1)):
            totals[i] = float("nan")
        args = (cands, totals, int(rng.randint(4, 37)),
                float(rng.rand() * 100), float(rng.rand() * 100))
        a, b = FallbackPolicy().decide(*args), JFallbackPolicy().decide(*args)
        assert a[0] == b[0]
        assert (np.isnan(a[1]) and np.isnan(b[1])) or a[1] == b[1]


def test_window_tables_match_reference():
    for name in ("node_failure", "interference_burst", "spot_preemption"):
        ours = scenarios.make_scenario(name, seed=4).window_tables(9)
        ref = jscenarios.make_scenario(name, seed=4).window_tables(9)
        for key in ref:
            np.testing.assert_array_equal(ours[key], ref[key], err_msg=key)


def test_enel_params_from_numpy_keeps_layout():
    from repro.core.model import init_enel as jinit_enel
    tree = jax.tree_util.tree_map(np.asarray,
                                  jinit_enel(jax.random.PRNGKey(2)))
    p = enel_params_from_numpy(tree, device="cpu")
    np.testing.assert_array_equal(p["f3"][0]["w"].numpy(), tree["f3"][0]["w"])
    np.testing.assert_array_equal(p["attn_a"].numpy(), tree["attn_a"])
    assert p["f4"][1]["b"].dtype == torch.float32
