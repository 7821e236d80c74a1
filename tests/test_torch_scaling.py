"""PyTorch port vs JAX reference: the single-job decision path.

Both packages drive the same seeded runs — simulator, context encoder (the
reference's auto-encoder weights carried across), profiling runs, then an
adaptive run with ``EnelScaler.recommend`` at every component boundary —
with the reference's model parameters converted into the port.  The picks
must be equal at every boundary and the per-candidate totals agree to
float32 rounding (rtol 1e-5).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core.graph import summary_node as jsummary_node
from repro.core.scaling import EnelScaler as JEnelScaler
from repro.core.training import EnelTrainer as JEnelTrainer
from repro.dataflow import runner as jrunner
from repro.dataflow import workloads as jworkloads
from repro.dataflow.context import ContextEncoder as JContextEncoder
from repro.dataflow.simulator import ClusterSim as JClusterSim
from repro_torch.convert import enel_params_from_numpy
from repro_torch.core.scaling import EnelScaler
from repro_torch.core.training import EnelTrainer
from repro_torch.dataflow import runner
from repro_torch.dataflow.context import ContextEncoder
from repro_torch.dataflow.simulator import ClusterSim
from repro_torch.dataflow.workloads import JOBS, SCALEOUT_RANGE

STRIDE = 8          # 5-6 candidates: C x K <= 66 graphs per sweep


@pytest.fixture(scope="module")
def jax_encoder():
    """One reference encoder (AE trained once) over both test jobs; each
    test re-seeds its draw stream."""
    return JContextEncoder([jworkloads.JOBS["kmeans"],
                            jworkloads.JOBS["gbt"]], seed=0)


def _pair(jax_encoder, job_key, seed):
    """Reference and port (encoder, trainer, scaler, sim) in equal states."""
    jenc = jax_encoder
    jenc.rng = np.random.RandomState(seed)
    jenc._cache = {}
    enc = ContextEncoder([JOBS[job_key]], seed=seed, device="cpu",
                         ae_params=jax.tree_util.tree_map(np.asarray,
                                                          jenc.ae_params))
    jtr = JEnelTrainer(seed=seed)
    tr = EnelTrainer(seed=seed, device="cpu")
    tr.params = enel_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jtr.params), device="cpu")
    jsc = JEnelScaler(jtr, SCALEOUT_RANGE, candidate_stride=STRIDE)
    sc = EnelScaler(tr, SCALEOUT_RANGE, candidate_stride=STRIDE)
    return ((jenc, jsc, JClusterSim(seed=seed)),
            (enc, sc, ClusterSim(seed=seed)))


def _jax_run(enc, scaler, sim, job, initial_s, inject, target, interval=1):
    """The reference's run protocol (``JobExperiment._execute_gen``) with the
    reference ``recommend`` answering each boundary."""
    sim.begin_run()
    clock, s_prev, s = 0.0, initial_s, initial_s
    out = []
    builder = lambda ci, a, z, pr: jrunner._to_graph(
        jrunner._future_nodes(enc, job, ci, a, z), pr, ci)
    for k in range(job.n_components):
        comp = sim.run_component(job, k, clock=clock, start_scaleout=s_prev,
                                 end_scaleout=s, inject_failures=inject,
                                 failures_log=[])
        clock = float(comp.stages[-1].start + comp.stages[-1].runtime)
        nodes = jrunner._component_nodes(enc, job, comp)
        scaler.record_component(k, nodes, comp.runtime)
        prev = jsummary_node(nodes, name=f"P{k}")
        s_prev = s
        if target is None or k >= job.n_components - 1 or k % interval:
            continue
        s, _, totals = scaler.recommend(
            graph_builder=builder, next_comp=k + 1,
            n_components=job.n_components, elapsed=clock,
            current_scaleout=s, target_runtime=target, current_summary=prev)
        out.append((s, totals))
    return out


@pytest.mark.parametrize("job_key,inject", [("kmeans", False), ("gbt", True)])
def test_recommend_matches_reference_run(jax_encoder, job_key, inject):
    (jenc, jsc, jsim), (enc, sc, sim) = _pair(jax_encoder, job_key, seed=1)
    job, jjob = JOBS[job_key], jworkloads.JOBS[job_key]
    runtimes = []
    for s0 in runner.PROFILING_SCALEOUTS[:3]:
        res = runner.execute_run(sim=sim, encoder=enc, job=job, scaler=sc,
                                 initial_s=s0, inject_failures=False)
        _jax_run(jenc, jsc, jsim, jjob, s0, False, None)
        runtimes.append(res.run.runtime)
    target = float(np.median(runtimes) * 0.95)
    s0 = sc.initial_allocation(target, job.n_components)
    assert s0 == jsc.initial_allocation(target, jjob.n_components)
    res = runner.execute_run(sim=sim, encoder=enc, job=job, scaler=sc,
                             initial_s=s0, inject_failures=inject,
                             target=target)
    ref = _jax_run(jenc, jsc, jsim, jjob, s0, inject, target)
    assert len(res.decisions) == len(ref) == job.n_components - 1
    for d, (pick, totals) in zip(res.decisions, ref):
        assert d.pick == pick, (d.next_comp, d.totals, totals)
        assert d.totals.keys() == totals.keys()
        np.testing.assert_allclose([d.totals[s] for s in totals],
                                   list(totals.values()), rtol=1e-5)
    assert len({d.pick for d in res.decisions}) > 1     # the picks move
    assert enc.rng.rand() == jenc.rng.rand()            # same encoder draws


def _builder_parts():
    """A small structural builder (3-stage chains with P/H predecessors)."""
    rng = np.random.RandomState(0)
    ctx = rng.randn(8, 24).astype(np.float32)

    def nodes(mod, k, a, z):
        return [mod.NodeAttrs(f"st{i}", ctx[(k + i) % 8], None,
                              a if i == 0 else z, z, 1.0 if a == z else 0.8)
                for i in range(3)]

    def history(mod):
        rng = np.random.RandomState(1)
        out = {}
        for k in range(4):
            out[k] = [mod.summary_node(
                [mod.NodeAttrs(f"st{i}", ctx[i], rng.rand(5).astype(
                    np.float32), s, s) for i in range(3)], name=f"P{k}")
                for s in (4, 12, 20, 28)]
        return out
    return nodes, history


def test_build_sweep_matches_reference():
    from repro.core import graph as jgraph
    from repro_torch.core import graph
    nodes, history = _builder_parts()
    sweeps = []
    for mod, scaler_cls, trainer in (
            (graph, EnelScaler, EnelTrainer(device="cpu")),
            (jgraph, JEnelScaler, JEnelTrainer())):
        sc = scaler_cls(trainer, SCALEOUT_RANGE, candidate_stride=4)
        for k, hist in history(mod).items():
            sc.hist_summaries[k] = hist
        build = lambda ci, a, z, pr, mod=mod: mod.build_graph(
            nodes(mod, ci, a, z) + pr,
            [(0, 1), (1, 2)] + [(3 + j, 0) for j in range(len(pr))], ci)
        summ = mod.summary_node(nodes(mod, 1, 8.0, 8.0), name="P1")
        sweeps.append(sc.build_sweep(
            graph_builder=build, next_comp=2, n_components=5,
            current_scaleout=10, candidates=sc.candidate_scaleouts(10),
            current_summary=summ))
    (t, d), (jt, jd) = sweeps
    assert t.levels == jt.levels and t.comp_ids == jt.comp_ids
    for f in dataclasses.fields(jt):
        if f.name == "base":
            for key in jt.base:
                np.testing.assert_array_equal(t.base[key], jt.base[key])
        elif f.name not in ("comp_ids", "levels"):
            np.testing.assert_array_equal(getattr(t, f.name),
                                          getattr(jt, f.name))
    for key in jd:
        np.testing.assert_array_equal(d[key], jd[key], err_msg=key)


def test_recommend_matches_pergraph_and_template_cache():
    from repro_torch.core import graph
    nodes, history = _builder_parts()
    sc = EnelScaler(EnelTrainer(seed=3, device="cpu"), SCALEOUT_RANGE,
                    candidate_stride=4)
    for k, hist in history(graph).items():
        sc.hist_summaries[k] = hist
    build = lambda ci, a, z, pr: graph.build_graph(
        nodes(graph, ci, a, z) + pr,
        [(0, 1), (1, 2)] + [(3 + j, 0) for j in range(len(pr))], ci)
    kw = dict(graph_builder=build, next_comp=2, n_components=5, elapsed=10.0,
              current_scaleout=8, target_runtime=25.0,
              current_summary=graph.summary_node(nodes(graph, 1, 8.0, 8.0),
                                                 name="P1"))
    s_new, tot_new, totals_new = sc.recommend(**kw)
    s_old, tot_old, totals_old = sc.recommend_pergraph(**kw)
    assert s_new == s_old and totals_new.keys() == totals_old.keys()
    for s in totals_new:
        np.testing.assert_allclose(totals_new[s], totals_old[s], atol=1e-4)
    assert sc.last_per_component.shape == (len(totals_new), 3)
    # the same decision again re-ships nothing: every base array is a hit
    cache = sc.template_cache
    before = (cache.transfers, cache.skips)
    assert sc.recommend(**kw)[0] == s_new
    assert cache.transfers == before[0]
    assert cache.skips == before[1] + len(graph.SWEEP_KEYS) + 1


def test_recommend_falls_back_on_poisoned_model():
    from repro_torch.core import graph
    nodes, history = _builder_parts()
    tr = EnelTrainer(seed=0, device="cpu")
    tr.params["f2"][1]["b"] = torch.full_like(tr.params["f2"][1]["b"],
                                              float("nan"))
    sc = EnelScaler(tr, SCALEOUT_RANGE, candidate_stride=4)
    build = lambda ci, a, z, pr: graph.build_graph(
        nodes(graph, ci, a, z) + pr, [(0, 1), (1, 2)], ci)
    s, pred, totals = sc.recommend(
        graph_builder=build, next_comp=1, n_components=3, elapsed=5.0,
        current_scaleout=12, target_runtime=10.0)
    assert sc.fallback_decisions == 1
    assert s in sc.candidate_scaleouts(12) and totals == {}
    assert np.isnan(pred)
