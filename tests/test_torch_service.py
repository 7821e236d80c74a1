"""PyTorch port vs JAX reference: the fleet decision service.

The contracts under test, on the CPU at the reference's tolerances:

* the shape ladders, ``bucket_sweep``, ``sweep_edge_list`` and whole
  ``prepare_request`` requests are byte-equal to the reference's on the four
  paper jobs' builders (``runner._future_nodes``/``_to_graph``; a stub
  encoder gives both packages the same node contexts without draws);
* padding a sweep to the ladders changes nothing (dense route, exactly);
* the sparse-edge engine equals the reference's and the port's dense route;
* a three-job ``decide`` gives the reference service's picks, a J = 4
  dispatch gives each row's J = 1 decision, the two dispatch modes agree
  bit for bit;
* capacity caps, shedding order, the retry / breaker envelope under
  ``DispatchChaos``, fits between decisions (the stack memo), NaN params
  (the guardrail), and the count of dispatch signatures.

The tests marked ``cuda`` need an NVIDIA card; they skip without one,
naming what is missing.  The reference is imported inside a fixture, so
this file loads without JAX.
"""
import dataclasses
import types
import warnings
import zlib

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.convert import enel_params_from_numpy
from repro_torch.core import model
from repro_torch.core import service as service_mod
from repro_torch.core.graph import (CAND_LADDER, COMP_LADDER, CTX_DIM,
                                    EDGE_LADDER, LEVEL_LADDER, N_METRICS,
                                    NODE_LADDER, NodeAttrs, bucket_sweep,
                                    build_graph, ladder_bucket,
                                    materialize_candidate,
                                    stack_graphs, summary_node,
                                    sweep_edge_list)
from repro_torch.core.scaling import EnelScaler
from repro_torch.core.service import (DecisionService, apply_capacity,
                                      sweep_eval_one)
from repro_torch.core.training import EnelTrainer, map_params, param_leaves
from repro_torch.dataflow import runner
from repro_torch.dataflow.workloads import JOBS, SCALEOUT_RANGE
from repro_torch.sim.chaos import ChaosSpec, DispatchChaos

JOB_KEYS = ("lr", "mpc", "kmeans", "gbt")
ELAPSED = 100.0
FAST = dict(backoff_base_s=1e-4, backoff_cap_s=1e-3)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these eager ops are tiny, and test processes
    that share a host's cores while each spins a full thread pool slow one
    another down many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class StubEncoder:
    """Node contexts as a pure function of (job, stage, tasks, attempt): no
    draws, so both packages' builders give the same graphs."""

    def node_context(self, job, stage_name, n_tasks, attempt=0,
                     drop_versions=True):
        key = f"{job.name}/{stage_name}/{n_tasks}/{attempt}".encode()
        rng = np.random.RandomState(zlib.crc32(key))
        return np.tanh(rng.randn(CTX_DIM)).astype(np.float32)


def _observe(nodes, rng):
    for nd in nodes:
        nd.metrics = rng.rand(N_METRICS).astype(np.float32)
        nd.runtime = float(5.0 + rng.rand())
    return nodes


def _side(pkg, job_key, stride, params=None, seed=0):
    """(job, scaler, builder, P0 summary) of one package (``pkg`` holds its
    ``runner``, ``EnelScaler``, ``trainer`` factory and ``summary_node``),
    with four runs of seeded history."""
    job = pkg.JOBS[job_key]
    enc = StubEncoder()
    sc = pkg.EnelScaler(pkg.trainer(seed, params), SCALEOUT_RANGE,
                        candidate_stride=stride)
    fut = lambda k, a, z: pkg.runner._future_nodes(enc, job, k, a, z)
    rng = np.random.RandomState(seed)
    for _ in range(4):
        for k in range(job.n_components):
            s = float(rng.choice([4, 8, 16, 24, 36]))
            sc.record_component(k, _observe(fut(k, s, s), rng), 10.0)
    builder = lambda ci, a, z, pr: pkg.runner._to_graph(
        pkg.runner._future_nodes(enc, job, ci, a, z), pr, ci)
    summary = pkg.summary_node(_observe(fut(0, 8.0, 8.0), rng), name="P0")
    return job, sc, builder, summary


PORT = types.SimpleNamespace(
    JOBS=JOBS, runner=runner, EnelScaler=EnelScaler,
    summary_node=summary_node,
    trainer=lambda seed, params: _port_trainer(seed, params, "cpu"))


def _port_trainer(seed, params, device):
    tr = EnelTrainer(seed=seed, device=device)
    if params is not None:
        tr.params = enel_params_from_numpy(params, device=device)
    return tr


def _kwargs(job, sc, builder, summary, next_comp=1, current=9,
            target=None):
    """prepare_request arguments; the target defaults to the midpoint of
    the two middle candidate totals of the dense sweep, so the pick is a
    real choice and no total lies near the target."""
    kw = dict(graph_builder=builder, next_comp=next_comp,
              n_components=job.n_components, elapsed=ELAPSED,
              current_scaleout=current, current_summary=summary)
    if target is None:
        cands = sc.candidate_scaleouts(current)
        template, deltas = sc.build_sweep(
            graph_builder=builder, next_comp=next_comp,
            n_components=job.n_components, current_scaleout=current,
            candidates=cands, current_summary=summary)
        per = np.asarray(sc.trainer.predict_sweep(template, deltas))
        totals = np.sort(per.sum(axis=1) + ELAPSED)
        mid = len(totals) // 2
        target = float(totals[mid - 1] + totals[mid]) / 2
    return dict(kw, target_runtime=target)


def _port_request(job_key, stride=2, seed=0, device="cpu"):
    """(scaler, request) of one job at its first boundary; the target comes
    from the CPU, whatever the device."""
    job, sc, builder, summary = _side(PORT, job_key, stride, seed=seed)
    kw = _kwargs(job, sc, builder, summary)
    if device != "cpu":
        sc = _on(sc, device)
    return sc, sc.prepare_request(**kw)


def _on(sc, device):
    """A copy of a CPU scaler's state on ``device``."""
    tr = EnelTrainer(seed=sc.trainer.seed, device=device)
    tr.params = map_params(lambda t: t.to(device), sc.trainer.params)
    out = EnelScaler(tr, sc.range, candidate_stride=sc.candidate_stride)
    out.hist_summaries = sc.hist_summaries
    return out


@pytest.fixture(scope="module")
def ref():
    """The reference package's pieces, as :data:`PORT` holds the port's."""
    import jax
    from repro.core import graph as jgraph
    from repro.core import model as jmodel
    from repro.core import service as jservice
    from repro.core.scaling import EnelScaler as JEnelScaler
    from repro.core.training import EnelTrainer as JEnelTrainer
    from repro.dataflow import runner as jrunner
    from repro.dataflow import workloads as jworkloads

    return types.SimpleNamespace(
        jax=jax, graph=jgraph, model=jmodel, service=jservice,
        JOBS=jworkloads.JOBS, runner=jrunner, EnelScaler=JEnelScaler,
        summary_node=jgraph.summary_node,
        trainer=lambda seed, params: JEnelTrainer(seed=seed),
        np_params=lambda tr: jax.tree_util.tree_map(np.asarray, tr.params))


def _pair(ref, job_key, stride):
    """Reference and port sides of one job, the port on the reference's
    initial parameters."""
    jside = _side(ref, job_key, stride)
    side = _side(PORT, job_key, stride,
                 params=ref.np_params(jside[1].trainer))
    return jside, side


def _assert_same_request(jreq, req):
    assert req.bucket_key == jreq.bucket_key
    for key, v in jreq.deltas.items():
        assert req.deltas[key].dtype == v.dtype, key
        np.testing.assert_array_equal(req.deltas[key], v, err_msg=key)
    for key, v in jreq.base.items():
        v = np.asarray(v)
        np.testing.assert_array_equal(req.base[key].numpy(), v, err_msg=key)
        assert req.base[key].numpy().dtype == v.dtype, key
    np.testing.assert_array_equal(req.h_onehot.numpy(),
                                  np.asarray(jreq.h_onehot))
    for name in ("edge_dst", "edge_src", "edge_valid", "candidates",
                 "cand_valid"):
        a, b = getattr(req, name), getattr(jreq, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (req.levels, req.candidate_list, req.n_components,
            req.elapsed, req.target, req.current_scaleout) == \
        (jreq.levels, jreq.candidate_list, jreq.n_components,
         jreq.elapsed, jreq.target, jreq.current_scaleout)


# ----------------------------------------- ladders, bucketing, edge lists
@pytest.mark.parametrize("ladder", [CAND_LADDER, COMP_LADDER, NODE_LADDER,
                                    EDGE_LADDER, LEVEL_LADDER,
                                    service_mod.JOB_LADDER])
def test_ladder_bucket_matches_reference(ref, ladder):
    assert ladder in (ref.graph.CAND_LADDER, ref.graph.COMP_LADDER,
                      ref.graph.NODE_LADDER, ref.graph.EDGE_LADDER,
                      ref.graph.LEVEL_LADDER, ref.service.JOB_LADDER)
    for n in range(0, 3 * ladder[-1] + 2):
        assert ladder_bucket(n, ladder) == ref.graph.ladder_bucket(n, ladder)


@pytest.mark.parametrize("job_key", JOB_KEYS)
def test_requests_byte_equal_reference(ref, job_key):
    """bucket_sweep, sweep_edge_list and whole prepare_request requests are
    byte-equal to the reference's, across K/C shapes that cross the
    bucket boundaries (incl. an exact-rung K and small tails)."""
    (jjob, jsc, jbuilder, jsum), (job, sc, builder, summ) = \
        _pair(ref, job_key, 2)
    n = job.n_components
    for next_comp, stride in [(1, 2), (max(1, n - 12), 2), (n - 4, 2),
                              (n - 1, 2), (1, 8)]:
        jsc.candidate_stride = sc.candidate_stride = stride
        cands = sc.candidate_scaleouts(9)
        template, deltas = sc.build_sweep(
            graph_builder=builder, next_comp=next_comp, n_components=n,
            current_scaleout=9, candidates=cands, current_summary=summ)
        jtemplate, jdeltas = jsc.build_sweep(
            graph_builder=jbuilder, next_comp=next_comp, n_components=n,
            current_scaleout=9, candidates=cands, current_summary=jsum)
        pt, pd, real = bucket_sweep(template, deltas)
        jpt, jpd, jreal = ref.graph.bucket_sweep(jtemplate, jdeltas)
        assert real == jreal and pt.levels == jpt.levels
        for key in jpd:
            np.testing.assert_array_equal(pd[key], jpd[key])
        for key in jpt.base:
            np.testing.assert_array_equal(pt.base[key], jpt.base[key])
            assert pt.base[key].dtype == jpt.base[key].dtype
        for a, b in zip(sweep_edge_list(pt.base),
                        ref.graph.sweep_edge_list(jpt.base)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        for c in (0, len(cands) - 1):
            got = materialize_candidate(template, deltas, c)
            want = ref.graph.materialize_candidate(jtemplate, jdeltas, c)
            for key in want:
                np.testing.assert_array_equal(got[key], want[key])
        kw = dict(graph_builder=builder, next_comp=next_comp,
                  n_components=n, elapsed=ELAPSED, current_scaleout=9,
                  target_runtime=500.0, current_summary=summ)
        req = sc.prepare_request(**kw)
        jreq = jsc.prepare_request(**dict(kw, graph_builder=jbuilder,
                                          current_summary=jsum))
        _assert_same_request(jreq, req)


# ------------------------------------------------- padded == unpadded (0.0)
@pytest.mark.parametrize("job_key", JOB_KEYS)
def test_bucketed_sweep_matches_unpadded_exactly(job_key):
    """Dense sweep on ladder-padded template/deltas == unpadded sweep, bit
    for bit; padded components read out exactly 0."""
    job, sc, builder, summ = _side(PORT, job_key, 2)
    n = job.n_components
    for next_comp, stride in [(1, 2), (max(1, n - 12), 2), (n - 4, 2),
                              (n - 1, 2), (1, 8)]:
        sc.candidate_stride = stride
        cands = sc.candidate_scaleouts(9)
        template, deltas = sc.build_sweep(
            graph_builder=builder, next_comp=next_comp, n_components=n,
            current_scaleout=9, candidates=cands, current_summary=summ)
        want = sc.trainer.predict_sweep(template, deltas)
        pt, pd, (c_real, k_real) = bucket_sweep(template, deltas)
        per = model.sweep_per_component(
            sc.trainer.params,
            {k: torch.as_tensor(v) for k, v in pt.base.items()},
            torch.as_tensor(pt.h_onehot),
            {k: torch.as_tensor(v) for k, v in pd.items()},
            levels=pt.levels).numpy()
        np.testing.assert_array_equal(per[:c_real, :k_real], want)
        np.testing.assert_array_equal(per[:, k_real:], 0.0)


# ------------------------------------------------------ sparse engine
def _random_graphs(seed, count=7, max_nodes=8):
    rng = np.random.RandomState(seed)
    graphs = []
    for k in range(count):
        n = rng.randint(1, max_nodes)
        nodes = [NodeAttrs(
            f"n{i}", np.tanh(rng.randn(CTX_DIM)).astype(np.float32),
            rng.rand(N_METRICS).astype(np.float32) if rng.rand() < 0.5
            else None,
            float(rng.randint(2, 30)), float(rng.randint(2, 30)),
            time_fraction=float(0.5 + 0.5 * rng.rand()),
            is_summary=bool(rng.rand() < 0.3)) for i in range(n)]
        edges = [(i, j) for j in range(n) for i in range(j)
                 if rng.rand() < 0.4]
        graphs.append(build_graph(nodes, edges, k, max_nodes=max_nodes))
    return graphs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sparse_engine_matches_reference_and_dense(ref, seed):
    batch = stack_graphs(_random_graphs(seed))
    jparams = ref.model.init_enel(ref.jax.random.PRNGKey(seed))
    params = enel_params_from_numpy(
        ref.jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    dst, src, val = sweep_edge_list(batch)
    jnp = ref.jax.numpy
    want = np.asarray(ref.model.sweep_sparse_totals(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()},
        jnp.asarray(dst), jnp.asarray(src), jnp.asarray(val)))
    flat = {k: torch.as_tensor(v) for k, v in batch.items()}
    got = model.sweep_sparse_totals(params, flat, torch.as_tensor(dst),
                                    torch.as_tensor(src),
                                    torch.as_tensor(val))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    dense = model.forward_stacked(params, flat)["total_runtime"]
    torch.testing.assert_close(got, dense, atol=1e-5, rtol=1e-5)


# ------------------------------------- batched decide == reference service
def test_decide_matches_reference_service(ref):
    """Three jobs in one decide: the reference service's picks, totals at
    rtol 1e-4 / atol 1e-3, per-component predictions alike."""
    jreqs, reqs = [], []
    for key in ("lr", "kmeans", "gbt"):
        (jjob, jsc, jbuilder, jsum), (job, sc, builder, summ) = \
            _pair(ref, key, 2)
        kw = _kwargs(job, sc, builder, summ)
        reqs.append(sc.prepare_request(**kw))
        jreqs.append(jsc.prepare_request(**dict(
            kw, graph_builder=jbuilder, current_summary=jsum)))
        _assert_same_request(jreqs[-1], reqs[-1])
    jres = ref.service.DecisionService().decide(jreqs)
    svc = DecisionService()
    res = svc.decide(reqs)
    assert svc.decisions == 3 and svc.fallback_decisions == 0
    for a, b in zip(res, jres):
        assert a.scaleout == b.scaleout and not a.fallback
        assert set(a.totals) == set(b.totals)
        for s in b.totals:
            np.testing.assert_allclose(a.totals[s], b.totals[s], rtol=1e-4,
                                       atol=1e-3)
        np.testing.assert_allclose(a.per_component, b.per_component,
                                   rtol=1e-4, atol=1e-3)


def _tenants(job_key="kmeans", n=3, device="cpu"):
    """``n`` tenants of one job (own params, same history) at one boundary:
    one bucket key."""
    out = [_port_request(job_key, seed=s, device=device) for s in range(n)]
    target = out[0][1].target
    reqs = [dataclasses.replace(r, target=target) for _, r in out]
    assert len({r.bucket_key for r in reqs}) == 1
    return [sc for sc, _ in out], reqs


def test_job_axis_rows_equal_single_dispatch():
    """A group of three requests dispatches once at the J = 4 rung; each row
    gives the pick of the same request alone (J = 1) and its totals within
    1e-6 relative; sweep_eval_one (J = 1) agrees too."""
    _, reqs = _tenants()
    svc = DecisionService()
    batched = svc.decide(reqs)
    assert (svc.dispatches, svc.batched_away) == (1, 2)
    for req, b in zip(reqs, batched):
        alone = DecisionService().decide([req])[0]
        assert b.scaleout == alone.scaleout
        for s in alone.totals:
            np.testing.assert_allclose(b.totals[s], alone.totals[s],
                                       rtol=1e-6)
        t = lambda a: torch.as_tensor(np.asarray(a))
        idx, totals, per, ok = sweep_eval_one(
            req.params, req.base, req.h_onehot,
            {k: t(v) for k, v in req.deltas.items()}, t(req.edge_dst),
            t(req.edge_src), t(req.edge_valid), t(req.candidates),
            t(req.cand_valid), torch.tensor(req.elapsed),
            torch.tensor(req.target), req.levels)
        assert bool(ok) and req.candidate_list[int(idx)] == alone.scaleout
        np.testing.assert_allclose(
            totals.numpy()[:len(req.candidate_list)],
            [alone.totals[s] for s in req.candidate_list], rtol=1e-6)


def test_double_buffered_matches_sync_exactly():
    """Overlapped enqueue-then-fetch returns exactly the synchronous path's
    decisions (picks, totals, per-component predictions), over a J = 4
    group and a J = 1 group of another bucket."""
    _, reqs = _tenants()
    reqs = reqs + [_port_request("gbt")[1]]
    sync = DecisionService(double_buffer=False)
    buf = DecisionService(double_buffer=True)
    res_s, res_b = sync.decide(reqs), buf.decide(reqs)
    assert sync.dispatches == buf.dispatches == 2
    for a, b in zip(res_s, res_b):
        assert (a.scaleout, a.predicted, a.totals) == \
            (b.scaleout, b.predicted, b.totals)
        np.testing.assert_array_equal(a.per_component, b.per_component)


def test_no_warning_on_the_dispatch_path():
    """No op of a decide falls back to a slow path with a warning (e.g. a
    batching rule missing): every warning is an error here."""
    _, reqs = _tenants()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        DecisionService().decide(reqs + [_port_request("lr")[1]])


# --------------------------------------------------- capacity, shedding
def test_apply_capacity():
    _, req = _port_request("kmeans")
    assert apply_capacity(req, 36) is req                 # does not bind
    capped = apply_capacity(req, 13)
    valid = capped.candidates[capped.cand_valid]
    assert valid.max() <= 13 and valid.min() == req.candidates.min()
    assert req.cand_valid.sum() > capped.cand_valid.sum()
    floor = apply_capacity(req, 1)                  # excludes everything
    assert floor.candidates[floor.cand_valid].tolist() == \
        [req.candidates[req.cand_valid].min()]
    res = DecisionService().decide([capped, floor])
    assert res[0].scaleout <= 13 and res[1].scaleout == valid.min()


def test_shedding_best_effort_first_newest_first():
    _, req = _port_request("kmeans")
    effort = [False, True, False, True, False]
    reqs = [dataclasses.replace(req, best_effort=e) for e in effort]
    svc = DecisionService(shed_capacity=2)
    res = svc.decide(reqs)
    # 3 shed: both best-effort ones (newest first), then the newest other
    assert [r.shed for r in res] == [False, True, False, True, True]
    assert all(r.fallback for r in res if r.shed)
    assert (svc.shed_requests, svc.fallback_decisions, svc.dispatches) == \
        (3, 3, 1)
    for r in res:
        assert r.scaleout in req.candidate_list


# ------------------------------------------------ retry / breaker envelope
def test_retry_and_breaker_under_dispatch_chaos():
    """Timeouts every 3rd dispatch in bursts of 5, one retry, breaker
    threshold 2, probe after 2 blocked calls: calls 3-4 exhaust their
    retries and trip the breaker, 5-6 are blocked (the 6th half-opens it),
    7's probe retries past the burst's end and closes it.  Every fallback
    span links to the fault or transition that forced it."""
    _, req = _port_request("kmeans")
    rec = obs.recorder()
    rec.clear()
    svc = DecisionService(max_retries=1, breaker_threshold=2,
                          breaker_probe_after=2, **FAST)
    svc.fault_injector = DispatchChaos(ChaosSpec(timeout_every=3,
                                                 timeout_burst=5))
    with obs.obs_enabled(True):
        fell = [svc.decide([req])[0].fallback for _ in range(8)]
    assert fell == [False, False, True, True, True, True, False, False]
    assert svc.stats() == dict(
        decisions=8, dispatches=4, batched_away=0, fallback_decisions=4,
        guardrail_trips=0, retries=3, dispatch_failures=5, shed_requests=0,
        breaker_trips=1, breaker_state="closed")
    causes = [e["attrs"]["cause"] for e in rec.events("decision.fallback")]
    assert causes == ["retries_exhausted"] * 2 + ["breaker_open"] * 2
    for ev in rec.events("decision.fallback"):
        cause = rec.find(ev["attrs"]["cause_seq"])
        assert cause is not None and cause["seq"] < ev["seq"]
        assert cause["kind"] in ("dispatch.fault", "breaker.transition")
    moves = [(e["attrs"]["src"], e["attrs"]["dst"])
             for e in rec.events("breaker.transition")]
    assert moves == [("closed", "open"), ("open", "half_open"),
                     ("half_open", "closed")]


# ------------------------------------------- stack memo, guardrail
def _ring_graphs(job, builder, rng):
    return [runner._to_graph(_observe(runner._future_nodes(
        StubEncoder(), job, k, 8.0, 8.0), rng), [], k)
        for k in range(job.n_components)]


def test_fit_between_decisions_is_seen():
    """The Adam step updates the params in place; the service's stack memo
    must not serve the weights from before the fit."""
    job, sc, builder, summ = _side(PORT, "kmeans", 2)
    kw = _kwargs(job, sc, builder, summ)
    svc = DecisionService()
    # a group of two: the memo then holds a stacked copy, not a view
    req = sc.prepare_request(**kw)
    before = svc.decide([req, req])[0]
    tr = sc.trainer
    leaves = [id(t) for t in param_leaves(tr.params)]
    tr.extend_history(_ring_graphs(job, builder, np.random.RandomState(1)))
    tr.fit_resident(steps=8, latest_only=True)
    assert [id(t) for t in param_leaves(tr.params)] == leaves   # in place
    req = sc.prepare_request(**kw)
    after = svc.decide([req, req])[0]
    fresh = DecisionService().decide([req, req])[0]
    assert after.totals == fresh.totals
    assert after.totals != before.totals


@pytest.mark.parametrize("in_place", [False, True])
def test_nan_params_trip_the_guardrail(in_place):
    """NaN params (as chaos writes them, or written in place) give
    non-finite sparse totals: the row falls back to FallbackPolicy."""
    job, sc, builder, summ = _side(PORT, "kmeans", 2)
    kw = _kwargs(job, sc, builder, summ)
    svc = DecisionService()
    assert not svc.decide([sc.prepare_request(**kw)])[0].fallback
    if in_place:
        with torch.no_grad():
            for t in param_leaves(sc.trainer.params):
                t.fill_(float("nan"))
    else:
        sc.trainer.params = map_params(
            lambda t: torch.full_like(t, float("nan")), sc.trainer.params)
    req = sc.prepare_request(**kw)
    rec = obs.recorder()
    rec.clear()
    with obs.obs_enabled(True):
        res = svc.decide([req])[0]
    assert res.fallback and not res.shed
    assert res.scaleout in req.candidate_list
    assert (svc.guardrail_trips, svc.fallback_decisions) == (1, 1)
    assert res.per_component.shape == (len(req.candidate_list),
                                       req.n_components)
    assert not res.per_component.any()
    trip = rec.events("guardrail.trip")
    assert len(trip) == 1
    assert rec.events("decision.fallback")[0]["attrs"]["cause_seq"] == \
        trip[0]["seq"]


def test_trace_counts_bounded_by_signatures(monkeypatch):
    """record_trace("fleet_sweep") once per new (bucket key, job rung); a
    repeat decide at seen shapes adds nothing."""
    monkeypatch.setattr(service_mod, "_SIGNATURES", set())
    monkeypatch.setattr(model, "TRACE_COUNTS", type(model.TRACE_COUNTS)())
    _, tenants = _tenants()
    other = [_port_request(k)[1] for k in ("lr", "gbt")]
    svc = DecisionService()
    svc.decide(tenants + other)
    svc.decide(tenants[:1] + other)
    sigs = {(r.bucket_key, 4) for r in tenants} | \
        {(r.bucket_key, 1) for r in tenants[:1] + other}
    assert model.trace_count("fleet_sweep") == len(sigs) == 4
    for _ in range(2):
        svc.decide(tenants + other)
        svc.decide(tenants[:1] + other)
    assert model.trace_count("fleet_sweep") == 4


def test_group_on_several_devices_raises():
    _, req = _port_request("kmeans")
    meta = dataclasses.replace(
        req, params=map_params(lambda t: t.to("meta"), req.params))
    with pytest.raises(ValueError, match="several devices"):
        DecisionService().decide([req, meta])


# ------------------------------------------------------------- on the card
@pytest.fixture
def card():
    """The CUDA card, or a skip naming what is missing."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is "
                    "False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sparse_engine_on_card_matches_cpu(card, seed):
    batch = stack_graphs(_random_graphs(seed))
    params = model.init_enel(torch.Generator().manual_seed(seed), "cpu")
    dst, src, val = (torch.as_tensor(a) for a in sweep_edge_list(batch))
    flat = {k: torch.as_tensor(v) for k, v in batch.items()}
    want = model.sweep_sparse_totals(params, flat, dst, src, val)
    move = lambda t: t.to(card)
    got = model.sweep_sparse_totals(
        map_params(move, params), {k: move(v) for k, v in flat.items()},
        move(dst), move(src), move(val))
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_decide_on_card_matches_cpu(card):
    """Three tenants (one J = 4 group) and two other jobs on the card: the
    CPU's picks, totals within 1e-5 relative."""
    _, cpu_reqs = _tenants()
    cpu_reqs += [_port_request(k)[1] for k in ("lr", "gbt")]
    _, reqs = _tenants(device=card)
    reqs += [_port_request(k, device=card)[1] for k in ("lr", "gbt")]
    want = DecisionService().decide(cpu_reqs)
    got = DecisionService().decide(reqs)
    for a, b in zip(got, want):
        assert a.scaleout == b.scaleout and not a.fallback
        for s in b.totals:
            np.testing.assert_allclose(a.totals[s], b.totals[s], rtol=1e-5)


@pytest.mark.cuda
def test_double_buffered_matches_sync_on_card(card):
    _, reqs = _tenants(device=card)
    reqs += [_port_request("gbt", device=card)[1]]
    res_s = DecisionService(double_buffer=False).decide(reqs)
    res_b = DecisionService(double_buffer=True).decide(reqs)
    for a, b in zip(res_s, res_b):
        assert (a.scaleout, a.predicted, a.totals) == \
            (b.scaleout, b.predicted, b.totals)
        np.testing.assert_array_equal(a.per_component, b.per_component)


@pytest.mark.cuda
def test_nan_params_trip_the_guardrail_on_card(card):
    job, sc, builder, summ = _side(PORT, "kmeans", 2)
    kw = _kwargs(job, sc, builder, summ)
    sc = _on(sc, card)
    sc.trainer.params = map_params(
        lambda t: torch.full_like(t, float("nan")), sc.trainer.params)
    svc = DecisionService()
    res = svc.decide([sc.prepare_request(**kw)])[0]
    assert res.fallback and svc.guardrail_trips == 1
