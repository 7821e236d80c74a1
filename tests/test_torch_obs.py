"""PyTorch port vs JAX reference: the observability layer.

* the port's metrics registry, flight recorder and Prometheus text against
  the reference's ``repro.obs`` for the same sequence of calls (snapshots
  equal, text byte-equal, span streams equal);
* attribute-API compatibility: the service and template-cache counters
  live in the registry behind their attributes;
* a service checkpoint taken while the breaker is OPEN restores breaker
  state AND the registry's labels;
* every ``decision.fallback`` span links to the span that caused it;
* neutrality: with ``ENEL_OBS`` off a K-Means run through the service
  decides bit for bit as with it on, and adds no dispatch signature.
"""
import contextlib
import json
import math

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.obs.metrics import HistogramSeries as JHistogramSeries
from repro.obs.metrics import MetricsRegistry as JMetricsRegistry
from repro.obs.recorder import FlightRecorder as JFlightRecorder
from repro_torch import obs
from repro_torch.core import model
from repro_torch.core.service import (CircuitBreaker, DecisionService,
                                      DispatchTimeout)
from repro_torch.dataflow.runner import (JobExperiment, _future_nodes,
                                         _to_graph)
from repro_torch.obs.metrics import (DEFAULT_LATENCY_BUCKETS,
                                     HistogramSeries, MetricsRegistry)
from repro_torch.obs.recorder import FlightRecorder


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these eager ops are tiny, and test processes
    that share a host's cores while each spins a full thread pool slow one
    another down many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------ same calls, same state
def _drive_registry(reg, seed):
    """One seeded sequence of registry calls (counters, gauges, labeled and
    bucketed histograms, a snapshot and a merge-restore)."""
    rng = np.random.RandomState(seed)
    c = reg.counter("t_total", "things done")
    g = reg.gauge("t_state", "a level")
    h = reg.histogram("t_seconds", "latency")
    hb = reg.histogram("t_custom_seconds", buckets=(0.1, 1.0, 10.0))
    for i in range(40):
        svc = f"s{rng.randint(3)}"
        c.labels(service=svc, kind="a" if i % 2 else "b").inc(
            float(rng.randint(1, 4)))
        g.labels(service=svc).set(float(rng.rand()))
        h.labels(service=svc).observe(float(rng.lognormal(-4, 2)))
        hb.labels().observe(float(rng.lognormal(0, 2)))
        if i == 25:
            snap = reg.snapshot()
    h.labels(service="s0").observe(float("nan"))       # dropped
    reg.counter("t_late_total").labels(x="1").inc()
    reg.restore(snap)
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_matches_reference(seed):
    reg = _drive_registry(MetricsRegistry(), seed)
    jreg = _drive_registry(JMetricsRegistry(), seed)
    assert reg.snapshot() == jreg.snapshot()
    assert reg.prometheus_text() == jreg.prometheus_text()
    got, want = reg.rows(), jreg.rows()
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert reg.snapshot(prefix="t_custom") == jreg.snapshot(prefix="t_custom")
    with pytest.raises(ValueError):
        reg.gauge("t_total")


@pytest.mark.parametrize("seed", [0, 1])
def test_histogram_quantiles_match_reference(seed):
    rng = np.random.RandomState(seed)
    vals = rng.lognormal(-3, 2, size=500)
    h = HistogramSeries(DEFAULT_LATENCY_BUCKETS)
    jh = JHistogramSeries(DEFAULT_LATENCY_BUCKETS)
    for v in vals:
        h.observe(v)
        jh.observe(v)
    assert h.summary() == jh.summary()
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert h.quantile(q) == jh.quantile(q)
    assert math.isnan(HistogramSeries((1.0,)).quantile(0.5))


def _drive_recorder(rec):
    gate = {"on": True}
    rec.gate = lambda: gate["on"]
    seqs = [rec.emit("k.a", _ts=float(i), i=i, kind="x") for i in range(6)]
    gate["on"] = False
    seqs.append(rec.emit("k.b", _ts=9.0, i=99))
    gate["on"] = True
    seqs.append(rec.emit("k.b", _ts=10.0, i=7, ts="attr"))
    return seqs


def test_recorder_matches_reference(tmp_path):
    rec, jrec = FlightRecorder(capacity=4), JFlightRecorder(capacity=4)
    assert _drive_recorder(rec) == _drive_recorder(jrec)
    assert len(rec) == 4 and rec.dropped == jrec.dropped == 3
    assert rec.find(0) is None and rec.find(6)["attrs"]["i"] == 7
    assert rec.stream() == jrec.stream()
    assert rec.events("k.") == jrec.events("k.")
    assert rec.span_counts() == jrec.span_counts() == {"k.a": 3, "k.b": 1}
    path = tmp_path / "spans.jsonl"
    assert rec.to_jsonl(str(path)) == jrec.to_jsonl()
    assert [json.loads(ln)["seq"] for ln in path.read_text().splitlines()] \
        == [3, 4, 5, 6]
    twin = FlightRecorder(capacity=4)
    twin.load(jrec.state())
    assert twin.state() == rec.state()


@contextlib.contextmanager
def _left_as_found(*mods):
    """Each obs module's registry, flight recorder and gate as they were on
    entry: series made inside are dropped and the others restored, so a
    test of the module-level singletons leaves nothing that another test
    file, run later in the same process, reads."""
    saved = [(m, m.registry().snapshot(), m.recorder().state(), m.enabled())
             for m in mods]
    try:
        yield
    finally:
        for m, snap, rec, on in saved:
            reg = m.registry()
            for name in reg.names():
                kept = snap.get(name, {}).get("series", {})
                metric = reg.get(name)
                for key in list(metric.series()):
                    if json.dumps(key) not in kept:
                        metric.drop(**dict(key))
            reg.restore(snap)
            m.recorder().load(rec)
            m.set_enabled(on)


def test_module_api_matches_reference():
    """emit/observe/snapshot/restore of the module-level singletons, with
    the gate, against the reference's module.  The series is one that no
    reference test uses, and both modules are left as they were found."""
    out = []
    with _left_as_found(obs, jobs):
        for mod in (obs, jobs):
            mod.recorder().clear()
            with mod.obs_enabled(True):
                mod.observe("t_port_rt_seconds", 0.2, phase="x")
                seq = mod.emit("t.span", _ts=1.0, a=1)
                snap = mod.snapshot()
                mod.observe("t_port_rt_seconds", 0.9, phase="x")
            with mod.obs_enabled(False):
                assert mod.emit("t.off") == -1
                mod.observe("t_port_rt_seconds", 5.0, phase="x")
                assert not mod.enabled() and mod.enabled(True)
            mod.restore(snap)
            h = mod.registry().get("t_port_rt_seconds").labels(phase="x")
            out.append((seq, h.count,
                        mod.registry().snapshot(prefix="t_port_rt"),
                        mod.recorder().stream()))
            json.dumps(snap, default=str)
    assert out[0] == out[1]
    assert out[0][1] == 1
    for mod in (obs, jobs):
        assert not mod.registry().get("t_port_rt_seconds").series()


def test_obs_left_as_found_restores_a_reference_series():
    """The guard's own contract on the series the reference's
    ``test_obs_snapshot_roundtrips_registry_and_recorder`` reads: counts
    made inside are rewound, series made inside are gone, and the
    recorder's stream is back."""
    def seen():
        snap = jobs.registry().snapshot(prefix="t_rt_seconds")
        return ({k: v["series"] for k, v in snap.items() if v["series"]},
                jobs.recorder().stream())
    before = seen()
    with _left_as_found(jobs):
        with jobs.obs_enabled(True):
            jobs.observe("t_rt_seconds", 0.5, phase="x")
            jobs.observe("t_rt_seconds", 0.5, phase="y")
            jobs.emit("t.guard", a=1)
        assert seen() != before
    assert seen() == before


# ------------------------------------------------- attribute-API counters
def test_service_counters_attribute_api():
    svc = DecisionService(obs_name="t_api")
    svc.decisions += 5
    svc.retries += 2
    assert svc.decisions == 5 and svc.retries == 2
    st = svc.stats()
    assert st["decisions"] == 5 and st["retries"] == 2
    assert st["breaker_state"] == "closed"
    rows = obs.registry().rows(prefix="enel_service_decisions_total")
    assert any(r["labels"] == {"service": "t_api"} and r["value"] == 5
               for r in rows)


def test_breaker_mid_open_checkpoint_restores_state_and_labels():
    """Checkpoint while the breaker is OPEN -> restore into a fresh service
    with the same obs label: breaker state, counters AND registry series
    match the moment of the snapshot."""
    svc = DecisionService(obs_name="t_s6")
    for _ in range(svc.breaker.threshold):
        svc.breaker.record(False)
    svc.dispatch_failures += 4
    assert svc.breaker.state == CircuitBreaker.OPEN
    snap = svc.snapshot_state()
    trips0 = svc.breaker.trips

    twin = DecisionService(obs_name="t_s6")      # fresh, label-identical
    assert twin.breaker.state == CircuitBreaker.CLOSED
    twin.restore_state(snap)
    assert twin.breaker.state == CircuitBreaker.OPEN
    assert twin.breaker.trips == trips0
    assert twin.dispatch_failures == 4
    gauge = obs.registry().get("enel_breaker_state")
    assert gauge.labels(service="t_s6", state="open").value == 1.0
    assert gauge.labels(service="t_s6", state="closed").value == 0.0
    rows = obs.registry().rows(prefix="enel_breaker_trips_total")
    assert any(r["labels"] == {"service": "t_s6"} and r["value"] == trips0
               for r in rows)


# ------------------------------------------------------ causal links
@pytest.fixture(scope="module")
def kmeans():
    ex = JobExperiment("kmeans", seed=2, candidate_stride=4, device="cpu")
    ex.profile(2)
    return ex


def test_fallback_spans_link_to_cause(kmeans):
    """Every decision.fallback span names its cause and links to the
    causing span (dispatch fault, then breaker transition)."""
    rec = obs.recorder()
    rec.clear()
    svc = DecisionService(obs_name="t_cause", max_retries=0,
                          breaker_threshold=2, breaker_probe_after=1)

    def chaos():
        raise DispatchTimeout("injected")

    svc.fault_injector = chaos
    exp = kmeans
    builder = lambda ci, a, z, pr: _to_graph(
        _future_nodes(exp.encoder, exp.job, ci, a, z), pr, ci)
    req = exp.enel.prepare_request(
        graph_builder=builder, next_comp=1,
        n_components=exp.job.n_components, elapsed=10.0,
        current_scaleout=8, target_runtime=exp.target)
    with obs.obs_enabled(True):
        for _ in range(3):
            svc.decide([req])
    falls = rec.events("decision.fallback")
    assert [ev["attrs"]["cause"] for ev in falls] == \
        ["retries_exhausted", "retries_exhausted", "breaker_open"]
    for ev in falls:
        cause = rec.find(ev["attrs"]["cause_seq"])
        assert cause is not None and cause["seq"] < ev["seq"]
        assert cause["kind"] in ("dispatch.fault", "breaker.transition",
                                 "guardrail.trip")
    assert obs.registry().get("enel_breaker_trips_total").labels(
        service="t_cause").value == 1


def test_run_end_span_and_counters(kmeans):
    rec = obs.recorder()
    rec.clear()
    runs = obs.registry().counter("enel_runs_total").labels(
        job=kmeans.job.name, kind="enel")
    before = runs.value
    with obs.obs_enabled(True):
        st = kmeans.adaptive_run("enel", inject_failures=False)
    assert runs.value == before + 1
    end = rec.events("run.end")
    assert len(end) == 1 and end[0]["attrs"]["decide_calls"] == \
        st.decide_calls > 0
    counts = rec.span_counts()
    assert counts["decision.dispatch"] == st.decide_calls
    assert counts["fit"] == 1
    # the template cache's counters live in the registry too
    cache = kmeans.enel.template_cache
    assert st.cache_transfers + st.cache_skips > 0
    for attr in ("transfers", "skips", "evictions"):
        family = obs.registry().get(f"enel_template_cache_{attr}_total")
        series = cache._obs_counters[attr]
        assert any(x is series for x in family.series().values())
        assert getattr(cache, attr) == int(series.value)


# ------------------------------------------------------------ neutrality
def _kmeans_trace(enabled):
    """Profile, then two Enel runs of a seeded K-Means experiment with obs
    on or off: each decision's pick and totals, and the signatures
    recorded meanwhile."""
    before = dict(model.TRACE_COUNTS)
    decisions = []
    with obs.obs_enabled(enabled):
        ex = JobExperiment("kmeans", seed=5, candidate_stride=4,
                           device="cpu")
        inner = ex.service.decide

        def decide(requests):
            res = inner(requests)
            decisions.extend((r.scaleout, r.predicted, r.totals)
                             for r in res)
            return res
        ex.service.decide = decide
        ex.profile(2)
        runs = [ex.adaptive_run("enel", inject_failures=False)
                for _ in range(2)]
    delta = {k: v - before.get(k, 0) for k, v in model.TRACE_COUNTS.items()
             if v != before.get(k, 0)}
    return ([(st.scaleouts, st.runtime, st.violation) for st in runs],
            decisions, delta)


def test_disabled_obs_is_bit_exact_and_signature_neutral():
    runs_on, dec_on, _ = _kmeans_trace(True)
    seq = obs.recorder().state()["seq"]
    runs_off, dec_off, delta_off = _kmeans_trace(False)
    assert obs.recorder().state()["seq"] == seq  # nothing emitted when off
    runs_on2, dec_on2, delta_on2 = _kmeans_trace(True)
    assert len(dec_on) > 0
    assert runs_off == runs_on == runs_on2
    assert dec_off == dec_on == dec_on2          # picks and totals, exactly
    assert delta_off == delta_on2 == {}          # warmed: no new signature
