"""The paper's experiment protocol (§V-B) for one job, PyTorch port.

Per job: 10 profiling runs (no scaling) -> initial model fit -> adaptive
runs where the scaler is consulted at every component boundary.  Enel
retrains from scratch every 5th run and fine-tunes otherwise; Ellis refits
its per-component model ensemble after every run.

Counterpart of ``repro.dataflow.runner`` for a single job:
:class:`JobExperiment` (``calibrate_target``, ``profile``,
``adaptive_run``) over :func:`execute_run`, one run with Enel's
:meth:`EnelScaler.recommend` (or Ellis) at the component boundaries.
Decisions call ``recommend`` directly where the reference's experiment
yields them to its fleet ``DecisionService``; that service answers with
the same picks as sequential ``recommend`` (``tests/test_service.py``
holds it so), so the semantics are the same.  The service, fleet
campaigns, checkpoints and the batched simulator engine are not ported
yet.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional

import numpy as np

from repro_torch.core.ellis import EllisScaler
from repro_torch.core.graph import (ComponentGraph, NodeAttrs, build_graph,
                                    historical_summary, summary_node)
from repro_torch.core.scaling import EnelScaler
from repro_torch.core.training import EnelTrainer
from repro_torch.dataflow.context import ContextEncoder
from repro_torch.dataflow.simulator import (ClusterSim, ComponentRecord,
                                            RunRecord, rescale_overhead)
from repro_torch.dataflow.workloads import JOBS, SCALEOUT_RANGE, JobSpec
from repro_torch.device import DeviceLike
from repro_torch.sim.scenarios import BASELINE, Scenario

PROFILING_SCALEOUTS = [4, 8, 11, 14, 18, 21, 25, 28, 32, 36]
HISTORY_WINDOW = 96           # newest graphs kept for scratch retraining


@dataclass
class RunStats:
    run_idx: int
    kind: str                 # profiling | enel | ellis
    runtime: float
    target: float
    violation: float
    predicted: Optional[float] = None
    scaleouts: List[int] = field(default_factory=list)
    n_failures: int = 0
    n_rescales: int = 0
    fit_seconds: float = 0.0
    decide_seconds: float = 0.0
    decide_calls: int = 0
    # sweep-template device-cache traffic during this run
    cache_transfers: int = 0
    cache_skips: int = 0
    cache_evictions: int = 0
    # decisions answered by the model-free fallback during this run
    fallback_decisions: int = 0

    @property
    def cvc(self) -> int:
        return int(self.violation > 0)

    @property
    def decide_seconds_per_call(self) -> float:
        return self.decide_seconds / self.decide_calls if self.decide_calls \
            else 0.0


def _component_nodes(encoder: ContextEncoder, job: JobSpec,
                     comp: ComponentRecord) -> List[NodeAttrs]:
    nodes = []
    for st in comp.stages:
        ctx = encoder.node_context(job, st.name, int(st.end_scaleout * 4),
                                   attempt=st.failures)
        nodes.append(NodeAttrs(
            name=st.name, context=ctx, metrics=st.metrics,
            start_scaleout=st.start_scaleout, end_scaleout=st.end_scaleout,
            time_fraction=st.time_fraction, runtime=st.runtime,
            overhead=st.overhead if st.overhead > 0 else None))
    return nodes


def _future_nodes(encoder: ContextEncoder, job: JobSpec, comp_idx: int,
                  a: float, z: float) -> List[NodeAttrs]:
    nodes = []
    for i, spec in enumerate(job.stages(comp_idx)):
        ctx = encoder.node_context(job, spec.name, int(z * 4))
        nodes.append(NodeAttrs(
            name=spec.name, context=ctx, metrics=None,
            start_scaleout=a if i == 0 else z, end_scaleout=z,
            time_fraction=1.0 if a == z else 0.8))
    return nodes


def _to_graph(nodes: List[NodeAttrs], preds: List[NodeAttrs],
              comp_idx: int) -> ComponentGraph:
    n = len(nodes)
    all_nodes = nodes + preds
    edges = [(i, i + 1) for i in range(n - 1)]
    edges += [(n + j, 0) for j in range(len(preds))]
    return build_graph(all_nodes, edges, component_id=comp_idx)


@dataclass
class Decision:
    """One decision at a component boundary (Ellis decisions have no
    per-candidate totals)."""
    next_comp: int
    current: int
    elapsed: float
    pick: int
    predicted: float
    totals: Dict[int, float]
    seconds: float                # host wall time of the call (synced)


@dataclass
class RunResult:
    run: RunRecord
    scaleouts: List[int] = field(default_factory=list)
    decisions: List[Decision] = field(default_factory=list)
    graphs: List[ComponentGraph] = field(default_factory=list)


def execute_run(*, sim: ClusterSim, encoder: ContextEncoder, job: JobSpec,
                scaler: EnelScaler, initial_s: int, inject_failures: bool,
                target: Optional[float] = None, decision_interval: int = 1,
                ellis: Optional[EllisScaler] = None,
                method: str = "enel") -> RunResult:
    """One run of ``job`` starting at ``initial_s`` executors.

    Every component's observed nodes go to ``scaler.record_component`` (and
    its scale-out and runtime to ``ellis``, when given), and its observed
    graph, with the P/H summary predecessors, to ``RunResult.graphs``.
    With a ``target`` the ``method`` scaler picks the scale-out at every
    ``decision_interval``-th boundary: ``scaler.recommend`` for "enel"
    (the builder of the reference runner: future nodes at (a, z) with the
    P/H summary predecessors), ``ellis.recommend`` for "ellis".  Without a
    target the run keeps ``initial_s`` (a profiling run).
    """
    run = RunRecord(job.name, target or 0.0)
    result = RunResult(run, scaleouts=[initial_s])
    sim.begin_run()
    clock = 0.0
    s_prev = s = initial_s
    n_comp = job.n_components
    prev_summary: Optional[NodeAttrs] = None
    builder = lambda ci, a, z, pr: _to_graph(
        _future_nodes(encoder, job, ci, a, z), pr, ci)
    for k in range(n_comp):
        failures: List[float] = []
        comp = sim.run_component(
            job, k, clock=clock, start_scaleout=s_prev, end_scaleout=s,
            inject_failures=inject_failures or sim.scenario.inject_failures,
            failures_log=failures)
        run.components.append(comp)
        run.failures.extend(failures)
        last = comp.stages[-1]
        clock = float(last.start + last.runtime)
        nodes = _component_nodes(encoder, job, comp)
        preds = [p for p in (prev_summary,) if p is not None]
        if k > 0:
            h = historical_summary(scaler.hist_summaries.get(k - 1, []),
                                   float(s))
            if h is not None:
                preds.append(h)
        result.graphs.append(_to_graph(nodes, preds, k))
        # record after building this graph (history = previous runs only)
        scaler.record_component(k, nodes, comp.runtime)
        if ellis is not None:
            ellis.observe_component(k, comp.scaleout, comp.runtime)
        prev_summary = summary_node(nodes, name=f"P{k}")
        s_prev = s
        if target is None or k >= n_comp - 1 or k % decision_interval:
            continue
        t0 = time.perf_counter()
        if method == "enel":
            s_new, predicted, totals = scaler.recommend(
                graph_builder=builder, next_comp=k + 1, n_components=n_comp,
                elapsed=clock, current_scaleout=s, target_runtime=target,
                current_summary=prev_summary)
        else:
            s_new, predicted = ellis.recommend(
                next_comp=k + 1, n_components=n_comp, elapsed=clock,
                current_scaleout=s, target_runtime=target)
            totals = {}
        result.decisions.append(Decision(
            next_comp=k + 1, current=s, elapsed=clock, pick=s_new,
            predicted=predicted, totals=totals,
            seconds=time.perf_counter() - t0))
        if s_new != s:
            run.rescales.append((k + 1, s, s_new))
            s = s_new
            result.scaleouts.append(s)
    return result


class JobExperiment:
    """Shared environment for one job: simulator, encoder, both scalers.

    ``scenario`` injects seeded disturbances; ``ae_params`` (the context
    encoder's auto-encoder weights, numpy) skip the encoder's own fit;
    ``chaos`` may hold a :class:`~repro_torch.sim.chaos.ChaosInjector`.
    """

    def __init__(self, job_key: str, seed: int = 0,
                 candidate_stride: int = 2, *, device: DeviceLike = "cuda",
                 scenario: Optional[Scenario] = None,
                 ae_params: Optional[Mapping] = None):
        self.job = JOBS[job_key]
        self.job_key = job_key
        self.seed = seed
        self.scenario = scenario or BASELINE
        self.sim = ClusterSim(seed=seed, scenario=self.scenario)
        self.encoder = ContextEncoder([self.job], seed=seed, device=device,
                                      ae_params=ae_params)
        self.trainer = EnelTrainer(seed=seed, cache_capacity=HISTORY_WINDOW,
                                   device=device)
        self.enel = EnelScaler(self.trainer, SCALEOUT_RANGE,
                               candidate_stride=candidate_stride)
        self.ellis = EllisScaler(SCALEOUT_RANGE,
                                 rescale_overhead=rescale_overhead(4, 8),
                                 candidate_stride=candidate_stride)
        # decision cadence: every component for short jobs, every 2nd for
        # the 22-component LR/MPC
        self.decision_interval = 2 if self.job.n_components > 15 else 1
        self.chaos = None            # optional per-experiment fault injector
        self.graph_history: List[ComponentGraph] = []
        self.target: Optional[float] = None
        self.stats: List[RunStats] = []
        self._run_idx = 0

    def _execute(self, *, method: Optional[str], inject_failures: bool,
                 initial_s: int) -> RunResult:
        """One run, decided by ``method`` ("enel", "ellis") or by nobody
        (a profiling run)."""
        return execute_run(
            sim=self.sim, encoder=self.encoder, job=self.job,
            scaler=self.enel, initial_s=initial_s,
            inject_failures=inject_failures,
            target=self.target if method else None,
            decision_interval=self.decision_interval, ellis=self.ellis,
            method=method or "enel")

    # ------------------------------------------------------------ profiling
    def calibrate_target(self, n_runs: int = 10) -> None:
        """Profiling runs without a model fit: sets the runtime target and
        fits Ellis, feeding the observation history."""
        for i in range(n_runs):
            s = PROFILING_SCALEOUTS[i % len(PROFILING_SCALEOUTS)]
            res = self._execute(method=None, inject_failures=False,
                                initial_s=s)
            self.graph_history.extend(res.graphs)
            self.trainer.extend_history(res.graphs)
            self._run_idx += 1
            self.stats.append(RunStats(self._run_idx, "profiling",
                                       res.run.runtime, 0.0, 0.0,
                                       scaleouts=res.scaleouts))
        runtimes = [st.runtime for st in self.stats if st.kind == "profiling"]
        # target: slightly under the median profiled runtime, so meeting it
        # requires actively choosing good scale-outs (cf. §V-B.3)
        self.target = float(np.median(runtimes) * 0.95)
        for st in self.stats:
            st.target = self.target
            st.violation = max(0.0, st.runtime - self.target)
        self.ellis.refit()

    def profile(self, n_runs: int = 10) -> None:
        """Profiling runs, then the initial scratch fit on the ring."""
        self.calibrate_target(n_runs)
        self.trainer.fit_resident(steps=160, from_scratch=True)

    # -------------------------------------------------------------- adaptive
    def adaptive_run(self, method: str, inject_failures: bool) -> RunStats:
        """One adaptive run with ``method`` ("enel" or "ellis") deciding,
        then the method's refit (Enel's cadence fit on the ring)."""
        assert self.target is not None, "profile() first"
        if method not in ("enel", "ellis"):
            raise ValueError(f"unknown method {method!r}")
        job = self.job
        cache = self.enel.template_cache
        cache0 = (cache.transfers, cache.skips, cache.evictions)
        fallback0 = self.enel.fallback_decisions
        # fair initial allocation for both methods (paper §V-B.3): Ellis'
        # per-component models pick the cheapest compliant scale-out
        s0, predicted = self.ellis.recommend(
            next_comp=0, n_components=job.n_components, elapsed=0.0,
            current_scaleout=SCALEOUT_RANGE[0], target_runtime=self.target)
        res = self._execute(method=method, inject_failures=inject_failures,
                            initial_s=s0)
        run, graphs = res.run, res.graphs
        if self.chaos is not None:
            # poisoned observations enter the pipeline here, upstream of
            # the cache quarantine
            graphs = self.chaos.poison_graphs(graphs, self._run_idx)
        self.graph_history.extend(graphs)
        # keep the resident ring in sync for both methods so a later Enel
        # scratch retrain sees the full history window
        self.trainer.extend_history(graphs)
        self._run_idx += 1
        fit_s = 0.0
        if method == "enel":
            t0 = time.perf_counter()
            self.trainer.observe_run_resident(
                retrain_every=5, steps=160, fine_tune_steps=60)
            fit_s = time.perf_counter() - t0
            if self.chaos is not None:
                self.chaos.after_fit(self.trainer, self._run_idx)
        else:
            self.ellis.refit()
        st = RunStats(self._run_idx, method, run.runtime, self.target,
                      run.violation, predicted=predicted,
                      scaleouts=res.scaleouts, n_failures=len(run.failures),
                      n_rescales=len(run.rescales), fit_seconds=fit_s,
                      decide_seconds=sum(d.seconds for d in res.decisions),
                      decide_calls=len(res.decisions),
                      cache_transfers=cache.transfers - cache0[0],
                      cache_skips=cache.skips - cache0[1],
                      cache_evictions=cache.evictions - cache0[2],
                      fallback_decisions=self.enel.fallback_decisions -
                      fallback0)
        self.stats.append(st)
        return st
