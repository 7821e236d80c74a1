"""The paper's experiment protocol (§V-B) for one job, PyTorch port.

Per job: 10 profiling runs (no scaling) -> initial model fit -> adaptive
runs where the scaler is consulted at every component boundary.  Enel
retrains from scratch every 5th run and fine-tunes otherwise; Ellis refits
its per-component model ensemble after every run.

Counterpart of ``repro.dataflow.runner``.  As there, the execution loop of
:class:`JobExperiment` is a generator that YIELDS two kinds of requests and
resumes with their results:

* :class:`~repro_torch.sim.engine.SimStepRequest` — the next component's
  simulated execution, answered by a sim backend: the per-job numpy event
  loop (:class:`~repro_torch.sim.engine.NumpySimBackend`,
  ``engine="numpy"``) or the vectorized fleet engine
  (:class:`~repro_torch.sim.engine.BatchedClusterSim`, ``engine="batched"``,
  one ``sim_step`` launch per step on the experiment's device);
* :class:`~repro_torch.core.service.DecisionRequest` — the pending Enel
  rescaling decision, answered by a
  :class:`~repro_torch.core.service.DecisionService` (shape-bucketed,
  sparse-edge engine, guardrail, retry and breaker envelope; cross-job
  batched under a fleet campaign, ``repro_torch.dataflow.fleet``).

:func:`run_gen` is that loop for one run; its ``decide`` callback turns a
:class:`DecisionPoint` into a :class:`Decision`.  :func:`drive` runs such a
generator to its end.  :func:`execute_run` drives one run whose decisions
ask ``EnelScaler.recommend`` directly (the dense sweep through the
``graph_prop`` kernel) and records every one.

Disturbance scenarios (``repro_torch.sim.scenarios``) and dataset-size
scaling (``size_scale``) parameterize the execution context;
``share_models_from`` transplants a trained model into a new context.
``JobExperiment.snapshot_state`` / ``restore_state`` are the campaign
checkpoints' per-job state.
"""
from __future__ import annotations

import copy
import time
from collections import defaultdict
from dataclasses import dataclass, field
from functools import partial
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.core.ellis import EllisScaler
from repro_torch.core.graph import (ComponentGraph, NodeAttrs, build_graph,
                                    historical_summary, summary_node)
from repro_torch.core.scaling import EnelScaler
from repro_torch.core.service import DecisionService
from repro_torch.core.training import EnelTrainer
from repro_torch.dataflow.context import ContextEncoder
from repro_torch.dataflow.simulator import (ClusterSim, ComponentRecord,
                                            RunRecord, rescale_overhead)
from repro_torch.dataflow.workloads import (JOBS, SCALEOUT_RANGE, JobSpec,
                                            scale_job)
from repro_torch.device import DeviceLike
from repro_torch.sim.engine import (BatchedClusterSim, NumpySimBackend,
                                    SimStepRequest)
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
    # fault-tolerance counters: decisions answered by the model-free
    # fallback / shed under overload during this run, plus this run's share
    # of service-wide dispatch retries and breaker trips (deltas over the
    # run)
    fallback_decisions: int = 0
    shed_requests: int = 0
    retries: int = 0
    breaker_trips: int = 0

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


def frozen_context_tables(encoder: ContextEncoder, job: JobSpec
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic node-context tables for the fused campaign planner.

    Returns ``(ctx (C, S_max, NS, CTX_DIM) f32, n_stages (C,) int32)`` with
    NS spanning the whole scale-out grid (``SCALEOUT_RANGE[0]..[1]``): entry
    ``[c, i, s - lo]`` is component c / stage i's context at scale-out s.
    Built with ``drop_versions=False`` so no encoder rng is consumed (the
    fused campaign freezes contexts at plan time; ``attempt`` is frozen at
    0).  The embed cache makes repeat lookups cheap.
    """
    lo, hi = SCALEOUT_RANGE
    grid = np.arange(lo, hi + 1)
    n_comp = job.n_components
    s_max = max(len(job.stages(c)) for c in range(n_comp))
    ctx = np.zeros((n_comp, s_max, len(grid), 24), np.float32)
    n_stages = np.zeros(n_comp, np.int32)
    for c in range(n_comp):
        specs = job.stages(c)
        n_stages[c] = len(specs)
        for i, spec in enumerate(specs):
            for si, s in enumerate(grid):
                ctx[c, i, si] = encoder.node_context(
                    job, spec.name, int(s * 4), drop_versions=False)
    return ctx, n_stages


def _to_graph(nodes: List[NodeAttrs], preds: List[NodeAttrs],
              comp_idx: int) -> ComponentGraph:
    n = len(nodes)
    all_nodes = nodes + preds
    edges = [(i, i + 1) for i in range(n - 1)]
    edges += [(n + j, 0) for j in range(len(preds))]
    return build_graph(all_nodes, edges, component_id=comp_idx)


def drive(gen, service: Optional[DecisionService], backend):
    """Run an execution generator to completion, answering each yielded
    :class:`SimStepRequest` with the backend's component record and each
    :class:`~repro_torch.core.service.DecisionRequest` with the service's
    decision."""
    try:
        req = next(gen)
        while True:
            if isinstance(req, SimStepRequest):
                req = gen.send(backend.step([req])[0])
            else:
                req = gen.send(service.decide([req])[0])
    except StopIteration as stop:
        return stop.value


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
    seconds: float                # host wall time of the decision
    fallback: bool = False        # answered by the model-free fallback
    shed: bool = False            # shed under overload


@dataclass
class DecisionPoint:
    """A pending decision at a component boundary, as the run hands it to
    its ``decide`` callback."""
    next_comp: int
    n_components: int
    elapsed: float
    current: int
    target: float
    current_summary: NodeAttrs
    graph_builder: Callable

    def ellis_kwargs(self) -> dict:
        return dict(next_comp=self.next_comp, n_components=self.n_components,
                    elapsed=self.elapsed, current_scaleout=self.current,
                    target_runtime=self.target)

    def enel_kwargs(self) -> dict:
        """Keywords of ``EnelScaler.recommend`` and ``prepare_request``."""
        return dict(self.ellis_kwargs(), graph_builder=self.graph_builder,
                    current_summary=self.current_summary)

    def decision(self, pick: int, predicted: float,
                 totals: Dict[int, float], seconds: float,
                 **flags) -> Decision:
        return Decision(next_comp=self.next_comp, current=self.current,
                        elapsed=self.elapsed, pick=pick, predicted=predicted,
                        totals=totals, seconds=seconds, **flags)


@dataclass
class RunResult:
    run: RunRecord
    scaleouts: List[int] = field(default_factory=list)
    decisions: List[Decision] = field(default_factory=list)
    graphs: List[ComponentGraph] = field(default_factory=list)


def run_gen(*, backend, slot: int, encoder: ContextEncoder, job: JobSpec,
            scaler: EnelScaler, initial_s: int, inject_failures: bool,
            target: Optional[float] = None, decision_interval: int = 1,
            ellis: Optional[EllisScaler] = None,
            decide: Optional[Callable] = None):
    """Generator form of one run of ``job`` starting at ``initial_s``
    executors on the backend's ``slot``; returns its :class:`RunResult`.

    Every component is yielded as a :class:`SimStepRequest` and resumes
    with its :class:`~repro_torch.sim.engine.SimStepResult`.  Its observed
    nodes go to ``scaler.record_component`` (and its scale-out and runtime
    to ``ellis``, when given), and its observed graph, with the P/H summary
    predecessors, to ``RunResult.graphs``.  With a ``target`` and a
    ``decide`` callback, every ``decision_interval``-th boundary becomes a
    :class:`DecisionPoint`; ``yield from decide(point)`` answers it with a
    :class:`Decision` (yielding whatever requests it needs on the way).
    Without them the run keeps ``initial_s`` (a profiling run).
    """
    run = RunRecord(job.name, target or 0.0)
    result = RunResult(run, scaleouts=[initial_s])
    backend.begin_run(slot)
    clock = 0.0
    s_prev = s = initial_s
    n_comp = job.n_components
    prev_summary: Optional[NodeAttrs] = None
    builder = lambda ci, a, z, pr: _to_graph(
        _future_nodes(encoder, job, ci, a, z), pr, ci)
    for k in range(n_comp):
        step = yield SimStepRequest(
            slot=slot, comp_idx=k, start_scaleout=s_prev, end_scaleout=s,
            clock=clock, inject_failures=inject_failures)
        comp = step.component
        run.components.append(comp)
        run.failures.extend(step.failures)
        clock = step.clock_end
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
        if target is None or decide is None or k >= n_comp - 1 or \
                k % decision_interval:
            continue
        d = yield from decide(DecisionPoint(
            next_comp=k + 1, n_components=n_comp, elapsed=clock, current=s,
            target=target, current_summary=prev_summary,
            graph_builder=builder))
        result.decisions.append(d)
        if d.pick != s:
            run.rescales.append((k + 1, s, d.pick))
            s = d.pick
            result.scaleouts.append(s)
    return result


def _recommend_gen(point: DecisionPoint, *, scaler: EnelScaler,
                   ellis: Optional[EllisScaler], method: str):
    """Answer a decision point in place with ``scaler.recommend`` (the
    dense sweep through the ``graph_prop`` kernel) or ``ellis.recommend``;
    a generator that never suspends the run."""
    t0 = time.perf_counter()
    if method == "enel":
        pick, predicted, totals = scaler.recommend(**point.enel_kwargs())
    else:
        pick, predicted = ellis.recommend(**point.ellis_kwargs())
        totals = {}
    return point.decision(pick, predicted, totals, time.perf_counter() - t0)
    yield  # unreachable: marks this function as a generator


def execute_run(*, sim: ClusterSim, encoder: ContextEncoder, job: JobSpec,
                scaler: EnelScaler, initial_s: int, inject_failures: bool,
                target: Optional[float] = None, decision_interval: int = 1,
                ellis: Optional[EllisScaler] = None,
                method: str = "enel") -> RunResult:
    """One run of :func:`run_gen` on ``sim``, decided without a service:
    with a ``target`` the ``method`` scaler picks the scale-out, through
    ``scaler.recommend`` for "enel" (the builder of the reference runner:
    future nodes at (a, z) with the P/H summary predecessors) or
    ``ellis.recommend`` for "ellis".  Without a target the run keeps
    ``initial_s`` (a profiling run).
    """
    backend = NumpySimBackend()
    decide = None if target is None else partial(
        _recommend_gen, scaler=scaler, ellis=ellis, method=method)
    return drive(run_gen(backend=backend, slot=backend.adopt(sim, job),
                         encoder=encoder, job=job, scaler=scaler,
                         initial_s=initial_s,
                         inject_failures=inject_failures, target=target,
                         decision_interval=decision_interval, ellis=ellis,
                         decide=decide), None, backend)


class JobExperiment:
    """Shared environment for one job: simulator, encoder, both scalers and
    the decision service.

    ``service`` answers Enel's decisions (a fresh
    :class:`~repro_torch.core.service.DecisionService` by default; several
    experiments may share one, as a fleet campaign's do); ``backend`` runs
    the simulated components: by default a
    :class:`~repro_torch.sim.engine.NumpySimBackend` adopting this
    experiment's simulator (``engine="numpy"``) or a
    :class:`~repro_torch.sim.engine.BatchedClusterSim` on ``device`` with
    this job registered (``engine="batched"``; bit-identical, and batched
    across jobs when a shared ``backend`` is passed, as a fleet campaign
    does).  ``scenario`` injects seeded
    disturbances; ``size_scale`` scales the dataset (cross-context axis);
    ``share_models_from`` reuses another experiment's trained model,
    encoder and scalers instead of fresh ones (transfer deployment; the
    source experiment should be done running).  ``ae_params`` (the context
    encoder's auto-encoder weights, numpy) skip the encoder's own fit;
    ``chaos`` may hold a :class:`~repro_torch.sim.chaos.ChaosInjector`.
    """

    def __init__(self, job_key: str, seed: int = 0,
                 candidate_stride: int = 2, *, device: DeviceLike = "cuda",
                 service: Optional[DecisionService] = None,
                 engine: str = "numpy",
                 scenario: Optional[Scenario] = None, backend=None,
                 size_scale: float = 1.0,
                 share_models_from: Optional["JobExperiment"] = None,
                 ae_params: Optional[Mapping] = None):
        if engine not in ("numpy", "batched"):
            raise ValueError(f"unknown engine {engine!r}")
        job = JOBS[job_key]
        if size_scale != 1.0:
            job = scale_job(job, size_scale)
        self.job = job
        self.job_key = job_key
        self.seed = seed
        self.scenario = scenario or BASELINE
        self.engine = engine
        self.sim = ClusterSim(seed=seed, scenario=self.scenario)
        if backend is not None:
            self.backend = backend
        elif engine == "batched":
            self.backend = BatchedClusterSim(device=device)
        else:
            self.backend = NumpySimBackend()
        if isinstance(self.backend, NumpySimBackend):
            self.sim_slot = self.backend.adopt(self.sim, self.job)
        else:
            self.sim_slot = self.backend.register(self.job, seed,
                                                  self.scenario)
        if share_models_from is not None:
            src = share_models_from
            self.encoder = src.encoder
            self.trainer = src.trainer
            self.enel = src.enel
            self.ellis = src.ellis
        else:
            self.encoder = ContextEncoder([self.job], seed=seed,
                                          device=device, ae_params=ae_params)
            self.trainer = EnelTrainer(seed=seed,
                                       cache_capacity=HISTORY_WINDOW,
                                       device=device)
            self.enel = EnelScaler(self.trainer, SCALEOUT_RANGE,
                                   candidate_stride=candidate_stride)
            self.ellis = EllisScaler(SCALEOUT_RANGE,
                                     rescale_overhead=rescale_overhead(4, 8),
                                     candidate_stride=candidate_stride)
        self.service = service or DecisionService()
        # decision cadence: every component for short jobs, every 2nd for
        # the 22-component LR/MPC
        self.decision_interval = 2 if self.job.n_components > 15 else 1
        self.scale_cap: Optional[int] = None   # multi-tenant capacity cap
        self.best_effort = False     # shed first under service overload
        self.chaos = None            # optional per-experiment fault injector
        self.graph_history: List[ComponentGraph] = []
        self.target: Optional[float] = None
        self.stats: List[RunStats] = []
        self._run_idx = 0

    # ----------------------------------------------------------- checkpoint
    def snapshot_state(self) -> Dict:
        """Everything a trace-identical resume needs: learned state (model
        params, optimizer moments, the ring, observation histories), the
        sim slot's rng/clock state and the bookkeeping counters, all on the
        host.  Perf-only caches (sweep templates, memoized stacks) are
        skipped; they repopulate deterministically.  Graph/summary lists
        hold append-only immutable records, so shallow list copies
        suffice."""
        return {
            "run_idx": int(self._run_idx),
            "target": self.target,
            "scale_cap": self.scale_cap,
            "best_effort": bool(self.best_effort),
            "stats": copy.deepcopy(self.stats),
            "graph_history": list(self.graph_history),
            # node_context draws the encoder's rng per call (the random
            # version dropout of the v group), so replay must re-draw the
            # same stream
            "encoder_rng": self.encoder.rng.get_state(),
            "trainer": self.trainer.snapshot_state(),
            "enel": {
                "hist_summaries": {k: list(v) for k, v in
                                   self.enel.hist_summaries.items()},
                "first_component_history":
                    list(self.enel.first_component_history),
                "fallback_decisions": int(self.enel.fallback_decisions),
                # not perf-only: a probe-cache miss makes the sweep call the
                # graph builder twice more, drawing encoder rng; the
                # hit/miss pattern must replay exactly (entries are
                # immutable tuples, a shallow dict copy suffices)
                "probe_cache": dict(self.enel._probe_cache),
            },
            "ellis_history": {k: list(v) for k, v in
                              self.ellis.history.items()},
            # fitted models are snapshotted, not refit on restore: under
            # method="enel" they are stale relative to the growing history
            # (last fit at profile time), and a refit would move the s0
            # recommendation off the uninterrupted trace
            "ellis_models": copy.deepcopy(self.ellis.models),
            "backend": self.backend.slot_state(self.sim_slot),
        }

    def restore_state(self, state: Dict) -> None:
        """Inverse of :meth:`snapshot_state`; the snapshot itself is left
        pristine (fresh copies are handed out, the model's tensors are new),
        so one checkpoint can be restored any number of times."""
        self._run_idx = int(state["run_idx"])
        self.target = state["target"]
        self.scale_cap = state["scale_cap"]
        self.best_effort = bool(state["best_effort"])
        self.stats = copy.deepcopy(state["stats"])
        self.graph_history = list(state["graph_history"])
        self.encoder.rng.set_state(state["encoder_rng"])
        self.trainer.restore_state(state["trainer"])
        self.enel.hist_summaries = defaultdict(
            list, {k: list(v) for k, v in
                   state["enel"]["hist_summaries"].items()})
        self.enel.first_component_history = \
            list(state["enel"]["first_component_history"])
        self.enel.fallback_decisions = \
            int(state["enel"]["fallback_decisions"])
        self.enel._probe_cache = dict(state["enel"]["probe_cache"])
        self.ellis.history = defaultdict(
            list, {k: list(v) for k, v in state["ellis_history"].items()})
        self.ellis.models = copy.deepcopy(state["ellis_models"])
        self.backend.restore_slot(self.sim_slot, state["backend"])

    # ------------------------------------------------------------ execution
    def _decide_gen(self, point: DecisionPoint, *, method: str):
        """Answer one decision point: Ellis in place, Enel through the
        service (yields the ``DecisionRequest``, resumes with its result).
        Decision latency = this job's local work + its share of the service
        call (``service_seconds``); the suspended yield is not billed."""
        t0 = time.perf_counter()
        if method == "ellis":
            pick, predicted = self.ellis.recommend(**point.ellis_kwargs())
            return point.decision(pick, predicted, {},
                                  time.perf_counter() - t0)
        req = self.enel.prepare_request(**point.enel_kwargs(),
                                        best_effort=self.best_effort)
        local = time.perf_counter() - t0
        result = yield req
        t0 = time.perf_counter()
        pick, predicted, totals = self.enel.apply_decision(req, result)
        local += time.perf_counter() - t0
        return point.decision(pick, predicted, totals,
                              local + result.service_seconds,
                              fallback=result.fallback, shed=result.shed)

    def _execute_gen(self, *, method: Optional[str], inject_failures: bool,
                     initial_s: int):
        """One run as a generator, decided by ``method`` ("enel", "ellis")
        or by nobody (a profiling run)."""
        return run_gen(
            backend=self.backend, slot=self.sim_slot, encoder=self.encoder,
            job=self.job, scaler=self.enel, initial_s=initial_s,
            inject_failures=inject_failures,
            target=self.target if method else None,
            decision_interval=self.decision_interval, ellis=self.ellis,
            decide=partial(self._decide_gen, method=method) if method
            else None)

    def _execute(self, *, method: Optional[str], inject_failures: bool,
                 initial_s: int) -> RunResult:
        return drive(self._execute_gen(method=method,
                                       inject_failures=inject_failures,
                                       initial_s=initial_s), self.service,
                     self.backend)

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
        return drive(self.adaptive_run_gen(method, inject_failures),
                     self.service, self.backend)

    def adaptive_run_gen(self, method: str, inject_failures: bool):
        """Generator form of :meth:`adaptive_run`."""
        assert self.target is not None, "profile() first"
        if method not in ("enel", "ellis"):
            raise ValueError(f"unknown method {method!r}")
        job = self.job
        cache = self.enel.template_cache
        cache0 = (cache.transfers, cache.skips, cache.evictions)
        # retry/breaker deltas are service-wide (one envelope may serve a
        # fleet); per-run rows report the delta observed over the run
        svc0 = (self.service.retries, self.service.breaker_trips)
        # fair initial allocation for both methods (paper §V-B.3): Ellis'
        # per-component models pick the cheapest compliant scale-out
        s0, predicted = self.ellis.recommend(
            next_comp=0, n_components=job.n_components, elapsed=0.0,
            current_scaleout=SCALEOUT_RANGE[0], target_runtime=self.target)
        if self.scale_cap is not None:      # multi-tenant admission headroom
            s0 = max(SCALEOUT_RANGE[0], min(s0, int(self.scale_cap)))
        res = yield from self._execute_gen(
            method=method, inject_failures=inject_failures, initial_s=s0)
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
                      fallback_decisions=sum(d.fallback
                                             for d in res.decisions),
                      shed_requests=sum(d.shed for d in res.decisions),
                      retries=self.service.retries - svc0[0],
                      breaker_trips=self.service.breaker_trips - svc0[1])
        self.stats.append(st)
        if obs.enabled():
            reg = obs.registry()
            labels = {"job": job.name, "kind": method}
            reg.counter("enel_runs_total",
                        "adaptive runs completed").labels(**labels).inc()
            if run.violation > 0:
                reg.counter("enel_run_violations_total",
                            "runs exceeding target").labels(**labels).inc()
            obs.emit("run.end", driver="stepped", job=job.name,
                     run=st.run_idx, kind=method,
                     runtime=round(st.runtime, 6),
                     target=round(st.target, 6),
                     violation=round(st.violation, 6),
                     rescales=st.n_rescales, failures=st.n_failures,
                     fallbacks=st.fallback_decisions,
                     shed=st.shed_requests, retries=st.retries,
                     breaker_trips=st.breaker_trips,
                     fit_seconds=round(st.fit_seconds, 6),
                     decide_seconds=round(st.decide_seconds, 6),
                     decide_calls=st.decide_calls)
        return st


def window_stats(stats: List[RunStats], lo: int, hi: int) -> Dict[str, float]:
    """CVC/CVS aggregates over adaptive runs lo..hi (1-based, inclusive)."""
    sel = [s for s in stats if s.kind != "profiling" and lo <= s.run_idx <= hi]
    if not sel:
        return {"cvc_mean": float("nan"), "cvc_median": float("nan"),
                "cvs_mean": float("nan"), "cvs_median": float("nan")}
    cvc = np.array([s.cvc for s in sel], float)
    cvs = np.array([s.violation / 60.0 for s in sel], float)   # minutes
    return {"cvc_mean": float(cvc.mean()), "cvc_median": float(np.median(cvc)),
            "cvs_mean": float(cvs.mean()), "cvs_median": float(np.median(cvs)),
            "n": len(sel)}
