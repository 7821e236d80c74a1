"""Run helpers of the paper's experiment protocol (§V-B), PyTorch port.

Counterpart of the graph helpers of ``repro.dataflow.runner``
(``_component_nodes``, ``_future_nodes``, ``_to_graph``) plus
:func:`execute_run`, which drives one run of a job through the simulator
with :meth:`EnelScaler.recommend` at the component boundaries — the
single-job decision loop of ``JobExperiment._execute_gen`` with the scaler
called directly.  ``JobExperiment`` itself (fleet service, model fits,
Ellis) comes with the parts of the port it needs.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.core.graph import (ComponentGraph, NodeAttrs, build_graph,
                                    summary_node)
from repro_torch.core.scaling import EnelScaler
from repro_torch.dataflow.context import ContextEncoder
from repro_torch.dataflow.simulator import (ClusterSim, ComponentRecord,
                                            RunRecord)
from repro_torch.dataflow.workloads import JobSpec

PROFILING_SCALEOUTS = [4, 8, 11, 14, 18, 21, 25, 28, 32, 36]


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
    """One ``recommend`` call at a component boundary."""
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


def execute_run(*, sim: ClusterSim, encoder: ContextEncoder, job: JobSpec,
                scaler: EnelScaler, initial_s: int, inject_failures: bool,
                target: Optional[float] = None,
                decision_interval: int = 1) -> RunResult:
    """One run of ``job`` starting at ``initial_s`` executors.

    Every component's observed nodes go to ``scaler.record_component``.
    With a ``target``, ``scaler.recommend`` picks the scale-out at every
    ``decision_interval``-th boundary (the builder of the reference runner:
    future nodes at (a, z) with the P/H summary predecessors); without one
    the run keeps ``initial_s`` (a profiling run).
    """
    run = RunRecord(job.name, target or 0.0)
    result = RunResult(run, scaleouts=[initial_s])
    sim.begin_run()
    clock = 0.0
    s_prev = s = initial_s
    n_comp = job.n_components
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
        scaler.record_component(k, nodes, comp.runtime)
        prev_summary = summary_node(nodes, name=f"P{k}")
        s_prev = s
        if target is None or k >= n_comp - 1 or k % decision_interval:
            continue
        t0 = time.perf_counter()
        s_new, predicted, totals = scaler.recommend(
            graph_builder=builder, next_comp=k + 1, n_components=n_comp,
            elapsed=clock, current_scaleout=s, target_runtime=target,
            current_summary=prev_summary)
        result.decisions.append(Decision(
            next_comp=k + 1, current=s, elapsed=clock, pick=s_new,
            predicted=predicted, totals=totals,
            seconds=time.perf_counter() - t0))
        if s_new != s:
            run.rescales.append((k + 1, s, s_new))
            s = s_new
            result.scaleouts.append(s)
    return result
