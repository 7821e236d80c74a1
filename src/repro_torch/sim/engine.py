"""The runner's simulation-backend protocol.

The experiment runner's execution generator *yields* its pending component
step as a :class:`SimStepRequest` and resumes with a :class:`SimStepResult`
from a sim backend, so a driver could batch every concurrent job's step.
:class:`NumpySimBackend` answers each request through the per-job
:class:`~repro_torch.dataflow.simulator.ClusterSim` event loop.

Counterpart of the protocol part of ``repro.sim.engine``; the vectorized
``BatchedClusterSim``, ``register`` (for fleets) and the checkpoint hooks
(``slot_state`` / ``restore_slot``) are not ported.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

from repro_torch.dataflow.simulator import ClusterSim, ComponentRecord
from repro_torch.dataflow.workloads import JobSpec


@dataclass
class SimStepRequest:
    """One job's pending component execution, yielded by the runner's
    execution generator and answered by a sim backend."""
    slot: int
    comp_idx: int
    start_scaleout: int
    end_scaleout: int
    clock: float
    inject_failures: bool


@dataclass
class SimStepResult:
    component: ComponentRecord
    failures: List[float]          # kill seconds observed in this component
    clock_end: float


class NumpySimBackend:
    """Per-job event-loop backend: each request runs through its
    :class:`ClusterSim` sequentially."""

    def __init__(self):
        self._slots: List[Tuple[ClusterSim, JobSpec]] = []

    def adopt(self, sim: ClusterSim, job: JobSpec) -> int:
        self._slots.append((sim, job))
        return len(self._slots) - 1

    def begin_run(self, slot: int) -> None:
        self._slots[slot][0].begin_run()

    def step(self, requests: Sequence[SimStepRequest]
             ) -> List[SimStepResult]:
        results = []
        for req in requests:
            sim, job = self._slots[req.slot]
            failures: List[float] = []
            comp = sim.run_component(
                job, req.comp_idx, clock=req.clock,
                start_scaleout=req.start_scaleout,
                end_scaleout=req.end_scaleout,
                inject_failures=req.inject_failures or
                sim.scenario.inject_failures, failures_log=failures)
            last = comp.stages[-1]
            results.append(SimStepResult(
                component=comp, failures=failures,
                clock_end=float(last.start + last.runtime)))
        return results
