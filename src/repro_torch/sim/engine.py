"""The runner's simulation-backend protocol.

The experiment runner's execution generator *yields* its pending component
step as a :class:`SimStepRequest` and resumes with a :class:`SimStepResult`
from a sim backend, so a driver could batch every concurrent job's step.
:class:`NumpySimBackend` answers each request through the per-job
:class:`~repro_torch.dataflow.simulator.ClusterSim` event loop.

Counterpart of the protocol part of ``repro.sim.engine``, with the
backend's fleet registration (``register``) and campaign-checkpoint hooks
(``slot_state`` / ``restore_slot``).  The vectorized ``BatchedClusterSim``
is not ported yet (queue 1 item 8 of ROADMAP.md).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from repro_torch.dataflow.simulator import ClusterSim, ComponentRecord
from repro_torch.dataflow.workloads import JobSpec
from repro_torch.sim.scenarios import Scenario


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

    def register(self, job: JobSpec, seed: int,
                 scenario: Optional[Scenario] = None,
                 interference_scale: float = 0.12) -> int:
        return self.adopt(ClusterSim(seed=seed, scenario=scenario,
                                     interference_scale=interference_scale),
                          job)

    def begin_run(self, slot: int) -> None:
        self._slots[slot][0].begin_run()

    def slot_state(self, slot: int) -> dict:
        """Mutable state of one registered sim, for campaign checkpoints."""
        return self._slots[slot][0].state_dict()

    def restore_slot(self, slot: int, state: dict) -> None:
        self._slots[slot][0].load_state_dict(state)

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
