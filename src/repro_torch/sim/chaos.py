"""Controller-side chaos plans: the frozen :class:`ChaosSpec` record that a
:class:`~repro_torch.sim.scenarios.Scenario` carries.

Only the plan is ported so far; the injector that applies it to the model,
the training cache and the decision service comes with those layers.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ChaosSpec:
    """Frozen fault-injection plan (composes into :class:`Scenario`)."""
    name: str = "none"
    seed: int = 0
    nan_graphs_every: int = 0     # poison run observations every Nth run
    cache_corrupt_every: int = 0  # NaN a resident cache row every Nth run
    nan_fit_every: int = 0        # NaN model params after every Nth fit
    timeout_every: int = 0        # dispatch timeout every Nth service call
    timeout_burst: int = 1        # consecutive failing attempts per firing
    crash_rounds: Tuple[int, ...] = ()  # campaign rounds that "kill" the
    #                                     controller (checkpoint recovery)

    @property
    def active(self) -> bool:
        return bool(self.nan_graphs_every or self.cache_corrupt_every
                    or self.nan_fit_every or self.timeout_every
                    or self.crash_rounds)

    def key(self):
        return dataclasses.astuple(self)


CHAOS_NONE = ChaosSpec()
