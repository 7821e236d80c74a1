"""Controller-side chaos injection: deterministic faults aimed at the
control plane (model, training cache), not the simulated cluster.

:class:`ChaosSpec` is the frozen plan a
:class:`~repro_torch.sim.scenarios.Scenario` carries; :class:`ChaosInjector`
applies its per-run families inside ``JobExperiment``:

=====================  =====================================================
``nan_graphs_every``   poisons observed component graphs (NaN metrics and
                       runtimes) before they enter the history, caught by
                       the ``TrainingCache`` entry quarantine and the
                       trainer's non-finite step guard.
``cache_corrupt_every`` writes NaN into a resident ring row in place,
                       healed by ``fit_resident``'s quarantine-and-retry.
``nan_fit_every``      overwrites the model parameters with NaN after a fit;
                       decisions then fall back to the bounded heuristic
                       until the next scratch retrain re-initialises the
                       model.
=====================  =====================================================

Every fault is a pure function of ``(spec.seed, experiment seed, run
index)``.  Counterpart of ``repro.sim.chaos`` without its obs events; the
dispatch-timeout injector comes with the decision service.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.training import map_params


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


class ChaosInjector:
    """Per-experiment fault injector driven by ``JobExperiment`` hooks.

    ``poison_graphs`` fires between simulation and history/cache ingestion;
    ``after_fit`` fires right after the trainer's per-run fit.  Run ``r``
    fires for a family with period ``every`` iff
    ``r % every == (exp_seed ^ spec.seed) % every``.
    """

    def __init__(self, spec: ChaosSpec, exp_seed: int = 0):
        self.spec = spec
        self.exp_seed = int(exp_seed)
        self.graphs_poisoned = 0
        self.cache_rows_corrupted = 0
        self.fits_poisoned = 0

    def _fires(self, every: int, idx: int) -> bool:
        if every <= 0:
            return False
        return (idx % every) == ((self.exp_seed ^ self.spec.seed) % every)

    def poison_graphs(self, graphs: Sequence, run_idx: int) -> List:
        """NaN the metrics and runtimes of one observed component graph
        (on copies of its arrays, upstream of the cache)."""
        graphs = list(graphs)
        if not graphs or not self._fires(self.spec.nan_graphs_every, run_idx):
            return graphs
        victim = graphs[run_idx % len(graphs)]
        bad = dataclasses.replace(
            victim, metrics=victim.metrics.copy(),
            runtime=victim.runtime.copy())
        bad.metrics[bad.metrics_valid] = np.nan
        bad.runtime[bad.runtime_valid] = np.nan
        graphs[run_idx % len(graphs)] = bad
        self.graphs_poisoned += 1
        return graphs

    def after_fit(self, trainer, run_idx: int) -> None:
        """Post-fit faults: in-place ring corruption (healed by the next
        fit's quarantine sweep) and NaN parameters (fallback decisions
        until the next scratch retrain)."""
        if self._fires(self.spec.cache_corrupt_every, run_idx):
            cache = getattr(trainer, "cache", None)
            if cache is not None and cache.count > 0:
                slot = run_idx % cache.count
                for v in cache.buffers.values():
                    if v.is_floating_point():
                        v[slot] = float("nan")
                self.cache_rows_corrupted += 1
        if self._fires(self.spec.nan_fit_every, run_idx):
            trainer.params = map_params(
                lambda p: torch.full_like(p, float("nan")), trainer.params)
            self.fits_poisoned += 1

