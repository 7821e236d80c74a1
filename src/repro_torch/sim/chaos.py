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
                       every decision then trips the service's on-device
                       guardrail and falls back to the bounded heuristic
                       until the next scratch retrain re-initialises the
                       model.
``timeout_every``      raises :class:`~repro_torch.core.service.
                       DispatchTimeout` inside the decision service's
                       dispatch path (:class:`DispatchChaos`, a burst of
                       ``timeout_burst`` consecutive attempts): absorbed by
                       retry/backoff; bursts longer than the retry budget
                       force fallback decisions and, repeated, trip the
                       circuit breaker.
=====================  =====================================================

Every fault is a pure function of ``(spec.seed, experiment seed, run/call
index)`` and emits a ``chaos`` span (``repro_torch.obs``).  Counterpart of
``repro.sim.chaos``; ``crash_rounds`` belongs to the fleet campaigns, which
are not ported.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.service import DispatchTimeout
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
        obs.emit("chaos", family="nan_graphs", spec=self.spec.name,
                 run=run_idx, victim=run_idx % len(graphs))
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
                obs.emit("chaos", family="cache_corrupt",
                         spec=self.spec.name, run=run_idx, slot=slot)
        if self._fires(self.spec.nan_fit_every, run_idx):
            trainer.params = map_params(
                lambda p: torch.full_like(p, float("nan")), trainer.params)
            self.fits_poisoned += 1
            obs.emit("chaos", family="nan_fit", spec=self.spec.name,
                     run=run_idx)


class DispatchChaos:
    """Service-level injector: plugs into ``DecisionService.fault_injector``
    (called once per dispatch *attempt*) and raises
    :class:`~repro_torch.core.service.DispatchTimeout` on every
    ``timeout_every``-th dispatch, for ``timeout_burst`` consecutive
    attempts.  A burst longer than the retry budget turns the whole group
    into fallback decisions and feeds the circuit breaker.  Counter-only
    state with ``snapshot``/``restore``, which the service folds into its
    own.
    """

    def __init__(self, spec: ChaosSpec):
        self.spec = spec
        self.dispatches = 0      # fault-free dispatch attempts seen
        self.timeouts = 0        # injected timeouts (lifetime)
        self._burst_left = 0     # remaining attempts of the current burst

    def __call__(self) -> None:
        if self.spec.timeout_every <= 0:
            return
        if self._burst_left > 0:
            self._burst_left -= 1
            self.timeouts += 1
            obs.emit("chaos", family="dispatch_timeout",
                     spec=self.spec.name, dispatch=self.dispatches,
                     burst_left=self._burst_left)
            raise DispatchTimeout(
                f"chaos[{self.spec.name}]: injected dispatch timeout "
                f"(burst, {self._burst_left} left)")
        self.dispatches += 1
        if self.dispatches % self.spec.timeout_every == 0:
            self._burst_left = max(int(self.spec.timeout_burst), 1) - 1
            self.timeouts += 1
            obs.emit("chaos", family="dispatch_timeout",
                     spec=self.spec.name, dispatch=self.dispatches,
                     burst_left=self._burst_left)
            raise DispatchTimeout(
                f"chaos[{self.spec.name}]: injected dispatch timeout")

    def snapshot(self) -> Dict:
        return {"dispatches": self.dispatches, "timeouts": self.timeouts,
                "burst_left": self._burst_left}

    def restore(self, st: Dict) -> None:
        self.dispatches = int(st["dispatches"])
        self.timeouts = int(st["timeouts"])
        self._burst_left = int(st["burst_left"])


def make_injector(spec: ChaosSpec, exp_seed: int = 0
                  ) -> Optional[ChaosInjector]:
    """Per-experiment injector, or None when the spec has no per-run
    faults (timeouts live at the service layer)."""
    if spec.nan_graphs_every or spec.cache_corrupt_every \
            or spec.nan_fit_every:
        return ChaosInjector(spec, exp_seed)
    return None


def make_dispatch_chaos(spec: ChaosSpec) -> Optional[DispatchChaos]:
    """Service-level timeout injector, or None when inactive."""
    return DispatchChaos(spec) if spec.timeout_every > 0 else None

