"""Named, seeded, composable disturbance scenarios (ROADMAP: "as many
scenarios as you can imagine"; paper §V-B.4 node failures + the C3O-style
cross-context axis).

A :class:`Scenario` is a frozen parameter record; all of its randomness is
materialized into seeded per-window / per-stage tables
(:func:`repro_torch.sim.tables.window_tables`); a numpy copy of
``repro.sim.scenarios``, so a scenario produces the exact same disturbance
trajectory in both packages.

Registry (each entry also composes with any other via dataclasses.replace):

=================== ========================================================
``baseline``        clean multi-tenant background (AR(1) interference only)
``node_failure``    paper-faithful: one kill per 90 s window while > 4
                    executors are allocated, per-window seeded second
``stragglers``      heavy-tailed per-stage slowdowns (p ~ straggler_prob)
``spot_preemption`` correlated loss of 2..preempt_max executors per window
``interference_burst`` regime-switching AR(1): seeded Markov bursts multiply
                    the interference innovation
``data_skew_drift`` per-iteration input growth: component k's parallel work
                    scales by skew_growth**k
``multi_tenant``    global executor pool + Poisson job arrivals (campaign
                    level: concurrent jobs contend, decisions are
                    capacity-capped — see FleetCampaign.arrival_campaign)
``chaos_*``         controller-side fault plans (sim/chaos.py): poisoned
                    observations / cache bit-rot / NaN model params /
                    dispatch timeouts / controller crashes — attack the
                    CONTROL PLANE instead of the simulated cluster
=================== ========================================================
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict

from repro_torch.sim import tables as T
from repro_torch.sim.chaos import CHAOS_NONE, ChaosSpec


@dataclass(frozen=True)
class Scenario:
    name: str = "baseline"
    seed: int = 0
    inject_failures: bool = False      # node_failure injector always on
    straggler_prob: float = 0.0        # P(stage is a straggler)
    straggler_scale: float = 0.0       # exponential tail scale of slowdown
    burst_prob: float = 0.0            # P(enter burst) per window
    burst_exit: float = 0.0            # P(exit burst) per window
    burst_mult: float = 1.0            # innovation multiplier inside burst
    preempt_prob: float = 0.0          # P(preemption event) per window
    preempt_max: int = 0               # max executors lost per event
    skew_growth: float = 1.0           # per-component parallel-work growth
    arrival_rate: float = 0.0          # jobs/round (multi-tenant campaigns)
    pool_size: int = 0                 # global executor pool (0 = unlimited)
    chaos: ChaosSpec = CHAOS_NONE      # controller-side fault plan

    def key(self):
        """Hashable identity used for table caching."""
        return dataclasses.astuple(self)

    def window_tables(self, sim_seed: int) -> Dict:
        return T.window_tables(self, sim_seed)


BASELINE = Scenario()

_REGISTRY: Dict[str, Scenario] = {
    "baseline": BASELINE,
    "node_failure": Scenario(name="node_failure", inject_failures=True),
    "stragglers": Scenario(name="stragglers", straggler_prob=0.12,
                           straggler_scale=0.8),
    "spot_preemption": Scenario(name="spot_preemption", preempt_prob=0.10,
                                preempt_max=6),
    "interference_burst": Scenario(name="interference_burst", burst_prob=0.10,
                                   burst_exit=0.30, burst_mult=4.0),
    "data_skew_drift": Scenario(name="data_skew_drift", skew_growth=1.04),
    "multi_tenant": Scenario(name="multi_tenant", arrival_rate=1.5,
                             pool_size=96),
    # controller-side chaos plans: the cluster stays on the node_failure
    # environment while faults hit the control plane itself
    "chaos_observations": Scenario(
        name="chaos_observations", inject_failures=True,
        chaos=ChaosSpec(name="observations", nan_graphs_every=2,
                        cache_corrupt_every=3)),
    "chaos_model": Scenario(
        name="chaos_model", inject_failures=True,
        chaos=ChaosSpec(name="model", nan_fit_every=3)),
    "chaos_timeouts": Scenario(
        name="chaos_timeouts", inject_failures=True,
        chaos=ChaosSpec(name="timeouts", timeout_every=3, timeout_burst=4)),
    "chaos_crashes": Scenario(
        name="chaos_crashes", inject_failures=True,
        chaos=ChaosSpec(name="crashes", crash_rounds=(2, 5))),
}

SCENARIO_NAMES = tuple(_REGISTRY)


def make_scenario(name: str, seed: int = 0, **overrides) -> Scenario:
    """Look up a named scenario; ``seed`` keys its disturbance tables and
    ``overrides`` compose extra effects onto it (e.g. stragglers + failures:
    ``make_scenario("stragglers", inject_failures=True)``)."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown scenario {name!r}; have {SCENARIO_NAMES}")
    return dataclasses.replace(_REGISTRY[name], seed=seed, **overrides)
