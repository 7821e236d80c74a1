"""Discrete-event execution of iterative dataflow jobs on a multi-tenant
cluster (paper §V-A/B): Ernest-form stage runtimes modulated by background
interference (AR(1)), data-locality noise, rescale overheads and the paper's
failure injector (one executor kill at a seeded random second per 90 s
window while more than 4 executors remain; Spark restores the executor after
a delay).

A numpy copy of the JAX package's reference simulator
(``repro.dataflow.simulator``): every stage is computed with IEEE-exact
float32 scalar ops reading precomputed lookup tables
(``repro_torch.sim.tables``), so the same seed gives bit-identical records in
both packages.  Scenario disturbances come from the seeded tables of
``repro_torch.sim.scenarios``.

Float32 stage recipe:

    w0     = floor(clock / 90);  window-indexed tables use min(w0, W_MAX-1)
    innov  = |n0| * (2*interference_scale * burst[w0])
    interf = clip(0.85*interf + 0.15*innov, 0, 0.45)          # AR(1)
    loc    = 1 + max(0, n1*0.04 + 0.02)                       # data locality
    z_eff  = max(z - preempt[w0], 1)                          # spot loss
    t      = rt[z_eff]*(1+interf)*loc + n2*(0.15*sq[z_eff])
    t      = max(t, 0.2) * straggler[stage_idx]
    for each window w covering [clock, clock+t):              # z > 4 only
        if kill_time[run, w] in [clock, clock+t):             # per-window
            frac = min(25, t)/max(t, 1e-6); t = t*(1-frac) +
                   (t*frac)*slow[z_eff] + 18                  # retry cost
    runtime = t + rescale_overhead
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.dataflow.workloads import JobSpec, StageSpec
from repro_torch.sim.scenarios import BASELINE, Scenario
from repro_torch.sim.tables import (F32, GLOBAL, MAX_FAIL_WINDOWS, N_NOISE, R_MAX,
                              T_STRAGGLER, W_MAX, overhead_f32, stage_tables)

FAILURE_WINDOW = 90.0
RESTART_DELAY = 25.0          # seconds until the replacement executor joins
RETRY_PENALTY = 18.0          # lost-task recompute cost charged to the stage
RESCALE_BASE = 4.0            # fixed rescale overhead (renegotiation)
RESCALE_PER_EXEC = 0.35       # per-executor-delta overhead (state movement)

_W90 = F32(FAILURE_WINDOW)


@dataclass
class StageRecord:
    name: str
    start: float
    runtime: float
    start_scaleout: float      # a_i
    end_scaleout: float        # z_i
    time_fraction: float       # r_i: fraction spent in end scale-out
    overhead: float            # rescale overhead attributed to this stage
    metrics: np.ndarray        # the 5 paper metrics
    failures: int = 0


@dataclass
class ComponentRecord:
    comp_idx: int
    stages: List[StageRecord]

    @property
    def runtime(self) -> float:
        return sum(s.runtime for s in self.stages)

    @property
    def scaleout(self) -> float:
        return self.stages[-1].end_scaleout


@dataclass
class RunRecord:
    job: str
    target_runtime: float
    components: List[ComponentRecord] = field(default_factory=list)
    rescales: List[Tuple[int, int, int]] = field(default_factory=list)
    failures: List[float] = field(default_factory=list)

    @property
    def runtime(self) -> float:
        return sum(c.runtime for c in self.components)

    @property
    def violation(self) -> float:
        return max(0.0, self.runtime - self.target_runtime)


class ClusterSim:
    """Shared-cluster environment; one instance per experiment sequence so
    interference is a persistent AR(1) process across runs.

    Noise discipline: each stage consumes exactly ``N_NOISE`` sequential
    ``randn`` draws from ``self.rng`` (interference innovation, locality,
    runtime noise, cpu-metric noise) — a path-independent count.
    """

    def __init__(self, seed: int = 0, interference_scale: float = 0.12,
                 scenario: Optional[Scenario] = None):
        self.rng = np.random.RandomState(seed)
        self.seed = seed
        self.scenario = scenario or BASELINE
        self.interference_scale = interference_scale
        self._iscale2 = F32(interference_scale * 2.0)
        self._win = self.scenario.window_tables(seed)
        self._interf = F32(0.0)
        self.run_idx = 0              # kill-table row of the current run
        self._runs_started = 0
        self.stage_idx = 0            # global stage counter (straggler stream)
        self._spec_tab: Dict[Tuple[StageSpec, int], Dict] = {}

    def begin_run(self) -> int:
        """Mark the start of a run: selects this run's seeded kill-second
        row."""
        self.run_idx = self._runs_started
        self._runs_started += 1
        return self.run_idx

    # ----------------------------------------------------------- checkpoint
    def state_dict(self) -> Dict:
        """Every mutable field a trace-identical resume needs.  The seeded
        window tables and the stage-spec cache are deterministic in
        (scenario, seed) and rebuilt on construction, so they stay out."""
        return {
            "rng": self.rng.get_state(),
            "interf": F32(self._interf),
            "run_idx": int(self.run_idx),
            "runs_started": int(self._runs_started),
            "stage_idx": int(self.stage_idx),
        }

    def load_state_dict(self, state: Dict) -> None:
        self.rng.set_state(state["rng"])
        self._interf = F32(state["interf"])
        self.run_idx = int(state["run_idx"])
        self._runs_started = int(state["runs_started"])
        self.stage_idx = int(state["stage_idx"])

    def _tables(self, spec: StageSpec, comp_idx: int) -> Dict:
        key = (spec, comp_idx)
        tab = self._spec_tab.get(key)
        if tab is None:
            growth = float(self.scenario.skew_growth) ** comp_idx
            tab = stage_tables(spec, growth)
            self._spec_tab[key] = tab
        return tab

    # ----------------------------------------------------------------- stage
    def run_stage(self, spec: StageSpec, *, start_scaleout: int,
                  end_scaleout: int, clock: float, rescale_overhead: float,
                  inject_failures: bool, failures_log: List[float],
                  comp_idx: int = 0) -> StageRecord:
        tab = self._tables(spec, comp_idx)
        a, z = int(start_scaleout), int(end_scaleout)
        clock = F32(clock)
        n = self.rng.randn(N_NOISE).astype(F32)
        w0 = int(np.floor(clock / _W90))
        wi0 = min(max(w0, 0), W_MAX - 1)
        # AR(1) interference, burst-modulated innovation
        innov = np.abs(n[0]) * (self._iscale2 * self._win["burst"][wi0])
        interf = F32(0.85) * self._interf + F32(0.15) * innov
        self._interf = interf = min(max(interf, F32(0.0)), F32(0.45))
        loc = F32(1.0) + max(F32(0.0), n[1] * F32(0.04) + F32(0.02))
        z_eff = max(z - int(self._win["preempt"][wi0]), 1)
        base = tab["rt"][z_eff]
        t = base * (F32(1.0) + interf) * loc + n[2] * (F32(0.15) *
                                                       tab["sq"][z_eff])
        t = max(t, F32(0.2))
        t = t * self._win["straggler"][self.stage_idx % T_STRAGGLER]
        t0 = t
        failed = 0
        # failure injector (paper §V-B.4): each 90 s window has ONE seeded
        # kill second (per window AND per run — the old engine re-drew it
        # per stage, so overlapping stages disagreed about the kill time);
        # the kill fires in whichever stage covers that second, only while
        # > 4 executors are allocated.
        if inject_failures and z > 4:
            w_hi = min(int(np.floor((clock + t0) / _W90)),
                       w0 + MAX_FAIL_WINDOWS - 1)
            kill_row = self._win["kill_time"][self.run_idx % R_MAX]
            for w in range(w0, w_hi + 1):
                when = kill_row[min(max(w, 0), W_MAX - 1)]
                if (when >= clock) and (when < clock + t0):
                    failed += 1
                    failures_log.append(float(when))
                    # degraded scale until restart + retry recompute
                    frac = min(F32(RESTART_DELAY), t) / max(t, F32(1e-6))
                    t = t * (F32(1.0) - frac) + \
                        (t * frac) * tab["slow"][z_eff] + F32(RETRY_PENALTY)
        runtime = t + F32(rescale_overhead)
        r_frac = F32(1.0) if a == z else F32(0.8)
        rec = StageRecord(
            name=spec.name, start=clock, runtime=runtime,
            start_scaleout=float(a), end_scaleout=float(z),
            time_fraction=float(r_frac), overhead=float(rescale_overhead),
            metrics=self._stage_metrics(tab, z_eff, interf, failed, n[3]),
            failures=failed)
        self.stage_idx += 1
        return rec

    def _stage_metrics(self, tab: Dict, z_eff: int, interf: F32,
                       failed: int, n3: F32) -> np.ndarray:
        """[cpu_util, shuffle_rw, data_io, gc_frac, spill_ratio] (§IV-B)."""
        mem = GLOBAL["mem"][z_eff]                 # fewer executors -> pressure
        gc = F32(0.04) + F32(0.05) * mem
        if failed:
            gc = gc + F32(0.05)
        spill = max(F32(0.0), mem - F32(1.4)) * F32(0.3)
        cpu = tab["cpu0"] * (F32(1.0) - interf) + n3 * F32(0.02)
        cpu = min(max(cpu, F32(0.0)), F32(1.0))
        shuffle = tab["shuffle0"] * GLOBAL["shuf"][z_eff]
        io = tab["io0"] * (F32(1.3) if failed else F32(1.0))
        return np.array([cpu, shuffle, io, gc, spill], F32)

    # -------------------------------------------------------------- component
    def run_component(self, job: JobSpec, comp_idx: int, *, clock: float,
                      start_scaleout: int, end_scaleout: int,
                      inject_failures: bool, failures_log: List[float]
                      ) -> ComponentRecord:
        overhead_total = overhead_f32(start_scaleout, end_scaleout)
        clock = F32(clock)
        stages = []
        specs = job.stages(comp_idx)
        for i, spec in enumerate(specs):
            ov = overhead_total if i == 0 else F32(0.0)
            a = start_scaleout if i == 0 else end_scaleout
            rec = self.run_stage(spec, start_scaleout=a,
                                 end_scaleout=end_scaleout, clock=clock,
                                 rescale_overhead=ov,
                                 inject_failures=inject_failures,
                                 failures_log=failures_log,
                                 comp_idx=comp_idx)
            stages.append(rec)
            clock = rec.start + rec.runtime
        return ComponentRecord(comp_idx, stages)


def rescale_overhead(a: int, z: int) -> float:
    return 0.0 if a == z else RESCALE_BASE + RESCALE_PER_EXEC * abs(z - a)
