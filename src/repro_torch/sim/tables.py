"""Precomputed float32 cost tables of the simulator (numpy copy of
``repro.sim.tables``).

Every stage-level quantity either is computed with IEEE-exact float32 ops
(+, -, *, /, min, max, abs, floor, compare, select) or comes out of a table
precomputed ONCE host-side and gathered.  All transcendentals (log2 in the
Ernest runtime form, sqrt of the base runtime for the noise term, the 12/s
memory-pressure curve) land in tables indexed by the integer scale-out s in
[0, 36], so no libm function whose last ulp could differ is evaluated per
stage.

Scale-outs are integers (paper §V-A: 4..36 Spark executors), which is what
makes the table trick exact rather than an approximation.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Dict, Tuple

import numpy as np

if TYPE_CHECKING:              # type-only: keeps ``import repro_torch.sim``
    # free of the dataflow package
    from repro_torch.dataflow.workloads import JobSpec, StageSpec

F32 = np.float32
EXEC_MAX = 36                 # largest scale-out; tables are (EXEC_MAX+1,)
N_NOISE = 4                   # randn draws per stage: interf, loc, t, cpu
FAILURE_WINDOW = 90.0         # seconds per failure-injection window
W_MAX = 128                   # windows per run horizon (~3.2 h simulated)
R_MAX = 256                   # seeded kill-second rows before the table tiles
T_STRAGGLER = 8192            # straggler-multiplier stream length (tiles)
MAX_FAIL_WINDOWS = 8          # windows a single stage may span (<= 720 s)


def stage_tables(spec: StageSpec, growth: float = 1.0) -> Dict[str, np.ndarray]:
    """Per-stage lookup tables over integer scale-out s in [0, EXEC_MAX].

    ``growth`` scales the data-dependent (perfectly-parallel) term — the
    ``data_skew_drift`` scenario applies growth**component so later
    iterations process more data.
    """
    s = np.arange(EXEC_MAX + 1, dtype=np.float64)
    s[0] = 1.0                                     # s=0 never used; avoid inf
    rt = (spec.serial + growth * spec.parallel / s +
          spec.comm * np.log2(np.maximum(s, 2.0)) + spec.lin * s)
    rt = rt.astype(F32)
    rt[0] = rt[1]
    slow = rt[np.maximum(np.arange(EXEC_MAX + 1) - 1, 1)] / \
        np.maximum(rt, F32(1e-6))
    return {
        "rt": rt,
        "sq": np.sqrt(rt).astype(F32),
        "slow": slow.astype(F32),
        "cpu0": F32(spec.cpu),
        "shuffle0": F32(spec.shuffle),
        "io0": F32(spec.io),
    }


def global_tables() -> Dict[str, np.ndarray]:
    """Spec-independent per-scale-out tables (memory pressure, shuffle fan)."""
    s = np.arange(EXEC_MAX + 1, dtype=np.float64)
    s[0] = 1.0
    mem = np.clip(12.0 / s, 0.0, 2.5).astype(F32)
    shuf = (1.0 + 0.25 * np.log2(np.maximum(s, 2.0)) / 5.0).astype(F32)
    return {"mem": mem, "shuf": shuf}


GLOBAL = global_tables()


@dataclass
class FlatJobTables:
    """A job's full run flattened to its stage sequence (length T).

    The vectorized engine advances over this layout (components are
    contiguous stage ranges), reading the same float32 table entries the
    per-job simulator reads stage by stage.
    """
    job: JobSpec
    names: list                      # stage name per flat slot
    comp_of: np.ndarray              # (T,) int32 component index
    first_of_comp: np.ndarray        # (T,) bool  first stage of its component
    comp_start: np.ndarray           # (C,) int32 offset of each component
    n_stages: np.ndarray             # (C,) int32 stages per component
    rt: np.ndarray                   # (T, 37) f32
    sq: np.ndarray                   # (T, 37) f32
    slow: np.ndarray                 # (T, 37) f32
    cpu0: np.ndarray                 # (T,) f32
    shuffle0: np.ndarray             # (T,) f32
    io0: np.ndarray                  # (T,) f32

    @property
    def total_stages(self) -> int:
        return len(self.names)


def flat_job_tables(job: JobSpec, skew_growth: float = 1.0) -> FlatJobTables:
    names, comp_of, first, rts, sqs, slows = [], [], [], [], [], []
    cpu0, shuffle0, io0, comp_start, n_stages = [], [], [], [], []
    for c in range(job.n_components):
        specs = job.stages(c)
        comp_start.append(len(names))
        n_stages.append(len(specs))
        growth = float(skew_growth) ** c
        for i, spec in enumerate(specs):
            tab = stage_tables(spec, growth)
            names.append(spec.name)
            comp_of.append(c)
            first.append(i == 0)
            rts.append(tab["rt"])
            sqs.append(tab["sq"])
            slows.append(tab["slow"])
            cpu0.append(tab["cpu0"])
            shuffle0.append(tab["shuffle0"])
            io0.append(tab["io0"])
    return FlatJobTables(
        job=job, names=names,
        comp_of=np.array(comp_of, np.int32),
        first_of_comp=np.array(first, bool),
        comp_start=np.array(comp_start, np.int32),
        n_stages=np.array(n_stages, np.int32),
        rt=np.stack(rts), sq=np.stack(sqs), slow=np.stack(slows),
        cpu0=np.array(cpu0, F32), shuffle0=np.array(shuffle0, F32),
        io0=np.array(io0, F32))


def overhead_f32(a: int, z: int) -> F32:
    """Rescale overhead in the simulator's float32 op order."""
    if a == z:
        return F32(0.0)
    return F32(4.0) + F32(0.35) * F32(abs(int(z) - int(a)))


_WINDOW_CACHE: Dict[Tuple, Dict[str, np.ndarray]] = {}


def window_tables(scenario, sim_seed: int) -> Dict[str, np.ndarray]:
    """Seeded per-window / per-stage disturbance tables for one (scenario,
    simulator seed) pair.

    Draw order from one RandomState (fixed, so adding fields stays
    reproducible): kill fractions, burst regime, preemption losses,
    straggler multipliers.

    * ``kill_time[r, w]``: the one kill second of failure window ``w`` in
      run ``r`` (paper §V-B.4 — one executor kill at a random second per
      90 s window).  Per-window and per-run seeded: every stage that
      overlaps window ``w`` agrees on the same kill second, so exactly one
      kill fires per window (in whichever stage covers that second).
    * ``burst[w]``: interference-innovation multiplier (regime-switching
      AR(1): a seeded Markov chain enters/exits burst windows).
    * ``preempt[w]``: executors lost to spot preemption while window ``w``
      is active (correlated multi-executor loss).
    * ``straggler[t]``: per-stage runtime multiplier stream (1.0 or an
      exponential tail), indexed by the engine's global stage counter.
    """
    key = (scenario.key(), int(sim_seed))
    hit = _WINDOW_CACHE.get(key)
    if hit is not None:
        return hit
    mix = (int(sim_seed) * 2654435761 + scenario.seed * 97 + 0x9E3779B9) \
        % (2 ** 32)
    rng = np.random.RandomState(mix)
    frac = rng.uniform(0.0, 1.0, (R_MAX, W_MAX))
    kill_time = ((np.arange(W_MAX)[None, :] + frac) *
                 FAILURE_WINDOW).astype(F32)
    # burst regime: 2-state Markov chain over windows
    u = rng.uniform(0.0, 1.0, W_MAX)
    burst = np.ones(W_MAX, F32)
    state = False
    for w in range(W_MAX):
        state = (u[w] < scenario.burst_prob) if not state else \
            (u[w] >= scenario.burst_exit)
        if state:
            burst[w] = F32(scenario.burst_mult)
    # spot preemption: correlated loss of several executors in a window
    pu = rng.uniform(0.0, 1.0, W_MAX)
    psz = rng.randint(2, max(scenario.preempt_max, 2) + 1, W_MAX)
    preempt = np.where(pu < scenario.preempt_prob, psz, 0).astype(np.int32)
    # stragglers: occasional heavy-tailed per-stage slowdown
    su = rng.uniform(0.0, 1.0, T_STRAGGLER)
    tail = rng.exponential(max(scenario.straggler_scale, 1e-9), T_STRAGGLER)
    straggler = np.where(su < scenario.straggler_prob,
                         1.0 + tail, 1.0).astype(F32)
    out = {"kill_time": kill_time, "burst": burst, "preempt": preempt,
           "straggler": straggler}
    _WINDOW_CACHE[key] = out
    return out
