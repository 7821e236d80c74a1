"""The runner's simulation-backend protocol and the vectorized fleet engine.

The experiment runner's execution generator *yields* its pending component
step as a :class:`SimStepRequest` and resumes with a :class:`SimStepResult`
from a sim backend, so a fleet campaign batches every concurrent job's step
into one call.  Two backends answer it:

* :class:`NumpySimBackend` runs each request through the per-job
  :class:`~repro_torch.dataflow.simulator.ClusterSim` event loop;
* :class:`BatchedClusterSim` advances every registered job in lockstep on
  the device: ONE launch of the ``sim_step`` kernel
  (``repro_torch.kernels.sim_step``) per fleet component-step, and one
  per whole run (:meth:`BatchedClusterSim.run_full`).

Bit-parity contract: the kernel replays the float32 stage recipe of
``repro_torch.dataflow.simulator`` op for op, reading the same precomputed
tables (``repro_torch.sim.tables``) and the same seeded noise stream (a
run's ``randn(T, N_NOISE)`` block, drawn on the host, equals the per-stage
sequential draws), so both backends give the same records bit for bit.

Dispatch-cost layout: per-stage inputs ride in ONE packed float32 block
(noise | rt | sq | slow | cpu0 | shuffle0 | io0 | straggler | overhead, the
``_F*`` slices), uploaded once per fleet run and kept on the device; a step
uploads one ``(J, 8)`` control row and fetches its packed ``(state, outs)``
in one copy.

Counterpart of ``repro.sim.engine``, with the backends' fleet registration
(``register``) and campaign-checkpoint hooks (``slot_state`` /
``restore_slot``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.dataflow.simulator import (ClusterSim, ComponentRecord,
                                            StageRecord)
from repro_torch.dataflow.workloads import JobSpec
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.sim_step import ops
from repro_torch.kernels.sim_step.ops import (  # noqa: F401  (the layout)
    F_CPU0 as _F_CPU0, F_IO0 as _F_IO0, F_NOISE as _F_NOISE, F_OV as _F_OV,
    F_RT as _F_RT, F_SHUF0 as _F_SHUF0, F_SLOW as _F_SLOW, F_SQ as _F_SQ,
    F_STRAG as _F_STRAG, F_TAB as _F_TAB, NF as _NF, NO as _NO,
    O_CLK as _O_CLK, O_FAILED as _O_FAILED, O_HIT as _O_HIT,
    O_MET as _O_MET, O_RT as _O_RT, O_WHEN as _O_WHEN)
from repro_torch.sim.scenarios import BASELINE, Scenario
from repro_torch.sim.tables import (EXEC_MAX, F32, GLOBAL, N_NOISE, R_MAX,
                                    T_STRAGGLER, W_MAX, FlatJobTables,
                                    flat_job_tables, overhead_f32)


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


# ----------------------------------------------------------------- batched
class _Slot:
    def __init__(self, job: JobSpec, seed: int, scenario: Scenario,
                 interference_scale: float):
        self.job = job
        self.seed = seed
        self.scenario = scenario
        self.tables: FlatJobTables = flat_job_tables(job,
                                                     scenario.skew_growth)
        self.win = scenario.window_tables(seed)
        self.rng = np.random.RandomState(seed)
        self.iscale2 = F32(interference_scale * 2.0)
        self.clock = F32(0.0)
        self.interf = F32(0.0)
        self.run_idx = 0
        self.runs_started = 0
        self.cursor = 0               # stage cursor within the current run
        self.stage_idx = 0            # global stage counter (stragglers)
        self.noise = np.zeros((self.tables.total_stages, N_NOISE), F32)


class BatchedClusterSim:
    """Vectorized fleet engine on ``device``; implements the same backend
    protocol as :class:`NumpySimBackend` but answers every concurrent
    request in one ``sim_step`` launch (and runs entire runs in one launch
    via :meth:`run_full`).

    State (clock, AR(1) interference, noise cursors, kill-table rows) is
    tracked per registered slot on the host and advanced only by the
    engine itself: the generator's ``req.clock`` must follow the engine's
    returned ``clock_end`` (the runner does); steps replayed out of order
    would diverge from the per-job stream.  ``dispatches`` counts launches.
    """

    def __init__(self, device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        self._slots: List[_Slot] = []
        self._built = False
        self.dispatches = 0

    # ------------------------------------------------------------- registry
    def register(self, job: JobSpec, seed: int,
                 scenario: Optional[Scenario] = None,
                 interference_scale: float = 0.12) -> int:
        assert not self._built, "register before the first step/run_full"
        self._slots.append(_Slot(job, seed, scenario or BASELINE,
                                 interference_scale))
        return len(self._slots) - 1

    def _dev(self, array: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(array)).to(self.device)

    def _build(self):
        if self._built:
            return
        self._built = True
        self._J = len(self._slots)
        self._T = max(s.tables.total_stages for s in self._slots)
        self._S = max(int(s.tables.n_stages.max()) for s in self._slots)
        self._burst = self._dev(np.stack([s.win["burst"]
                                          for s in self._slots]))
        self._preempt = self._dev(np.stack([s.win["preempt"]
                                            for s in self._slots]))
        self._iscale2 = self._dev(np.array([s.iscale2 for s in self._slots]))
        self._mem_tab = self._dev(GLOBAL["mem"])
        self._shuf_tab = self._dev(GLOBAL["shuf"])
        self._kill_dev = None         # per-run upload, cached until begin_run
        # per-slot packed table block (T_j, 111): rt | sq | slow; plus the
        # scalar spec columns, copied into the run block by slice
        self._tabpack = []
        self._scalpack = []
        for s in self._slots:
            t = s.tables
            self._tabpack.append(np.concatenate(
                [t.rt, t.sq, t.slow], axis=1).astype(F32))
            self._scalpack.append(np.stack(
                [t.cpu0, t.shuffle0, t.io0], axis=1).astype(F32))
        # device-resident full-run input block for the stepped path: the
        # noise / tables / straggler columns of EVERY stage of the current
        # run, uploaded once per fleet run (dirty slots re-packed lazily at
        # the next step); a step then ships only the (J, 8) control row
        self._run_host = np.zeros((self._T, self._J, _NF), F32)
        self._run_host[:, :, _F_STRAG] = 1.0
        for j, s in enumerate(self._slots):
            tj = s.tables.total_stages
            self._run_host[:tj, j, _F_TAB] = self._tabpack[j]
            self._run_host[:tj, j, _F_CPU0:_F_IO0 + 1] = self._scalpack[j]
        self._run_dev = None
        self._dirty = set(range(self._J))

    # ------------------------------------------------------------ lifecycle
    def begin_run(self, slot: int) -> int:
        s = self._slots[slot]
        s.run_idx = s.runs_started
        s.runs_started += 1
        s.cursor = 0
        s.clock = F32(0.0)
        tj = s.tables.total_stages
        s.noise = s.rng.randn(tj * N_NOISE).astype(F32).reshape(tj, N_NOISE)
        self._kill_dev = None
        if self._built:
            self._dirty.add(slot)
        return s.run_idx

    # ----------------------------------------------------------- checkpoint
    def slot_state(self, slot: int) -> dict:
        """Mutable state of one slot, sufficient for a trace-identical
        resume: host RNG stream, clock/interference carry, stage cursors
        and the current run's pre-drawn noise block (host data only)."""
        s = self._slots[slot]
        return {
            "rng": s.rng.get_state(),
            "clock": F32(s.clock),
            "interf": F32(s.interf),
            "run_idx": int(s.run_idx),
            "runs_started": int(s.runs_started),
            "cursor": int(s.cursor),
            "stage_idx": int(s.stage_idx),
            "noise": s.noise.copy(),
        }

    def restore_slot(self, slot: int, state: dict) -> None:
        s = self._slots[slot]
        s.rng.set_state(state["rng"])
        s.clock = F32(state["clock"])
        s.interf = F32(state["interf"])
        s.run_idx = int(state["run_idx"])
        s.runs_started = int(state["runs_started"])
        s.cursor = int(state["cursor"])
        s.stage_idx = int(state["stage_idx"])
        s.noise = state["noise"].copy()
        # invalidate the device-resident caches derived from slot state
        self._kill_dev = None
        if self._built:
            self._dirty.add(slot)

    def _consts(self) -> ops.SimConsts:
        if self._kill_dev is None:
            self._kill_dev = self._dev(np.stack(
                [s.win["kill_time"][s.run_idx % R_MAX]
                 for s in self._slots]))
        return ops.SimConsts(self._kill_dev, self._burst, self._preempt,
                             self._iscale2, self._mem_tab, self._shuf_tab)

    def _strag_slice(self, slot: int, n: int) -> np.ndarray:
        s = self._slots[slot]
        # the run block holds the WHOLE run's stages, so the straggler
        # stream must be aligned to the run's first stage: normally the
        # pack happens right after begin_run (cursor 0), but a mid-run
        # checkpoint restore re-packs with the cursor already advanced
        base = s.stage_idx - s.cursor
        idx = (base + np.arange(n)) % T_STRAGGLER
        return s.win["straggler"][idx]

    def _run_block(self) -> torch.Tensor:
        """Device copy of the current run's stage inputs; slots whose run
        began since the last upload are re-packed, and the block is
        re-shipped once per fleet run (not per step)."""
        if self._dirty or self._run_dev is None:
            for j in self._dirty:
                s = self._slots[j]
                tj = s.tables.total_stages
                self._run_host[:tj, j, _F_NOISE] = s.noise
                self._run_host[:tj, j, _F_STRAG] = self._strag_slice(j, tj)
            self._dirty.clear()
            self._run_dev = self._dev(self._run_host)
        return self._run_dev

    def _fetch(self, buf: torch.Tensor, s_len: int
               ) -> Tuple[np.ndarray, np.ndarray]:
        """The launch's packed ``(state, outs)``, in one device-to-host
        copy."""
        self.dispatches += 1
        return ops.unpack(buf.cpu().numpy(), self._J, s_len)

    # ----------------------------------------------------------------- step
    def step(self, requests: Sequence[SimStepRequest]
             ) -> List[SimStepResult]:
        """Advance every requested job by one component in ONE launch; the
        only per-step host->device traffic is the (J, 8) control row."""
        self._build()
        ctrl = np.zeros((self._J, ops.N_CTRL), F32)
        for j, s in enumerate(self._slots):
            ctrl[j, 0] = s.clock
            ctrl[j, 1] = s.interf
            ctrl[j, 7] = s.cursor
        spans: List[Tuple[int, int, int]] = []       # (slot, cursor, n)
        for req in requests:
            j = req.slot
            s = self._slots[j]
            c0 = int(s.tables.comp_start[req.comp_idx])
            n = int(s.tables.n_stages[req.comp_idx])
            assert s.cursor == c0, "steps must follow the run's stage order"
            a, z = int(req.start_scaleout), int(req.end_scaleout)
            assert 1 <= z <= EXEC_MAX, f"scale-out {z} outside the tables"
            ctrl[j, 2] = a
            ctrl[j, 3] = z
            ctrl[j, 4] = int(req.inject_failures or
                             s.scenario.inject_failures)
            ctrl[j, 5] = n
            ctrl[j, 6] = overhead_f32(a, z)
            spans.append((j, c0, n))
        state, outs = self._fetch(ops.sim_stages(
            self._run_block(), self._consts(), ctrl=self._dev(ctrl),
            s_len=self._S), self._S)
        results = []
        for req, (j, c0, n) in zip(requests, spans):
            s = self._slots[j]
            s.clock = F32(state[j, 0])
            s.interf = F32(state[j, 1])
            s.cursor = c0 + n
            s.stage_idx += n
            comp, fails = self._records(req, s, outs, j, c0, n)
            results.append(SimStepResult(component=comp, failures=fails,
                                         clock_end=float(s.clock)))
        return results

    def _records(self, req, s: _Slot, outs: np.ndarray, j: int, c0: int,
                 n: int, row0: int = 0
                 ) -> Tuple[ComponentRecord, List[float]]:
        a, z = int(req.start_scaleout), int(req.end_scaleout)
        stages, fails = [], []
        for i in range(n):
            r = outs[row0 + i, j]
            sa = a if i == 0 else z
            ov = float(overhead_f32(a, z)) if i == 0 else 0.0
            nfail = int(r[_O_FAILED])
            stages.append(StageRecord(
                name=s.tables.names[c0 + i],
                start=r[_O_CLK],
                runtime=r[_O_RT],
                start_scaleout=float(sa), end_scaleout=float(z),
                time_fraction=1.0 if sa == z else 0.8,
                overhead=ov,
                metrics=r[_O_MET].copy(),
                failures=nfail))
            if nfail:
                fails.extend(float(w) for w, h in
                             zip(r[_O_WHEN], r[_O_HIT]) if h)
        return ComponentRecord(req.comp_idx, stages), fails

    # ------------------------------------------------------- fused campaign
    def campaign_run_blocks(self, n_runs: int
                            ) -> Tuple[np.ndarray, np.ndarray]:
        """Pre-draw the packed input blocks for ``n_runs`` consecutive fleet
        runs: ``(blocks (R, T, J, _NF), kill_rows (R, J, W_MAX))``, on the
        host.

        Consumes the slots' RNG streams and advances their run/stage
        counters exactly as ``n_runs`` stepped (or ``run_full``) runs would,
        so a fused campaign executed from these blocks sees the SAME noise /
        straggler / kill draws as the stepped path, and the backend's state
        afterwards is as if those runs had been started.  The per-step
        overhead column (``_F_OV``) is left 0: a fused campaign fills it
        from its control row, as the stepped launch does.
        """
        self._build()
        blocks = np.zeros((n_runs, self._T, self._J, _NF), F32)
        kills = np.zeros((n_runs, self._J, W_MAX), F32)
        for r in range(n_runs):
            for j in range(self._J):
                self.begin_run(j)
            for j, s in enumerate(self._slots):
                tj = s.tables.total_stages
                blocks[r, :tj, j, _F_NOISE] = s.noise
                blocks[r, :tj, j, _F_TAB] = self._tabpack[j]
                blocks[r, :tj, j, _F_CPU0:_F_IO0 + 1] = self._scalpack[j]
                blocks[r, :tj, j, _F_STRAG] = self._strag_slice(j, tj)
                blocks[r, tj:, j, _F_STRAG] = 1.0
                kills[r, j] = s.win["kill_time"][s.run_idx % R_MAX]
            for s in self._slots:       # advance cursors past the run
                s.cursor = s.tables.total_stages
                s.stage_idx += s.tables.total_stages
        self._kill_dev = None
        self._dirty.update(range(self._J))
        return blocks, kills

    def fused_sim_constants(self) -> dict:
        """The per-fleet constant arrays the stage recipe closes over (on
        the engine's device), for a fused campaign that runs the same
        recipe."""
        self._build()
        return {"burst": self._burst, "preempt": self._preempt,
                "iscale2": self._iscale2, "mem_tab": self._mem_tab,
                "shuf_tab": self._shuf_tab, "t_max": self._T,
                "s_max": self._S}

    # ------------------------------------------------------------- full run
    def run_full(self, a_sched: np.ndarray, z_sched: np.ndarray,
                 inject_failures: bool = False
                 ) -> List[Tuple[List[ComponentRecord], List[float]]]:
        """One ENTIRE run of every registered job in a single launch.

        ``a_sched``/``z_sched``: (J, C_max) integer scale-out schedules
        (component c of job j starts at ``a_sched[j, c]`` and runs at
        ``z_sched[j, c]``); rescale decisions are fixed upfront, which is
        what profiling runs and scenario replays need.  Returns per job the
        component records and observed kill seconds.
        """
        self._build()
        J, T = self._J, self._T
        for j in range(J):
            self.begin_run(j)
        fbuf = np.zeros((T, J, _NF), F32)
        fbuf[:, :, _F_STRAG] = 1.0
        ibuf = np.zeros((T, J, 2), np.int32)  # z | inject (a is host-side)
        ibuf[:, :, 0] = 4
        vbuf = np.zeros((T, J), bool)
        for j, s in enumerate(self._slots):
            tj = s.tables.total_stages
            fbuf[:tj, j, _F_NOISE] = s.noise
            fbuf[:tj, j, _F_TAB] = self._tabpack[j]
            fbuf[:tj, j, _F_CPU0:_F_IO0 + 1] = self._scalpack[j]
            fbuf[:tj, j, _F_STRAG] = self._strag_slice(j, tj)
            comp = s.tables.comp_of
            first = s.tables.first_of_comp
            zs = z_sched[j, comp].astype(np.int32)
            as_ = np.where(first, a_sched[j, comp], zs).astype(np.int32)
            assert ((zs >= 1) & (zs <= EXEC_MAX)).all(), \
                "scale-outs outside the tables"
            # overhead in the shared f32 op order (4 + 0.35*|z-a|, first
            # stage of a rescaling component only), vectorized
            d = np.abs(zs - as_).astype(F32)
            fbuf[:tj, j, _F_OV] = np.where(
                first & (as_ != zs), F32(4.0) + F32(0.35) * d, F32(0.0))
            ibuf[:tj, j, 0] = zs
            ibuf[:, j, 1] = int(inject_failures or
                                s.scenario.inject_failures)
            vbuf[:tj, j] = True
        state0 = np.zeros((J, 2), F32)
        state0[:, 1] = [s.interf for s in self._slots]
        state, outs = self._fetch(ops.sim_stages(
            self._dev(fbuf), self._consts(), state=self._dev(state0),
            ipack=self._dev(ibuf), valid=self._dev(vbuf)), T)
        results = []
        for j, s in enumerate(self._slots):
            s.clock = F32(state[j, 0])
            s.interf = F32(state[j, 1])
            s.cursor = s.tables.total_stages
            s.stage_idx += s.tables.total_stages
            comps, fails = [], []
            for c in range(s.job.n_components):
                c0 = int(s.tables.comp_start[c])
                n = int(s.tables.n_stages[c])
                req = SimStepRequest(j, c, int(a_sched[j, c]),
                                     int(z_sched[j, c]), 0.0,
                                     bool(ibuf[0, j, 1]))
                comp, cf = self._records(req, s, outs, j, c0, n, row0=c0)
                comps.append(comp)
                fails.extend(cf)
            results.append((comps, fails))
        return results
