"""Multi-job fleet campaigns over the shared decision service, PyTorch port.

A :class:`FleetCampaign` owns one
:class:`~repro_torch.core.service.DecisionService` shared by many
:class:`~repro_torch.dataflow.runner.JobExperiment`\\ s (four job classes x
several seeds, the paper's multi-tenant setting).  Each adaptive run
executes as a generator that yields its pending simulation step at every
component and its pending rescaling decision at every decision point; the
campaign interleaves all generators in lockstep rounds and hands every
currently pending request of each kind to its engine in one call: sim
steps in one backend call per backend, and the decisions of a round in one
``service.decide``, where same-bucket decisions from different jobs ride
one job-axis dispatch while each job still sees its own model's
predictions.

:meth:`FleetCampaign.arrival_campaign` adds the multi-tenant capacity
model: a global executor pool with Poisson job arrivals.  Concurrent jobs
contend, and every rescaling decision is capped to the job's fair share of
the free pool (``repro_torch.core.service.apply_capacity``), so the
compliant pick must respect a shrinking max scale-out.  The invariant
``sum(allocations) <= pool_size`` holds after every round: admission clamps
the initial allocation to the headroom, and the per-round caps hand each
pending decision ``alloc_i + free // n_pending``.

:class:`CampaignCheckpoint` makes a campaign survive its controller's
crash: ``checkpoint_every=k`` snapshots it every k lockstep rounds, and a
resumed campaign's trace equals the uninterrupted one.  Snapshots hold host
data only (numpy, python), so a checkpoint pickled on a card loads in a
process without one.

:meth:`FleetCampaign.fused_campaign` runs a whole campaign through the
fused step body of ``repro_torch.core.campaign_kernel``, enqueued without a
host synchronisation, and materializes its traces once at the end;
:class:`FusedCheckpoint` snapshots its carry between runs.

Counterpart of ``repro.dataflow.fleet``.
"""
from __future__ import annotations

import copy
import pickle
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.service import DecisionService, apply_capacity
from repro_torch.dataflow.runner import JobExperiment, RunStats
from repro_torch.dataflow.workloads import SCALEOUT_RANGE
from repro_torch.sim.engine import BatchedClusterSim, SimStepRequest


@dataclass
class CapacityTrace:
    """Per-round pool accounting of an arrival campaign."""
    round_idx: int
    active: int
    pool_used: int
    pool_size: int
    capped_decisions: int = 0
    arrivals: int = 0


@dataclass
class CampaignCheckpoint:
    """Resumable snapshot of a fleet campaign between lockstep rounds.

    Mid-run generators cannot be pickled or rebuilt directly, so a
    checkpoint stores checkpoint-by-replay state instead: each running
    experiment's run-start snapshot plus the ordered log of results its
    generator consumed since (one per round).  Resuming restores the
    run-start state, re-creates the generator and replays the logged
    results: every host-side mutation the generator performs
    (``record_component``/``observe_component``, graph building, the
    encoder's rng draws) is re-applied, the sim backend is then overwritten
    with its checkpoint-time slot state (``backend_now``), and the
    generator is parked at exactly the request it was pending on.
    Experiments whose run already finished (and between-runs checkpoints)
    store their current state; no replay needed.
    """
    kind: str                              # "adaptive" | "arrival"
    method: str
    inject_failures: bool
    n_runs: int
    run_idx: int                           # completed runs so far
    round_idx: int                         # global lockstep round counter
    checkpoint_every: int
    mid_run: bool
    # per experiment: {state, log, backend_now, stats}; log is None when
    # the state is current (finished / between runs) and a replay list
    # (run-start state + consumed results) when the run is in flight
    exps: List[Dict] = field(default_factory=list)
    all_stats: List[List[RunStats]] = field(default_factory=list)
    service_state: Dict = field(default_factory=dict)
    extra: Optional[Dict] = None           # arrival-campaign pool state
    obs_state: Optional[Dict] = None       # registry + flight-recorder state

    def save(self, path: str) -> None:
        """Persist to disk (host data only: snapshots are numpy, and a
        logged decision result pickles without its device tensor)."""
        with open(path, "wb") as f:
            pickle.dump(self, f)

    @staticmethod
    def load(path: str) -> "CampaignCheckpoint":
        with open(path, "rb") as f:
            return pickle.load(f)


@dataclass
class FusedCheckpoint:
    """Resumable snapshot of a fused campaign.

    The whole mutable state of a fused campaign is its carry: a host copy
    of it plus the step index is a complete checkpoint.  ``ys`` holds the
    stacked per-step outputs for steps ``[0, step)`` so a resumed campaign
    can materialize the SAME traces as an uninterrupted one.  Host data
    only (numpy), so it loads in a process without a card.
    """
    step: int
    n_steps: int
    carry: Dict
    ys: Dict
    obs_state: Optional[Dict] = None       # registry + flight-recorder state

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            pickle.dump(self, f)

    @staticmethod
    def load(path: str) -> "FusedCheckpoint":
        with open(path, "rb") as f:
            return pickle.load(f)


@dataclass
class FusedReport:
    """Campaign-level outcome of a fused run: the plan it executed, the
    final host carry, the per-step host traces and the guardrail counters
    (``nonfinite`` must be all zero: the step body clamps any non-finite
    pick to the current scale-out and counts it here)."""
    plan: object
    carry: Dict
    ys: Dict
    fallbacks: np.ndarray        # (J,) fallback-clamped decisions
    nonfinite: np.ndarray        # (J,) non-finite sweep picks (clamped)
    checkpoints: List[FusedCheckpoint] = field(default_factory=list)


def materialize_fused(plan, ys) -> List[List[RunStats]]:
    """Host materialization of a fused campaign's traces: one
    :class:`RunStats` per (run, experiment), shaped like
    :meth:`FleetCampaign.adaptive_campaign`'s stats.  Pure host numpy,
    called once at campaign end (or resume)."""
    host = plan.host
    c_max = plan.static.c_max
    n_runs = host["n_runs"]
    J = len(host["job_names"])
    clock = np.asarray(ys["clock"])
    z = np.asarray(ys["z"])
    s_next = np.asarray(ys["s_next"])
    decided = np.asarray(ys["decided"])
    fallback = np.asarray(ys["fallback"])
    failed = np.asarray(ys["failed"])            # (T, s_max, J)
    stage_live = (np.arange(failed.shape[1])[None, :, None]
                  < host["n_stage"][:, None, :])  # (c_max, s_max, J)
    stage_live = np.tile(stage_live, (n_runs, 1, 1))
    all_stats: List[List[RunStats]] = []
    for r in range(n_runs):
        t0 = r * c_max
        row: List[RunStats] = []
        for j in range(J):
            nc = int(host["n_comp"][j])
            runtime = float(clock[t0 + nc - 1, j])
            target = float(host["targets"][j])
            scaleouts = [int(host["s0"][j])]
            for t in range(t0, t0 + nc):
                if decided[t, j] and s_next[t, j] != z[t, j]:
                    scaleouts.append(int(s_next[t, j]))
            nfail = int(np.sum(
                failed[t0:t0 + c_max] * stage_live[t0:t0 + c_max],
                axis=(0, 1))[j])
            row.append(RunStats(
                host["run_idx0"][j] + r + 1, "enel", runtime, target,
                max(0.0, runtime - target),
                predicted=host["predicted"][j], scaleouts=scaleouts,
                n_failures=nfail, n_rescales=len(scaleouts) - 1,
                decide_calls=int(decided[t0:t0 + c_max, j].sum()),
                fallback_decisions=int(fallback[t0:t0 + c_max, j].sum())))
        all_stats.append(row)
    return all_stats


class FleetCampaign:
    """Drive many concurrent job experiments through one decision service.

    Pass ``engine="batched"`` to re-register every experiment on ONE shared
    :class:`~repro_torch.sim.engine.BatchedClusterSim` (before any runs have
    started), on the experiments' one device, so each lockstep round
    advances the whole fleet's simulation in one ``sim_step`` launch.  The
    default keeps each experiment's own backend (the numpy per-job event
    loop unless it was built with another).
    """

    def __init__(self, experiments: Sequence[JobExperiment],
                 service: Optional[DecisionService] = None,
                 engine: Optional[str] = None):
        self.service = service or DecisionService()
        self.experiments = list(experiments)
        for exp in self.experiments:
            exp.service = self.service          # single-run calls batch too
        if engine == "batched" and self.experiments:
            devices = {exp.trainer.device for exp in self.experiments}
            assert len(devices) == 1, \
                f"one shared backend, one device: {sorted(map(str, devices))}"
            shared = BatchedClusterSim(device=devices.pop())
            for exp in self.experiments:
                assert exp._run_idx == 0, \
                    "attach the shared backend before any runs"
                exp.backend = shared
                exp.sim_slot = shared.register(exp.job, exp.seed,
                                               exp.scenario)

    def profile(self, n_runs: int = 10) -> None:
        for exp in self.experiments:
            exp.profile(n_runs)

    # -------------------------------------------------------- lockstep rounds
    def _start(self, gens: Dict[int, object], stats: Dict[int, RunStats]
               ) -> Dict[int, object]:
        pending: Dict[int, object] = {}
        for i, gen in list(gens.items()):
            try:
                pending[i] = next(gen)
            except StopIteration as stop:       # run without any request
                stats[i] = stop.value
        return pending

    def _round(self, gens: Dict[int, object], pending: Dict[int, object],
               stats: Dict[int, RunStats],
               caps: Optional[Dict[int, int]] = None,
               on_decision=None,
               on_result=None) -> Tuple[Dict[int, object], int, List[int]]:
        """One lockstep round: batch pending sim steps per backend and
        pending decisions into one service call, resume every generator.

        ``caps`` (job id -> max scale-out) applies capacity caps to the
        listed decision requests; ``on_decision(i, result)`` observes each
        decision as it lands; ``on_result(i, result)`` observes every
        result (sim step or decision) just before it is fed to generator
        ``i`` (the checkpoint event log).  Returns (next pending,
        capped-decision count, ids of generators that finished this round).
        """
        results: Dict[int, object] = {}
        sims = {i: r for i, r in pending.items()
                if isinstance(r, SimStepRequest)}
        decs = {i: r for i, r in pending.items() if i not in sims}
        by_backend: Dict[int, List[int]] = {}
        for i in sims:
            by_backend.setdefault(
                id(self.experiments[i].backend), []).append(i)
        for ids in by_backend.values():
            backend = self.experiments[ids[0]].backend
            for i, res in zip(ids, backend.step([sims[i] for i in ids])):
                results[i] = res
        capped = 0
        if decs:
            ids = list(decs)
            reqs = []
            for i in ids:
                req = decs[i]
                if caps is not None and i in caps:
                    limited = apply_capacity(req, caps[i])
                    capped += limited is not req
                    req = limited
                reqs.append(req)
            for i, res in zip(ids, self.service.decide(reqs)):
                results[i] = res
                if on_decision is not None:
                    on_decision(i, res)
        nxt: Dict[int, object] = {}
        done: List[int] = []
        for i, res in results.items():
            if on_result is not None:
                on_result(i, res)
            try:
                nxt[i] = gens[i].send(res)
            except StopIteration as stop:
                stats[i] = stop.value
                done.append(i)
        return nxt, capped, done

    def _drain(self, gens: Dict[int, object]) -> Dict[int, RunStats]:
        """Interleave generators to completion, batching each round's
        pending requests per kind (and per sim backend)."""
        stats: Dict[int, RunStats] = {}
        pending = self._start(gens, stats)
        while pending:
            pending, _, _ = self._round(gens, pending, stats)
        return stats

    def adaptive_round(self, method: str = "enel",
                       inject_failures: bool = False) -> List[RunStats]:
        """One adaptive run of every experiment, requests cross-batched.

        All experiments advance to their next pending request; each round
        the set of pending sim steps is executed in one backend call per
        backend and the set of pending decisions in one service call
        (grouped by shape bucket, one job-axis dispatch per bucket), and
        each experiment resumes with its own result.  Returns the
        per-experiment RunStats in order.
        """
        stats, _ = self.adaptive_campaign(1, method, inject_failures)
        return stats[0]

    # ------------------------------------------------------ checkpointed runs
    def adaptive_campaign(self, n_runs: int, method: str = "enel",
                          inject_failures: bool = False, *,
                          checkpoint_every: int = 0,
                          stop_after_round: Optional[int] = None
                          ) -> Tuple[Optional[List[List[RunStats]]],
                                     List[CampaignCheckpoint]]:
        """``n_runs`` adaptive runs of every experiment with optional
        periodic checkpoints.

        ``checkpoint_every=k`` snapshots the whole campaign every k
        lockstep rounds (plus one initial checkpoint); with 0 no snapshot
        or event-log work happens.  ``stop_after_round=r`` simulates a
        controller crash: the campaign halts after global round r without
        writing a checkpoint and returns ``(None, ckpts)``; resume from the
        last periodic checkpoint with :meth:`resume_adaptive_campaign`.

        Returns ``(stats, ckpts)`` where ``stats[run][i]`` is experiment
        i's RunStats for that run (or None if stopped early).
        """
        return self._campaign_loop(
            n_runs, method, inject_failures, checkpoint_every,
            stop_after_round, run_idx=0, round_idx=0, all_stats=[],
            ckpts=[])

    def _campaign_loop(self, n_runs, method, inject_failures,
                       checkpoint_every, stop_after_round, *, run_idx,
                       round_idx, all_stats, ckpts, gens=None, pending=None,
                       stats=None, runstart=None, logs=None):
        checkpointing = checkpoint_every > 0
        mid = gens is not None
        while run_idx < n_runs or mid:
            if not mid:
                stats = {}
                if checkpointing:
                    runstart = {i: exp.snapshot_state()
                                for i, exp in enumerate(self.experiments)}
                    logs = {i: [] for i in range(len(self.experiments))}
                gens = {i: exp.adaptive_run_gen(method, inject_failures)
                        for i, exp in enumerate(self.experiments)}
                pending = self._start(gens, stats)
                if checkpointing and not ckpts:
                    # initial checkpoint: a crash before the first periodic
                    # one must still be recoverable
                    ckpts.append(self._make_checkpoint(
                        method, inject_failures, n_runs, run_idx, round_idx,
                        checkpoint_every, all_stats, stats, runstart, logs,
                        pending))
            mid = False
            while pending:
                on_result = None
                if checkpointing:
                    on_result = lambda i, res: logs[i].append(res)
                pending, _, _ = self._round(gens, pending, stats,
                                            on_result=on_result)
                round_idx += 1
                if checkpointing and round_idx % checkpoint_every == 0:
                    ckpts.append(self._make_checkpoint(
                        method, inject_failures, n_runs, run_idx, round_idx,
                        checkpoint_every, all_stats, stats, runstart, logs,
                        pending))
                if stop_after_round is not None and \
                        round_idx >= stop_after_round:
                    return None, ckpts           # simulated controller crash
            all_stats.append([stats[i]
                              for i in range(len(self.experiments))])
            run_idx += 1
        return all_stats, ckpts

    def _make_checkpoint(self, method, inject_failures, n_runs, run_idx,
                         round_idx, checkpoint_every, all_stats, stats,
                         runstart, logs, pending, kind="adaptive",
                         extra=None) -> CampaignCheckpoint:
        mid = bool(pending)
        all_c = copy.deepcopy(all_stats)
        if not mid and stats and len(stats) == len(self.experiments):
            # the round that tripped the checkpoint completed the run:
            # fold it in so resume starts cleanly at the next run
            all_c.append([copy.deepcopy(stats[i])
                          for i in range(len(self.experiments))])
            run_idx += 1
        exps = []
        for i, exp in enumerate(self.experiments):
            if mid and i in pending:
                exps.append({
                    "state": runstart[i], "log": list(logs[i]),
                    "backend_now": exp.backend.slot_state(exp.sim_slot),
                    "stats": None})
            else:                      # finished this run / between runs
                exps.append({
                    "state": exp.snapshot_state(), "log": None,
                    "backend_now": None,
                    "stats": copy.deepcopy(stats.get(i)) if mid else None})
        obs.emit("checkpoint", kind=kind, run_idx=run_idx,
                 round_idx=round_idx, mid_run=mid)
        return CampaignCheckpoint(
            kind=kind, method=method, inject_failures=inject_failures,
            n_runs=n_runs, run_idx=run_idx, round_idx=round_idx,
            checkpoint_every=checkpoint_every, mid_run=mid, exps=exps,
            all_stats=all_c, service_state=self.service.snapshot_state(),
            extra=copy.deepcopy(extra),
            obs_state=obs.snapshot() if obs.enabled() else None)

    def _replay_exp(self, i: int, entry: Dict, method: str,
                    inject_failures: bool):
        """Rebuild one mid-run generator from its run-start snapshot by
        replaying its consumed results, then pin the backend slot to its
        checkpoint-time state.  Returns (gen, pending request)."""
        exp = self.experiments[i]
        exp.restore_state(entry["state"])
        gen = exp.adaptive_run_gen(method, inject_failures)
        req = next(gen)
        for res in entry["log"]:
            req = gen.send(res)
        # replay fed logged results without touching the sim: overwrite
        # with the slot state as of the checkpoint (rng stream, AR(1)
        # carry, counters) so post-resume steps continue the exact sequence
        exp.backend.restore_slot(exp.sim_slot, entry["backend_now"])
        return gen, req

    def resume_adaptive_campaign(self, ckpt: CampaignCheckpoint, *,
                                 stop_after_round: Optional[int] = None
                                 ) -> Tuple[Optional[List[List[RunStats]]],
                                            List[CampaignCheckpoint]]:
        """Continue a campaign from a checkpoint; the completed campaign's
        stats (and decision traces) match an uninterrupted run exactly."""
        assert ckpt.kind == "adaptive", "use resume_arrival_campaign"
        if ckpt.obs_state is not None and obs.enabled():
            # rewind the registry + recorder to checkpoint time so the
            # resumed campaign's span/metric stream continues exactly
            # where the checkpointed one left off (trace identity)
            obs.restore(ckpt.obs_state)
        obs.emit("restore", kind="adaptive", run_idx=ckpt.run_idx,
                 round_idx=ckpt.round_idx, mid_run=ckpt.mid_run)
        self.service.restore_state(ckpt.service_state)
        all_stats = copy.deepcopy(ckpt.all_stats)
        if not ckpt.mid_run:
            for i, entry in enumerate(ckpt.exps):
                self.experiments[i].restore_state(entry["state"])
            return self._campaign_loop(
                ckpt.n_runs, ckpt.method, ckpt.inject_failures,
                ckpt.checkpoint_every, stop_after_round,
                run_idx=ckpt.run_idx, round_idx=ckpt.round_idx,
                all_stats=all_stats, ckpts=[])
        stats, gens, pending, runstart, logs = {}, {}, {}, {}, {}
        for i, entry in enumerate(ckpt.exps):
            if entry["log"] is None:           # finished before checkpoint
                self.experiments[i].restore_state(entry["state"])
                stats[i] = copy.deepcopy(entry["stats"])
            else:
                gens[i], pending[i] = self._replay_exp(
                    i, entry, ckpt.method, ckpt.inject_failures)
                runstart[i] = entry["state"]
                logs[i] = list(entry["log"])
        return self._campaign_loop(
            ckpt.n_runs, ckpt.method, ckpt.inject_failures,
            ckpt.checkpoint_every, stop_after_round, run_idx=ckpt.run_idx,
            round_idx=ckpt.round_idx, all_stats=all_stats, ckpts=[],
            gens=gens, pending=pending, stats=stats, runstart=runstart,
            logs=logs)

    def adaptive_campaign_resilient(self, n_runs: int, method: str = "enel",
                                    inject_failures: bool = False, *,
                                    crash_rounds: Sequence[int] = (),
                                    checkpoint_every: int = 1
                                    ) -> Tuple[List[List[RunStats]], int]:
        """Run a campaign through a schedule of simulated controller
        crashes, restoring from the latest checkpoint after each one.
        Returns ``(stats, n_restores)``; stats match an uninterrupted
        campaign exactly."""
        crash_rounds = sorted(int(r) for r in crash_rounds)
        k = 0
        stop = crash_rounds[k] if k < len(crash_rounds) else None
        stats, ckpts = self.adaptive_campaign(
            n_runs, method, inject_failures,
            checkpoint_every=checkpoint_every, stop_after_round=stop)
        latest = list(ckpts)
        restores = 0
        while stats is None:
            restores += 1
            k += 1
            stop = crash_rounds[k] if k < len(crash_rounds) else None
            stats, ckpts = self.resume_adaptive_campaign(
                latest[-1], stop_after_round=stop)
            latest.extend(ckpts)
        return stats, restores

    # ------------------------------------------------------- fused campaigns
    def fused_campaign(self, n_runs: int, method: str = "enel",
                       inject_failures: bool = False, *,
                       write_back: bool = True,
                       checkpoint_every_runs: int = 0,
                       plan=None
                       ) -> Tuple[List[List[RunStats]], FusedReport]:
        """``n_runs`` adaptive runs of the whole fleet through the fused
        step body, enqueued without a host synchronisation.

        The stepped path (:meth:`adaptive_campaign`) re-enters Python
        between every component and reads every result on the host; this
        runs the entire campaign (sim step, ring append, decision sweep and
        per-run resident fit) through ``repro_torch.core.campaign_kernel``
        and materializes the traces once at the end.  Decisions are guarded
        in the step: a non-finite sweep falls back to the model-free pick
        and a non-finite pick is clamped to the current scale-out (counted
        in ``report.nonfinite``).

        ``checkpoint_every_runs=k`` splits the campaign every k runs and
        snapshots the carry (:class:`FusedCheckpoint`); resume with
        :meth:`resume_fused_campaign` for traces identical to an
        uninterrupted campaign.  ``write_back=True`` syncs the final
        model, ring and backend state into the experiments, so stepped
        runs can continue after a fused campaign.
        """
        assert method == "enel", "the fused step body sweeps Enel's model"
        from repro_torch.core import campaign_kernel as ck
        if plan is None:
            plan = ck.build_plan(self.experiments, n_runs,
                                 inject_failures=inject_failures)
        carry = ck.init_carry(plan)
        return self._fused_drive(ck, plan, carry, start=0, pieces=[],
                                 ckpts=[],
                                 checkpoint_every_runs=checkpoint_every_runs,
                                 write_back=write_back)

    def resume_fused_campaign(self, plan, ckpt: FusedCheckpoint, *,
                              write_back: bool = True,
                              checkpoint_every_runs: int = 0
                              ) -> Tuple[List[List[RunStats]], FusedReport]:
        """Continue a fused campaign from a :class:`FusedCheckpoint`; the
        completed campaign's stats match an uninterrupted one exactly."""
        from repro_torch.core import campaign_kernel as ck
        ck.check_fit_calls(plan, ckpt.carry["fit_calls"], ckpt.step)
        if ckpt.obs_state is not None and obs.enabled():
            obs.restore(ckpt.obs_state)
        obs.emit("restore", kind="fused", step=ckpt.step,
                 n_steps=ckpt.n_steps)
        carry = ck.carry_from_host(ckpt.carry, plan.device)
        return self._fused_drive(
            ck, plan, carry, start=ckpt.step, pieces=[ckpt.ys],
            ckpts=[], checkpoint_every_runs=checkpoint_every_runs,
            write_back=write_back)

    def _fused_drive(self, ck, plan, carry, *, start, pieces, ckpts,
                     checkpoint_every_runs, write_back):
        cat = lambda ps: {k: np.concatenate([p[k] for p in ps])
                          for k in ps[0]}
        seg = (checkpoint_every_runs * plan.static.c_max
               if checkpoint_every_runs > 0 else plan.n_steps)
        t = start
        while t < plan.n_steps:
            t1 = min(t + seg, plan.n_steps)
            carry, ys = ck.run_fused(plan, carry, t, t1)
            pieces.append(ys)
            t = t1
            if checkpoint_every_runs > 0 and t < plan.n_steps:
                obs.emit("checkpoint", kind="fused", step=t,
                         n_steps=plan.n_steps)
                ckpts.append(FusedCheckpoint(
                    step=t, n_steps=plan.n_steps,
                    carry=ck.carry_to_host(carry), ys=cat(pieces),
                    obs_state=obs.snapshot() if obs.enabled() else None))
        ys_all = cat(pieces)
        stats = materialize_fused(plan, ys_all)
        carry_h = ck.carry_to_host(carry)
        report = FusedReport(
            plan=plan, carry=carry_h, ys=ys_all,
            fallbacks=np.asarray(carry_h["fallbacks"]),
            nonfinite=np.asarray(carry_h["nonfinite"]), checkpoints=ckpts)
        if write_back:
            self._fused_write_back(plan, carry_h, stats, ys=ys_all)
        return stats, report

    def _fused_write_back(self, plan, carry: Dict,
                          stats: List[List[RunStats]],
                          ys: Optional[Dict] = None) -> None:
        """Sync the campaign's final (host) carry into the experiments:
        model params and Adam state, the resident training ring, run
        counters, per-run stats, and the backend slots' clock and
        interference (the rng streams were already advanced by
        ``campaign_run_blocks``).  The host ``graph_history`` and Enel's
        ``hist_summaries`` are NOT back-filled: a fused campaign trades
        those growing host mirrors for the synchronisation-free path
        (documented deviation)."""
        from repro_torch.core.training import map_params
        if ys is not None and obs.enabled():
            # the telemetry block becomes the span stream the stepped
            # driver would have produced
            from repro_torch.core import campaign_kernel as ck
            ck.replay_spans(plan, ys)
        n_runs = plan.host["n_runs"]
        ring = carry["ring"]
        for j, exp in enumerate(self.experiments):
            tr = exp.trainer
            up = lambda a: torch.tensor(np.asarray(a)[j], device=tr.device)
            mu, nu, t = carry["opt"]
            tr.params = map_params(up, carry["params"])
            tr.opt = (map_params(up, mu), map_params(up, nu), up(t))
            tr._fit_calls = int(carry["fit_calls"][j])
            tr.runs_seen += n_runs
            cache = tr.cache
            cache.buffers = {k: up(v) for k, v in ring["buffers"].items()}
            cache.pos = int(ring["pos"][j])
            cache.count = int(ring["count"][j])
            cache.slot_ok = np.asarray(ring["slot_ok"][j]).copy()
            nc = int(plan.host["n_comp"][j])
            cache.latest = ((cache.pos - nc + np.arange(nc))
                            % cache.capacity).astype(np.int64)
            exp._run_idx += n_runs
            exp.enel.fallback_decisions += int(carry["fallbacks"][j])
            for r in range(n_runs):
                exp.stats.append(stats[r][j])
            st = exp.backend.slot_state(exp.sim_slot)
            st["clock"] = np.float32(carry["clock"][j])
            st["interf"] = np.float32(carry["interf"][j])
            exp.backend.restore_slot(exp.sim_slot, st)

    # ------------------------------------------------------ multi-tenant pool
    def arrival_campaign(self, *, pool_size: int, arrival_rate: float,
                         method: str = "enel", inject_failures: bool = False,
                         seed: int = 0, max_rounds: int = 64,
                         checkpoint_every: int = 0,
                         stop_after_round: Optional[int] = None
                         ) -> Tuple[Optional[List[Optional[RunStats]]],
                                    List[CapacityTrace]]:
        """Poisson arrivals into a bounded executor pool.

        Experiments queue up; each lockstep round admits ``~Poisson(rate)``
        waiting jobs (clamped to the pool headroom: a job needs at least
        the minimum scale-out), runs one interleaved round of every active
        job, and caps every pending decision at the job's current
        allocation plus its fair share of the free pool.  Jobs run one
        adaptive run each and release their executors on completion.

        ``checkpoint_every=k`` snapshots the campaign (including the pool
        state: arrival queue, allocations, Poisson rng, in-flight
        generators) every k rounds into ``self.checkpoints``;
        ``stop_after_round`` simulates a controller crash (returns
        ``(None, trace)``), recoverable via :meth:`resume_arrival_campaign`.
        """
        assert method == "enel", \
            "capacity caps ride the decision-service request path, which " \
            "only Enel uses (Ellis decides inline in the runner)"
        rng = np.random.RandomState(seed)
        self.checkpoints: List[CampaignCheckpoint] = []
        return self._arrival_loop(
            pool_size=pool_size, arrival_rate=arrival_rate, method=method,
            inject_failures=inject_failures, max_rounds=max_rounds,
            checkpoint_every=checkpoint_every,
            stop_after_round=stop_after_round, rng=rng,
            waiting=list(range(len(self.experiments))), gens={}, pending={},
            alloc={}, stats_d={}, trace=[], round0=0, runstart={}, logs={})

    def resume_arrival_campaign(self, ckpt: CampaignCheckpoint
                                ) -> Tuple[Optional[List[Optional[RunStats]]],
                                           List[CapacityTrace]]:
        """Continue an arrival campaign from a checkpoint; the completed
        campaign's stats and capacity trace match an uninterrupted run."""
        assert ckpt.kind == "arrival", "use resume_adaptive_campaign"
        if ckpt.obs_state is not None and obs.enabled():
            obs.restore(ckpt.obs_state)
        obs.emit("restore", kind="arrival", run_idx=ckpt.run_idx,
                 round_idx=ckpt.round_idx, mid_run=ckpt.mid_run)
        self.service.restore_state(ckpt.service_state)
        ex = copy.deepcopy(ckpt.extra)
        rng = np.random.RandomState(0)
        rng.set_state(ex["rng"])
        gens, pending, runstart, logs = {}, {}, {}, {}
        for i, entry in enumerate(ckpt.exps):
            if entry["log"] is None:
                self.experiments[i].restore_state(entry["state"])
            else:
                gens[i], pending[i] = self._replay_exp(
                    i, entry, ckpt.method, ckpt.inject_failures)
                runstart[i] = entry["state"]
                logs[i] = list(entry["log"])
        self.checkpoints = []
        return self._arrival_loop(
            pool_size=ex["pool_size"], arrival_rate=ex["arrival_rate"],
            method=ckpt.method, inject_failures=ckpt.inject_failures,
            max_rounds=ex["max_rounds"],
            checkpoint_every=ckpt.checkpoint_every, stop_after_round=None,
            rng=rng, waiting=ex["waiting"], gens=gens, pending=pending,
            alloc=ex["alloc"], stats_d=ex["stats_d"], trace=ex["trace"],
            round0=ckpt.round_idx, runstart=runstart, logs=logs)

    def _arrival_loop(self, *, pool_size, arrival_rate, method,
                      inject_failures, max_rounds, checkpoint_every,
                      stop_after_round, rng, waiting, gens, pending, alloc,
                      stats_d, trace, round0, runstart, logs):
        checkpointing = checkpoint_every > 0
        s_min = SCALEOUT_RANGE[0]

        def admit(row: CapacityTrace):
            n = int(rng.poisson(arrival_rate)) if arrival_rate > 0 \
                else len(waiting)
            for _ in range(n):
                if not waiting:
                    return
                free = pool_size - sum(alloc.values())
                if free < s_min:
                    return
                i = waiting.pop(0)
                exp = self.experiments[i]
                exp.scale_cap = free          # clamps the initial allocation
                if checkpointing:             # run-start snapshot for replay
                    runstart[i] = exp.snapshot_state()
                    logs[i] = []
                gens[i] = exp.adaptive_run_gen(method, inject_failures)
                try:
                    pending[i] = next(gens[i])
                except StopIteration as stop:
                    stats_d[i] = stop.value
                    continue
                alloc[i] = int(getattr(pending[i], "end_scaleout", s_min))
                row.arrivals += 1

        for round_idx in range(round0, max_rounds):
            row = CapacityTrace(round_idx, 0, 0, pool_size)
            admit(row)
            if not pending and not waiting:
                break
            for i, r in pending.items():      # granted picks take effect
                if isinstance(r, SimStepRequest):
                    alloc[i] = int(r.end_scaleout)
            dec_ids = [i for i, r in pending.items()
                       if not isinstance(r, SimStepRequest)]
            caps = None
            if dec_ids:
                free = max(0, pool_size - sum(alloc.values()))
                share = free // len(dec_ids)
                caps = {i: alloc.get(i, s_min) + share for i in dec_ids}

            def grant(i, res):                # reserve the pick immediately
                alloc[i] = int(res.scaleout)  # <= caps[i]: range floor 4 is
                # always a candidate, so apply_capacity's fallback (which
                # could exceed a sub-floor cap) cannot trigger here

            on_result = None
            if checkpointing:
                on_result = lambda i, res: logs[i].append(res)
            pending, capped, done = self._round(gens, pending, stats_d,
                                                caps=caps, on_decision=grant,
                                                on_result=on_result)
            row.capped_decisions = capped
            for i in done:                    # job done: release executors
                alloc.pop(i, None)
                self.experiments[i].scale_cap = None
            row.active = len(pending)
            row.pool_used = sum(alloc.values())
            trace.append(row)
            assert row.pool_used <= pool_size, "capacity model oversubscribed"
            rounds_done = round_idx + 1
            if checkpointing and rounds_done % checkpoint_every == 0:
                extra = {"pool_size": pool_size,
                         "arrival_rate": arrival_rate,
                         "max_rounds": max_rounds, "rng": rng.get_state(),
                         "waiting": list(waiting), "alloc": dict(alloc),
                         "stats_d": stats_d, "trace": trace}
                exps = []
                for i, exp in enumerate(self.experiments):
                    if i in pending:
                        exps.append({
                            "state": runstart[i], "log": list(logs[i]),
                            "backend_now":
                                exp.backend.slot_state(exp.sim_slot),
                            "stats": None})
                    else:
                        exps.append({"state": exp.snapshot_state(),
                                     "log": None, "backend_now": None,
                                     "stats": None})
                self.checkpoints.append(CampaignCheckpoint(
                    kind="arrival", method=method,
                    inject_failures=inject_failures, n_runs=1, run_idx=0,
                    round_idx=rounds_done,
                    checkpoint_every=checkpoint_every,
                    mid_run=bool(pending), exps=exps, all_stats=[],
                    service_state=self.service.snapshot_state(),
                    extra=copy.deepcopy(extra)))
            if stop_after_round is not None and \
                    rounds_done >= stop_after_round:
                return None, trace            # simulated controller crash
        for exp in self.experiments:          # max_rounds may strand actives
            exp.scale_cap = None
        stats = [stats_d.get(i) for i in range(len(self.experiments))]
        return stats, trace
