"""Cross-context evaluation harness: scenario x job target-compliance grid
plus the paper's model-reuse claim as measurable transfer cells.

Entry points, each emitting benchmark-JSON-ready rows:

* :func:`run_scenario_campaign` — one disturbance scenario over a fleet of
  jobs driven through :class:`~repro_torch.dataflow.fleet.FleetCampaign`
  (profiling -> adaptive runs, decisions cross-batched, simulation on the
  vectorized engine by default).  The ``multi_tenant`` scenario routes
  through :meth:`FleetCampaign.arrival_campaign` instead: Poisson arrivals
  into a bounded executor pool with capacity-capped picks.
* :func:`run_chaos_campaign` — one controller-chaos scenario: faults on the
  control plane after a clean profile, crashes recovered from checkpoints;
  :func:`chaos_trace_identity` checks that a crashed and restored campaign
  reproduces the uninterrupted trace.
* :func:`run_transfer_cells` — train the Enel model under execution context
  A (scenario, dataset size), then deploy it under context B WITHOUT a
  scratch retrain (only target calibration + the runner's normal online
  fine-tune cadence), and measure target compliance in the deploy context
  ("one model can be reused across different execution contexts", §I/§VI;
  evaluation style after C3O's cross-context runtime prediction).

Each takes a ``device`` (the card by default); every experiment of a call
lives on it, and the batched engine launches its ``sim_step`` kernel there.
Counterpart of ``repro.sim.evaluate``.
"""
from __future__ import annotations

import time
from typing import Dict, List, Sequence

import numpy as np

from repro_torch import obs
from repro_torch.dataflow.fleet import FleetCampaign
from repro_torch.dataflow.runner import JobExperiment, RunStats
from repro_torch.dataflow.workloads import SCALEOUT_RANGE
from repro_torch.device import DeviceLike
from repro_torch.sim.chaos import make_dispatch_chaos, make_injector
from repro_torch.sim.engine import BatchedClusterSim
from repro_torch.sim.scenarios import make_scenario

DEFAULT_JOBS = ("lr", "mpc", "kmeans", "gbt")
DEFAULT_SCENARIOS = ("baseline", "node_failure", "stragglers",
                     "spot_preemption", "interference_burst",
                     "data_skew_drift")
CHAOS_SCENARIOS = ("chaos_observations", "chaos_model", "chaos_timeouts",
                   "chaos_crashes")
# (train_scenario, train_size) -> (deploy_scenario, deploy_size) per job
DEFAULT_TRANSFER_CELLS = (
    ("baseline", 1.0, "node_failure", 1.0, "kmeans"),
    ("baseline", 1.0, "interference_burst", 1.0, "gbt"),
    ("baseline", 1.0, "baseline", 1.6, "kmeans"),
    ("node_failure", 1.0, "stragglers", 1.25, "gbt"),
)


def _adaptive_rows(stats: Sequence[RunStats]) -> Dict:
    sel = [s for s in stats if s is not None and s.kind not in ("profiling",)]
    if not sel:
        return {"runs": 0}
    cvc = np.array([s.cvc for s in sel], float)
    cvs = np.array([s.violation / 60.0 for s in sel], float)
    return {"runs": len(sel),
            "compliance": float(1.0 - cvc.mean()),
            "cvs_mean_min": float(cvs.mean()),
            "rescales_mean": float(np.mean([s.n_rescales for s in sel])),
            "failures_total": int(sum(s.n_failures for s in sel)),
            "runtime_mean_s": float(np.mean([s.runtime for s in sel])),
            "target_s": float(sel[0].target)}


def _fleet(scenario, job_keys, engine, seed, candidate_stride, device):
    """Experiments over ``job_keys`` (seeds ``seed``, ``seed + 1``, ...)
    behind one campaign; with ``engine="batched"`` they share one
    vectorized engine, handed to every experiment up front."""
    shared = BatchedClusterSim(device=device) if engine == "batched" \
        else None
    exps = [JobExperiment(k, seed=seed + i, scenario=scenario,
                          candidate_stride=candidate_stride, engine=engine,
                          backend=shared, device=device)
            for i, k in enumerate(job_keys)]
    return exps, FleetCampaign(exps)


def run_scenario_campaign(scenario_name: str,
                          job_keys: Sequence[str] = DEFAULT_JOBS, *,
                          engine: str = "batched", seed: int = 0,
                          profile_runs: int = 3, adaptive_runs: int = 3,
                          candidate_stride: int = 2,
                          device: DeviceLike = "cuda") -> List[Dict]:
    """Run one scenario over a job fleet; returns one row per job plus a
    scenario summary row (fleet decisions/sec, wall time)."""
    sc = make_scenario(scenario_name, seed=seed)
    exps, campaign = _fleet(sc, job_keys, engine, seed, candidate_stride,
                            device)
    campaign.profile(profile_runs)
    t0 = time.time()
    if sc.pool_size > 0:                       # multi-tenant capacity model
        stats, trace = campaign.arrival_campaign(
            pool_size=sc.pool_size, arrival_rate=sc.arrival_rate,
            inject_failures=sc.inject_failures, seed=seed)
        per_exp = [[st] for st in stats]
        extra = {"pool_size": sc.pool_size,
                 "max_pool_used": max((t.pool_used for t in trace),
                                      default=0),
                 "capped_decisions": sum(t.capped_decisions for t in trace),
                 "rounds": len(trace)}
    else:
        per_exp = [[] for _ in exps]
        for _ in range(adaptive_runs):
            for st, acc in zip(campaign.adaptive_round(
                    "enel", inject_failures=sc.inject_failures), per_exp):
                acc.append(st)
        extra = {}
    wall = time.time() - t0
    decisions = sum(st.decide_calls for acc in per_exp for st in acc
                    if st is not None)
    rows = []
    for exp, acc in zip(exps, per_exp):
        row = {"scenario": scenario_name, "job": exp.job_key,
               "engine": engine, "seed": seed}
        row.update(_adaptive_rows(acc))
        rows.append(row)
    rows.append({"scenario": scenario_name, "job": "__fleet__",
                 "engine": engine, "seed": seed, "fleet_size": len(exps),
                 "wall_s_adaptive": wall,
                 "decisions": decisions,
                 "decisions_per_s": decisions / max(wall, 1e-9), **extra})
    return rows


def _robustness_cols(stats: Sequence[RunStats]) -> Dict:
    """Fault-handling aggregates over one experiment's adaptive runs."""
    sel = [s for s in stats if s is not None and s.kind != "profiling"]
    decisions = sum(s.decide_calls for s in sel)
    bad = 0
    for s in sel:
        for z in (s.scaleouts or ()):
            zf = float(z)
            ok = np.isfinite(zf) and \
                SCALEOUT_RANGE[0] <= zf <= SCALEOUT_RANGE[1]
            bad += not ok
    fb = sum(s.fallback_decisions for s in sel)
    return {"decisions": decisions,
            "fallback_decisions": fb,
            "fallback_rate": fb / max(decisions, 1),
            "retries": sum(s.retries for s in sel),
            "breaker_trips": sum(s.breaker_trips for s in sel),
            "shed_requests": sum(s.shed_requests for s in sel),
            "nonfinite_decisions": int(bad)}


def run_chaos_campaign(scenario_name: str,
                       job_keys: Sequence[str] = DEFAULT_JOBS, *,
                       engine: str = "batched", seed: int = 0,
                       profile_runs: int = 3, adaptive_runs: int = 6,
                       candidate_stride: int = 2,
                       device: DeviceLike = "cuda") -> List[Dict]:
    """One controller-chaos scenario over a job fleet: profile cleanly,
    then run the adaptive campaign with the scenario's fault plan attached
    to the control plane (observation poisoning + cache corruption + model
    poisoning per experiment, dispatch timeouts at the service, controller
    crashes recovered from checkpoints).  Returns one row per job plus a
    fleet summary row with injected-fault and recovery counters."""
    sc = make_scenario(scenario_name, seed=seed)
    spec = sc.chaos
    exps, campaign = _fleet(sc, job_keys, engine, seed, candidate_stride,
                            device)
    campaign.profile(profile_runs)
    # faults start AFTER profiling: the control plane degrades mid-flight,
    # it does not start broken
    for exp in exps:
        exp.chaos = make_injector(spec, exp.seed)
    campaign.service.fault_injector = make_dispatch_chaos(spec)
    t0 = time.time()
    restores = 0
    if spec.crash_rounds:
        all_stats, restores = campaign.adaptive_campaign_resilient(
            adaptive_runs, "enel", sc.inject_failures,
            crash_rounds=spec.crash_rounds, checkpoint_every=1)
    else:
        all_stats, _ = campaign.adaptive_campaign(
            adaptive_runs, "enel", sc.inject_failures)
    wall = time.time() - t0
    per_exp = [[run[i] for run in all_stats] for i in range(len(exps))]
    rows = []
    for exp, acc in zip(exps, per_exp):
        row = {"scenario": scenario_name, "chaos": spec.name,
               "job": exp.job_key, "engine": engine, "seed": seed}
        row.update(_adaptive_rows(acc))
        row.update(_robustness_cols(acc))
        if exp.chaos is not None:
            row.update(exp.chaos.snapshot())
        rows.append(row)
    svc = campaign.service
    fleet = {"scenario": scenario_name, "chaos": spec.name,
             "job": "__fleet__", "engine": engine, "seed": seed,
             "fleet_size": len(exps), "wall_s_adaptive": wall,
             "restores": restores,
             "quarantined_rows": sum(
                 exp.trainer.cache.quarantined for exp in exps
                 if exp.trainer.cache is not None),
             "poisoned_fits": sum(exp.trainer.poisoned_fits
                                  for exp in exps)}
    # the service counters live in the metrics registry; ``stats()`` reads
    # this service's series
    fleet.update({f"svc_{k}": v for k, v in svc.stats().items()})
    if svc.fault_injector is not None:
        fleet["injected_timeouts"] = svc.fault_injector.timeouts
    if obs.enabled():
        fleet["controller_health"] = obs.registry().rows(prefix="enel_")
    rows.append(fleet)
    return rows


def chaos_trace_identity(job_keys: Sequence[str] = ("kmeans", "gbt"), *,
                         seed: int = 0, adaptive_runs: int = 4,
                         crash_rounds: Sequence[int] = (2, 5),
                         device: DeviceLike = "cuda") -> bool:
    """Acceptance check: a campaign killed at ``crash_rounds`` and restored
    from checkpoints must reproduce the uninterrupted campaign's decision
    trace exactly, WITH chaos active (model poisoning), since injectors
    are deterministic and checkpointed."""
    def build():
        sc = make_scenario("chaos_model", seed=seed)
        exps = [JobExperiment(k, seed=seed + 7 + i, scenario=sc,
                              candidate_stride=4, engine="batched",
                              device=device)
                for i, k in enumerate(job_keys)]
        c = FleetCampaign(exps, engine="batched")
        c.profile(3)
        for exp in exps:
            exp.chaos = make_injector(sc.chaos, exp.seed)
        return c

    def trace(all_stats):
        return [(round(s.runtime, 4), round(s.violation, 4),
                 tuple(s.scaleouts), s.n_failures, s.n_rescales,
                 s.fallback_decisions)
                for run in all_stats for s in run]

    plain, _ = build().adaptive_campaign(adaptive_runs, "enel", True)
    crashed, restores = build().adaptive_campaign_resilient(
        adaptive_runs, "enel", True, crash_rounds=crash_rounds,
        checkpoint_every=1)
    return restores == len(tuple(crash_rounds)) and \
        trace(plain) == trace(crashed)


def run_transfer_cell(train_scenario: str, train_size: float,
                      deploy_scenario: str, deploy_size: float,
                      job_key: str, *, engine: str = "batched",
                      seed: int = 0, profile_runs: int = 3,
                      train_runs: int = 2, calibrate_runs: int = 3,
                      adaptive_runs: int = 3, candidate_stride: int = 2,
                      device: DeviceLike = "cuda") -> Dict:
    """Train under context A, deploy (reuse, no scratch retrain) under
    context B; returns one row with compliance in the deploy context."""
    sc_a = make_scenario(train_scenario, seed=seed)
    train = JobExperiment(job_key, seed=seed, scenario=sc_a,
                          size_scale=train_size, engine=engine,
                          candidate_stride=candidate_stride, device=device)
    train.profile(profile_runs)
    for _ in range(train_runs):
        train.adaptive_run("enel", inject_failures=sc_a.inject_failures)
    sc_b = make_scenario(deploy_scenario, seed=seed + 1)
    deploy = JobExperiment(job_key, seed=seed + 100, scenario=sc_b,
                           size_scale=deploy_size, engine=engine,
                           candidate_stride=candidate_stride,
                           share_models_from=train, device=device)
    # the transplanted model keeps its weights: only the runtime target is
    # calibrated in the new context (plus the normal online fine-tunes)
    deploy.calibrate_target(calibrate_runs)
    stats = [deploy.adaptive_run("enel",
                                 inject_failures=sc_b.inject_failures)
             for _ in range(adaptive_runs)]
    row = {"train_scenario": train_scenario, "train_size": train_size,
           "deploy_scenario": deploy_scenario, "deploy_size": deploy_size,
           "job": job_key, "engine": engine, "seed": seed}
    row.update(_adaptive_rows(stats))
    # prediction quality of the reused model in the NEW context
    pred = [(s.predicted, s.runtime) for s in stats
            if s.predicted is not None]
    if pred:
        row["pred_rel_err_mean"] = float(np.mean(
            [abs(p - r) / max(r, 1e-9) for p, r in pred]))
    return row


def run_transfer_cells(cells=DEFAULT_TRANSFER_CELLS, **kw) -> List[Dict]:
    return [run_transfer_cell(a, sa, b, sb, job, **kw)
            for a, sa, b, sb, job in cells]
