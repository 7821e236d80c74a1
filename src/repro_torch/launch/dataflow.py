"""The paper's experiment, in miniature: profile a Spark-MLlib-style job,
then run adaptive runs with Enel and Ellis, with a failure phase.

    PYTHONPATH=src python -m repro_torch.launch.dataflow [--job kmeans]
        [--runs 6] [--profiling 6] [--device cpu] [--engine batched]
    PYTHONPATH=src python -m repro_torch.launch.dataflow --fleet 8

Counterpart of ``examples/enel_dataflow.py``, with its arguments.
``--fleet N`` runs a fleet campaign instead: N experiments over the four
job classes in turn (LR, MPC, K-Means, GBT; seeds ``--seed``,
``--seed + 1``, ... for each class), each profiled, then ``--runs``
lockstep Enel runs of all of them behind one shared ``DecisionService``,
failures injected in the last two.  ``--engine batched`` simulates the
cluster on the vectorized engine (one ``sim_step`` launch per component
step, every experiment of a fleet on one shared engine) instead of the
per-job numpy event loop; both give the same records.  Runs on the card
unless ``--device cpu``.
"""
from __future__ import annotations

import argparse

JOB_CLASSES = ("lr", "mpc", "kmeans", "gbt")


def single(args) -> None:
    from repro_torch.dataflow import JobExperiment, window_stats

    exp = JobExperiment(args.job, seed=args.seed, device=args.device,
                        engine=args.engine)
    print(f"profiling {args.profiling} runs ...")
    exp.profile(args.profiling)
    print(f"runtime target: {exp.target:.0f}s")
    for i in range(args.runs):
        anomalous = i >= args.runs - 2          # failure phase at the end
        st_e = exp.adaptive_run("enel", inject_failures=anomalous)
        st_l = exp.adaptive_run("ellis", inject_failures=anomalous)
        tag = "ANOMALOUS" if anomalous else "normal   "
        print(f"[{tag}] enel: rt={st_e.runtime:6.0f}s "
              f"viol={st_e.violation:5.0f}s scale-outs={st_e.scaleouts} | "
              f"ellis: rt={st_l.runtime:6.0f}s viol={st_l.violation:5.0f}s")
    ws = window_stats(exp.stats, 1, 10_000)
    print(f"overall: CVC mean={ws['cvc_mean']:.2f} "
          f"CVS mean={ws['cvs_mean']:.2f} min")


def fleet(args) -> None:
    from repro_torch.core.service import DecisionService
    from repro_torch.dataflow import (FleetCampaign, JobExperiment,
                                      window_stats)

    exps = [JobExperiment(JOB_CLASSES[i % 4], seed=args.seed + i // 4,
                          device=args.device) for i in range(args.fleet)]
    camp = FleetCampaign(exps, DecisionService(),
                         engine="batched" if args.engine == "batched"
                         else None)
    print(f"profiling {args.profiling} runs of {len(exps)} experiments ...")
    camp.profile(args.profiling)
    for i in range(args.runs):
        anomalous = i >= args.runs - 2
        stats, _ = camp.adaptive_campaign(1, "enel", anomalous)
        tag = "ANOMALOUS" if anomalous else "normal   "
        for ex, st in zip(exps, stats[0]):
            print(f"[{tag}] {ex.job.name:8s} seed {ex.seed}: "
                  f"rt={st.runtime:6.0f}s viol={st.violation:5.0f}s "
                  f"scale-outs={st.scaleouts}")
    svc = camp.service
    print(f"service: {svc.decisions} decisions in {svc.dispatches} "
          f"dispatches ({svc.batched_away} batched away)")
    for ex in exps:
        ws = window_stats(ex.stats, 1, 10_000)
        print(f"{ex.job.name:8s} seed {ex.seed}: CVC mean="
              f"{ws['cvc_mean']:.2f} CVS mean={ws['cvs_mean']:.2f} min")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--job", default="kmeans", choices=list(JOB_CLASSES))
    ap.add_argument("--runs", type=int, default=6)
    ap.add_argument("--profiling", type=int, default=6)
    ap.add_argument("--fleet", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--engine", default="numpy", choices=("numpy", "batched"),
                    help="cluster simulator: the per-job numpy event loop "
                         "or the vectorized engine (one sim_step launch per "
                         "step; a fleet shares one)")
    args = ap.parse_args(argv)
    if args.fleet > 0:
        fleet(args)
    else:
        single(args)


if __name__ == "__main__":
    main()
