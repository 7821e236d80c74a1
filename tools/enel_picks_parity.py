"""Enel's picks, reference against port, run by run, on the CPU.

Both packages run ``JobExperiment`` on one job under ``chip_smoke.py``'s
training protocol (``run_training``): 10 profiling runs and the scratch fit,
6 adaptive Enel runs (the 5th retrains from scratch), one Enel run with
failures injected and one Ellis run.  The port gets the reference's
auto-encoder weights and initial parameters, and both fits run without
metric dropout (the reference draws its masks from ``jax.random``, which the
port cannot reproduce), as ``tests/test_torch_runner.py`` sets them up.

Every Enel decision's pick and per-candidate totals are kept on both sides.
A run's picks either all agree, or the first decision where they differ is
printed with its margin: over the candidates whose compliance (total <=
target) differs between the two, the largest distance of their totals from
the target, relative to it (where none does, the two picks' totals apart).
The runs after a differing pick start from other scale-outs and are compared
only as far as their picks go.  The last line is a JSON summary.

    PYTHONPATH=src python tools/enel_picks_parity.py [--jobs lr mpc gbt]

Needs JAX (the reference) and runs on the CPU; a job takes a few minutes.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import model as jmodel  # noqa: E402
from repro.dataflow import runner as jrunner  # noqa: E402
from repro_torch.convert import enel_params_from_numpy  # noqa: E402
from repro_torch.dataflow import runner  # noqa: E402

PLAN = [("enel", False)] * 6 + [("enel", True), ("ellis", False)]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _no_dropout(trainer):
    fit = trainer.fit_resident
    trainer.fit_resident = lambda **kw: fit(**dict(kw, metric_dropout=0.0))


def _keep(decisions, fn):
    """``fn`` (returning (pick, predicted, totals)) that also appends the
    triple to ``decisions``."""
    def wrapped(*args, **kw):
        out = fn(*args, **kw)
        decisions.append((int(out[0]), dict(out[2])))
        return out
    return wrapped


def margin(ref_totals, port_totals, ref_pick, port_pick, target):
    """How close a differing pick sits to a rounding flip, relative to the
    target (see the module docstring)."""
    flipped = [s for s in ref_totals if s in port_totals and
               (ref_totals[s] <= target) != (port_totals[s] <= target)]
    if flipped:
        return max(max(abs(ref_totals[s] - target),
                       abs(port_totals[s] - target))
                   for s in flipped) / abs(target)
    return abs(port_totals[port_pick] - port_totals[ref_pick]) / abs(target)


def compare_job(key: str, seed: int = 0) -> dict:
    t0 = time.perf_counter()
    jex = jrunner.JobExperiment(key, seed=seed)
    ex = runner.JobExperiment(key, seed=seed, device="cpu",
                              ae_params=_np(jex.encoder.ae_params))
    init = _np(jmodel.init_enel(jax.random.PRNGKey(seed)))
    ex.trainer.init_params = enel_params_from_numpy(init, device="cpu")
    ex.trainer.params = enel_params_from_numpy(init, device="cpu")
    _no_dropout(jex.trainer)
    _no_dropout(ex.trainer)
    jdec, dec = [], []
    jex.enel.apply_decision = _keep(jdec, jex.enel.apply_decision)
    ex.enel.apply_decision = _keep(dec, ex.enel.apply_decision)
    jex.profile()
    ex.profile()
    out = {"job": key, "target": [float(jex.target), float(ex.target)],
           "runs": []}
    print(f"{key}: target reference {jex.target:.6f} s, port "
          f"{ex.target:.6f} s", flush=True)
    for method, inject in PLAN:
        n0, m0 = len(jdec), len(dec)
        jst = jex.adaptive_run(method, inject_failures=inject)
        st = ex.adaptive_run(method, inject_failures=inject)
        run = {"method": method, "failures": inject,
               "scaleouts": [jst.scaleouts, st.scaleouts],
               "runtime": [float(jst.runtime), float(st.runtime)],
               "decisions": [len(jdec) - n0, len(dec) - m0], "first_diff": None}
        worst = 0.0
        for d, ((jp, jt), (pp, pt)) in enumerate(zip(jdec[n0:], dec[m0:])):
            common = [s for s in jt if s in pt]
            worst = max([worst] + [abs(pt[s] - jt[s]) / abs(jt[s])
                                   for s in common if jt[s]])
            if jp != pp:
                mg = margin(jt, pt, jp, pp, jex.target)
                run["first_diff"] = {"decision": d, "reference": jp,
                                     "port": pp, "margin": mg,
                                     "reference_total": jt[jp],
                                     "port_total": pt[pp]}
                break
        run["totals_max_rel_diff"] = worst
        out["runs"].append(run)
        same = jst.scaleouts == st.scaleouts
        diff = run["first_diff"]
        print(f"  {method:5s} failures={inject!s:5s}: picks "
              f"{'agree' if same and diff is None else 'DIFFER'} "
              f"({run['decisions'][0]} / {run['decisions'][1]} decisions, "
              f"totals within {worst:.2g} relative); runtime reference "
              f"{jst.runtime:.2f} s, port {st.runtime:.2f} s"
              + ("" if diff is None else
                 f"; first at decision {diff['decision']}: reference "
                 f"{diff['reference']} ({diff['reference_total']:.6f} s), "
                 f"port {diff['port']} ({diff['port_total']:.6f} s), "
                 f"margin {diff['margin']:.3g} of the target"), flush=True)
    out["seconds"] = time.perf_counter() - t0
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--jobs", nargs="+", default=["lr", "mpc", "gbt"])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    results = [compare_job(key, args.seed) for key in args.jobs]
    print(json.dumps({"picks_parity": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
