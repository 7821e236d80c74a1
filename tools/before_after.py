"""Run one measurement in two checkouts, on one card, in one call.

The kernel families' before/after tools (``attention_before_after.py``,
``graph_prop_before_after.py``, ``ssm_kernels_before_after.py``) each
define ``measure(root, args)``, which imports ``chip_smoke`` and the port
from the checkout at ``root`` and returns a dict of numbers, and hand it
to :func:`main`.  :func:`main` prints the card's name and power limit,
then runs ``measure`` in a process of its own for each checkout in the
order other, this, this, other, so that a drift of the card over the run
shows, and prints each run's dict as one JSON line.  ``args.run`` is the
run's place in that order (0-3): a tool can keep a slow reading to the
first two runs.  ``args.save`` names a file in the git-ignored
``build/before_after/<tool>/`` where the run may leave its outputs; with
``compare``, :func:`main` then prints ``{"other_vs_this": compare(saved
file of run 0, saved file of run 1)}``.  The other checkout, e.g. the
parent unpacked with ``git archive`` into a git-ignored directory, must
have ``chip_smoke.py`` at its root.  :func:`jamba` and
:func:`xlstm_prefill` are readings of the serving models that the tools
share.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORDER = ("other", "this", "this", "other")


def main(script: str, doc: str, measure, flags=(), compare=None) -> int:
    """``script`` is the tool's ``__file__``, ``doc`` its docstring,
    ``flags`` its own (flag, help) switches, passed on to every run."""
    ap = argparse.ArgumentParser(description=doc.split("\n")[0])
    ap.add_argument("--other", required=True,
                    help="checkout to hold this one against")
    for flag, text in flags:
        ap.add_argument(flag, action="store_true", help=text)
    ap.add_argument("--measure", help=argparse.SUPPRESS)
    ap.add_argument("--run", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--save", default="", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure:
        root = os.path.abspath(args.measure)
        sys.path[:0] = [root, os.path.join(root, "src")]
        print(json.dumps(measure(root, args)), flush=True)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    out = os.path.join(HERE, "build", "before_after",
                       os.path.splitext(os.path.basename(script))[0])
    os.makedirs(out, exist_ok=True)
    roots = {"other": os.path.abspath(args.other), "this": HERE}
    saves = [os.path.join(out, f"run{i}.pt") for i in range(len(ORDER))]
    passed = [f for f, _ in flags if getattr(args, f[2:].replace("-", "_"))]
    for i, which in enumerate(ORDER):
        cmd = [sys.executable, os.path.abspath(script), "--other",
               roots["other"], "--measure", roots[which], "--run", str(i),
               "--save", saves[i]] + passed
        res = subprocess.run(cmd, capture_output=True, text=True,
                             cwd=roots[which])
        if res.returncode:
            print(res.stdout + res.stderr, flush=True)
            return res.returncode
        print(res.stdout.strip().splitlines()[-1], flush=True)
    if compare is not None:
        print(json.dumps({"other_vs_this": compare(saves[0], saves[1])}),
              flush=True)
    return 0


def jamba(cs, device, teacher_forced: bool, prefill: bool) -> dict:
    """jamba cut to one period at full width, as ``chip_smoke.py`` phase 15
    builds it.  ``teacher_forced``: its bf16 teacher-forced reading (all 8
    layers, B = 2, capacity 16, decode_step vs forward at 768..771 on the
    rows routed alike) and its routing flips.  ``prefill``: the prefill of
    wave 0 (B 8, P 1024), its host wall time (median of 5) and, from a
    profiler trace of 3 calls, its device-busy time, ``mamba_scan``'s part
    of it and its kernels, each per call."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    from repro_torch.models import prefill as lm_prefill
    cfg = dataclasses.replace(get_config(cs.JAMBA_ARCH),
                              n_layers=cs.JAMBA_LAYERS)
    params = init_model(cfg, seed=cs.SEED, device=device)
    toks0 = cs.padded(cs.capped_waves(cfg, cs.JAMBA_TOP)[0])
    out = {}
    if teacher_forced:
        toks = torch.tensor(toks0[:cs.JAMBA_TF_BATCH], device=device)
        cfg16 = dataclasses.replace(cfg,
                                    capacity_factor=cs.JAMBA_TF_CAPACITY)
        err, flip, nflip = cs.routed_teacher_forced(params, cfg16, toks,
                                                    cs.JAMBA_TF_PREFIX)
        kept = ~flip
        out["jamba_bf16_rel_err_routed_alike"] = float(err[kept].max())
        out["jamba_bf16_rel_err_all_rows"] = float(err.max())
        out["jamba_rows_left_out"] = int(flip.sum())
        out["jamba_rows"] = int(flip.numel())
        out["jamba_routings_flipped"] = int(nflip)
    if prefill:
        xt = torch.tensor(toks0, device=device)
        pf = lambda: (lm_prefill(params, cfg, {"tokens": xt},
                                 cache_len=cs.LM_MAX_LEN),
                      torch.cuda.synchronize())
        out["jamba_prefill_wall_ms"] = cs.median_wall_ms(pf, reps=5,
                                                         warmup=1)
        busy, per, kernels = cs.profile_device(pf, reps=3,
                                               names=("mamba_scan",))
        out["jamba_prefill_busy_ms"] = busy
        out["jamba_prefill_mamba_scan_ms"] = per["mamba_scan"]
        out["jamba_prefill_kernels"] = kernels
    del params
    torch.cuda.empty_cache()
    return out


def xlstm_prefill(cs, device) -> dict:
    """Full-width xlstm-350m's prefill of wave 0 (B 8, P 1024), as
    ``chip_smoke.py`` phase 13 times it: host wall time (median of 5) and,
    from a profiler trace of 2 calls, device-busy time, ``mlstm_chunk``'s
    part of it and the kernels, each per call."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_model, prefill
    cfg = get_config(cs.XLSTM_ARCH)
    params = init_model(cfg, seed=cs.SEED, device=device)
    xt = torch.tensor(cs.padded(cs.capped_waves(cfg, cs.XLSTM_TOP)[0]),
                      device=device)
    pf = lambda: (prefill(params, cfg, {"tokens": xt},
                          cache_len=cs.LM_MAX_LEN), torch.cuda.synchronize())
    out = {"xlstm_prefill_wall_ms": cs.median_wall_ms(pf, reps=5, warmup=1)}
    busy, per, kernels = cs.profile_device(pf, reps=2,
                                           names=("mlstm_kernel",))
    out["xlstm_prefill_busy_ms"] = busy
    out["xlstm_prefill_mlstm_chunk_ms"] = per["mlstm_kernel"]
    out["xlstm_prefill_kernels"] = kernels
    del params
    torch.cuda.empty_cache()
    return out
