"""Time the fused campaign's two drivers in alternating order on one card.

    python tools/fused_campaign_timing.py [--reps 2]

Builds ``chip_smoke.py`` phase 20's fleet (8 experiments, ``profile(3)``,
two live rounds, ``nan_fit`` chaos on K-Means SEED + 1) and one plan of 3
runs, then drives that plan ``--reps`` times in the order run_fused,
run_stepped, run_stepped, run_fused, so that a warm-up or a drift of the
card shows; each ``run_fused`` once under
``torch.cuda.set_sync_debug_mode("error")`` and once without.  Each line
gives the driver's wall seconds, the host's median enqueue ms per step
without a fit and mean ms per Adam step in the fit steps, and the caching
allocator's ``cudaMalloc`` calls and retries during the run
(``torch.cuda.memory_stats``).  Every run's outputs must equal the first
run's bit for bit.  Prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=2,
                    help="times through the four-run order")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a card")
        return 1
    import chip_smoke
    from repro_torch.core import campaign_kernel as ck
    from repro_torch.kernels.graph_prop import ops
    from repro_torch.kernels.sim_step import ops as ss
    torch.backends.cuda.matmul.allow_tf32 = False
    ops._kernel_fn(), ops._bwd_kernel_fn(), ss._kernel_fn()
    card = chip_smoke.card_line()
    print(card, flush=True)
    torch.set_grad_enabled(False)       # as the smoke has it by phase 20
    device = torch.device("cuda")
    camp = chip_smoke.fused_fleet(device)
    base = [ex.snapshot_state() for ex in camp.experiments]
    chip_smoke.fused_twin(camp, base)
    plan = ck.build_plan(camp.experiments, chip_smoke.FUSED_RUNS)
    first = None
    order = [("fused", True), ("stepped", False), ("stepped", False),
             ("fused", False)]
    for rep in range(args.reps):
        for name, strict in order:
            driver = ck.run_fused if name == "fused" else ck.run_stepped
            torch.cuda.synchronize()
            m0 = torch.cuda.memory_stats()
            _, ys, wall, step_ms, adam_ms = chip_smoke.timed_drive(
                plan, driver, strict)
            m1 = torch.cuda.memory_stats()
            if first is None:
                first = ys
            assert all(np.array_equal(first[k], ys[k], equal_nan=True)
                       for k in first), "outputs differ between runs"
            print(json.dumps({
                "rep": rep, "driver": name, "sync_debug_error": strict,
                "wall_s": wall, "enqueue_ms_per_step": step_ms,
                "ms_per_adam_step": adam_ms,
                "cuda_mallocs": m1["segment.all.allocated"]
                - m0["segment.all.allocated"],
                "alloc_retries": m1["num_alloc_retries"]
                - m0["num_alloc_retries"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
