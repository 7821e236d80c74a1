"""train_mfu: model FLOPs of the window's steps (the frozen formula) over
their synced host time, as a percent of the H100's bf16 peak."""
from bench.work.peaks import BF16_FLOPS


def read(rec):
    if not rec.get("steps"):
        return None
    busy = sum(b - a for a, b, _ in rec["steps"])
    return 100.0 * rec["step_flops"] * len(rec["steps"]) / busy / BF16_FLOPS
