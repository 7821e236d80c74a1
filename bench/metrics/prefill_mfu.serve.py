"""prefill_mfu.serve: model FLOPs of the window's prefilled rows (each
request's own, the frozen formula) over the waves' times to first token,
as a percent of the H100's bf16 peak."""
import math

from bench.work.peaks import BF16_FLOPS


def read(rec):
    waves = [(f, t) for f, t in rec.get("prefill", ()) if math.isfinite(t)]
    if not waves:
        return None
    return 100.0 * sum(f for f, _ in waves) / sum(t for _, t in waves) \
        / BF16_FLOPS
