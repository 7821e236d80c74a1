"""ttft_p95_ms: the 95th percentile, over every request of the window, of
the time from its wave's hand-off to its first token on the host."""
import numpy as np


def read(rec):
    if not rec.get("ttft"):
        return None
    return 1e3 * float(np.percentile(rec["ttft"], 95))
