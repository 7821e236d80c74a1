"""What the drivers share: the card's clock and memory, and the traced
stretch's reduction."""
from __future__ import annotations

import time
from typing import Dict

import torch

from bench.core import trace as tr


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def now() -> float:
    return time.perf_counter()


def summarize_trace(tdata: Dict, span_name: str) -> Dict:
    """The traced stretch: from the first ``span_name`` span's start to
    the last one's end; busy seconds, the breakdown."""
    spans = tr.span_bounds(tdata["spans"], span_name)
    lo, hi = spans[0][0], spans[-1][1]
    kernels = [k for k in tdata["kernels"] if k[2] > lo and k[1] < hi]
    return {"lo": lo, "hi": hi, "window_s": hi - lo,
            "busy_s": tr.busy_in(kernels, lo, hi),
            "breakdown": {"device_ops": tr.device_ops(kernels),
                          "idle_gaps": tr.idle_gaps(kernels, tdata["cpu"],
                                                    lo, hi)}}


def kernel_seconds(kernels, names, lo=None, hi=None) -> float:
    """Device seconds of the operations whose name holds one of
    ``names``."""
    return sum(b - a for n, a, b in kernels
               if any(s in n for s in names)
               and (lo is None or (a >= lo and b <= hi)))


def rel_gap(prog, ref, floor) -> float:
    return abs(prog - ref) / max(abs(ref), floor)
