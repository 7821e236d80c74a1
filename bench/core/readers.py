"""Helpers of the per-layer metric readers (``bench/metrics``)."""
from __future__ import annotations

from typing import Dict, Optional, Sequence

from bench.core.trace import busy_in
from bench.work.flops import attention_work, least_seconds
from bench.work.peaks import BF16_FLOPS, HBM_BYTES


def attention_roofline(rec: Dict, kernels: Sequence[str]) -> Optional[float]:
    """Percent: the least time of the traced ``flash_attention`` calls (at
    the shapes the program reported) over the device time of the kernels
    named ``kernels``; None where either is missing."""
    tr = rec.get("trace")
    if not tr:
        return None
    least = 0.0
    for name, reads, _, opts in tr["reports"]:
        if name != "flash_attention":
            continue
        (b, sq, h, d), elt = reads[0]
        sk, kh = reads[1][0][1], reads[1][0][2]
        least += least_seconds(*attention_work(
            b, sq, sk, h, kh, d, opts.get("causal", True), elt),
            BF16_FLOPS, HBM_BYTES)
    spent = sum(b - a for n, a, b in tr["kernels"]
                if any(k in n for k in kernels)
                and a >= tr["lo"] and b <= tr["hi"])
    if not least or not spent:
        return None
    return 100.0 * least / spent


def idle_share(rec: Dict, intervals_key: Optional[str] = None
               ) -> Optional[float]:
    """Percent of the traced stretch (or of its ``intervals_key``
    intervals) in which no device operation ran."""
    tr = rec.get("trace")
    if not tr:
        return None
    spans = tr[intervals_key] if intervals_key else [(tr["lo"], tr["hi"])]
    total = sum(b - a for a, b in spans)
    busy = sum(busy_in(tr["kernels"], a, b) for a, b in spans)
    if not total or not busy:
        return None
    return 100.0 * (1.0 - busy / total)
