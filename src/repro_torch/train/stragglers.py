"""Straggler detection + mitigation hooks for the elastic runtime.

Counterpart of ``repro.train.stragglers``, a numpy copy (the port imports
nothing of the reference): the same heartbeats give the same flags,
evictions and severities.

Per-worker-group heartbeats (step completion times) are tracked in rolling
windows; groups whose step time exceeds a robust threshold (median +
k * MAD) are flagged.  The detector feeds two consumers:

  1. Enel's metric vector — ``straggler_severity`` raises the step-time
     jitter metric so the runtime prediction (eq. 4) reflects the slowdown
     and the scaler reacts (scale out / re-mesh around the slow group).
  2. The elastic trainer — ``should_replace`` triggers checkpoint/re-mesh
     exactly like a failure, evicting the slow group (the standard
     large-fleet mitigation: replace, don't wait).
"""
from __future__ import annotations

from collections import defaultdict, deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np


@dataclass
class StragglerConfig:
    window: int = 16              # heartbeats kept per group
    mad_k: float = 5.0            # flag threshold: median + k * MAD
    min_heartbeats: int = 4
    replace_after: int = 3        # consecutive flags before eviction


class StragglerDetector:
    def __init__(self, cfg: StragglerConfig = StragglerConfig()):
        self.cfg = cfg
        self._beats: Dict[int, Deque[float]] = defaultdict(
            lambda: deque(maxlen=self.cfg.window))
        self._flags: Dict[int, int] = defaultdict(int)

    def heartbeat(self, group: int, step_seconds: float) -> None:
        self._beats[group].append(float(step_seconds))

    # ------------------------------------------------------------- analysis
    def _stats(self) -> Tuple[float, float]:
        """Robust (median, MAD) over each group's recent median."""
        meds = [float(np.median(b)) for b in self._beats.values()
                if len(b) >= self.cfg.min_heartbeats]
        if len(meds) < 2:
            return float("nan"), float("nan")
        med = float(np.median(meds))
        mad = float(np.median(np.abs(np.array(meds) - med))) + 1e-9
        return med, mad

    def flagged(self) -> List[int]:
        med, mad = self._stats()
        if np.isnan(med):
            return []
        out = []
        for g, b in self._beats.items():
            if len(b) < self.cfg.min_heartbeats:
                continue
            if float(np.median(b)) > med + self.cfg.mad_k * mad:
                out.append(g)
        for g in list(self._flags):
            if g not in out:
                self._flags[g] = 0
        for g in out:
            self._flags[g] += 1
        return out

    def should_replace(self) -> List[int]:
        self.flagged()
        return [g for g, n in self._flags.items()
                if n >= self.cfg.replace_after]

    def severity(self, group: Optional[int] = None) -> float:
        """Normalized slowdown of the worst (or given) group vs the median —
        plugs into Enel's metric vector as step-time jitter."""
        med, mad = self._stats()
        if np.isnan(med) or med <= 0:
            return 0.0
        groups = [group] if group is not None else list(self._beats)
        worst = 0.0
        for g in groups:
            b = self._beats.get(g)
            if b and len(b) >= self.cfg.min_heartbeats:
                worst = max(worst, (float(np.median(b)) - med) / med)
        return max(0.0, worst)
