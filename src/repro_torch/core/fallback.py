"""Model-free fallback scaling policy (decision guardrail backstop).

When the learned model's sweep predictions are unusable — non-finite totals
from a poisoned fit, a dispatch that exhausted its retries, an open circuit
breaker, or a request shed under overload — the control plane must still
answer with SOME bounded scale-out (Daedalus-style graceful degradation:
the autoscaler keeps serving decisions while its model is unavailable).

:class:`FallbackPolicy` implements an Ernest-style clamp: salvage a
compliant pick from whatever finite predictions survive, otherwise step the
current allocation up by an urgency-scaled bounded amount.  Its contract —
property-tested in the JAX package's fallback tests — is that the returned
scale-out is ALWAYS one of the real candidates (hence always inside
``[min_scaleout, max_scaleout]``), for arbitrary finite/non-finite
prediction vectors, elapsed times and targets.

A pure-Python copy of ``repro.core.fallback.FallbackPolicy``; the in-scan
twin ``fallback_pick`` comes with the fused campaign.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple, Union


def _finite(x) -> bool:
    try:
        return math.isfinite(float(x))
    except (TypeError, ValueError, OverflowError):
        return False


@dataclass
class FallbackPolicy:
    """Bounded heuristic scale-out picker for unusable predictions.

    ``max_step`` caps how many executors a single blind decision may add;
    ``press_lo``/``press_hi`` are elapsed/target urgency thresholds below
    which the policy holds, half-steps and full-steps respectively.
    """

    max_step: int = 4
    press_lo: float = 0.5
    press_hi: float = 0.85

    # ------------------------------------------------------------- decide
    def decide(self, candidates: Sequence[int],
               totals: Optional[Union[Dict[int, float], Sequence[float]]],
               current: int, elapsed: float, target: float
               ) -> Tuple[int, float]:
        """(scale-out, predicted_total) with predicted NaN when no finite
        prediction backed the pick.

        Salvage first: if any candidate kept a finite predicted total, run
        the normal smallest-compliant-else-least-violating pick over that
        finite subset.  Otherwise fall back to :meth:`clamp`.
        """
        finite = self._finite_totals(candidates, totals)
        if finite:
            if _finite(target):
                feasible = [s for s, t in finite.items() if t <= target]
                if feasible:
                    best = min(feasible)
                    return best, finite[best]
            best = min(finite, key=lambda s: (finite[s], s))
            return best, finite[best]
        return self.clamp(candidates, current, elapsed, target), float("nan")

    @staticmethod
    def _finite_totals(candidates, totals) -> Dict[int, float]:
        if totals is None:
            return {}
        if isinstance(totals, dict):
            pairs = [(s, totals.get(s)) for s in candidates]
        else:
            pairs = list(zip(candidates, totals))
        return {int(s): float(t) for s, t in pairs
                if t is not None and _finite(t)}

    # -------------------------------------------------------------- clamp
    def clamp(self, candidates: Sequence[int], current: int,
              elapsed: float, target: float) -> int:
        """Model-free bounded step: scale out by an urgency-proportional
        amount from the current allocation, clamped to the candidate range.

        Urgency is ``elapsed / target``: under ``press_lo`` hold the current
        scale-out, under ``press_hi`` add half of ``max_step``, above it add
        the full ``max_step`` (the run is about to blow its target and blind
        scale-out is the only lever left).  Non-finite elapsed/target means
        no urgency signal at all: hold the (clamped) current scale-out.
        """
        cands = sorted({int(s) for s in candidates})
        if not cands:
            raise ValueError("fallback needs at least one candidate")
        lo, hi = cands[0], cands[-1]
        cur = int(current) if _finite(current) else lo
        cur = min(max(cur, lo), hi)
        step = 0
        if _finite(elapsed) and _finite(target) and target > 0 \
                and elapsed >= 0:
            urgency = elapsed / target
            if urgency >= self.press_hi:
                step = self.max_step
            elif urgency >= self.press_lo:
                step = max(1, self.max_step // 2)
        want = min(max(cur + step, lo), hi)
        for s in cands:                    # smallest candidate >= want
            if s >= want:
                return s
        return hi
