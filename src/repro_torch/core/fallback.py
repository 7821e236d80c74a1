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

A pure-Python copy of ``repro.core.fallback.FallbackPolicy``, and its
device twin :func:`fallback_pick` for the fused campaign's step
(``core/campaign_kernel.py``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple, Union

import torch


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


def fallback_pick(candidates: torch.Tensor, cand_valid: torch.Tensor,
                  totals: torch.Tensor, current: torch.Tensor,
                  elapsed: torch.Tensor, target: torch.Tensor,
                  max_step: int = 4, press_lo: float = 0.5,
                  press_hi: float = 0.85) -> torch.Tensor:
    """Device mirror of :meth:`FallbackPolicy.decide`, in tensor ops.

    ``candidates`` (..., C) is ascending and duplicate-free over its
    ``cand_valid`` entries, ``totals`` (..., C); ``current``, ``elapsed``
    and ``target`` carry the leading shape (a job axis, or none).  Returns
    the picked index into ``candidates`` (int32, the leading shape), not
    the scale-out.  Same contract as the host policy: salvage the smallest
    compliant candidate among finite totals, else the least (total,
    scale-out) pair, else the urgency-scaled bounded clamp.  Every argmax
    and argmin returns the first index of a tie, as ``jnp``'s do.
    """
    f32 = torch.float32
    candidates = candidates.to(f32)
    inf = torch.full_like(totals, math.inf)
    finite = cand_valid & torch.isfinite(totals)
    # salvage: the smallest compliant candidate (ascending: the first
    # feasible index), else the first argmin of the finite totals (the
    # smallest scale-out on ties, as min(key=(total, s)) picks)
    feasible = finite & (totals <= target[..., None])
    idx_feas = torch.argmax(feasible.to(torch.int32), dim=-1)
    idx_min = torch.argmin(torch.where(finite, totals, inf), dim=-1)
    use_feas = torch.isfinite(target) & feasible.any(dim=-1)
    idx_salvage = torch.where(use_feas, idx_feas, idx_min)
    # clamp: an urgency-proportional bounded step from the current
    # allocation
    cand_inf = torch.full_like(candidates, math.inf)
    lo = torch.where(cand_valid, candidates, cand_inf).amin(dim=-1)
    hi = torch.where(cand_valid, candidates, -cand_inf).amax(dim=-1)
    cur = torch.where(torch.isfinite(current), current.to(f32), lo)
    cur = torch.minimum(torch.maximum(cur, lo), hi)
    ok_u = (torch.isfinite(elapsed) & torch.isfinite(target) & (target > 0)
            & (elapsed >= 0))
    urgency = elapsed / target
    zero = torch.zeros_like(cur)
    half = max(1, max_step // 2)
    step = torch.where(ok_u & (urgency >= press_hi), zero + max_step,
                       torch.where(ok_u & (urgency >= press_lo),
                                   zero + half, zero))
    want = torch.minimum(torch.maximum(cur + step, lo), hi)
    ge = cand_valid & (candidates >= want[..., None])
    idx_hi = torch.argmax(torch.where(cand_valid, candidates, -cand_inf),
                          dim=-1)
    idx_clamp = torch.where(ge.any(dim=-1),
                            torch.argmax(ge.to(torch.int32), dim=-1), idx_hi)
    return torch.where(finite.any(dim=-1), idx_salvage,
                       idx_clamp).to(torch.int32)
