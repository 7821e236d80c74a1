"""Ellis baseline [Thamsen et al., CloudCom'17] (paper §V comparison).

Ellis fits a *new set of specialized models per run* — one scale-out model
per job component — estimates progress from completed components, and
rescales to the smallest scale-out whose predicted remaining runtime meets
the target.  Contrast: Enel uses ONE reusable context-aware graph model.

A numpy copy of ``repro.core.ellis`` over the port's ``BellModel``.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core.bell import BellModel


class EllisScaler:
    def __init__(self, scaleout_range: Tuple[int, int],
                 rescale_overhead: float = 5.0, candidate_stride: int = 1):
        self.range = scaleout_range
        self.rescale_overhead = rescale_overhead
        self.candidate_stride = max(1, candidate_stride)
        # history[component_idx] -> list of (scaleout, runtime)
        self.history: Dict[int, List[Tuple[float, float]]] = defaultdict(list)
        self.models: Dict[int, BellModel] = {}

    # -------------------------------------------------------------- training
    def observe_component(self, comp_idx: int, scaleout: float,
                          runtime: float) -> None:
        self.history[comp_idx].append((scaleout, runtime))

    def refit(self) -> None:
        """Per-run refit of every specialized component model."""
        self.models = {}
        for comp_idx, pairs in self.history.items():
            if len(pairs) >= 2:
                s = np.array([p[0] for p in pairs])
                t = np.array([p[1] for p in pairs])
                self.models[comp_idx] = BellModel().fit(s, t)

    # ------------------------------------------------------------- inference
    def predict_component(self, comp_idx: int, scaleout: float) -> float:
        m = self.models.get(comp_idx)
        if m is not None:
            return float(m.predict(scaleout)[0])
        pairs = self.history.get(comp_idx)
        if pairs:
            return float(np.mean([p[1] for p in pairs]))
        # fall back to the mean over all known components
        all_t = [t for ps in self.history.values() for (_, t) in ps]
        return float(np.mean(all_t)) if all_t else 0.0

    def predict_remaining(self, next_comp: int, n_components: int,
                          scaleout: float) -> float:
        return sum(self.predict_component(c, scaleout)
                   for c in range(next_comp, n_components))

    def recommend(self, *, next_comp: int, n_components: int, elapsed: float,
                  current_scaleout: int, target_runtime: float
                  ) -> Tuple[int, float]:
        """Smallest scale-out meeting the target; (scaleout, predicted_total)."""
        lo, hi = self.range
        best_s, best_total = current_scaleout, None
        feasible: List[Tuple[int, float]] = []
        cands = sorted(set(range(lo, hi + 1, self.candidate_stride))
                       | {hi, current_scaleout})
        for s in [c for c in cands if lo <= c <= hi]:
            overhead = self.rescale_overhead if s != current_scaleout else 0.0
            total = elapsed + overhead + self.predict_remaining(
                next_comp, n_components, s)
            if best_total is None or total < best_total:
                best_s, best_total = s, total
            if total <= target_runtime:
                feasible.append((s, total))
        if feasible:
            return feasible[0][0], feasible[0][1]
        return best_s, best_total if best_total is not None else elapsed
