"""Decision results of the candidate sweep.

Counterpart of the ``DecisionResult`` of ``repro.core.service``: the pick
and per-candidate totals arrive on the host in one transfer, the (C, K)
per-component predictions stay on the device until someone asks.  The
batched fleet ``DecisionService`` comes with a later part of the port.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


class DecisionResult:
    """Pick + totals (fetched in one transfer); per-component preds lazy."""

    def __init__(self, scaleout: int, predicted: float,
                 totals: Dict[int, float], per_component_dev: torch.Tensor,
                 n_candidates: int, n_components: int):
        self.scaleout = scaleout
        self.predicted = predicted
        self.totals = totals
        self._per_dev = per_component_dev       # (C, K) on the device
        self._shape = (n_candidates, n_components)
        self._per_np: Optional[np.ndarray] = None

    @property
    def per_component(self) -> np.ndarray:
        """(C, K) per-component predictions; device->host on first access."""
        if self._per_np is None:
            c, k = self._shape
            self._per_np = self._per_dev.cpu().numpy()[:c, :k]
        return self._per_np
