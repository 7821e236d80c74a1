"""The Enel model holder and its inference entry points (paper §IV-A).

Counterpart of ``repro.core.training.EnelTrainer`` without the fitting
(``fit``, ``fit_resident`` and the Adam loop come with the training path):
it owns one parameter dict on one device and answers per-graph, stacked and
candidate-sweep predictions.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import model as enel_model
from repro_torch.core.graph import (ComponentGraph, SweepTemplate,
                                    empty_graph, pow2_bucket, stack_graphs)
from repro_torch.device import DeviceLike, resolve_device


class EnelTrainer:
    """One global reusable model on ``device``.

    ``params`` are drawn by :func:`~repro_torch.core.model.init_enel` from a
    ``torch.Generator`` seeded with ``seed``; callers may replace them (e.g.
    with :func:`repro_torch.convert.enel_params_from_numpy`).
    """

    def __init__(self, seed: int = 0, *, device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        self.seed = seed
        self.params = enel_model.init_enel(
            torch.Generator().manual_seed(seed), self.device)

    def n_params(self) -> int:
        return enel_model.n_params(self.params)

    def _to_device(self, arrays: Dict) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in arrays.items()}

    @torch.no_grad()
    def predict(self, graphs: Sequence[ComponentGraph]) -> np.ndarray:
        """Per-component total-runtime predictions (seconds)."""
        n = len(graphs)
        padded = list(graphs) + [empty_graph()] * (pow2_bucket(n) - n)
        batch = self._to_device(stack_graphs(padded))
        return enel_model.predict_total_runtime(
            self.params, batch).cpu().numpy()[:n]

    @torch.no_grad()
    def predict_stacked(self, batch: Dict[str, np.ndarray]) -> np.ndarray:
        """Totals for an already-stacked (B, N, ...) graph-array dict."""
        return enel_model.predict_total_runtime(
            self.params, self._to_device(batch)).cpu().numpy()

    @torch.no_grad()
    def predict_sweep_device(self, template: SweepTemplate,
                             deltas: Dict[str, np.ndarray],
                             use_kernel: Optional[bool] = None
                             ) -> torch.Tensor:
        """Batched candidate-sweep predictions as a DEVICE (C, K) tensor.

        The template's (K, N, ...) base arrays (device tensors when the
        scaler's template cache holds them) and the small (C, K, ...) deltas
        are evaluated by :func:`~repro_torch.core.model.sweep_per_component`
        with the propagation depth lowered to the template DAG's depth.  No
        host sync: callers reduce and pick on the device and fetch once.
        """
        levels = min(enel_model.MAX_LEVELS, max(1, template.levels))
        return enel_model.sweep_per_component(
            self.params, self._to_device(template.base),
            torch.as_tensor(template.h_onehot, device=self.device),
            self._to_device(deltas), use_kernel=use_kernel, levels=levels)

    def predict_sweep(self, template: SweepTemplate,
                      deltas: Dict[str, np.ndarray],
                      use_kernel: Optional[bool] = None) -> np.ndarray:
        """Host (C, K) sweep predictions (one transfer)."""
        return self.predict_sweep_device(template, deltas,
                                         use_kernel).cpu().numpy()
