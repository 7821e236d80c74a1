"""Bell runtime model [Thamsen et al., IPCCC'16] — used by Enel for the
initial resource allocation (paper §IV-A).

Bell cross-validates between (a) an Ernest-style parametric model
t(s) = th0 + th1/s + th2*log(s) + th3*s  (non-negative least squares via
projected lstsq) and (b) a non-parametric local model (inverse-distance
interpolation over observed scale-outs), picking the lower LOO-CV error.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def _features(s: np.ndarray) -> np.ndarray:
    s = np.asarray(s, np.float64)
    return np.stack([np.ones_like(s), 1.0 / s, np.log(s), s], axis=1)


def _nnls(A: np.ndarray, y: np.ndarray, iters: int = 200) -> np.ndarray:
    """Projected-gradient NNLS (tiny problems; no scipy in this image)."""
    theta = np.maximum(np.linalg.lstsq(A, y, rcond=None)[0], 0.0)
    lr = 1.0 / (np.linalg.norm(A, 2) ** 2 + 1e-9)
    for _ in range(iters):
        grad = A.T @ (A @ theta - y)
        theta = np.maximum(theta - lr * grad, 0.0)
    return theta


class ParametricModel:
    def __init__(self):
        self.theta: Optional[np.ndarray] = None

    def fit(self, s: np.ndarray, t: np.ndarray) -> "ParametricModel":
        self.theta = _nnls(_features(s), np.asarray(t, np.float64))
        return self

    def predict(self, s) -> np.ndarray:
        return _features(np.atleast_1d(s)) @ self.theta


class NonParametricModel:
    """Inverse-distance-weighted interpolation in scale-out space."""

    def __init__(self, power: float = 2.0):
        self.power = power
        self.s: Optional[np.ndarray] = None
        self.t: Optional[np.ndarray] = None

    def fit(self, s: np.ndarray, t: np.ndarray) -> "NonParametricModel":
        self.s = np.asarray(s, np.float64)
        self.t = np.asarray(t, np.float64)
        return self

    def predict(self, s) -> np.ndarray:
        s = np.atleast_1d(np.asarray(s, np.float64))
        d = np.abs(s[:, None] - self.s[None, :])
        w = 1.0 / np.maximum(d, 1e-9) ** self.power
        exact = d < 1e-9
        w = np.where(exact.any(axis=1, keepdims=True), exact.astype(float), w)
        return (w * self.t[None, :]).sum(1) / w.sum(1)


class BellModel:
    """CV-selected combination (paper [20]): the better of the two models."""

    def __init__(self):
        self.model = None
        self.choice = "parametric"

    def fit(self, s: Sequence[float], t: Sequence[float]) -> "BellModel":
        s = np.asarray(s, np.float64)
        t = np.asarray(t, np.float64)
        if len(s) < 3:
            self.model = NonParametricModel().fit(s, t)
            self.choice = "nonparametric"
            return self
        errs = {"parametric": 0.0, "nonparametric": 0.0}
        for i in range(len(s)):
            mask = np.arange(len(s)) != i
            pm = ParametricModel().fit(s[mask], t[mask])
            npm = NonParametricModel().fit(s[mask], t[mask])
            errs["parametric"] += float((pm.predict(s[i])[0] - t[i]) ** 2)
            errs["nonparametric"] += float((npm.predict(s[i])[0] - t[i]) ** 2)
        self.choice = min(errs, key=errs.get)
        cls = ParametricModel if self.choice == "parametric" else NonParametricModel
        self.model = cls().fit(s, t)
        return self

    def predict(self, s) -> np.ndarray:
        return self.model.predict(s)


def initial_scaleout(history: Sequence[Tuple[float, float]],
                     target_runtime: float,
                     scaleout_range: Tuple[int, int]) -> int:
    """Smallest scale-out whose Bell-predicted runtime meets the target;
    falls back to the runtime-minimizing scale-out."""
    s = np.array([h[0] for h in history])
    t = np.array([h[1] for h in history])
    bell = BellModel().fit(s, t)
    lo, hi = scaleout_range
    cand = np.arange(lo, hi + 1)
    pred = bell.predict(cand)
    feasible = cand[pred <= target_runtime]
    if len(feasible):
        return int(feasible.min())
    return int(cand[np.argmin(pred)])
