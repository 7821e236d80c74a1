"""Enel model training and fine-tuning (paper §IV-A, §V-B.3), PyTorch.

Targets: observed node runtimes, observed rescale overheads and observed
metric vectors (propagation loss).  Adam over the ~5k-parameter model; the
"retrain from scratch every 5th run, fine-tune in between" cadence lives in
:class:`EnelTrainer`.

Counterpart of ``repro.core.training``.  Two fit routes share the loss and
the optimizer:

* ``EnelTrainer.fit`` — list of graphs: host restack, power-of-two
  bucketing and a frozen metric-dropout copy appended to the batch (its
  masks come from ``np.random.RandomState``, so they equal the reference's).
* ``EnelTrainer.fit_resident`` — the online path: trains on the
  device-resident :class:`~repro_torch.core.graph.TrainingCache` ring, with
  metric dropout drawn on the device per Adam step from a
  ``torch.Generator`` (the reference draws from ``jax.random``; the two
  cannot give the same bits).

Both differentiate through ``forward_stacked``: on a card eqs. 6-7 go
through the ``graph_prop`` kernels (forward and backward), on the CPU
through the inline PyTorch route.  The reference's ``jax.lax.scan`` over
Adam steps is a Python loop here; losses and the skipped-step count stay on
the device and are fetched once per fit (the fused campaign,
``core/campaign_kernel.py``, keeps them there).  Every fit emits the
reference's ``fit`` span and observes ``enel_fit_seconds``
(``repro_torch.obs``).
"""
from __future__ import annotations

import itertools
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs, tree
from repro_torch.core import model as enel_model
from repro_torch.core.graph import (ComponentGraph, SweepTemplate,
                                    TrainingCache, empty_graph, pow2_bucket,
                                    stack_graphs)
from repro_torch.device import DeviceLike, resolve_device

HUBER_DELTA = 10.0

Opt = Tuple[Dict, Dict, torch.Tensor]      # (mu, nu, t) of Adam


# ``fn`` at every tensor of a parameter dict (same structure), and its
# tensors in a fixed order
map_params = tree.tree_map
param_leaves = tree.leaves


def _huber(err: torch.Tensor, delta: float = HUBER_DELTA) -> torch.Tensor:
    a = torch.abs(err)
    return torch.where(a <= delta, 0.5 * err * err, delta * (a - 0.5 * delta))


def enel_loss(params: Dict, batch: Dict[str, torch.Tensor],
              weights: Optional[torch.Tensor] = None,
              use_kernel: Optional[bool] = None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Training loss over a stacked graph batch.

    ``weights`` (B,) 0/1 scales each graph's contribution (ring slots
    outside the training window).  On the CPU ``use_kernel`` routes eqs. 6-7
    through the op's plain version instead of the inline path.
    """
    out = enel_model.forward_stacked(params, batch, use_kernel=use_kernel)
    zero = torch.zeros((), dtype=torch.float32, device=out["runtime"].device)
    rt_mask = batch["runtime_valid"] & batch["mask"] & ~batch["is_summary"]
    rt_err = torch.where(rt_mask, out["runtime"] - batch["runtime"], zero)

    ov_mask = batch["overhead_valid"] & batch["mask"]
    ov_err = torch.where(ov_mask, out["overhead"] - batch["overhead"], zero)

    # metric propagation loss: predict observed metrics from predecessors
    m_mask = (batch["metrics_valid"] & batch["mask"])[..., None]
    m_err = torch.where(m_mask, out["metrics"] - batch["metrics"], zero)

    if weights is None:
        l_rt = _huber(rt_err).sum() / torch.clamp_min(rt_mask.sum(), 1)
        l_ov = _huber(ov_err).sum() / torch.clamp_min(ov_mask.sum(), 1)
        l_m = torch.square(m_err).sum() / torch.clamp_min(m_mask.sum(), 1)
    else:
        w1 = weights[:, None]
        l_rt = (_huber(rt_err) * w1).sum() / \
            torch.clamp_min((rt_mask * w1).sum(), 1.0)
        l_ov = (_huber(ov_err) * w1).sum() / \
            torch.clamp_min((ov_mask * w1).sum(), 1.0)
        w2 = weights[:, None, None]
        l_m = (torch.square(m_err) * w2).sum() / \
            torch.clamp_min((m_mask * w2).sum(), 1.0)

    loss = l_rt + l_ov + 0.5 * l_m
    return loss, {"runtime": l_rt, "overhead": l_ov, "metrics": l_m}


def _adam_update(params: Dict, opt: Opt, batch: Dict[str, torch.Tensor],
                 lr: float, weights: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One guarded Adam step, in place on ``params`` and ``opt``.

    A step whose loss or gradients come back non-finite is skipped: params,
    moments and ``t`` keep their values and ``ok`` is False.  The choice is
    made on the device with ``torch.where`` (no host sync per step); the
    reference returns new pytrees, this port overwrites the tensors in place
    (``copy_``), which callers holding the same dict see.  Returns the
    (loss, ok) device scalars.
    """
    leaves = param_leaves(params)
    with torch.enable_grad():
        live = [p.detach().requires_grad_(True) for p in leaves]
        swap = dict(zip(map(id, leaves), live))
        loss, _ = enel_loss(map_params(lambda p: swap[id(p)], params),
                            batch, weights)
        grads = torch.autograd.grad(loss, live)
    mu0, nu0, t0 = opt
    with torch.no_grad():
        ok = torch.isfinite(loss)
        for g in grads:
            ok = ok & torch.isfinite(g).all()
        t = t0 + 1
        bc1 = 1 - 0.9 ** t
        bc2 = 1 - 0.999 ** t
        for p, g, m, v in zip(leaves, grads, param_leaves(mu0),
                              param_leaves(nu0)):
            m_new = 0.9 * m + 0.1 * g
            v_new = 0.999 * v + 0.001 * g * g
            mh = m_new / bc1
            vh = v_new / bc2
            p_new = p - lr * mh / (torch.sqrt(vh) + 1e-8)
            p.copy_(torch.where(ok, p_new, p))
            m.copy_(torch.where(ok, m_new, m))
            v.copy_(torch.where(ok, v_new, v))
        t0.copy_(torch.where(ok, t, t0))
    return loss.detach(), ok


def _adam_run(params: Dict, opt: Opt, batch: Dict[str, torch.Tensor],
              steps: int, lr: float) -> Tuple[float, float, int]:
    """``steps`` guarded Adam updates; returns (first-step loss, last loss,
    skipped steps), fetched from the device once."""
    losses, oks = [], []
    for _ in range(steps):
        loss, ok = _adam_update(params, opt, batch, lr)
        losses.append(loss)
        oks.append(ok)
    return _fetch(losses, oks)


def _adam_run_resident_device(params: Dict, opt: Opt,
                              batch: Dict[str, torch.Tensor],
                              weights: torch.Tensor,
                              generator: torch.Generator, lr: float,
                              dropout_p: float, steps: int
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Adam over a resident batch with per-step metric dropout, enqueued
    without a host sync.

    Each step draws a fresh mask on the device hiding task-set metrics with
    probability ``dropout_p`` (summary nodes kept), so runtime prediction is
    also trained through the metric-propagation path.  Returns (first-step
    loss, last loss, skipped steps as int32) as device scalars; ``steps``
    must be at least 1.
    """
    losses, oks = [], []
    mv = batch["metrics_valid"]
    for _ in range(steps):
        b = batch
        if dropout_p > 0:
            u = torch.rand(mv.shape, generator=generator, device=mv.device)
            drop = (u < dropout_p) & ~batch["is_summary"]
            b = dict(batch, metrics_valid=mv & ~drop)
        loss, ok = _adam_update(params, opt, b, lr, weights)
        losses.append(loss)
        oks.append(ok)
    skipped = (~torch.stack(oks)).sum().to(torch.int32)
    return losses[0], losses[-1], skipped


def _adam_run_resident(params: Dict, opt: Opt,
                       batch: Dict[str, torch.Tensor], weights: torch.Tensor,
                       generator: torch.Generator, lr: float,
                       dropout_p: float, steps: int
                       ) -> Tuple[float, float, int]:
    """:func:`_adam_run_resident_device`, its (first-step loss, last loss,
    skipped steps) fetched once."""
    if steps < 1:
        return float("nan"), float("nan"), 0
    return _to_host(*_adam_run_resident_device(
        params, opt, batch, weights, generator, lr, dropout_p, steps))


def _fetch(losses: List[torch.Tensor], oks: List[torch.Tensor]
           ) -> Tuple[float, float, int]:
    """(first loss, last loss, count of not-ok steps) in one transfer."""
    if not losses:
        return float("nan"), float("nan"), 0
    return _to_host(losses[0], losses[-1], (~torch.stack(oks)).sum())


def _to_host(first: torch.Tensor, last: torch.Tensor,
             skipped: torch.Tensor) -> Tuple[float, float, int]:
    host = torch.stack([first.float(), last.float(), skipped.float()]).cpu()
    return float(host[0]), float(host[1]), int(host[2])


def _round_steps(steps: int) -> int:
    """Round down to a power of two in [8, 512] (the reference's jit-cache
    rounding; kept so step counts match it)."""
    p2 = 1 << max(0, (max(steps, 1)).bit_length() - 1)
    return max(8, min(512, p2 if steps - p2 < p2 else p2 * 2))


def _dropout_seed(seed: int, fit_calls: int) -> int:
    """Generator seed of one resident fit (the reference folds
    ``fit_calls`` into ``PRNGKey(seed ^ 0x5eed)``)."""
    return int(np.random.SeedSequence(
        [(seed ^ 0x5eed) & 0xffffffff, fit_calls]).generate_state(1)[0])


class EnelTrainer:
    """One global reusable model on ``device`` and the paper's
    (re)training cadence.

    ``init_params`` are drawn by :func:`~repro_torch.core.model.init_enel`
    from a ``torch.Generator`` seeded with ``seed``; ``params`` start as a
    copy and every scratch fit restarts from another copy.  Callers may
    replace either (e.g. with :func:`repro_torch.convert.
    enel_params_from_numpy`).
    """

    _ids = itertools.count()        # default obs label allocator

    def __init__(self, seed: int = 0, lr: float = 5e-3,
                 cache_capacity: int = 96, *, device: DeviceLike = "cuda",
                 obs_name: Optional[str] = None):
        self.device = resolve_device(device)
        self.obs_name = obs_name or f"tr{next(self._ids)}"
        self.seed = seed
        self.lr = lr
        self.init_params = enel_model.init_enel(
            torch.Generator().manual_seed(seed), self.device)
        self.params = map_params(torch.clone, self.init_params)
        self._reset_opt()
        self.runs_seen = 0
        self.last_fit_seconds = 0.0
        # device-resident history ring for the online path (made on the
        # first extend_history); fit() works without it
        self.cache: Optional[TrainingCache] = None
        self.cache_capacity = cache_capacity
        self._fit_calls = 0
        # the most recent fit's first-step and final losses, the Adam steps
        # run (guard-skipped ones included) and the non-finite guard counts
        # (see _adam_update)
        self.first_step_loss = self.last_loss = float("nan")
        self.adam_steps = 0
        self.nonfinite_steps = 0
        self.last_skipped_steps = 0
        self.poisoned_fits = 0

    def _emit_fit(self, route: str, scratch: bool, steps: int, loss: float,
                  retried: bool = False) -> None:
        mode = "scratch" if scratch else "tune"
        obs.emit("fit", trainer=self.obs_name, route=route, mode=mode,
                 steps=steps, skipped=self.last_skipped_steps,
                 retried=retried, loss=round(float(loss), 6),
                 seconds=round(self.last_fit_seconds, 6))
        obs.observe("enel_fit_seconds", self.last_fit_seconds,
                    trainer=self.obs_name, mode=mode)

    def _reset_opt(self) -> None:
        self.opt: Opt = (map_params(torch.zeros_like, self.params),
                         map_params(torch.zeros_like, self.params),
                         torch.zeros((), dtype=torch.int32,
                                     device=self.device))

    def _scratch(self) -> None:
        self.params = map_params(torch.clone, self.init_params)
        self._reset_opt()

    def n_params(self) -> int:
        return enel_model.n_params(self.params)

    def _to_device(self, arrays: Dict) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in arrays.items()}

    def _note_fit(self, first: float, last: float, skipped: int,
                  steps: int) -> None:
        self.first_step_loss, self.last_loss = first, last
        self.adam_steps += steps
        self.last_skipped_steps = skipped
        self.nonfinite_steps += skipped
        if skipped >= steps:
            self.poisoned_fits += 1

    def params_finite(self) -> bool:
        """True iff every model parameter is finite (one host fetch)."""
        flags = torch.stack([torch.isfinite(p).all()
                             for p in param_leaves(self.params)])
        return bool(flags.all().cpu())

    # ------------------------------------------------------------ legacy
    def fit(self, graphs: Sequence[ComponentGraph], *, steps: int = 200,
            from_scratch: bool = False, metric_dropout: float = 0.5) -> float:
        """Train on a set of component graphs; returns the final loss.

        ``metric_dropout`` appends a copy of the batch with task-set metrics
        masked out (summary nodes kept), so runtime prediction is also
        trained through the metric-propagation path (§III-D).
        """
        if not graphs:
            return float("nan")
        t0 = time.time()
        if from_scratch:
            self._scratch()
        graphs = list(graphs)
        n = len(graphs)
        graphs = graphs + [empty_graph()] * (pow2_bucket(n) - n)
        stacked = stack_graphs(graphs)
        if metric_dropout > 0:
            rng = np.random.RandomState(self.seed + self.runs_seen)
            aug = {k: v.copy() for k, v in stacked.items()}
            drop = (rng.rand(*aug["metrics_valid"].shape) < metric_dropout)
            drop &= ~aug["is_summary"]
            aug["metrics_valid"] = aug["metrics_valid"] & ~drop
            stacked = {k: np.concatenate([stacked[k], aug[k]])
                       for k in stacked}
        steps = _round_steps(steps)
        first, loss, skipped = _adam_run(self.params, self.opt,
                                         self._to_device(stacked), steps,
                                         self.lr)
        self._note_fit(first, loss, skipped, steps)
        self.last_fit_seconds = time.time() - t0
        self._emit_fit("legacy", from_scratch, steps, loss)
        return loss

    # ---------------------------------------------------- resident ring
    def extend_history(self, graphs: Sequence[ComponentGraph]) -> None:
        """Append a run's graphs to the device-resident training ring."""
        graphs = list(graphs)
        if not graphs:
            return
        if self.cache is None:
            self.cache = TrainingCache(self.cache_capacity,
                                       device=self.device)
        self.cache.extend(graphs)

    def fit_resident(self, *, steps: int = 200, from_scratch: bool = False,
                     metric_dropout: float = 0.5, latest_only: bool = False,
                     _retry: bool = True) -> float:
        """Train on the resident ring; returns the final loss.

        ``latest_only`` restricts the loss to the newest ``extend_history``
        batch (the fine-tune step); otherwise the whole ring trains, with
        per-slot weights masking unfilled slots.  A fit where every step
        was skipped by the non-finite guard, with finite params, triggers
        one quarantine sweep of the ring and a single retry.
        """
        if self.cache is None or self.cache.count == 0:
            return float("nan")
        t0 = time.time()
        if from_scratch:
            self._scratch()
        batch, weights = (self.cache.latest_batch() if latest_only
                          else self.cache.full_batch())
        gen = torch.Generator(device=self.device).manual_seed(
            _dropout_seed(self.seed, self._fit_calls))
        self._fit_calls += 1
        n_steps = _round_steps(steps)
        first, loss, skipped = _adam_run_resident(
            self.params, self.opt, batch,
            torch.as_tensor(weights, device=self.device), gen, self.lr,
            float(metric_dropout), n_steps)
        self._note_fit(first, loss, skipped, n_steps)
        self.last_fit_seconds = time.time() - t0
        if self.last_skipped_steps >= n_steps and _retry and \
                self.params_finite() and \
                self.cache.quarantine_nonfinite() > 0:
            # params were fine but the batch was poisoned: the corrupt rows
            # are quarantined now, so one retry trains on the healed ring
            self._emit_fit("resident", from_scratch, n_steps, loss,
                           retried=True)
            return self.fit_resident(steps=steps, from_scratch=from_scratch,
                                     metric_dropout=metric_dropout,
                                     latest_only=latest_only, _retry=False)
        self._emit_fit("resident", from_scratch, n_steps, loss)
        return loss

    def observe_run_resident(self, *, retrain_every: int = 5,
                             steps: int = 200,
                             fine_tune_steps: int = 60) -> float:
        """Paper cadence (§V-B.3) on the resident ring: scratch-retrain on
        the whole history window every ``retrain_every`` runs, fine-tune on
        the newest run's graphs in between."""
        self.runs_seen += 1
        if (self.runs_seen % retrain_every) == 0:
            return self.fit_resident(steps=steps, from_scratch=True)
        return self.fit_resident(steps=fine_tune_steps, latest_only=True)

    def observe_run(self, latest: Sequence[ComponentGraph],
                    history: Optional[Sequence[ComponentGraph]] = None,
                    retrain_every: int = 5, steps: int = 200,
                    fine_tune_steps: int = 60) -> float:
        """Paper cadence (§V-B.3) on the legacy route."""
        self.runs_seen += 1
        scratch = (self.runs_seen % retrain_every) == 0 and history is not None
        if scratch:
            return self.fit(history, steps=steps, from_scratch=True)
        return self.fit(latest, steps=fine_tune_steps)

    # --------------------------------------------------- checkpoint support
    def snapshot_state(self) -> Dict:
        """Picklable host copy of the params, Adam state, cadence, guard
        counters and ring (campaign checkpoints, ``dataflow/fleet.py``).
        The leaves are numpy copies, not views of the live tensors, which
        the Adam step overwrites in place.  Beside the reference's fields it
        keeps ``init_params`` (every scratch fit restarts from them) and the
        last fit's step count and losses."""
        host = lambda t: t.detach().cpu().numpy().copy()
        mu, nu, t = self.opt
        return {"params": map_params(host, self.params),
                "opt": (map_params(host, mu), map_params(host, nu), host(t)),
                "init_params": map_params(host, self.init_params),
                "runs_seen": self.runs_seen, "fit_calls": self._fit_calls,
                "nonfinite_steps": self.nonfinite_steps,
                "last_skipped_steps": self.last_skipped_steps,
                "poisoned_fits": self.poisoned_fits,
                "adam_steps": self.adam_steps,
                "first_step_loss": self.first_step_loss,
                "last_loss": self.last_loss,
                "cache": None if self.cache is None
                else self.cache.snapshot()}

    def restore_state(self, st: Dict) -> None:
        """Inverse of :meth:`snapshot_state`, into fresh tensors on this
        trainer's device (so nothing keyed on the old tensors' identity, such
        as the decision service's stack memo, can match them); the snapshot
        is left untouched."""
        dev = lambda a: torch.tensor(np.asarray(a), device=self.device)
        mu, nu, t = st["opt"]
        self.params = map_params(dev, st["params"])
        self.opt = (map_params(dev, mu), map_params(dev, nu), dev(t))
        self.init_params = map_params(dev, st["init_params"])
        self.runs_seen = int(st["runs_seen"])
        self._fit_calls = int(st["fit_calls"])
        self.nonfinite_steps = int(st["nonfinite_steps"])
        self.last_skipped_steps = int(st["last_skipped_steps"])
        self.poisoned_fits = int(st["poisoned_fits"])
        self.adam_steps = int(st["adam_steps"])
        self.first_step_loss = float(st["first_step_loss"])
        self.last_loss = float(st["last_loss"])
        self.cache = None if st["cache"] is None else \
            TrainingCache.from_snapshot(st["cache"], device=self.device)

    # -------------------------------------------------------- inference
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
