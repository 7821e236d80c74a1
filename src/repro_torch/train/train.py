"""Train step and eval loss, closed over (cfg, opt).

Counterpart of ``repro.train.train``.  A train state is ``{"params",
"opt": {"mu", "nu", "step"}}`` of tensors on one device; a step computes
the gradients with ``torch.autograd.grad`` and updates the state in place
(``optimizer.adamw_update``).  The reference's sharding constraints
(``constrain`` on the microbatch split) place data on a mesh; at world
size 1 they mean nothing and are dropped (distribution is ROADMAP.md queue
1 item 13).  The reference draws its initial weights from ``jax.random``,
which the port cannot reproduce: :func:`init_train_state` takes the seed of
the port's ``torch.Generator`` instead (``convert.train_state_from_numpy``
carries a reference state over).
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Tuple

import numpy as np
import torch

from repro_torch import tree
from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import apply_model, frontend_input, init_model
from repro_torch.models.layers import DTYPES
from repro_torch.train.optimizer import (AdamWConfig, adamw_update,
                                         init_opt_state)

AUX_LOSS_WEIGHT = 0.01


def init_train_state(seed: int, cfg: ModelConfig, opt: AdamWConfig, *,
                     device: DeviceLike = "cuda") -> Dict:
    """Seeded parameters (``init_model``) and zero moments on ``device``."""
    params = init_model(cfg, seed=seed, device=device)
    return {"params": params, "opt": init_opt_state(params, cfg.opt_dtype)}


def batch_to_device(batch: Mapping[str, np.ndarray],
                    device: DeviceLike) -> Dict[str, torch.Tensor]:
    """A ``data.pipeline`` batch as tensors on ``device``: token ids as
    int64, float arrays as they are."""
    dev = resolve_device(device)
    return {k: torch.as_tensor(np.asarray(v), device=dev).long()
            if np.asarray(v).dtype.kind in "iu"
            else torch.as_tensor(np.asarray(v), device=dev)
            for k, v in batch.items()}


def loss_fn(params, cfg: ModelConfig, batch: Dict
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Cross-entropy in float32 over the targets in ``[0,
    raw_vocab_size)`` (others are masked out), averaged over the valid
    tokens, plus ``AUX_LOSS_WEIGHT`` times the MoE aux loss."""
    logits, aux = apply_model(params, cfg, batch)
    targets = batch["targets"]
    logits = logits[:, frontend_input(cfg).text_offset:]   # text positions
    mask = ((targets >= 0) & (targets < cfg.raw_vocab_size)).float()
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(
        logits, -1, targets.clamp(0, cfg.vocab_size - 1)[..., None].long()
    )[..., 0]
    nll = (lse - picked) * mask
    denom = torch.clamp_min(mask.sum(), 1.0)
    ce = nll.sum() / denom
    loss = ce + AUX_LOSS_WEIGHT * aux
    return loss, {"ce": ce, "aux": aux, "tokens": denom}


def _value_and_grad(params, cfg: ModelConfig, batch: Dict):
    """(loss, parts, grads in the tree's leaf order); a leaf the loss does
    not reach gets a zero gradient, as ``jax.grad`` gives it."""
    leaves = tree.leaves(params)
    with torch.enable_grad():
        live = [p.detach().requires_grad_(True) for p in leaves]
        swap = dict(zip(map(id, leaves), live))
        loss, parts = loss_fn(tree.tree_map(lambda p: swap[id(p)], params),
                              cfg, batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), {k: v.detach() for k, v in parts.items()}, grads


def make_train_step(cfg: ModelConfig, opt: AdamWConfig,
                    grad_accum: int = 1) -> Callable:
    """``train_step(state, batch) -> (state, metrics)``, the state updated in
    place.  With ``grad_accum > 1`` the batch's leading axis is split into
    that many microbatches, run in turn; their gradients are summed in
    ``cfg.grad_accum_dtype`` (arctic: bfloat16) and divided by
    ``grad_accum``, and the loss and its parts are averaged."""
    acc_dt = DTYPES[cfg.grad_accum_dtype]

    def train_step(state: Dict, batch: Dict) -> Tuple[Dict, Dict]:
        params = state["params"]
        if grad_accum == 1:
            loss, parts, grads = _value_and_grad(params, cfg, batch)
        else:
            micro = [{k: v.reshape(grad_accum, v.shape[0] // grad_accum,
                                   *v.shape[1:])[j]
                      for k, v in batch.items()} for j in range(grad_accum)]
            gsum = [torch.zeros(p.shape, dtype=acc_dt, device=p.device)
                    for p in tree.leaves(params)]
            lsum = torch.zeros((), dtype=torch.float32,
                               device=gsum[0].device)
            parts_all = []
            for mb in micro:
                l, parts_i, g = _value_and_grad(params, cfg, mb)
                gsum = [a + b.to(a.dtype) for a, b in zip(gsum, g)]
                lsum = lsum + l
                parts_all.append(parts_i)
            grads = [g / grad_accum for g in gsum]
            loss = lsum / grad_accum
            parts = {k: torch.stack([p[k] for p in parts_all]).mean()
                     for k in parts_all[0]}
        # grads is a list in the tree's leaf order, which is its own tree
        _, _, om = adamw_update(params, grads, state["opt"], opt)
        return state, {"loss": loss, **parts, **om}

    return train_step


def make_eval_step(cfg: ModelConfig) -> Callable:
    """``eval_step(params, batch) -> {"loss", "ce", "aux", "tokens"}``."""
    @torch.no_grad()
    def eval_step(params, batch):
        loss, parts = loss_fn(params, cfg, batch)
        return {"loss": loss, **parts}
    return eval_step
