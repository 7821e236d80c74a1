"""Plain reference of the training step: cross-entropy over the valid
targets plus 0.01 times the MoE aux loss, averaged over ``grad_accum``
microbatches (the batch's leading rows split in order), gradients summed
in float32, then AdamW (global-norm clipping, linear warmup and cosine
decay, bias-corrected moments in float32, decoupled weight decay on leaves
of two or more dims), each parameter stored back in its own dtype.
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from bench.reference import lm

AUX_WEIGHT = 0.01


class AdamW(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def lr_at(o: AdamW, step: int) -> float:
    warm = min((step + 1.0) / max(1, o.warmup_steps), 1.0)
    prog = min(max((step - o.warmup_steps) /
                   max(1, o.total_steps - o.warmup_steps), 0.0), 1.0)
    scale = o.min_lr_ratio + (1 - o.min_lr_ratio) * 0.5 * (
        1 + math.cos(math.pi * prog))
    return o.lr * warm * scale


def microbatch_loss(live: Dict, c: Dict, tokens: torch.Tensor,
                    targets: torch.Tensor, fp8: bool) -> torch.Tensor:
    s = tokens.shape[1]
    h, aux = lm.hidden(live, c, tokens, None, lm.routing_groups(c, s), fp8,
                       remat=True)
    off = c.get("n_patches", 0) if c["family"] == "vlm" else 0
    lg = lm.logits(live, c, h[:, off:], fp8)
    valid = (targets >= 0) & (targets < c["raw_vocab_size"])
    nll = F.cross_entropy(lg.reshape(-1, lg.shape[-1]),
                          targets.clamp(0, c["vocab_size"] - 1).reshape(-1),
                          reduction="none").view(targets.shape)
    ce = (nll * valid).sum() / valid.sum().clamp_min(1)
    return ce + AUX_WEIGHT * aux


def grads(params: Dict, names: List[Tuple[str, torch.Tensor]], c: Dict,
          tokens: torch.Tensor, targets: torch.Tensor, accum: int,
          fp8: bool) -> Tuple[float, List[torch.Tensor]]:
    """(loss, float32 gradient of each leaf of ``names``) of one step."""
    from bench.core.weights import leaf_specs
    specs = leaf_specs(c)
    total = [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
             for _, t in names]
    loss = 0.0
    rows = tokens.shape[0] // accum
    for j in range(accum):
        live_leaves = [t.detach().float().requires_grad_(True)
                       for _, t in names]
        live = _tree_like(params, specs, live_leaves)
        with torch.enable_grad():
            l = microbatch_loss(live, c, tokens[j * rows:(j + 1) * rows],
                                targets[j * rows:(j + 1) * rows], fp8)
            g = torch.autograd.grad(l, live_leaves, allow_unused=True)
        for acc, gi in zip(total, g):
            if gi is not None:
                acc += gi
        loss += float(l.detach()) / accum
        del live, live_leaves, g, l
    return loss, [t / accum for t in total]


def _tree_like(params, specs, leaves):
    from bench.core.weights import _set
    tree: Dict = {}
    for spec, t in zip(specs, leaves):
        _set(tree, spec.path, t)
    return tree


class Adam:
    """AdamW state over the leaves of ``names``, updating them in place."""

    def __init__(self, names, opt: AdamW):
        self.opt = opt
        self.mu = [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
                   for _, t in names]
        self.nu = [torch.zeros_like(m) for m in self.mu]
        self.step = 0

    @torch.no_grad()
    def update(self, names, gs: List[torch.Tensor]) -> List[float]:
        """One step; returns each leaf's clipped-gradient norm."""
        o = self.opt
        gnorm = torch.sqrt(sum(g.square().sum() for g in gs))
        scale = torch.clamp_max(o.clip_norm / (gnorm + 1e-9), 1.0)
        lr = lr_at(o, self.step)
        t = self.step + 1
        bc1, bc2 = 1 - o.b1 ** t, 1 - o.b2 ** t
        norms = []
        for (_, p), g, mu, nu in zip(names, gs, self.mu, self.nu):
            g = g * scale
            norms.append(float(g.norm()))
            mu.mul_(o.b1).add_(g, alpha=1 - o.b1)
            nu.mul_(o.b2).add_(g.square(), alpha=1 - o.b2)
            delta = (mu / bc1) / ((nu / bc2).sqrt() + o.eps)
            wd = o.weight_decay if p.dim() >= 2 else 0.0
            pf = p.float()
            p.copy_(pf - lr * (delta + wd * pf))
        self.step += 1
        return norms
