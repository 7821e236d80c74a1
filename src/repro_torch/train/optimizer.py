"""AdamW + clipping + LR schedule over the port's parameter trees.

Counterpart of ``repro.train.optimizer``.  Moments are stored in
``cfg.opt_dtype`` (float32; bfloat16 for arctic-480b); the update math runs
in float32 and is cast back to each leaf's dtype.  The reference returns new
pytrees; here parameters and moments are overwritten in place under
``torch.no_grad()`` (``copy_``), as ``core/training.py``'s Adam does, so a
caller holding the same dicts sees the update.  Nothing is read back to the
host: the schedule and the clip scale stay device scalars.

On a sharded state (``DTensor`` leaves, ``train.train``'s sharded step)
each rank updates its own shards; the gradients must carry the
parameters' placements.  The global norm sums each leaf's local squares
once (a replicated leaf on the ranks at coordinate 0 of the mesh dims it
is replicated over) and all-reduces the sum over every mesh dim, so the
shards add in another order than one device's leaf sums do.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple, Union

import torch

from repro_torch import tree
from repro_torch.models.layers import DTYPES


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def lr_at(opt: AdamWConfig, step: Union[int, torch.Tensor]) -> torch.Tensor:
    """Linear warmup then cosine decay to min_lr_ratio * lr (float32)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp_max((step + 1.0) / max(1, opt.warmup_steps), 1.0)
    prog = torch.clamp((step - opt.warmup_steps) /
                       max(1, opt.total_steps - opt.warmup_steps), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    scale = opt.min_lr_ratio + (1.0 - opt.min_lr_ratio) * cos
    return opt.lr * warm * scale


def init_opt_state(params, opt_dtype: str) -> Dict:
    """Zero moments in ``opt_dtype`` shaped like ``params``; step 0 (int64)
    on the parameters' device."""
    dt = DTYPES[opt_dtype]
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    dev = tree.leaves(params)[0].device
    return {"mu": tree.tree_map(zeros, params),
            "nu": tree.tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int64, device=dev)}


def _local(t):
    """A ``DTensor``'s own shard; any other tensor as it is."""
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def global_norm(grads) -> torch.Tensor:
    """The float32 norm of every leaf of ``grads`` together (of the whole
    tensors, for ``DTensor`` leaves: a collective over their mesh)."""
    from torch.distributed.tensor import DTensor
    leaves = tree.leaves(grads)
    if not isinstance(leaves[0], DTensor):
        return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                              for g in leaves))
    import torch.distributed as dist
    mesh = leaves[0].device_mesh
    coord = mesh.get_coordinate()
    owned = [g for g in leaves
             if all(c == 0 for c, pl in zip(coord, g.placements)
                    if not pl.is_shard())]
    total = sum((torch.sum(torch.square(g.to_local().float()))
                 for g in owned),
                torch.zeros((), dtype=torch.float32,
                            device=leaves[0].to_local().device))
    for i in range(mesh.ndim):
        if mesh.size(i) > 1:
            dist.all_reduce(total, group=mesh.get_group(i))
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(params, grads, opt_state: Dict, opt: AdamWConfig
                 ) -> Tuple[Dict, Dict, Dict]:
    """One AdamW step in place; returns (params, opt_state, metrics) with
    metrics {"grad_norm", "lr"} as device scalars.

    Gradients are clipped by their global norm, the moments are
    bias-corrected, and leaves of ``ndim < 2`` (norms, biases) take no
    weight decay.
    """
    step = _local(opt_state["step"])
    gnorm = global_norm(grads)
    scale = torch.clamp_max(opt.clip_norm / (gnorm + 1e-9), 1.0)
    lr = lr_at(opt, step)
    t = (step + 1).to(torch.float32)
    bc1 = 1.0 - opt.b1 ** t
    bc2 = 1.0 - opt.b2 ** t
    for p, g, mu, nu in zip(tree.leaves(params), tree.leaves(grads),
                            tree.leaves(opt_state["mu"]),
                            tree.leaves(opt_state["nu"])):
        p, g, mu, nu = _local(p), _local(g), _local(mu), _local(nu)
        g = g.float() * scale
        mu_f = opt.b1 * mu.float() + (1 - opt.b1) * g
        nu_f = opt.b2 * nu.float() + (1 - opt.b2) * torch.square(g)
        delta = (mu_f / bc1) / (torch.sqrt(nu_f / bc2) + opt.eps)
        wd = opt.weight_decay if p.dim() >= 2 else 0.0
        pf = p.float()
        p.copy_(pf - lr * (delta + wd * pf))
        mu.copy_(mu_f)
        nu.copy_(nu_f)
    step.add_(1)
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
