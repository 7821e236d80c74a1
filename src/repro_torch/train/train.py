"""Train step and eval loss, closed over (cfg, opt).

Counterpart of ``repro.train.train``.  A train state is ``{"params",
"opt": {"mu", "nu", "step"}}``; a step computes the gradients with
``torch.autograd.grad`` and updates the state in place
(``optimizer.adamw_update``).  The reference draws its initial weights from
``jax.random``, which the port cannot reproduce: :func:`init_train_state`
takes the seed of the port's ``torch.Generator`` instead
(``convert.train_state_from_numpy`` carries a reference state over).

A state of tensors on one device runs as it is.  A state of ``DTensor``
leaves on a mesh (placed by ``launch.shardings.state_shardings`` and
``shard_tree``) runs the sharded step, the port's form of the
reference's ``jax.jit(make_train_step(...), in_shardings=(state
shardings, None))``: each rank takes its rows of the global batch when the
active rules (``models.sharding.use_rules``) shard ``dp`` and runs the
sharded forward (``models.transformer``: each block gathers its
parameters over ``"data"`` as it runs and computes on this rank's
``"model"`` shards; the logits are this rank's columns of the
vocabulary, so the cross-entropy takes its log-sum-exp from a max and a
sum over the ranks and the target's logit from the rank that holds it;
where the heads do not divide, each rank attends over its slice of the
keys and the gradients flow through the log-sum-exp merge; under
Megatron-SP the residual is split along the sequence between blocks and
the loss is taken on the gathered sequence).
It normalises its partial loss by the global count of valid tokens, so
that the gradients summed over the batch-sharding mesh dims are the
gradients of the global batch's loss; ranks that repeat the same rows
(along ``"model"``) are not summed.  An MoE layer's load-balancing aux
loss is the global batch's on every rank (``models.moe``: its routing
statistics are summed over the batch's ranks inside the model); it enters
each rank's loss once, undivided, and the sum's backward passes each rank
the gradient of its own tokens' statistics, so that the gradients summed
over the ranks count it once.  The gradients come back with the
parameters' placements and AdamW updates each rank's shards.  The
reference's microbatch ``constrain`` maps onto ``models.sharding.
constrain``.
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
from repro_torch.models.sharding import (batch_axes, constrain, get_rules,
                                         local_rows)
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


def _loss_terms(params, cfg: ModelConfig, batch: Dict):
    """(sum of the masked token NLLs in float32, count of valid targets,
    MoE aux loss)."""
    logits, aux = apply_model(params, cfg, batch)
    targets = batch["targets"]
    logits = logits[:, frontend_input(cfg).text_offset:]   # text positions
    mask = ((targets >= 0) & (targets < cfg.raw_vocab_size)).float()
    logits = logits.float()
    tgt = targets.clamp(0, cfg.vocab_size - 1)
    if logits.shape[-1] == cfg.vocab_size:
        lse = torch.logsumexp(logits, dim=-1)
        picked = torch.gather(logits, -1, tgt[..., None].long())[..., 0]
    else:                            # this rank's columns of the vocabulary
        lse, picked = _vocab_parallel(logits, tgt)
    nll = (lse - picked) * mask
    return nll.sum(), mask.sum(), aux


def _vocab_parallel(logits: torch.Tensor, targets: torch.Tensor):
    """(log-sum-exp, the target's logit) of logits whose columns are this
    rank's part of the vocabulary along ``"model"``: the row max and the
    sum of exps over the ranks, the target's logit from its rank."""
    from repro_torch.launch.collectives import max_over, reduce_from, tp_of
    mesh, _ = get_rules()
    tp = tp_of(mesh)
    n = logits.shape[-1]
    m = max_over(logits.amax(dim=-1), tp)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    lse = reduce_from((logits - m[..., None]).exp().sum(dim=-1), tp).log() + m
    local = targets - tp.start(n)
    mine = (local >= 0) & (local < n)
    picked = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None].long()
                          )[..., 0]
    return lse, reduce_from(torch.where(mine, picked,
                                        torch.zeros_like(picked)), tp)


def loss_fn(params, cfg: ModelConfig, batch: Dict
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Cross-entropy in float32 over the targets in ``[0,
    raw_vocab_size)`` (others are masked out), averaged over the valid
    tokens, plus ``AUX_LOSS_WEIGHT`` times the MoE aux loss."""
    nll, count, aux = _loss_terms(params, cfg, batch)
    denom = torch.clamp_min(count, 1.0)
    ce = nll / denom
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


def is_sharded(state) -> bool:
    """Whether the leaves of ``state`` are ``DTensor`` objects."""
    from torch.distributed.tensor import DTensor
    return isinstance(tree.leaves(state)[0], DTensor)


def _sum_over(t: torch.Tensor, mesh, axes: Tuple[str, ...]) -> torch.Tensor:
    """``t`` summed over the ranks of the mesh dims ``axes`` (in place)."""
    import torch.distributed as dist
    for a in axes:
        if mesh.size(mesh.mesh_dim_names.index(a)) > 1:
            dist.all_reduce(t, group=mesh.get_group(a))
    return t


def _sharded_value_and_grad(params, cfg: ModelConfig, batch: Dict):
    """:func:`_value_and_grad` of the global batch on parameters that are
    ``DTensor`` objects: the gradients are ``DTensor`` objects with the
    parameters' placements; the loss and its parts are the global
    batch's, on every rank.  The forward gathers each block's parameters
    as it runs it (``models.transformer``), never the whole tree."""
    from torch.distributed.tensor import DTensor
    leaves = tree.leaves(params)
    mesh = leaves[0].device_mesh
    axes = batch_axes(mesh)
    local = local_rows(batch, mesh, axes)
    with torch.enable_grad():
        live = [p.to_local().detach().requires_grad_(True) for p in leaves]
        wrapped = [DTensor.from_local(x, mesh, p.placements, run_check=False,
                                      shape=p.shape, stride=p.stride())
                   for x, p in zip(live, leaves)]
        swap = dict(zip(map(id, leaves), wrapped))
        nll, count, aux = _loss_terms(
            tree.tree_map(lambda p: swap[id(p)], params), cfg, local)
        denom = torch.clamp_min(_sum_over(count.detach().clone(), mesh, axes),
                                1.0)
        ce = nll / denom
        loss = ce + AUX_LOSS_WEIGHT * aux     # aux: the global batch's
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [DTensor.from_local(torch.zeros_like(x) if g is None else g,
                                mesh, p.placements, run_check=False)
             for x, g, p in zip(live, grads, leaves)]
    ce = _sum_over(ce.detach().clone(), mesh, axes)
    aux = aux.detach()
    return ce + AUX_LOSS_WEIGHT * aux, {"ce": ce, "aux": aux,
                                        "tokens": denom}, grads


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
        vg = _sharded_value_and_grad if is_sharded(params) else \
            _value_and_grad
        if grad_accum == 1:
            loss, parts, grads = vg(params, cfg, batch)
        else:
            micro = [{k: constrain(v.reshape(grad_accum,
                                             v.shape[0] // grad_accum,
                                             *v.shape[1:])[j], "dp",
                                   *([None] * (v.dim() - 1)))
                      for k, v in batch.items()} for j in range(grad_accum)]
            gsum = [torch.zeros_like(p, dtype=acc_dt)
                    for p in tree.leaves(params)]
            lsum = torch.zeros((), dtype=torch.float32,
                               device=gsum[0].device)
            parts_all = []
            for mb in micro:
                l, parts_i, g = vg(params, cfg, mb)
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
