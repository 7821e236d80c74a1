"""The collectives of the tensor-parallel model: the Megatron pair and the
few gathers and reductions its layers need, over the ``"model"`` dim (or
the batch's dims) of a ``DeviceMesh``.

No counterpart in the reference: GSPMD inserts these from its sharding
constraints.  Every function here calls only ``all_gather_into_tensor``,
``reduce_scatter_tensor``, ``all_reduce`` and ``broadcast``: DTensor's
functional collectives and ``batch_isend_irecv`` do not finish over gloo
on CUDA tensors (ROADMAP.md queue 3, a finding of the card's machine).

A :class:`TP` names one mesh dim's process group, its size and this
rank's place in it.  In a layer that runs on local shards:

- :func:`copy_to` marks a tensor that every rank holds alike (an
  activation, a replicated parameter) entering the rank's own part of the
  work: identity forward, the gradient summed over the group backward;
- :func:`reduce_from` sums the ranks' partial results (a row-parallel
  product): summed forward, identity backward, since every rank then
  holds the same result and its gradient.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch


class TP(NamedTuple):
    """One mesh dim's process group (``group``), its size and this rank's
    index along it."""
    group: object
    size: int
    rank: int

    def start(self, local: int) -> int:
        """The first global index of this rank's ``local`` rows."""
        return self.rank * local


def tp_of(mesh):
    """The :class:`TP` of the mesh's ``"model"`` dim, or None if the mesh
    has no such dim or it has one rank."""
    if mesh is None or "model" not in (mesh.mesh_dim_names or ()):
        return None
    i = mesh.mesh_dim_names.index("model")
    if mesh.size(i) == 1:
        return None
    return TP(mesh.get_group(i), mesh.size(i), mesh.get_local_rank(i))


def _all_reduce(x: torch.Tensor, group, op=None) -> torch.Tensor:
    import torch.distributed as dist
    x = x.clone(memory_format=torch.contiguous_format)
    if op is None:
        dist.all_reduce(x, group=group)
    else:
        dist.all_reduce(x, op=op, group=group)
    return x


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        for group in groups:
            x = _all_reduce(x, group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to(x: torch.Tensor, tp: TP) -> torch.Tensor:
    """``x`` as it is; its gradient summed over ``tp``'s ranks."""
    return _CopyTo.apply(x, tp.group)


def reduce_from(x: torch.Tensor, tp: TP) -> torch.Tensor:
    """``x`` summed over ``tp``'s ranks; its gradient passed as it is."""
    return _ReduceFrom.apply(x, (tp.group,))


def sum_over(x: torch.Tensor, groups: Sequence) -> torch.Tensor:
    """``x`` summed over the ranks of each group in ``groups`` in turn
    (the batch's mesh dims), differentiable as :func:`reduce_from`: every
    rank holds the sum, and each takes the gradient of its own part."""
    if not groups:
        return x
    return _ReduceFrom.apply(x, tuple(groups))


def max_over(x: torch.Tensor, tp: TP) -> torch.Tensor:
    """The elementwise max of ``x`` over ``tp``'s ranks (no gradient)."""
    import torch.distributed as dist
    return _all_reduce(x.detach(), tp.group, dist.ReduceOp.MAX)


def gather_dim(x: torch.Tensor, dim: int, tp: TP) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order (no
    gradient)."""
    import torch.distributed as dist
    xt = x.detach().movedim(dim, 0).contiguous()
    out = xt.new_empty((tp.size * xt.shape[0],) + tuple(xt.shape[1:]))
    dist.all_gather_into_tensor(out, xt, group=tp.group)
    return out.movedim(0, dim)


def argmax_over(x: torch.Tensor, tp: TP) -> torch.Tensor:
    """The index of the largest value along the last dim of ``x`` (each
    rank holding the next ``x.shape[-1]`` columns of the whole row, in
    rank order), the lowest on ties, as ``jnp.argmax``; every rank gets
    the same indices."""
    n = x.shape[-1]
    val, idx = x.detach().max(dim=-1)
    idx = idx + tp.start(n)
    vals = gather_dim(val[None], 0, tp)                   # (tp, ...)
    idxs = gather_dim(idx[None], 0, tp)
    best = vals.max(dim=0).values
    cand = torch.where(vals == best[None], idxs,
                       torch.full_like(idxs, torch.iinfo(idxs.dtype).max))
    return cand.min(dim=0).values
