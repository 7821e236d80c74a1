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

Under Megatron-SP (the residual split along the sequence between blocks,
a :class:`TP` with ``seq``) a block gathers its input's sequence
(:func:`gather_seq`) and a mixer ends in :func:`reduce_out`, which
reduce-scatters the sequence (:func:`reduce_scatter`) where it would
all-reduce, or in :func:`same_out`, which keeps this rank's rows
(:func:`split_seq`) of an output every rank computed alike.  Throughout,
a tensor every rank holds alike carries its whole gradient on every rank.

:func:`merge_partials` joins the ranks' partial attentions over their
slices of the keys or of the cache by log-sum-exp.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch


class TP(NamedTuple):
    """One mesh dim's process group (``group``), its size and this rank's
    index along it; ``seq``: the block's residual is this rank's rows of
    the sequence (dim 1), split evenly over the group (Megatron-SP)."""
    group: object
    size: int
    rank: int
    seq: bool = False

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


def _all_gather(x: torch.Tensor, dim: int, tp: TP) -> torch.Tensor:
    import torch.distributed as dist
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((tp.size * xt.shape[0],) + tuple(xt.shape[1:]))
    dist.all_gather_into_tensor(out, xt, group=tp.group)
    return out.movedim(0, dim)


def gather_dim(x: torch.Tensor, dim: int, tp: TP) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order (no
    gradient)."""
    return _all_gather(x.detach(), dim, tp)


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


# ------------------------------------------------------------ Megatron-SP
def _rows(x: torch.Tensor, dim: int, tp: TP) -> torch.Tensor:
    n = x.shape[dim] // tp.size
    return x.narrow(dim, tp.start(n), n)


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return _all_gather(x, 1, tp)

    @staticmethod
    def backward(ctx, g):
        return _rows(g, 1, ctx.tp).contiguous(), None


class _SplitSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return _rows(x, 1, tp).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, 1, ctx.tp), None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, tp):
        import torch.distributed as dist
        ctx.dim, ctx.tp = dim, tp
        xt = x.movedim(dim, 0).contiguous()
        out = xt.new_empty((xt.shape[0] // tp.size,) + tuple(xt.shape[1:]))
        dist.reduce_scatter_tensor(out, xt, group=tp.group)
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.tp), None, None


def _even(size: int, tp: TP) -> None:
    if size % tp.size:
        raise ValueError(f"a sequence of {size} does not split evenly over "
                         f"{tp.size} ranks (Megatron-SP needs seq_len % tp "
                         f"== 0)")


def gather_seq(x: torch.Tensor, tp: TP) -> torch.Tensor:
    """The whole sequence (dim 1) from every rank's rows of it, in rank
    order; backward, this rank's rows of the gradient (every rank holds
    the whole sequence alike, and its whole gradient)."""
    return _GatherSeq.apply(x, tp)


def split_seq(x: torch.Tensor, tp: TP) -> torch.Tensor:
    """This rank's rows (dim 1) of ``x``, which every rank holds alike;
    backward, the ranks' row gradients gathered."""
    _even(x.shape[1], tp)
    return _SplitSeq.apply(x, tp)


def reduce_scatter(x: torch.Tensor, dim: int, tp: TP) -> torch.Tensor:
    """The ranks' ``x`` summed, and this rank's rows of the sum along
    ``dim`` (``reduce_scatter_tensor``); backward, the ranks' row
    gradients gathered."""
    _even(x.shape[dim], tp)
    return _ReduceScatter.apply(x, dim, tp)


def reduce_out(x: torch.Tensor, tp: TP) -> torch.Tensor:
    """A row-parallel mixer's output, summed over ``tp``'s ranks: whole
    on every rank (:func:`reduce_from`), or under Megatron-SP this rank's
    rows of the sequence (:func:`reduce_scatter`)."""
    return reduce_scatter(x, 1, tp) if tp.seq else reduce_from(x, tp)


def same_out(x: torch.Tensor, tp: TP) -> torch.Tensor:
    """A mixer's output that every rank of ``tp`` computed alike: as it
    is, or under Megatron-SP this rank's rows of the sequence."""
    return split_seq(x, tp) if tp.seq else x


# ------------------------------------------------------- partial softmax
def merge_partials(out: torch.Tensor, lse: torch.Tensor,
                   groups: Sequence) -> torch.Tensor:
    """Attention over every key from the ranks' partials over their own
    keys: ``out`` (..., D), each rank's normalised attention over its keys
    (0 where it saw none), ``lse`` (...) float32, their log-sum-exps (-inf
    where none), merged over the ranks of each group in ``groups`` as
    sum_r w_r out_r / sum_r w_r with w_r = exp(lse_r - M), M the max over
    the ranks (detached: the result does not depend on it).  The sums are
    one ``all_reduce`` a group with the backward of :func:`reduce_from`, so
    each rank takes the gradient of its own partial.  A row no rank saw
    comes out as 0.  In ``out``'s dtype; no group: ``out``."""
    import torch.distributed as dist
    if not groups:
        return out
    m = lse.detach()
    for group in groups:
        m = _all_reduce(m, group, dist.ReduceOp.MAX)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    w = torch.exp(lse - m)[..., None]
    both = sum_over(torch.cat([out.float() * w, w], dim=-1), groups)
    num, den = both[..., :-1], both[..., -1:]
    den = torch.where(den > 0, den, torch.ones_like(den))
    return (num / den).to(out.dtype)
