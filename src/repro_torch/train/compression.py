"""Gradient compression for the DP all-reduce: int8 quantization with error
feedback.

Counterpart of ``repro.train.compression``, arithmetic line for line.
Two-phase shared-scale scheme:
  1. all-reduce (MAX) each rank's |g + err|_max over the DP group -> one
     shared scale (/ 127, at least 1e-20),
  2. quantize to int8 (round half to even, clip to +-127), all-reduce (SUM)
     in int32, dequantize, divide by the group's size.
The quantization residual is carried in an error-feedback buffer so that
the bias vanishes over steps (EF-SGD).  The payload shrinks ~3.97x (int8
plus one scale per tensor vs float32).  ``group`` is a process group (the
DP dim's of a mesh, ``mesh.get_group("data")``); ``None`` is the default
group.
"""
from __future__ import annotations

from typing import List, Tuple

import torch
import torch.distributed as dist

from repro_torch import tree


def quantize(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


@torch.no_grad()
def psum_compressed(g: torch.Tensor, err: torch.Tensor, group=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean-reduce ``g`` over ``group`` in int8: (reduced grad, new
    error-feedback buffer).  A collective: every rank of the group calls
    it."""
    g_corr = g.to(torch.float32) + err
    scale = torch.max(torch.abs(g_corr)).reshape(1)
    dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
    # divisions by tensors: CUDA turns a division by a Python scalar into a
    # product with its reciprocal, which the reference does not
    scale = torch.clamp_min(scale[0] / _f32(127.0, g_corr), 1e-20)
    q = quantize(g_corr, scale)
    new_err = g_corr - dequantize(q, scale)
    total = q.to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    n = _f32(dist.get_world_size(group), g_corr)
    return total.to(torch.float32) * scale / n, new_err


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def psum_compressed_tree(grads, err_state, group=None):
    """:func:`psum_compressed` on every leaf, ``err_state``'s leaves taken
    in the order of ``grads``' (a parameter tree, or a list of its leaves
    in order): (grads like ``grads``, error state like ``err_state``)."""
    g_paths = tree.leaves_with_paths(grads)
    e_paths = tree.leaves_with_paths(err_state)
    out = [psum_compressed(g, e, group)
           for (_, g), (_, e) in zip(g_paths, e_paths)]
    g_new = {p: o[0] for (p, _), o in zip(g_paths, out)}
    e_new = {p: o[1] for (p, _), o in zip(e_paths, out)}
    return (tree.map_with_paths(lambda p, _: g_new[p], grads),
            tree.map_with_paths(lambda p, _: e_new[p], err_state))


def init_error_state(params):
    return tree.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params)


def compression_ratio(params) -> float:
    """Bytes saved vs a float32 all-reduce: int8 payload + one float32 scale
    per tensor."""
    sizes: List[int] = [l.numel() for l in tree.leaves(params)]
    total_f32 = sum(n * 4 for n in sizes)
    total_c = sum(n * 1 + 4 for n in sizes)
    return total_f32 / total_c
