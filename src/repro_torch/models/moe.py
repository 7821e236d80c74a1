"""Mixture-of-Experts FFN: GShard-style routing with capacity, dispatch and
combine by slot index.

Counterpart of ``repro.models.moe``.  Tokens are routed top-k within groups
of ``min(S, moe_group)`` tokens, and each expert takes at most ``capacity``
tokens per group, in the order in which the reference's top-k loop fills
its slots: over the group's (token, choice) pairs in choice-major order
(every token's first choice, then every second choice, ...), an exclusive
count per expert gives each pair its position there, and a pair at
position ``capacity`` or later is dropped, pad tokens included.  Where the
reference builds one-hot dispatch and combine tensors (G, T, E, C) and
contracts them by einsums, each kept pair here has one flat slot (e, g, c):
dispatch gathers the tokens' rows into the slots by a slot-to-token table
(an empty slot reads a zero row), the experts run the reference's three
products over every slot, and combine gathers each pair's slot row and
sums a token's K rows weighted by their gate values, accumulating in
float32 as the reference's product does.  The reference computes all of it
outside any Pallas kernel too.

Expert-parallel with ``tp`` (a ``launch.collectives.TP`` over ``"model"``):
the router is replicated, so every rank assigns the same slots, and runs
its own ``E / tp`` experts (the expert weights are its shards) on their
slots, its combine taking the other experts' pairs as dropped; the output
is summed over the ranks.
The load-balancing loss is a product of two means over the batch's
tokens: with ``dp_groups`` (the process groups of the mesh dims that split
the batch) the per-expert sums and the token count are summed over those
ranks first, so every rank holds the global batch's aux loss.

While spans record (``repro_torch.obs``), ``moe_ffn`` adds to the
innermost span's counters (the model's ``model.moe``): the ``routed``
(token, choice) pairs G T K, those ``kept`` within capacity and the
``slots`` computed, G E C, over all E experts under ``tp`` too (every rank
routes the same tokens).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch import obs
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.collectives import copy_to, reduce_out, sum_over
from repro_torch.models.layers import DTYPES, dense_init
from repro_torch.models.sharding import constrain
from repro_torch.models.ssm import silu


def init_moe(gen, cfg: ModelConfig, device: torch.device) -> Dict:
    dt = DTYPES[cfg.param_dtype]
    e, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    f32 = torch.float32

    def experts(rows: int, cols: int) -> torch.Tensor:
        w = torch.randn(e, rows, cols, generator=gen, dtype=f32,
                        device=device)
        return (w / math.sqrt(rows)).to(dt)

    return {"router": dense_init(gen, d, e, f32, device),
            "w_gate": experts(d, f), "w_up": experts(d, f),
            "w_down": experts(f, d)}


def capacity(cfg: ModelConfig, group: int) -> int:
    """Slots per expert and group: the capacity factor's share, rounded up
    to a multiple of 4, at least 4."""
    c = int(math.ceil(group * cfg.top_k * cfg.capacity_factor /
                      cfg.n_experts))
    return max(4, ((c + 3) // 4) * 4)


def route(p: Dict, cfg: ModelConfig, xg: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xg: (G, T, d) -> the router's float32 probabilities (G, T, E), the
    top-k gate values renormalised over k and their experts (G, T, K),
    largest first.  ``jax.lax.top_k`` takes the lower index on ties and
    ``torch.topk`` leaves their order open; with float32 router logits a
    tie has measure zero."""
    probs = torch.softmax(xg.float() @ p["router"], dim=-1)
    gate_vals, gate_idx = torch.topk(probs, cfg.top_k, dim=-1)
    return probs, gate_vals / gate_vals.sum(-1, keepdim=True), gate_idx


def _aux_loss(probs: torch.Tensor, gate_idx: torch.Tensor, e: int,
              dp_groups) -> torch.Tensor:
    """The Switch/GShard load-balancing loss: E x sum over the experts of
    the mean router probability times the share of top-1 picks.  Over
    ``dp_groups`` the means are the global batch's (differentiable sums:
    each rank takes the gradient of its own tokens' part, so that the
    batch's gradient, summed over those ranks, counts the loss once)."""
    f32 = torch.float32
    top1 = torch.nn.functional.one_hot(gate_idx[..., 0], e).to(f32)
    if not dp_groups:
        me = probs.mean(dim=(0, 1))
        ce = top1.mean(dim=(0, 1))
        return (me * ce).sum() * e
    n = torch.full((1,), float(probs.shape[0] * probs.shape[1]), dtype=f32,
                   device=probs.device)
    sums = sum_over(torch.cat([probs.sum(dim=(0, 1)), top1.sum(dim=(0, 1)),
                               n]), dp_groups)
    me, ce = sums[:e] / sums[-1], sums[e:2 * e] / sums[-1]
    return (me * ce).sum() * e


def _gather_sum(rows: torch.Tensor, at: torch.Tensor, w: torch.Tensor
                ) -> torch.Tensor:
    """rows (N, d), at and w (..., K) -> (..., d): the sum over k of
    w[..., k] rows[at[..., k]], as one batched product, which accumulates
    in float32 and rounds once to ``rows``' dtype."""
    got = rows.index_select(0, at.reshape(-1)).view(*at.shape, rows.shape[1])
    return (w.unsqueeze(-2) @ got).squeeze(-2)


class _Dispatch(torch.autograd.Function):
    """rows (N, d) -> the slots' rows, ``rows[table]`` with N a zero row.
    The gradient of a token's row is the sum of its pairs' slots' gradients
    (slots ``at``, weights ``mine``: 0 for a dropped pair), a gather by
    :func:`_gather_sum`.  ``index_select``'s own backward would add them by
    atomics, each rounding to a bf16 row, and every empty slot's into the
    zero row."""

    @staticmethod
    def forward(ctx, rows, table, at, mine):
        ctx.save_for_backward(at, mine)
        return torch.cat([rows, rows.new_zeros(1, rows.shape[1])]
                         ).index_select(0, table)

    @staticmethod
    def backward(ctx, grad):
        at, mine = ctx.saved_tensors
        got = _gather_sum(grad, at, mine.to(grad.dtype))
        return got.reshape(-1, grad.shape[1]), None, None, None


def moe_ffn(p: Dict, cfg: ModelConfig, x: torch.Tensor, *, tp=None,
            dp_groups=()) -> Dict:
    """x: (B, S, d) -> {"out": (B, S, d), "aux_loss": float32 scalar}.  S
    must be at most ``moe_group`` or a multiple of it.  ``tp`` and
    ``dp_groups`` as the module docstring says."""
    b, s, d = x.shape
    t = min(s, cfg.moe_group)
    if s % t:
        raise ValueError(
            f"S = {s} must be at most moe_group = {cfg.moe_group} or a "
            f"multiple of it: the reference's routing-group contract "
            f"(repro/models/moe.py:44-46)")
    g = b * (s // t)
    e, k = cfg.n_experts, cfg.top_k
    c = capacity(cfg, t)
    dev = x.device
    xg = x.reshape(g, t, d)
    probs, gate_vals, gate_idx = route(p, cfg, xg)
    aux = _aux_loss(probs, gate_idx, e, dp_groups)

    # each pair's position at its expert (G, T, K): an exclusive count
    # over the group's pairs in choice-major order, along the innermost dim
    # (a scan along an outer dim runs one thread per column on the card)
    pick = gate_idx.transpose(1, 2).reshape(g, 1, k * t)
    hot = torch.zeros((g, e, k * t), dtype=torch.int32, device=dev)
    hot.scatter_(1, pick, 1)
    pos = hot.cumsum(2, dtype=torch.int32).gather(1, pick) - 1
    pos = pos.view(g, k, t).transpose(1, 2)
    keep = pos < c
    if obs.recording():
        obs.count(routed=g * t * k, kept=keep.sum(), slots=g * e * c)

    el, e0 = e, 0
    if tp is not None:                   # this rank's experts
        el = p["w_gate"].shape[0]
        e0 = tp.start(el)
        xg = copy_to(xg, tp)
        gate_vals = copy_to(gate_vals, tp)
    # a kept pair of this rank's experts takes slot (e, g, c) of the n; the
    # others are past the table, and read slot n - 1 at weight 0
    n = el * g * c
    expert = gate_idx - e0
    mine = keep & (expert >= 0) & (expert < el)
    group = torch.arange(g, device=dev).view(g, 1, 1)
    slot = torch.where(mine, (expert * g + group) * c + pos, n)
    table = torch.full((n + 1,), g * t, dtype=torch.long, device=dev)
    table.index_put_((slot,), torch.arange(g * t, device=dev).view(g, t, 1))
    at = slot.clamp(max=n - 1)

    xe = _Dispatch.apply(xg.reshape(g * t, d), table[:n], at, mine)
    xe = constrain(xe.view(el, g, c, d), "ep", "dp", None, None,
                   full=(e, None, None, None))
    h = silu(torch.einsum("egcd,edf->egcf", xe, p["w_gate"]))
    h = h * torch.einsum("egcd,edf->egcf", xe, p["w_up"])
    ye = torch.einsum("egcf,efd->egcd", h, p["w_down"])
    ye = constrain(ye, "ep", "dp", None, None, full=(e, None, None, None))
    cdt = torch.float32 if cfg.moe_combine_f32 else x.dtype
    w = torch.where(mine, gate_vals.to(cdt), 0).to(ye.dtype)
    out = _gather_sum(ye.reshape(n, d), at, w).reshape(b, s, d)
    if tp is not None:
        out = reduce_out(out, tp)
    return {"out": out.to(x.dtype), "aux_loss": aux}
