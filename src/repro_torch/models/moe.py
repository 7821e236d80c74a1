"""Mixture-of-Experts FFN: GShard-style dense dispatch with capacity.

Counterpart of ``repro.models.moe``.  Tokens are routed top-k within groups
of ``min(S, moe_group)`` tokens, each expert takes at most ``capacity``
tokens per group in the order of a cumulative sum over the group (a token
routed past an expert's capacity is dropped there, pad tokens included),
and the dispatch and combine tensors (G, T, E, C) are contracted with the
expert weights by plain products: the JAX package computes them outside any
Pallas kernel too.

Expert-parallel with ``tp`` (a ``launch.collectives.TP`` over ``"model"``):
the router is replicated, so every rank builds the same dispatch, and runs
its own ``E / tp`` experts (the expert weights are its shards) on its slice
of the dispatch and combine tensors; the output is summed over the ranks.
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
    e = cfg.n_experts
    c = capacity(cfg, t)
    f32 = torch.float32
    xg = x.reshape(g, t, d)
    probs, gate_vals, gate_idx = route(p, cfg, xg)
    aux = _aux_loss(probs, gate_idx, e, dp_groups)

    cdt = f32 if cfg.moe_combine_f32 else x.dtype
    dispatch = torch.zeros((g, t, e, c), dtype=x.dtype, device=x.device)
    combine = torch.zeros((g, t, e, c), dtype=cdt, device=x.device)
    counts = torch.zeros((g, e), dtype=f32, device=x.device)
    slots = torch.arange(c, dtype=f32, device=x.device)
    for j in range(cfg.top_k):
        m_j = torch.nn.functional.one_hot(gate_idx[..., j], e).to(f32)
        pos_in_e = torch.cumsum(m_j, dim=1) - m_j + counts[:, None, :]
        counts = counts + m_j.sum(dim=1)
        pos_j = (pos_in_e * m_j).sum(dim=-1)                 # (G, T)
        keep = (pos_j < c) & (m_j.sum(dim=-1) > 0)
        # jax.nn.one_hot(pos_j, c): a zero row for pos_j >= c (a drop)
        slot = (pos_j[..., None] == slots).to(f32) * keep[..., None]
        contrib = m_j[..., :, None] * slot[..., None, :]     # (G, T, E, C)
        dispatch = dispatch + contrib.to(x.dtype)
        combine = combine + (contrib * gate_vals[..., j, None, None]).to(cdt)
    if obs.recording():
        # an expert's pairs take its slots in order: min(count, C) are kept
        obs.count(routed=g * t * cfg.top_k, kept=counts.clamp(max=c).sum(),
                  slots=g * e * c)

    if tp is not None:                   # this rank's experts
        el = p["w_gate"].shape[0]
        e0 = tp.start(el)
        xg = copy_to(xg, tp)
        dispatch = dispatch[:, :, e0:e0 + el]
        combine = copy_to(combine, tp)[:, :, e0:e0 + el]
    xe = torch.einsum("gtec,gtd->egcd", dispatch, xg)
    xe = constrain(xe, "ep", "dp", None, None, full=(e, None, None, None))
    h = silu(torch.einsum("egcd,edf->egcf", xe, p["w_gate"]))
    h = h * torch.einsum("egcd,edf->egcf", xe, p["w_up"])
    ye = torch.einsum("egcf,efd->egcd", h, p["w_down"])
    ye = constrain(ye, "ep", "dp", None, None, full=(e, None, None, None))
    out = torch.einsum("egcd,gtec->gtd", ye, combine.to(ye.dtype))
    out = out.reshape(b, s, d)
    if tp is not None:
        out = reduce_out(out, tp)
    return {"out": out.to(x.dtype), "aux_loss": aux}
