"""Mixture-of-Experts FFN: GShard-style dense dispatch with capacity.

Counterpart of ``repro.models.moe``.  Tokens are routed top-k within groups
of ``min(S, moe_group)`` tokens, each expert takes at most ``capacity``
tokens per group in the order of a cumulative sum over the group (a token
routed past an expert's capacity is dropped there, pad tokens included),
and the dispatch and combine tensors (G, T, E, C) are contracted with the
expert weights by plain products: the JAX package computes them outside any
Pallas kernel too.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import DTYPES, dense_init
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


def moe_ffn(p: Dict, cfg: ModelConfig, x: torch.Tensor) -> Dict:
    """x: (B, S, d) -> {"out": (B, S, d), "aux_loss": float32 scalar}.  S
    must be at most ``moe_group`` or a multiple of it."""
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

    # load-balancing auxiliary loss (Switch/GShard form)
    me = probs.mean(dim=(0, 1))
    ce = torch.nn.functional.one_hot(gate_idx[..., 0], e).to(f32).mean(
        dim=(0, 1))
    aux = (me * ce).sum() * e

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

    xe = torch.einsum("gtec,gtd->egcd", dispatch, xg)
    h = silu(torch.einsum("egcd,edf->egcf", xe, p["w_gate"]))
    h = h * torch.einsum("egcd,edf->egcf", xe, p["w_up"])
    ye = torch.einsum("egcf,efd->egcd", h, p["w_down"])
    out = torch.einsum("egcd,gtec->gtd", ye, combine.to(ye.dtype))
    return {"out": out.reshape(b, s, d).to(x.dtype), "aux_loss": aux}
