"""Primitive layers: inits, norms, FFNs, embeddings, rotary embeddings,
sinusoidal positions.

Counterpart of ``repro.models.layers``.  Layers are functions over plain
dicts of tensors with the reference's ``(in, out)`` weight layout.  Inits
draw from a ``torch.Generator`` (the reference draws from ``jax.random``, so
the values differ; the tests carry the reference's weights over instead).

Given ``tp`` (a ``launch.collectives.TP`` over ``"model"``), a layer runs
on this rank's shards, the weights being those shards: the FFN
column-parallel into its hidden units and row-parallel out, the embedding
and the logits over this rank's rows of the vocabulary.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.collectives import copy_to, reduce_from, reduce_out
from repro_torch.models.sharding import constrain

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def dense_init(gen: Optional[torch.Generator], in_dim: int, out_dim: int,
               dtype: torch.dtype, device: torch.device,
               scale: Optional[float] = None) -> torch.Tensor:
    """N(0, 1) * scale (default 1/sqrt(in_dim)), drawn in float32."""
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    w = torch.randn(in_dim, out_dim, generator=gen, dtype=torch.float32,
                    device=device)
    return (w * scale).to(dtype)


def embed_init(gen: Optional[torch.Generator], vocab: int, dim: int,
               dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    w = torch.randn(vocab, dim, generator=gen, dtype=torch.float32,
                    device=device)
    return (w * 0.02).to(dtype)


def norm_init(dim: int, device: torch.device) -> torch.Tensor:
    """A norm scale, stored as an offset from 1.0."""
    return torch.zeros(dim, dtype=torch.float32, device=device)


# --------------------------------------------------------------------- norms
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm over the last dim in float32, scaled by (1 + scale)."""
    xf = x.float()
    xf = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (xf * (1.0 + scale.float())).to(x.dtype)


head_rms_norm = rms_norm     # over the head dim of (..., H, Dh) q/k tensors


# ----------------------------------------------------------------------- FFN
def init_ffn(gen, cfg: ModelConfig, d_ff: int, device: torch.device) -> Dict:
    dt = DTYPES[cfg.param_dtype]
    return {
        "w_gate": dense_init(gen, cfg.d_model, d_ff, dt, device),
        "w_up": dense_init(gen, cfg.d_model, d_ff, dt, device),
        "w_down": dense_init(gen, d_ff, cfg.d_model, dt, device,
                             scale=1.0 / math.sqrt(d_ff)),
    }


def ffn(params: Dict, cfg: ModelConfig, x: torch.Tensor, *,
        tp=None) -> torch.Tensor:
    """Gated FFN: SwiGLU, or GeGLU with the tanh gelu for gemma (the
    default of ``jax.nn.gelu``).  With ``tp``: this rank's hidden units
    (``w_gate`` / ``w_up`` columns, ``w_down`` rows), the output summed
    over the ranks (``reduce_out``: under Megatron-SP, this rank's rows of
    the sequence)."""
    if tp is not None:
        x = copy_to(x, tp)
    gate = x @ params["w_gate"]
    gate = F.gelu(gate, approximate="tanh") if cfg.embed_scale \
        else F.silu(gate)
    h = constrain(gate * (x @ params["w_up"]), "dp", None, "tp_ff",
                  full=(None, None, cfg.d_ff))
    out = h @ params["w_down"]
    return out if tp is None else reduce_out(out, tp)


# -------------------------------------------------------------------- rotary
def rope_frequencies(d_head: int, theta: float,
                     device: Optional[torch.device] = None) -> torch.Tensor:
    exps = torch.arange(0, d_head, 2, dtype=torch.float32,
                        device=device) / d_head
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, Dh); positions: (B, S) int.  Split-halves rotation:
    cos/sin are computed in float32 from the positions, cast to x's dtype and
    applied in that dtype."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs             # (B, S, Dh/2)
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def sinusoidal_positions(n_pos: int, dim: int,
                         device: Optional[torch.device] = None, *,
                         start: int = 0) -> torch.Tensor:
    """Whisper-style sinusoidal absolute position table (n_pos, dim) in
    float32, rows ``start .. start + n_pos - 1`` (a row does not depend on
    the table's length, so decode takes its one row directly)."""
    log_timescale = math.log(10_000.0) / (dim // 2 - 1)
    inv = torch.exp(-log_timescale * torch.arange(dim // 2,
                                                  dtype=torch.float32,
                                                  device=device))
    scaled = torch.arange(start, start + n_pos, dtype=torch.float32,
                          device=device)[:, None] * inv[None, :]
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=1)


# --------------------------------------------------------------------- embed
def embed_lookup(table: torch.Tensor, ids: torch.Tensor,
                 cfg: ModelConfig, *, tp=None) -> torch.Tensor:
    """Rows ``ids`` of ``table`` in the compute dtype (scaled for gemma).
    With ``tp``, ``table`` is this rank's rows of the vocabulary: ids
    outside them read zeros and the ranks' rows are summed."""
    if tp is None:
        x = table[ids]
    else:
        n = table.shape[0]
        local = ids - tp.start(n)
        mine = (local >= 0) & (local < n)
        x = table[local.clamp(0, n - 1)]
        x = reduce_from(torch.where(mine[..., None], x, torch.zeros_like(x)),
                        tp)
    x = x.to(DTYPES[cfg.dtype])
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return x


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return torch.tanh(x / cap) * cap


def unembed_logits(x: torch.Tensor, table: torch.Tensor,
                   cfg: ModelConfig, *, tp=None) -> torch.Tensor:
    """(B, S, d) @ (V, d)^T -> (B, S, V) logits, with the optional final
    softcap (applied in float32).  With ``tp``, ``table`` is this rank's
    rows of the vocabulary and so are the logits' columns."""
    if tp is not None:
        x = copy_to(x, tp)
    logits = constrain(x @ table.to(x.dtype).T, "dp", None, "vocab",
                       full=(None, None, cfg.vocab_size))
    if cfg.final_logit_softcap:
        logits = softcap(logits.float(), cfg.final_logit_softcap)
    return logits
