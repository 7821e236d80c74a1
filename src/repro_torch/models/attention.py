"""GQA attention for the LM families: grouped-query attention, sliding
window (local) layers, the attention-logit softcap, qk-norm, QKV bias, rope,
inert padded heads, cross-attention (whisper's decoder over its encoder),
and decode against a (B, S, Kh, Dh) KV cache.

Counterpart of ``repro.models.attention``.  The attention itself is the
hand-written kernels' work: full-sequence attention (self, the encoder's
bidirectional and the decoder's cross-attention, whose keys have their own
length) goes through :func:`repro_torch.kernels.flash_attention.ops.mha`
and one-token decode (over the self cache, or over every encoder row)
through :func:`repro_torch.kernels.flash_decode.ops.decode_attn`.  On CUDA
tensors those launch the kernels; on CPU tensors they run their plain
versions (which compute what the reference's ``_mask_bias`` + ``_sdpa``
compute, so neither is repeated here).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import mha
from repro_torch.kernels.flash_decode.ops import decode_attn
from repro_torch.models.layers import (DTYPES, apply_rope, dense_init,
                                       head_rms_norm)


def padded_heads(cfg: ModelConfig) -> int:
    return max(cfg.head_pad_to, cfg.n_heads)


def init_attention(gen, cfg: ModelConfig, device: torch.device) -> Dict:
    dt = DTYPES[cfg.param_dtype]
    hp = padded_heads(cfg)
    p = {
        "wq": dense_init(gen, cfg.d_model, hp * cfg.d_head, dt, device),
        "wk": dense_init(gen, cfg.d_model, cfg.kv_hidden, dt, device),
        "wv": dense_init(gen, cfg.d_model, cfg.kv_hidden, dt, device),
        "wo": dense_init(gen, hp * cfg.d_head, cfg.d_model, dt, device,
                         scale=1.0 / math.sqrt(cfg.q_hidden)),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(hp * cfg.d_head, dtype=dt, device=device)
        p["bk"] = torch.zeros(cfg.kv_hidden, dtype=dt, device=device)
        p["bv"] = torch.zeros(cfg.kv_hidden, dtype=dt, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros(cfg.d_head, dtype=torch.float32,
                                  device=device)
        p["k_norm"] = torch.zeros(cfg.d_head, dtype=torch.float32,
                                  device=device)
    return p


def _layer_theta(cfg: ModelConfig, kind: str) -> float:
    """gemma3 local layers keep the short-context 10k base frequency."""
    if kind == "attn_local" and cfg.rope_theta > 10_000.0:
        return 10_000.0
    return cfg.rope_theta


def _window(cfg: ModelConfig, kind: str) -> int:
    return cfg.sliding_window if kind == "attn_local" else 0


def _project_q(p: Dict, cfg: ModelConfig, x: torch.Tensor,
               positions: torch.Tensor, kind: str) -> torch.Tensor:
    q = x @ p["wq"]
    if cfg.qkv_bias:
        q = q + p["bq"].to(q.dtype)
    q = q.reshape(*x.shape[:-1], padded_heads(cfg), cfg.d_head)
    if cfg.qk_norm:
        q = head_rms_norm(q, p["q_norm"], cfg.norm_eps)
    if cfg.rope_theta:
        q = apply_rope(q, positions, _layer_theta(cfg, kind))
    return q


def _project_kv(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, kind: str
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    k = k.reshape(*x.shape[:-1], cfg.n_kv_heads, cfg.d_head)
    v = v.reshape(*x.shape[:-1], cfg.n_kv_heads, cfg.d_head)
    if cfg.qk_norm:
        k = head_rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.rope_theta:
        k = apply_rope(k, positions, _layer_theta(cfg, kind))
    return k, v


def _finish(p: Dict, cfg: ModelConfig, out: torch.Tensor) -> torch.Tensor:
    hp = padded_heads(cfg)
    if hp > cfg.n_heads:                     # inert padded heads
        out = out * (torch.arange(hp, device=out.device) <
                     cfg.n_heads).to(out.dtype)[None, None, :, None]
    return out.reshape(*out.shape[:-2], hp * cfg.d_head) @ p["wo"]


def multi_head_attention(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                         positions: torch.Tensor, kind: str, *,
                         causal: bool = True,
                         kv_x: Optional[torch.Tensor] = None,
                         kv_positions: Optional[torch.Tensor] = None,
                         return_kv: bool = False):
    """Full-sequence attention (train / prefill / encoder / cross).

    q comes from ``x`` at ``positions``; k and v from ``kv_x`` at
    ``kv_positions`` (default: ``x`` and ``positions``; for ``kv_x`` alone,
    0..Sk-1), so cross-attention has Sq != Sk.  With ``return_kv`` also
    returns the roped (k, v), (B, Sk, Kh, Dh), that the prefill cache is
    built from.
    """
    q = _project_q(p, cfg, x, positions, kind)
    if kv_x is None:
        kv_x, kv_positions = x, positions
    elif kv_positions is None:
        kv_positions = torch.arange(kv_x.shape[1], device=kv_x.device
                                    ).expand(kv_x.shape[:2])
    k, v = _project_kv(p, cfg, kv_x, kv_positions, kind)
    out = mha(q, k, v, causal=causal, window=_window(cfg, kind),
              softcap=cfg.attn_logit_softcap)
    out = _finish(p, cfg, out)
    return (out, (k, v)) if return_kv else out


# ---------------------------------------------------------------- decode path
def init_kv_cache(cfg: ModelConfig, batch: int, seq: int,
                  dtype: torch.dtype, device: torch.device) -> Dict:
    shape = (batch, seq, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_attention(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                     cache: Dict, pos: int, kind: str, *,
                     cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]]
                     = None) -> Tuple[torch.Tensor, Dict]:
    """One-token attention.  x: (B, 1, d); pos: host int shared by the
    batch.

    Self-attention writes (k, v) of the new token into ``cache`` at ``pos``
    IN PLACE (the reference returns a new cache from
    ``dynamic_update_slice``), then attends over positions <= pos,
    window-clipped on local layers.  With ``cross_kv`` = (ck, cv), the
    encoder's (B, T, Kh, Dh) keys and values, the cache is left alone and
    every one of the T rows is attended (the kernel at pos = T - 1).
    Returns (out, cache), the cache being the same dict.
    """
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.long,
                           device=x.device)
    q = _project_q(p, cfg, x, positions, kind)
    if cross_kv is not None:
        ck, cv = cross_kv
        out = decode_attn(q, ck, cv, ck.shape[1] - 1,
                          softcap=cfg.attn_logit_softcap)
        return _finish(p, cfg, out), cache
    k_new, v_new = _project_kv(p, cfg, x, positions, kind)
    cache["k"][:, pos] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][:, pos] = v_new[:, 0].to(cache["v"].dtype)
    out = decode_attn(q, cache["k"], cache["v"], pos,
                      window=_window(cfg, kind),
                      softcap=cfg.attn_logit_softcap)
    return _finish(p, cfg, out), cache
