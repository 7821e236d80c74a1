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

Given ``tp`` (a ``launch.collectives.TP`` over ``"model"``), attention runs
on this rank's heads: ``wq`` / ``wk`` / ``wv`` are its columns (its q and
kv heads) and ``wo`` its rows, so the kernels take the local head counts
and the output is summed over the ranks.  Where the kv heads do not split
(``wk`` / ``wv`` whole), every rank projects them all and keeps the ones
its q heads read.  A replicated ``bq`` / ``bk`` / ``bv`` is cut to the
local heads, and padded heads are masked by their global index.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import mha
from repro_torch.kernels.flash_decode.ops import decode_attn
from repro_torch.launch.collectives import copy_to, reduce_from
from repro_torch.models.layers import (DTYPES, apply_rope, dense_init,
                                       head_rms_norm)
from repro_torch.models.sharding import constrain


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


def _local_cols(b: torch.Tensor, n: int, tp) -> torch.Tensor:
    """A replicated bias cut to this rank's ``n`` columns."""
    if tp is None or n == b.shape[0]:
        return b
    return copy_to(b, tp).narrow(0, tp.start(n), n)


def _replicated(t: torch.Tensor, tp) -> torch.Tensor:
    """A replicated parameter used on this rank's heads."""
    return t if tp is None else copy_to(t, tp)


def _project_q(p: Dict, cfg: ModelConfig, x: torch.Tensor,
               positions: torch.Tensor, kind: str, tp=None) -> torch.Tensor:
    q = x @ p["wq"]
    if cfg.qkv_bias:
        q = q + _local_cols(p["bq"], q.shape[-1], tp).to(q.dtype)
    q = q.reshape(*x.shape[:-1], q.shape[-1] // cfg.d_head, cfg.d_head)
    if cfg.qk_norm:
        q = head_rms_norm(q, _replicated(p["q_norm"], tp), cfg.norm_eps)
    if cfg.rope_theta:
        q = apply_rope(q, positions, _layer_theta(cfg, kind))
    return constrain(q, "dp", None, "tp_heads", None,
                     full=(None, None, padded_heads(cfg), None))


def _project_kv(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, kind: str, tp=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k and v of this rank's kv heads (all of them when ``wk`` is whole;
    ``tp`` is then None: every rank computes the same)."""
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        k = k + _local_cols(p["bk"], k.shape[-1], tp).to(k.dtype)
        v = v + _local_cols(p["bv"], v.shape[-1], tp).to(v.dtype)
    kh = k.shape[-1] // cfg.d_head
    k = k.reshape(*x.shape[:-1], kh, cfg.d_head)
    v = v.reshape(*x.shape[:-1], kh, cfg.d_head)
    if cfg.qk_norm:
        k = head_rms_norm(k, _replicated(p["k_norm"], tp), cfg.norm_eps)
    if cfg.rope_theta:
        k = apply_rope(k, positions, _layer_theta(cfg, kind))
    return k, v


def kv_for_heads(k: torch.Tensor, v: torch.Tensor, cfg: ModelConfig,
                 heads: int, tp) -> Tuple[torch.Tensor, torch.Tensor]:
    """From every kv head (computed alike on every rank), the ones this
    rank's ``heads`` q heads read (q head i reads kv head i // group): a
    run of kv heads when the local q heads split evenly over it, else one
    kv head per q head."""
    group = padded_heads(cfg) // k.shape[2]
    first = tp.start(heads)
    want = [(first + i) // group for i in range(heads)]
    kv = sorted(set(want))
    per = heads // len(kv)
    if heads % len(kv) == 0 and want == [h for h in kv for _ in range(per)]:
        idx = kv
    else:
        idx = want
    sel = torch.tensor(idx, device=k.device)
    return (copy_to(k, tp).index_select(2, sel),
            copy_to(v, tp).index_select(2, sel))


def _finish(p: Dict, cfg: ModelConfig, out: torch.Tensor,
            tp=None) -> torch.Tensor:
    hp = padded_heads(cfg)
    hl = out.shape[-2]
    if hp > cfg.n_heads:                     # inert padded heads
        h0 = 0 if tp is None else tp.start(hl)
        out = out * (torch.arange(h0, h0 + hl, device=out.device) <
                     cfg.n_heads).to(out.dtype)[None, None, :, None]
    out = constrain(out, "dp", None, "tp_heads", None,
                    full=(None, None, hp, None))
    y = out.reshape(*out.shape[:-2], hl * cfg.d_head) @ p["wo"]
    return y if tp is None else reduce_from(y, tp)


def kv_local(p: Dict, cfg: ModelConfig) -> bool:
    """Whether ``p``'s ``wk`` / ``wv`` are a rank's kv-head shards."""
    return p["wk"].shape[-1] != cfg.kv_hidden


def multi_head_attention(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                         positions: torch.Tensor, kind: str, *,
                         causal: bool = True,
                         kv_x: Optional[torch.Tensor] = None,
                         kv_positions: Optional[torch.Tensor] = None,
                         return_kv: bool = False, tp=None):
    """Full-sequence attention (train / prefill / encoder / cross).

    q comes from ``x`` at ``positions``; k and v from ``kv_x`` at
    ``kv_positions`` (default: ``x`` and ``positions``; for ``kv_x`` alone,
    0..Sk-1), so cross-attention has Sq != Sk.  With ``return_kv`` also
    returns the roped (k, v), (B, Sk, Kh, Dh), that the prefill cache is
    built from.  With ``tp``, this rank's heads (module docstring); the
    returned (k, v) are its kv heads when they split, else all of them.
    """
    xq = x if tp is None else copy_to(x, tp)
    q = _project_q(p, cfg, xq, positions, kind, tp)
    if kv_x is None:
        kv_x, kv_positions = x, positions
    elif kv_positions is None:
        kv_positions = torch.arange(kv_x.shape[1], device=kv_x.device
                                    ).expand(kv_x.shape[:2])
    split = tp is not None and kv_local(p, cfg)
    if split:
        kv_x = copy_to(kv_x, tp)
    k, v = _project_kv(p, cfg, kv_x, kv_positions, kind,
                       tp if split else None)
    k = constrain(k, "dp", "kv_seq", "tp_kv", None,
                  full=(None, None, cfg.n_kv_heads, None))
    v = constrain(v, "dp", "kv_seq", "tp_kv", None,
                  full=(None, None, cfg.n_kv_heads, None))
    kq, vq = (k, v) if tp is None or split else \
        kv_for_heads(k, v, cfg, q.shape[2], tp)
    out = mha(q, kq, vq, causal=causal, window=_window(cfg, kind),
              softcap=cfg.attn_logit_softcap)
    out = _finish(p, cfg, out, tp)
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
                     = None, tp=None) -> Tuple[torch.Tensor, Dict]:
    """One-token attention.  x: (B, 1, d); pos: host int shared by the
    batch.

    Self-attention writes (k, v) of the new token into ``cache`` at ``pos``
    IN PLACE (the reference returns a new cache from
    ``dynamic_update_slice``), then attends over positions <= pos,
    window-clipped on local layers.  With ``cross_kv`` = (ck, cv), the
    encoder's (B, T, Kh, Dh) keys and values, the cache is left alone and
    every one of the T rows is attended (the kernel at pos = T - 1).
    Returns (out, cache), the cache being the same dict.  With ``tp``,
    this rank's heads: the cache (and ``cross_kv``) hold its kv heads.
    """
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.long,
                           device=x.device)
    if tp is not None:
        assert kv_local(p, cfg), "sharded decode needs kv-head shards"
        x = copy_to(x, tp)
    q = _project_q(p, cfg, x, positions, kind, tp)
    if cross_kv is not None:
        ck, cv = cross_kv
        out = decode_attn(q, ck, cv, ck.shape[1] - 1,
                          softcap=cfg.attn_logit_softcap)
        return _finish(p, cfg, out, tp), cache
    k_new, v_new = _project_kv(p, cfg, x, positions, kind, tp)
    cache["k"][:, pos] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][:, pos] = v_new[:, 0].to(cache["v"].dtype)
    ck = constrain(cache["k"], "dp", "cache_seq", "tp_kv", None,
                   full=(None, None, cfg.n_kv_heads, None))
    cv = constrain(cache["v"], "dp", "cache_seq", "tp_kv", None,
                   full=(None, None, cfg.n_kv_heads, None))
    out = decode_attn(q, ck, cv, pos, window=_window(cfg, kind),
                      softcap=cfg.attn_logit_softcap)
    return _finish(p, cfg, out, tp), cache
