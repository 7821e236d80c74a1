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

Where the heads do not split (``kv_seq`` over ``"model"``: ``wq`` ..
``wo`` whole on every rank), the keys do: each rank projects k and v for
its ``torch.chunk`` slice of the key rows only, runs every query against
them (``mha`` with the slice's offset, so the masks compare global
positions, and its log-sum-exp) and the ranks' partials are merged by
log-sum-exp (``launch.collectives.merge_partials``).  Where the cache
splits along its sequence (``cache_seq`` over ``"model"``, the batch's
``"data"`` or both), only the rank that holds row ``pos`` writes the new
token's k and v, each rank runs every query head over the rows of its
slice the token sees (``decode_attn`` with ``rows``; the one-token q
gathered over ``"model"`` where the heads split) and the partials are
merged over the split's mesh dims; a rank then keeps its own heads for
``wo``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import mha
from repro_torch.kernels.flash_decode.ops import decode_attn, visible_rows
from repro_torch.launch.collectives import (copy_to, gather_dim,
                                            merge_partials, reduce_out,
                                            same_out)
from repro_torch.models.layers import (DTYPES, apply_rope, dense_init,
                                       head_rms_norm)
from repro_torch.models.sharding import constrain, seq_split


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
    """Padded heads masked, then ``wo``: with ``tp``, this rank's heads
    against its rows of ``wo``, summed over the ranks (``reduce_out``), or,
    where ``wo`` is whole (``kv_seq``), every head on every rank alike
    (``same_out``)."""
    hp = padded_heads(cfg)
    hl = out.shape[-2]
    local = tp is not None and hl != hp
    if hp > cfg.n_heads:                     # inert padded heads
        h0 = tp.start(hl) if local else 0
        out = out * (torch.arange(h0, h0 + hl, device=out.device) <
                     cfg.n_heads).to(out.dtype)[None, None, :, None]
    out = constrain(out, "dp", None, "tp_heads", None,
                    full=(None, None, hp, None))
    y = out.reshape(*out.shape[:-2], hl * cfg.d_head) @ p["wo"]
    if tp is None:
        return y
    return reduce_out(y, tp) if local else same_out(y, tp)


def kv_local(p: Dict, cfg: ModelConfig) -> bool:
    """Whether ``p``'s ``wk`` / ``wv`` are a rank's kv-head shards."""
    return p["wk"].shape[-1] != cfg.kv_hidden


def heads_local(p: Dict, cfg: ModelConfig) -> bool:
    """Whether ``p``'s ``wq`` holds a rank's q-head shards."""
    return p["wq"].shape[-1] != padded_heads(cfg) * cfg.d_head


def _gather_rows(t: torch.Tensor, size: int, split, tp) -> torch.Tensor:
    """The whole (B, ``size``, ...) tensor from every rank's chunk of its
    rows (``split``'s cut over ``tp``; no gradient): the chunks padded to
    one length, gathered, the padding cut."""
    lo, hi = split.bounds(size)
    step = -(-size // split.n)
    if hi - lo < step:
        t = torch.cat([t, t.new_zeros((t.shape[0], step - (hi - lo))
                                      + tuple(t.shape[2:]))], dim=1)
    return gather_dim(t, 1, tp)[:, :size]


def _seq_attention(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                   positions: torch.Tensor, kind: str, causal: bool,
                   kv_x: torch.Tensor, kv_positions: torch.Tensor,
                   return_kv: bool, tp):
    """:func:`multi_head_attention` under ``kv_seq``: every head on every
    rank, the keys split over ``"model"`` (module docstring).  The
    projections' parameters and ``x`` enter through ``copy_to`` (each rank
    computes a part of their gradients: its keys' and its partial's);
    ``wo`` does not, since every rank then holds the merged output."""
    split = seq_split("kv_seq")
    assert split is not None and split.n == tp.size, (split, tp)
    pp = {k: t if k == "wo" else copy_to(t, tp) for k, t in p.items()}
    xq = copy_to(x, tp)
    src = xq if kv_x is x else copy_to(kv_x, tp)
    sk = kv_x.shape[1]
    r0, r1 = split.bounds(sk)
    q = _project_q(pp, cfg, xq, positions, kind)
    k, v = _project_kv(pp, cfg, src[:, r0:r1], kv_positions[:, r0:r1], kind)
    full = (None, sk, cfg.n_kv_heads, None)
    k = constrain(k, "dp", "kv_seq", "tp_kv", None, full=full)
    v = constrain(v, "dp", "kv_seq", "tp_kv", None, full=full)
    out, lse = mha(q, k, v, causal=causal, window=_window(cfg, kind),
                   softcap=cfg.attn_logit_softcap, k_offset=r0,
                   return_lse=True)
    out = merge_partials(out, lse.transpose(1, 2), split.groups)
    out = _finish(pp, cfg, out, tp)
    if not return_kv:
        return out
    return out, tuple(_gather_rows(t, sk, split, tp) for t in (k, v))


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
    Under ``kv_seq`` (``wq`` whole with ``tp``) the keys split instead,
    and the returned (k, v) are gathered whole (no gradient: the prefill's
    cache).
    """
    if kv_x is None:
        kv_x, kv_positions = x, positions
    elif kv_positions is None:
        kv_positions = torch.arange(kv_x.shape[1], device=kv_x.device
                                    ).expand(kv_x.shape[:2])
    if tp is not None and not heads_local(p, cfg):
        return _seq_attention(p, cfg, x, positions, kind, causal, kv_x,
                              kv_positions, return_kv, tp)
    xq = x if tp is None else copy_to(x, tp)
    q = _project_q(p, cfg, xq, positions, kind, tp)
    split = tp is not None and kv_local(p, cfg)
    if split:
        kv_x = copy_to(kv_x, tp)
    k, v = _project_kv(p, cfg, kv_x, kv_positions, kind,
                       tp if split else None)
    full = (None, kv_x.shape[1], cfg.n_kv_heads, None)
    k = constrain(k, "dp", "kv_seq", "tp_kv", None, full=full)
    v = constrain(v, "dp", "kv_seq", "tp_kv", None, full=full)
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
    this rank's heads, or every head where ``wq`` is whole (``kv_seq``);
    the cache (and ``cross_kv``) hold its kv heads.  Under ``cache_seq``
    the cache is this rank's slice of the rows (module docstring).
    """
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.long,
                           device=x.device)
    if tp is not None:
        x = copy_to(x, tp)
    q = _project_q(p, cfg, x, positions, kind, tp)
    if cross_kv is not None:
        ck, cv = cross_kv
        out = decode_attn(q, ck, cv, ck.shape[1] - 1,
                          softcap=cfg.attn_logit_softcap)
        return _finish(p, cfg, out, tp), cache
    k_new, v_new = _project_kv(p, cfg, x, positions, kind,
                               tp if kv_local(p, cfg) else None)
    split = seq_split("cache_seq")
    rows, r0 = cache["k"].shape[1], 0
    if split is not None:
        r0 = split.index * rows
    if r0 <= pos < r0 + rows:                # the rank that holds row pos
        cache["k"][:, pos - r0] = k_new[:, 0].to(cache["k"].dtype)
        cache["v"][:, pos - r0] = v_new[:, 0].to(cache["v"].dtype)
    full = (None, rows * (split.n if split else 1), cfg.n_kv_heads, None)
    ck = constrain(cache["k"], "dp", "cache_seq", "tp_kv", None, full=full)
    cv = constrain(cache["v"], "dp", "cache_seq", "tp_kv", None, full=full)
    window = _window(cfg, kind)
    if split is None:
        assert tp is None or kv_local(p, cfg), \
            "a sharded decode over whole kv heads needs its cache split"
        out = decode_attn(q, ck, cv, pos, window=window,
                          softcap=cfg.attn_logit_softcap)
        return _finish(p, cfg, out, tp), cache
    # every q head over this rank's rows, merged over the split
    hl = q.shape[2]
    gather = tp is not None and heads_local(p, cfg) and not kv_local(p, cfg)
    if gather:
        q = gather_dim(q, 2, tp)
    out, lse = decode_attn(q, ck, cv, pos, window=window,
                           softcap=cfg.attn_logit_softcap,
                           rows=visible_rows(pos, window, r0, rows),
                           return_lse=True)
    out = merge_partials(out, lse[:, None], split.groups)
    if gather:
        out = out.narrow(2, tp.start(hl), hl)
    return _finish(p, cfg, out, tp), cache
