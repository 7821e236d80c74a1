"""Flash decode: one-token attention against a (B, S, Kh, D) KV cache.

``decode_attn`` is the entry the model calls.  On CUDA tensors it launches
the hand-written kernel ``csrc/flash_decode.cu`` (built with ``nvcc`` at
first use) or raises; it never falls back.  On CPU tensors it runs
:func:`decode_attn_plain`, the same function in plain PyTorch ops, which is
also what the kernel is held against on the card.

Counterpart of ``repro.kernels.flash_decode.ops.decode_attn`` (whose kernel
is ``flash_decode``); unlike it, the cache is read in place in its own
layout, never transposed, and ``pos`` is a host int.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.kernels import build

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_decode.cu"
NEG_INF = -1e30         # the mask value of the reference kernel
MAX_HEAD_DIM = 256
MAX_GROUP = 8           # query heads per kv head one block serves
DTYPES = (torch.float32, torch.bfloat16)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since import (or since the caller last reset them)
LAUNCHES = 0

_FN = None


def decode_attn_plain(q: torch.Tensor, cache_k: torch.Tensor,
                      cache_v: torch.Tensor, pos: int, *,
                      window: int = 0, softcap: float = 0.0) -> torch.Tensor:
    """Softmax attention of q over cache positions <= ``pos`` (and > ``pos -
    window`` when ``window`` > 0), in float32, over the whole cache with the
    rest masked to -1e30.  Same arguments as :func:`decode_attn`."""
    b, _, h, d = q.shape
    s_len, kh = cache_k.shape[1], cache_k.shape[2]
    group = h // kh
    qf = q[:, 0].float()                                      # (B, H, D)
    kf = cache_k.float().permute(0, 2, 1, 3).repeat_interleave(group, dim=1)
    vf = cache_v.float().permute(0, 2, 1, 3).repeat_interleave(group, dim=1)
    s = torch.einsum("bhd,bhkd->bhk", qf, kf) * (1.0 / math.sqrt(d))
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    k_pos = torch.arange(s_len, device=q.device)
    mask = k_pos <= pos
    if window:
        mask = mask & (k_pos > pos - window)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    out = torch.einsum("bhk,bhkd->bhd", p, vf) / l
    return out[:, None].to(q.dtype)


def _check(q, cache_k, cache_v, pos: int, window: int,
           softcap: float) -> None:
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be (B, 1, H, D), got {tuple(q.shape)}")
    if cache_k.dim() != 4 or tuple(cache_k.shape) != tuple(cache_v.shape):
        raise ValueError(f"cache_k {tuple(cache_k.shape)} and cache_v "
                         f"{tuple(cache_v.shape)} must be one (B, S, Kh, D)")
    b, _, h, d = q.shape
    if cache_k.shape[0] != b or cache_k.shape[3] != d:
        raise ValueError(f"cache {tuple(cache_k.shape)} does not match q "
                         f"{tuple(q.shape)} in batch or head dim")
    kh = cache_k.shape[2]
    if kh == 0 or h % kh or h // kh > MAX_GROUP:
        raise ValueError(f"{h} query heads over {kh} kv heads: need a "
                         f"multiple of at most {MAX_GROUP}")
    if not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim must be in 1..{MAX_HEAD_DIM}, got {d}")
    if q.dtype not in DTYPES or cache_k.dtype != q.dtype or \
            cache_v.dtype != q.dtype:
        raise TypeError(f"q and the cache must share one dtype of {DTYPES}, "
                        f"got {q.dtype}, {cache_k.dtype}, {cache_v.dtype}")
    if not 0 <= pos < cache_k.shape[1] or window < 0 or softcap < 0:
        raise ValueError(f"need 0 <= pos < {cache_k.shape[1]}, window >= 0 "
                         f"and softcap >= 0, got pos={pos}, window={window}, "
                         f"softcap={softcap}")
    devices = {t.device for t in (q, cache_k, cache_v)}
    if len(devices) != 1:
        raise ValueError(f"q and the cache lie on several devices: "
                         f"{sorted(str(d) for d in devices)}")


def _kernel_fn():
    global _FN
    if _FN is None:
        fn = build.load(SOURCE).flash_decode
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 14
                       + [ctypes.c_int] * 7 + [ctypes.c_float] * 2
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _launch(q, cache_k, cache_v, out, pos: int, window: int,
            softcap: float) -> None:
    """One launch of ``flash_decode`` on checked CUDA tensors."""
    global LAUNCHES
    b, _, h, d = q.shape
    qs, ks, vs, os_ = (q.stride(), cache_k.stride(), cache_v.stride(),
                       out.stride())
    fn = _kernel_fn()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
            out.data_ptr(), qs[0], qs[2], qs[3], *ks, *vs,
            os_[0], os_[2], os_[3], b, h, cache_k.shape[2], d, pos, window,
            _DTYPE_CODE[q.dtype], float(1.0 / math.sqrt(d)), float(softcap),
            stream)
    if rc != 0:
        raise RuntimeError(f"flash_decode launch failed: cudaError {rc}")
    LAUNCHES += 1


def decode_attn(q: torch.Tensor, cache_k: torch.Tensor,
                cache_v: torch.Tensor, pos: int, *,
                window: int = 0, softcap: float = 0.0) -> torch.Tensor:
    """q: (B, 1, H, D); cache_k, cache_v: (B, S, Kh, D); pos: host int, the
    position of the token being decoded, shared by the batch -> (B, 1, H, D)
    in q's dtype (float32 or bfloat16; float32 softmax state).  With
    ``softcap`` > 0 the logits are capped as in :func:`repro_torch.kernels.
    flash_attention.ops.mha` (the models' decode needs it; the reference
    kernel has no cap).

    CPU tensors run :func:`decode_attn_plain`; CUDA tensors launch the
    kernel, which reads only the cache rows the token sees.
    """
    pos, window = int(pos), int(window)
    _check(q, cache_k, cache_v, pos, window, softcap)
    if q.device.type == "cpu":
        return decode_attn_plain(q, cache_k, cache_v, pos, window=window,
                                 softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attn runs on cpu or cuda, not {q.device}")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if out.numel():
        _launch(q, cache_k, cache_v, out, pos, window, softcap)
    return out
