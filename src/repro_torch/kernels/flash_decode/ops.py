"""Flash decode: one-token attention against a (B, S, Kh, D) KV cache.

``decode_attn`` is the entry the model calls.  On CUDA tensors it launches
the hand-written kernel ``csrc/flash_decode.cu`` (built with ``nvcc`` at
first use) or raises; it never falls back.  On CPU tensors it runs
:func:`decode_attn_plain`, the same function in plain PyTorch ops, which is
also what the kernel is held against on the card.

The kernel splits the visible keys into chunks (:func:`split_plan`), one
block per (chunk, kv head, batch), and merges the chunks in the same launch:
the block that finishes last for its (batch, kv head) merges them in chunk
order, so results repeat bit for bit.  It reads the cache with 16-byte
loads, which need D a multiple of 8, a unit innermost stride, the other
strides multiples of 16 bytes and 16-byte aligned data; a cache that breaks
this is copied first (contiguous, D zero-padded to a multiple of 8).  The
models' caches (D 64, 128, 256, allocated contiguous) never are.

Partial decode, for a cache split along its sequence over ranks: with
``rows`` = (r0, r1) the token sees rows [r0, r1) of the cache given (a
rank's slice, local to it; :func:`visible_rows` derives them from the
global ``pos`` and window), in place of the rows ``pos`` and the window
give; with ``return_lse`` the call also returns each query head's float32
log-sum-exp over those rows, (B, H).  An empty range launches nothing and
comes out as 0 with log-sum-exp -inf (the plain version alike), so that
``launch.collectives.merge_partials`` of the ranks' partials is the
attention over the whole cache.  A call without ``rows`` and
``return_lse`` computes what it did before, bit for bit.

On ``meta`` tensors (the dry run, ``launch.dryrun``) :func:`decode_attn`
takes the CUDA route up to the launch and stops there: the outputs' shapes
and dtypes, nothing launched.  Every call on CUDA or meta tensors is
reported at the launch as one op (``kernels/observe.py``); :func:`cost`
gives its FLOPs and bytes.

Counterpart of ``repro.kernels.flash_decode.ops.decode_attn`` (whose kernel
is ``flash_decode``); unlike it, the cache is read in place in its own
layout, never transposed, and ``pos`` is a host int.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build, observe

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_decode.cu"
NEG_INF = -1e30         # the mask value of the reference kernel
MAX_HEAD_DIM = 256
MAX_GROUP = 8           # query heads per kv head one block serves
DTYPES = (torch.float32, torch.bfloat16)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# split_plan: about SPLIT_BLOCKS_PER_SM blocks on each of the H100's SMS
SMS = 132
SPLIT_BLOCKS_PER_SM = 4
CHUNK_ALIGN = 64        # keys; a chunk's length is a multiple of this
MAX_CHUNKS = 64         # per (batch, kv head); the kernel's kMaxChunks

# kernel launches since import (or since the caller last reset them)
LAUNCHES = 0

_FN = None
_TICKETS: Dict[int, torch.Tensor] = {}   # per device: B * Kh zeroed ints


def split_plan(b: int, n_kv: int, kbeg: int, pos: int) -> Tuple[int, int]:
    """(chunk, n_chunks): the kernel's cut of the visible keys [kbeg, pos]
    into ``n_chunks`` chunks of ``chunk`` keys (the last one shorter), one
    block each per (batch, kv head).

    Enough chunks for about ``SPLIT_BLOCKS_PER_SM`` blocks on every SM, each
    a multiple of ``CHUNK_ALIGN`` keys long, at most ``MAX_CHUNKS``.  Chunk
    i covers [kbeg + i * chunk, min(kbeg + (i + 1) * chunk, pos + 1)); none
    is empty.  Deterministic in its arguments, so a call repeats bit for bit.
    """
    n_keys = pos - kbeg + 1
    if n_keys < 1:
        raise ValueError(f"no visible key: kbeg={kbeg}, pos={pos}")
    want = min(MAX_CHUNKS, -(-SPLIT_BLOCKS_PER_SM * SMS // (b * n_kv)))
    chunk = -(-n_keys // want)
    chunk = -(-chunk // CHUNK_ALIGN) * CHUNK_ALIGN
    return chunk, -(-n_keys // chunk)


def visible_rows(pos: int, window: int, start: int,
                 length: int) -> Tuple[int, int]:
    """The rows (r0, r1), local to a slice of ``length`` cache rows that
    starts at global row ``start``, that a token at ``pos`` sees: global
    rows <= ``pos`` and, with ``window`` > 0, > ``pos - window``; r0 ==
    r1 when it sees none of them."""
    lo = max(0, pos - window + 1) if window else 0
    r0 = min(max(lo, start), start + length) - start
    return r0, max(r0, min(pos + 1, start + length) - start)


def _tickets(device: torch.device, n: int) -> torch.Tensor:
    """The kernel's per-(batch, kv head) tickets on ``device``: zeroed once,
    and left zeroed by every launch.  Launches on one device must not run
    concurrently on two streams, since they share these."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    buf = _TICKETS.get(idx)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(n, dtype=torch.int32, device=device)
        _TICKETS[idx] = buf
    return buf


def _rows_16b(x: torch.Tensor) -> bool:
    """Whether the kernel can read cache ``x`` with 16-byte loads."""
    vec = 16 // x.element_size()
    return (x.shape[-1] % 8 == 0 and x.stride(-1) == 1
            and all(st % vec == 0 for st in x.stride()[:-1])
            and x.data_ptr() % 16 == 0)


def decode_attn_plain(q: torch.Tensor, cache_k: torch.Tensor,
                      cache_v: torch.Tensor, pos: int, *,
                      window: int = 0, softcap: float = 0.0,
                      rows: Optional[Tuple[int, int]] = None,
                      return_lse: bool = False):
    """Softmax attention of q over cache positions <= ``pos`` (and > ``pos -
    window`` when ``window`` > 0), or over ``rows``, in float32, over the
    whole cache with the rest masked to -1e30.  Same arguments and results
    as :func:`decode_attn`."""
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
    if rows is not None:
        mask = (k_pos >= rows[0]) & (k_pos < rows[1])
    else:
        mask = k_pos <= pos
        if window:
            mask = mask & (k_pos > pos - window)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    out = torch.einsum("bhk,bhkd->bhd", p, vf) / l
    if not return_lse:
        return out[:, None].to(q.dtype)
    if not bool(mask.any()):
        return (torch.zeros_like(q),
                torch.full(m.shape[:-1], -math.inf, device=q.device))
    return out[:, None].to(q.dtype), (m + l.log())[..., 0]


def cost(reads, writes, opts) -> tuple:
    """(FLOPs, bytes) of one call (``kernels/observe.py``): the products of
    :func:`decode_attn_plain`, q K^T and p V over every row of the cache,
    2 B H S D each; bytes: q, the rows [r0, r1) of both caches that the
    kernel reads (``opts["rows"]``), and the outputs."""
    (b, _, h, d), _ = reads[0]
    (_, s_len, kh, _), size = reads[1]
    r0, r1 = opts["rows"]
    read = observe.nbytes(reads[0]) + 2 * b * (r1 - r0) * kh * d * size
    return 4 * b * h * s_len * d, read + observe.moved((), writes)


def _check(q, cache_k, cache_v, pos: int, window: int, softcap: float,
           rows: Optional[Tuple[int, int]] = None) -> None:
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
    if window < 0 or softcap < 0 or (
            rows is None and not 0 <= pos < cache_k.shape[1]) or (
            rows is not None and not 0 <= rows[0] <= rows[1]
            <= cache_k.shape[1]):
        raise ValueError(f"need 0 <= pos < {cache_k.shape[1]} (or 0 <= r0 "
                         f"<= r1 <= {cache_k.shape[1]}), window >= 0 and "
                         f"softcap >= 0, got pos={pos}, rows={rows}, "
                         f"window={window}, softcap={softcap}")
    devices = {t.device for t in (q, cache_k, cache_v)}
    if len(devices) != 1:
        raise ValueError(f"q and the cache lie on several devices: "
                         f"{sorted(str(d) for d in devices)}")


def _kernel_fn():
    global _FN
    if _FN is None:
        fn = build.load(SOURCE).flash_decode
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 14
                       + [ctypes.c_int] * 9 + [ctypes.c_float] * 2
                       + [ctypes.c_void_p] * 4)
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _launch(q, cache_k, cache_v, out, kbeg: int, kend: int,
            softcap: float, scale: float = 0.0,
            lse: Optional[torch.Tensor] = None) -> None:
    """One launch of ``flash_decode`` over the rows [kbeg, kend) (not
    empty) on checked CUDA tensors (the cache laid out for 16-byte loads);
    ``scale`` defaults to 1/sqrt(D); ``lse``, a contiguous (B, H) float32
    tensor, receives the heads' log-sum-exps.  Reported first; on meta
    tensors nothing more."""
    global LAUNCHES
    observe.report("flash_decode", (q, cache_k, cache_v),
                   (out,) if lse is None else (out, lse), rows=(kbeg, kend),
                   softcap=softcap)
    if q.device.type == "meta":
        return
    b, _, h, d = q.shape
    kh = cache_k.shape[2]
    qs, ks, vs, os_ = (q.stride(), cache_k.stride(), cache_v.stride(),
                       out.stride())
    chunk, n_chunks = split_plan(b, kh, kbeg, kend - 1)
    part = tickets = None
    if n_chunks > 1:
        part = torch.empty(b * kh * n_chunks * (h // kh) * (d + 2),
                           dtype=torch.float32, device=q.device)
        tickets = _tickets(q.device, b * kh)
    fn = _kernel_fn()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
            out.data_ptr(), qs[0], qs[2], qs[3], *ks, *vs,
            os_[0], os_[2], os_[3], b, h, kh, d, kbeg, kend, chunk,
            n_chunks, _DTYPE_CODE[q.dtype],
            float(scale or 1.0 / math.sqrt(d)), float(softcap),
            None if part is None else part.data_ptr(),
            None if tickets is None else tickets.data_ptr(),
            None if lse is None else lse.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"flash_decode launch failed: cudaError {rc}")
    LAUNCHES += 1


def decode_attn(q: torch.Tensor, cache_k: torch.Tensor,
                cache_v: torch.Tensor, pos: int, *,
                window: int = 0, softcap: float = 0.0,
                rows: Optional[Tuple[int, int]] = None,
                return_lse: bool = False):
    """q: (B, 1, H, D); cache_k, cache_v: (B, S, Kh, D); pos: host int, the
    position of the token being decoded, shared by the batch -> (B, 1, H, D)
    in q's dtype (float32 or bfloat16; float32 softmax state), and with
    ``return_lse`` also the heads' log-sum-exps, (B, H) float32.  With
    ``softcap`` > 0 the logits are capped as in :func:`repro_torch.kernels.
    flash_attention.ops.mha` (the models' decode needs it; the reference
    kernel has no cap).  ``rows``: the module docstring.

    CPU tensors run :func:`decode_attn_plain`; CUDA tensors launch the
    kernel, which reads only the cache rows the token sees; meta tensors
    take the CUDA route without the launch.  A cache whose
    layout rules out 16-byte loads (see the module docstring) is copied
    first; the kernel still runs.
    """
    pos, window = int(pos), int(window)
    if rows is not None:
        rows = (int(rows[0]), int(rows[1]))
    _check(q, cache_k, cache_v, pos, window, softcap, rows)
    if rows is not None and rows[0] == rows[1]:    # nothing seen, no launch
        b, _, h, _ = q.shape
        out = torch.zeros_like(q)
        return (out, q.new_full((b, h), -math.inf, dtype=torch.float32)) \
            if return_lse else out
    if q.device.type == "cpu":
        return decode_attn_plain(q, cache_k, cache_v, pos, window=window,
                                 softcap=softcap, rows=rows,
                                 return_lse=return_lse)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"decode_attn runs on cpu or cuda (or meta, "
                         f"launching nothing), not {q.device}")
    kbeg, kend = rows if rows is not None else (
        max(0, pos - window + 1) if window else 0, pos + 1)
    d = q.shape[-1]
    d_pad = -(-d // 8) * 8
    if d_pad != d:
        q, cache_k, cache_v = (F.pad(x, (0, d_pad - d))
                               for x in (q, cache_k, cache_v))
    cache_k, cache_v = (x if _rows_16b(x) else x.contiguous()
                        for x in (cache_k, cache_v))
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    b, _, h, _ = q.shape
    lse = torch.empty((b, h), dtype=torch.float32, device=q.device) \
        if return_lse else None
    if out.numel():
        _launch(q, cache_k, cache_v, out, kbeg, kend, softcap,
                scale=1.0 / math.sqrt(d), lse=lse)
    out = out if d_pad == d else out[..., :d].contiguous()
    return (out, lse) if return_lse else out
