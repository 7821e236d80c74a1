"""Flash attention (training / prefill) in the model's (B, S, H, D) layout.

``mha`` is the entry the model calls.  On CUDA tensors it launches the
hand-written kernel ``csrc/flash_attention_fwd.cu`` (built with ``nvcc`` at
first use) or raises; it never falls back.  On CPU tensors it runs
:func:`mha_plain`, the same function in plain PyTorch ops, which is also
what the kernel is held against on the card.

When grad is enabled and an input requires it, the launch goes through
:class:`Mha`, whose backward recomputes :func:`mha_plain` on the saved
inputs and differentiates it: the VJP of the op's own math, as the
reference trains (its models differentiate plain ops; the Pallas kernel
has no VJP).

The kernel has two routes: bfloat16 runs on the tensor cores (``wgmma``, fed
by 16-byte ``cp.async``), float32 on the CUDA cores.  Both read the model's
layout through strides and mask the ragged tail of S themselves.  The
bfloat16 route needs 16-byte rows: unit innermost stride, the other strides
multiples of 8 elements, 16-byte aligned data, D a multiple of 8.  An input
that breaks this is copied first (contiguous, and D zero-padded to a
multiple of 8); no configuration under ``configs/`` (D 64, 128, 256) needs
a copy.

Partial attention, for keys split along the sequence over ranks: with
``k_offset`` the keys given are the slice that starts at that global
position (the causal and window masks compare global positions); with
``return_lse`` the call also returns each row's float32 log-sum-exp of its
visible logits, (B, H, Sq), and a row that sees no key of the slice comes
out as 0 with log-sum-exp -inf (kernel and plain version alike), so that
``launch.collectives.merge_partials`` of the ranks' partials is the
attention over every key.  Without ``return_lse`` a row with no visible
key keeps the reference's convention (the mean of V), and a call with
``k_offset=0`` computes what it did before, bit for bit.

On ``meta`` tensors (the dry run, ``launch.dryrun``) :func:`mha` takes
the CUDA route up to the launch and stops there: the outputs' shapes and
dtypes, nothing launched.  Every call on CUDA or meta tensors is reported
at the launch as one op (``kernels/observe.py``); :func:`cost` gives its
FLOPs and bytes.  A meta tensor has no address, so the meta route takes
its data as 16-byte aligned.

Counterpart of ``repro.kernels.flash_attention.ops.mha`` (whose kernel is
``flash_attention``), which transposes and pads every call.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch
import torch.nn.functional as F

from repro_torch.kernels import build, observe
from repro_torch.kernels.vjp import plain_vjp

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention_fwd.cu"
NEG_INF = -1e30         # the mask value of the reference kernel
MAX_HEAD_DIM = 256
DTYPES = (torch.float32, torch.bfloat16)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since import (or since the caller last reset them)
LAUNCHES = 0

_FN = None


def mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0, softcap: float = 0.0,
              kv_len: int = 0, k_offset: int = 0, return_lse: bool = False):
    """Exact softmax attention with the kernel's masks, in float32.

    Same arguments and results as :func:`mha`.  Masked logits are set to
    -1e30 (not -inf) and the normaliser is floored at 1e-20, as in the
    reference kernel, so without ``return_lse`` a query row whose keys are
    all masked comes out as the mean of V over every key; with it, as 0
    and log-sum-exp -inf.
    """
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    group = h // kh
    qf = q.float().permute(0, 2, 1, 3)                       # (B, H, Sq, D)
    kf = k.float().permute(0, 2, 1, 3).repeat_interleave(group, dim=1)
    vf = v.float().permute(0, 2, 1, 3).repeat_interleave(group, dim=1)
    s = (qf @ kf.transpose(-1, -2)) * (1.0 / math.sqrt(d))
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_idx = torch.arange(sk, device=q.device)[None, :]
    k_pos = k_idx + k_offset
    mask = k_idx < (kv_len or sk)
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window:
        mask = mask & ((q_pos - k_pos) < window)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    out = (p @ vf) / l
    if not return_lse:
        return out.permute(0, 2, 1, 3).to(q.dtype)
    seen = mask.any(dim=-1)[:, None]                          # (Sq, 1)
    out = torch.where(seen, out, torch.zeros_like(out))
    lse = torch.where(seen[:, 0], (m + l.log())[..., 0],
                      torch.full_like(m[..., 0], -math.inf))
    return out.permute(0, 2, 1, 3).to(q.dtype), lse


def cost(reads, writes, opts) -> tuple:
    """(FLOPs, bytes) of one call (``kernels/observe.py``): the products of
    :func:`mha_plain`, Q K^T and P V over every key, 2 B H Sq Sk D each,
    whatever the masks; q, k, v read once, the outputs written once."""
    (b, sq, h, d), _ = reads[0]
    sk = reads[1][0][1]
    return 4 * b * h * sq * sk * d, observe.moved(reads, writes)


def _check(q, k, v, window: int, softcap: float, kv_len: int,
           k_offset: int = 0, return_lse: bool = False) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be (B, S, H, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, _, h, d = q.shape
    if tuple(k.shape) != tuple(v.shape):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)} in batch or head dim")
    if k.shape[1] == 0 and not return_lse:
        raise ValueError("k and v hold no keys")
    if k.shape[2] == 0 or h % k.shape[2]:
        raise ValueError(f"{h} query heads are not a multiple of "
                         f"{k.shape[2]} kv heads")
    if not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim must be in 1..{MAX_HEAD_DIM}, got {d}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype of {DTYPES}, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if window < 0 or softcap < 0 or not 0 <= kv_len <= k.shape[1] or \
            k_offset < 0:
        raise ValueError(f"bad window={window}, softcap={softcap}, "
                         f"kv_len={kv_len} (keys: {k.shape[1]}) or "
                         f"k_offset={k_offset}")
    devices = {t.device for t in (q, k, v)}
    if len(devices) != 1:
        raise ValueError(f"q, k, v lie on several devices: "
                         f"{sorted(str(d) for d in devices)}")


def _kernel_fn():
    global _FN
    if _FN is None:
        fn = build.load(SOURCE).flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 16
                       + [ctypes.c_int] * 11 + [ctypes.c_float] * 2
                       + [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _rows_16b(x: torch.Tensor) -> bool:
    """Whether the bfloat16 route can read ``x`` with 16-byte copies."""
    return (x.shape[-1] % 8 == 0 and x.stride(-1) == 1
            and all(st % 8 == 0 for st in x.stride()[:-1])
            and x.data_ptr() % 16 == 0)


def _for_tensor_cores(x: torch.Tensor, d_pad: int) -> torch.Tensor:
    """``x`` as the bfloat16 route reads it: itself where its layout allows,
    else a contiguous copy, zero-padded to ``d_pad`` columns."""
    if x.shape[-1] != d_pad:
        return F.pad(x, (0, d_pad - x.shape[-1]))
    return x if _rows_16b(x) else x.contiguous()


def _launch(q, k, v, out, causal: bool, window: int, softcap: float,
            kv_len: int, scale: float = 0.0, k_offset: int = 0,
            lse: torch.Tensor = None) -> None:
    """One launch of ``flash_attention_fwd`` on checked CUDA tensors (for
    bfloat16, laid out as :func:`_for_tensor_cores` leaves them).  ``scale``
    defaults to 1/sqrt(D); ``lse``, a contiguous (B, H, Sq) float32 tensor,
    receives the rows' log-sum-exps.  Reported first; on meta tensors
    nothing more."""
    global LAUNCHES
    observe.report("flash_attention", (q, k, v),
                   (out,) if lse is None else (out, lse), causal=causal,
                   window=window, softcap=softcap, kv_len=kv_len,
                   k_offset=k_offset)
    if q.device.type == "meta":
        return
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    fn = _kernel_fn()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *q.stride(), *k.stride(), *v.stride(), *out.stride(),
            b, sq, sk, h, kh, d, int(causal), int(window), int(kv_len or sk),
            int(k_offset), _DTYPE_CODE[q.dtype],
            float(scale or 1.0 / math.sqrt(d)), float(softcap),
            None if lse is None else lse.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: cudaError "
                           f"{rc}")
    LAUNCHES += 1


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, window: int = 0, softcap: float = 0.0,
        kv_len: int = 0, k_offset: int = 0, return_lse: bool = False):
    """q: (B, Sq, H, D); k, v: (B, Sk, Kh, D) with H % Kh == 0 -> (B, Sq, H,
    D) in q's dtype (float32 or bfloat16; float32 softmax state), and with
    ``return_lse`` also the rows' log-sum-exps, (B, H, Sq) float32.

    Query head h reads kv head ``h // (H // Kh)``.  Key j sits at position
    g = j + ``k_offset``; query i sees it when j < ``kv_len`` (0: every
    key), g <= i if ``causal``, and i - g < ``window`` if ``window`` > 0;
    logits are scaled by 1/sqrt(D) and, with ``softcap`` > 0, capped as
    ``softcap * tanh(s / softcap)``.  A row with no visible key: see the
    module docstring; with ``return_lse`` a slice of no keys (Sk = 0) is
    answered without a launch.

    CPU tensors run :func:`mha_plain`; CUDA tensors launch the kernel;
    meta tensors take the CUDA route without the launch.  A
    bfloat16 input whose layout rules out 16-byte copies (D not a multiple
    of 8, an innermost stride other than 1, another stride not a multiple
    of 8 elements, data not 16-byte aligned) is copied to a contiguous
    tensor first, zero-padded to a multiple of 8 columns; the kernel still
    runs.
    """
    _check(q, k, v, window, softcap, kv_len, k_offset, return_lse)
    if k.shape[1] == 0:                  # an empty slice: nothing launched
        b, sq, h, _ = q.shape
        return (torch.zeros_like(q),
                q.new_full((b, h, sq), -math.inf, dtype=torch.float32))
    opts = dict(causal=causal, window=window, softcap=softcap, kv_len=kv_len,
                k_offset=k_offset, return_lse=return_lse)
    if q.device.type == "cpu":
        return mha_plain(q, k, v, **opts)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"mha runs on cpu or cuda (or meta, "
                         f"launching nothing), not {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return Mha.apply(opts, q, k, v)
    return _mha_cuda(q, k, v, **opts)


class Mha(torch.autograd.Function):
    """:func:`mha` on checked CUDA (or meta) tensors with a gradient: the
    forward launches the kernel (returning (out, lse) with ``return_lse``;
    on meta tensors the shapes alone); the
    backward is autograd of :func:`mha_plain`, recomputed on the saved
    inputs."""

    @staticmethod
    def forward(ctx, opts, q, k, v):
        ctx.opts = opts
        ctx.save_for_backward(q, k, v)
        return _mha_cuda(q, k, v, **opts)

    @staticmethod
    def backward(ctx, *g):
        return (None,) + plain_vjp(
            lambda *x: mha_plain(*x, **ctx.opts), ctx.saved_tensors, g,
            ctx.needs_input_grad[1:])


def _mha_cuda(q, k, v, *, causal: bool, window: int, softcap: float,
              kv_len: int, k_offset: int, return_lse: bool):
    """One kernel launch for :func:`mha` on checked CUDA tensors (on meta
    tensors, its outputs' shapes)."""
    b, sq, h, d = q.shape
    if q.dtype == torch.bfloat16:
        d_pad = -(-d // 8) * 8
        q, k, v = (_for_tensor_cores(x, d_pad) for x in (q, k, v))
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    if out.numel():
        _launch(q, k, v, out, causal, window, softcap, kv_len,
                scale=1.0 / math.sqrt(d), k_offset=k_offset, lse=lse)
    out = out if out.shape[-1] == d else out[..., :d].contiguous()
    return (out, lse) if return_lse else out
