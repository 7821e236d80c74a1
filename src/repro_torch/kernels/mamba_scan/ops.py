"""Mamba's selective scan in the model's (B, S, D) layout.

``selective_scan`` is the entry the model calls.  On CUDA tensors it
launches the hand-written kernel ``csrc/mamba_scan.cu`` (built with
``nvcc`` at first use) or raises; it never falls back.  On CPU tensors it
runs :func:`selective_scan_plain`, the same recurrence in plain PyTorch
ops, which is also what the kernel is held against on the card.  When grad
is enabled and an input requires it, the launch goes through
:class:`SelectiveScan`, whose backward is autograd of
:func:`selective_scan_plain` recomputed on the saved inputs
(``kernels/vjp.py``).

On ``meta`` tensors (the dry run, ``launch.dryrun``) :func:`selective_scan`
takes the CUDA route up to the launch and stops there: the outputs' shapes
and dtypes, nothing launched.  Every call on CUDA or meta tensors is
reported at the launch as one op (``kernels/observe.py``); :func:`cost`
gives its FLOPs and bytes.

Counterpart of ``repro.kernels.mamba_scan.ops.selective_scan`` (whose
kernel is ``mamba_scan``), with the same arguments.  It computes the strict
recurrence of the reference's oracle ``ref.py::mamba_scan_ref``, not the
TPU kernel's chunked cumulative-log form, which overflows float32 once
dt |a| summed over a chunk passes about 88; and it can return the final
state h, which the prefill cache needs.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple, Union

import torch

from repro_torch.kernels import build, observe
from repro_torch.kernels.vjp import plain_vjp

SOURCE = Path(__file__).resolve().parent / "csrc" / "mamba_scan.cu"
STATE_DIMS = (1, 2, 4, 8, 16, 32)
X_DTYPES = (torch.float32, torch.bfloat16)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since import (or since the caller last reset them)
LAUNCHES = 0

_FN = None

Output = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def selective_scan_plain(dt: torch.Tensor, a: torch.Tensor, x: torch.Tensor,
                         b: torch.Tensor, c: torch.Tensor, *,
                         return_state: bool = False) -> Output:
    """The recurrence step by step in float32 (same arguments as
    :func:`selective_scan`): decay and drive are formed one step at a time,
    (B, D, N) each, never over the whole (B, S, D, N)."""
    bsz, s, d = dt.shape
    xf = x.float()
    h = torch.zeros((bsz, d, a.shape[1]), dtype=torch.float32,
                    device=dt.device)
    ys = []
    for t in range(s):
        dt_t = dt[:, t]                                      # (B, D)
        decay = torch.exp(dt_t[..., None] * a)
        drive = (dt_t * xf[:, t])[..., None] * b[:, t, None, :]
        h = decay * h + drive
        ys.append(torch.einsum("bdn,bn->bd", h, c[:, t]))
    y = torch.stack(ys, dim=1)
    return (y, h) if return_state else y


def cost(reads, writes, opts) -> tuple:
    """(FLOPs, bytes) of one call (``kernels/observe.py``): the product of
    :func:`selective_scan_plain`, h C at every step (2 B S D N); dt, a, x,
    b, c read once, y and h written once."""
    (bsz, s, d), _ = reads[0]
    n = reads[1][0][1]
    return 2 * bsz * s * d * n, observe.moved(reads, writes)


def _check(dt, a, x, b, c) -> None:
    if dt.dim() != 3 or tuple(x.shape) != tuple(dt.shape):
        raise ValueError(f"dt and x must be one (B, S, D), got "
                         f"{tuple(dt.shape)}, {tuple(x.shape)}")
    bsz, s, d = dt.shape
    if a.dim() != 2 or a.shape[0] != d:
        raise ValueError(f"a must be (D, N) with D = {d}, got "
                         f"{tuple(a.shape)}")
    n = a.shape[1]
    if tuple(b.shape) != (bsz, s, n) or tuple(c.shape) != (bsz, s, n):
        raise ValueError(f"b and c must be (B, S, N) = {(bsz, s, n)}, got "
                         f"{tuple(b.shape)}, {tuple(c.shape)}")
    if min(bsz, s, d) < 1:
        raise ValueError(f"empty input: (B, S, D) = {tuple(dt.shape)}")
    if n not in STATE_DIMS:
        raise ValueError(f"state dim N must be one of {STATE_DIMS}, got {n}")
    if any(t.dtype != torch.float32 for t in (dt, a, b, c)):
        raise TypeError(f"dt, a, b, c must be float32, got {dt.dtype}, "
                        f"{a.dtype}, {b.dtype}, {c.dtype}")
    if x.dtype not in X_DTYPES:
        raise TypeError(f"x dtype must be one of {X_DTYPES}, got {x.dtype}")
    if not all(t.is_contiguous() for t in (dt, a, x, b, c)):
        raise ValueError("dt, a, x, b, c must be contiguous")
    devices = {t.device for t in (dt, a, x, b, c)}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: "
                         f"{sorted(str(v) for v in devices)}")


def _kernel_fn():
    global _FN
    if _FN is None:
        fn = build.load(SOURCE).mamba_scan
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _launch(dt, a, x, b, c, y, h) -> None:
    """One launch of ``mamba_scan`` on checked CUDA tensors, reported
    first; on meta tensors nothing more."""
    global LAUNCHES
    observe.report("mamba_scan", (dt, a, x, b, c), (y, h))
    if dt.device.type == "meta":
        return
    bsz, s, d = dt.shape
    fn = _kernel_fn()
    stream = torch.cuda.current_stream(dt.device).cuda_stream
    rc = fn(*(t.data_ptr() for t in (dt, a, x, b, c, y, h)),
            bsz, s, d, a.shape[1], _DTYPE_CODE[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"mamba_scan launch failed: cudaError {rc}")
    LAUNCHES += 1


def selective_scan(dt: torch.Tensor, a: torch.Tensor, x: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor, *,
                   return_state: bool = False) -> Output:
    """dt: (B, S, D) float32, already through softplus; a: (D, N) float32,
    negative (left to the caller, as in the reference); x: (B, S, D)
    float32 or bfloat16 (widened to float32); b, c: (B, S, N) float32.
    Returns y (B, S, D) float32, the SSM output without the D x skip term,
    and with ``return_state`` also the final h (B, D, N) float32.

    CPU tensors run :func:`selective_scan_plain`; CUDA tensors launch the
    kernel; meta tensors take the CUDA route without the launch."""
    _check(dt, a, x, b, c)
    if dt.device.type == "cpu":
        return selective_scan_plain(dt, a, x, b, c, return_state=return_state)
    if dt.device.type not in ("cuda", "meta"):
        raise ValueError(f"selective_scan runs on cpu or cuda (or meta, "
                         f"launching nothing), not {dt.device}")
    inputs = (dt, a, x, b, c)
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        y, h = SelectiveScan.apply(*inputs)
    else:
        y, h = _scan_cuda(*inputs)
    return (y, h) if return_state else y


class SelectiveScan(torch.autograd.Function):
    """:func:`selective_scan` on checked CUDA (or meta) tensors with a
    gradient: the forward launches the kernel and returns (y, h) (on meta
    tensors their shapes); the backward is
    autograd of :func:`selective_scan_plain`, recomputed on the saved
    inputs."""

    @staticmethod
    def forward(ctx, dt, a, x, b, c):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(dt, a, x, b, c)
        return _scan_cuda(dt, a, x, b, c)

    @staticmethod
    def backward(ctx, g_y, g_h):
        return plain_vjp(
            lambda *t: selective_scan_plain(*t, return_state=True),
            ctx.saved_tensors, (g_y, g_h), ctx.needs_input_grad)


def _scan_cuda(dt, a, x, b, c):
    """One kernel launch for :func:`selective_scan` on checked CUDA (or
    meta) tensors: (y, h)."""
    bsz, _, d = dt.shape
    y = torch.empty(dt.shape, dtype=torch.float32, device=dt.device)
    h = torch.empty((bsz, d, a.shape[1]), dtype=torch.float32,
                    device=dt.device)
    _launch(dt, a, x, b, c, y, h)
    return y, h
