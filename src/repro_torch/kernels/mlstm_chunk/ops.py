"""Chunkwise mLSTM in the model's (B, S, H, D) layout, gates (B, S, H).

``mlstm`` is the entry the model calls.  On CUDA tensors it launches the
hand-written kernel ``csrc/mlstm_chunk.cu`` (built with ``nvcc`` at first
use) or raises; it never falls back.  On CPU tensors it runs
:func:`mlstm_plain`, the same function in plain PyTorch ops, which is also
what the kernel is held against on the card.  When grad is enabled and an
input requires it, the launch goes through :class:`Mlstm`, whose backward
is autograd of :func:`mlstm_plain` recomputed on the saved inputs
(``kernels/vjp.py``).

On ``meta`` tensors (the dry run, ``launch.dryrun``) :func:`mlstm` takes
the CUDA route up to the launch and stops there: the outputs' shapes and
dtypes, nothing launched.  Every call on CUDA or meta tensors is reported
as one op (``kernels/observe.py``), with the ``chunk`` that sets the plain
version's work; :func:`cost` gives its FLOPs and bytes.

Counterpart of ``repro.kernels.mlstm_chunk.ops.mlstm`` (whose kernel is
``mlstm_chunk``); unlike it, nothing is transposed, and the final state
(C, n, m) can be returned, as ``repro.models.ssm.mlstm_chunk_scan`` returns
it, for the prefill cache.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Dict, Tuple, Union

import torch

from repro_torch.kernels import build, observe
from repro_torch.kernels.vjp import plain_vjp

SOURCE = Path(__file__).resolve().parent / "csrc" / "mlstm_chunk.cu"
M_INIT = -1e30          # the stabiliser's start, as in the reference
HEAD_DIMS = (16, 32, 64, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since import (or since the caller last reset them)
LAUNCHES = 0

_FN = None

Output = Union[torch.Tensor, Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: -softplus(-x), with softplus(y) = max(y, 0) +
    log1p(exp(-|y|)), written out so that both packages round alike."""
    return -(torch.clamp_min(-x, 0.0) + torch.log1p(torch.exp(-x.abs())))


def mlstm_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                i: torch.Tensor, f: torch.Tensor, *, chunk: int = 128,
                return_state: bool = False) -> Output:
    """The chunkwise stabilised mLSTM in float32, chunk by chunk as
    ``repro.models.ssm.mlstm_chunk_scan`` computes it (same arguments as
    :func:`mlstm`; k is scaled by 1/sqrt(D) and f goes through
    ``log_sigmoid`` here)."""
    b, s, h, d = q.shape
    L = min(chunk, s)
    qf, vf = q.float(), v.float()
    kf = k.float() / math.sqrt(d)
    ig, lf = i.float(), log_sigmoid(f.float())
    dev = q.device
    C = torch.zeros((b, h, d, d), dtype=torch.float32, device=dev)
    n = torch.zeros((b, h, d), dtype=torch.float32, device=dev)
    m = torch.full((b, h), M_INIT, dtype=torch.float32, device=dev)
    causal = torch.ones((L, L), dtype=torch.bool, device=dev).tril()
    causal = causal[None, :, :, None]                        # t >= s
    outs = []
    for c0 in range(0, s, L):
        qc, kc, vc = qf[:, c0:c0 + L], kf[:, c0:c0 + L], vf[:, c0:c0 + L]
        ic, lfc = ig[:, c0:c0 + L], lf[:, c0:c0 + L]          # (B, L, H)
        F = torch.cumsum(lfc, dim=1)
        dm = F[:, :, None, :] - F[:, None, :, :] + ic[:, None, :, :]
        dm = torch.where(causal, dm, torch.full_like(dm, -math.inf))
        m_intra = dm.amax(dim=2)                             # (B, L, H)
        m_inter = F + m[:, None, :]
        m_t = torch.maximum(m_intra, m_inter)
        ws = torch.exp(dm - m_t[:, :, None, :]) * \
            torch.einsum("blhd,bshd->blsh", qc, kc)          # (B, L, L, H)
        w_inter = torch.exp(m_inter - m_t)
        num = torch.einsum("blsh,bshd->blhd", ws, vc) + \
            w_inter[..., None] * torch.einsum("blhd,bhde->blhe", qc, C)
        den = ws.sum(dim=2) + w_inter * torch.einsum("blhd,bhd->blh", qc, n)
        outs.append(num / torch.clamp_min(den.abs(), 1.0)[..., None])
        f_tot, m_end = F[:, -1], m_t[:, -1]                  # (B, H)
        g_old = torch.exp(f_tot + m - m_end)
        w_end = torch.exp(f_tot[:, None] - F + ic - m_end[:, None])
        kw = kc * w_end[..., None]
        C = g_old[:, :, None, None] * C + \
            torch.einsum("blhd,blhe->bhde", kw, vc)
        n = g_old[:, :, None] * n + kw.sum(dim=1)
        m = m_end
    out = torch.cat(outs, dim=1).to(q.dtype)
    if return_state:
        return out, {"C": C, "n": n, "m": m}
    return out


def cost(reads, writes, opts) -> tuple:
    """(FLOPs, bytes) of one call (``kernels/observe.py``): the products of
    :func:`mlstm_plain` at ``opts["chunk"]``, for each of its S / L chunks
    of L = min(chunk, S) rows: q k^T and w v (2 B H L^2 D each), q C and
    the C update (2 B H L D^2 each) and q n (2 B H L D); q, k, v and the
    gates read once, h and the state written once."""
    (b, s, h, d), _ = reads[0]
    el = min(opts["chunk"], s)
    per_chunk = 4 * b * h * el * el * d + 4 * b * h * el * d * d + \
        2 * b * h * el * d
    return (s // el) * per_chunk, observe.moved(reads, writes)


def _check(q, k, v, i, f, chunk: int) -> None:
    if q.dim() != 4 or tuple(k.shape) != tuple(q.shape) or \
            tuple(v.shape) != tuple(q.shape):
        raise ValueError(f"q, k, v must be one (B, S, H, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, h, d = q.shape
    if tuple(i.shape) != (b, s, h) or tuple(f.shape) != (b, s, h):
        raise ValueError(f"gates i, f must be (B, S, H) = {(b, s, h)}, got "
                         f"{tuple(i.shape)}, {tuple(f.shape)}")
    if min(b, s, h) < 1:
        raise ValueError(f"empty input: (B, S, H, D) = {tuple(q.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim must be one of {HEAD_DIMS}, got {d}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype of {DTYPES}, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if i.dtype != torch.float32 or f.dtype != torch.float32:
        raise TypeError(f"gates must be float32, got {i.dtype}, {f.dtype}")
    if chunk < 1 or s % min(chunk, s):
        raise ValueError(
            f"S = {s} must be a multiple of min(chunk, S) with chunk = "
            f"{chunk} >= 1: the reference's contract "
            f"(repro/models/ssm.py:177-178, kernels/mlstm_chunk/kernel.py:"
            f"75-76) has no ragged last chunk")
    if not all(t.is_contiguous() for t in (q, k, v, i, f)):
        raise ValueError("q, k, v, i, f must be contiguous")
    devices = {t.device for t in (q, k, v, i, f)}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: "
                         f"{sorted(str(x) for x in devices)}")


def _kernel_fn():
    global _FN
    if _FN is None:
        fn = build.load(SOURCE).mlstm_chunk
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _launch(q, k, v, i, f, out, C, n, m) -> None:
    """One launch of ``mlstm_chunk`` on checked CUDA tensors; nothing on
    meta tensors."""
    global LAUNCHES
    if q.device.type == "meta":
        return
    b, s, h, d = q.shape
    fn = _kernel_fn()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(*(t.data_ptr() for t in (q, k, v, i, f, out, C, n, m)),
            b, s, h, d, _DTYPE_CODE[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"mlstm_chunk launch failed: cudaError {rc}")
    LAUNCHES += 1


def mlstm(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          i: torch.Tensor, f: torch.Tensor, *, chunk: int = 128,
          return_state: bool = False) -> Output:
    """q, k, v: (B, S, H, D) float32 or bfloat16, k not yet scaled (it is
    scaled by 1/sqrt(D) inside); i: (B, S, H) log input gate; f: (B, S, H)
    forget gate before its ``log_sigmoid``; both float32.  Returns h (B, S,
    H, D) in q's dtype and, with ``return_state``, the final float32 state
    {"C": (B, H, D, D), "n": (B, H, D), "m": (B, H)}.

    ``chunk`` is the reference's chunk length: S must be a multiple of
    min(chunk, S).  CPU tensors run :func:`mlstm_plain` with it; CUDA
    tensors launch the kernel, which walks chunks of its own length (the
    result does not depend on the chunking); meta tensors take the CUDA
    route without the launch.
    """
    _check(q, k, v, i, f, chunk)
    if q.device.type == "cpu":
        return mlstm_plain(q, k, v, i, f, chunk=chunk,
                           return_state=return_state)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"mlstm runs on cpu or cuda (or meta, "
                         f"launching nothing), not {q.device}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k, v must start on a 16-byte boundary")
    inputs = (q, k, v, i, f)
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        out, C, n, m = Mlstm.apply(chunk, *inputs)
    else:
        out, C, n, m = _run(chunk, *inputs)
    if return_state:
        return out, {"C": C, "n": n, "m": m}
    return out


class Mlstm(torch.autograd.Function):
    """:func:`mlstm` on checked CUDA (or meta) tensors with a gradient: the
    forward launches the kernel and returns (h, C, n, m) (on meta tensors
    their shapes); the backward is autograd
    of :func:`mlstm_plain` (at the caller's ``chunk``), recomputed on the
    saved inputs."""

    @staticmethod
    def forward(ctx, chunk, q, k, v, i, f):
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(q, k, v, i, f)
        return _run(chunk, q, k, v, i, f)

    @staticmethod
    def backward(ctx, g_out, g_C, g_n, g_m):
        def plain(*x):
            out, st = mlstm_plain(*x, chunk=ctx.chunk, return_state=True)
            return out, st["C"], st["n"], st["m"]
        return (None,) + plain_vjp(plain, ctx.saved_tensors,
                                   (g_out, g_C, g_n, g_m),
                                   ctx.needs_input_grad[1:])


def _run(chunk: int, *inputs):
    """:func:`_mlstm_cuda`, reported with the caller's ``chunk``, which sets
    the plain version's work (``kernels/observe.py``)."""
    outs = _mlstm_cuda(*inputs)
    observe.report("mlstm_chunk", inputs, outs, chunk=chunk)
    return outs


def _mlstm_cuda(q, k, v, i, f):
    """One kernel launch for :func:`mlstm` on checked CUDA (or meta)
    tensors: (h, C, n, m)."""
    b, s, h, d = q.shape
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    C = torch.empty((b, h, d, d), dtype=torch.float32, device=q.device)
    n = torch.empty((b, h, d), dtype=torch.float32, device=q.device)
    m = torch.empty((b, h), dtype=torch.float32, device=q.device)
    _launch(q, k, v, i, f, out, C, n, m)
    return out, C, n, m
