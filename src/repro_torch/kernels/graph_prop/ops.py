"""Enel graph propagation (eqs. 6-7) over a stacked batch of padded graphs.

``graph_prop`` is the entry the model calls.  On CUDA tensors it launches
the hand-written kernel ``csrc/graph_prop_fwd.cu`` (one thread block per
graph; built with ``nvcc`` at first use) or raises; it never falls back.
On CPU tensors it runs :func:`graph_prop_plain`, the same function in plain
PyTorch ops, which is also what the kernel is held against on the card.

Counterpart of ``repro.kernels.graph_prop.ops.graph_prop`` (forward only:
the backward kernel comes with the training path).
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Tuple

import torch

from repro_torch.kernels import build

X_DIM = 30
HIDDEN = 32
EDGE_DIM = 16
N_METRICS = 5
MAX_NODES = 16          # largest graph one thread block takes (N*N <= 256)

SOURCE = Path(__file__).resolve().parent / "csrc" / "graph_prop_fwd.cu"

# kernel launches since import (or since the caller last reset it)
LAUNCHES = 0

_FN = None


def _leaky(z: torch.Tensor) -> torch.Tensor:
    return torch.where(z >= 0, z, 0.1 * z)


def _weights(params: Dict) -> Tuple[torch.Tensor, ...]:
    f3, f4 = params["f3"], params["f4"]
    return (f3[0]["w"], f3[0]["b"], f3[1]["w"], f3[1]["b"], params["attn_a"],
            f4[0]["w"], f4[0]["b"], f4[1]["w"], f4[1]["b"])


_WEIGHT_SHAPES = ((2 * X_DIM, HIDDEN), (HIDDEN,), (HIDDEN, EDGE_DIM),
                  (EDGE_DIM,), (EDGE_DIM,), (EDGE_DIM + N_METRICS, HIDDEN),
                  (HIDDEN,), (HIDDEN, N_METRICS), (N_METRICS,))


def graph_prop_plain(params: Dict, x: torch.Tensor, adj: torch.Tensor,
                     m_obs: torch.Tensor, valid: torch.Tensor, *,
                     levels: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch eqs. 6-7 with the kernel's math (f4's first layer split
    so ``h3 @ W41[:16]`` runs once).  Same arguments as :func:`graph_prop`.
    """
    (w31, b31, w32, b32, attn, w41, b41, w42, b42) = _weights(params)
    b, n, xd = x.shape
    valid = valid[..., None]
    xi = x[:, :, None, :].expand(b, n, n, xd)
    xj = x[:, None, :, :].expand(b, n, n, xd)
    pair = torch.cat([xi, xj], dim=-1)
    h3 = _leaky(pair @ w31 + b31) @ w32 + b32               # (B, N, N, E)
    logits = _leaky(h3) @ attn
    logits = torch.where(adj, logits, torch.full_like(logits, -1e30))
    sm = torch.softmax(logits, dim=-1)
    has_pred = adj.any(dim=-1, keepdim=True)
    e = torch.where(has_pred, sm, torch.zeros_like(sm))
    pre_h = h3 @ w41[:EDGE_DIM]                              # (B, N, N, H)
    w_m = w41[EDGE_DIM:]
    m_cur = m_obs
    for _ in range(levels):
        mj = torch.where(valid, m_obs, m_cur)
        hh = _leaky(pre_h + (mj @ w_m)[:, None, :, :] + b41)
        msg = hh @ w42 + b42                                 # (B, N, N, M)
        m_prop = (e[..., None] * msg).sum(dim=2)
        m_cur = torch.where(valid, m_obs, m_prop)
    return e, m_cur


def _check(params: Dict, x, adj, m_obs, valid, levels: int) -> None:
    if x.dim() != 3 or x.shape[-1] != X_DIM:
        raise ValueError(f"x must be (B, N, {X_DIM}), got {tuple(x.shape)}")
    b, n, _ = x.shape
    for name, t, shape in (("adj", adj, (b, n, n)),
                           ("m_obs", m_obs, (b, n, N_METRICS)),
                           ("valid", valid, (b, n))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if x.dtype != torch.float32 or m_obs.dtype != torch.float32:
        raise TypeError("x and m_obs must be float32")
    if adj.dtype != torch.bool or valid.dtype != torch.bool:
        raise TypeError("adj and valid must be bool")
    if levels < 0:
        raise ValueError(f"levels must be >= 0, got {levels}")
    tensors = (x, adj, m_obs, valid) + _weights(params)
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs and weights lie on several devices: "
                         f"{sorted(str(d) for d in devices)}")


def _kernel_fn():
    global _FN
    if _FN is None:
        fn = build.load(SOURCE).graph_prop_fwd
        fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 3 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def graph_prop(params: Dict, x: torch.Tensor, adj: torch.Tensor,
               m_obs: torch.Tensor, valid: torch.Tensor, *,
               levels: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """eqs. 6-7 for a stacked batch of padded graphs.

    params: the Enel parameter dict (uses "f3", "f4", "attn_a"); x:
    (B, N, 30) float32; adj: (B, N, N) bool, ``adj[b, i, j]`` is the edge
    j -> i (already mask-ANDed); m_obs: (B, N, 5) float32; valid: (B, N)
    bool.  Returns (e (B, N, N), m_hat (B, N, 5)), float32.

    CPU tensors run :func:`graph_prop_plain`; CUDA tensors launch the kernel
    (forward only, so no input may require grad there).
    """
    global LAUNCHES
    _check(params, x, adj, m_obs, valid, levels)
    if x.device.type == "cpu":
        return graph_prop_plain(params, x, adj, m_obs, valid, levels=levels)
    weights = _weights(params)
    tensors = (x, adj, m_obs, valid) + weights
    if any(t.requires_grad for t in tensors):
        raise RuntimeError("graph_prop has no backward kernel yet: call it "
                           "under torch.no_grad() or on detached tensors")
    if x.device.type != "cuda":
        raise ValueError(f"graph_prop runs on cpu or cuda, not {x.device}")
    for t, shape in zip(weights, _WEIGHT_SHAPES):
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"weight of shape {tuple(t.shape)} "
                             f"({t.dtype}) where float32 {shape} is needed")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("graph_prop needs contiguous tensors")
    b, n, _ = x.shape
    if n > MAX_NODES:
        raise ValueError(f"graph_prop takes N <= {MAX_NODES}, got {n}")
    e = torch.empty((b, n, n), dtype=torch.float32, device=x.device)
    m_hat = torch.empty((b, n, N_METRICS), dtype=torch.float32,
                        device=x.device)
    if b == 0:
        return e, m_hat
    fn = _kernel_fn()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(*(t.data_ptr() for t in tensors), e.data_ptr(), m_hat.data_ptr(),
            b, n, int(levels), stream)
    if rc != 0:
        raise RuntimeError(f"graph_prop_fwd launch failed: cudaError {rc}")
    LAUNCHES += 1
    return e, m_hat
