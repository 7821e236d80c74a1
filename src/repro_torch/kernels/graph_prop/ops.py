"""Enel graph propagation (eqs. 6-7) over a stacked batch of padded graphs.

``graph_prop`` is the entry the model calls.  On CUDA tensors it launches
the hand-written kernel ``csrc/graph_prop_fwd.cu`` (one thread block per
graph, one warp per destination row, :func:`launch_plan`; built with
``nvcc`` at first use) or raises; it never falls back.
When grad is enabled and an input requires grad, the launch goes through
:class:`GraphProp`, a ``torch.autograd.Function`` whose backward is the
hand-written kernel ``csrc/graph_prop_bwd.cu``.  On CPU tensors it runs
:func:`graph_prop_plain`, the same function in plain PyTorch ops, which is
also what the kernels are held against on the card (the backward against
:func:`graph_prop_vjp_plain`).

Counterpart of ``repro.kernels.graph_prop.ops.graph_prop`` and its custom
VJP.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.kernels import build

X_DIM = 30
HIDDEN = 32
EDGE_DIM = 16
N_METRICS = 5
MAX_NODES = 16          # largest graph one thread block takes (N*N <= 256)

SOURCE = Path(__file__).resolve().parent / "csrc" / "graph_prop_fwd.cu"
SOURCE_BWD = Path(__file__).resolve().parent / "csrc" / "graph_prop_bwd.cu"
MAX_BWD_LEVELS = 64     # the backward kernel stashes every level's state

# kernel launches since import (or since the caller last reset them)
LAUNCHES = 0
LAUNCHES_BWD = 0

_FN = None
_FN_BWD = None


def _leaky(z: torch.Tensor) -> torch.Tensor:
    return torch.where(z >= 0, z, 0.1 * z)


def _weights(params: Dict) -> Tuple[torch.Tensor, ...]:
    f3, f4 = params["f3"], params["f4"]
    return (f3[0]["w"], f3[0]["b"], f3[1]["w"], f3[1]["b"], params["attn_a"],
            f4[0]["w"], f4[0]["b"], f4[1]["w"], f4[1]["b"])


def _params(weights) -> Dict:
    """Inverse of :func:`_weights`: the nine tensors as a parameter dict."""
    (w31, b31, w32, b32, attn, w41, b41, w42, b42) = weights
    return {"f3": [{"w": w31, "b": b31}, {"w": w32, "b": b32}],
            "f4": [{"w": w41, "b": b41}, {"w": w42, "b": b42}],
            "attn_a": attn}


_WEIGHT_SHAPES = ((2 * X_DIM, HIDDEN), (HIDDEN,), (HIDDEN, EDGE_DIM),
                  (EDGE_DIM,), (EDGE_DIM,), (EDGE_DIM + N_METRICS, HIDDEN),
                  (HIDDEN,), (HIDDEN, N_METRICS), (N_METRICS,))
N_WEIGHTS = sum(math.prod(s) for s in _WEIGHT_SHAPES)       # 3365


class LaunchPlan(NamedTuple):
    """How both kernels cut one graph of ``n`` nodes (one block per graph)."""
    threads: int        # per block: one warp per destination row, 32 * n
    slices: int         # S: a pair's lanes split the 32 hidden units S ways
    width: int          # W: source lanes of a row's warp, S * W = 32
    smem_fwd: int       # dynamic shared memory of a forward block, bytes
    smem_bwd: int       # of a backward block at ``levels``, bytes


def launch_plan(n: int, levels: int) -> LaunchPlan:
    """The kernels' plan for graphs of ``n`` nodes and ``levels`` rounds.

    A row i is one warp of W = max(4, next_pow2(n)) source lanes times
    S = 32 / W hidden slices (N <= 4: S = 8; N <= 8: S = 4; N <= 16:
    S = 2).  The shared-memory sizes mirror the buffers the kernels carve
    out (``graph_prop_fwd.cu::fwd_smem``, ``graph_prop_bwd.cu::BwdLayout``),
    and the C entries refuse a plan that differs from theirs.
    """
    if not 1 <= n <= MAX_NODES:
        raise ValueError(f"graph_prop takes 1 <= N <= {MAX_NODES}, got {n}")
    if levels < 0:
        raise ValueError(f"levels must be >= 0, got {levels}")
    w = 4
    while w < n:
        w *= 2
    s = 32 // w
    r4 = lambda v: -(-v // 4) * 4
    hs, xs, ms = HIDDEN + 4, 32, 8           # padded row strides
    weights = 3464 + 8 * s                   # staged, slices 16 B apart
    fwd = weights + n * xs + 3 * n * hs + 2 * n * ms + r4(n)
    pairs = n * w
    pair_floats = 2 * EDGE_DIM + 3 * hs      # h3 g_h3 | g_pre_h h1 g_z1
    bwd = (weights + n * xs + 5 * n * hs + 4 * n * ms + 2 * r4(n)
           + r4(levels * n * N_METRICS) + n * HIDDEN * (2 * N_METRICS + 1)
           + pairs * pair_floats + r4(pairs))
    return LaunchPlan(32 * n, s, w, 4 * fwd, 4 * bwd)


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


def graph_prop_vjp_plain(params: Dict, x: torch.Tensor, adj: torch.Tensor,
                         m_obs: torch.Tensor, valid: torch.Tensor,
                         g_e: torch.Tensor, g_mhat: torch.Tensor, *,
                         levels: int) -> Tuple[torch.Tensor, ...]:
    """Plain version of the backward kernel: autograd through
    :func:`graph_prop_plain` under the cotangents (g_e, g_mhat).

    Returns ``(gx, gm_obs, gw31, gb31, gw32, gb32, g_attn, gw41, gb41, gw42,
    gb42)``, the gradients of x, m_obs and the nine weights of
    :func:`_weights` (zeros where the output does not depend on one).
    """
    with torch.enable_grad():
        xs = x.detach().requires_grad_(True)
        ms = m_obs.detach().requires_grad_(True)
        ws = [w.detach().requires_grad_(True) for w in _weights(params)]
        e, m_hat = graph_prop_plain(_params(ws), xs, adj, ms, valid,
                                    levels=levels)
        wrt = [xs, ms] + ws
        grads = torch.autograd.grad((e, m_hat), wrt, (g_e, g_mhat),
                                    allow_unused=True)
    return tuple(torch.zeros_like(t) if g is None else g
                 for g, t in zip(grads, wrt))


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
        fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 7 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _bwd_kernel_fn():
    global _FN_BWD
    if _FN_BWD is None:
        fn = build.load(SOURCE_BWD).graph_prop_bwd
        fn.argtypes = [ctypes.c_void_p] * 19 + [ctypes.c_int] * 7 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN_BWD = fn
    return _FN_BWD


def _launch_fwd(x, adj, m_obs, valid, weights, levels: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of ``graph_prop_fwd`` on checked CUDA tensors."""
    global LAUNCHES
    b, n, _ = x.shape
    e = torch.empty((b, n, n), dtype=torch.float32, device=x.device)
    m_hat = torch.empty((b, n, N_METRICS), dtype=torch.float32,
                        device=x.device)
    if b == 0:
        return e, m_hat
    fn = _kernel_fn()
    plan = launch_plan(n, levels)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(*(t.data_ptr() for t in (x, adj, m_obs, valid) + weights),
            e.data_ptr(), m_hat.data_ptr(), b, n, int(levels),
            *plan[:3], plan.smem_fwd, stream)
    if rc != 0:
        raise RuntimeError(f"graph_prop_fwd launch failed: cudaError {rc}")
    LAUNCHES += 1
    return e, m_hat


def _launch_bwd(x, adj, m_obs, valid, weights, g_e, g_mhat, levels: int
                ) -> Tuple[torch.Tensor, ...]:
    """One launch of ``graph_prop_bwd`` (per-graph kernel + slot sum).
    Returns the gradients in the order of :func:`graph_prop_vjp_plain`."""
    global LAUNCHES_BWD
    b, n, _ = x.shape
    dev = x.device
    gx = torch.empty_like(x)
    gmo = torch.empty_like(m_obs)
    flat = torch.empty(N_WEIGHTS, dtype=torch.float32, device=dev)
    if b == 0:
        flat.zero_()
    else:
        slots = torch.empty((b, N_WEIGHTS), dtype=torch.float32, device=dev)
        fn = _bwd_kernel_fn()
        plan = launch_plan(n, levels)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*(t.data_ptr() for t in (x, adj, m_obs, valid) + weights +
                  (g_e, g_mhat, gx, gmo, slots, flat)),
                b, n, int(levels), *plan[:3], plan.smem_bwd, stream)
        if rc != 0:
            raise RuntimeError(
                f"graph_prop_bwd launch failed: cudaError {rc}")
        LAUNCHES_BWD += 1
    grads, off = [], 0
    for shape in _WEIGHT_SHAPES:
        size = math.prod(shape)
        grads.append(flat[off:off + size].view(shape))
        off += size
    return (gx, gmo) + tuple(grads)


class GraphProp(torch.autograd.Function):
    """eqs. 6-7 with both passes in the hand-written kernels.  The forward
    saves only the primal inputs (as the reference's ``_core_fwd`` does);
    the backward kernel recomputes the rest."""

    @staticmethod
    def forward(ctx, levels: int, x, adj, m_obs, valid, *weights):
        ctx.levels = levels
        ctx.save_for_backward(x, adj, m_obs, valid, *weights)
        return _launch_fwd(x, adj, m_obs, valid, weights, levels)

    @staticmethod
    def backward(ctx, g_e, g_mhat):
        x, adj, m_obs, valid, *weights = ctx.saved_tensors
        gx, gmo, *gw = _launch_bwd(x, adj, m_obs, valid, tuple(weights),
                                   g_e.contiguous(), g_mhat.contiguous(),
                                   ctx.levels)
        return (None, gx, None, gmo, None, *gw)


def graph_prop(params: Dict, x: torch.Tensor, adj: torch.Tensor,
               m_obs: torch.Tensor, valid: torch.Tensor, *,
               levels: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """eqs. 6-7 for a stacked batch of padded graphs.

    params: the Enel parameter dict (uses "f3", "f4", "attn_a"); x:
    (B, N, 30) float32; adj: (B, N, N) bool, ``adj[b, i, j]`` is the edge
    j -> i (already mask-ANDed); m_obs: (B, N, 5) float32; valid: (B, N)
    bool.  Returns (e (B, N, N), m_hat (B, N, 5)), float32, differentiable
    in x, m_obs and the weights.

    CPU tensors run :func:`graph_prop_plain`; CUDA tensors launch the
    forward kernel, through :class:`GraphProp` when grad is enabled and an
    input requires grad (its backward launches the backward kernel).
    """
    _check(params, x, adj, m_obs, valid, levels)
    if x.device.type == "cpu":
        return graph_prop_plain(params, x, adj, m_obs, valid, levels=levels)
    if x.device.type != "cuda":
        raise ValueError(f"graph_prop runs on cpu or cuda, not {x.device}")
    weights = _weights(params)
    tensors = (x, adj, m_obs, valid) + weights
    for t, shape in zip(weights, _WEIGHT_SHAPES):
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"weight of shape {tuple(t.shape)} "
                             f"({t.dtype}) where float32 {shape} is needed")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("graph_prop needs contiguous tensors")
    if x.shape[1] > MAX_NODES:
        raise ValueError(f"graph_prop takes N <= {MAX_NODES}, got "
                         f"{x.shape[1]}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        if levels > MAX_BWD_LEVELS:
            raise ValueError(f"graph_prop's backward takes levels <= "
                             f"{MAX_BWD_LEVELS}, got {levels}")
        return GraphProp.apply(int(levels), *tensors)
    return _launch_fwd(x, adj, m_obs, valid, weights, levels)
