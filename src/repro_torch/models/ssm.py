"""State-space / recurrent mixers: Mamba (jamba), mLSTM and sLSTM (xLSTM).

Counterpart of ``repro.models.ssm``.  Each mixer has a full-sequence form
(train / prefill) and a one-token decode form carrying an explicit state
dict.  The Mamba mixer's full-sequence scan is the hand-written kernel's
work: :func:`mamba_forward` goes through
:func:`repro_torch.kernels.mamba_scan.ops.selective_scan`, which launches
the CUDA kernel on CUDA tensors and runs its plain version (the strict
recurrence) on CPU tensors; its decode step is plain ops, as in the
reference.  The mLSTM's full-sequence form likewise goes through
:func:`repro_torch.kernels.mlstm_chunk.ops.mlstm` (the reference's
``mlstm_chunk_scan``, chunk 256, on CPU tensors).  The sLSTM has no kernel
in either package: its full-sequence form is a Python loop over time, as
the reference's ``lax.scan``.

Given ``tp`` (a ``launch.collectives.TP`` over ``"model"``), the Mamba and
mLSTM mixers run on this rank's shards.  Mamba: its ``dI / tp`` channels
(``conv_*``, ``dt_proj``, ``dt_bias``, ``A_log``, ``D`` are their shards;
``in_proj`` comes whole, since its column shards do not line up with the
``x1`` / ``z`` halves, and each rank takes both halves' columns of its
channels), ``x_proj`` row-parallel with dt, B and C summed over the ranks,
``out_proj`` row-parallel; its state holds its channels.  mLSTM, full
sequence: its heads (``wq`` / ``wk`` / ``wv`` / ``w_gate`` columns, ``w_out``
rows; the replicated gates cut to its heads) through the unchanged chunk
kernel; the final state is then placed on the value dim, as the cache
holds it.  mLSTM, one token: on a state whose ``C`` holds this rank's
value columns (``(B, H, Dh, Dh / tp)``, weights whole): q, k, the gates
and ``n`` computed alike on every rank, v's columns local; the value
columns of ``C`` and ``h`` are independent given ``n`` and ``m``, so this is
exact.  The sLSTM stays replicated.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.mamba_scan.ops import selective_scan
from repro_torch.kernels.mlstm_chunk.ops import M_INIT, log_sigmoid, mlstm
from repro_torch.launch.collectives import (copy_to, gather_dim, reduce_from,
                                            reduce_out)
from repro_torch.models.layers import DTYPES, dense_init
from repro_torch.models.sharding import constrain

CHUNK = 256             # the reference's chunk (repro/models/ssm.py:167)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: x * sigmoid(x)."""
    return x * torch.sigmoid(x)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0).  (``F.softplus`` switches to x
    above its threshold of 20, which this does not.)"""
    return torch.logaddexp(x, torch.zeros_like(x))


# ======================================================================= Mamba
def mamba_dims(cfg: ModelConfig) -> Tuple[int, int]:
    """(d_inner, dt_rank)."""
    d_inner = cfg.mamba_expand * cfg.d_model
    dt_rank = max(1, math.ceil(cfg.d_model / 16))
    return d_inner, dt_rank


def init_mamba(gen, cfg: ModelConfig, device: torch.device) -> Dict:
    dt = DTYPES[cfg.param_dtype]
    di, r = mamba_dims(cfg)
    n, dconv = cfg.mamba_d_state, cfg.mamba_d_conv
    f32 = torch.float32
    a = torch.arange(1, n + 1, dtype=f32, device=device).repeat(di, 1)
    conv_w = torch.randn(dconv, di, generator=gen, dtype=f32,
                         device=device) / math.sqrt(dconv)
    p = {"in_proj": dense_init(gen, cfg.d_model, 2 * di, dt, device),
         "conv_w": conv_w.to(dt),
         "conv_b": torch.zeros(di, dtype=dt, device=device),
         "x_proj": dense_init(gen, di, r + 2 * n, dt, device),
         "dt_proj": dense_init(gen, r, di, dt, device)}
    # softplus^-1 of U(1e-3, 1e-1)
    u = torch.rand(di, generator=gen, dtype=f32, device=device) * \
        (1e-1 - 1e-3) + 1e-3
    p.update({"dt_bias": torch.log(torch.expm1(u)), "A_log": torch.log(a),
              "D": torch.ones(di, dtype=f32, device=device),
              "out_proj": dense_init(gen, di, cfg.d_model, dt, device)})
    return p


def _mamba_conv_full(p: Dict, x1: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv along S, x1: (B, S, dI): the shifted products
    summed in the reference's order, then the bias."""
    dconv, s = p["conv_w"].shape[0], x1.shape[1]
    w = p["conv_w"].to(x1.dtype)
    out = torch.zeros_like(x1)
    for i in range(dconv):
        shift = dconv - 1 - i
        out = out + F.pad(x1, (0, 0, shift, 0))[:, :s] * w[i]
    return out + p["conv_b"].to(x1.dtype)


def _mamba_core(p: Dict, cfg: ModelConfig, x1: torch.Tensor, tp=None):
    """The scan's per-token inputs, x1: (B, S, dI) post-conv post-silu:
    dt (B, S, dI) through softplus, a = -exp(A_log) (dI, N), and B, C
    (B, S, N), all float32.  Unlike the reference, decay and drive are not
    formed here: over (B, S, dI, N) they would not fit the card."""
    _, r = mamba_dims(cfg)
    n = cfg.mamba_d_state
    dbc = x1 @ p["x_proj"]
    if tp is not None:
        dbc = copy_to(reduce_from(dbc, tp), tp)
    dt_raw, bc, cc = torch.split(dbc, [r, n, n], dim=-1)
    dt = softplus((dt_raw @ p["dt_proj"]).float() + p["dt_bias"])
    a = -torch.exp(p["A_log"])
    return dt, a, bc.float().contiguous(), cc.float().contiguous()


def _mamba_out(p: Dict, x: torch.Tensor, x1: torch.Tensor, y: torch.Tensor,
               z: torch.Tensor, cfg: ModelConfig, tp=None) -> torch.Tensor:
    """The D x skip term, the silu(z) gate and the out projection."""
    y = (y + p["D"] * x1.float()).to(x.dtype)
    y = y * silu(z)
    if y.dim() == 3:
        y = constrain(y, "dp", None, "tp_ff",
                      full=(None, None, mamba_dims(cfg)[0]))
    out = y @ p["out_proj"]
    return out if tp is None else reduce_out(out, tp)


def _mamba_in(p: Dict, cfg: ModelConfig, x: torch.Tensor, tp=None):
    """x @ in_proj split into (x1, z) of this rank's channels."""
    di, _ = mamba_dims(cfg)
    if tp is None:
        return torch.split(x @ p["in_proj"], di, dim=-1)
    dl = p["conv_b"].shape[0]
    c0 = tp.start(dl)
    w = copy_to(p["in_proj"], tp)
    w = torch.cat([w[:, c0:c0 + dl], w[:, di + c0:di + c0 + dl]], dim=1)
    return torch.split(copy_to(x, tp) @ w, dl, dim=-1)


def mamba_forward(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                  return_state: bool = False, tp=None):
    """x: (B, S, d) -> (B, S, d) [, final state {"h": (B, dI, N) float32,
    "conv": the last dconv - 1 rows of the pre-conv x1}] (this rank's
    channels with ``tp``)."""
    di, _ = mamba_dims(cfg)
    x1_pre, z = _mamba_in(p, cfg, x, tp)
    x1_pre = constrain(x1_pre, "dp", None, "tp_ff", full=(None, None, di))
    x1 = silu(_mamba_conv_full(p, x1_pre))
    dt, a, bc, cc = _mamba_core(p, cfg, x1, tp)
    y, h = selective_scan(dt, a, x1, bc, cc, return_state=True)
    out = _mamba_out(p, x, x1, y, z, cfg, tp)
    if not return_state:
        return out
    dconv = p["conv_w"].shape[0]
    # a copy: a view would keep the whole (B, S, 2 dI) product alive
    conv = x1_pre[:, -(dconv - 1):].contiguous()
    return out, {"h": h, "conv": conv}


def mamba_init_state(cfg: ModelConfig, batch: int, device: torch.device,
                     dtype: torch.dtype = torch.float32) -> Dict:
    di, _ = mamba_dims(cfg)
    return {"h": torch.zeros((batch, di, cfg.mamba_d_state),
                             dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.mamba_d_conv - 1, di),
                                dtype=dtype, device=device)}


def mamba_step(p: Dict, cfg: ModelConfig, x: torch.Tensor,
               state: Dict, tp=None) -> Tuple[torch.Tensor, Dict]:
    """Single-token decode, x: (B, 1, d) -> (B, 1, d), new state.  Plain
    ops: one step of the recurrence launches no scan."""
    x1_pre, z = (t[:, 0] for t in _mamba_in(p, cfg, x, tp))   # (B, dI)
    window = torch.cat([state["conv"].to(x1_pre.dtype), x1_pre[:, None]],
                       dim=1)                                 # (B, dconv, dI)
    x1 = torch.einsum("bcd,cd->bd", window, p["conv_w"].to(x1_pre.dtype))
    x1 = silu(x1 + p["conv_b"].to(x1.dtype))[:, None]         # (B, 1, dI)
    dt, a, bc, cc = _mamba_core(p, cfg, x1, tp)
    decay = torch.exp(dt[:, 0, :, None] * a)                  # (B, dI, N)
    drive = (dt[:, 0] * x1[:, 0].float())[..., None] * bc[:, 0, None, :]
    h = decay * state["h"] + drive
    y = torch.einsum("bdn,bn->bd", h, cc[:, 0])
    out = _mamba_out(p, x, x1[:, 0], y, z, cfg, tp)[:, None]
    return out, {"h": h, "conv": window[:, 1:]}


# ======================================================================= mLSTM
def init_mlstm(gen, cfg: ModelConfig, device: torch.device) -> Dict:
    dt = DTYPES[cfg.param_dtype]
    d, h = cfg.d_model, cfg.n_heads
    hid = h * cfg.d_head
    f32 = torch.float32
    return {
        "wq": dense_init(gen, d, hid, dt, device),
        "wk": dense_init(gen, d, hid, dt, device),
        "wv": dense_init(gen, d, hid, dt, device),
        "w_gate": dense_init(gen, d, d, dt, device),
        "w_i": dense_init(gen, d, h, f32, device),
        "b_i": torch.zeros(h, dtype=f32, device=device),
        "w_f": dense_init(gen, d, h, f32, device),
        "b_f": torch.full((h,), 3.0, dtype=f32, device=device),  # open gates
        "w_out": dense_init(gen, hid, d, dt, device),
    }


def _mlstm_proj(p: Dict, cfg: ModelConfig, u: torch.Tensor, tp=None):
    """q, unscaled k, v (B, S, H, Dh) in u's dtype; the log input gate i and
    the forget gate f before its log-sigmoid, (B, S, H) float32 (the gate
    projections run in float32 when ``ssm_io_f32``).  With ``tp``, this
    rank's heads (the replicated gates cut to them)."""
    b, s, _ = u.shape
    dh = cfg.d_head
    uh = u if tp is None else copy_to(u, tp)
    q = (uh @ p["wq"]).reshape(b, s, -1, dh)
    k = (uh @ p["wk"]).reshape(b, s, -1, dh)
    v = (uh @ p["wv"]).reshape(b, s, -1, dh)
    gdt = torch.float32 if cfg.ssm_io_f32 else u.dtype
    ug = u.to(gdt)
    i = (ug @ p["w_i"].to(gdt)).float() + p["b_i"]
    f = (ug @ p["w_f"].to(gdt)).float() + p["b_f"]
    if tp is not None:
        hl = q.shape[2]
        i = copy_to(i, tp).narrow(-1, tp.start(hl), hl).contiguous()
        f = copy_to(f, tp).narrow(-1, tp.start(hl), hl).contiguous()
    return q, k, v, i, f


def _gate_out(p: Dict, u: torch.Tensor, h_out: torch.Tensor,
              tp=None, cols=None) -> torch.Tensor:
    """h (B, S, H, Dh) -> silu-gated, projected (B, S, d).  With ``tp``:
    h of this rank's heads, or (``cols``, weights whole) of its value
    columns ``cols`` of the flattened heads; the ranks' parts summed."""
    w_gate, w_out = p["w_gate"], p["w_out"]
    if cols is not None:
        w_gate, w_out = w_gate[:, cols], w_out[cols]
    elif tp is not None:
        u = copy_to(u, tp)
    gate = silu(u @ w_gate)
    out = (h_out.reshape(*u.shape[:2], -1) * gate) @ w_out
    return out if tp is None else reduce_out(out, tp)


def _value_state(state: Dict, cfg: ModelConfig, tp, heads: bool) -> Dict:
    """A final state placed as the cache holds it: ``C`` on this rank's
    value columns of every head, ``n`` and ``m`` whole; a state of this
    rank's ``heads`` is gathered first (collectives without gradient: the
    state leaves the step)."""
    if heads:
        state = {k: gather_dim(t, 1, tp) for k, t in state.items()}
    dv = cfg.d_head // tp.size
    return dict(state, C=state["C"][..., tp.start(dv):tp.start(dv) + dv
                                    ].contiguous())


def mlstm_forward(p: Dict, cfg: ModelConfig, u: torch.Tensor,
                  return_state: bool = False, tp=None):
    """Mixer body (u is already normed), u: (B, S, d).  S must be at most
    256 or a multiple of 256 (the reference's chunk contract).  With
    ``tp``: this rank's heads where ``wq`` holds its columns, else every
    head; the final state on this rank's value columns."""
    heads = tp is not None and p["wq"].shape[-1] < cfg.n_heads * cfg.d_head
    tp_h = tp if heads else None
    q, k, v, i, f = _mlstm_proj(p, cfg, u, tp_h)
    # the reference places v on its value dim (ssm.py:232); the port runs
    # its heads through the chunk kernel and moves the final state onto
    # the value dim once (_value_state)
    v = constrain(v, "dp", None, "tp_ff", None,
                  full=(None, None, cfg.n_heads, None))
    h_out, state = mlstm(q, k, v, i, f, chunk=CHUNK, return_state=True)
    out = _gate_out(p, u, h_out, tp_h)
    if not return_state:
        return out
    return out, (state if tp is None else
                 _value_state(state, cfg, tp, heads))


def mlstm_init_state(cfg: ModelConfig, batch: int,
                     device: torch.device) -> Dict:
    h, dh = cfg.n_heads, cfg.d_head
    f32 = torch.float32
    return {"C": torch.zeros((batch, h, dh, dh), dtype=f32, device=device),
            "n": torch.zeros((batch, h, dh), dtype=f32, device=device),
            "m": torch.full((batch, h), M_INIT, dtype=f32, device=device)}


def mlstm_step(p: Dict, cfg: ModelConfig, u: torch.Tensor,
               state: Dict, tp=None) -> Tuple[torch.Tensor, Dict]:
    """Single-token recurrence, u: (B, 1, d) -> (B, 1, d), new state.  With
    ``tp``, ``state["C"]`` holds this rank's value columns and the weights
    are whole (module docstring)."""
    q, k, v, i, f = _mlstm_proj(p, cfg, u)
    k = k / math.sqrt(cfg.d_head)
    dv = state["C"].shape[-1]
    cols = None
    if tp is not None:
        c0 = tp.start(dv)
        v = v[..., c0:c0 + dv]
        dh = cfg.d_head
        cols = torch.arange(cfg.n_heads, device=u.device)[:, None] * dh + \
            torch.arange(c0, c0 + dv, device=u.device)[None, :]
        cols = cols.reshape(-1)
    q0, k0, v0 = (t[:, 0].float() for t in (q, k, v))        # (B, H, Dh)
    i0, lf0 = i[:, 0], log_sigmoid(f[:, 0])                  # (B, H)
    m_new = torch.maximum(lf0 + state["m"], i0)
    fg = torch.exp(lf0 + state["m"] - m_new)
    ig = torch.exp(i0 - m_new)
    C = fg[:, :, None, None] * state["C"] + \
        ig[:, :, None, None] * (k0[..., :, None] * v0[..., None, :])
    n = fg[:, :, None] * state["n"] + ig[:, :, None] * k0
    num = torch.einsum("bhd,bhde->bhe", q0, C)
    den = torch.einsum("bhd,bhd->bh", q0, n)
    h_out = (num / torch.clamp_min(den.abs(), 1.0)[..., None]).to(u.dtype)
    return _gate_out(p, u, h_out, tp, cols), {"C": C, "n": n, "m": m_new}


# ======================================================================= sLSTM
def init_slstm(gen, cfg: ModelConfig, device: torch.device) -> Dict:
    dt = DTYPES[cfg.param_dtype]
    d, h, dh = cfg.d_model, cfg.n_heads, cfg.d_head
    hid = h * dh
    f32 = torch.float32
    w = torch.randn(d, 4 * hid, generator=gen, dtype=f32,
                    device=device) / math.sqrt(d)
    r = torch.randn(4, h, dh, dh, generator=gen, dtype=f32,
                    device=device) / math.sqrt(dh)
    b = torch.zeros(4 * hid, dtype=f32, device=device)
    b[2 * hid:3 * hid] = 3.0                                 # forget gates
    return {"w": w, "r": r, "b": b,
            "w_out": dense_init(gen, hid, d, dt, device)}


def _slstm_cell(p: Dict, cfg: ModelConfig, xw_t: torch.Tensor,
                carry: Tuple[torch.Tensor, ...]) -> Tuple[torch.Tensor, ...]:
    """One timestep.  xw_t: (B, 4 * hid) float32 input projection; carry
    (h, c, n, m), each (B, H, Dh) float32."""
    h_, c_, n_, m_ = carry
    hh, dh = cfg.n_heads, cfg.d_head
    rec = torch.einsum("bhd,ghde->bghe", h_, p["r"])         # (B, 4, H, Dh)
    pre = xw_t.reshape(-1, 4, hh, dh) + rec + p["b"].reshape(4, hh, dh)
    z = torch.tanh(pre[:, 0])
    o = torch.sigmoid(pre[:, 3])
    lf = log_sigmoid(pre[:, 2])
    pi = pre[:, 1]
    m_new = torch.maximum(lf + m_, pi)
    ig = torch.exp(pi - m_new)
    fg = torch.exp(lf + m_ - m_new)
    c_new = fg * c_ + ig * z
    n_new = fg * n_ + ig
    h_new = o * c_new / torch.clamp_min(n_new, 1.0)
    return h_new, c_new, n_new, m_new


def slstm_forward(p: Dict, cfg: ModelConfig, u: torch.Tensor,
                  return_state: bool = False):
    """u: (B, S, d); a strictly sequential loop over time (one cell per
    token, each a handful of small kernels: no kernel fuses it)."""
    b, s, _ = u.shape
    state = slstm_init_state(cfg, b, u.device)
    xdt = torch.float32 if cfg.ssm_io_f32 else u.dtype
    xw = u.to(xdt) @ p["w"].to(xdt)                          # (B, S, 4 hid)
    carry = (state["h"], state["c"], state["n"], state["m"])
    hs = []
    for t in range(s):
        carry = _slstm_cell(p, cfg, xw[:, t].float(), carry)
        hs.append(carry[0])
    h_seq = torch.stack(hs, dim=1).reshape(b, s, -1).to(u.dtype)
    out = h_seq @ p["w_out"]
    if return_state:
        return out, dict(zip(("h", "c", "n", "m"), carry))
    return out


def slstm_init_state(cfg: ModelConfig, batch: int,
                     device: torch.device) -> Dict:
    shape = (batch, cfg.n_heads, cfg.d_head)
    f32 = torch.float32
    return {"h": torch.zeros(shape, dtype=f32, device=device),
            "c": torch.zeros(shape, dtype=f32, device=device),
            "n": torch.zeros(shape, dtype=f32, device=device),
            "m": torch.full(shape, M_INIT, dtype=f32, device=device)}


def slstm_step(p: Dict, cfg: ModelConfig, u: torch.Tensor,
               state: Dict) -> Tuple[torch.Tensor, Dict]:
    """u: (B, 1, d) -> (B, 1, d), new state."""
    xw = u[:, 0].float() @ p["w"].float()
    carry = _slstm_cell(p, cfg, xw,
                        (state["h"], state["c"], state["n"], state["m"]))
    out = (carry[0].reshape(u.shape[0], -1).to(u.dtype) @ p["w_out"])[:, None]
    return out, dict(zip(("h", "c", "n", "m"), carry))
