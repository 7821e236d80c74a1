"""The simulator's float32 stage recipe over a ``(jobs,)`` batch, scanned
over a fleet step's stages or over whole runs.

``sim_stages`` is the entry the vectorized engine
(``repro_torch.sim.engine.BatchedClusterSim``) calls, once per fleet step
and once per whole run.  On CUDA tensors it launches the hand-written
kernel ``csrc/sim_step.cu`` (one thread per job; built with ``nvcc`` at
first use) or raises; it never falls back.  On CPU tensors it runs
:func:`sim_stages_plain`, the same recipe in plain PyTorch ops, which is
also what the kernel is held against on the card.

Counterpart of ``repro.sim.engine._make_body`` scanned by
``_step_kernel_impl`` (stepped mode) and ``_run_stages`` (whole-run
mode): a ``lax.scan`` under ``jax.jit``, no Pallas kernel.  Both modes run
one stage function, so their bit parity with the per-job simulator
(``repro_torch.dataflow.simulator.ClusterSim``) is one property.  Every
product and sum is rounded on its own, in the reference's order: the plain
version uses no fused op (``addcmul``, ``lerp``, an ``alpha`` other than
1) and divides by a tensor (CUDA turns a division by a Python scalar into
a product with its reciprocal), and the kernel writes every product that
feeds a sum as ``__fmul_rn`` so ``nvcc`` contracts nothing into an FMA.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.sim.tables import EXEC_MAX, MAX_FAIL_WINDOWS, W_MAX

SOURCE = Path(__file__).resolve().parent / "csrc" / "sim_step.cu"

# packed per-stage input layout (last axis of a run block): noise | rt | sq
# | slow | cpu0 | shuffle0 | io0 | straggler | overhead
N_TAB = EXEC_MAX + 1
F_NOISE = slice(0, 4)
F_RT = slice(4, 4 + N_TAB)
F_SQ = slice(4 + N_TAB, 4 + 2 * N_TAB)
F_SLOW = slice(4 + 2 * N_TAB, 4 + 3 * N_TAB)
F_TAB = slice(4, 4 + 3 * N_TAB)     # rt | sq | slow as packed per slot
F_CPU0, F_SHUF0, F_IO0, F_STRAG, F_OV = 115, 116, 117, 118, 119
NF = 120

# packed per-stage output layout (last axis): clock_before | runtime |
# metrics(5) | failed | fail_when(8) | fail_hit(8)
O_CLK, O_RT = 0, 1
O_MET = slice(2, 7)
O_FAILED = 7
O_WHEN = slice(8, 8 + MAX_FAIL_WINDOWS)
O_HIT = slice(8 + MAX_FAIL_WINDOWS, 8 + 2 * MAX_FAIL_WINDOWS)
NO = 8 + 2 * MAX_FAIL_WINDOWS

# stepped-mode control row, one per job: clock | interf | a | z | inject |
# n_stages | overhead | cursor (integer columns are exact in float32)
N_CTRL = 8

# kernel launches since import (or since the caller last reset them)
LAUNCHES = 0

_FN = None


class SimConsts(NamedTuple):
    """The per-fleet arrays the stage recipe closes over."""
    kill_row: torch.Tensor      # (J, W_MAX) f32, this run's kill seconds
    burst: torch.Tensor         # (J, W_MAX) f32
    preempt: torch.Tensor       # (J, W_MAX) int32
    iscale2: torch.Tensor       # (J,) f32, 2 * interference_scale
    mem_tab: torch.Tensor       # (37,) f32
    shuf_tab: torch.Tensor      # (37,) f32


def unpack(buf, n_jobs: int, s_len: int):
    """``(state (J, 2), outs (S, J, NO))`` views of one packed output
    buffer (a tensor or a numpy array)."""
    state = buf[:2 * n_jobs].reshape(n_jobs, 2)
    return state, buf[2 * n_jobs:].reshape(s_len, n_jobs, NO)


def _stage_plain(clock, interf_prev, f, z, inject, val, ov, c: SimConsts):
    """One stage of every job: ``f`` (J, NF) its packed inputs, ``z``,
    ``inject`` (J,) int32, ``val`` (J,) bool, ``ov`` (J,) f32.  Returns the
    next carry and the (J, NO) output row."""
    n0, n1, n2, n3 = f[:, 0], f[:, 1], f[:, 2], f[:, 3]
    c90 = torch.full_like(clock, 90.0)
    w0 = torch.floor(clock / c90).to(torch.int32)
    wi0 = w0.clamp(0, W_MAX - 1).long()[:, None]
    burst_w = c.burst.gather(1, wi0)[:, 0]
    innov = n0.abs() * (c.iscale2 * burst_w)
    interf = (interf_prev * 0.85) + (innov * 0.15)
    interf = interf.clamp(0.0, 0.45)
    loc = 1.0 + ((n1 * 0.04) + 0.02).clamp(min=0.0)
    loss = c.preempt.gather(1, wi0)[:, 0]
    z_eff = (z - loss).clamp(min=1).long()
    zi = z_eff[:, None]
    base = f[:, F_RT].gather(1, zi)[:, 0]
    sqb = f[:, F_SQ].gather(1, zi)[:, 0]
    slow = f[:, F_SLOW].gather(1, zi)[:, 0]
    t = ((base * (1.0 + interf)) * loc) + (n2 * (sqb * 0.15))
    t = t.clamp(min=0.2)
    t = t * f[:, F_STRAG]
    t0 = t
    end0 = clock + t0
    fail_ok = (inject > 0) & (z > 4) & val
    w_hi = torch.minimum(torch.floor(end0 / c90).to(torch.int32),
                         w0 + (MAX_FAIL_WINDOWS - 1))
    failed = torch.zeros_like(w0)
    whens, hits = [], []
    for k in range(MAX_FAIL_WINDOWS):
        w = w0 + k
        when = c.kill_row.gather(1, w.clamp(0, W_MAX - 1).long()[:, None])[:, 0]
        hit = fail_ok & (w <= w_hi) & (when >= clock) & (when < end0)
        frac = t.clamp(max=25.0) / t.clamp(min=1e-6)
        t_new = ((t * (1.0 - frac)) + ((t * frac) * slow)) + 18.0
        t = torch.where(hit, t_new, t)
        failed = failed + hit.to(torch.int32)
        whens.append(when)
        hits.append(hit)
    runtime = t + ov
    mem = c.mem_tab[z_eff]
    any_fail = failed > 0
    gc = (mem * 0.05) + 0.04
    gc = torch.where(any_fail, gc + 0.05, gc)
    spill = (mem - 1.4).clamp(min=0.0) * 0.3
    cpu = (f[:, F_CPU0] * (1.0 - interf)) + (n3 * 0.02)
    cpu = cpu.clamp(0.0, 1.0)
    shuffle = f[:, F_SHUF0] * c.shuf_tab[z_eff]
    io = torch.where(any_fail, f[:, F_IO0] * 1.3, f[:, F_IO0])
    out = torch.cat([clock[:, None], runtime[:, None],
                     torch.stack([cpu, shuffle, io, gc, spill], dim=-1),
                     failed[:, None].float(), torch.stack(whens, -1),
                     torch.stack(hits, -1).float()], dim=-1)
    return (torch.where(val, clock + runtime, clock),
            torch.where(val, interf, interf_prev), out)


def sim_stages_plain(block: torch.Tensor, consts: SimConsts, *,
                     ctrl: Optional[torch.Tensor] = None, s_len: int = 0,
                     state: Optional[torch.Tensor] = None,
                     ipack: Optional[torch.Tensor] = None,
                     valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`sim_stages` in plain PyTorch ops (same arguments)."""
    t_max, n_jobs = block.shape[:2]
    jobs = torch.arange(n_jobs, device=block.device)
    if ctrl is not None:
        clock, interf = ctrl[:, 0], ctrl[:, 1]
        z, inject = ctrl[:, 3].to(torch.int32), ctrl[:, 4].to(torch.int32)
        n = ctrl[:, 5].to(torch.int32)
        cursor = ctrl[:, 7].to(torch.int64)
        zero = torch.zeros_like(clock)
        steps = s_len
    else:
        clock, interf = state[:, 0], state[:, 1]
        steps = t_max
    outs = []
    for s in range(steps):
        if ctrl is not None:
            f = block[(cursor + s).clamp(0, t_max - 1), jobs]
            ov = ctrl[:, 6] if s == 0 else zero
            clock, interf, out = _stage_plain(clock, interf, f, z, inject,
                                              s < n, ov, consts)
        else:
            f = block[s]
            clock, interf, out = _stage_plain(
                clock, interf, f, ipack[s, :, 0], ipack[s, :, 1], valid[s],
                f[:, F_OV], consts)
        outs.append(out)
    return torch.cat([torch.stack([clock, interf], -1).reshape(-1),
                      torch.stack(outs).reshape(-1)])


def _check(block, consts: SimConsts, ctrl, s_len, state, ipack, valid
           ) -> None:
    if block.dim() != 3 or block.shape[2] != NF or min(block.shape) < 1:
        raise ValueError(f"block must be (T, J, {NF}) with T, J >= 1, got "
                         f"{tuple(block.shape)}")
    n_jobs = block.shape[1]
    shapes = {"kill_row": (n_jobs, W_MAX), "burst": (n_jobs, W_MAX),
              "preempt": (n_jobs, W_MAX), "iscale2": (n_jobs,),
              "mem_tab": (N_TAB,), "shuf_tab": (N_TAB,)}
    tensors = [("block", block)] + list(zip(SimConsts._fields, consts))
    if (ctrl is None) == (state is None):
        raise ValueError("pass ctrl (stepped mode) or state (whole-run "
                         "mode), not both")
    if ctrl is not None:
        shapes["ctrl"] = (n_jobs, N_CTRL)
        tensors.append(("ctrl", ctrl))
        if s_len < 1:
            raise ValueError(f"s_len must be >= 1, got {s_len}")
    else:
        shapes.update(state=(n_jobs, 2), ipack=(block.shape[0], n_jobs, 2),
                      valid=tuple(block.shape[:2]))
        tensors += [("state", state), ("ipack", ipack), ("valid", valid)]
    dtypes = {"preempt": torch.int32, "ipack": torch.int32,
              "valid": torch.bool}
    for nm, t in tensors:
        if nm in shapes and tuple(t.shape) != shapes[nm]:
            raise ValueError(f"{nm} must be {shapes[nm]}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != dtypes.get(nm, torch.float32):
            raise TypeError(f"{nm} must be {dtypes.get(nm, torch.float32)}, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{nm} must be contiguous")
    devices = {t.device for _, t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: "
                         f"{sorted(str(v) for v in devices)}")


def _kernel_fn():
    global _FN
    if _FN is None:
        fn = build.load(SOURCE).sim_stages
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _launch(block, consts: SimConsts, ctrl, s_len, state, ipack, valid,
            out) -> None:
    """One launch of ``sim_stages`` on checked CUDA tensors."""
    global LAUNCHES
    t_max, n_jobs = block.shape[:2]
    fn = _kernel_fn()
    ptr = lambda t: None if t is None else t.data_ptr()
    stepped = ctrl is not None
    stream = torch.cuda.current_stream(block.device).cuda_stream
    rc = fn(block.data_ptr(), ptr(ctrl), ptr(state), ptr(ipack), ptr(valid),
            *(t.data_ptr() for t in consts), out.data_ptr(), t_max, n_jobs,
            s_len if stepped else t_max, 0 if stepped else 1, stream)
    if rc != 0:
        raise RuntimeError(f"sim_stages launch failed: cudaError {rc}")
    LAUNCHES += 1


def sim_stages(block: torch.Tensor, consts: SimConsts, *,
               ctrl: Optional[torch.Tensor] = None, s_len: int = 0,
               state: Optional[torch.Tensor] = None,
               ipack: Optional[torch.Tensor] = None,
               valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scan the stage recipe over a fleet; returns one packed float32
    buffer, ``(state (J, 2), outs (S, J, NO))`` by :func:`unpack`.

    Stepped mode (``ctrl`` (J, 8), ``s_len`` = S): ``block`` is the run
    block (T, J, NF) of every stage of the current run, and job j runs
    the ``ctrl[j, 5]`` stages at its cursor ``ctrl[j, 7]`` (rows past them
    are computed and leave the carry alone), the first one with the
    overhead ``ctrl[j, 6]``.  Whole-run mode (``state`` (J, 2) the start
    carry, ``ipack`` (T, J, 2) int32 z | inject, ``valid`` (T, J) bool):
    ``block`` holds every stage's inputs, overhead included, and S = T.

    CPU tensors run :func:`sim_stages_plain`; CUDA tensors launch the
    kernel."""
    _check(block, consts, ctrl, s_len, state, ipack, valid)
    kw = dict(ctrl=ctrl, s_len=s_len, state=state, ipack=ipack, valid=valid)
    if block.device.type == "cpu":
        return sim_stages_plain(block, consts, **kw)
    if block.device.type != "cuda":
        raise ValueError(f"sim_stages runs on cpu or cuda, not "
                         f"{block.device}")
    n_jobs = block.shape[1]
    steps = s_len if ctrl is not None else block.shape[0]
    out = torch.empty(2 * n_jobs + steps * n_jobs * NO, dtype=torch.float32,
                      device=block.device)
    _launch(block, consts, ctrl, s_len, state, ipack, valid, out)
    return out
