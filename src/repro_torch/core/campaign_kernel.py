"""Whole campaign on the device: sim step + decision sweep + resident fit
in ONE step body, enqueued for every step of a campaign without a host
synchronisation (PyTorch port of ``repro.core.campaign_kernel``).

The live fleet path (``FleetCampaign.adaptive_campaign``) interleaves host
Python between every device call: one sim-step launch per component round,
one sweep per decision round, one fit per run, plus host graph building,
ring appends and bookkeeping in between, each ending in a copy to the host.
This module runs the ENTIRE campaign (R runs x C components of J
concurrent jobs) as one step body per component step whose every input is
on the device:

* step ``t`` maps to (run ``t // C``, component ``t % C``);
* (a) one ``sim_step`` launch (:func:`repro_torch.kernels.sim_step.ops.
  sim_stages` in stepped mode) against pre-drawn per-run input blocks
  (:meth:`BatchedClusterSim.campaign_run_blocks` consumes the SAME host
  rng stream as the stepped path, so the noise / straggler / kill draws
  are bit-identical), its control row built on the device from the carry;
* (b) the observed component's ring row is built on the device from frozen
  context tables and written into the resident training ring at each job's
  ``pos`` (:func:`~repro_torch.core.graph.ring_append` semantics);
* (c) on decision boundaries, the bucketed candidate sweep and on-device
  compliant pick run through the service's job-axis sweep
  (:func:`~repro_torch.core.service._fleet_eval`, the sparse engine in
  plain ops), with the :func:`~repro_torch.core.fallback.fallback_pick`
  guardrail and the non-finite clamp folded in;
* (d) at each run boundary, the paper's retrain cadence runs K resident
  Adam steps per job (scratch reinit every ``retrain_every``-th run,
  fine-tune otherwise), each through both ``graph_prop`` kernels on a
  card, and ``nan_fit`` chaos poisons params in place.

Where the reference branches under ``lax.cond`` on plan tables, this port
branches in Python on the plan's host copies (``any_decide[k]``, the last
component, ``scratch_at[r]``, ``poison_at[r]``): nothing in the step body
reads a device value on the host.  :func:`run_fused` enqueues steps
``[start, stop)`` and copies their stacked outputs to the host once, at
the end; :func:`run_stepped` drives the same step body and copies each
step's outputs (the reference's loop of jit calls).  ``run_fused ==
run_stepped`` is bit-exact.

Documented deviations from the LIVE host path (``adaptive_campaign``),
as in the reference: the fused campaign is a faithful but not
bit-identical twin:

* node contexts are FROZEN at plan time (``frozen_context_tables``:
  ``drop_versions=False``, ``attempt=0``); the live encoder consumes rng
  per observation for software-version dropout and bumps the attempt
  counter on failures;
* the candidate grid is the fixed ``range(lo, hi+1, stride) | {hi}``;
  the live grid also splices in the current scale-out when off-stride;
* historical H-summary tables are frozen at plan time; the live
  ``hist_summaries`` grow intra-campaign, so live H nodes drift as runs
  accumulate;
* P-summary context/metrics are float32 device means (live: numpy means
  cast to float32; identical op order for <= 5 stages, but not
  guaranteed bitwise);
* the per-run fit fires at the LAST component index of the longest job
  for every job, and fine-tune batches are padded to one uniform
  ``pow2_bucket(c_max)`` row count (live: per-job ``pow2_bucket(n_j)``,
  which changes the per-step dropout mask shapes for shorter jobs);
* only ``nan_fit`` chaos is supported in the step body
  (``nan_graphs_every`` / ``cache_corrupt_every`` mutate host caches
  mid-run); the service-layer retry/breaker/shed envelope does not exist
  here: the guardrail is the isfinite reduce and the fallback clamp.

Two more, of this port: a fit's metric dropout draws from a
``torch.Generator`` seeded with ``_dropout_seed(seed, f)`` at the job's
``f``-th fit (a host count, so run_fused, run_stepped and a resumed
campaign draw the same masks; the reference folds ``f`` into a
``jax.random`` key, whose bits no torch generator gives), and a fit is
one Adam run per job (the reference vmaps the jobs' runs into one).

None of these affect the fused == stepped contract, which shares every
table and every op; ``tests/test_torch_campaign.py`` also grounds the fused
sim against ``BatchedClusterSim.run_full`` by replaying the fused
z-schedule (bit-exact stage runtimes and clocks).
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core.fallback import fallback_pick
from repro_torch.core.graph import (CAND_LADDER, COMP_LADDER, CTX_DIM,
                                    EDGE_LADDER, LEVEL_LADDER, N_METRICS,
                                    historical_summaries_batch, ladder_bucket,
                                    pow2_bucket, propagation_depth,
                                    ring_append)
from repro_torch.core.model import record_trace
from repro_torch.core.service import _fleet_eval
from repro_torch.core.training import (_adam_run_resident_device,
                                       _dropout_seed, _round_steps,
                                       map_params, param_leaves)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.sim_step import ops as sim_ops

# engine <-> dataflow import cycle: load the dataflow package first, so the
# engine's simulator import finds it loaded (the order the fleet entry
# points use)
import repro_torch.dataflow  # noqa: F401,E402  (import order only)
from repro_torch.sim.engine import BatchedClusterSim  # noqa: E402

N_ROW = 8          # ring-row / sweep node slots (stages + P + H, bucketed)


class PlanStatic(NamedTuple):
    """Hashable static shape of one fused campaign.

    ``record_trace("fused_campaign")`` counts each distinct PlanStatic
    once, as the reference counts its compiles: bounded by the
    bucket-ladder rungs these fields can take, not by runs or jobs.
    """
    c_max: int           # component steps per run (longest job)
    s_max: int           # stage rows per component step (engine S)
    lo: int              # scale-out grid origin (SCALEOUT_RANGE[0])
    tune_rows: int       # fine-tune batch rows: pow2_bucket(c_max)
    scratch_steps: int   # _round_steps(steps)
    tune_steps: int      # _round_steps(fine_tune_steps)
    retrain_every: int
    levels: int          # bucketed propagation depth for the sweep
    telemetry: bool = False  # the obs block; False gives the same carry
    #                          and ys without the tel entries, bit-equal


class CampaignPlan:
    """Everything one fused campaign needs: static shapes, device tables,
    the initial carry (device tensors) and the host tables (the branches
    of the step body and the materialization)."""

    def __init__(self, static: PlanStatic, dev: Dict[str, Any],
                 init: Dict[str, Any], host: Dict[str, Any]):
        self.static = static
        self.dev = dev
        self.init = init
        self.host = host

    @property
    def device(self) -> torch.device:
        return self.dev["inject"].device

    @property
    def n_jobs(self) -> int:
        return int(self.dev["inject"].shape[0])

    @property
    def n_runs(self) -> int:
        return int(self.dev["blocks"].shape[0])

    @property
    def n_steps(self) -> int:
        return self.n_runs * self.static.c_max


# =========================================================================
# the step body: ONE component step of the whole fleet
# =========================================================================

def _where0(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``x`` where ``mask`` (broadcast over x's trailing axis), else 0."""
    return torch.where(mask[..., None], x, torch.zeros_like(x))


def _grid_index(plan: CampaignPlan, s: torch.Tensor) -> torch.Tensor:
    """Index of scale-outs ``s`` on the frozen tables' scale-out grid."""
    return torch.clamp(s.long() - plan.static.lo, 0,
                       plan.dev["obs_ctx"].shape[3] - 1)


def _sim_step(plan: CampaignPlan, carry, r: int, k: int):
    """(a): the fleet's sim step.  Returns (a, z, clock, interf, ov, outs)
    with outs (S, J, NO)."""
    dev = plan.dev
    if k == 0:                       # a run starts: clock 0 at s0
        clock = torch.zeros_like(carry["clock"])
        a = z = dev["s0"]
    else:
        clock, a, z = carry["clock"], carry["s_prev"], carry["s_cur"]
    # the engine's overhead_f32 (4 + 0.35 * |z - a|), every op rounded on
    # its own
    d = torch.abs(z - a)
    ov = torch.where(a == z, torch.zeros_like(d), (d * 0.35) + 4.0)
    ctrl = torch.stack([clock, carry["interf"], a, z, dev["inject"],
                        dev["n_stage_f"][k], ov, dev["cursor_f"][k]], -1)
    consts = sim_ops.SimConsts(dev["kills"][r], dev["burst"], dev["preempt"],
                               dev["iscale2"], dev["mem_tab"],
                               dev["shuf_tab"])
    buf = sim_ops.sim_stages(dev["blocks"][r], consts, ctrl=ctrl,
                             s_len=plan.static.s_max)
    state, outs = sim_ops.unpack(buf, plan.n_jobs, plan.static.s_max)
    return a, z, state[:, 0], state[:, 1], ov, outs


def _observe(plan: CampaignPlan, carry, k: int, a, z, ov, outs):
    """(b): the observed component's ring row, appended at each job's
    ``pos``, and the fresh P(k) summary.  Returns (ring, p_met, p_a,
    p_z)."""
    st, dev = plan.static, plan.dev
    ji = dev["ji"]
    zi = lambda s: _grid_index(plan, s)
    g, h = dev["cls"], dev["hcls"]
    ok = dev["comp_valid"][k]                           # (J,)
    rmask = dev["row_mask"][g, k]                       # (J, N_ROW)
    rsum = dev["row_summ"][g, k]
    radj = dev["row_adj"][g, k]                         # (J, N_ROW, N_ROW)
    rsi = dev["row_stage_idx"][g, k]                    # (J, N_ROW) int64
    rst = dev["row_is_stage"][g, k]
    rs0 = rst & (rsi == 0)
    rp = dev["row_is_p"][g, k]
    rh = dev["row_is_h"][g, k]

    pm, pa, pz = carry["p_met"], carry["p_a"], carry["p_z"]
    zz = zi(z)
    ctx_kz = dev["obs_ctx"][g, k][ji[:, None], rsi, zz[:, None]]
    p_ctx_old = dev["p_ctx"][g, max(k - 1, 0), zi(pz)]  # (J, CTX)
    h_ctx = dev["hob_ctx"][h, k, zz]                    # (J, CTX)
    h_met = dev["hob_met"][h, k, zz]                    # (J, N_METRICS)
    h_val = dev["hob_val"][h, k, zz]                    # (J,)
    h_a = dev["hob_start"][h, k, zz]
    h_b = dev["hob_end"][h, k, zz]

    met_js = outs[:, :, sim_ops.O_MET].transpose(0, 1)  # (J, S, 5)
    rt_js = outs[:, :, sim_ops.O_RT].transpose(0, 1)    # (J, S)
    row_met = met_js[ji[:, None], rsi]                  # (J, N_ROW, 5)
    row_rt = rt_js[ji[:, None], rsi]                    # (J, N_ROW)

    a2, z2 = a[:, None], z[:, None]
    rescale0 = rs0 & (a2 != z2)
    one = torch.ones_like(row_rt)
    zero = torch.zeros_like(row_rt)
    row = {
        "context": (_where0(rst, ctx_kz)
                    + _where0(rp, p_ctx_old[:, None, :].expand_as(ctx_kz))
                    + _where0(rh, h_ctx[:, None, :].expand_as(ctx_kz))),
        "metrics": (_where0(rst, row_met)
                    + _where0(rp, pm[:, None, :].expand_as(row_met))
                    + _where0(rh, h_met[:, None, :].expand_as(row_met))),
        "metrics_valid": rst | rp | (rh & h_val[:, None]),
        "a_raw": torch.where(rs0, a2, torch.where(rst, z2, torch.where(
            rp, pa[:, None], torch.where(rh, h_a[:, None], one)))),
        "z_raw": torch.where(rst, z2, torch.where(
            rp, pz[:, None], torch.where(rh, h_b[:, None], one))),
        "r": torch.where(rescale0, one * 0.8, one),
        "runtime": torch.where(rst, row_rt, zero),
        "runtime_valid": rst,
        "overhead": torch.where(rescale0, ov[:, None].expand_as(zero), zero),
        "overhead_valid": rescale0,
        "adj": radj,
        "mask": rmask,
        "is_summary": rsum,
    }

    ring = carry["ring"]
    pos = ring["pos"]
    cap = ring["slot_ok"].shape[1]
    at = (ji, pos)                          # each job's next slot
    ring_append(ring["buffers"], {
        key: torch.where(ok.reshape((-1,) + (1,) * (buf.dim() - 2)),
                         row[key].to(buf.dtype), buf[at])
        for key, buf in ring["buffers"].items()}, at)
    slot_ok = ring["slot_ok"]
    slot_ok[at] = slot_ok[at] | ok
    inc = ok.long()
    ring = {"buffers": ring["buffers"], "pos": (pos + inc) % cap,
            "count": torch.clamp(ring["count"] + inc, max=cap),
            "slot_ok": slot_ok}

    # the fresh P(k) summary (current_summary for this boundary's decision):
    # the stages' metric mean, summed in stage order
    nst = dev["n_stage_i"][k]                           # (J,) int64
    acc = torch.zeros_like(pm)
    for s in range(st.s_max):
        acc = acc + _where0(nst > s, met_js[:, s])
    pm_new = acc / torch.clamp(nst, min=1)[:, None].float()
    pm = torch.where(ok[:, None], pm_new, pm)
    pa = torch.where(ok, a, pa)
    pz = torch.where(ok, z, pz)
    return ring, pm, pa, pz


def _decide(plan: CampaignPlan, params, k: int, s_cur, clock, pm, pa, pz):
    """(c): every job's candidate sweep through the service's job-axis
    sweep, the fallback guardrail for non-finite rows.  Returns (s_new,
    dec_ok)."""
    st, dev = plan.static, plan.dev
    ji = dev["ji"]
    zi = lambda s: _grid_index(plan, s)
    g, h = dev["cls"], dev["hcls"]
    J = plan.n_jobs
    cand, cand_valid = dev["cand"], dev["cand_valid"]
    n_cand = cand.shape[0]
    stg = dev["sw_is_stage"][g]                         # (J, K, N)
    sidx = dev["sw_stage_idx"][g]
    isp = dev["sw_is_p"][g]
    ish = dev["sw_is_h"][g]
    comp_of = dev["sw_comp"]                            # (K,) = ki + 1
    vk = (comp_of > k)[None, :] & (comp_of[None, :] < dev["n_comp"][:, None])
    isn = comp_of == (k + 1)                            # (K,)
    mask = dev["sw_mask0"][g] & vk[..., None] & (~isp | isn[None, :, None])
    ctx_z = dev["obs_ctx"][g, :, :, zi(s_cur)]          # (J, C_max, S, CTX)
    cc = torch.clamp(comp_of, 0, dev["obs_ctx"].shape[1] - 1)
    ctx_st = ctx_z[ji[:, None, None], cc[None, :, None], sidx]
    pctx = dev["p_ctx"][g, k, zi(pz)]                   # (J, CTX)
    base = {
        "context": (_where0(stg, ctx_st)
                    + _where0(isp, pctx[:, None, None, :].expand_as(ctx_st))),
        "metrics": _where0(isp, pm[:, None, None, :].expand(
            tuple(isp.shape) + (N_METRICS,))),
        "adj": dev["sw_adj"][g],
        "mask": mask,
        "is_summary": dev["sw_summ"][g],
    }
    k_pad = stg.shape[1]
    zsel = cand[None, :, None].expand(J, n_cand, k_pad)
    asel = torch.where(isn[None, None, :], s_cur[:, None, None], zsel)
    st0 = stg & (sidx == 0)
    a3, z3 = asel[..., None], zsel[..., None]           # (J, C, K, 1)
    h_a3 = dev["hsw_start"][h][..., None]               # (J, C, K, 1)
    h_b3 = dev["hsw_end"][h][..., None]
    hv3 = dev["hsw_val"][h][..., None]
    one = torch.ones((), dtype=torch.float32, device=cand.device)
    pa4, pz4 = pa[:, None, None, None], pz[:, None, None, None]
    stg4, isp4, ish4 = stg[:, None], isp[:, None], ish[:, None]
    deltas = {
        "a_raw": torch.where(st0[:, None], a3, torch.where(
            stg4, z3, torch.where(isp4, pa4, torch.where(ish4, h_a3, one)))),
        "z_raw": torch.where(stg4, z3, torch.where(
            isp4, pz4, torch.where(ish4, h_b3, one))),
        "r": torch.where(stg4 & (a3 != z3), one * 0.8, one),
        "metrics_valid": (isp4 | (ish4 & hv3)) & mask[:, None],
        "h_context": dev["hsw_ctx"][h],                 # (J, C, K, CTX)
        "h_metrics": dev["hsw_met"][h],
    }
    ed = dev["sw_edge_dst"][g]                          # (J, K, E) int64
    es = dev["sw_edge_src"][g]
    ev = (dev["sw_edge_val"][g] & torch.gather(mask, 2, ed)
          & torch.gather(mask, 2, es))
    cand_j = cand[None].expand(J, n_cand)
    valid_j = cand_valid[None].expand(J, n_cand)
    idx, totals, _, ok = _fleet_eval(
        params, base, dev["sw_oh"][g], deltas, ed, es, ev, cand_j, valid_j,
        clock, dev["target"], st.levels)
    fb = fallback_pick(cand_j, valid_j, totals, s_cur, clock, dev["target"])
    return cand[torch.where(ok, idx, fb.long())], ok


def _fit(plan: CampaignPlan, carry, ring, r: int):
    """(d): one Adam run per job on its ring, in place on the carry's
    params and moments.  Returns (last losses, skipped steps), (J,)."""
    st, dev, host = plan.static, plan.dev, plan.host
    params, (mu, nu, t_adam) = carry["params"], carry["opt"]
    buffers, pos, count = ring["buffers"], ring["pos"], ring["count"]
    slot_ok = ring["slot_ok"]
    ji = dev["ji"]
    cap = slot_ok.shape[1]
    if host["scratch_at"][r]:
        for p, p0 in zip(param_leaves(params),
                         param_leaves(dev["init_params"])):
            p.copy_(p0)
        for m in param_leaves(mu) + param_leaves(nu) + [t_adam]:
            m.zero_()
        weights = ((dev["slots"][None, :] < count[:, None])
                   & slot_ok).float()
        batch, steps = buffers, st.scratch_steps
    else:
        rows = dev["tune_rows"][None, :]
        live = rows < dev["n_comp"][:, None]
        idx = (pos[:, None] - dev["n_comp"][:, None] + rows) % cap
        idx = torch.where(live, idx, torch.zeros_like(idx))
        batch = {key: b[ji[:, None], idx] for key, b in buffers.items()}
        weights = (live & slot_ok[ji[:, None], idx]).float()
        steps = st.tune_steps
    losses, skipped = [], []
    for j in range(plan.n_jobs):
        job = lambda x: x[j]
        gen = torch.Generator(device=plan.device).manual_seed(
            _dropout_seed(host["seeds"][j], int(host["fit_calls0"][j]) + r))
        _, last, skip = _adam_run_resident_device(
            map_params(job, params),
            (map_params(job, mu), map_params(job, nu), t_adam[j]),
            {key: b[j] for key, b in batch.items()}, weights[j], gen,
            host["lr"][j], host["dropout_p"], steps)
        losses.append(last)
        skipped.append(skip)
    return torch.stack(losses), torch.stack(skipped)


def _step(plan: CampaignPlan, carry, t: int):
    """(carry, t) -> (carry', ys): component ``t % c_max`` of run
    ``t // c_max`` for every job: sim step, ring append, decision sweep (on
    decision boundaries) and the per-run fit (on run boundaries), every
    operand on the device.  Updates the carry's ring, params and moments
    in place."""
    st, dev, host = plan.static, plan.dev, plan.host
    r, k = divmod(t, st.c_max)
    a, z, clock, interf, ov, outs = _sim_step(plan, carry, r, k)
    s_cur = z
    ring, pm, pa, pz = _observe(plan, carry, k, a, z, ov, outs)

    decide = dev["decide_tab"][k]                       # (J,)
    if host["any_decide"][k]:
        s_new, dec_ok = _decide(plan, carry["params"], k, s_cur, clock, pm,
                                pa, pz)
    else:
        s_new, dec_ok = s_cur, torch.ones_like(decide)
    fb_used = decide & ~dec_ok
    nonfin = decide & ~torch.isfinite(s_new)
    s_next = torch.where(decide, s_new, s_cur)
    # belt and braces: a non-finite decision never leaves the step
    s_next = torch.where(torch.isfinite(s_next), s_next, s_cur)

    is_last = k == st.c_max - 1
    fit_calls = carry["fit_calls"]
    if is_last:
        fit_loss, fit_skip = _fit(plan, carry, ring, r)
        fit_calls = fit_calls + 1
        # nan_fit chaos fires right after the fit, as the live hook does
        for j in np.flatnonzero(host["poison_at"][r]):
            for p in param_leaves(carry["params"]):
                p[int(j)].fill_(float("nan"))
    else:
        fit_loss = torch.zeros_like(clock)
        fit_skip = torch.zeros_like(fit_calls)

    new_carry = {
        "clock": clock, "interf": interf,
        "s_prev": s_cur, "s_cur": s_next,
        "p_met": pm, "p_a": pa, "p_z": pz,
        "ring": ring,
        "params": carry["params"], "opt": carry["opt"],
        "fit_calls": fit_calls,
        "fallbacks": carry["fallbacks"] + fb_used.int(),
        "nonfinite": carry["nonfinite"] + nonfin.int(),
    }
    ys = {
        "clock": clock, "interf": interf, "a": a, "z": z, "s_next": s_next,
        "decided": decide, "dec_ok": dec_ok, "fallback": fb_used,
        "nonfinite": nonfin, "fit_loss": fit_loss, "fit_skipped": fit_skip,
        "rt": outs[:, :, sim_ops.O_RT], "failed": outs[:, :, sim_ops.O_FAILED],
        "stage_clk": outs[:, :, sim_ops.O_CLK],
    }

    if st.telemetry:
        # the flight-recorder block: decision-gap step deltas as the
        # pick-latency proxy, per-run fallback / non-finite / fit-skip
        # counts and the per-run compliance margin, written to ys at run
        # boundaries and replayed into the recorder at write-back
        # (``replay_spans``).  Pure observation: nothing below feeds the
        # decision or training ops above.
        tel = carry["tel"]
        gap_valid = decide & (tel["last_dec_t"] >= 0)
        gap = torch.where(gap_valid, t - tel["last_dec_t"],
                          torch.zeros_like(tel["last_dec_t"]))
        last_dec_t = torch.where(decide, torch.full_like(gap, t),
                                 tel["last_dec_t"])
        run_fb = tel["run_fallbacks"] + fb_used.int()
        run_nf = tel["run_nonfinite"] + nonfin.int()
        run_fs = tel["run_fit_skip"] + fit_skip
        zero = torch.zeros_like(run_fb)
        new_carry["tel"] = {
            "last_dec_t": last_dec_t,
            "run_fallbacks": zero if is_last else run_fb,
            "run_nonfinite": zero if is_last else run_nf,
            "run_fit_skip": zero if is_last else run_fs,
            "gap_sum": tel["gap_sum"] + gap,
            "gap_n": tel["gap_n"] + gap_valid.int(),
        }
        ys.update(
            tel_dec_gap=gap,
            tel_margin=(dev["target"] - clock) if is_last
            else torch.zeros_like(clock),
            tel_run_fallbacks=run_fb if is_last else zero,
            tel_run_nonfinite=run_nf if is_last else zero,
            tel_run_fit_skip=run_fs if is_last else zero,
        )
    return new_carry, ys


# =========================================================================
# drivers
# =========================================================================

_SIGNATURES: set = set()        # the PlanStatics driven in this process


def _note_signature(plan: CampaignPlan) -> None:
    if plan.static not in _SIGNATURES:
        _SIGNATURES.add(plan.static)
        record_trace("fused_campaign")


def _stack(trees: List):
    """Trees of one structure -> one tree, each leaf stacked on a new
    leading (job) axis."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _stack([t[k] for t in trees]) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(_stack([t[i] for t in trees])
                        for i in range(len(t0)))
    return torch.stack(trees)


def init_carry(plan: CampaignPlan):
    """A fresh carry: device copies of ``plan.init``, so two runs of one
    plan share no tensor."""
    return tree.tree_map(torch.clone, plan.init)


def _expected_fit_calls(plan: CampaignPlan, start: int) -> np.ndarray:
    """Each job's fit count at step ``start``: the plan's plus one per run
    finished before it (the dropout seeds of the step body assume it)."""
    return plan.host["fit_calls0"] + start // plan.static.c_max


def check_fit_calls(plan: CampaignPlan, fit_calls, start: int) -> None:
    """Refuse a carry (device or host copy) whose fit counts are not the
    ones the plan's dropout seeds assume at step ``start``."""
    got = np.asarray(fit_calls)
    want = _expected_fit_calls(plan, start)
    assert (got == want).all(), \
        f"the carry's fit_calls {got} are not the plan's {want} at step " \
        f"{start}: the dropout seeds would differ"


class _HostCopies:
    """A window with the CUDA sync debug mode (if any) lifted, for the
    fused driver's copies to the host before and after its enqueue loop,
    so a caller that checks the loop under
    ``torch.cuda.set_sync_debug_mode("error")`` sees no other."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def __enter__(self):
        if self.cuda:
            self.mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode(0)

    def __exit__(self, *exc):
        if self.cuda:
            torch.cuda.set_sync_debug_mode(self.mode)


def _start(plan: CampaignPlan, carry, start: int, stop: Optional[int]):
    """(carry, stop) for a driver: a fresh carry, or the caller's once its
    fit counts are checked (before anything is enqueued or changed)."""
    _note_signature(plan)
    stop = _check_range(plan, start, stop)
    if carry is None:
        return init_carry(plan), stop
    with _HostCopies(plan.device):
        check_fit_calls(plan, carry["fit_calls"].cpu(), start)
    return carry, stop


def _check_range(plan: CampaignPlan, start: int, stop: Optional[int]
                 ) -> int:
    stop = plan.n_steps if stop is None else stop
    if not 0 <= start < stop <= plan.n_steps:
        raise ValueError(f"steps [{start}, {stop}) outside the campaign's "
                         f"[0, {plan.n_steps})")
    return stop


def run_fused(plan: CampaignPlan, carry=None, start: int = 0,
              stop: Optional[int] = None):
    """Steps ``[start, stop)`` enqueued without a host synchronisation ->
    (final carry (device), ys (host numpy, stacked along the steps)).

    The outputs stay on the device until the end, stacked there, and are
    copied to the host after the last step is enqueued."""
    carry, stop = _start(plan, carry, start, stop)
    steps = []
    for t in range(start, stop):
        carry, y = _step(plan, carry, t)
        steps.append(y)
    stacked = {key: torch.stack([y[key] for y in steps]) for key in steps[0]}
    with _HostCopies(plan.device):
        return carry, {key: s.cpu().numpy() for key, s in stacked.items()}


def run_stepped(plan: CampaignPlan, carry=None, start: int = 0,
                stop: Optional[int] = None):
    """The same step body, each step's outputs moved to the host as it
    ends (the parity comparator and incremental driver); ys stacked as
    :func:`run_fused` stacks them."""
    carry, stop = _start(plan, carry, start, stop)
    ys_steps = []
    for t in range(start, stop):
        carry, y = _step(plan, carry, t)
        ys_steps.append({key: v.cpu().numpy() for key, v in y.items()})
    ys = {key: np.stack([y[key] for y in ys_steps]) for key in ys_steps[0]}
    return carry, ys


def carry_to_host(carry) -> Dict[str, Any]:
    """Picklable numpy copy of a carry (a mid-campaign checkpoint)."""
    return tree.tree_map(lambda t: t.detach().cpu().numpy().copy(), carry)


def carry_from_host(carry, device: DeviceLike = "cuda") -> Dict[str, Any]:
    """A carry on ``device`` from :func:`carry_to_host`'s copy (which is
    left untouched)."""
    dev = resolve_device(device)
    return tree.tree_map(lambda a: torch.tensor(np.asarray(a), device=dev),
                     carry)


def replay_spans(plan: CampaignPlan, ys, start: int = 0,
                 recorder=None) -> int:
    """Replay a fused campaign's ys block into the flight recorder.

    A pure function of ``(plan, ys)``: the span stream depends only on the
    materialized step outputs, so ``run_fused`` and ``run_stepped`` of the
    same plan replay to IDENTICAL ``(kind, attrs)`` streams.  Timestamps
    are the *logical* step index (not wall time).  Returns the number of
    spans emitted.

    Span kinds mirror the live stepped path where an in-step analogue
    exists: ``decision.pick`` per decided job (with the step-delta pick
    latency proxy), ``decision.fallback`` for guardrail-clamped picks,
    ``fit`` at run boundaries and ``run.end`` with the per-run compliance
    margin and fallback / non-finite / fit-skip counts from the telemetry
    block (plans built with ``telemetry=False`` have no tel arrays, so only
    the base decision / fit spans replay).
    """
    from repro_torch import obs as _obs
    if recorder is None:
        recorder = _obs.recorder()
    if not _obs.enabled():
        return 0
    h = plan.host
    ysn = {k: np.asarray(v) for k, v in ys.items()}
    c_max = plan.static.c_max
    names = h["job_names"]
    scratch_at = h.get("scratch_at")
    n = 0
    for i in range(ysn["decided"].shape[0]):
        t = start + i
        r, k = divmod(t, c_max)
        decided = ysn["decided"][i]
        for j, name in enumerate(names):
            if decided[j]:
                attrs = dict(driver="fused", job=name, run=r, comp=k,
                             scaleout=int(ysn["s_next"][i, j]),
                             fallback=bool(ysn["fallback"][i, j]))
                if "tel_dec_gap" in ysn:
                    attrs["gap_steps"] = int(ysn["tel_dec_gap"][i, j])
                recorder.emit("decision.pick", _ts=float(t), **attrs)
                n += 1
                if attrs["fallback"]:
                    recorder.emit(
                        "decision.fallback", _ts=float(t), driver="fused",
                        job=name, run=r, comp=k, cause="guardrail",
                        nonfinite=bool(ysn["nonfinite"][i, j]))
                    n += 1
        if k == c_max - 1:                      # run boundary: fit + run.end
            scratch = bool(scratch_at[r]) if scratch_at is not None and \
                r < len(scratch_at) else False
            for j, name in enumerate(names):
                recorder.emit(
                    "fit", _ts=float(t), driver="fused", job=name, run=r,
                    mode="scratch" if scratch else "tune",
                    skipped=int(ysn["fit_skipped"][i, j]),
                    loss=round(float(ysn["fit_loss"][i, j]), 6))
                n += 1
                if "tel_margin" in ysn:
                    recorder.emit(
                        "run.end", _ts=float(t), driver="fused", job=name,
                        run=r, clock=round(float(ysn["clock"][i, j]), 4),
                        margin=round(float(ysn["tel_margin"][i, j]), 4),
                        fallbacks=int(ysn["tel_run_fallbacks"][i, j]),
                        nonfinite=int(ysn["tel_run_nonfinite"][i, j]),
                        fit_skipped=int(ysn["tel_run_fit_skip"][i, j]))
                    n += 1
    return n


# =========================================================================
# plan construction (host side, once per campaign)
# =========================================================================

def _class_tables(exp, c_max: int, s_max: int, k_pad: int,
                  e_pad: int) -> Dict[str, np.ndarray]:
    """Structural tables shared by every experiment of one job class:
    frozen observation contexts, ring-row node layout and the sweep's
    candidate-invariant graph structure (fixed slot layout: stages 0..n-1,
    P at n, masked unless next component, and H at n+1; masked slots
    contribute exact zeros in the sparse sweep, so the fixed layout is
    functionally identical to the live path's compaction)."""
    from repro_torch.dataflow.runner import frozen_context_tables
    job = exp.job
    ctx, n_stages = frozen_context_tables(exp.encoder, job)
    n_comp, s_loc, ns = ctx.shape[0], ctx.shape[1], ctx.shape[2]
    obs = np.zeros((c_max, s_max, ns, CTX_DIM), np.float32)
    obs[:n_comp, :s_loc] = ctx
    nst = np.zeros(c_max, np.int32)
    nst[:n_comp] = n_stages
    p_ctx = np.zeros((c_max, ns, CTX_DIM), np.float32)
    for c in range(n_comp):
        p_ctx[c] = ctx[c, :n_stages[c]].mean(axis=0)

    row_mask = np.zeros((c_max, N_ROW), bool)
    row_summ = np.zeros((c_max, N_ROW), bool)
    row_st = np.zeros((c_max, N_ROW), bool)
    row_p = np.zeros((c_max, N_ROW), bool)
    row_h = np.zeros((c_max, N_ROW), bool)
    row_si = np.zeros((c_max, N_ROW), np.int64)
    row_adj = np.zeros((c_max, N_ROW, N_ROW), bool)
    for c in range(n_comp):
        n = int(n_stages[c])
        row_mask[c, :n] = True
        row_st[c, :n] = True
        row_si[c, :n] = np.arange(n)
        for i in range(n - 1):
            row_adj[c, i + 1, i] = True
        if c > 0:                     # P(k-1) and H(k-1) predecessor slots
            row_mask[c, n:n + 2] = True
            row_summ[c, n:n + 2] = True
            row_p[c, n] = True
            row_h[c, n + 1] = True
            row_adj[c, 0, n] = True
            row_adj[c, 0, n + 1] = True

    sw_mask0 = np.zeros((k_pad, N_ROW), bool)
    sw_summ = np.zeros((k_pad, N_ROW), bool)
    sw_st = np.zeros((k_pad, N_ROW), bool)
    sw_p = np.zeros((k_pad, N_ROW), bool)
    sw_h = np.zeros((k_pad, N_ROW), bool)
    sw_si = np.zeros((k_pad, N_ROW), np.int64)
    sw_oh = np.zeros((k_pad, N_ROW), np.float32)
    sw_adj = np.zeros((k_pad, N_ROW, N_ROW), bool)
    sw_ed = np.zeros((k_pad, e_pad), np.int64)
    sw_es = np.zeros((k_pad, e_pad), np.int64)
    sw_ev = np.zeros((k_pad, e_pad), bool)
    depth = 1
    for ki in range(k_pad):
        c = ki + 1
        if c >= n_comp:
            continue
        n = int(n_stages[c])
        assert n + 2 <= N_ROW, "sweep slots overflow the node bucket"
        sw_mask0[ki, :n + 2] = True
        sw_st[ki, :n] = True
        sw_si[ki, :n] = np.arange(n)
        sw_summ[ki, n:n + 2] = True
        sw_p[ki, n] = True
        sw_h[ki, n + 1] = True
        sw_oh[ki, n + 1] = 1.0
        adj = np.zeros((N_ROW, N_ROW), bool)
        for i in range(n - 1):
            adj[i + 1, i] = True
        adj[0, n] = True
        adj[0, n + 1] = True
        sw_adj[ki] = adj
        pairs = np.argwhere(adj)               # (m, 2): [dst, src], the
        m = len(pairs)                         # live sweep_edge_list order
        assert m <= e_pad, "edge bucket overflow"
        sw_ed[ki, :m] = pairs[:, 0]
        sw_es[ki, :m] = pairs[:, 1]
        sw_ev[ki, :m] = True
        depth = max(depth, propagation_depth(adj, sw_mask0[ki]))
    return {
        "obs_ctx": obs, "p_ctx": p_ctx, "n_stage": nst,
        "row_mask": row_mask, "row_summ": row_summ, "row_is_stage": row_st,
        "row_is_p": row_p, "row_is_h": row_h, "row_stage_idx": row_si,
        "row_adj": row_adj,
        "sw_mask0": sw_mask0, "sw_summ": sw_summ, "sw_is_stage": sw_st,
        "sw_is_p": sw_p, "sw_is_h": sw_h, "sw_stage_idx": sw_si,
        "sw_oh": sw_oh, "sw_adj": sw_adj, "sw_edge_dst": sw_ed,
        "sw_edge_src": sw_es, "sw_edge_val": sw_ev,
        "depth": np.int32(depth),
    }


def _hist_tables(exp, c_max: int, k_pad: int, grid: np.ndarray,
                 cand: np.ndarray) -> Dict[str, np.ndarray]:
    """Frozen historical-summary tables: per component k, the H(k-1) node
    attributes at every grid scale-out (ring rows) and at every candidate
    (sweep deltas).  Matches the live ranking exactly at plan time; the
    live history keeps growing afterwards (documented deviation)."""
    beta = exp.enel.beta
    ns, c_pad = len(grid), len(cand)
    n_comp = exp.job.n_components
    hob_ctx = np.zeros((c_max, ns, CTX_DIM), np.float32)
    hob_met = np.zeros((c_max, ns, N_METRICS), np.float32)
    hob_val = np.zeros((c_max, ns), bool)
    hob_start = np.ones((c_max, ns), np.float32)
    hob_end = np.ones((c_max, ns), np.float32)
    for k in range(1, n_comp):
        hl = exp.enel.hist_summaries.get(k - 1, [])
        if not hl:
            raise ValueError(
                f"no history for component {k - 1} of {exp.job.name} — "
                "run profile() before building a fused campaign plan")
        hb = historical_summaries_batch(hl, grid, beta)
        hob_ctx[k] = hb["context"]
        hob_met[k] = hb["metrics"]
        hob_val[k] = hb["metrics_valid"]
        hob_start[k] = np.maximum(hb["start"], 1e-6)
        hob_end[k] = np.maximum(hb["end"], 1e-6)
    hsw_ctx = np.zeros((c_pad, k_pad, CTX_DIM), np.float32)
    hsw_met = np.zeros((c_pad, k_pad, N_METRICS), np.float32)
    hsw_val = np.zeros((c_pad, k_pad), bool)
    hsw_start = np.ones((c_pad, k_pad), np.float32)
    hsw_end = np.ones((c_pad, k_pad), np.float32)
    for ki in range(k_pad):
        c = ki + 1
        if c >= n_comp:
            continue
        hl = exp.enel.hist_summaries.get(c - 1, [])
        if not hl:
            raise ValueError(
                f"no history for component {c - 1} of {exp.job.name} — "
                "run profile() before building a fused campaign plan")
        hb = historical_summaries_batch(hl, cand, beta)
        hsw_ctx[:, ki] = hb["context"]
        hsw_met[:, ki] = hb["metrics"]
        hsw_val[:, ki] = hb["metrics_valid"]
        hsw_start[:, ki] = np.maximum(hb["start"], 1e-6)
        hsw_end[:, ki] = np.maximum(hb["end"], 1e-6)
    return {"hob_ctx": hob_ctx, "hob_met": hob_met, "hob_val": hob_val,
            "hob_start": hob_start, "hob_end": hob_end,
            "hsw_ctx": hsw_ctx, "hsw_met": hsw_met, "hsw_val": hsw_val,
            "hsw_start": hsw_start, "hsw_end": hsw_end}


def build_plan(experiments, n_runs: int, *, inject_failures: bool = False,
               retrain_every: int = 5, steps: int = 160,
               fine_tune_steps: int = 60,
               metric_dropout: float = 0.5,
               telemetry: Optional[bool] = None) -> CampaignPlan:
    """A fused whole-campaign plan for ``n_runs`` adaptive runs of a
    profiled fleet sharing one :class:`BatchedClusterSim`, on its device.

    Consumes the backend's rng streams exactly as ``n_runs`` stepped runs
    would (via :meth:`campaign_run_blocks`, last, so that a refused plan
    leaves them as they were), so a fused campaign and a stepped campaign
    from the same seed state see identical draws.  Raises on
    configurations the step body cannot honour (unprofiled jobs, host-side
    chaos families, capacity caps, non-uniform trainer cadence).  Each
    job's scratch fits restart from its trainer's ``init_params``.
    """
    exps = list(experiments)
    if not exps:
        raise ValueError("empty fleet")
    backend = exps[0].backend
    if not isinstance(backend, BatchedClusterSim):
        raise TypeError("fused campaigns need the batched sim engine "
                        "(FleetCampaign(..., engine='batched'))")
    for i, e in enumerate(exps):
        if e.backend is not backend:
            raise ValueError("all experiments must share ONE backend")
        if e.sim_slot != i:
            raise ValueError("experiment order must match sim slots")
        if e.target is None:
            raise ValueError(f"{e.job.name}: profile() first")
        cache = e.trainer.cache
        if cache is None or cache.count == 0:
            raise ValueError(f"{e.job.name}: empty training ring")
        if cache.max_nodes != N_ROW:
            raise ValueError(f"ring rows have {cache.max_nodes} node "
                             f"slots, fused kernel needs {N_ROW}")
        if e.scale_cap is not None:
            raise ValueError("capacity caps are a host-path feature")
        if e.chaos is not None and (e.chaos.spec.nan_graphs_every
                                    or e.chaos.spec.cache_corrupt_every):
            raise ValueError("only nan_fit chaos runs in-scan; "
                             "nan_graphs/cache_corrupt mutate host caches")
    J = len(exps)
    lo, hi = exps[0].enel.range
    stride = exps[0].enel.candidate_stride
    cap = exps[0].trainer.cache.capacity
    runs_seen0 = exps[0].trainer.runs_seen
    for e in exps:
        if e.enel.range != (lo, hi) or \
                e.enel.candidate_stride != stride:
            raise ValueError("candidate grids must be uniform")
        if e.trainer.cache.capacity != cap:
            raise ValueError("ring capacities must be uniform")
        if e.trainer.runs_seen != runs_seen0:
            raise ValueError("trainer cadence must be uniform "
                             "(equal runs_seen)")
    device = backend.device

    grid_c = sorted(set(range(lo, hi + 1, stride)) | {hi})
    c_real = len(grid_c)
    c_pad = ladder_bucket(c_real, CAND_LADDER)
    cand = np.full(c_pad, grid_c[-1], np.float32)
    cand[:c_real] = grid_c
    cand_valid = np.zeros(c_pad, bool)
    cand_valid[:c_real] = True
    grid_all = np.arange(lo, hi + 1, dtype=np.float32)

    const = backend.fused_sim_constants()
    s_max = int(const["s_max"])
    c_max = max(e.job.n_components for e in exps)
    k_pad = ladder_bucket(max(c_max - 1, 1), COMP_LADDER)
    e_pad = ladder_bucket(s_max + 1, EDGE_LADDER)

    # ---- structural tables, deduplicated per job class
    cls_of: Dict[tuple, int] = {}
    classes: List[Dict[str, np.ndarray]] = []
    cls = np.zeros(J, np.int64)
    for i, e in enumerate(exps):
        key = (e.job.name, e.seed, e.job.n_components,
               tuple(len(e.job.stages(c))
                     for c in range(e.job.n_components)))
        if key not in cls_of:
            cls_of[key] = len(classes)
            classes.append(_class_tables(e, c_max, s_max, k_pad, e_pad))
        cls[i] = cls_of[key]
    depth = max(int(c["depth"]) for c in classes)
    levels = ladder_bucket(depth, LEVEL_LADDER)

    # ---- frozen history tables, deduplicated per (job, seed, progress)
    h_of: Dict[tuple, int] = {}
    hists: List[Dict[str, np.ndarray]] = []
    hcls = np.zeros(J, np.int64)
    for i, e in enumerate(exps):
        key = (e.job.name, e.seed, e._run_idx, e.trainer.runs_seen,
               tuple(len(e.enel.hist_summaries.get(c, []))
                     for c in range(e.job.n_components)))
        if key not in h_of:
            h_of[key] = len(hists)
            hists.append(_hist_tables(e, c_max, k_pad, grid_all, cand))
        hcls[i] = h_of[key]

    # ---- per-job schedule tables
    n_comp = np.array([e.job.n_components for e in exps], np.int64)
    comp_valid = np.zeros((c_max, J), bool)
    decide_tab = np.zeros((c_max, J), bool)
    n_stage_f = np.zeros((c_max, J), np.float32)
    cursor_f = np.zeros((c_max, J), np.float32)
    for i, e in enumerate(exps):
        nc = e.job.n_components
        comp_valid[:nc, i] = True
        for k in range(nc):
            decide_tab[k, i] = (k < nc - 1
                                and k % e.decision_interval == 0)
        tab = backend._slots[i].tables
        n_stage_f[:nc, i] = tab.n_stages
        cursor_f[:nc, i] = tab.comp_start
        cursor_f[nc:, i] = tab.total_stages
    any_decide = decide_tab.any(axis=1)

    # ---- fixed s0 (exact under method="enel": Ellis never refits during
    # adaptive runs, so its recommendation is constant across the campaign)
    s0 = np.zeros(J, np.float32)
    predicted = []
    for i, e in enumerate(exps):
        rec, p_hat = e.ellis.recommend(
            next_comp=0, n_components=e.job.n_components, elapsed=0.0,
            current_scaleout=lo, target_runtime=e.target)
        s0[i] = rec
        predicted.append(p_hat)
    inject = np.array(
        [float(bool(inject_failures) or e.scenario.inject_failures)
         for e in exps], np.float32)
    target = np.array([e.target for e in exps], np.float32)

    # ---- fit cadence / chaos schedules
    scratch_at = np.array(
        [((runs_seen0 + r + 1) % retrain_every) == 0
         for r in range(n_runs)], bool)
    poison_at = np.zeros((n_runs, J), bool)
    for i, e in enumerate(exps):
        if e.chaos is not None and e.chaos.spec.nan_fit_every:
            for r in range(n_runs):
                poison_at[r, i] = e.chaos._fires(
                    e.chaos.spec.nan_fit_every, e._run_idx + r + 1)

    # ---- learned state, stacked along the job axis on the device
    params0 = _stack([e.trainer.params for e in exps])
    opt0 = _stack([e.trainer.opt for e in exps])
    init_params = _stack([e.trainer.init_params for e in exps])
    fit_calls = np.array([e.trainer._fit_calls for e in exps], np.int32)

    snaps = [e.trainer.cache.snapshot() for e in exps]
    ring0 = {
        "buffers": {kk: np.stack([s["buffers"][kk] for s in snaps])
                    for kk in snaps[0]["buffers"]},
        "pos": np.array([s["pos"] for s in snaps], np.int64),
        "count": np.array([s["count"] for s in snaps], np.int64),
        "slot_ok": np.stack([s["slot_ok"] for s in snaps]),
    }
    interf0 = np.array(
        [backend.slot_state(i)["interf"] for i in range(J)], np.float32)

    # LAST: consume the backend rng streams for the whole campaign
    blocks, kills = backend.campaign_run_blocks(n_runs)

    up = lambda a: torch.tensor(np.asarray(a), device=device)
    gather = lambda key_: up(np.stack([c[key_] for c in classes]))
    hgather = lambda key_: up(np.stack([hh[key_] for hh in hists]))
    tune_rows = pow2_bucket(c_max)
    dev = {
        "blocks": up(blocks), "kills": up(kills),
        "burst": const["burst"], "preempt": const["preempt"],
        "iscale2": const["iscale2"], "mem_tab": const["mem_tab"],
        "shuf_tab": const["shuf_tab"],
        "cand": up(cand), "cand_valid": up(cand_valid),
        "inject": up(inject), "target": up(target),
        "s0": up(s0), "n_comp": up(n_comp),
        "comp_valid": up(comp_valid),
        "decide_tab": up(decide_tab),
        "n_stage_f": up(n_stage_f), "n_stage_i": up(n_stage_f.astype(
            np.int64)),
        "cursor_f": up(cursor_f),
        "cls": up(cls), "hcls": up(hcls),
        "ji": torch.arange(J, device=device),
        "slots": torch.arange(cap, device=device),
        "tune_rows": torch.arange(tune_rows, device=device),
        "sw_comp": torch.arange(1, k_pad + 1, device=device),
        "obs_ctx": gather("obs_ctx"), "p_ctx": gather("p_ctx"),
        "row_mask": gather("row_mask"), "row_summ": gather("row_summ"),
        "row_is_stage": gather("row_is_stage"),
        "row_is_p": gather("row_is_p"), "row_is_h": gather("row_is_h"),
        "row_stage_idx": gather("row_stage_idx"),
        "row_adj": gather("row_adj"),
        "sw_mask0": gather("sw_mask0"), "sw_summ": gather("sw_summ"),
        "sw_is_stage": gather("sw_is_stage"),
        "sw_is_p": gather("sw_is_p"), "sw_is_h": gather("sw_is_h"),
        "sw_stage_idx": gather("sw_stage_idx"), "sw_oh": gather("sw_oh"),
        "sw_adj": gather("sw_adj"),
        "sw_edge_dst": gather("sw_edge_dst"),
        "sw_edge_src": gather("sw_edge_src"),
        "sw_edge_val": gather("sw_edge_val"),
        "hob_ctx": hgather("hob_ctx"), "hob_met": hgather("hob_met"),
        "hob_val": hgather("hob_val"),
        "hob_start": hgather("hob_start"), "hob_end": hgather("hob_end"),
        "hsw_ctx": hgather("hsw_ctx"), "hsw_met": hgather("hsw_met"),
        "hsw_val": hgather("hsw_val"),
        "hsw_start": hgather("hsw_start"), "hsw_end": hgather("hsw_end"),
        "init_params": init_params, "fit_calls0": up(fit_calls),
    }
    init = {
        "clock": torch.zeros(J, device=device), "interf": up(interf0),
        "s_prev": up(s0), "s_cur": up(s0),
        "p_met": torch.zeros((J, N_METRICS), device=device),
        "p_a": torch.ones(J, device=device),
        "p_z": torch.ones(J, device=device),
        "ring": tree.tree_map(up, ring0),
        "params": params0, "opt": opt0,
        "fit_calls": up(fit_calls),
        "fallbacks": torch.zeros(J, dtype=torch.int32, device=device),
        "nonfinite": torch.zeros(J, dtype=torch.int32, device=device),
    }
    if telemetry is None:
        from repro_torch import obs as _obs
        telemetry = _obs.enabled()
    if telemetry:
        i32 = lambda fill: torch.full((J,), fill, dtype=torch.int32,
                                      device=device)
        init["tel"] = {
            "last_dec_t": i32(-1), "run_fallbacks": i32(0),
            "run_nonfinite": i32(0), "run_fit_skip": i32(0),
            "gap_sum": i32(0), "gap_n": i32(0),
        }
    static = PlanStatic(
        c_max=c_max, s_max=s_max, lo=lo, tune_rows=tune_rows,
        scratch_steps=_round_steps(steps),
        tune_steps=_round_steps(fine_tune_steps),
        retrain_every=retrain_every, levels=levels,
        telemetry=bool(telemetry))
    host = {
        "predicted": predicted, "targets": target.copy(),
        "n_comp": n_comp.copy(), "decide_tab": decide_tab.copy(),
        "any_decide": any_decide.copy(),
        "comp_valid": comp_valid.copy(),
        "n_stage": n_stage_f.astype(np.int32),
        "s0": s0.astype(np.int32),
        "job_names": [e.job.name for e in exps],
        "run_idx0": [e._run_idx for e in exps],
        "n_runs": int(n_runs),
        "scratch_at": scratch_at.copy(),
        "poison_at": poison_at.copy(),
        "fit_calls0": fit_calls.copy(),
        "seeds": [e.trainer.seed for e in exps],
        "lr": [float(e.trainer.lr) for e in exps],
        "dropout_p": float(metric_dropout),
    }
    return CampaignPlan(static, dev, init, host)
