"""Driver of the training cells: the port's ``make_train_step`` on one
train state, fed packed synthetic documents from the seed.

Set-up makes the weights and the optimizer state, then drives the step
through its first ``check_steps`` steps (which also warm it up), keeping
what the comparison needs: each step's loss, the first gradient as the
optimizer got it (its first moment over 1 - b1), and the parameters'
change over those steps.  The same state then trains through the window;
a step counts once its loss has reached the host.  The window ends with
the first step that ends at or after ``--seconds``.
"""
from __future__ import annotations

import statistics
from typing import Dict, List

import numpy as np
import torch

from bench.core import weights as W
from bench.core.trace import traced
from bench.drivers.common import now, rel_gap, summarize_trace, sync
from bench.work import flops, tokens


def batch(ctx, step: int) -> Dict[str, torch.Tensor]:
    t = ctx.traffic
    toks, tgts = tokens.train_batch(
        ctx.seed, ctx.c["raw_vocab_size"], step, t["batch"], t["seq_len"],
        mean_doc_len=t["mean_doc_len"], eos_id=t["eos_id"],
        zipf_a=t["zipf_a"])
    return {"tokens": torch.from_numpy(toks).to(ctx.device),
            "targets": torch.from_numpy(tgts).to(ctx.device)}


def program_step(ctx):
    """The program's step function and a fresh state from the seed."""
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train import make_train_step
    cfg = ctx.model_config()
    params = W.make_params(ctx.c, ctx.seed, ctx.device)
    state = {"params": params, "opt": init_opt_state(params, cfg.opt_dtype)}
    step = make_train_step(cfg, AdamWConfig(**ctx.traffic["optimizer"]),
                           grad_accum=cfg.grad_accum)
    return step, state


def first_steps(ctx, step_fn, state, n: int) -> Dict:
    """Drive ``n`` steps; the readings the comparison takes."""
    b1 = ctx.traffic["optimizer"].get("b1", 0.9)
    p0 = [t.detach().clone() for _, t in W.leaves(state["params"], ctx.c)]
    losses, grad_norms = [], None
    for i in range(n):
        state, m = step_fn(state, batch(ctx, i))
        losses.append(float(m["loss"]))
        if i == 0:
            grad_norms = [float(mu.float().div(1 - b1).norm())
                          for _, mu in W.leaves(state["opt"]["mu"], ctx.c)]
    change = [float((t.float() - a.float()).norm())
              for (_, t), a in zip(W.leaves(state["params"], ctx.c), p0)]
    return {"losses": losses, "grad_norms": grad_norms, "change": change}


def run(ctx, step_fn=None, state=None) -> Dict:
    from repro_torch.kernels.flash_attention import ops as fa
    t = ctx.traffic
    cuda = ctx.device.type == "cuda"
    if cuda:
        fa._kernel_fn()                     # from the build cache
    if step_fn is None:
        step_fn, state = program_step(ctx)
    readings = first_steps(ctx, step_fn, state, t["check_steps"])
    sync(ctx.device)
    tokens_per_step = t["batch"] * t["seq_len"]
    steps: List = []
    i = t["check_steps"]
    start = now()
    while not steps or steps[-1][1] - start < ctx.seconds:
        a = now()
        state, m = step_fn(state, batch(ctx, i))
        loss = float(m["loss"])
        steps.append((a, now(), loss))
        i += 1
    rec = {"window_start": start, "window_end": steps[-1][1],
           "steps": steps, "tokens_per_step": tokens_per_step,
           "step_flops": flops.train_step_flops(ctx.c, t["batch"],
                                                t["seq_len"]),
           "attempted": len(steps),
           "failed": sum(not np.isfinite(s[2]) for s in steps),
           "readings": readings, "printed": {}}
    if ctx.trace:
        tdata: Dict = {}
        with traced(tdata):
            for _ in range(t["trace_steps"]):
                from torch.profiler import record_function
                with record_function("bench.step"):
                    state, m = step_fn(state, batch(ctx, i))
                    float(m["loss"])
                i += 1
        rec["trace"] = dict(tdata, **summarize_trace(tdata, "bench.step"))
        rec["printed"]["launches_per_step"] = {
            k: sum(r[0] == k for r in tdata["reports"]) / t["trace_steps"]
            for k in sorted({r[0] for r in tdata["reports"]})}
    if cuda:
        rec["printed"]["peak_hbm_bytes"] = torch.cuda.max_memory_allocated(
            ctx.device)
    rec["printed"]["step_s"] = [s[1] - s[0] for s in steps]
    rec["printed"]["losses"] = [s[2] for s in steps]
    return rec


def reference_readings(ctx, fp8: bool = False) -> Dict:
    """The plain reference's readings over the same first steps, from the
    seed's weights and batches."""
    from bench.reference import lm
    from bench.reference.train import AdamW, Adam, grads
    lm.exact_float32()
    t = ctx.traffic
    params = W.make_params(ctx.c, ctx.seed, ctx.device)
    names = W.leaves(params, ctx.c)
    p0 = [p.detach().clone() for _, p in names]
    adam = Adam(names, AdamW(**t["optimizer"]))
    losses, grad_norms, raw = [], None, None
    for i in range(t["check_steps"]):
        b = batch(ctx, i)
        loss, gs = grads(params, names, ctx.c, b["tokens"], b["targets"],
                         ctx.c.get("grad_accum", 1), fp8)
        if i == 0:
            raw = [float(g.norm()) for g in gs]
        norms = adam.update(names, gs)
        del gs
        losses.append(loss)
        if i == 0:
            grad_norms = norms
    change = [float((p.float() - a.float()).norm())
              for (_, p), a in zip(names, p0)]
    return {"losses": losses, "grad_norms": grad_norms, "change": change,
            "raw_grad_norms": raw, "names": [n for n, _ in names]}


def compare(prog: Dict, ref: Dict) -> Dict:
    """The numbers compared: the widest loss gap over the steps; the worst
    leaf's gap of first-gradient norms and of the change's norms, each
    against the larger of that leaf's reference norm and the median
    leaf's.  Leaves whose reference gradient is under a thousandth of the
    median leaf's move by rounding alone and are left out of the change."""
    loss_gap = max(abs(a - b) for a, b in zip(prog["losses"], ref["losses"]))
    med_g = statistics.median(ref["grad_norms"])
    grad_gap = max(rel_gap(a, b, med_g)
                   for a, b in zip(prog["grad_norms"], ref["grad_norms"]))
    med_raw = statistics.median(ref["raw_grad_norms"])
    counted = [i for i, g in enumerate(ref["raw_grad_norms"])
               if g >= 1e-3 * med_raw]
    med_c = statistics.median(ref["change"][i] for i in counted)
    change_gap = max(rel_gap(prog["change"][i], ref["change"][i], med_c)
                     for i in counted)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap}


def worst_leaves(prog: Dict, ref: Dict, key: str, k: int = 4) -> List:
    """The ``k`` leaves farthest apart on ``key``: [name, program,
    reference]."""
    rows = sorted(zip(ref["names"], prog[key], ref[key]),
                  key=lambda r: -abs(r[1] - r[2]) / max(abs(r[2]), 1e-30))
    return [list(r) for r in rows[:k]]


def check(ctx, rec) -> Dict:
    ref = reference_readings(ctx)
    rec["printed"]["reference"] = {
        "losses": ref["losses"], "program_losses": rec["readings"]["losses"],
        "worst_grad_leaves": worst_leaves(rec["readings"], ref, "grad_norms"),
        "worst_change_leaves": worst_leaves(rec["readings"], ref, "change")}
    return compare(rec["readings"], ref)
