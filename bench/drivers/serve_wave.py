"""Driver of the serving cells: the port's ``ServeEngine.serve_wave`` on
closed-loop waves of requests; the next wave is handed in when the last
one returns.

The traffic file fixes the waves' sizes: ``cycle_waves`` waves of
``wave`` prompts whose lengths are drawn once, log-uniform in
``lengths``, with the file's ``size_seed``, served in that order (the
order of arrival), over and over.  With ``sorted_waves`` the cycle's
lengths are sorted and cut into waves, so that a wave holds prompts of
like length, as a server that batches by length forms them, and the
waves are served in an order drawn from ``size_seed``.  ``--seed`` draws
what the prompts say and the images' patch embeddings, so every seed
serves the same sizes.  Set-up serves one wave of each padded length of
the cycle, the longest first.  A wave is left-padded with token 0 (as
the engine pads) to its longest prompt, and a wave whose longest prompt
is over ``pad_multiple`` to a multiple of it (the MoE layer takes a
sequence of at most one routing group or of whole groups); its cache
holds its rows and ``new_tokens`` more.  A request's first token counts
from the hand-off of its wave to its arrival on the host, stamped by its
output list.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from bench.core import weights as W
from bench.core.stamps import StampList
from bench.core.trace import traced, busy_in, span_bounds
from bench.drivers.common import (kernel_seconds, now, summarize_trace,
                                  sync)
from bench.work import flops, tokens
from bench.work.flops import decode_work, least_seconds
from bench.work.peaks import BF16_FLOPS, HBM_BYTES


def wave_sizes(traffic: Dict) -> List[List[int]]:
    """Prompt lengths of each wave of the cycle (fixed by the file)."""
    t = traffic
    rng = np.random.default_rng(t["size_seed"])
    lo, hi = t["lengths"]["lo"], t["lengths"]["hi"]
    n = t["cycle_waves"] * t["wave"]
    lens = np.exp(rng.uniform(np.log(lo), np.log(hi), n)).astype(int)
    lens = np.clip(lens, lo, hi)
    if t.get("sorted_waves"):
        waves = np.sort(lens).reshape(t["cycle_waves"], t["wave"])
        return waves[rng.permutation(t["cycle_waves"])].tolist()
    return lens.reshape(t["cycle_waves"], t["wave"]).tolist()


def padded(traffic: Dict, lens: List[int]) -> int:
    m, p = traffic["pad_multiple"], max(lens)
    return p if p <= m else -(-p // m) * m


def make_wave(ctx, k: int, sizes) -> Dict:
    """Wave ``k``'s prompts (left-padded) and, for a vlm, its patches on
    the device."""
    t, c = ctx.traffic, ctx.c
    lens = sizes[k % len(sizes)]
    p = padded(t, lens)
    prompts = []
    for i, n in enumerate(lens):
        row = np.zeros(p, np.int64)
        row[p - n:] = tokens.prompt_tokens(ctx.seed, c["raw_vocab_size"], k,
                                           i, n)
        prompts.append(row)
    wave = {"k": k, "lens": list(lens), "p": p, "prompts": prompts,
            "extras": None}
    if c["family"] == "vlm":
        wave["extras"] = {"patches": patches(ctx, k, len(lens))}
    return wave


def patches(ctx, k: int, n: int) -> torch.Tensor:
    c = ctx.c
    gen = torch.Generator(device=ctx.device).manual_seed(
        (ctx.seed * 1_000_003 + 7919 * (k + 1)) % (1 << 63))
    x = torch.randn((n, c["n_patches"], c["d_model"]), generator=gen,
                    device=ctx.device, dtype=torch.float32)
    return (x * 0.1).to(getattr(torch, c["dtype"]))


def rows_of(ctx, wave) -> int:
    return wave["p"] + (ctx.c["n_patches"] if ctx.c["family"] == "vlm"
                        else 0)


def serve(ctx, engine_cls, request_cls, params, wave) -> Dict:
    """Hand wave ``wave`` to a fresh engine; the wave's record."""
    n = ctx.traffic["new_tokens"]
    cfg = ctx.cfg
    reqs = [request_cls(prompt=p, max_new_tokens=n, out_tokens=StampList())
            for p in wave["prompts"]]
    engine = engine_cls(cfg, params, max_len=rows_of(ctx, wave) + n,
                        device=ctx.device)
    sync(ctx.device)
    a = now()
    engine.serve_wave(reqs, wave["extras"])
    b = now()
    return {"k": wave["k"], "start": a, "end": b, "p": wave["p"],
            "lens": wave["lens"], "prompts": wave["prompts"],
            "tokens": [list(r.out_tokens) for r in reqs],
            "stamps": [list(r.out_tokens.stamps) for r in reqs]}


def run(ctx, engine_cls=None) -> Dict:
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_decode import ops as fd
    from repro_torch.serve.engine import Request, ServeEngine
    engine_cls = engine_cls or ServeEngine
    t = ctx.traffic
    ctx.cfg = ctx.model_config()
    if ctx.device.type == "cuda":
        fa._kernel_fn()                     # from the build cache
        fd._kernel_fn()
    params = W.make_params(ctx.c, ctx.seed, ctx.device)
    sizes = wave_sizes(t)
    shapes = {padded(t, w): j for j, w in enumerate(sizes)}
    for p in sorted(shapes, reverse=True):    # each padded length once
        j = shapes[p]
        serve(ctx, engine_cls, Request, params,
              make_wave(ctx, 10 ** 6 + j, [sizes[j]]))
    waves: List[Dict] = []
    k = 0
    start = now()
    while not waves or waves[-1]["end"] - start < ctx.seconds:
        waves.append(serve(ctx, engine_cls, Request, params,
                           make_wave(ctx, k, sizes)))
        k += 1
    rec = {"window_start": start, "window_end": waves[-1]["end"],
           "waves": waves, "printed": {}}
    ttft, done, prefill = [], 0, []
    for w in waves:
        firsts = [s[0] - w["start"] for s in w["stamps"] if s]
        ttft += firsts
        done += sum(len(tk) == t["new_tokens"] for tk in w["tokens"])
        rows = [n + (ctx.c["n_patches"] if ctx.c["family"] == "vlm" else 0)
                for n in w["lens"]]
        prefill.append((flops.prefill_flops(ctx.c, rows),
                        min(firsts) if firsts else float("nan")))
    rec.update(ttft=ttft, prefill=prefill,
               attempted=sum(len(w["lens"]) for w in waves))
    rec["failed"] = rec["attempted"] - done
    if ctx.trace:
        rec["trace"] = trace_waves(ctx, engine_cls, Request, params, sizes,
                                   k)
        rec["printed"].update(rec["trace"].pop("printed"))
    if ctx.device.type == "cuda":
        rec["printed"]["peak_hbm_bytes"] = torch.cuda.max_memory_allocated(
            ctx.device)
    stepped = [(s[-1] - s[0]) / (len(s) - 1) for w in waves
               for s in w["stamps"][:1] if len(s) > 1]
    rec["printed"]["decode_step_ms_median"] = (
        1e3 * float(np.median(stepped)) if stepped else None)
    return rec


def trace_waves(ctx, engine_cls, request_cls, params, sizes, k) -> Dict:
    """``trace_waves`` more waves under the profiler: the prefill stretch
    of each (hand-off to first token) and its decode stretch (first token
    to return)."""
    from torch.profiler import record_function
    t = ctx.traffic
    tdata: Dict = {}
    StampList.mark = True
    try:
        with traced(tdata):
            for j in range(t["trace_waves"]):
                wave = make_wave(ctx, k + j, sizes)
                sync(ctx.device)
                with record_function("bench.wave"):
                    serve(ctx, engine_cls, request_cls, params, wave)
    finally:
        StampList.mark = False
    out = dict(tdata, **summarize_trace(tdata, "bench.wave"))
    toks = sorted(a for a, _ in span_bounds(tdata["spans"], "bench.token"))
    pre, dec = [], []
    for a, b in span_bounds(tdata["spans"], "bench.wave"):
        inside = [x for x in toks if a <= x <= b]
        if inside:
            pre.append((a, inside[0]))
            dec.append((inside[0], b))
    out["prefill_intervals"] = pre
    kern = tdata["kernels"]
    dec_len = sum(b - a for a, b in dec)
    printed = {
        "decode_idle_share": (1 - sum(busy_in(kern, a, b) for a, b in dec)
                              / dec_len) if dec_len else None,
        "launches_per_wave": {
            n: sum(r[0] == n for r in tdata["reports"]) / t["trace_waves"]
            for n in sorted({r[0] for r in tdata["reports"]})}}
    least = sum(least_seconds(*_decode_least(r), BF16_FLOPS, HBM_BYTES)
                for r in tdata["reports"] if r[0] == "flash_decode")
    fd_s = kernel_seconds(kern, ("fd_kernel",))
    printed["flash_decode_roofline_pct"] = (100 * least / fd_s
                                            if fd_s and least else None)
    out["printed"] = printed
    return out


def _decode_least(report):
    """(FLOPs, bytes) of a ``flash_decode`` report: one token over the
    visible rows."""
    _, reads, _, opts = report
    (b, _, h, d), elt = reads[0]
    kh = reads[1][0][2]
    kbeg, kend = opts["rows"]
    return decode_work(b, h, kh, d, kend - kbeg - 1, elt)


def sample_waves(ctx, rec) -> List[Dict]:
    """The waves compared: the one with the longest prompt, and others
    drawn from the seed, ``check_waves`` in all."""
    waves = rec["waves"]
    longest = max(range(len(waves)), key=lambda i: max(waves[i]["lens"]))
    rest = [i for i in range(len(waves)) if i != longest]
    rng = np.random.default_rng([ctx.seed % (1 << 63), 11])
    pick = rng.permutation(rest)[:ctx.traffic["check_waves"] - 1].tolist()
    return [waves[i] for i in [longest] + sorted(pick)]


def reference_gaps(ctx, waves, fp8_control: bool = False) -> Dict:
    """For every served token of ``waves`` (``gaps``): the gap by which its
    logit lies below the float32 reference's best at its position
    (teacher forced on the wave's padded prompts and the served tokens;
    0 where it is the reference's first choice); with ``fp8_control``,
    the gap of the token the float8 reference puts first there instead.
    A request served short reads an infinite gap."""
    from bench.reference import lm
    lm.exact_float32()
    c, t = ctx.c, ctx.traffic
    params = W.make_params(c, ctx.seed, ctx.device)
    vlm = c["family"] == "vlm"
    off = c["n_patches"] if vlm else 0
    n = t["new_tokens"]
    block = t["reference_rows"]
    gaps, stats = [], {}
    for w in waves:
        for r0 in range(0, len(w["prompts"]), block):
            idx = list(range(r0, min(r0 + block, len(w["prompts"]))))
            served = [w["tokens"][i] for i in idx]
            if any(len(s) != n for s in served):
                return {"gaps": [float("inf")]}
            seq = np.stack([np.concatenate([w["prompts"][i],
                                            np.asarray(s[:-1], np.int64)])
                            for i, s in zip(idx, served)])
            tok = torch.from_numpy(seq).to(ctx.device)
            pt = patches(ctx, w["k"], len(w["prompts"]))[idx] if vlm \
                else None
            groups = lm.routing_groups(c, off + w["p"], n - 1) \
                if c.get("n_experts") else [seq.shape[1] + off]
            at = torch.arange(off + w["p"] - 1, off + w["p"] - 1 + n,
                              device=ctx.device)
            with torch.no_grad():
                h, _ = lm.hidden(params, c, tok, pt, groups, stats=stats)
                ref = lm.logits(params, c, h[:, at])
                want = torch.tensor(served, device=ctx.device)
                if fp8_control:
                    h8, _ = lm.hidden(params, c, tok, pt, groups, fp8=True)
                    want = lm.logits(params, c, h8[:, at], fp8=True
                                     ).argmax(-1)
                got = ref.gather(-1, want[..., None])[..., 0]
                gaps += (ref.amax(-1) - got).flatten().tolist()
            del h, ref
    out = {"gaps": gaps}
    if stats:
        out["moe_dropped_share"] = stats["dropped"] / stats["pairs"]
    return out


def gap_numbers(gaps: List[float]) -> Dict[str, float]:
    """What a serving cell may compare: the widest gap, the mean gap and
    the share of served tokens that are not the reference's first
    choice."""
    g = np.asarray(gaps, dtype=np.float64)
    return {"max_gap": float(g.max()), "mean_gap": float(g.mean()),
            "share_off": float((g > 0).mean())}


def check(ctx, rec) -> Dict:
    """The numbers that the cell's limits file names."""
    waves = sample_waves(ctx, rec)
    rec["waves_checked"] = [w["k"] for w in waves]
    ref = reference_gaps(ctx, waves)
    if "moe_dropped_share" in ref:
        rec["printed"]["moe_dropped_share"] = ref["moe_dropped_share"]
    nums = gap_numbers(ref["gaps"])
    rec["printed"]["gaps"] = nums
    return {k: nums[k] for k in ctx.limits}
