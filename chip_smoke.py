"""Build and drive the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

1. the card's name and power limit (``nvidia-smi``); no card -> exit 1;
2. build every kernel (``graph_prop_fwd``, ``graph_prop_bwd``,
   ``flash_attention_fwd``, ``flash_decode``, ``mlstm_chunk``,
   ``mamba_scan``, ``sim_step``) with ``nvcc`` for ``sm_90a``, one ``nvcc``
   per source, all started together;
3. each kernel against its plain PyTorch version on the card: the forward
   at atol = rtol = 1e-5, the backward against ``graph_prop_vjp_plain`` at
   the reference's gradient tolerance (atol 1e-4, rtol 1e-3) and bit for
   bit against a second launch; then both graph-propagation kernels on the
   edge cases at every hidden-slice count of ``ops.launch_plan`` (N in
   {1, 3, 5, 9, 16}; every other graph all-masked as the training ring
   holds an empty slot, rows without a predecessor, every row observed, no
   row observed; levels 0, 1, 8 and 64), one launch per call, repeats bit
   for bit equal; then ``sim_step``: engines driven on the card (each paper
   job alone at J = 1, two stepped runs on ``node_failure``; the 24 (job,
   scenario) pairs of the four jobs and six default scenarios at J = 24,
   one stepped run and one ``run_full``; failures injected) with every
   launch made twice and through the plain version on the same inputs, all
   bit for bit equal, and no FFMA in the kernel's SASS (``cuobjdump``)
   but the Newton steps of its IEEE divisions;
4. the decision path of the four paper jobs (LR, MPC, K-Means, GBT): a
   context encoder on the card, a seeded simulated cluster, 3 profiling
   runs, then one normal and one failure-injected adaptive run with
   ``EnelScaler.recommend`` (``candidate_stride=2``) at every decision
   boundary; the model has ``init_enel`` weights from a seeded
   ``torch.Generator``.  Each decision must launch the forward kernel
   exactly once, and the largest sweep of each job is held against the
   plain route on the card; then every decision's sweep runs again through
   ``graph_prop_plain`` and picks again: a pick that differs is printed
   with its totals' margin to the target and fails the run unless that
   margin is within 1e-5 of the target (``PickRecorder``);
5. timings at the LR decision shape (B = 378, N = 16, levels = 3): the
   forward kernel as CUDA events over back-to-back launches and per call in
   a CUDA graph (``graph_ms``), beside its bound, its plain version and its
   ``ptxas -v`` registers and spills; and the per-decision latency of
   ``recommend``;
6. the training path of the four jobs: ``JobExperiment.profile`` (10
   profiling runs, a scratch fit on the resident ring), 6 adaptive Enel
   runs (the 5th retrains from scratch), one failure-injected Enel run and
   one Ellis run; then a K-Means experiment under chaos (NaN graphs, ring
   corruption, NaN params).  Enel decides through the experiment's
   ``DecisionService`` (the sparse-edge engine, plain ops): one dispatch
   per decision, no fallback outside the chaos run and guardrail
   fallbacks inside it.  Both kernels must launch once per Adam step; no
   step is skipped outside the chaos run, scratch fits end below their
   first-step loss, picks lie in [4, 36], and the chaos run quarantines
   rows and has finite params again after its scratch retrain.  Then every
   service decision is replayed through the dense kernel route on its
   unpadded sweep (one ``graph_prop_fwd`` launch each, counted from 0 and
   reported as ``check_launches``, not as a path's) and picked again: the
   service's totals must equal the dense ones within 1e-5 relative, a
   pick that differs fails the run unless its margin is within 1e-5 of the
   target, and a guardrail fallback must replay non-finite;
7. timings of the training path: both kernels at the scratch shape (B =
   96, N = 8, levels = 8), back to back and in a CUDA graph, beside their
   bounds, their plain versions and their registers and spills; fit wall
   seconds (scratch, fine-tune) per job with the device-busy share of one
   scratch fit, and each run's runtime against the target (Enel vs Ellis);
8. the LM attention kernels against their plain versions on the card:
   ``mha`` on ``tests/test_kernels.py``'s sweep in float32 (atol = rtol =
   2e-5) and bfloat16 (3e-2), plus qwen3-0.6b's shapes (B = 8, S up to
   1024, H = 16, Kh = 8, D = 128, bf16), jamba's (H = 32, Kh = 8, D =
   128), a D = 256 case with window and softcap, and the tensor-core
   route's own cases (S = 812 and 1000, ragged against its 128-row and
   128-key tiles; kv_len < S); ``decode_attn`` on that file's decode sweep
   plus the models' shapes (B = 8, cache 2048, pos near 0, mid-cache and at
   the end, with and without a window; H = 16 and 32) and split-K's own
   cases (1023, 1024 and 1025 visible keys around a chunk boundary of
   ``split_plan``; windows that end inside a chunk); every case launched
   twice, bit for bit equal;
9. the serving path: ``ServeEngine`` over the full qwen3-0.6b config (28
   layers, bf16, seeded ``init_model`` weights, ``max_len`` = 2048) serves
   two waves of 8 requests (prompt lengths in [128, 1024] from
   ``np.random.RandomState(SEED)``, 64 new tokens each), each wave twice.
   ``flash_attention_fwd`` must launch 28 times per prefill and
   ``flash_decode`` 28 times per decode step; every token is in range and
   both runs of a wave give the same tokens.  Then, teacher-forced, the
   logits of ``decode_step`` at positions P..P+3 against ``forward``'s at
   the same positions (relative to the largest logit: 5e-2 in bf16, and
   the reference's 5e-3 with the weights in float32);
10. timings of the serving path: each LM kernel at the main path's shapes
   (the decode kernel with its caches cold in L2, as the loop finds them)
   beside its bound, its plain version and one
   ``scaled_dot_product_attention`` call (``library_ms``, a yardstick the
   port never calls), as CUDA events over back-to-back calls and over the
   replay of a CUDA graph of them (the kernel's own time when the host's
   launch cost exceeds it), with each kernel's registers and spills from
   ``ptxas -v``; prefill latency, decode ms per step, tokens/s and the
   device-busy share of a prefill and of the decode loop;
11. the mLSTM kernel against its plain version on the card: ``mlstm`` on
   ``tests/test_kernels.py``'s mLSTM sweep and a ragged last kernel chunk in
   float32 and bfloat16, at xlstm-350m's shapes (B = 8, S in {256, 768,
   1024}, H = 4, D = 256, bf16; S = 768 also in float32), and the bf16
   tensor-core route's own cases (S = 48, 96 and 1000, ragged against its
   64-row chunk; D in {16, 64, 256} with |den| < 1 at almost every row, an
   intra-chunk m_t, and a state that decays to 0), h and the final state
   (C, n, m), every case launched twice, bit for bit equal;
12. the xLSTM serving path: ``ServeEngine`` over the full xlstm-350m config
   (24 layers: 21 mLSTM, 3 sLSTM; d 1024, 4 heads of 256, bf16, seeded
   ``init_model`` weights, ``max_len`` = 2048) serves two waves of 8
   requests (prompt lengths from ``np.random.RandomState(SEED)`` in [128,
   1024], the longest 1024 in wave 0 and 768 in wave 1, since the mLSTM's
   chunk contract needs a padded length of at most 256 or a multiple of
   256; 64 new tokens each), each wave twice.  ``mlstm_chunk`` must launch
   21 times per wave (per prefill, none in the decode steps) and no other
   kernel at all; every token is in range and both runs of a wave give the
   same tokens.  Then, teacher-forced over wave 0's 1024 tokens, in bf16
   and with the weights in float32, each against a fixed limit: every one
   of the 24 mixers alone, on the inputs the model gives it, steps from its
   prefill state over 768 tokens to positions 768..771 within 1e-4
   (float32) or two bf16 steps (2^-6) of its largest output of the
   full-sequence form; and on the model's first four layers (mLSTM,
   mLSTM, sLSTM, mLSTM) ``decode_step``'s logits at 768..771 after a
   prefill of 768 match ``forward``'s within 5e-2 (bf16) / 5e-3 (float32)
   of the largest logit.  The same difference over all 24 layers, and
   that between two forwards of the same tokens over 768 and 1024
   positions, are printed only: with random weights the model amplifies a
   rounding difference over its depth and sequence
   (``tools/xlstm_rounding.py``);
13. timings of the xLSTM path: ``mlstm_chunk`` at wave 0's prefill shape,
   in a CUDA graph and back to back, beside its bound, its plain version
   (no PyTorch call computes the chunkwise mLSTM, so no library time) and
   its registers and spills; prefill latency, decode ms per step,
   tokens/s, kernels per prefill and per step and the device-busy share of
   each;
14. the Mamba scan kernel against its plain version on the card:
   ``selective_scan`` on ``tests/test_new_substrate.py``'s sweep (decay in
   (0.5, 1)), at jamba's prefill shapes (B = 8, S in {768, 1024}, D =
   8192, N = 16) with dt up to 1.0, where the TPU kernel's chunk form
   overflows, and at D = 300, S = 77 for every N (a ragged block of
   channels, a ragged tile of steps); x in float32 and bf16; y and the
   final h within 1e-5 of their largest value; every case launched twice,
   bit for bit equal;
15. the jamba serving path, on jamba-v0.1-52b cut to one period (8 of 32
   layers: Mamba at 0-3 and 5-7, attention at 4, MoE FFNs at the odd
   layers; every other field as published; bf16, seeded ``init_model``
   weights, ``max_len`` = 2048; the whole 52 B model does not fit one
   card).  First, with no bf16 model resident, the first 5 layers in
   float32: teacher-forced ``decode_step`` logits at 768..771 after a
   prefill of 768 against ``forward``'s over 1024 tokens (B = 2, capacity
   factor 16 so that nothing is dropped) within the reference's 5e-3 of
   the largest logit.  Then ``ServeEngine`` serves two waves of 8 requests
   (the longest prompt 1024 and 896: the MoE's routing groups need a
   padded length of at most 1024 or a multiple of it; 64 new tokens
   each), each twice: ``mamba_scan`` must launch 7 times per wave (per
   prefill, none in decode), ``flash_attention_fwd`` once per prefill,
   ``flash_decode`` once per step, no other kernel; every token in range
   and both runs of a wave alike; peak device memory printed.  Then each
   of the 7 Mamba mixers alone on its real inputs steps from its prefill
   state over 768 tokens within 1e-4 (float32) / 2^-6 (bf16) of its
   largest full-sequence output, and the bf16 model's teacher-forced
   logits (all 8 layers, B = 2, capacity 16) hold 5e-2 at the rows whose
   top-2 experts agree in every MoE layer between decode and forward (a
   bf16 rounding difference can flip two nearly tied experts; at most a
   quarter of the rows may be left out, and the flips are printed);
16. timings of the jamba path: ``mamba_scan`` at wave 0's prefill shape,
   in a CUDA graph and back to back, beside its bound, the floor that its
   precise exponentials set on the SFU pipe, its plain version (no PyTorch
   call computes the selective scan) and its registers and spills;
   prefill latency, decode ms per step, tokens/s, the kernels of one
   prefill and one step and the device-busy share of each;
17. the decision service on the card, over phase 6's four experiments:
   the four jobs' requests at their last boundary share one bucket and go
   to one ``decide`` (one dispatch at the J = 4 rung), those at their first
   boundary make three groups; every row must give the pick of the same
   request alone (J = 1) and its totals within 1e-6 relative; the
   double-buffered and synchronous modes must agree bit for bit; a
   ``DispatchChaos`` burst must cause retries, a breaker trip and a
   half-open probe that closes the breaker, each ``decision.fallback``
   span linked to a recorded cause; a short K-Means protocol (3 profiling
   runs, two Enel runs) with ``ENEL_OBS`` on, off and on again must give
   bit-equal picks and totals and add no dispatch signature once warm; no
   kernel launches on the service's path.  Printed: span counts, and
   ``decide`` per request at J = 1 and J = 4 (host clock, ending in its
   one copy per group), kernels per dispatch and the device-busy share of
   one dispatch, beside ``recommend``'s median from phase 5;
18. fleet campaigns on the card: eight experiments (the four jobs, each
   with seeds SEED and SEED + 1, ``candidate_stride=2``, ``profile(10)``
   with its 128-step scratch fit) share one ``DecisionService``.  A 3-run
   ``adaptive_campaign``: the decisions of a round go to one ``decide``
   (same-bucket rows on the job axis, up to the J = 8 rung), so some are
   batched away; ``decisions`` equals the runs' decide calls; picks in
   [4, 36]; no fallback, no skipped step; ``graph_prop_fwd`` and
   ``graph_prop_bwd`` launch exactly once per Adam step (counted from 0
   before the fleet is built; none on the service path).  A second fleet,
   built the same way, runs the campaign with a checkpoint every round
   and crashes in the middle of run 2; its last checkpoint is pickled,
   loaded back (and once more in a CPU-only process) and resumed: the
   trace (runtime and violation as float32, scale-outs, failures,
   rescales, fallbacks, shed) equals the first fleet's, which took no
   checkpoint.  From the profiled state, ``adaptive_campaign_resilient``
   through crashes at rounds 2 and 5 gives 2 restores and the same
   trace; an ``arrival_campaign`` (pool 96, rate 1.5, seed SEED, 64
   rounds) completes every job, keeps ``pool_used <= pool_size`` and caps
   some decisions, and a crash at round 5 resumed from its last
   checkpoint gives the same stats and capacity rows.  Printed beside the
   card: a round's wall time and the device-busy share of a round where
   all 8 decide, ``decide`` per request at the largest J, a checkpoint's
   make / pickle / restore time and size, fit seconds and the phase's;
19. the vectorized fleet engine on the card: (a) ``BatchedClusterSim`` on
   the card against ``NumpySimBackend`` on the host, records bit for bit
   (each paper job alone, two runs on ``node_failure`` with random rescale
   schedules; four jobs under four scenarios; ``run_full`` of the 24 (job,
   scenario) pairs against stepped numpy); (b) slot states taken in the
   middle of a run and restored after the engine ran on resume to the same
   records; (c) a four-job fleet (``profile(3)``, 2 adaptive runs with
   failures) under ``FleetCampaign(engine="batched")`` gives the numpy
   fleet's trace pick for pick, ``sim_step`` launching once per engine
   dispatch (one per profiling component, one per lockstep round that
   steps) and the graph kernels once per Adam step; (d) the harness:
   ``run_scenario_campaign`` on ``node_failure`` and ``multi_tenant`` and
   ``run_chaos_campaign("chaos_crashes")`` (2 restores) at the four jobs
   (``profile_runs=3``, 1 adaptive run), ``chaos_trace_identity`` (2
   runs) True, one transfer cell (``baseline`` 1.0 -> ``node_failure``
   1.6, K-Means).
   Launches of (c) and (d) count from 0 and each equals one dispatch.
   Printed beside the card: ``sim_step`` in a CUDA graph and back to back
   at J = 4, 8 and 32 (S = 5) beside its bound, the launch floor and its
   plain version; a fleet step's wall time (enqueue, kernel wait + copy,
   records) beside ``NumpySimBackend.step`` on the same requests; a
   32-job ``run_full`` beside numpy; each campaign's compliance, rescales,
   failures, decisions per second and wall time; the phase's seconds;
20. the fused campaign (``repro_torch.core.campaign_kernel``) on the card:
   8 experiments (the four jobs, each with seeds SEED and SEED + 1,
   ``candidate_stride=2``; ``node_failure`` on the SEED + 1 half) on one
   shared batched engine, ``profile(3)`` and two live adaptive runs,
   then ``nan_fit`` chaos on K-Means SEED + 1; one plan of 3 runs (66
   steps at ``c_max`` 22: fine-tunes after runs 1 and 2, the cadence's
   scratch fit after run 3, the chaos job poisoned after run 2; sweeps of
   18 candidates x 24 components; 96-row rings).  (a) ``run_fused``, enqueued
   under ``torch.cuda.set_sync_debug_mode("error")`` (its copies to the
   host after the loop excepted), and ``run_stepped`` give bit-equal
   outputs and carry;
   (b) per driver ``sim_step`` launches once per step and both graph
   kernels once per Adam step (none for the decisions, which run the
   sparse engine in plain ops), counted from 0; (c) no non-finite pick,
   fallbacks on the chaos job, picks in [4, 36]; (d) the fused schedule
   replayed through ``run_full`` on the fleet restored to its state
   before the plan gives the same stage runtimes and clocks bit for bit; (e)
   ``fused_campaign`` with a checkpoint every run, its last checkpoint
   pickled, loaded and resumed, equals the single pass (outputs, stats);
   (f) after the write-back ``adaptive_round`` runs run 9 with finite
   runtimes.  Printed beside the card: the wall time of both drivers and
   of the same fleet's live ``adaptive_campaign(3)``, the host's enqueue
   ms per step without a fit and per Adam step, the device-busy share of
   the step body (run 1's steps before its fit), the launches and the
   phase's seconds;
21. a ``{"kernels": [...]}`` line, then the device line last.

Imports torch, numpy and the port (``src/repro_torch``) only.
"""
from __future__ import annotations

import itertools
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 0
JOB_KEYS = ("lr", "mpc", "kmeans", "gbt")
ATOL = RTOL = 1e-5          # float32: FMA contraction + shuffle-tree sums
ATOL_BWD, RTOL_BWD = 1e-4, 1e-3   # the reference's gradient tolerance
FP32_FLOPS = 67e12          # H100 SXM, fp32 outside the tensor cores
BF16_FLOPS = 989e12         # H100 SXM, dense bf16 tensor cores
HBM_BYTES = 3.35e12         # H100 SXM HBM3
REPS = 30


def say(*parts) -> None:
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def close(a: torch.Tensor, b: torch.Tensor, what: str, atol: float = ATOL,
          rtol: float = RTOL) -> float:
    torch.testing.assert_close(a, b, atol=atol, rtol=rtol, msg=lambda m:
                               f"{what}: {m}")
    return float((a - b).abs().max()) if a.numel() else 0.0


EDGE_KINDS = ("ring", "no_pred", "all_obs", "no_obs")


def random_inputs(rng, b, n, device, kind="random"):
    """(x, adj, m_obs, valid) of ``b`` random graphs of ``n`` nodes; with
    ``kind`` an edge case: ``ring``, every other graph all-masked as the
    training ring holds an empty slot (x lifted from ``empty_graph`` as the
    model lifts it, no edge, nothing observed, zero metrics); ``no_pred``,
    most rows without a predecessor; ``all_obs`` / ``no_obs``, every / no
    row observed."""
    x = rng.randn(b, n, 30).astype(np.float32)
    adj = np.tril(rng.rand(b, n, n) < 0.35, -1)
    adj[:, min(1, n - 1), :] = False             # rows with no predecessor
    valid = rng.rand(b, n) < 0.4                 # observed rows
    m = rng.rand(b, n, 5).astype(np.float32)
    if kind == "ring":
        from repro_torch.core import model
        from repro_torch.core.graph import empty_graph, stack_graphs
        flat = {k: torch.as_tensor(v) for k, v in
                stack_graphs([empty_graph(n)]).items()}
        _, _, ex, eadj = model._prelude(flat)
        x[1::2], adj[1::2] = ex.numpy(), eadj.numpy()
        valid[1::2], m[1::2] = False, 0.0
    elif kind == "no_pred":
        adj &= rng.rand(b, n, 1) < 0.25
    elif kind == "all_obs":
        valid[:] = True
    elif kind == "no_obs":
        valid[:] = False
    return tuple(torch.tensor(a, device=device) for a in (x, adj, m, valid))


def median_ms(fn, burst: int, reps: int = REPS, warmup: int = 5) -> float:
    """Median over ``reps`` of the CUDA-event time of ``burst`` back-to-back
    calls of ``fn``, per call, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s, e = torch.cuda.Event(True), torch.cuda.Event(True)
        s.record()
        for _ in range(burst):
            fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / burst)
    return float(np.median(times))


def median_wall_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median host wall time of ``fn()`` (which ends in a host copy)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def raw_launcher(ops, params, x, adj, m, valid, levels):
    """The kernel's C entry with its pointers bound once, launching on the
    current stream.  Back-to-back calls cost the host a few microseconds
    each, so CUDA events time the kernel rather than the wrapper's Python
    checks; a kernel shorter than that is timed in a CUDA graph
    (:func:`graph_ms`)."""
    fn = ops._kernel_fn()
    b, n = x.shape[:2]
    plan = ops.launch_plan(n, levels)
    e = torch.empty((b, n, n), dtype=torch.float32, device=x.device)
    mh = torch.empty((b, n, 5), dtype=torch.float32, device=x.device)
    ptrs = [t.data_ptr() for t in (x, adj, m, valid) + ops._weights(params)]

    def launch():        # the current stream: a CUDA graph captures its own
        rc = fn(*ptrs, e.data_ptr(), mh.data_ptr(), b, n, levels,
                *plan[:3], plan.smem_fwd,
                torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc
    return launch


def bwd_raw_launcher(ops, params, x, adj, m, valid, g_e, g_m, levels):
    """The backward kernel's C entry (per-graph kernel + slot sum) with its
    pointers bound once, as :func:`raw_launcher`; the outputs it writes live
    as long as the launcher (``torch.cuda.graph`` frees cached memory before
    it captures)."""
    fn = ops._bwd_kernel_fn()
    b, n = x.shape[:2]
    plan = ops.launch_plan(n, levels)
    outs = (torch.empty_like(x), torch.empty_like(m),
            torch.empty((b, ops.N_WEIGHTS), dtype=torch.float32,
                        device=x.device),
            torch.empty(ops.N_WEIGHTS, dtype=torch.float32, device=x.device))
    ptrs = [t.data_ptr() for t in (x, adj, m, valid) + ops._weights(params)
            + (g_e, g_m) + outs]

    def launch():
        rc = fn(*ptrs, b, n, levels, *plan[:3], plan.smem_bwd,
                torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc
    launch.outputs = outs     # alive as long as the launcher
    return launch


def profile_device(fn, reps: int = 10, names=("graph_prop",)):
    """(device busy ms, {name: ms of the kernels whose name holds it},
    kernels launched), each per call of ``fn``, from a torch.profiler
    (CUPTI) trace of ``reps`` calls.  Only device events are summed: a CPU
    op also carries the device time of the kernels it launched, and those
    kernels appear again as events of their own."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    busy, kernels = 0.0, 0
    per = dict.fromkeys(names, 0.0)
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue
        t = float(getattr(ev, "self_device_time_total", 0.0) or 0.0)
        busy += t
        kernels += ev.count
        for nm in names:
            if nm in ev.key:
                per[nm] += t
    return (busy / 1e3 / reps, {nm: t / 1e3 / reps for nm, t in per.items()},
            kernels / reps)


def graph_ms(fn, calls: int = 20, reps: int = 10) -> float:
    """Device time per call of ``fn``: ``calls`` calls captured in one CUDA
    graph and replayed between CUDA events (median of ``reps``), so that the
    host's launch cost, which can exceed a short kernel's run, is not
    counted.  (A profiler trace is no substitute: it can drop kernels.)"""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return median_ms(graph.replay, burst=1, reps=reps) / calls


def top_device_kernels(fn, k: int = 6):
    """The ``k`` device kernels that take the most time in one call of
    ``fn`` (a torch.profiler trace): [(name cut to 70 characters, ms,
    launches)]."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(ev.key[:70], float(ev.self_device_time_total) / 1e3, ev.count)
            for ev in prof.key_averages()
            if getattr(ev, "device_type", None) == DeviceType.CUDA]
    return sorted(rows, key=lambda r: -r[1])[:k]


XD, HID, ED, NM = 30, 32, 16, 5     # f3 input per node, hidden, edge, metrics
N_WEIGHTS = 2 * XD * HID + HID + HID * ED + 2 * ED + (ED + NM) * HID + HID \
    + HID * NM + NM                 # 3365 floats


def graph_prop_work(b: int, n: int, levels: int):
    """(FLOPs, bytes) that eqs. 6-7 need at least for b graphs of n nodes.

    FLOPs in the least form: f3's first layer split into per-node halves
    (x_i @ W31[:30], x_j @ W31[30:]); b41 folded into the level-invariant
    h3 @ W41[:16]; f4's second layer taken per node, m_i = S_i @ W42 +
    (sum_j e_ij) b42 with S_i = sum_j e_ij hh_ij, so no pair forms its
    message.  Bytes: inputs read once, outputs written once."""
    node = 2 * (2 * XD * HID)                    # x @ W31 halves
    pair = (2 * HID + HID                        # a_i + c_j + b31, leaky
            + 2 * HID * ED + 2 * ED              # h1 @ W32 + b32, leaky
            + 2 * ED + 5                         # logit, masked softmax
            + 2 * ED * HID + HID)                # h3 @ W41[:16] + b41
    level_node = 2 * NM * HID + 2 * HID * NM + 2 * NM   # m_j @ W41[16:],
    #                                              S_i @ W42, (sum e) b42
    level_pair = HID + HID + 2 * HID             # zz, leaky, S_i += e hh
    per_graph = node * n + pair * n * n + levels * (level_node * n
                                                    + level_pair * n * n)
    per_graph_bytes = n * XD * 4 + n * n + n * NM * 4 + n \
        + n * n * 4 + n * NM * 4
    return b * per_graph, b * per_graph_bytes + N_WEIGHTS * 4


def graph_prop_bwd_work(b: int, n: int, levels: int):
    """(FLOPs, bytes) that the VJP of eqs. 6-7 needs at least for b graphs
    of n nodes: the forward once (:func:`graph_prop_work`, every level's f4
    pre-activation kept), then per level u_i = W42 g_m_i once per node, so
    a pair's cotangents g_e_ij = hh_ij . u_i + g_m_i . b42 and g_zz_ij =
    e_ij u_i dleaky(zz_ij) cost ~64 FLOPs each; gW42 from S_i x g_m_i per
    node; the cotangent of h3 @ W41[:16] summed over the levels before its
    one matmul; gW31 and gx from per-node row and column sums of g_z1.
    Bytes: primal inputs and cotangents read once, gx, gm_obs and the
    summed weight gradients written once."""
    fwd_flops, _ = graph_prop_work(b, n, levels)
    level_node = (2 * HID * NM + 2 * NM          # u_i, g_m_i . b42
                  + 2 * HID * NM + 2 * NM        # gW42 += S_i x g_m_i, gb42
                  + HID                          # gb41
                  + 2 * NM * HID + 2 * HID * NM  # gW41[16:], g_m_j
                  + 2 * NM)                      # g_m_obs, carry
    level_pair = (2 * HID + 1                    # g_e_ij
                  + 2 * HID                      # g_zz_ij
                  + HID + HID)                   # sum over levels, over i
    pair = (1 + 5 + 2 * ED                       # g_e, softmax, g_attn
            + 2 * ED + 2 * HID * ED + ED         # g_h3
            + 2 * ED * HID                       # gW41[:16]
            + 2 * HID * ED + ED                  # gW32, gb32
            + 2 * ED * HID + HID + HID           # g_z1, gb31
            + 2 * HID)                           # row, column sums of g_z1
    node = 2 * (2 * XD * HID) + 2 * (2 * XD * HID) + XD   # gW31, gx
    per_graph = levels * (level_node * n + level_pair * n * n) \
        + pair * n * n + node * n
    per_graph_bytes = (n * XD * 4 + n * n + n * NM * 4 + n  # primal inputs
                       + n * n * 4 + n * NM * 4             # cotangents
                       + n * XD * 4 + n * NM * 4)           # gx, gm_obs
    return (fwd_flops + b * per_graph,
            b * per_graph_bytes + 2 * N_WEIGHTS * 4)


class SweepRecorder:
    """Wraps ``trainer.predict_sweep_device`` to keep the largest sweep of a
    job (inputs and the kernel route's (C, K) output)."""

    def __init__(self, trainer):
        self.inner = trainer.predict_sweep_device
        self.largest = None
        trainer.predict_sweep_device = self

    def __call__(self, template, deltas, use_kernel=None):
        out = self.inner(template, deltas, use_kernel)
        if self.largest is None or out.numel() > self.largest[2].numel():
            self.largest = (template, {k: np.array(v) for k, v in
                                       deltas.items()}, out.clone())
        return out


def sweep_flat(template, deltas, device):
    from repro_torch.core import model
    flat = model.assemble_sweep_batch(
        template.base, torch.as_tensor(template.h_onehot, device=device),
        {k: torch.as_tensor(v, device=device) for k, v in deltas.items()})
    return flat, min(model.MAX_LEVELS, max(1, template.levels))


def sweep_plain(params, template, deltas, device) -> torch.Tensor:
    """The sweep's (C, K) totals with eqs. 6-7 in the plain version."""
    from repro_torch.core import model
    from repro_torch.kernels.graph_prop import ops
    flat, levels = sweep_flat(template, deltas, device)
    a_vec, z_vec, x, adj = model._prelude(flat)
    e, m_hat = ops.graph_prop_plain(params, x, adj, flat["metrics"],
                                    flat["metrics_valid"], levels=levels)
    out = model._readout(params, flat, a_vec, z_vec, adj, e, m_hat, levels)
    return out["total_runtime"].reshape(deltas["a_raw"].shape[:2])


PICK_RTOL = 1e-5        # a pick may differ only where float32 rounding can
SPARSE_RTOL = 1e-5      # service (sparse engine) totals vs the dense route


class PickRecorder:
    """Every decision's sweep on the kernel route: its inputs, the (C, K)
    output, the candidates, elapsed time, target and pick, with the params
    it was made under (a copy, taken again after each fit).  ``compare``
    runs each sweep again through ``graph_prop_plain`` and picks again.

    ``watch_service`` records every ``DecisionService.decide`` instead (the
    request, its answer and a copy of the params): ``compare`` replays each
    service decision through the dense kernel route (``graph_prop_fwd``) on
    the unpadded sweep and picks again, the card's sparse == dense check.
    A guardrail fallback's replay must be non-finite too."""

    def __init__(self):
        self.records, self._pending, self._snaps = [], None, {}
        self.service_records = []
        from repro_torch.core import scaling
        self._scaling = scaling
        self._inner_pick = scaling._totals_pick

    def watch(self, trainer, label):
        inner = trainer.predict_sweep_device

        def sweep(template, deltas, use_kernel=None):
            out = inner(template, deltas, use_kernel)
            self._pending = (label, trainer, template,
                             {k: np.array(v) for k, v in deltas.items()},
                             out)
            return out
        trainer.predict_sweep_device = sweep

    def watch_service(self, service, label):
        inner = service.decide

        def decide(requests):
            results = inner(requests)
            from repro_torch.core.training import map_params, param_leaves
            for req, res in zip(requests, results):
                key = tuple((id(t), t._version)
                            for t in param_leaves(req.params))
                if key not in self._snaps:
                    self._snaps = {key: map_params(torch.clone, req.params)}
                self.service_records.append((label, self._snaps[key], req,
                                             res))
            return results
        service.decide = decide

    def __enter__(self):
        def pick(per_comp, cand, cand_valid, elapsed, target):
            packed = self._inner_pick(per_comp, cand, cand_valid, elapsed,
                                      target)
            label, tr, template, deltas, out = self._pending
            key = (id(tr), tr.adam_steps)
            if key not in self._snaps:
                from repro_torch.core.training import map_params
                self._snaps = {key: map_params(torch.clone, tr.params)}
            self.records.append((label, self._snaps[key], template, deltas,
                                 cand, cand_valid, elapsed, target, packed))
            return packed
        self._scaling._totals_pick = pick
        return self

    def __exit__(self, *exc):
        self._scaling._totals_pick = self._inner_pick

    def compare(self, device):
        """(decisions, differing picks); each differing pick is printed with
        its margin to the target (relative), and the run fails unless that
        margin is within PICK_RTOL."""
        differ = 0
        for idx, (label, params, template, deltas, cand, cand_valid,
                  elapsed, target, packed) in enumerate(self.records):
            plain = sweep_plain(params, template, deltas, device)
            again = self._inner_pick(plain, cand, cand_valid, elapsed, target)
            differ += check_pick(f"{label} decision {idx}", cand,
                                 float(target), int(packed[0]),
                                 packed[1:].cpu(), int(again[0]),
                                 again[1:].cpu(), ("kernel", "plain"))
        return len(self.records), differ

    def compare_service(self, device):
        """(decisions replayed, differing picks, guardrail fallbacks, largest
        totals difference): every recorded service decision again through
        the dense kernel route on its unpadded sweep, picked again as
        ``recommend`` picks.  The service's totals must equal the dense
        ones within SPARSE_RTOL relative."""
        from repro_torch.core import model
        differ = fallbacks = 0
        worst = 0.0
        for idx, (label, params, req, res) in \
                enumerate(self.service_records):
            c, k = len(req.candidate_list), req.n_components
            deltas = {kk: torch.as_tensor(np.ascontiguousarray(v[:c, :k]),
                                          device=device)
                      for kk, v in req.deltas.items()}
            per = model.sweep_per_component(
                params, {kk: v[:k] for kk, v in req.base.items()},
                req.h_onehot[:k], deltas,
                levels=min(model.MAX_LEVELS, req.levels))
            cand = torch.as_tensor(req.candidates[:c], device=device)
            again = self._inner_pick(
                per, cand, torch.ones(c, dtype=torch.bool, device=device),
                torch.tensor(np.float32(req.elapsed), device=device),
                torch.tensor(np.float32(req.target), device=device)).cpu()
            if res.fallback:
                fallbacks += 1
                assert not bool(torch.isfinite(again[1:]).all()), \
                    (label, idx, "a guardrail fallback replays finite")
                continue
            tk = torch.tensor([res.totals[s] for s in req.candidate_list])
            rel = float(((tk - again[1:]).abs() / again[1:].abs()).max())
            assert rel <= SPARSE_RTOL, (label, idx, "totals", rel)
            worst = max(worst, rel)
            differ += check_pick(f"{label} service decision {idx}",
                                 cand.cpu(), req.target,
                                 req.candidate_list.index(res.scaleout), tk,
                                 int(again[0]), again[1:],
                                 ("service", "dense kernel"))
        return len(self.service_records), differ, fallbacks, worst


def check_pick(what, cand, tgt, kp, tk, pp, tp, names) -> int:
    """1 if picks ``kp`` (of totals ``tk``) and ``pp`` (of ``tp``) differ,
    printed with the totals' margin to the target (relative); fails unless
    that margin is within PICK_RTOL.  0 if they agree."""
    if kp == pp:
        return 0
    flips = (tk <= tgt) != (tp <= tgt)
    if bool(flips.any()):
        dist = torch.cat([tk[flips], tp[flips]]) - tgt
        margin = float(dist.abs().max()) / abs(tgt)
    else:                        # least violation: two near-equal totals
        margin = float((tk[kp] - tk[pp]).abs()) / abs(tgt)
    say(f"  pick differs, {what}: {names[0]} {int(cand[kp])} (total "
        f"{float(tk[kp]):.6f}), {names[1]} {int(cand[pp])} (total "
        f"{float(tp[pp]):.6f}), target {tgt:.6f}: margin {margin:.3g} of "
        f"the target")
    assert margin <= PICK_RTOL, (what, margin)
    return 1


def run_job(job_key, device, ops, picks=None):
    from repro_torch.core.scaling import EnelScaler
    from repro_torch.core.training import EnelTrainer
    from repro_torch.dataflow import runner
    from repro_torch.dataflow.context import ContextEncoder
    from repro_torch.dataflow.simulator import ClusterSim
    from repro_torch.dataflow.workloads import JOBS, SCALEOUT_RANGE

    job = JOBS[job_key]
    encoder = ContextEncoder([job], seed=SEED, device=device)
    trainer = EnelTrainer(seed=SEED, device=device)
    recorder = SweepRecorder(trainer)
    if picks is not None:
        picks.watch(trainer, job_key)
    scaler = EnelScaler(trainer, SCALEOUT_RANGE, candidate_stride=2)
    sim = ClusterSim(seed=SEED)
    interval = 2 if job.n_components > 15 else 1
    runtimes = [runner.execute_run(sim=sim, encoder=encoder, job=job,
                                   scaler=scaler, initial_s=s,
                                   inject_failures=False).run.runtime
                for s in runner.PROFILING_SCALEOUTS[:3]]
    target = float(np.median(runtimes) * 0.95)
    s0 = scaler.initial_allocation(target, job.n_components)
    decisions = []
    for inject in (False, True):
        before = ops.LAUNCHES
        res = runner.execute_run(sim=sim, encoder=encoder, job=job,
                                 scaler=scaler, initial_s=s0,
                                 inject_failures=inject, target=target,
                                 decision_interval=interval)
        n_dec = len(res.decisions)
        assert n_dec == len(range(0, job.n_components - 1, interval)), n_dec
        assert ops.LAUNCHES - before == n_dec, (ops.LAUNCHES - before, n_dec)
        for d in res.decisions:
            lo, hi = SCALEOUT_RANGE
            assert lo <= d.pick <= hi, d.pick
            assert all(np.isfinite(t) for t in d.totals.values()), d.totals
        assert scaler.fallback_decisions == 0
        say(f"  {job.name:8s} failures={inject!s:5s} runtime="
            f"{res.run.runtime:.1f}s target={target:.1f}s "
            f"decisions={n_dec} picks={[d.pick for d in res.decisions]}")
        decisions += res.decisions
    template, deltas, kernel_out = recorder.largest
    plain_out = sweep_plain(trainer.params, template, deltas, device)
    err = close(kernel_out, plain_out, f"{job_key} largest sweep")
    c, k = kernel_out.shape
    say(f"  {job.name:8s} largest sweep C={c} K={k} B={c * k}: kernel vs "
        f"plain route max abs diff {err:.3g}")
    lat = np.array([d.seconds * 1e3 for d in decisions])
    return {"decisions": len(decisions), "largest": (c, k),
            "trainer": trainer,
            "recommend_ms_median": float(np.median(lat)),
            "recommend_ms_p90": float(np.percentile(lat, 90)),
            "sweep": (trainer.params, template, deltas)}


def run_training(job_key, device, chaos=None, picks=None):
    """One job's training path (phase 6): profile, 6 Enel runs (the 5th a
    scratch retrain), a failure-injected Enel run and an Ellis run; with
    ``chaos`` (a ChaosSpec) 6 Enel runs under fault injection instead.
    Enel decides through the experiment's ``DecisionService`` (one request
    per dispatch); ``picks`` (a PickRecorder) records every decision."""
    from repro_torch.dataflow.runner import JobExperiment
    from repro_torch.dataflow.workloads import SCALEOUT_RANGE
    from repro_torch.sim.chaos import ChaosInjector

    ex = JobExperiment(job_key, seed=SEED, device=device)
    tr = ex.trainer
    if picks is not None:
        picks.watch_service(ex.service, job_key + (
            "-chaos" if chaos is not None else ""))
    ex.profile()
    scratch = [(tr.last_fit_seconds, tr.first_step_loss, tr.last_loss)]
    tune = []
    if chaos is not None:
        ex.chaos = ChaosInjector(chaos, exp_seed=SEED)
    plan = [("enel", False)] * 6
    if chaos is None:
        plan += [("enel", True), ("ellis", False)]
    finite_after = []
    for method, inject in plan:
        st = ex.adaptive_run(method, inject_failures=inject)
        if method == "enel":
            fit = (st.fit_seconds, tr.first_step_loss, tr.last_loss)
            (scratch if tr.runs_seen % 5 == 0 else tune).append(fit)
        finite_after.append(tr.params_finite())
    lo, hi = SCALEOUT_RANGE
    for st in ex.stats:
        assert all(lo <= s <= hi for s in st.scaleouts), st.scaleouts
    svc = ex.service
    decisions = sum(st.decide_calls for st in ex.stats if st.kind == "enel")
    assert svc.dispatches == svc.decisions == decisions, \
        (svc.dispatches, svc.decisions, decisions)
    assert svc.fallback_decisions == sum(st.fallback_decisions
                                         for st in ex.stats)
    if chaos is None:
        assert tr.nonfinite_steps == 0, tr.nonfinite_steps
        for _, first, last in scratch + tune:
            assert np.isfinite(first) and np.isfinite(last), (first, last)
        for _, first, last in scratch:
            assert last < first, (job_key, first, last)
        assert svc.fallback_decisions == 0, svc.stats()
    else:
        assert svc.guardrail_trips == svc.fallback_decisions > 0, \
            svc.stats()
        c = ex.chaos
        assert c.graphs_poisoned and c.cache_rows_corrupted and \
            c.fits_poisoned, (c.graphs_poisoned, c.cache_rows_corrupted,
                              c.fits_poisoned)
        assert tr.cache.quarantined > 0 and tr.nonfinite_steps > 0
        # the 5th run retrains from scratch: finite params again
        assert finite_after[4], finite_after
        assert not all(finite_after), finite_after
    adaptive = [st for st in ex.stats if st.kind != "profiling"]
    return {"experiment": ex, "scratch": scratch, "tune": tune,
            "runs": adaptive, "decisions": decisions,
            "steps": tr.adam_steps, "quarantined": tr.cache.quarantined,
            "skipped": tr.nonfinite_steps,
            "fallbacks": svc.fallback_decisions}

SERVICE_FAST = dict(backoff_base_s=1e-4, backoff_cap_s=1e-3)
ROW_RTOL = 1e-6             # a J = 4 row against the same request at J = 1


def boundary_request(ex, next_comp):
    """One experiment's decision request at ``next_comp``, with its current
    history and params, a fresh first component as the current summary and
    the elapsed time pro rata of the target (so the pick is a choice)."""
    from repro_torch.core.graph import summary_node
    from repro_torch.dataflow import runner
    job = ex.job
    comp = ex.sim.run_component(job, 0, clock=0.0, start_scaleout=8,
                                end_scaleout=8, inject_failures=False,
                                failures_log=[])
    summ = summary_node(runner._component_nodes(ex.encoder, job, comp),
                        name="P0")
    builder = lambda ci, a, z, pr: runner._to_graph(
        runner._future_nodes(ex.encoder, job, ci, a, z), pr, ci)
    return ex.enel.prepare_request(
        graph_builder=builder, next_comp=next_comp,
        n_components=job.n_components,
        elapsed=ex.target * next_comp / job.n_components,
        current_scaleout=8, target_runtime=ex.target, current_summary=summ)


def kmeans_protocol(device, ae_params, enabled: bool):
    """A short K-Means protocol (3 profiling runs, the scratch fit, two Enel
    runs) with obs on or off: each service decision's (pick, predicted,
    totals), each run's scale-outs and runtime, the signatures it added."""
    from repro_torch import obs
    from repro_torch.core import model
    from repro_torch.dataflow.runner import JobExperiment
    before = dict(model.TRACE_COUNTS)
    decisions = []
    with obs.obs_enabled(enabled):
        ex = JobExperiment("kmeans", seed=SEED + 1, device=device,
                           ae_params=ae_params)
        inner = ex.service.decide

        def decide(requests):
            res = inner(requests)
            decisions.extend((r.scaleout, r.predicted,
                              sorted(r.totals.items())) for r in res)
            return res
        ex.service.decide = decide
        ex.profile(3)
        runs = [ex.adaptive_run("enel", inject_failures=False)
                for _ in range(2)]
    delta = {k: v - before.get(k, 0) for k, v in model.TRACE_COUNTS.items()
             if v != before.get(k, 0)}
    return [(st.scaleouts, st.runtime) for st in runs], decisions, delta


def run_service(device, card, train, ops, recommend_ms):
    """Phase 17: the decision service on the card.  Fleet batching (the four
    jobs' last boundaries share one bucket: one J = 4 group; their first
    boundaries make three groups), each row against the same request alone
    (J = 1), double-buffered against synchronous bit for bit, a
    DispatchChaos burst through retries, a breaker trip and a half-open
    probe that recovers (every fallback span linked to its cause), ENEL_OBS
    neutrality over a short K-Means protocol, span counts and timings."""
    from repro_torch import obs
    from repro_torch.core.service import DecisionService
    from repro_torch.sim.chaos import ChaosSpec, DispatchChaos
    t_phase = time.perf_counter()
    exps = [train[k]["experiment"] for k in JOB_KEYS]
    last = [boundary_request(ex, ex.job.n_components - 1) for ex in exps]
    first = [boundary_request(ex, 1) for ex in exps]
    assert len({r.bucket_key for r in last}) == 1, \
        [r.bucket_key for r in last]
    launches0 = ops.LAUNCHES

    # fleet batching: each row against the same request alone
    svc = DecisionService()
    rows = svc.decide(last)
    assert (svc.dispatches, svc.batched_away) == (1, 3), svc.stats()
    rows += svc.decide(first)
    n_groups = len({r.bucket_key for r in first})
    assert svc.dispatches == 1 + n_groups, svc.stats()
    differ = 0
    worst = 0.0
    for i, (req, row) in enumerate(zip(last + first, rows)):
        alone = DecisionService().decide([req])[0]
        assert not row.fallback and not alone.fallback
        want = torch.tensor([alone.totals[s] for s in req.candidate_list])
        got = torch.tensor([row.totals[s] for s in req.candidate_list])
        worst = max(worst, float(((got - want).abs() / want.abs()).max()))
        differ += check_pick(
            f"service row {i} (J = {len(last) if i < 4 else 'group'})",
            torch.as_tensor(req.candidates), req.target,
            req.candidate_list.index(row.scaleout), got,
            req.candidate_list.index(alone.scaleout), want,
            ("batched", "alone"))
    assert worst <= ROW_RTOL, worst
    say(f"service fleet batching: 4 last-boundary requests in one J = 4 "
        f"dispatch, 4 first-boundary requests in {n_groups} groups; each "
        f"row vs alone: {differ} picks differ, totals within {worst:.3g} "
        f"relative (limit {ROW_RTOL})")

    # double-buffered == synchronous, bit for bit
    res_b = DecisionService(double_buffer=True).decide(last + first)
    res_s = DecisionService(double_buffer=False).decide(last + first)
    for a, b in zip(res_b, res_s):
        assert (a.scaleout, a.predicted, a.totals) == \
            (b.scaleout, b.predicted, b.totals)
        assert np.array_equal(a.per_component, b.per_component)
    say("service double-buffered vs synchronous: picks, totals and "
        "per-component predictions bit-equal")

    # dispatch chaos: retries, a breaker trip, a half-open probe that heals
    rec = obs.recorder()
    rec.clear()
    chaos_svc = DecisionService(max_retries=1, breaker_threshold=2,
                                breaker_probe_after=2, **SERVICE_FAST)
    chaos_svc.fault_injector = DispatchChaos(
        ChaosSpec(name="smoke", timeout_every=3, timeout_burst=5))
    with obs.obs_enabled(True):
        fell = [chaos_svc.decide([last[2]])[0].fallback for _ in range(8)]
    assert fell == [False, False, True, True, True, True, False, False], fell
    st = chaos_svc.stats()
    assert (st["retries"], st["breaker_trips"], st["fallback_decisions"],
            st["dispatch_failures"], st["breaker_state"]) == \
        (3, 1, 4, 5, "closed"), st
    for ev in rec.events("decision.fallback"):
        cause = rec.find(ev["attrs"]["cause_seq"])
        assert cause is not None and cause["seq"] < ev["seq"], ev
        assert cause["kind"] in ("dispatch.fault", "guardrail.trip",
                                 "breaker.transition"), cause
    moves = [(e["attrs"]["src"], e["attrs"]["dst"])
             for e in rec.events("breaker.transition")]
    assert moves == [("closed", "open"), ("open", "half_open"),
                     ("half_open", "closed")], moves
    chaos_spans = rec.span_counts()
    say(f"service chaos: {st['dispatch_failures']} injected timeouts, "
        f"{st['retries']} retries, {st['breaker_trips']} breaker trip, "
        f"{st['fallback_decisions']} fallbacks each linked to its cause, "
        f"half-open probe closed the breaker; spans {chaos_spans}")

    # timings, with the memo warm
    torch.cuda.synchronize()
    t_svc = DecisionService()
    j1 = lambda: t_svc.decide([last[2]])
    j4 = lambda: t_svc.decide(last)
    j1_ms = median_wall_ms(j1)
    j4_ms = median_wall_ms(j4)
    j1_busy, _, j1_kernels = profile_device(j1)
    j4_busy, _, j4_kernels = profile_device(j4)
    j1_ms2 = median_wall_ms(j1)
    assert ops.LAUNCHES == launches0, "the sparse engine launched a kernel"
    say(f"service timing on {card}: decide at J = 1 {j1_ms:.3f} ms per "
        f"request (again {j1_ms2:.3f}), {j1_kernels:.0f} kernels per "
        f"dispatch, device busy {j1_busy:.3f} ms (busy share "
        f"{j1_busy / j1_ms:.3f}); at J = 4 {j4_ms / 4:.3f} ms per request "
        f"({j4_ms:.3f} per call, {j4_ms / j1_ms:.2f}x J = 1), "
        f"{j4_kernels:.0f} kernels, busy {j4_busy:.3f} ms (share "
        f"{j4_busy / j4_ms:.3f}); recommend (phase 5) median "
        + ", ".join(f"{k} {v:.2f}" for k, v in recommend_ms.items())
        + " ms")

    # ENEL_OBS neutrality over a short K-Means protocol
    ae = {k: v.cpu().numpy() for k, v in
          train["kmeans"]["experiment"].encoder.ae_params.items()}
    runs_on, dec_on, _ = kmeans_protocol(device, ae, True)
    runs_off, dec_off, delta_off = kmeans_protocol(device, ae, False)
    runs_on2, dec_on2, delta_on2 = kmeans_protocol(device, ae, True)
    assert len(dec_on) > 0
    assert runs_off == runs_on == runs_on2, (runs_on, runs_off, runs_on2)
    assert dec_off == dec_on == dec_on2
    assert delta_off == delta_on2 == {}, (delta_off, delta_on2)
    spans = obs.recorder().span_counts()
    phase_s = time.perf_counter() - t_phase
    say(f"service ENEL_OBS neutrality: {len(dec_on)} decisions of the "
        f"K-Means protocol bit-equal with obs on, off and on, no new "
        f"signature when warm; span counts {spans}; phase {phase_s:.1f}s")
    return {"j1_ms_per_request": j1_ms, "j1_ms_again": j1_ms2,
            "j4_ms_per_request": j4_ms / 4, "j4_ms_per_call": j4_ms,
            "kernels_per_dispatch_j1": j1_kernels,
            "kernels_per_dispatch_j4": j4_kernels,
            "busy_ms_j1": j1_busy, "busy_share_j1": j1_busy / j1_ms,
            "busy_ms_j4": j4_busy, "busy_share_j4": j4_busy / j4_ms,
            "recommend_ms_median": recommend_ms,
            "rows_max_rel_diff": worst, "rows_picks_differ": differ,
            "first_boundary_groups": n_groups, "chaos": st,
            "chaos_spans": chaos_spans, "span_counts": spans,
            "neutral_decisions": len(dec_on), "seconds": phase_s}


FLEET_SEEDS = (SEED, SEED + 1)
FLEET_RUNS = 3
FLEET_POOL = dict(pool_size=96, arrival_rate=1.5, seed=SEED, max_rounds=64)


def fleet_campaign(device, service):
    """Phase 18's fleet: the four paper jobs, each with seeds SEED and
    SEED + 1 (``candidate_stride=2``), behind one shared service."""
    from repro_torch.dataflow import FleetCampaign, JobExperiment
    return FleetCampaign([JobExperiment(key, seed=s, candidate_stride=2,
                                        device=device)
                          for key in JOB_KEYS for s in FLEET_SEEDS], service)


def fleet_trace(all_stats):
    """A campaign's trace: runtime and violation as float32, scale-outs,
    failures, rescales, fallbacks and shed requests exactly."""
    return [(np.float32(s.runtime), np.float32(s.violation),
             tuple(s.scaleouts), s.n_failures, s.n_rescales,
             s.fallback_decisions, s.shed_requests)
            for run in all_stats for s in run]


def fleet_rounds(camp, run) -> int:
    """Lockstep rounds of one campaign run: each generator takes one result
    a round, one per component and one per decision."""
    return max(ex.job.n_components + st.decide_calls
               for ex, st in zip(camp.experiments, run))


def fleet_state(camp):
    return ([ex.snapshot_state() for ex in camp.experiments],
            camp.service.snapshot_state())


def restore_fleet(camp, state) -> None:
    exps, service = state
    for ex, st in zip(camp.experiments, exps):
        ex.restore_state(st)
    camp.service.restore_state(service)


class RoundClock:
    """Times a campaign's lockstep rounds and its service's ``decide``
    calls (host wall clock), and traces with torch.profiler the third
    round in which every experiment decides (warm: the first two met new
    dispatch signatures), for its device-busy ms."""

    PROFILE_AT = 3

    def __init__(self, camp):
        from repro_torch.sim.engine import SimStepRequest
        self.camp, self.round_s, self.decide = camp, [], []
        self.busy_ms = self.profiled_ms = None
        self._all_decide = 0
        inner_round, inner_decide = camp._round, camp.service.decide

        def decide(reqs):
            t0 = time.perf_counter()
            out = inner_decide(reqs)
            self.decide.append((len(reqs), time.perf_counter() - t0))
            return out

        def rnd(gens, pending, stats, *args, **kw):
            if self.busy_ms is None and all(
                    not isinstance(r, SimStepRequest)
                    for r in pending.values()) and \
                    len(pending) == len(camp.experiments):
                self._all_decide += 1
                if self._all_decide == self.PROFILE_AT:
                    return self._profiled(inner_round, gens, pending,
                                          stats, *args, **kw)
            t0 = time.perf_counter()
            out = inner_round(gens, pending, stats, *args, **kw)
            self.round_s.append(time.perf_counter() - t0)
            return out

        camp._round, camp.service.decide = rnd, decide

    def _profiled(self, inner, *args, **kw):
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = inner(*args, **kw)
            torch.cuda.synchronize()
            self.profiled_ms = (time.perf_counter() - t0) * 1e3
        self.busy_ms = sum(
            float(getattr(ev, "self_device_time_total", 0.0) or 0.0)
            for ev in prof.key_averages()
            if getattr(ev, "device_type", None) == DeviceType.CUDA) / 1e3
        return out

    def close(self) -> None:
        del self.camp._round
        del self.camp.service.decide


def run_fleet(device, card, ops):
    """Phase 18: fleet campaigns on the card.  Eight experiments (four jobs
    x two seeds) share one DecisionService: a 3-run adaptive campaign
    (launches counted from 0: both graph kernels once per Adam step, none
    on the service path), a second fleet built the same way crashed in run
    2 with a checkpoint every round and resumed from its last checkpoint
    (pickled, loaded back, and loaded again in a CPU-only process), a
    resilient 2-run campaign through two crashes, and a multi-tenant
    arrival campaign, crashed at round 5 and resumed; every resumed trace
    equals the uninterrupted one exactly."""
    import os
    import tempfile
    from repro_torch.core.service import DecisionService
    from repro_torch.dataflow.fleet import CampaignCheckpoint
    from repro_torch.dataflow.workloads import SCALEOUT_RANGE
    t_phase = time.perf_counter()

    # the campaign; only its launches count
    ops.LAUNCHES = ops.LAUNCHES_BWD = 0
    a = fleet_campaign(device, DecisionService())
    t0 = time.perf_counter()
    a.profile(10)
    torch.cuda.synchronize()
    profile_s = time.perf_counter() - t0
    scratch_s = [ex.trainer.last_fit_seconds for ex in a.experiments]
    base = fleet_state(a)
    clock = RoundClock(a)
    t0 = time.perf_counter()
    stats, _ = a.adaptive_campaign(FLEET_RUNS, "enel")
    torch.cuda.synchronize()
    campaign_s = time.perf_counter() - t0
    clock.close()
    launches, launches_bwd = ops.LAUNCHES, ops.LAUNCHES_BWD
    steps = sum(ex.trainer.adam_steps for ex in a.experiments)
    svc = a.service
    dispatches, batched_away = svc.dispatches, svc.batched_away
    decisions = sum(st.decide_calls for run in stats for st in run)
    assert launches_bwd == steps > 0, (launches_bwd, steps)
    assert launches == steps, (launches, steps, decisions)
    assert svc.decisions == decisions > 0, (svc.decisions, decisions)
    assert svc.batched_away > 0, svc.stats()
    assert svc.fallback_decisions == 0 and svc.shed_requests == 0, \
        svc.stats()
    assert sum(ex.trainer.nonfinite_steps for ex in a.experiments) == 0
    lo, hi = SCALEOUT_RANGE
    for run in stats:
        for st in run:
            assert all(lo <= s <= hi for s in st.scaleouts), st.scaleouts
            assert st.fallback_decisions == 0, st
    rounds = [fleet_rounds(a, run) for run in stats]
    assert clock.busy_ms is not None, "no round where all 8 decide"
    assert sum(rounds) == len(clock.round_s) + 1, (rounds, clock.round_s)
    tune_s = [st.fit_seconds for run in stats for st in run]
    j_max = max(n for n, _ in clock.decide)
    at_j = [s for n, s in clock.decide if n == j_max]
    decide_ms = float(np.median(at_j)) * 1e3 / j_max
    round_ms = float(np.median(clock.round_s)) * 1e3
    say(f"fleet campaign on {card}: 8 experiments, {FLEET_RUNS} runs in "
        f"{sum(rounds)} lockstep rounds ({rounds}), {campaign_s:.2f}s; "
        f"{decisions} decisions in {dispatches} dispatches "
        f"({batched_away} batched away); {steps} Adam steps, "
        f"graph_prop_fwd {launches} and graph_prop_bwd {launches_bwd} "
        f"launches (none on the service path); no fallback, no skipped "
        f"step; picks in [{lo}, {hi}]")
    say(f"fleet timing on {card}: a round {round_ms:.2f} ms median "
        f"(wall, {campaign_s / sum(rounds) * 1e3:.2f} ms mean with the "
        f"fits); a round where all 8 decide {clock.profiled_ms:.2f} ms "
        f"traced, device busy {clock.busy_ms:.3f} ms (busy share "
        f"{clock.busy_ms / clock.profiled_ms:.3f}); decide at J = {j_max} "
        f"{decide_ms:.3f} ms per request; fits: scratch "
        f"{np.median(scratch_s):.3f}s median (profile {profile_s:.1f}s for "
        f"8), fine-tune {np.median(tune_s):.3f}s median")

    # crash in run 2, resume from the last checkpoint
    b = fleet_campaign(device, DecisionService())
    b.profile(10)
    for xa, xb in zip(a.experiments, b.experiments):
        for k, v in xa.encoder.ae_params.items():
            assert torch.equal(v, xb.encoder.ae_params[k]), k
    crash_at = rounds[0] + rounds[1] // 2
    made = []
    inner_make = b._make_checkpoint

    def make(*args, **kw):
        t0 = time.perf_counter()
        out = inner_make(*args, **kw)
        made.append(time.perf_counter() - t0)
        return out
    b._make_checkpoint = make
    out, ckpts = b.adaptive_campaign(FLEET_RUNS, "enel", checkpoint_every=1,
                                     stop_after_round=crash_at)
    del b._make_checkpoint
    last = ckpts[-1]
    assert out is None and last.mid_run, (out, last.mid_run)
    assert (last.round_idx, last.run_idx) == (crash_at, 1), \
        (last.round_idx, last.run_idx)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "campaign.ckpt")
        t0 = time.perf_counter()
        last.save(path)
        save_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        loaded = CampaignCheckpoint.load(path)
        load_s = time.perf_counter() - t0
        cpu_env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
                       PYTHONPATH=str(ROOT / "src"))
        probe = subprocess.run(
            [sys.executable, "-c",
             "import pickle, sys, torch\n"
             "assert not torch.cuda.is_available()\n"
             "ck = pickle.load(open(sys.argv[1], 'rb'))\n"
             "print(ck.round_idx, len(ck.exps))", path],
            env=cpu_env, capture_output=True, text=True, timeout=300)
        assert probe.returncode == 0, probe.stderr
        assert probe.stdout.split() == [str(crash_at), "8"], probe.stdout
    entered = []
    inner_loop = b._campaign_loop

    def loop(*args, **kw):
        entered.append(time.perf_counter())
        return inner_loop(*args, **kw)
    b._campaign_loop = loop
    t0 = time.perf_counter()
    resumed, _ = b.resume_adaptive_campaign(loaded)
    del b._campaign_loop
    restore_s = entered[0] - t0
    assert fleet_trace(resumed) == fleet_trace(stats), \
        "resumed campaign differs from the uninterrupted one"
    say(f"fleet crash at round {crash_at} (run 2), checkpoint every round: "
        f"resumed from the last checkpoint, trace equal to the "
        f"uninterrupted campaign without checkpoints ({len(ckpts)} "
        f"checkpoints); a checkpoint: make {np.median(made) * 1e3:.1f} ms "
        f"median, pickle {save_s * 1e3:.1f} ms, {size} bytes, load "
        f"{load_s * 1e3:.1f} ms, restore and replay {restore_s * 1e3:.1f} "
        f"ms; loaded in a CPU-only process")

    # a resilient campaign through two crashes, from the profiled state
    restore_fleet(b, base)
    hard, restores = b.adaptive_campaign_resilient(2, "enel",
                                                   crash_rounds=(2, 5))
    assert restores == 2, restores
    assert fleet_trace(hard) == fleet_trace(stats[:2])
    say("fleet resilient campaign: 2 runs through crashes at rounds 2 and "
        "5, 2 restores, trace equal to the uninterrupted one")

    # the multi-tenant pool: Poisson arrivals, capped decisions
    after = fleet_state(a)
    t0 = time.perf_counter()
    pool_stats, pool_trace = a.arrival_campaign(**FLEET_POOL)
    torch.cuda.synchronize()
    arrival_s = time.perf_counter() - t0
    assert all(st is not None for st in pool_stats), pool_stats
    assert all(t.pool_used <= t.pool_size for t in pool_trace)
    capped = [t.capped_decisions for t in pool_trace]
    assert max(capped) > 0, capped
    restore_fleet(b, after)
    out, _ = b.arrival_campaign(**FLEET_POOL, checkpoint_every=1,
                                stop_after_round=5)
    assert out is None and b.checkpoints[-1].round_idx == 5
    b_stats, b_trace = b.resume_arrival_campaign(b.checkpoints[-1])
    rows = lambda tr: [(t.round_idx, t.active, t.pool_used, t.pool_size,
                        t.capped_decisions, t.arrivals) for t in tr]
    assert fleet_trace([b_stats]) == fleet_trace([pool_stats])
    assert rows(b_trace) == rows(pool_trace)
    phase_s = time.perf_counter() - t_phase
    say(f"fleet arrival campaign (pool {FLEET_POOL['pool_size']}, rate "
        f"{FLEET_POOL['arrival_rate']}): all 8 jobs done in "
        f"{len(pool_trace)} rounds, {arrival_s:.2f}s, peak pool "
        f"{max(t.pool_used for t in pool_trace)}, {sum(capped)} capped "
        f"decisions in {sum(c > 0 for c in capped)} rounds; crash at round "
        f"5 resumed to the same stats and trace; phase {phase_s:.1f}s")
    return {"experiments": len(a.experiments), "runs": FLEET_RUNS,
            "rounds": rounds, "campaign_s": campaign_s,
            "decisions": decisions, "dispatches": dispatches,
            "batched_away": batched_away, "adam_steps": steps,
            "launches": launches, "launches_bwd": launches_bwd,
            "round_ms_median": round_ms,
            "round_ms_mean": campaign_s / sum(rounds) * 1e3,
            "all_decide_round_ms": clock.profiled_ms,
            "all_decide_round_busy_ms": clock.busy_ms,
            "all_decide_round_busy_share":
                clock.busy_ms / clock.profiled_ms,
            "decide_j": j_max, "decide_ms_per_request": decide_ms,
            "scratch_fit_s": scratch_s, "tune_fit_s_median":
                float(np.median(tune_s)), "profile_s": profile_s,
            "checkpoint": {"make_ms_median": float(np.median(made)) * 1e3,
                           "pickle_ms": save_s * 1e3, "bytes": size,
                           "load_ms": load_s * 1e3,
                           "restore_ms": restore_s * 1e3,
                           "crash_round": crash_at, "count": len(ckpts)},
            "arrival": {"rounds": len(pool_trace), "seconds": arrival_s,
                        "capped_decisions": sum(capped),
                        "peak_pool": max(t.pool_used for t in pool_trace)},
            "seconds": phase_s}


SIM_MIXED = [("lr", "stragglers"), ("mpc", "interference_burst"),
             ("kmeans", "spot_preemption"), ("gbt", "data_skew_drift")]
SIM_TIMING_J = (4, 8, 32)    # fleet sizes of the timings; S = 5 with GBT
SIM_FLEET = 32               # benchmarks/scenario_suite.py's fleet
SIM_PROFILE_RUNS = 3         # phase 19's fleets and harness campaigns
SIM_ADAPTIVE_RUNS = 2        # the four-job fleet's runs
SIM_HARNESS_RUNS = 1         # the harness campaigns' (the reference: 3, 6)
SIM_IDENTITY_RUNS = 2        # chaos_trace_identity's (the reference: 4)


def sim_combos(n: int):
    """``n`` (job, scenario) pairs cycled over the four paper jobs and the
    six default scenarios; at 24 every pair once."""
    from repro_torch.sim.evaluate import DEFAULT_SCENARIOS
    if n == len(JOB_KEYS) * len(DEFAULT_SCENARIOS):
        return [(k, s) for s in DEFAULT_SCENARIOS for k in JOB_KEYS]
    return [(JOB_KEYS[i % 4], DEFAULT_SCENARIOS[i % 6]) for i in range(n)]


def sim_engines(device, combos, seed0: int):
    """(numpy backend on the host, batched engine on ``device``) with the
    same (job, scenario) pairs registered, seeds ``seed0 + i``."""
    from repro_torch.dataflow.workloads import JOBS
    from repro_torch.sim.engine import BatchedClusterSim, NumpySimBackend
    from repro_torch.sim.scenarios import make_scenario
    nb, bb = NumpySimBackend(), BatchedClusterSim(device=device)
    for i, (key, scn) in enumerate(combos):
        for b in (nb, bb):
            b.register(JOBS[key], seed=seed0 + i,
                       scenario=make_scenario(scn, seed=5))
    return nb, bb


def sim_records_equal(want, got, ctx: str) -> None:
    """Two component records equal field for field (start and runtime as
    float32, metrics bit for bit)."""
    assert len(want.stages) == len(got.stages), ctx
    for sw, sg in zip(want.stages, got.stages):
        assert (sw.name, np.float32(sw.start), np.float32(sw.runtime),
                sw.start_scaleout, sw.end_scaleout,
                np.float32(sw.time_fraction), sw.overhead, sw.failures) == \
            (sg.name, np.float32(sg.start), np.float32(sg.runtime),
             sg.start_scaleout, sg.end_scaleout,
             np.float32(sg.time_fraction), sg.overhead, sg.failures), ctx
        assert np.array_equal(sw.metrics, sg.metrics), ctx


def drive_sim(backends, jobs, comps, rng, begin=True, clocks=None,
              s_prev=None):
    """Step every backend through one random rescale schedule from
    component ``comps[0]`` on, failures injected; every backend's records,
    kill seconds and end clocks must equal the first's.  Returns the kill
    seconds seen, the clocks and the next scale-outs."""
    from repro_torch.sim.engine import SimStepRequest
    n = len(jobs)
    if begin:
        for b in backends:
            for j in range(n):
                b.begin_run(j)
    clocks = clocks or [0.0] * n
    s_prev = s_prev or [int(rng.choice([8, 16, 33]))] * n
    s_cur = list(s_prev)
    fails = 0
    for k in comps:
        idxs = [j for j in range(n) if k < jobs[j].n_components]
        results = [b.step([SimStepRequest(j, k, s_prev[j], s_cur[j],
                                          clocks[j], True) for j in idxs])
                   for b in backends]
        for pos, j in enumerate(idxs):
            want = results[0][pos]
            for res in results[1:]:
                ctx = f"comp {k} job {j} ({jobs[j].name})"
                sim_records_equal(want.component, res[pos].component, ctx)
                assert want.failures == res[pos].failures, ctx
                assert np.float32(want.clock_end) == \
                    np.float32(res[pos].clock_end), ctx
            fails += len(want.failures)
            clocks[j] = want.clock_end
            s_prev[j] = s_cur[j]
            s_cur[j] = int(rng.choice([4, 8, 16, 24, 36]))
    return fails, clocks, s_cur


def sim_schedules(rng, jobs):
    """Random (J, C_max) start and end scale-out schedules of a run."""
    c_max = max(j.n_components for j in jobs)
    a = rng.choice([8, 16, 24], (len(jobs), c_max)).astype(np.int32)
    z = rng.choice([4, 8, 16, 24, 36], (len(jobs), c_max)).astype(np.int32)
    return a, z


def numpy_full_runs(nb, jobs, a, z):
    """The numpy backend's records of one run per job at the schedules,
    component by component."""
    from repro_torch.sim.engine import SimStepRequest
    out = []
    for j, job in enumerate(jobs):
        nb.begin_run(j)
        clock, comps, fails = 0.0, [], []
        for c in range(job.n_components):
            r = nb.step([SimStepRequest(j, c, int(a[j, c]), int(z[j, c]),
                                        clock, True)])[0]
            clock = r.clock_end
            comps.append(r.component)
            fails.extend(r.failures)
        out.append((comps, fails))
    return out


def check_sim_kernel(device, ss):
    """Phase 3's ``sim_step`` checks: engines driven on the card with every
    launch made twice and once through the plain version on the same
    inputs, all three bit for bit equal: each paper job alone (J = 1, two
    stepped runs), the 24 (job, scenario) pairs at J = 24 (one stepped run,
    then ``run_full``), failures injected.  Returns the launches checked
    per mode."""
    inner = ss.sim_stages
    checked = {"stepped": 0, "whole_run": 0}

    def check(block, consts, **kw):
        out = inner(block, consts, **kw)
        again = inner(block, consts, **kw)
        plain = ss.sim_stages_plain(block, consts, **kw)
        torch.cuda.synchronize()
        mode = "stepped" if kw.get("ctrl") is not None else "whole_run"
        assert torch.equal(out, again), f"sim_step {mode}: not repeatable"
        assert torch.equal(out, plain), \
            f"sim_step {mode} differs from its plain version at " \
            f"{int((out != plain).sum())} of {out.numel()} outputs"
        checked[mode] += 1
        return out
    ss.sim_stages = check
    try:
        rng = np.random.RandomState(SEED)
        for i, key in enumerate(JOB_KEYS):
            _, bb = sim_engines(device, [(key, "node_failure")], 40 + i)
            jobs = [bb._slots[0].job]
            for _ in range(2):
                drive_sim((bb,), jobs, range(jobs[0].n_components), rng)
        combos = sim_combos(24)
        _, bb = sim_engines(device, combos, 200)
        jobs = [s.job for s in bb._slots]
        drive_sim((bb,), jobs, range(max(j.n_components for j in jobs)),
                  rng)
        bb.run_full(*sim_schedules(rng, jobs), inject_failures=True)
    finally:
        ss.sim_stages = inner
    return checked


def sim_step_work(n_jobs: int, s_len: int):
    """(float operations, bytes) one stepped launch needs: per job the
    control row, per stage the 11 inputs it reads (noise, three gathered
    table entries, three spec scalars, straggler), one burst and one
    preemption entry, eight kill seconds, two global table entries; the
    packed outputs written once.  Operations: ~25 per stage and ~10 per
    kill window, float32 on the CUDA cores."""
    reads = n_jobs * 8 + n_jobs * s_len * (11 + 2 + 8 + 2)
    writes = 2 * n_jobs + n_jobs * s_len * 24
    return n_jobs * s_len * (25 + 8 * 10), 4 * (reads + writes)


def sass_ffma(lib_path):
    """(all FFMA, FFMA outside IEEE divisions) in the built library's SASS
    (``cuobjdump``).  A correctly rounded float division compiles to an
    FCHK with five FFMA Newton steps around it, plus a shared slow-path
    subroutine after the kernel's last EXIT; those fuse nothing of the
    source.  Any other FFMA is a contraction of ``a*b + c``."""
    from repro_torch.kernels import build
    tool = Path(build.find_nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "-sass", str(lib_path)],
                         capture_output=True, text=True, check=True,
                         timeout=120).stdout
    ops_ = [m.group(1) for m in re.finditer(
        r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9.]*)", out)]
    total = sum(op.startswith("FFMA") for op in ops_)
    body = ops_[:max(i for i, op in enumerate(ops_) if op == "EXIT") + 1]
    ffma = {i for i, op in enumerate(body) if op.startswith("FFMA")}
    for k in (i for i, op in enumerate(body) if op.startswith("FCHK")):
        near = sorted((i for i in ffma if abs(i - k) <= 8),
                      key=lambda i: abs(i - k))
        ffma -= set(near[:5])
    return total, len(ffma)


class StepClock:
    """Host wall time of one batched fleet step cut into its parts: the
    control row and upload up to the launch's enqueue, the wait for the
    kernel plus the one device-to-host copy, and the record building."""

    def __init__(self, bb, ss):
        self.parts = {"enqueue": [], "wait_and_copy": [], "records": []}
        inner_launch, inner_fetch = ss.sim_stages, bb._fetch
        inner_records = bb._records
        self._undo = (ss, inner_launch)

        def timed(key, fn):
            def run(*a, **kw):
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                self.parts[key][-1] += time.perf_counter() - t0
                return out
            return run
        ss.sim_stages = timed("enqueue", inner_launch)
        bb._fetch = timed("wait_and_copy", inner_fetch)
        bb._records = timed("records", inner_records)
        self.bb = bb

    def open_step(self):
        for v in self.parts.values():
            v.append(0.0)

    def close(self):
        ss, inner = self._undo
        ss.sim_stages = inner
        del self.bb._fetch, self.bb._records


def time_fleet_steps(device, ss, n_jobs: int, runs: int = 3):
    """Median host wall ms of a batched fleet step (``step()`` with every
    job's request, record building included) and of the numpy backend's
    ``step`` on the same requests, over ``runs`` runs of ``n_jobs`` jobs;
    with the batched step's parts."""
    from repro_torch.sim.engine import SimStepRequest
    nb, bb = sim_engines(device, sim_combos(n_jobs), 300)
    jobs = [s.job for s in bb._slots]
    clock = StepClock(bb, ss)
    rng = np.random.RandomState(n_jobs)
    t_b, t_n = [], []
    for _ in range(runs):
        for b in (nb, bb):
            for j in range(n_jobs):
                b.begin_run(j)
        clocks = [[0.0] * n_jobs, [0.0] * n_jobs]
        s = [int(rng.choice([8, 16, 24]))] * n_jobs
        for k in range(max(j.n_components for j in jobs)):
            idxs = [j for j in range(n_jobs) if k < jobs[j].n_components]
            z = [int(rng.choice([4, 8, 16, 24, 36])) for _ in idxs]
            for which, b, times in ((0, bb, t_b), (1, nb, t_n)):
                reqs = [SimStepRequest(j, k, s[j], zj, clocks[which][j], True)
                        for j, zj in zip(idxs, z)]
                if b is bb:
                    clock.open_step()
                t0 = time.perf_counter()
                res = b.step(reqs)
                times.append((time.perf_counter() - t0) * 1e3)
                for j, r in zip(idxs, res):
                    clocks[which][j] = r.clock_end
            for j, zj in zip(idxs, z):
                s[j] = zj
    clock.close()
    parts = {k: float(np.median(v)) * 1e3 for k, v in clock.parts.items()}
    return float(np.median(t_b)), float(np.median(t_n)), parts, bb


def run_sim_engine(device, card, ss, ops):
    """Phase 19: the vectorized engine on the card.  (a) bit parity with
    the numpy backend on the host, (b) a mid-run restore, (c) a four-job
    fleet on the shared batched engine against the same fleet on the numpy
    engine, (d) the evaluation harness; then timings.  The main path is
    (c) and (d): their launches are counted from 0, and every launch must
    be one engine dispatch."""
    from repro_torch.core.service import DecisionService
    from repro_torch.dataflow import FleetCampaign, JobExperiment
    from repro_torch.sim import evaluate
    from repro_torch.sim.engine import BatchedClusterSim, SimStepRequest
    t_phase = time.perf_counter()
    rng = np.random.RandomState(SEED + 19)

    # (a) bit parity with the numpy engine on the host
    ss.LAUNCHES = 0
    fails = 0
    for i, key in enumerate(JOB_KEYS):
        nb, bb = sim_engines(device, [(key, "node_failure")], 40 + i)
        jobs = [bb._slots[0].job]
        for _ in range(2):
            fails += drive_sim((nb, bb), jobs, range(jobs[0].n_components),
                               rng)[0]
    nb, bb = sim_engines(device, SIM_MIXED, 60)
    jobs = [s.job for s in bb._slots]
    for _ in range(2):
        fails += drive_sim((nb, bb), jobs,
                           range(max(j.n_components for j in jobs)), rng)[0]
    combos = sim_combos(24)
    nb, bb = sim_engines(device, combos, 200)
    jobs = [s.job for s in bb._slots]
    a, z = sim_schedules(rng, jobs)
    full = bb.run_full(a, z, inject_failures=True)
    for j, (want, got) in enumerate(zip(numpy_full_runs(nb, jobs, a, z),
                                        full)):
        for c, (cw, cg) in enumerate(zip(want[0], got[0])):
            sim_records_equal(cw, cg, f"run_full job {j} comp {c}")
        assert want[1] == got[1], f"run_full job {j} kill seconds"
        fails += len(got[1])
    assert fails > 0, "no failure in the parity runs"
    say(f"sim engine on {card}: BatchedClusterSim on the card equals "
        f"NumpySimBackend on the host bit for bit (each paper job alone, "
        f"2 runs on node_failure; 4 jobs x 4 scenarios, 2 runs; run_full "
        f"of the 24 (job, scenario) pairs against stepped numpy; {fails} "
        f"kill seconds)")

    # (b) a mid-run restore, into the same engine after it ran on
    pair = [("gbt", "stragglers"), ("kmeans", "stragglers")]
    nb, bb = sim_engines(device, pair, 90)
    jobs = [s.job for s in bb._slots]
    _, clocks, s_next = drive_sim((nb, bb), jobs, range(4), rng)
    states = [bb.slot_state(j) for j in range(2)]
    drive_sim((bb,), jobs, range(4, 6), np.random.RandomState(1),
              begin=False, clocks=list(clocks))
    drive_sim((bb,), jobs, range(2), np.random.RandomState(2))
    for j in range(2):
        bb.restore_slot(j, states[j])
    drive_sim((nb, bb), jobs, range(4, 8), rng, begin=False,
              clocks=list(clocks), s_prev=s_next)
    say("sim engine restore: slot states taken after 4 components, the "
        "engine run on and into a new run, restored: the rest of the run "
        "equals the uninterrupted numpy run")
    check_launches = ss.LAUNCHES

    # (c) + (d), the main path: launches counted from 0, one per dispatch
    fetches = [0]
    inner_fetch = BatchedClusterSim._fetch

    def fetch(self, buf, s_len):
        fetches[0] += 1
        return inner_fetch(self, buf, s_len)
    BatchedClusterSim._fetch = fetch
    ss.LAUNCHES = ops.LAUNCHES = ops.LAUNCHES_BWD = 0

    def fleet(engine):
        exps = [JobExperiment(k, seed=SEED + i, candidate_stride=2,
                              device=device)
                for i, k in enumerate(JOB_KEYS)]
        return FleetCampaign(exps, DecisionService(), engine=engine)
    t0 = time.perf_counter()
    camp = fleet("batched")
    backend = camp.experiments[0].backend
    camp.profile(SIM_PROFILE_RUNS)
    d_profile = backend.dispatches
    stepping = [0]
    inner_round = camp._round

    def rnd(gens, pending, *args, **kw):
        stepping[0] += any(isinstance(r, SimStepRequest)
                           for r in pending.values())
        return inner_round(gens, pending, *args, **kw)
    camp._round = rnd
    b_stats, _ = camp.adaptive_campaign(SIM_ADAPTIVE_RUNS, "enel", True)
    torch.cuda.synchronize()
    del camp._round
    fleet_s = time.perf_counter() - t0
    fleet_launches = ss.LAUNCHES
    adam_steps = sum(ex.trainer.adam_steps for ex in camp.experiments)
    assert fleet_launches == backend.dispatches == fetches[0], \
        (fleet_launches, backend.dispatches, fetches[0])
    assert backend.dispatches - d_profile == stepping[0] > 0, \
        (backend.dispatches, d_profile, stepping[0])
    assert d_profile == SIM_PROFILE_RUNS * sum(
        ex.job.n_components for ex in camp.experiments), d_profile
    assert ops.LAUNCHES == ops.LAUNCHES_BWD == adam_steps > 0, \
        (ops.LAUNCHES, ops.LAUNCHES_BWD, adam_steps)
    graph_launches = (ops.LAUNCHES, ops.LAUNCHES_BWD)
    plain = fleet(None)
    plain.profile(SIM_PROFILE_RUNS)
    n_stats, _ = plain.adaptive_campaign(SIM_ADAPTIVE_RUNS, "enel", True)
    assert ss.LAUNCHES == fleet_launches, (ss.LAUNCHES, fleet_launches)
    assert fleet_trace(b_stats) == fleet_trace(n_stats), \
        "the batched fleet's trace differs from the numpy fleet's"
    n_fail = sum(s.n_failures for run in b_stats for s in run)
    say(f"sim engine fleet on {card}: 4 jobs, profile({SIM_PROFILE_RUNS}) + "
        f"{SIM_ADAPTIVE_RUNS} adaptive runs with failures under "
        f"FleetCampaign(engine='batched'), trace equal pick for pick to the "
        f"numpy fleet's ({n_fail} failures); sim_step launched "
        f"{fleet_launches} times = dispatches ({d_profile} profiling steps "
        f"+ {stepping[0]} lockstep rounds that stepped); graph_prop_fwd and "
        f"graph_prop_bwd once per Adam step ({adam_steps}); "
        f"{fleet_s:.1f}s")

    ss.LAUNCHES = 0
    fetches[0] = 0
    campaigns = {}
    t0 = time.perf_counter()
    for name in ("node_failure", "multi_tenant"):
        t1 = time.perf_counter()
        rows = evaluate.run_scenario_campaign(
            name, JOB_KEYS, device=device, profile_runs=SIM_PROFILE_RUNS,
            adaptive_runs=SIM_HARNESS_RUNS)
        campaigns[name] = (rows, time.perf_counter() - t1)
    t1 = time.perf_counter()
    rows = evaluate.run_chaos_campaign(
        "chaos_crashes", JOB_KEYS, device=device,
        profile_runs=SIM_PROFILE_RUNS, adaptive_runs=SIM_HARNESS_RUNS)
    campaigns["chaos_crashes"] = (rows, time.perf_counter() - t1)
    assert rows[-1]["restores"] == 2, rows[-1]
    t1 = time.perf_counter()
    identity = evaluate.chaos_trace_identity(
        device=device, adaptive_runs=SIM_IDENTITY_RUNS)
    identity_s = time.perf_counter() - t1
    assert identity is True, "chaos_trace_identity failed on the card"
    t1 = time.perf_counter()
    cell = evaluate.run_transfer_cell("baseline", 1.0, "node_failure", 1.6,
                                      "kmeans", device=device)
    cell_s = time.perf_counter() - t1
    torch.cuda.synchronize()
    harness_s = time.perf_counter() - t0
    harness_launches = ss.LAUNCHES
    assert harness_launches == fetches[0] > 0, (harness_launches, fetches)
    BatchedClusterSim._fetch = inner_fetch
    mt = campaigns["multi_tenant"][0][-1]
    assert 0 < mt["max_pool_used"] <= mt["pool_size"], mt
    summary = {}
    for name, (rows, wall) in campaigns.items():
        per_job = rows[:-1]
        for r in per_job:
            assert r["runs"] > 0 and 0.0 <= r["compliance"] <= 1.0, r
            assert np.isfinite(r["runtime_mean_s"]), r
        fl = rows[-1]
        summary[name] = {
            "compliance": {r["job"]: r["compliance"] for r in per_job},
            "rescales_mean": {r["job"]: r["rescales_mean"] for r in per_job},
            "failures": sum(r["failures_total"] for r in per_job),
            "decisions": fl.get("decisions", fl.get("svc_decisions")),
            "decisions_per_s": fl.get("decisions_per_s"),
            "wall_s_adaptive": fl["wall_s_adaptive"], "wall_s": wall}
        say(f"harness {name} on {card}: compliance "
            + ", ".join(f"{r['job']} {r['compliance']:.2f}" for r in per_job)
            + "; rescales/run " + ", ".join(f"{r['rescales_mean']:.1f}"
                                            for r in per_job)
            + f"; failures {summary[name]['failures']}; decisions "
            f"{summary[name]['decisions']}"
            + (f" at {fl['decisions_per_s']:.1f}/s"
               if "decisions_per_s" in fl else "")
            + f"; adaptive wall {fl['wall_s_adaptive']:.2f}s, call "
            f"{wall:.1f}s")
    assert np.isfinite(cell["compliance"]) and cell["runs"] > 0, cell
    say(f"harness transfer baseline 1.0 -> node_failure 1.6 (kmeans) on "
        f"{card}: compliance {cell['compliance']:.2f}, rescales/run "
        f"{cell['rescales_mean']:.1f}, failures {cell['failures_total']}, "
        f"prediction rel err {cell.get('pred_rel_err_mean', float('nan')):.3f}"
        f"; {cell_s:.1f}s; chaos_trace_identity True ({identity_s:.1f}s); "
        f"harness {harness_s:.1f}s, sim_step launched {harness_launches} "
        f"times = dispatches")

    # timings: the kernel, a fleet step, a whole run
    tiny = torch.zeros(1, device=device)
    floor_graph = graph_ms(lambda: tiny.add_(1.0))
    floor_b2b = median_ms(lambda: tiny.add_(1.0), burst=50)
    kernel = {}
    for n in SIM_TIMING_J:
        _, bb = sim_engines(device, sim_combos(n), 400)
        bb._build()
        for j in range(n):
            bb.begin_run(j)
        ctrl = np.zeros((n, ss.N_CTRL), np.float32)
        ctrl[:, 2] = 8
        ctrl[:, 3] = 24
        ctrl[:, 4] = 1
        ctrl[:, 5] = [s.tables.n_stages[0] for s in bb._slots]
        ctrl[:, 6] = 9.6
        block, consts, ctrl_d = bb._run_block(), bb._consts(), bb._dev(ctrl)
        s_len = bb._S
        out = torch.empty(2 * n + s_len * n * ss.NO, device=device)
        launch = lambda: ss._launch(block, consts, ctrl_d, s_len, None, None,
                                    None, out)
        t_graph = graph_ms(launch)
        t_b2b = median_ms(launch, burst=50)
        t_plain = median_ms(lambda: ss.sim_stages_plain(
            block, consts, ctrl=ctrl_d, s_len=s_len), burst=2, reps=10)
        flops, nbytes = sim_step_work(n, s_len)
        t_bound, by = bound(flops, nbytes, FP32_FLOPS)
        kernel[n] = {"ms": t_graph, "graph_ms": t_graph,
                     "back_to_back_ms": t_b2b, "plain_ms": t_plain,
                     "bound_ms": t_bound, "bound_by": by, "bytes": nbytes,
                     "flops": flops, "S": s_len}
        say(f"sim_step at J={n} S={s_len} on {card}: kernel {t_graph:.4f} ms "
            f"in a CUDA graph, back to back {t_b2b:.4f} ms, plain "
            f"{t_plain:.3f} ms, bound {t_bound:.6f} ms by {by} "
            f"({nbytes} bytes, {flops} FLOP); launch floor (a 1-element "
            f"add) {floor_graph:.4f} ms in a CUDA graph, {floor_b2b:.4f} "
            f"back to back")
    steps = {}
    for n in SIM_TIMING_J:
        t_b, t_n, parts, _ = time_fleet_steps(device, ss, n)
        steps[n] = {"batched_ms": t_b, "numpy_ms": t_n, "parts_ms": parts}
        say(f"fleet step at J={n} on {card}: batched {t_b:.3f} ms wall "
            f"(enqueue {parts['enqueue']:.3f}, kernel wait + copy "
            f"{parts['wait_and_copy']:.3f}, records {parts['records']:.3f}), "
            f"numpy {t_n:.3f} ms on the same requests")
    nb, bb = sim_engines(device, sim_combos(SIM_FLEET), 500)
    jobs = [s.job for s in bb._slots]
    a, z = sim_schedules(rng, jobs)
    full_ms = median_wall_ms(lambda: bb.run_full(a, z, inject_failures=True),
                             reps=5, warmup=1)
    np_full_ms = median_wall_ms(lambda: numpy_full_runs(nb, jobs, a, z),
                                reps=3, warmup=1)
    phase_s = time.perf_counter() - t_phase
    say(f"run_full of a {SIM_FLEET}-job fleet (T = {bb._T}) on {card}: "
        f"{full_ms:.2f} ms wall in one launch, numpy {np_full_ms:.2f} ms; "
        f"phase {phase_s:.1f}s")
    return {"launches": fleet_launches + harness_launches,
            "launches_by_path": {"fleet_batched": fleet_launches,
                                 "harness": harness_launches},
            "check_launches": {"parity_and_restore": check_launches},
            "graph_launches_fleet": graph_launches,
            "adam_steps_fleet": adam_steps,
            "kernel": kernel, "fleet_step": steps,
            "run_full": {"J": SIM_FLEET, "T": bb._T, "batched_ms": full_ms,
                         "numpy_ms": np_full_ms},
            "launch_floor": {"graph_ms": floor_graph,
                             "back_to_back_ms": floor_b2b},
            "campaigns": summary, "transfer": {
                k: cell[k] for k in ("compliance", "rescales_mean",
                                     "failures_total", "runs")},
            "chaos_trace_identity": identity, "fleet_s": fleet_s,
            "harness_s": harness_s, "seconds": phase_s}


FUSED_PROFILE_RUNS = 3      # phase 20: profile(3), 2 live adaptive runs,
FUSED_WARM_RUNS = 2         # then 3 fused runs: the cadence (a scratch fit
FUSED_RUNS = 3              # every 5th run) retrains in the 3rd
FUSED_CHAOS = ("kmeans", SEED + 1)   # nan_fit after every 2nd fit


def fused_fleet(device):
    """Phase 20's fleet: the four paper jobs, each with seeds SEED and
    SEED + 1 (``candidate_stride=2``; ``node_failure`` on the SEED + 1
    half), on one shared batched engine, after ``profile(3)`` and two
    live adaptive runs."""
    from repro_torch.core.service import DecisionService
    from repro_torch.dataflow import FleetCampaign, JobExperiment
    from repro_torch.sim.scenarios import make_scenario
    camp = FleetCampaign(
        [JobExperiment(key, seed=s, candidate_stride=2, device=device,
                       scenario=make_scenario("baseline" if s == SEED
                                              else "node_failure"))
         for key in JOB_KEYS for s in FLEET_SEEDS],
        DecisionService(), engine="batched")
    camp.profile(FUSED_PROFILE_RUNS)
    camp.adaptive_campaign(FUSED_WARM_RUNS, "enel")
    return camp


def fused_twin(camp, base):
    """``camp`` back in the state ``base`` (its experiments' snapshots,
    backend slots included), ``nan_fit`` chaos attached to the
    ``FUSED_CHAOS`` experiment after profiling, as the chaos suite
    does."""
    from repro_torch.sim.chaos import ChaosInjector, ChaosSpec
    for ex, st in zip(camp.experiments, base):
        ex.restore_state(st)
        ex.chaos = None
        if (ex.job_key, ex.seed) == FUSED_CHAOS:
            ex.chaos = ChaosInjector(ChaosSpec(name="nan_fit",
                                               nan_fit_every=2),
                                     exp_seed=ex.seed)
    return camp


def fused_adam_steps(plan) -> int:
    """Adam steps of a fused plan's fits, summed over its jobs and runs."""
    st = plan.static
    return plan.n_jobs * sum(st.scratch_steps if s else st.tune_steps
                             for s in plan.host["scratch_at"])


def timed_drive(plan, driver, strict: bool):
    """``driver(plan)`` (``run_fused`` or ``run_stepped``) with the host's
    enqueue time of each step taken (``campaign_kernel._step`` wrapped for
    the run), under ``torch.cuda.set_sync_debug_mode("error")`` when
    ``strict`` -> (carry, ys, wall seconds, median enqueue ms per step
    without a fit, enqueue ms per Adam step in the fit steps)."""
    from repro_torch.core import campaign_kernel as ck
    enqueue = {}
    inner_step = ck._step

    def timed_step(plan_, carry, t):
        t0 = time.perf_counter()
        out = inner_step(plan_, carry, t)
        enqueue[t] = time.perf_counter() - t0
        return out
    torch.cuda.synchronize()
    ck._step = timed_step
    if strict:                  # any host sync in run_fused's loop raises
        torch.cuda.set_sync_debug_mode("error")
    t0 = time.perf_counter()
    try:
        carry, ys = driver(plan)
    finally:
        torch.cuda.set_sync_debug_mode("default")
        ck._step = inner_step
    wall = time.perf_counter() - t0
    c_max = plan.static.c_max
    fit_t = [t for t in enqueue if t % c_max == c_max - 1]
    step_ms = float(np.median([s for t, s in enqueue.items()
                               if t not in fit_t])) * 1e3
    adam_ms = sum(enqueue[t] for t in fit_t) * 1e3 / fused_adam_steps(plan)
    return carry, ys, wall, step_ms, adam_ms


def tree_leaves(tree, path=""):
    """(path, leaf) pairs of nested dicts, lists and tuples, keys sorted."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in tree_leaves(tree[k], f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree)
                for pl in tree_leaves(v, f"{path}/{i}")]
    return [(path, tree)]


def trees_equal(a, b, what: str) -> None:
    """Same structure, dtypes and values bit for bit (NaN equal to NaN)."""
    la, lb = tree_leaves(a), tree_leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb], what
    for (p, x), (_, y) in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, f"{what}{p}"
        assert np.array_equal(x, y, equal_nan=x.dtype.kind == "f"), \
            f"{what}{p} differs"


def run_fused_campaign(device, card, ss, ops):
    """Phase 20: the fused campaign (``repro_torch.core.campaign_kernel``)
    on the card.  The main path is ``run_fused`` over a plan of 8 jobs x 3
    runs: its launches count from 0, and it must enqueue all 66 steps
    under ``torch.cuda.set_sync_debug_mode("error")`` (its copies to the
    host after the loop excepted).  Held against ``run_stepped`` on the same
    plan (bit for bit), ``run_full`` on the fleet restored to its state
    before the plan, and a checkpointed, pickled and resumed
    ``FleetCampaign.fused_campaign``; then the stepped path continues."""
    import os
    import tempfile
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import campaign_kernel as ck
    from repro_torch.dataflow.fleet import FusedCheckpoint, materialize_fused
    from repro_torch.dataflow.workloads import SCALEOUT_RANGE
    t_phase = time.perf_counter()
    camp = fused_fleet(device)
    base = [ex.snapshot_state() for ex in camp.experiments]
    profile_s = time.perf_counter() - t_phase
    fused_twin(camp, base)
    plan = ck.build_plan(camp.experiments, FUSED_RUNS)
    st, n_jobs = plan.static, plan.n_jobs
    adam = fused_adam_steps(plan)
    want = {"sim_step": plan.n_steps, "graph_prop_fwd": adam,
            "graph_prop_bwd": adam}
    lo, hi = SCALEOUT_RANGE

    def drive(driver, strict: bool):
        ss.LAUNCHES = ops.LAUNCHES = ops.LAUNCHES_BWD = 0
        carry, ys, wall, step_ms, adam_ms = timed_drive(plan, driver, strict)
        got = {"sim_step": ss.LAUNCHES, "graph_prop_fwd": ops.LAUNCHES,
               "graph_prop_bwd": ops.LAUNCHES_BWD}
        assert got == want, (driver.__name__, got, want)
        return ck.carry_to_host(carry), ys, wall, got, step_ms, adam_ms

    # (a), (b): the main path, each step's enqueue timed on the host clock
    c_f, ys_f, fused_s, launches, step_ms, adam_ms = drive(ck.run_fused,
                                                           strict=True)
    c_s, ys_s, stepped_s, _, _, _ = drive(ck.run_stepped, strict=False)
    trees_equal(ys_f, ys_s, "fused vs stepped ys")
    trees_equal(c_f, c_s, "fused vs stepped carry")
    # (c) the guardrail
    chaos_j = [(ex.job_key, ex.seed) for ex in camp.experiments].index(
        FUSED_CHAOS)
    picks = ys_f["s_next"][ys_f["decided"]]
    assert (c_f["nonfinite"] == 0).all(), c_f["nonfinite"]
    assert c_f["fallbacks"][chaos_j] > 0, c_f["fallbacks"]
    assert ((picks >= lo) & (picks <= hi)).all(), picks
    say(f"fused campaign on {card}: {n_jobs} jobs x {FUSED_RUNS} runs = "
        f"{plan.n_steps} steps (c_max {st.c_max}, scratch fits in runs "
        f"{(np.flatnonzero(plan.host['scratch_at']) + 1).tolist()}, "
        f"sweep {len(plan.dev['cand'])} "
        f"candidates x {plan.dev['sw_comp'].numel()} components, ring "
        f"{c_f['ring']['slot_ok'].shape[1]}), run_fused enqueued under "
        f"sync debug mode 'error' and equal to run_stepped bit for bit; "
        f"launches per driver {launches} ({adam} Adam steps); "
        f"{int(ys_f['decided'].sum())} decisions, fallbacks "
        f"{c_f['fallbacks'].tolist()} (chaos job {chaos_j}), no non-finite "
        f"pick, picks in [{lo}, {hi}]")

    # the busy share of the step body: run 1's 21 steps before its fit
    # step, device time in a trace over the wall time of an untraced run
    # of the same steps (a trace of the fit step's ~170,000 kernels takes
    # minutes to read; phase 7 traces a fit)
    n_body = st.c_max - 1
    t0 = time.perf_counter()
    ck.run_fused(plan, None, 0, n_body)
    seg_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ck.run_fused(plan, None, 0, n_body)
    dev_ev = [ev for ev in prof.key_averages()
              if getattr(ev, "device_type", None) == DeviceType.CUDA]
    busy_ms = sum(float(getattr(ev, "self_device_time_total", 0.0) or 0.0)
                  for ev in dev_ev) / 1e3
    kernels = sum(ev.count for ev in dev_ev)
    drivers_s = time.perf_counter() - t_phase - profile_s

    # (d) the fused sim against run_full on the fleet in its state before
    # the plan
    backend = fused_twin(camp, base).experiments[0].backend
    a, z = ys_f["a"].astype(np.int64), ys_f["z"].astype(np.int64)
    for r in range(FUSED_RUNS):
        t0 = r * st.c_max
        res = backend.run_full(a[t0:t0 + st.c_max].T.copy(),
                               z[t0:t0 + st.c_max].T.copy())
        for j, (comps, _) in enumerate(res):
            for k, comp in enumerate(comps):
                for i, stage in enumerate(comp.stages):
                    assert np.float32(stage.runtime) == \
                        ys_f["rt"][t0 + k, i, j], (r, j, k, i)
            nc = camp.experiments[j].job.n_components
            assert np.float32(backend.slot_state(j)["clock"]) == \
                ys_f["clock"][t0 + nc - 1, j], (r, j)

    # the live campaign of the same fleet, for its wall time
    fused_twin(camp, base)
    t0 = time.perf_counter()
    live, _ = camp.adaptive_campaign(FUSED_RUNS, "enel")
    torch.cuda.synchronize()
    live_s = time.perf_counter() - t0

    # (e) checkpointed, pickled, loaded and resumed = the single pass;
    # (f) the written-back fleet goes on with the stepped path
    fused_twin(camp, base)
    single = materialize_fused(plan, ys_f)
    stats_c, rep_c = camp.fused_campaign(FUSED_RUNS, write_back=False,
                                         checkpoint_every_runs=1)
    assert len(rep_c.checkpoints) == FUSED_RUNS - 1
    trees_equal(rep_c.ys, ys_f, "checkpointed ys")
    assert repr(stats_c) == repr(single)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "fused.ckpt")
        rep_c.checkpoints[-1].save(path)
        size = os.path.getsize(path)
        loaded = FusedCheckpoint.load(path)
    stats_r, rep_r = camp.resume_fused_campaign(rep_c.plan, loaded)
    trees_equal(rep_r.ys, ys_f, "resumed ys")
    trees_equal(rep_r.carry, c_f, "resumed carry")
    assert repr(stats_r) == repr(single)
    post = camp.adaptive_round()
    assert all(np.isfinite(s.runtime) and s.runtime > 0 for s in post)
    run_next = FUSED_PROFILE_RUNS + FUSED_WARM_RUNS + FUSED_RUNS + 1
    assert [s.run_idx for s in post] == [run_next] * n_jobs, post
    phase_s = time.perf_counter() - t_phase
    compliance = float(np.mean([s.violation == 0.0 for run in single
                                for s in run]))
    say(f"fused campaign checks on {card}: the fused sim equals run_full "
        f"on the fleet's state before the plan bit for bit; fused_campaign "
        f"checkpointed every run ({size} bytes pickled), loaded and resumed "
        f"from run 3 equals the single pass (ys, stats); after write-back "
        f"adaptive_round runs run {run_next}")
    say(f"fused campaign timing on {card}: run_fused {fused_s:.2f}s wall, "
        f"run_stepped {stepped_s:.2f}s, the live adaptive_campaign("
        f"{FUSED_RUNS}) of the same fleet {live_s:.2f}s; host enqueue "
        f"{step_ms:.3f} ms per step without a fit (median), "
        f"{adam_ms:.3f} ms per Adam step in the fit steps; run 1's "
        f"{n_body} step bodies before its fit traced: {busy_ms:.2f} ms "
        f"device busy of {seg_s * 1e3:.1f} ms wall (busy share "
        f"{busy_ms / (seg_s * 1e3):.3f}, {kernels / n_body:.0f} kernels a "
        f"step); compliance {compliance:.3f}; profile and "
        f"{FUSED_WARM_RUNS} live runs {profile_s:.1f}s, both drivers and "
        f"the trace {drivers_s:.1f}s; phase {phase_s:.1f}s")
    return {"jobs": n_jobs, "runs": FUSED_RUNS, "steps": plan.n_steps,
            "c_max": st.c_max, "adam_steps": adam, "launches": launches,
            "fused_s": fused_s, "stepped_s": stepped_s, "live_s": live_s,
            "enqueue_ms_per_step": step_ms, "enqueue_ms_per_adam_step":
                adam_ms, "body_steps": n_body, "body_wall_ms": seg_s * 1e3,
            "body_busy_ms": busy_ms, "body_busy_share":
                busy_ms / (seg_s * 1e3), "body_kernels": kernels,
            "fallbacks": c_f["fallbacks"].tolist(),
            "decisions": int(ys_f["decided"].sum()),
            "checkpoint_bytes": size, "compliance": compliance,
            "profile_s": profile_s, "drivers_s": drivers_s,
            "seconds": phase_s}


LM_ARCH = "qwen3-0.6b"
LM_WAVES, LM_BATCH, LM_NEW, LM_MAX_LEN = 2, 8, 64, 2048
LM_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}   # tests/test_kernels.py
TF_TOL = {torch.bfloat16: 5e-2, torch.float32: 5e-3}   # decode vs forward
TF_STEPS = 4
LM_COPIES = 4               # caches cycled by the decode timings (> L2)
# (B, S, H, Kh, D, causal, window, softcap): tests/test_kernels.py's sweep,
# then qwen3-0.6b's prefill shapes and a gemma2-like D = 256 case
MHA_SWEEP = [(2, 128, 4, 2, 32, True, 0, 0.0),
             (1, 256, 4, 4, 64, True, 64, 50.0),
             (2, 96, 8, 2, 32, False, 0, 0.0),
             (1, 64, 2, 1, 128, True, 32, 0.0),
             (1, 192, 6, 3, 32, True, 0, 30.0)]
MHA_MODEL = [(8, 1024, 16, 8, 128, True, 0, 0.0),
             (8, 1024, 32, 8, 128, True, 0, 0.0),
             (8, 777, 16, 8, 128, True, 0, 0.0),
             (8, 128, 16, 8, 128, True, 0, 0.0),
             (2, 512, 8, 4, 256, True, 128, 50.0)]
# (B, S, H, Kh, D, pos, window, softcap): the decode sweep, then the model's
DECODE_SWEEP = [(2, 256, 4, 2, 32, 100, 0, 0.0),
                (1, 512, 8, 8, 64, 511, 128, 0.0),
                (2, 128, 4, 1, 32, 0, 0, 0.0),
                (1, 128, 2, 2, 128, 64, 32, 0.0)]
DECODE_MODEL = [(8, 2048, 16, 8, 128, pos, win, 0.0)
                for pos in (0, 1023, 2047) for win in (0, 256)] + \
    [(8, 2048, 32, 8, 128, pos, 0, 0.0) for pos in (0, 1087, 2047)] + \
    [(2, 1024, 8, 4, 256, 700, 512, 50.0)]
# the bf16 tensor-core route of mha: S ragged against the 128-row q-tile and
# the 128-key tile (qwen3's S = 812, and 1000) and kv_len < S; (..., kv_len)
MHA_TC = [(8, 812, 16, 8, 128, True, 0, 0.0, 0),
          (8, 1000, 16, 8, 128, True, 0, 0.0, 0),
          (8, 812, 16, 8, 128, True, 0, 0.0, 775),
          (2, 300, 4, 2, 64, False, 0, 0.0, 263)]
# split-K decode at the model's shape: 1023, 1024 and 1025 visible keys sit
# just below, at and above a chunk boundary of split_plan (8 chunks of 128,
# then 9); windows of 100 and 300 keys end inside a chunk
DECODE_SPLIT = [(8, 2048, 16, 8, 128, pos, 0, 0.0)
                for pos in (1022, 1023, 1024)] + \
    [(8, 2048, 16, 8, 128, 1023, 100, 0.0),
     (8, 2048, 16, 8, 128, 1500, 300, 0.0)]


def _randn(rng, shape, dtype, device):
    return torch.tensor(rng.randn(*shape).astype(np.float32),
                        device=device).to(dtype)


def check_lm_kernels(device, fa, fd):
    """Phase 8: each LM kernel against its plain version, twice bit-equal.
    Returns the largest abs error of each kernel, by dtype."""
    f32, bf16 = torch.float32, torch.bfloat16
    rng = np.random.RandomState(SEED)
    errs = {"mha": {f32: 0.0, bf16: 0.0}, "decode": {f32: 0.0, bf16: 0.0}}
    mha_cases = [(c, dt) for c in MHA_SWEEP for dt in (f32, bf16)] + \
        [(c, bf16) for c in MHA_MODEL + MHA_TC] + [(MHA_MODEL[-1], f32)]
    for (b, s, h, kh, d, causal, win, cap, *kv_len), dt in mha_cases:
        q = _randn(rng, (b, s, h, d), dt, device)
        k, v = (_randn(rng, (b, s, kh, d), dt, device) for _ in range(2))
        kw = dict(causal=causal, window=win, softcap=cap,
                  kv_len=kv_len[0] if kv_len else 0)
        got, again = fa.mha(q, k, v, **kw), fa.mha(q, k, v, **kw)
        torch.cuda.synchronize()
        what = f"mha {dt} B={b} S={s} H={h} Kh={kh} D={d} {kw}"
        assert torch.equal(got, again), f"{what}: not repeatable"
        err = close(got.float(), fa.mha_plain(q, k, v, **kw).float(), what,
                    LM_TOL[dt], LM_TOL[dt])
        errs["mha"][dt] = max(errs["mha"][dt], err)
        say(f"  {what}: max abs err {err:.3g}, repeat bit-equal")
    dec_cases = [(c, dt) for c in DECODE_SWEEP + DECODE_SPLIT
                 for dt in (f32, bf16)] + \
        [(c, bf16) for c in DECODE_MODEL] + [(DECODE_MODEL[-1], f32)]
    for (b, s, h, kh, d, pos, win, cap), dt in dec_cases:
        q = _randn(rng, (b, 1, h, d), dt, device)
        ck, cv = (_randn(rng, (b, s, kh, d), dt, device) for _ in range(2))
        kw = dict(window=win, softcap=cap)
        got = fd.decode_attn(q, ck, cv, pos, **kw)
        again = fd.decode_attn(q, ck, cv, pos, **kw)
        torch.cuda.synchronize()
        kbeg = max(0, pos - win + 1) if win else 0
        what = (f"decode_attn {dt} B={b} S={s} H={h} Kh={kh} D={d} pos={pos} "
                f"{kw}, (chunk, chunks) {fd.split_plan(b, kh, kbeg, pos)}")
        assert torch.equal(got, again), f"{what}: not repeatable"
        err = close(got.float(),
                    fd.decode_attn_plain(q, ck, cv, pos, **kw).float(), what,
                    LM_TOL[dt], LM_TOL[dt])
        errs["decode"][dt] = max(errs["decode"][dt], err)
        say(f"  {what}: max abs err {err:.3g}, repeat bit-equal")
    return errs


def lm_waves(cfg):
    """Two waves of LM_BATCH (prompt, max_new_tokens): chat-style prompts
    of 128..1024 tokens from ``np.random.RandomState(SEED)``."""
    rng = np.random.RandomState(SEED)
    return [[(rng.randint(2, cfg.raw_vocab_size, rng.randint(128, 1025)),
              LM_NEW) for _ in range(LM_BATCH)] for _ in range(LM_WAVES)]


def padded(prompts) -> np.ndarray:
    """The engine's left-padded token matrix of a wave."""
    plen = max(len(p) for p, _ in prompts)
    toks = np.zeros((len(prompts), plen), np.int64)
    for i, (p, _) in enumerate(prompts):
        toks[i, plen - len(p):] = p
    return toks


def serve_twice(cfg, params, device, waves, after_wave=None):
    """Each wave served twice by one engine; both runs must give the same
    tokens, LM_NEW in range for each request.  ``after_wave()`` runs after
    each serve_wave call.  Returns [[(tokens, stats), (tokens, stats)],
    ...]."""
    from repro_torch.serve.engine import Request, ServeEngine
    eng = ServeEngine(cfg, params, max_len=LM_MAX_LEN, device=device)
    results = []
    for w, prompts in enumerate(waves):
        runs = []
        for _ in range(2):
            reqs = [Request(prompt=p, max_new_tokens=n) for p, n in prompts]
            runs.append(([r.out_tokens for r in reqs], eng.serve_wave(reqs)))
            if after_wave is not None:
                after_wave()
        assert runs[0][0] == runs[1][0], f"wave {w}: runs differ"
        results.append(runs)
    torch.cuda.synchronize()
    for runs in results:
        for toks, st in runs:
            assert all(len(t) == LM_NEW for t in toks)
            assert all(0 <= x < cfg.vocab_size for t in toks for x in t)
            assert st.decode_steps == LM_NEW
    return results


def run_serving(cfg, params, device, fa, fd):
    """Phase 9: each wave served twice; launch counts from 0."""
    waves = lm_waves(cfg)
    fa.LAUNCHES = fd.LAUNCHES = 0
    results = serve_twice(cfg, params, device, waves)
    launches = (fa.LAUNCHES, fd.LAUNCHES)
    prefills = 2 * len(waves)
    steps = sum(st.decode_steps for runs in results for _, st in runs)
    assert launches == (cfg.n_layers * prefills, cfg.n_layers * steps), \
        (launches, prefills, steps)
    return waves, results, launches, prefills, steps


def teacher_forced_err(params, cfg, toks: torch.Tensor, p: int) -> float:
    """max over TF_STEPS decode steps of max|forward - decode_step| logits
    at positions p..p+TF_STEPS-1, relative to the largest forward logit."""
    from repro_torch.models import apply_model, decode_step, prefill
    full, _ = apply_model(params, cfg, {"tokens": toks})
    _, cache = prefill(params, cfg, {"tokens": toks[:, :p]},
                       cache_len=p + TF_STEPS)
    errs = []
    for t in range(TF_STEPS):
        dec, cache = decode_step(params, cfg, cache, toks[:, p + t:p + t + 1],
                                 p + t)
        a, d = full[:, p + t].float(), dec[:, 0].float()
        errs.append(float((a - d).abs().max() / a.abs().max()))
    del full, cache
    return max(errs)


def forward_floor(params, cfg, toks: torch.Tensor, p: int) -> float:
    """max over the TF_STEPS positions before p of max|forward over toks -
    forward over toks[:, :p]| logits, relative to the largest: one function
    of the same tokens, computed with matmuls of other shapes."""
    from repro_torch.models import apply_model
    full, _ = apply_model(params, cfg, {"tokens": toks})
    part, _ = apply_model(params, cfg, {"tokens": toks[:, :p]})
    a, b = full[:, p - TF_STEPS:p].float(), part[:, p - TF_STEPS:].float()
    err = (a - b).abs().amax(dim=(0, 2)) / a.abs().amax(dim=(0, 2))
    del full, part
    return float(err.max())


def mixer_continuation_err(layer, cfg, kind: str, u: torch.Tensor,
                           p: int) -> float:
    """One recurrent mixer: max over TF_STEPS steps, from the state of a
    prefill over u[:, :p], of max|full-sequence form over u - step| at
    positions p..p+TF_STEPS-1, relative to the largest output."""
    from repro_torch.models import ssm
    forward, step = {"mamba": (ssm.mamba_forward, ssm.mamba_step),
                     "mlstm": (ssm.mlstm_forward, ssm.mlstm_step),
                     "slstm": (ssm.slstm_forward, ssm.slstm_step)}[kind]
    full = forward(layer, cfg, u)
    _, state = forward(layer, cfg, u[:, :p], return_state=True)
    errs = []
    for t in range(TF_STEPS):
        y, state = step(layer, cfg, u[:, p + t:p + t + 1], state)
        a = full[:, p + t]
        errs.append(float((a - y[:, 0]).abs().max() / a.abs().max()))
    return max(errs)


def layer_continuation_errs(params, cfg, toks: torch.Tensor,
                            p: int) -> list:
    """mixer_continuation_err of every layer on the inputs that a forward
    over ``toks`` gives it (its ln1-normed residual stream)."""
    from repro_torch.models import transformer as tr
    from repro_torch.models.layers import embed_lookup, rms_norm
    x = embed_lookup(params["embed"], toks, cfg)
    errs = []
    for i, lp in enumerate(params["layers"]):
        kind = cfg.layer_kind(i)
        errs.append(mixer_continuation_err(
            lp["mixer"], cfg, kind, rms_norm(x, lp["ln1"], cfg.norm_eps), p))
        x, _, _ = tr._layer_apply(lp, cfg, kind, cfg.ffn_kind(i), x,
                                  "train", None, None, None)
    return errs


def first_layers(params, cfg, k: int):
    """The model cut to its first ``k`` layers, with the same weights."""
    import dataclasses
    return (dict(params, layers=params["layers"][:k]),
            dataclasses.replace(cfg, n_layers=k))


def prefill_work(b, s, h, kh, d, elt=2):
    """(FLOPs, bytes) of causal attention: 4 * D FLOPs for each of the S(S +
    1)/2 visible (query, key) pairs of each head (QK^T and PV); q, k, v read
    once and the output written once."""
    return (4 * b * h * d * s * (s + 1) // 2,
            elt * b * s * d * (2 * h + 2 * kh))


def decode_work(b, h, kh, d, pos, elt=2):
    """(FLOPs, bytes) of one-token attention over positions 0..pos: 4 * D
    FLOPs per key and query head; the pos + 1 cache rows of K and V read
    once, q read and the output written once."""
    n = pos + 1
    return 4 * b * h * d * n, elt * (2 * b * kh * n * d + 2 * b * h * d)


def ptxas_usage(kname: str, symbol: str) -> dict:
    """{registers, spill_stores, spill_loads} (bytes) of the instantiation
    of kernel ``kname`` whose mangled name holds ``symbol``, from the
    ``ptxas -v`` log of its build; {"ptxas": "no build log"} when the
    library came without one."""
    from repro_torch.kernels import build
    info = build.BUILDS.get(kname)
    lines = info.log.splitlines() if info is not None else []
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and symbol in line:
            text = " ".join(lines[i + 1:i + 4])
            num = lambda pat: int(re.search(pat, text).group(1))
            return {"registers": num(r"Used (\d+) registers"),
                    "spill_stores": num(r"(\d+) bytes spill stores"),
                    "spill_loads": num(r"(\d+) bytes spill loads")}
    return {"ptxas": "no build log"}


def bound(flops, nbytes, peak):
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def as_float32(params):
    """A copy of LM params with every leaf in float32."""
    def leaf(x):
        return {k: leaf(v) for k, v in x.items()} if isinstance(x, dict) \
            else x.float()
    return {k: [leaf(layer) for layer in v] if k == "layers" else leaf(v)
            for k, v in params.items()}


XLSTM_ARCH = "xlstm-350m"
XLSTM_TOP = (1024, 768)     # each wave's longest prompt: 256-multiples
XLSTM_TF_PREFIX = 768       # teacher-forced: prefill 768 of wave 0's 1024
XLSTM_TF_DEPTH = 4          # teacher-forced on the first 4 layers: both kinds
# bf16 h: one bf16 step (2^-7 of the value) where the float32
# results straddle a rounding boundary, plus the float32 tolerance below
BF16_STEP = 2.0 ** -7
# One mixer on its real inputs (no depth to amplify anything): the step
# from the prefill state against the full-sequence form, relative to the
# largest output.  float32: summation orders only; bf16: the two routes
# round q, k, v, h and the gated product to bf16 at other points, two
# steps of the largest output
MIXER_TF_TOL = {torch.float32: 1e-4, torch.bfloat16: 2 * BF16_STEP}
# float32: the reference's 2e-4 between two chunk sizes (tests/test_kernels
# .py:101); the float32 route walks 32-row chunks, the bf16 route 64-row
# ones, the plain version the caller's
MLSTM_TOL = 2e-4
# (B, S, H, D, chunk): tests/test_kernels.py's mLSTM sweep, a ragged last
# kernel chunk, then xlstm-350m's prefill shapes
MLSTM_SWEEP = [(2, 128, 2, 32, 32), (1, 256, 4, 64, 64), (1, 64, 1, 128, 16),
               (2, 48, 3, 32, 16)]
MLSTM_MODEL = [(8, s, 4, 256, 256) for s in (256, 768, 1024)]
# the bf16 tensor-core route's own cases, (B, S, H, D, caller chunk,
# inputs): S ragged against its 64-row chunk (48, 96, 1000), D in {16, 64,
# 256}, and inputs off the common path: "floor" (q / 8: |den| < 1 at
# almost every row, so h is num itself), "big_i" (m_t the intra-chunk
# max), "decay" (f far below 0: the state decays to 0 inside a chunk)
MLSTM_TC_EDGE = [(2, 48, 3, 64, 16, "random"), (1, 96, 2, 64, 32, "random"),
                 (1, 1000, 2, 64, 200, "random"),
                 (8, 1000, 4, 256, 200, "random")] + \
    [(2, 256, 4, d, 64, kind) for d in (16, 64, 256)
     for kind in ("floor", "big_i", "decay")]


def mlstm_inputs(rng, b, s, h, d, dtype, device, kind="random"):
    """q, k, v in ``dtype``; the log input gate and the forget gate before
    its log-sigmoid in float32, drawn as tests/test_kernels.py draws them;
    ``kind`` moves them off the common path (``MLSTM_TC_EDGE``)."""
    q, k, v = (_randn(rng, (b, s, h, d), dtype, device) for _ in range(3))
    i = _randn(rng, (b, s, h), torch.float32, device)
    f = _randn(rng, (b, s, h), torch.float32, device) + 2
    if kind == "floor":
        q = q / 8
    elif kind == "big_i":
        i = 8 * i + 10
    elif kind == "decay":
        f = f - 40
    return q, k, v, i, f


def check_mlstm_kernel(device, ml):
    """Phase 11: the kernel against its plain version, h and the state,
    twice bit-equal.  Returns the largest abs error of h by dtype and of
    the state."""
    f32, bf16 = torch.float32, torch.bfloat16
    rng = np.random.RandomState(SEED + 2)
    errs = {f32: 0.0, bf16: 0.0, "state": 0.0}
    cases = [(c + ("random",), dt) for c in MLSTM_SWEEP
             for dt in (f32, bf16)] + \
        [(c + ("random",), bf16) for c in MLSTM_MODEL] + \
        [(MLSTM_MODEL[1] + ("random",), f32)] + \
        [(c, bf16) for c in MLSTM_TC_EDGE]
    for (b, s, h, d, chunk, kind), dt in cases:
        args = mlstm_inputs(rng, b, s, h, d, dt, device, kind)
        got, st = ml.mlstm(*args, chunk=chunk, return_state=True)
        again, st2 = ml.mlstm(*args, chunk=chunk, return_state=True)
        torch.cuda.synchronize()
        what = f"mlstm {dt} B={b} S={s} H={h} D={d} chunk={chunk} {kind}"
        assert torch.equal(got, again), f"{what}: not repeatable"
        assert all(torch.equal(st[k], st2[k]) for k in st), \
            f"{what}: state not repeatable"
        ref, rst = ml.mlstm_plain(*args, chunk=chunk, return_state=True)
        rtol = MLSTM_TOL if dt == f32 else BF16_STEP
        err = close(got.float(), ref.float(), what, MLSTM_TOL, rtol)
        errs[dt] = max(errs[dt], err)
        for key in st:
            errs["state"] = max(errs["state"], close(
                st[key], rst[key], f"{what} state {key}", MLSTM_TOL,
                MLSTM_TOL))
        say(f"  {what}: h max abs err {err:.3g}, state within "
            f"{MLSTM_TOL}, repeat bit-equal")
    return errs


def capped_waves(cfg, tops):
    """One wave of LM_BATCH (prompt, LM_NEW) per entry of ``tops``: lengths
    in [128, top] from ``np.random.RandomState(SEED)``, the longest set to
    the wave's top."""
    rng = np.random.RandomState(SEED)
    waves = []
    for top in tops:
        lens = rng.randint(128, top + 1, LM_BATCH)
        lens[np.argmax(lens)] = top
        waves.append([(rng.randint(2, cfg.raw_vocab_size, n), LM_NEW)
                      for n in lens])
    return waves


def run_xlstm_serving(cfg, params, device, ml, others):
    """Phase 12: every count from 0; each wave (one prefill and its decode
    steps) must launch ``mlstm_chunk`` once per mLSTM layer and no kernel
    of ``others`` (the modules of the other kernels)."""
    n_mlstm = sum(cfg.layer_kind(i) == "mlstm" for i in range(cfg.n_layers))
    counts = [(m, n) for m in (ml,) + tuple(others)
              for n in ("LAUNCHES", "LAUNCHES_BWD") if hasattr(m, n)]
    for m, n in counts:
        setattr(m, n, 0)
    per_wave = []

    def after_wave():
        per_wave.append(ml.LAUNCHES - sum(per_wave))
    results = serve_twice(cfg, params, device, capped_waves(cfg, XLSTM_TOP),
                          after_wave)
    assert per_wave == [n_mlstm] * len(per_wave), (per_wave, n_mlstm)
    others_launched = sum(getattr(m, n) for m, n in counts if m is not ml)
    assert others_launched == 0, others_launched
    steps = sum(st.decode_steps for runs in results for _, st in runs)
    return results, ml.LAUNCHES, len(per_wave), steps, n_mlstm


def mlstm_work(b, s, h, d, elt=2):
    """(FLOPs, bytes) that the chunkwise mLSTM needs at least: per token
    and head the state's outer-product update (2 D^2) and the read-out q C
    (2 D^2), the recurrent form's count, which no chunking lowers; q, k, v
    and the two float32 gates read once, h written once, the float32 state
    (C, n, m) written once."""
    flops = 4 * b * h * s * d * d
    nbytes = elt * 4 * b * s * h * d + 4 * 2 * b * s * h \
        + 4 * b * h * (d * d + d + 1)
    return flops, nbytes


def xlstm_path(device, card, ml, others):
    """Phases 12-13 on full-width xlstm-350m: serving with its launch
    counts, the teacher-forced check, then timings.  Returns what the
    ``kernels`` line reports of ``mlstm_chunk``."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_model, prefill
    bf16 = torch.bfloat16
    n_loop = 16
    # 12. the xLSTM serving path; only its launches count
    xcfg = get_config(XLSTM_ARCH)
    t0 = time.perf_counter()
    x_params = init_model(xcfg, seed=SEED, device=device)
    torch.cuda.synchronize()
    say(f"{XLSTM_ARCH}: {xcfg.n_layers} layers, d_model {xcfg.d_model}, "
        f"{xcfg.n_heads} heads of {xcfg.d_head}, vocab {xcfg.vocab_size}, "
        f"{xcfg.param_dtype}; init {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    x_served, ml_launches, x_prefills, x_steps, n_mlstm = run_xlstm_serving(
        xcfg, x_params, device, ml, others)
    say(f"xLSTM serving path ({time.perf_counter() - t0:.1f}s): "
        f"{x_prefills} prefills, {x_steps} decode steps; mlstm_chunk "
        f"launched {ml_launches} times (= {n_mlstm} x {x_prefills}, none in "
        f"decode), no other kernel; both runs of each wave gave the same "
        f"tokens")
    x_waves = capped_waves(xcfg, XLSTM_TOP)
    x_toks0 = padded(x_waves[0])
    assert x_toks0.shape[1] == XLSTM_TOP[0], x_toks0.shape
    xt = torch.tensor(x_toks0, device=device)
    # Teacher-forced, each against a fixed limit: every mixer alone on its
    # real inputs, and decode vs forward on the first XLSTM_TF_DEPTH
    # layers.  Over all 24 layers, decode vs forward and two forwards of
    # the same tokens over 768 and 1024 positions are printed only: with
    # random weights the model amplifies rounding differences over its
    # depth and sequence (tools/xlstm_rounding.py).
    x_params32 = as_float32(x_params)
    xcfg32 = dataclasses.replace(xcfg, dtype="float32", param_dtype="float32")
    x_tf, x_floor, x_shallow, x_layers = {}, {}, {}, {}
    for dt, prm, c in ((torch.bfloat16, x_params, xcfg),
                       (torch.float32, x_params32, xcfg32)):
        x_layers[dt] = layer_continuation_errs(prm, c, xt, XLSTM_TF_PREFIX)
        x_shallow[dt] = teacher_forced_err(
            *first_layers(prm, c, XLSTM_TF_DEPTH), xt, XLSTM_TF_PREFIX)
        x_tf[dt] = teacher_forced_err(prm, c, xt, XLSTM_TF_PREFIX)
        x_floor[dt] = forward_floor(prm, c, xt, XLSTM_TF_PREFIX)
    del x_params32
    torch.cuda.empty_cache()
    span = f"{XLSTM_TF_PREFIX}..{XLSTM_TF_PREFIX + TF_STEPS - 1}"
    for dt, name in ((torch.bfloat16, "bf16"), (torch.float32, "float32")):
        errs = x_layers[dt]
        worst = max(range(len(errs)), key=errs.__getitem__)
        say(f"xLSTM {name}: each of the {len(errs)} mixers, step vs "
            f"full-sequence form on its real inputs at {span}: max rel err "
            f"{errs[worst]:.3g} (layer {worst}, {xcfg.layer_kind(worst)}; "
            f"tol {MIXER_TF_TOL[dt]:.3g}); decode_step vs forward logits on "
            f"the first {XLSTM_TF_DEPTH} layers {x_shallow[dt]:.3g} (tol "
            f"{TF_TOL[dt]}); all {xcfg.n_layers} layers {x_tf[dt]:.3g}, and "
            f"forward over {XLSTM_TF_PREFIX} vs over {xt.shape[1]} at "
            f"{XLSTM_TF_PREFIX - TF_STEPS}..{XLSTM_TF_PREFIX - 1} "
            f"{x_floor[dt]:.3g} (printed only)")
    for dt in x_layers:
        for i, err in enumerate(x_layers[dt]):
            assert err < MIXER_TF_TOL[dt], (dt, i, err)
        assert x_shallow[dt] < TF_TOL[dt], (dt, x_shallow[dt])

    # 13. timings of the xLSTM path
    xb, px, xh, xd = LM_BATCH, x_toks0.shape[1], xcfg.n_heads, xcfg.d_head
    trng = np.random.RandomState(SEED + 3)
    q, k, v, gi, gf = mlstm_inputs(trng, xb, px, xh, xd, bf16, device)
    out = torch.empty_like(q)
    st = (torch.empty((xb, xh, xd, xd), dtype=torch.float32, device=device),
          torch.empty((xb, xh, xd), dtype=torch.float32, device=device),
          torch.empty((xb, xh), dtype=torch.float32, device=device))
    ml_launch = lambda: ml._launch(q, k, v, gi, gf, out, *st)
    ml_ms = median_ms(ml_launch, burst=5, reps=10)
    ml_graph_ms = graph_ms(ml_launch)
    ml_plain_ms = median_ms(lambda: ml.mlstm_plain(
        q, k, v, gi, gf, chunk=256, return_state=True), burst=2, reps=5)
    ml_ms2 = median_ms(ml_launch, burst=5, reps=10)
    fl, nb = mlstm_work(xb, px, xh, xd)
    ml_bound, ml_by = bound(fl, nb, BF16_FLOPS)
    ml_regs = ptxas_usage("mlstm_chunk", f"mlstm_kernel_tcILi{xd}E")
    say(f"mlstm_chunk at B={xb} S={px} H={xh} D={xd} bf16 on {card}: kernel "
        f"{ml_graph_ms:.4f} ms in a CUDA graph, back to back {ml_ms:.4f} ms "
        f"(again {ml_ms2:.4f}), plain {ml_plain_ms:.4f} ms, bound "
        f"{ml_bound:.5f} ms by {ml_by} ({fl / 1e9:.2f} GFLOP, "
        f"{nb / 1e6:.1f} MB), no library call; ptxas {ml_regs}")
    del q, k, v, gi, gf, out, st
    x_first = [runs[0][1] for runs in x_served]
    for w, stt in enumerate(x_first):
        say(f"xLSTM wave {w}: P={padded(x_waves[w]).shape[1]}, prefill "
            f"{stt.prefill_s * 1e3:.1f} ms, decode {stt.decode_steps} steps "
            f"{stt.decode_s * 1e3 / stt.decode_steps:.2f} ms/step, "
            f"{stt.tokens_out} tokens at {stt.decode_tok_s:.1f} tok/s")
    xpf = lambda: (prefill(x_params, xcfg, {"tokens": xt},
                           cache_len=LM_MAX_LEN), torch.cuda.synchronize())
    xpf_wall = median_wall_ms(xpf, reps=3, warmup=1)
    xpf_busy, xpf_per, xpf_kernels = profile_device(
        xpf, reps=1, names=("mlstm_kernel",))
    _, x_cache = prefill(x_params, xcfg, {"tokens": xt}, cache_len=LM_MAX_LEN)

    def x_decode_loop():
        tok = xt[:, -1:]
        for i in range(n_loop):
            logits, _ = decode_step(x_params, xcfg, x_cache, tok, px + i)
            tok = logits[:, -1:].argmax(dim=-1)
            tok.tolist()                   # the engine's host fetch
    x_dec_wall = median_wall_ms(x_decode_loop, reps=5, warmup=1) / n_loop
    x_dec_busy, _, x_dec_kernels = profile_device(x_decode_loop, reps=2,
                                                  names=("mlstm_kernel",))
    x_dec_busy, x_dec_kernels = x_dec_busy / n_loop, x_dec_kernels / n_loop
    say(f"xLSTM prefill of wave 0 (B={xb}, P={px}): {xpf_wall:.2f} ms wall, "
        f"device busy {xpf_busy:.2f} ms (mlstm_chunk "
        f"{xpf_per['mlstm_kernel']:.2f} ms), idle share "
        f"{1 - xpf_busy / xpf_wall:.3f}, {xpf_kernels:.0f} kernels")
    say(f"xLSTM decode step (B={xb}): {x_dec_wall:.3f} ms wall, device busy "
        f"{x_dec_busy:.3f} ms, idle share {1 - x_dec_busy / x_dec_wall:.3f}, "
        f"{x_dec_kernels:.0f} kernels per step")
    del x_cache, x_params
    say(json.dumps({"card": card, "serving_xlstm": {
        "arch": XLSTM_ARCH, "batch": LM_BATCH, "new_tokens": LM_NEW,
        "max_len": LM_MAX_LEN,
        "waves": [{"P": int(padded(x_waves[w]).shape[1]),
                   "prefill_ms": stt.prefill_s * 1e3,
                   "decode_ms_per_step": stt.decode_s * 1e3 / stt.decode_steps,
                   "decode_tok_s": stt.decode_tok_s}
                  for w, stt in enumerate(x_first)],
        "mixer_teacher_forced_rel_err": {
            "bf16": x_layers[torch.bfloat16],
            "float32": x_layers[torch.float32]},
        f"teacher_forced_rel_err_{XLSTM_TF_DEPTH}_layers": {
            "bf16": x_shallow[torch.bfloat16],
            "float32": x_shallow[torch.float32]},
        "teacher_forced_rel_err": {"bf16": x_tf[torch.bfloat16],
                                   "float32": x_tf[torch.float32]},
        "forward_floor_rel": {"bf16": x_floor[torch.bfloat16],
                              "float32": x_floor[torch.float32]},
        "prefill": {"wall_ms": xpf_wall, "busy_ms": xpf_busy,
                    "mlstm_chunk_ms": xpf_per["mlstm_kernel"],
                    "kernels": xpf_kernels},
        "decode_step": {"wall_ms": x_dec_wall, "busy_ms": x_dec_busy,
                        "kernels": x_dec_kernels}}}))
    return {"launches": ml_launches, "ms": ml_graph_ms,
            "graph_ms": ml_graph_ms, "back_to_back_ms": ml_ms,
            "plain_ms": ml_plain_ms, "bound_ms": ml_bound, "bound_by": ml_by,
            "ptxas": ml_regs,
            "shape": {"B": xb, "S": px, "H": xh, "D": xd,
                      "dtype": "bfloat16"}}


JAMBA_ARCH = "jamba-v0.1-52b"
# One period of the published 32 layers (7 Mamba, attention at 4, MoE FFNs
# at the odd layers), every other field as published: ~13.3 B parameters,
# 26.6 GB in bf16.  The 52 B model (~103 GB) does not fit one 80 GB card.
JAMBA_LAYERS = 8
JAMBA_TOP = (1024, 896)     # each wave's longest prompt: the MoE's routing
#                             groups need at most moe_group or a multiple
JAMBA_TF_PREFIX = 768       # teacher-forced: prefill 768 of 1024 tokens
JAMBA_TF_BATCH = 2          # keeps the capacity-16 expert products ~2 GB
JAMBA_TF_DEPTH_F32 = 5      # float32: layers 0-4, through the attention layer
JAMBA_TF_CAPACITY = 16.0    # no drops, as tests/test_cache_consistency.py
JAMBA_MAX_EXCLUDED = 0.25   # of the teacher-forced rows, for flipped routes
# kernel vs plain: float32 both, so FMA contraction of decay h + drive and
# the kernel's tree order over N, relative to the largest |y| (|h|)
MAMBA_TOL = 1e-5
# (B, S, D, N, dt range): tests/test_new_substrate.py's sweep at its decay
# range (exp(dt a) in (0.5, 1) with a = -(1..N)), then jamba's prefill
# shapes with dt up to 1.0, where the TPU kernel's chunk form overflows
MAMBA_SWEEP = [(2, 128, 64, 8, (0.01, 0.04)), (1, 64, 128, 16, (0.01, 0.04)),
               (1, 96, 32, 4, (0.01, 0.04))]
MAMBA_MODEL = [(8, s, 8192, 16, (0.0, 1.0)) for s in (768, 1024)]
# one thread per channel in blocks of 128: D = 300 ends in a ragged block,
# S = 77 inside a 32-step tile of B_t, C_t and an 8-step group of dt, x
# loaded ahead; every N the kernel takes
MAMBA_EDGE = [(3, 77, 300, n, (0.0, 1.0)) for n in (1, 2, 4, 8, 16, 32)]
SFU_EX2_PER_CLOCK = 16      # MUFU.EX2 per SM per clock, compute capability 9.0


def mamba_inputs(rng, b, s, d, n, dt_range, x_dtype, device):
    """dt (B, S, D) uniform in ``dt_range``, a = -(1..N) per channel as
    ``init_mamba`` makes it, x (B, S, D) in ``x_dtype``, B and C (B, S,
    N)."""
    dt = rng.uniform(*dt_range, (b, s, d)).astype(np.float32)
    a = -np.tile(np.arange(1, n + 1, dtype=np.float32), (d, 1))
    return (torch.tensor(dt, device=device), torch.tensor(a, device=device),
            _randn(rng, (b, s, d), x_dtype, device),
            _randn(rng, (b, s, n), torch.float32, device),
            _randn(rng, (b, s, n), torch.float32, device))


def check_mamba_kernel(device, ms):
    """Phase 14: ``selective_scan`` against its plain version, y and the
    final h, x in float32 and bf16, twice bit-equal.  Returns the largest
    abs error of y and of h."""
    rng = np.random.RandomState(SEED + 4)
    errs = {"y": 0.0, "h": 0.0}
    for (b, s, d, n, dtr), xdt in itertools.product(
            MAMBA_SWEEP + MAMBA_MODEL + MAMBA_EDGE,
            (torch.float32, torch.bfloat16)):
        args = mamba_inputs(rng, b, s, d, n, dtr, xdt, device)
        y, h = ms.selective_scan(*args, return_state=True)
        y2, h2 = ms.selective_scan(*args, return_state=True)
        torch.cuda.synchronize()
        what = f"selective_scan x {xdt} B={b} S={s} D={d} N={n} dt in {dtr}"
        assert torch.equal(y, y2) and torch.equal(h, h2), \
            f"{what}: not repeatable"
        ry, rh = ms.selective_scan_plain(*args, return_state=True)
        assert torch.isfinite(y).all() and torch.isfinite(h).all(), what
        err = {}
        for key, got, ref in (("y", y, ry), ("h", h, rh)):
            tol = MAMBA_TOL * float(ref.abs().max())
            err[key] = close(got, ref, f"{what} {key}", tol, 0.0)
            errs[key] = max(errs[key], err[key])
        say(f"  {what}: max abs err y {err['y']:.3g}, h {err['h']:.3g} "
            f"(1e-5 of max |y| {float(ry.abs().max()):.3g}, |h| "
            f"{float(rh.abs().max()):.3g}), repeat bit-equal")
        del args, y, h, y2, h2, ry, rh
    return errs


def mamba_work(b, s, d, n, x_elt=2):
    """(FLOPs, bytes) that the selective scan needs at least: per state
    update exp(dt a) (a product and an exp), the drive's product with B_t,
    decay h + drive (2) and h C_t into y (2), plus dt x once per channel;
    dt, x, B, C and a read once, y and the final h written once."""
    flops = 7 * b * s * d * n + b * s * d
    nbytes = 4 * b * s * d + x_elt * b * s * d + 2 * 4 * b * s * n \
        + 4 * d * n + 4 * b * s * d + 4 * b * d * n
    return flops, nbytes


def max_sm_clock_hz() -> float:
    """The card's rated highest SM clock, from ``nvidia-smi``
    (clocks.max.sm); not the clock it runs at under load."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def mamba_exp_floor_ms(b, s, d, n, clock_hz):
    """The time the B S D N precise exponentials of the scan take at least
    on the special-function pipe: one MUFU.EX2 each, SFU_EX2_PER_CLOCK per
    SM per clock on every SM at ``clock_hz``.  It lies above the bytes
    bound, so the kernel cannot come near that bound while it keeps the
    precise exp."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    return b * s * d * n / (SFU_EX2_PER_CLOCK * n_sm * clock_hz) * 1e3


def run_jamba_serving(cfg, params, device, ms, fa, fd, others):
    """Phase 15's serving: every count from 0; each wave (one prefill and
    its LM_NEW decode steps) must launch ``mamba_scan`` once per Mamba
    layer, ``flash_attention_fwd`` once per attention layer, ``flash_decode``
    once per attention layer and step, and no kernel of ``others``."""
    kinds = [cfg.layer_kind(i) for i in range(cfg.n_layers)]
    n_mamba, n_attn = kinds.count("mamba"), kinds.count("attn")
    counts = [(m, n) for m in (ms, fa, fd) + tuple(others)
              for n in ("LAUNCHES", "LAUNCHES_BWD") if hasattr(m, n)]
    for m, n in counts:
        setattr(m, n, 0)
    per_wave, last = [], [0, 0, 0]

    def after_wave():
        now = [ms.LAUNCHES, fa.LAUNCHES, fd.LAUNCHES]
        per_wave.append(tuple(a - b for a, b in zip(now, last)))
        last[:] = now
    results = serve_twice(cfg, params, device, capped_waves(cfg, JAMBA_TOP),
                          after_wave)
    want = (n_mamba, n_attn, n_attn * LM_NEW)
    assert per_wave == [want] * len(per_wave), (per_wave, want)
    others_launched = sum(getattr(m, n) for m, n in counts
                          if m not in (ms, fa, fd))
    assert others_launched == 0, others_launched
    steps = sum(st.decode_steps for runs in results for _, st in runs)
    return (results, (ms.LAUNCHES, fa.LAUNCHES, fd.LAUNCHES), len(per_wave),
            steps, want)


def jamba_mixer_errs(params, cfg, toks: torch.Tensor, p: int):
    """mixer_continuation_err of every Mamba mixer on the inputs that a
    forward over ``toks`` gives it, in bf16 and with the mixer's weights
    and inputs in float32: {dtype: [(layer, err), ...]}."""
    import dataclasses
    from repro_torch.models import transformer as tr
    from repro_torch.models.layers import embed_lookup, rms_norm
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    x = embed_lookup(params["embed"], toks, cfg)
    b, s = toks.shape
    positions = torch.arange(s, device=toks.device).expand(b, s)
    errs = {torch.bfloat16: [], torch.float32: []}
    for i, lp in enumerate(params["layers"]):
        kind = cfg.layer_kind(i)
        if kind == "mamba":
            u = rms_norm(x, lp["ln1"], cfg.norm_eps)
            errs[torch.bfloat16].append((i, mixer_continuation_err(
                lp["mamba"], cfg, kind, u, p)))
            p32 = {k: v.float() for k, v in lp["mamba"].items()}
            errs[torch.float32].append((i, mixer_continuation_err(
                p32, cfg32, kind, u.float(), p)))
            del u, p32
        x, _, _ = tr._layer_apply(lp, cfg, kind, cfg.ffn_kind(i), x, "train",
                                  positions, None, None)
    return errs


def routed_teacher_forced(params, cfg, toks: torch.Tensor, p: int):
    """decode_step's logits at p..p+TF_STEPS-1 after a prefill over p
    tokens against forward's, with each MoE layer's top-k experts taken in
    both (``moe.route`` on the same inputs as ``moe_ffn``).  Returns (rel
    err of each (step, row), relative to the step's largest forward logit;
    for each (step, row), whether any MoE layer routed it to other experts
    in decode than in forward; the number of (step, row, layer) routings
    that differ)."""
    from repro_torch.models import apply_model, decode_step, moe, prefill
    routes = []
    inner = moe.moe_ffn

    def recording(pm, c, x):
        b, s, d = x.shape
        idx = moe.route(pm, c, x.reshape(-1, min(s, c.moe_group), d))[2]
        routes.append(idx.reshape(b, s, -1).sort(dim=-1).values)
        return inner(pm, c, x)
    moe.moe_ffn = recording
    try:
        full, _ = apply_model(params, cfg, {"tokens": toks})
        fwd_routes = list(routes)
        _, cache = prefill(params, cfg, {"tokens": toks[:, :p]},
                           cache_len=p + TF_STEPS)
        errs, flipped, flips = [], [], 0
        for t in range(TF_STEPS):
            del routes[:]
            dec, cache = decode_step(params, cfg, cache,
                                     toks[:, p + t:p + t + 1], p + t)
            a, d = full[:, p + t].float(), dec[:, 0].float()
            errs.append((a - d).abs().amax(dim=-1) / a.abs().max())
            assert len(routes) == len(fwd_routes) > 0
            diff = torch.stack([(fr[:, p + t] != dr[:, 0]).any(dim=-1)
                                for fr, dr in zip(fwd_routes, routes)])
            flips += int(diff.sum())
            flipped.append(diff.any(dim=0))
    finally:
        moe.moe_ffn = inner
    del full, cache
    return torch.stack(errs).cpu(), torch.stack(flipped).cpu(), flips


def jamba_path(device, card, ms, fa, fd, others, cfg=None):
    """Phases 15-16 on jamba cut to one period at full width: the float32
    teacher-forced check on its first layers (before the bf16 model is
    resident), serving with its launch counts, the Mamba mixers'
    continuation and the bf16 teacher-forced check, then timings.  Returns
    what the ``kernels`` line reports of ``mamba_scan`` and of the flash
    kernels' jamba launches."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_model, prefill
    cfg = cfg or dataclasses.replace(get_config(JAMBA_ARCH),
                                     n_layers=JAMBA_LAYERS)
    bf16, f32 = torch.bfloat16, torch.float32
    say(f"{JAMBA_ARCH} cut to its first period: n_layers {cfg.n_layers} of "
        f"32 (dataclasses.replace), d_model {cfg.d_model}, {cfg.n_heads} "
        f"query / {cfg.n_kv_heads} kv heads of {cfg.d_head}, {cfg.n_experts}"
        f" experts top-{cfg.top_k} of {cfg.moe_d_ff}, d_ff {cfg.d_ff}, Mamba "
        f"d_state {cfg.mamba_d_state} expand {cfg.mamba_expand}, vocab "
        f"{cfg.vocab_size}, {cfg.param_dtype}; layers "
        + " ".join(f"{cfg.layer_kind(i)}/{cfg.ffn_kind(i)}"
                   for i in range(cfg.n_layers)))
    waves = capped_waves(cfg, JAMBA_TOP)
    toks0 = padded(waves[0])
    assert toks0.shape[1] == JAMBA_TOP[0], toks0.shape
    tf_toks = torch.tensor(toks0[:JAMBA_TF_BATCH], device=device)

    # 15a. float32 teacher-forced on the first layers, with no bf16 model
    # resident: init_model draws the layers in order, so these are the
    # first layers of the served model, widened
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    k32 = JAMBA_TF_DEPTH_F32
    cut = dataclasses.replace(cfg, n_layers=k32)
    params = init_model(cut, seed=SEED, device=device)
    probe = float(params["layers"][k32 - 1]["attn"]["wq"].float().sum())
    params = as_float32(params)
    cfg32 = dataclasses.replace(cut, dtype="float32", param_dtype="float32",
                                capacity_factor=JAMBA_TF_CAPACITY)
    tf32, flip32, nflip32 = routed_teacher_forced(params, cfg32, tf_toks,
                                                  JAMBA_TF_PREFIX)
    del params
    torch.cuda.empty_cache()
    peak32 = torch.cuda.max_memory_allocated() / 2 ** 30
    span = f"{JAMBA_TF_PREFIX}..{JAMBA_TF_PREFIX + TF_STEPS - 1}"
    say(f"jamba float32, first {k32} layers, B={JAMBA_TF_BATCH}, capacity "
        f"{JAMBA_TF_CAPACITY:g} ({time.perf_counter() - t0:.1f}s, peak "
        f"{peak32:.1f} GiB): decode_step vs forward logits at {span}: max "
        f"rel err {float(tf32.max()):.3g} (tol {TF_TOL[f32]}); {nflip32} "
        f"routings differ")
    assert float(tf32.max()) < TF_TOL[f32], float(tf32.max())

    # 15b. serving; only its launches count
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_model(cfg, seed=SEED, device=device)
    torch.cuda.synchronize()
    assert float(params["layers"][k32 - 1]["attn"]["wq"].float().sum()) \
        == probe
    say(f"jamba init {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    served, launches, prefills, steps, per_wave = run_jamba_serving(
        cfg, params, device, ms, fa, fd, others)
    serve_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    say(f"jamba serving path ({serve_s:.1f}s, peak {peak:.1f} GiB): "
        f"{prefills} prefills, {steps} decode steps; per wave mamba_scan "
        f"{per_wave[0]} (one per Mamba layer, none in decode), "
        f"flash_attention_fwd {per_wave[1]}, flash_decode {per_wave[2]} "
        f"(= {per_wave[1]} x {LM_NEW} steps); totals {launches}; no other "
        f"kernel; both runs of each wave gave the same tokens")

    # 15c. each Mamba mixer on its real inputs (wave 0, B = 8), then the
    # bf16 teacher-forced check over all layers
    t0 = time.perf_counter()
    xt = torch.tensor(toks0, device=device)
    mixer = jamba_mixer_errs(params, cfg, xt, JAMBA_TF_PREFIX)
    for dt, name in ((bf16, "bf16"), (f32, "float32")):
        worst = max(mixer[dt], key=lambda e: e[1])
        say(f"jamba {name}: each of the {len(mixer[dt])} Mamba mixers, step "
            f"vs full-sequence form on its real inputs at {span}: max rel "
            f"err {worst[1]:.3g} (layer {worst[0]}; tol "
            f"{MIXER_TF_TOL[dt]:.3g}); "
            + ", ".join(f"{i}: {e:.3g}" for i, e in mixer[dt]))
        for i, err in mixer[dt]:
            assert err < MIXER_TF_TOL[dt], (dt, i, err)
    cfg16 = dataclasses.replace(cfg, capacity_factor=JAMBA_TF_CAPACITY)
    tf16, flip16, nflip16 = routed_teacher_forced(params, cfg16, tf_toks,
                                                  JAMBA_TF_PREFIX)
    kept = ~flip16
    n_rows, n_out = flip16.numel(), int(flip16.sum())
    tf16_err = float(tf16[kept].max()) if kept.any() else float("inf")
    say(f"jamba bf16, all {cfg.n_layers} layers, B={JAMBA_TF_BATCH}, "
        f"capacity {JAMBA_TF_CAPACITY:g} ({time.perf_counter() - t0:.1f}s "
        f"with the mixers): decode_step vs forward logits at {span}: max "
        f"rel err {tf16_err:.3g} over the {n_rows - n_out} of {n_rows} rows "
        f"routed alike (tol {TF_TOL[bf16]}); {nflip16} (step, row, layer) "
        f"routings flipped, {n_out} rows left out (all rows: "
        f"{float(tf16.max()):.3g})")
    assert n_out <= JAMBA_MAX_EXCLUDED * n_rows, (n_out, n_rows)
    assert tf16_err < TF_TOL[bf16], tf16_err

    # 16. timings of the jamba path
    b, p0 = LM_BATCH, toks0.shape[1]
    di, n = cfg.mamba_expand * cfg.d_model, cfg.mamba_d_state
    trng = np.random.RandomState(SEED + 5)
    dt_, a_, x_, b_, c_ = mamba_inputs(trng, b, p0, di, n, (0.0, 1.0), bf16,
                                       device)
    y_ = torch.empty((b, p0, di), dtype=f32, device=device)
    h_ = torch.empty((b, di, n), dtype=f32, device=device)
    ms_launch = lambda: ms._launch(dt_, a_, x_, b_, c_, y_, h_)
    ms_ms = median_ms(ms_launch, burst=10, reps=10)
    ms_graph_ms = graph_ms(ms_launch, calls=10)
    ms_plain_ms = median_ms(lambda: ms.selective_scan_plain(
        dt_, a_, x_, b_, c_, return_state=True), burst=1, reps=3, warmup=1)
    ms_ms2 = median_ms(ms_launch, burst=10, reps=10)
    fl, nb = mamba_work(b, p0, di, n)
    ms_bound, ms_by = bound(fl, nb, FP32_FLOPS)
    clock = max_sm_clock_hz()
    ms_floor = mamba_exp_floor_ms(b, p0, di, n, clock)
    ms_regs = ptxas_usage("mamba_scan", f"mamba_scan_kernelI13__nv_bfloat16"
                                        f"Li{n}E")
    say(f"mamba_scan at B={b} S={p0} D={di} N={n} (x bf16) on {card}: "
        f"kernel {ms_graph_ms:.4f} ms in a CUDA graph, back to back "
        f"{ms_ms:.4f} ms (again {ms_ms2:.4f}), plain {ms_plain_ms:.4f} ms, "
        f"bound {ms_bound:.5f} ms by {ms_by} ({fl / 1e9:.3f} GFLOP fp32, "
        f"{nb / 1e6:.1f} MB); the {b * p0 * di * n / 1e9:.3f} G precise "
        f"exponentials alone take at least {ms_floor:.5f} ms on the SFU "
        f"pipe (computed at the rated highest SM clock, {clock / 1e9:.3f} "
        f"GHz); no library call; ptxas {ms_regs}")
    del dt_, a_, x_, b_, c_, y_, h_
    first = [runs[0][1] for runs in served]
    for w, stt in enumerate(first):
        say(f"jamba wave {w}: P={padded(waves[w]).shape[1]}, prefill "
            f"{stt.prefill_s * 1e3:.1f} ms, decode {stt.decode_steps} steps "
            f"{stt.decode_s * 1e3 / stt.decode_steps:.2f} ms/step, "
            f"{stt.tokens_out} tokens at {stt.decode_tok_s:.1f} tok/s")
    names = ("mamba_scan", "fa_fwd", "fd_kernel")
    pf = lambda: (prefill(params, cfg, {"tokens": xt}, cache_len=LM_MAX_LEN),
                  torch.cuda.synchronize())
    pf_wall = median_wall_ms(pf, reps=3, warmup=1)
    pf_busy, pf_per, pf_kernels = profile_device(pf, reps=1, names=names)
    before = (ms.LAUNCHES, fa.LAUNCHES, fd.LAUNCHES)
    _, cache = prefill(params, cfg, {"tokens": xt}, cache_len=LM_MAX_LEN)
    mid = (ms.LAUNCHES, fa.LAUNCHES, fd.LAUNCHES)
    decode_step(params, cfg, cache, xt[:, -1:], p0)
    after = (ms.LAUNCHES, fa.LAUNCHES, fd.LAUNCHES)
    one_prefill = tuple(m - a for m, a in zip(mid, before))
    one_step = tuple(z - m for z, m in zip(after, mid))
    assert one_prefill == per_wave[:2] + (0,), one_prefill
    assert one_step == (0, 0, per_wave[1]), one_step
    n_loop = 16

    def decode_loop():
        tok = xt[:, -1:]
        for i in range(n_loop):
            logits, _ = decode_step(params, cfg, cache, tok, p0 + 1 + i)
            tok = logits[:, -1:].argmax(dim=-1)
            tok.tolist()                   # the engine's host fetch
    dec_wall = median_wall_ms(decode_loop, reps=3, warmup=1) / n_loop
    dec_busy, dec_per, dec_kernels = profile_device(decode_loop, reps=1,
                                                    names=names)
    dec_busy, dec_kernels = dec_busy / n_loop, dec_kernels / n_loop
    pf_top = top_device_kernels(pf)
    dec_top = top_device_kernels(lambda: decode_step(
        params, cfg, cache, xt[:, -1:], p0 + 1))
    for what, top in (("prefill", pf_top), ("decode step", dec_top)):
        say(f"jamba {what}, most device time: " + "; ".join(
            f"{nm} {t:.2f} ms x{c}" for nm, t, c in top))
    say(f"jamba prefill of wave 0 (B={b}, P={p0}): {pf_wall:.2f} ms wall, "
        f"device busy {pf_busy:.2f} ms (mamba_scan "
        f"{pf_per['mamba_scan']:.2f} ms, flash_attention_fwd "
        f"{pf_per['fa_fwd']:.2f} ms), idle share {1 - pf_busy / pf_wall:.3f},"
        f" {pf_kernels:.0f} kernels; one prefill launches (mamba_scan, "
        f"flash_attention_fwd, flash_decode) {one_prefill}")
    say(f"jamba decode step (B={b}): {dec_wall:.3f} ms wall, device busy "
        f"{dec_busy:.3f} ms (flash_decode {dec_per['fd_kernel'] / n_loop:.3f}"
        f" ms), idle share {1 - dec_busy / dec_wall:.3f}, "
        f"{dec_kernels:.0f} kernels per step; one step launches {one_step}")
    del cache, params
    torch.cuda.empty_cache()
    say(json.dumps({"card": card, "serving_jamba": {
        "arch": JAMBA_ARCH, "n_layers": cfg.n_layers, "batch": LM_BATCH,
        "new_tokens": LM_NEW, "max_len": LM_MAX_LEN,
        "peak_gib": {"serving": peak, "float32_check": peak32},
        "waves": [{"P": int(padded(waves[w]).shape[1]),
                   "prefill_ms": stt.prefill_s * 1e3,
                   "decode_ms_per_step": stt.decode_s * 1e3 / stt.decode_steps,
                   "decode_tok_s": stt.decode_tok_s}
                  for w, stt in enumerate(first)],
        "mixer_teacher_forced_rel_err": {
            "bf16": mixer[bf16], "float32": mixer[f32]},
        f"teacher_forced_rel_err_{k32}_layers_float32": float(tf32.max()),
        "teacher_forced_rel_err_bf16": tf16_err,
        "teacher_forced_routings_flipped_bf16": nflip16,
        "teacher_forced_rows_left_out_bf16": n_out,
        "prefill": {"wall_ms": pf_wall, "busy_ms": pf_busy,
                    "mamba_scan_ms": pf_per["mamba_scan"],
                    "flash_attention_ms": pf_per["fa_fwd"],
                    "kernels": pf_kernels},
        "decode_step": {"wall_ms": dec_wall, "busy_ms": dec_busy,
                        "flash_decode_ms": dec_per["fd_kernel"] / n_loop,
                        "kernels": dec_kernels},
        "top_kernels": {"prefill": pf_top, "decode_step": dec_top}}}))
    return {"launches": launches, "ms": ms_graph_ms,
            "graph_ms": ms_graph_ms, "back_to_back_ms": ms_ms,
            "plain_ms": ms_plain_ms, "bound_ms": ms_bound, "bound_by": ms_by,
            "ptxas": ms_regs,
            "shape": {"B": b, "S": p0, "D": di, "N": n,
                      "x_dtype": "bfloat16"}}


def main() -> int:
    if not torch.cuda.is_available():
        say("chip_smoke: torch.cuda.is_available() is False; needs a card")
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    name = torch.cuda.get_device_name(0)

    # 1. the card
    card = card_line()
    say(card)
    say(f"torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. build, one nvcc per source, all started together
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.core.model import init_enel
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_decode import ops as fd
    from repro_torch.kernels.graph_prop import ops
    from repro_torch.kernels.mamba_scan import ops as ms
    from repro_torch.kernels.mlstm_chunk import ops as ml
    from repro_torch.kernels.sim_step import ops as ss
    t0 = time.perf_counter()
    with ThreadPoolExecutor(7) as pool:
        builds = [pool.submit(fn) for fn in (ops._kernel_fn,
                                             ops._bwd_kernel_fn,
                                             fa._kernel_fn, fd._kernel_fn,
                                             ml._kernel_fn, ms._kernel_fn,
                                             ss._kernel_fn)]
        for fut in builds:
            fut.result()
    say(f"build: {time.perf_counter() - t0:.2f}s wall")
    for kname in ("graph_prop_fwd", "graph_prop_bwd", "flash_attention_fwd",
                  "flash_decode", "mlstm_chunk", "mamba_scan", "sim_step"):
        info = build.BUILDS[kname]
        say(f"build {kname}: nvcc {info.seconds:.2f}s, "
            f"compiled={info.compiled}")
        say("\n".join(line for line in info.log.splitlines()
                      if "registers" in line or "spill" in line))

    # 3. kernels vs plain
    params = init_enel(torch.Generator().manual_seed(SEED), device=device)
    rng = np.random.RandomState(SEED)
    max_err = 0.0
    for n in (4, 8, 16):
        for levels in (1, 3, 8):
            for b in (1, 7, 357):
                x, adj, m, valid = random_inputs(rng, b, n, device)
                e, mh = ops.graph_prop(params, x, adj, m, valid,
                                       levels=levels)
                torch.cuda.synchronize()
                pe, pm = ops.graph_prop_plain(params, x, adj, m, valid,
                                              levels=levels)
                err_e = close(e, pe, f"e N={n} levels={levels} B={b}")
                err_m = close(mh, pm, f"m_hat N={n} levels={levels} B={b}")
                max_err = max(max_err, err_e, err_m)
                say(f"  kernel vs plain N={n:2d} levels={levels} B={b:3d}: "
                    f"max|de|={err_e:.3g} max|dm|={err_m:.3g}")
    say(f"kernel vs plain: max abs err {max_err:.3g} "
        f"(atol={ATOL}, rtol={RTOL})")
    names = ("gx", "gm_obs", "gw31", "gb31", "gw32", "gb32", "g_attn",
             "gw41", "gb41", "gw42", "gb42")
    max_err_bwd = 0.0
    for n in (4, 8, 16):
        for levels in (1, 3, 8):
            for b in (1, 7, 96):
                x, adj, m, valid = random_inputs(rng, b, n, device)
                g_e = torch.tensor(rng.randn(b, n, n).astype(np.float32),
                                   device=device)
                g_m = torch.tensor(rng.randn(b, n, 5).astype(np.float32),
                                   device=device)
                w = ops._weights(params)
                got = ops._launch_bwd(x, adj, m, valid, w, g_e, g_m, levels)
                again = ops._launch_bwd(x, adj, m, valid, w, g_e, g_m,
                                        levels)
                torch.cuda.synchronize()
                ref = ops.graph_prop_vjp_plain(params, x, adj, m, valid, g_e,
                                               g_m, levels=levels)
                errs = []
                for nm, a, a2, r in zip(names, got, again, ref):
                    assert torch.equal(a, a2), \
                        f"{nm} N={n} levels={levels} B={b}: not repeatable"
                    errs.append(close(a, r, f"{nm} N={n} levels={levels} "
                                      f"B={b}", ATOL_BWD, RTOL_BWD))
                max_err_bwd = max(max_err_bwd, max(errs))
                say(f"  bwd kernel vs plain VJP N={n:2d} levels={levels} "
                    f"B={b:2d}: max abs err {max(errs):.3g}, repeat "
                    f"bit-equal")
    say(f"bwd kernel vs plain VJP: max abs err {max_err_bwd:.3g} "
        f"(atol={ATOL_BWD}, rtol={RTOL_BWD}); two launches bit-equal")
    # edge cases at every hidden-slice count (N <= 4: 8 slices, <= 8: 4,
    # <= 16: 2), levels 0 and 64, one launch per call, repeats bit-equal
    w = ops._weights(params)
    for n in (1, 3, 5, 9, 16):
        for kind in EDGE_KINDS:
            x, adj, m, valid = random_inputs(rng, 95, n, device, kind)
            g_e = torch.tensor(rng.randn(95, n, n).astype(np.float32),
                               device=device)
            g_m = torch.tensor(rng.randn(95, n, 5).astype(np.float32),
                               device=device)
            for levels in (0, 1, 8, ops.MAX_BWD_LEVELS):
                what = f"N={n} levels={levels} B=95 {kind}"
                before = (ops.LAUNCHES, ops.LAUNCHES_BWD)
                e, mh = ops.graph_prop(params, x, adj, m, valid,
                                       levels=levels)
                e2, mh2 = ops.graph_prop(params, x, adj, m, valid,
                                         levels=levels)
                got = ops._launch_bwd(x, adj, m, valid, w, g_e, g_m, levels)
                again = ops._launch_bwd(x, adj, m, valid, w, g_e, g_m,
                                        levels)
                torch.cuda.synchronize()
                assert (ops.LAUNCHES, ops.LAUNCHES_BWD) == \
                    (before[0] + 2, before[1] + 2), what
                assert torch.equal(e, e2) and torch.equal(mh, mh2), what
                pe, pm = ops.graph_prop_plain(params, x, adj, m, valid,
                                              levels=levels)
                max_err = max(max_err, close(e, pe, f"e {what}"),
                              close(mh, pm, f"m_hat {what}"))
                ref = ops.graph_prop_vjp_plain(params, x, adj, m, valid,
                                               g_e, g_m, levels=levels)
                for nm, a, a2, r in zip(names, got, again, ref):
                    assert torch.equal(a, a2), f"{nm} {what}: not repeatable"
                    max_err_bwd = max(max_err_bwd, close(
                        a, r, f"{nm} {what}", ATOL_BWD, RTOL_BWD))
        say(f"  edge cases N={n:2d} ({', '.join(EDGE_KINDS)}; levels 0, 1, "
            f"8, 64; B=95): both kernels vs plain, repeats bit-equal")
    say(f"with the edge cases: forward max abs err {max_err:.3g}, backward "
        f"{max_err_bwd:.3g}")
    t0 = time.perf_counter()
    sim_checked = check_sim_kernel(device, ss)
    sim_ffma_all, sim_ffma = sass_ffma(build.BUILDS["sim_step"].path)
    assert sim_ffma == 0, f"sim_step: {sim_ffma} contracted FFMA in its SASS"
    sim_regs = ptxas_usage("sim_step", "sim_stages_kernel")
    say(f"sim_step vs plain ({time.perf_counter() - t0:.1f}s): bit for bit "
        f"equal at every launch of the four jobs at J = 1 (two runs each) "
        f"and the 24 (job, scenario) pairs at J = 24 (a stepped run, then "
        f"run_full), failures injected; {sim_checked['stepped']} stepped and "
        f"{sim_checked['whole_run']} whole-run launches, each launched twice "
        f"bit-equal; SASS: {sim_ffma_all} FFMA, all inside IEEE divisions, "
        f"{sim_ffma} contracted; ptxas {sim_regs}")

    # 4. the decision path; only its launches count
    with PickRecorder() as picks:
        ops.LAUNCHES = ops.LAUNCHES_BWD = 0
        jobs = {key: run_job(key, device, ops, picks) for key in JOB_KEYS}
        torch.cuda.synchronize()
        launches, launches_bwd = ops.LAUNCHES, ops.LAUNCHES_BWD
    n_decisions = sum(j["decisions"] for j in jobs.values())
    assert launches == n_decisions > 0, (launches, n_decisions)
    assert launches_bwd == 0, launches_bwd
    say(f"decision path: {n_decisions} decisions, graph_prop_fwd launched "
        f"{launches} times")
    n_rec, n_differ = picks.compare(device)
    assert n_rec == n_decisions, (n_rec, n_decisions)
    say(f"decision path picks, kernel vs plain route: {n_differ} of {n_rec} "
        f"differ (each within {PICK_RTOL} of the target)")
    pick_parity = {"decision": [n_rec, n_differ]}

    # 5. timings at the LR decision shape
    p, template, deltas = jobs["lr"]["sweep"]
    flat, levels = sweep_flat(template, deltas, device)
    from repro_torch.core import model
    _, _, x, adj = model._prelude(flat)
    args = (p, x, adj, flat["metrics"], flat["metrics_valid"])
    b, n = x.shape[:2]
    launch = raw_launcher(ops, *args, levels)
    kernel_ms = median_ms(launch, burst=50)
    kernel_graph_ms = graph_ms(launch)
    plain_ms = median_ms(
        lambda: ops.graph_prop_plain(*args, levels=levels), burst=10)
    call_ms = median_ms(lambda: ops.graph_prop(*args, levels=levels),
                        burst=50)
    kernel_ms2 = median_ms(launch, burst=50)
    flops, nbytes = graph_prop_work(b, n, levels)
    bound_ms = max(flops / FP32_FLOPS, nbytes / HBM_BYTES) * 1e3
    bound_by = "operations" if flops / FP32_FLOPS >= nbytes / HBM_BYTES \
        else "bytes"
    prof_kernel_ms = profile_device(launch, reps=50)[1]["graph_prop"]
    dec_shape = {"B": b, "N": n, "levels": levels}
    fwd_regs = ptxas_usage(
        "graph_prop_fwd",
        f"graph_prop_fwd_kernelILi{ops.launch_plan(n, levels).slices}E")
    say(f"timing at B={b} N={n} levels={levels} on {card}: kernel "
        f"{kernel_graph_ms:.4f} ms in a CUDA graph, back to back "
        f"{kernel_ms:.4f} (again {kernel_ms2:.4f}; profiler "
        f"{prof_kernel_ms:.4f}; through the wrapper {call_ms:.4f}), plain "
        f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms by {bound_by} "
        f"({flops / 1e6:.1f} MFLOP, {nbytes / 1e6:.3f} MB); ptxas {fwd_regs}")
    # the device half of an LR decision: assembly, kernel, readout, copy
    trainer = jobs["lr"]["trainer"]
    sweep = lambda: trainer.predict_sweep_device(template, deltas).cpu()
    sweep_ms = median_wall_ms(sweep)
    busy_ms, per, sweep_kernels = profile_device(sweep)
    sweep_kernel_ms = per["graph_prop"]
    say(f"LR sweep evaluation (C x K = {b}): {sweep_ms:.3f} ms wall, device "
        f"busy {busy_ms:.3f} ms (graph_prop {sweep_kernel_ms:.3f} ms), "
        f"idle share {1 - busy_ms / sweep_ms:.3f}, {sweep_kernels:.0f} "
        f"kernels")
    for key, j in jobs.items():
        c, k = j["largest"]
        say(f"recommend {key}: {j['decisions']} decisions, per decision "
            f"median {j['recommend_ms_median']:.2f} ms, p90 "
            f"{j['recommend_ms_p90']:.2f} ms (largest sweep {c}x{k})")

    say(json.dumps({"card": card, "recommend_ms": {
        key: {"median": j["recommend_ms_median"], "p90": j["recommend_ms_p90"]}
        for key, j in jobs.items()}}))

    # 6. the training path; only its launches count
    from repro_torch.sim.chaos import ChaosSpec
    with PickRecorder() as picks:
        ops.LAUNCHES = ops.LAUNCHES_BWD = 0
        t0 = time.perf_counter()
        train = {key: run_training(key, device, picks=picks)
                 for key in JOB_KEYS}
        train["kmeans-chaos"] = run_training(
            "kmeans", device, picks=picks,
            chaos=ChaosSpec(name="smoke", nan_graphs_every=2,
                            cache_corrupt_every=3, nan_fit_every=4))
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        t_launches, t_launches_bwd = ops.LAUNCHES, ops.LAUNCHES_BWD
    steps = sum(t["steps"] for t in train.values())
    t_decisions = sum(t["decisions"] for t in train.values())
    # the service decides with the sparse engine (plain ops): the forward
    # kernel launches once per Adam step only
    assert t_launches_bwd == steps > 0, (t_launches_bwd, steps)
    assert t_launches == steps, (t_launches, steps, t_decisions)
    say(f"training path ({train_s:.1f}s): {steps} Adam steps, "
        f"{t_decisions} decisions through DecisionService; graph_prop_bwd "
        f"launched {t_launches_bwd} times, graph_prop_fwd {t_launches}")
    ops.LAUNCHES = 0
    n_rec, n_differ, n_fell, totals_rel = picks.compare_service(device)
    torch.cuda.synchronize()
    replay_launches = ops.LAUNCHES
    assert n_rec == t_decisions, (n_rec, t_decisions)
    assert replay_launches == n_rec, (replay_launches, n_rec)
    say(f"training path picks, service (sparse) vs dense kernel route: "
        f"{n_differ} of {n_rec - n_fell} differ (each within {PICK_RTOL} of "
        f"the target); totals max rel diff {totals_rel:.3g} (limit "
        f"{SPARSE_RTOL}); {n_fell} guardrail fallbacks replay non-finite; "
        f"the check launched graph_prop_fwd {replay_launches} times")
    pick_parity["training"] = [n_rec, n_differ]
    chaos = train["kmeans-chaos"]
    say(f"chaos (K-Means): {chaos['quarantined']} rows quarantined, "
        f"{chaos['skipped']} steps skipped, {chaos['fallbacks']} fallback "
        f"decisions, params finite after the scratch retrain")

    # 7. timings of the training path
    ex = train["lr"]["experiment"]
    tr = ex.trainer
    ring, _ = tr.cache.full_batch()
    _, _, x, adj = model._prelude(ring)
    b, n = x.shape[:2]
    lv = model.MAX_LEVELS
    m, valid = ring["metrics"], ring["metrics_valid"]
    g_e = torch.tensor(rng.randn(b, n, n).astype(np.float32), device=device)
    g_m = torch.tensor(rng.randn(b, n, 5).astype(np.float32), device=device)
    targs = (tr.params, x, adj, m, valid)
    blaunch = bwd_raw_launcher(ops, *targs, g_e, g_m, lv)
    flaunch = raw_launcher(ops, *targs, lv)
    bwd_ms = median_ms(blaunch, burst=50)
    bwd_graph_ms = graph_ms(blaunch)
    fwd_train_ms = median_ms(flaunch, burst=50)
    fwd_train_graph_ms = graph_ms(flaunch)
    bwd_plain_ms = median_ms(lambda: ops.graph_prop_vjp_plain(
        *targs, g_e, g_m, levels=lv), burst=5)
    fwd_train_plain_ms = median_ms(
        lambda: ops.graph_prop_plain(*targs, levels=lv), burst=10)
    bwd_ms2 = median_ms(blaunch, burst=50)
    slices = ops.launch_plan(n, lv).slices
    bwd_regs = ptxas_usage("graph_prop_bwd",
                           f"graph_prop_bwd_kernelILi{slices}E")
    fwd_train_regs = ptxas_usage("graph_prop_fwd",
                                 f"graph_prop_fwd_kernelILi{slices}E")
    bflops, bbytes = graph_prop_bwd_work(b, n, lv)
    bwd_bound_ms = max(bflops / FP32_FLOPS, bbytes / HBM_BYTES) * 1e3
    bwd_bound_by = "operations" if bflops / FP32_FLOPS >= \
        bbytes / HBM_BYTES else "bytes"
    ff, fb = graph_prop_work(b, n, lv)
    fwd_train_bound = max(ff / FP32_FLOPS, fb / HBM_BYTES) * 1e3
    fwd_train_by = "operations" if ff / FP32_FLOPS >= fb / HBM_BYTES \
        else "bytes"
    say(f"backward timing at B={b} N={n} levels={lv} on {card}: kernel "
        f"{bwd_graph_ms:.4f} ms in a CUDA graph, back to back {bwd_ms:.4f} "
        f"(again {bwd_ms2:.4f}), plain VJP {bwd_plain_ms:.4f} ms, bound "
        f"{bwd_bound_ms:.5f} ms by {bwd_bound_by} ({bflops / 1e6:.1f} MFLOP "
        f"incl. the forward recompute, {bbytes / 1e6:.3f} MB); ptxas "
        f"{bwd_regs}")
    say(f"forward timing at B={b} N={n} levels={lv} on {card}: kernel "
        f"{fwd_train_graph_ms:.4f} ms in a CUDA graph, back to back "
        f"{fwd_train_ms:.4f}, plain {fwd_train_plain_ms:.4f} ms, bound "
        f"{fwd_train_bound:.5f} ms by {fwd_train_by} ({ff / 1e6:.1f} MFLOP, "
        f"{fb / 1e6:.3f} MB); ptxas {fwd_train_regs}")
    scratch_fit = lambda: tr.fit_resident(steps=160, from_scratch=True)
    fit_wall_ms = median_wall_ms(scratch_fit, reps=3, warmup=1)
    f_busy, per, f_kernels = profile_device(
        scratch_fit, reps=2,
        names=("graph_prop_fwd", "graph_prop_bwd", "sum_slots"))
    f_fwd = per["graph_prop_fwd"]
    f_bwd = per["graph_prop_bwd"] + per["sum_slots"]
    n_steps = 128
    say(f"LR scratch fit ({n_steps} steps, B={b}): {fit_wall_ms:.1f} ms "
        f"wall, device busy {f_busy:.1f} ms (graph_prop_fwd {f_fwd:.2f}, "
        f"graph_prop_bwd {f_bwd:.2f}; {(f_fwd + f_bwd) / f_busy:.3f} of "
        f"busy), idle share {1 - f_busy / fit_wall_ms:.3f}, "
        f"{f_kernels / n_steps:.0f} kernels per step, "
        f"{fit_wall_ms / n_steps:.2f} ms per step")
    fits = {}
    for key, t in train.items():
        sc = [f[0] for f in t["scratch"]]
        tu = [f[0] for f in t["tune"]]
        fits[key] = {"scratch_s": sc, "tune_s_median": float(np.median(tu)),
                     "tune_n": len(tu),
                     "scratch_loss": [(f[1], f[2]) for f in t["scratch"]]}
        say(f"fit {key}: scratch {', '.join(f'{v:.3f}' for v in sc)} s, "
            f"fine-tune median {np.median(tu):.3f} s over {len(tu)}; "
            f"scratch losses first -> last "
            f"{', '.join(f'{a:.3g} -> {z:.3g}' for _, a, z in t['scratch'])}")
    compliance = {}
    for key in JOB_KEYS:
        runs = train[key]["runs"]
        enel = [r for r in runs if r.kind == "enel"]
        ellis = [r for r in runs if r.kind == "ellis"]
        compliance[key] = {
            "target": enel[0].target,
            "enel": [(float(r.runtime), float(r.violation), r.n_failures)
                     for r in enel],
            "ellis": [(float(r.runtime), float(r.violation), r.n_failures)
                      for r in ellis],
            "enel_cvc": float(np.mean([r.cvc for r in enel])),
            "enel_cvs_min": float(np.mean([r.violation for r in enel])) / 60,
            "ellis_cvc": float(np.mean([r.cvc for r in ellis])),
            "ellis_cvs_min": float(np.mean([r.violation for r in ellis]))
            / 60}
        say(f"compliance {key}: target {enel[0].target:.1f}s; Enel runs "
            + ", ".join(f"{r.runtime:.1f}s(+{r.violation:.1f})" for r in enel)
            + "; Ellis "
            + ", ".join(f"{r.runtime:.1f}s(+{r.violation:.1f})"
                        for r in ellis))
    say(json.dumps({"card": card, "training": {
        "steps": steps, "decisions": t_decisions, "seconds": train_s,
        "fits": fits, "compliance": compliance,
        "scratch_fit": {"wall_ms": fit_wall_ms, "busy_ms": f_busy,
                        "fwd_ms": f_fwd, "bwd_ms": f_bwd,
                        "kernels_per_step": f_kernels / n_steps}}}))

    # 8. the LM attention kernels vs plain
    t0 = time.perf_counter()
    lm_errs = check_lm_kernels(device, fa, fd)
    say(f"LM kernels vs plain ({time.perf_counter() - t0:.1f}s): mha max abs "
        f"err f32 {lm_errs['mha'][torch.float32]:.3g} (tol 2e-5), bf16 "
        f"{lm_errs['mha'][torch.bfloat16]:.3g} (tol 3e-2); decode_attn f32 "
        f"{lm_errs['decode'][torch.float32]:.3g}, bf16 "
        f"{lm_errs['decode'][torch.bfloat16]:.3g}; every case bit-equal "
        f"twice")

    # 9. the serving path; only its launches count
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    torch.set_grad_enabled(False)
    cfg = get_config(LM_ARCH)
    t0 = time.perf_counter()
    lm_params = init_model(cfg, seed=SEED, device=device)
    torch.cuda.synchronize()
    say(f"{LM_ARCH}: {cfg.n_layers} layers, d_model {cfg.d_model}, vocab "
        f"{cfg.vocab_size}, {cfg.param_dtype}; init "
        f"{time.perf_counter() - t0:.1f}s")
    waves, served, lm_launches, n_prefill, n_steps = run_serving(
        cfg, lm_params, device, fa, fd)
    fa_launches, fd_launches = lm_launches
    say(f"serving path: {n_prefill} prefills, {n_steps} decode steps; "
        f"flash_attention_fwd launched {fa_launches} times "
        f"(= {cfg.n_layers} x {n_prefill}), flash_decode {fd_launches} "
        f"(= {cfg.n_layers} x {n_steps}); both runs of each wave gave the "
        f"same tokens")
    toks0 = padded(waves[0])
    p0 = toks0.shape[1]
    gen0 = np.array(served[0][0][0])[:, :TF_STEPS]
    tf_toks = torch.tensor(np.concatenate([toks0, gen0], axis=1),
                           device=device)
    tf_err = {torch.bfloat16: teacher_forced_err(lm_params, cfg, tf_toks, p0)}
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    params32 = as_float32(lm_params)
    tf_err[torch.float32] = teacher_forced_err(params32, cfg32, tf_toks, p0)
    del params32
    torch.cuda.empty_cache()
    for dt, err in tf_err.items():
        assert err < TF_TOL[dt], (dt, err)
    say(f"teacher-forced decode_step vs forward logits at positions "
        f"{p0}..{p0 + TF_STEPS - 1} (B = {LM_BATCH}): max rel err bf16 "
        f"{tf_err[torch.bfloat16]:.3g} (tol {TF_TOL[torch.bfloat16]}), "
        f"float32 weights {tf_err[torch.float32]:.3g} (tol "
        f"{TF_TOL[torch.float32]})")

    # 10. timings of the serving path
    import torch.nn.functional as F
    from repro_torch.models import decode_step, prefill
    bf16 = torch.bfloat16
    b, h, kh, d = LM_BATCH, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    trng = np.random.RandomState(SEED + 1)
    q = _randn(trng, (b, p0, h, d), bf16, device)
    k, v = (_randn(trng, (b, p0, kh, d), bf16, device) for _ in range(2))
    out = torch.empty_like(q)
    fa_launch = lambda: fa._launch(q, k, v, out, True, 0, 0.0, 0)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    fa_ms = median_ms(fa_launch, burst=10)
    fa_plain_ms = median_ms(lambda: fa.mha_plain(q, k, v), burst=2, reps=5)
    fa_lib_ms = median_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), burst=10)
    fa_ms2 = median_ms(fa_launch, burst=10)
    fa_dev = graph_ms(fa_launch)
    fa_lib_dev = graph_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True))
    fl, nb = prefill_work(b, p0, h, kh, d)
    fa_bound, fa_by = bound(fl, nb, BF16_FLOPS)
    fa_regs = ptxas_usage("flash_attention_fwd", f"fa_fwd_tcILi{d}E")
    say(f"flash_attention_fwd at B={b} S={p0} H={h} Kh={kh} D={d} bf16 "
        f"causal on {card}: kernel {fa_ms:.4f} ms (again {fa_ms2:.4f}; in "
        f"a CUDA graph {fa_dev:.4f}), plain {fa_plain_ms:.4f} ms, SDPA "
        f"{fa_lib_ms:.4f} ms (in a CUDA graph {fa_lib_dev:.4f}), bound "
        f"{fa_bound:.5f} ms by {fa_by} ({fl / 1e9:.2f} GFLOP, "
        f"{nb / 1e6:.1f} MB; {1.5 * fl / fa_dev / 1e9:.0f} TFLOP/s of "
        f"tensor-core work with P split in hi + lo); ptxas {fa_regs}")
    del q, k, v, out, qt, kt, vt
    pos_main = p0 + LM_NEW - 1          # wave 0's last decode position
    fd_times = {}
    # The loop reads each layer's cache once per step, 27 other layers
    # apart, so it finds the cache cold: every timed call below takes the
    # next of LM_COPIES caches, which together exceed the 50 MB L2.
    caches = [tuple(_randn(trng, (b, LM_MAX_LEN, kh, d), bf16, device)
                    for _ in range(2)) for _ in range(LM_COPIES)]
    qd = _randn(trng, (b, 1, h, d), bf16, device)
    qdt = qd.transpose(1, 2).contiguous()
    outd = torch.empty_like(qd)
    for pos in (pos_main, LM_MAX_LEN - 1):
        rows = [tuple(x[:, :pos + 1].transpose(1, 2).contiguous()
                      for x in kv) for kv in caches]
        turn = itertools.cycle(range(LM_COPIES))
        fd_launch = lambda: fd._launch(qd, *caches[next(turn)], outd, pos,
                                       0, 0.0)
        t_k = median_ms(fd_launch, burst=50)
        t_p = median_ms(lambda: fd.decode_attn_plain(
            qd, *caches[next(turn)], pos), burst=10)
        t_l = median_ms(lambda: F.scaled_dot_product_attention(
            qdt, *rows[next(turn)], enable_gqa=True), burst=50)
        t_k2 = median_ms(fd_launch, burst=50)
        t_dev = graph_ms(fd_launch, calls=48)
        t_l_dev = graph_ms(lambda: F.scaled_dot_product_attention(
            qdt, *rows[next(turn)], enable_gqa=True), calls=48)
        del rows
        fl, nb = decode_work(b, h, kh, d, pos)
        t_b, by = bound(fl, nb, BF16_FLOPS)
        plan = fd.split_plan(b, kh, 0, pos)
        fd_times[pos] = {"ms": t_dev, "back_to_back_ms": t_k, "again": t_k2,
                         "plain_ms": t_p, "library_ms": t_l_dev,
                         "library_back_to_back_ms": t_l, "bound_ms": t_b,
                         "bound_by": by, "split_plan": plan}
        say(f"flash_decode at B={b} H={h} Kh={kh} D={d} cache "
            f"{LM_MAX_LEN} pos={pos} bf16, L2 cold, on {card}: kernel in a "
            f"CUDA graph {t_dev:.4f} ms (back-to-back calls {t_k:.4f}, again "
            f"{t_k2:.4f}: host-bound), plain {t_p:.4f} ms, SDPA in a CUDA "
            f"graph {t_l_dev:.4f} ms (back-to-back {t_l:.4f}), bound "
            f"{t_b:.5f} ms by {by} ({nb / 1e6:.2f} MB; "
            f"{nb / t_dev / 1e6:.0f} GB/s); "
            f"(chunk, chunks) {plan}, {b * kh * plan[1]} blocks")
    fd_regs = {g: ptxas_usage("flash_decode",
                              f"fd_kernelI13__nv_bfloat16Li128ELi{g}E")
               for g in (2, 4)}
    say(f"flash_decode ptxas at D = 128, bf16: group 2 (qwen3) "
        f"{fd_regs[2]}, group 4 (jamba) {fd_regs[4]}")
    del caches, qd, qdt, outd
    first = [runs[0][1] for runs in served]
    for w, st in enumerate(first):
        say(f"wave {w}: P={padded(waves[w]).shape[1]}, prefill "
            f"{st.prefill_s * 1e3:.1f} ms, decode {st.decode_steps} steps "
            f"{st.decode_s * 1e3 / st.decode_steps:.2f} ms/step, "
            f"{st.tokens_out} tokens at {st.decode_tok_s:.1f} tok/s")
    t0_dev = torch.tensor(toks0, device=device)
    pf = lambda: (prefill(lm_params, cfg, {"tokens": t0_dev},
                          cache_len=LM_MAX_LEN), torch.cuda.synchronize())
    pf_wall = median_wall_ms(pf, reps=5, warmup=1)
    pf_busy, pf_per, pf_kernels = profile_device(pf, reps=2,
                                                 names=("fa_fwd",))
    _, cache = prefill(lm_params, cfg, {"tokens": t0_dev},
                       cache_len=LM_MAX_LEN)
    n_loop = 16

    def decode_loop():
        tok = t0_dev[:, -1:]
        for i in range(n_loop):
            logits, _ = decode_step(lm_params, cfg, cache, tok, p0 + i)
            tok = logits[:, -1:].argmax(dim=-1)
            tok.tolist()                   # the engine's host fetch
    dec_wall = median_wall_ms(decode_loop, reps=5, warmup=1) / n_loop
    dec_busy, dec_per, dec_kernels = profile_device(decode_loop, reps=2,
                                                    names=("fd_kernel",))
    dec_busy, dec_kernels = dec_busy / n_loop, dec_kernels / n_loop
    dec_fd = dec_per["fd_kernel"] / n_loop
    say(f"prefill of wave 0 (B={b}, P={p0}): {pf_wall:.2f} ms wall, device "
        f"busy {pf_busy:.2f} ms (flash_attention_fwd {pf_per['fa_fwd']:.2f} "
        f"ms), idle share {1 - pf_busy / pf_wall:.3f}, {pf_kernels:.0f} "
        f"kernels")
    say(f"decode step (B={b}, pos {p0}..{p0 + n_loop - 1}): {dec_wall:.3f} "
        f"ms wall, device busy {dec_busy:.3f} ms (flash_decode "
        f"{dec_fd:.3f} ms), idle share {1 - dec_busy / dec_wall:.3f}, "
        f"{dec_kernels:.0f} kernels per step")
    del cache
    say(json.dumps({"card": card, "serving": {
        "arch": LM_ARCH, "batch": LM_BATCH, "new_tokens": LM_NEW,
        "max_len": LM_MAX_LEN,
        "waves": [{"P": int(padded(waves[w]).shape[1]),
                   "prefill_ms": st.prefill_s * 1e3,
                   "decode_ms_per_step": st.decode_s * 1e3 / st.decode_steps,
                   "decode_tok_s": st.decode_tok_s}
                  for w, st in enumerate(first)],
        "teacher_forced_rel_err": {"bf16": tf_err[torch.bfloat16],
                                   "float32": tf_err[torch.float32]},
        "prefill": {"wall_ms": pf_wall, "busy_ms": pf_busy,
                    "flash_attention_ms": pf_per["fa_fwd"]},
        "decode_step": {"wall_ms": dec_wall, "busy_ms": dec_busy,
                        "flash_decode_ms": dec_fd,
                        "kernels": dec_kernels}}}))
    del lm_params
    torch.cuda.empty_cache()

    # 11. the mLSTM kernel vs plain
    t0 = time.perf_counter()
    ml_errs = check_mlstm_kernel(device, ml)
    say(f"mLSTM kernel vs plain ({time.perf_counter() - t0:.1f}s): h max "
        f"abs err f32 {ml_errs[torch.float32]:.3g} (tol {MLSTM_TOL}), bf16 "
        f"{ml_errs[torch.bfloat16]:.3g} (atol {MLSTM_TOL}, rtol "
        f"{BF16_STEP:.3g}); state {ml_errs['state']:.3g} (tol {MLSTM_TOL}); "
        f"every case bit-equal twice")

    # 12-13. the xLSTM serving path (only its launches count), timings
    xl = xlstm_path(device, card, ml, (ops, fa, fd, ms))

    # 14. the Mamba scan kernel vs plain
    t0 = time.perf_counter()
    ms_errs = check_mamba_kernel(device, ms)
    say(f"Mamba scan kernel vs plain ({time.perf_counter() - t0:.1f}s): max "
        f"abs err y {ms_errs['y']:.3g}, h {ms_errs['h']:.3g} (each within "
        f"{MAMBA_TOL} of its largest value); every case bit-equal twice")

    # 15-16. the jamba serving path (only its launches count), timings
    jb = jamba_path(device, card, ms, fa, fd, (ops, ml))

    # 17. the decision service on the card
    service = run_service(device, card, train, ops, {
        key: j["recommend_ms_median"] for key, j in jobs.items()})
    say(json.dumps({"card": card, "service": service}))

    # 18. fleet campaigns on the card; only the campaign's launches count
    fleet = run_fleet(device, card, ops)
    say(json.dumps({"card": card, "fleet": fleet}))

    # 19. the vectorized engine on the card; only (c) and (d) count
    sim = run_sim_engine(device, card, ss, ops)
    say(json.dumps({"card": card, "sim_engine": sim}))

    # 20. the fused campaign on the card; only run_fused's launches count
    fused = run_fused_campaign(device, card, ss, ops)
    say(json.dumps({"card": card, "fused_campaign": fused}))
    f_launch = fused["launches"]

    # 21. results
    say(json.dumps({"kernels": [{
        "name": "graph_prop_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/graph_prop/csrc/graph_prop_fwd.cu",
        "replaces": "src/repro/kernels/graph_prop/kernel.py:271",
        "launches": launches + t_launches + fleet["launches"]
        + sim["graph_launches_fleet"][0] + f_launch["graph_prop_fwd"],
        "launches_by_path": {"decision": launches, "training": t_launches,
                             "fleet": fleet["launches"],
                             "sim_fleet": sim["graph_launches_fleet"][0],
                             "fused": f_launch["graph_prop_fwd"]},
        "check_launches": {"training_decision_replay": replay_launches},
        "max_abs_err": max_err,
        "ms": kernel_graph_ms, "graph_ms": kernel_graph_ms,
        "back_to_back_ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "ptxas": fwd_regs, "shape": dec_shape,
        "pick_parity": pick_parity,
        "training_shape": {
            "ms": fwd_train_graph_ms, "graph_ms": fwd_train_graph_ms,
            "back_to_back_ms": fwd_train_ms, "plain_ms": fwd_train_plain_ms,
            "bound_ms": fwd_train_bound, "bound_by": fwd_train_by,
            "ptxas": fwd_train_regs, "shape": {"B": b, "N": n, "levels": lv}},
    }, {
        "name": "graph_prop_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/graph_prop/csrc/graph_prop_bwd.cu",
        "replaces": "src/repro/kernels/graph_prop/kernel.py:208",
        "launches": t_launches_bwd + fleet["launches_bwd"]
        + sim["graph_launches_fleet"][1] + f_launch["graph_prop_bwd"],
        "launches_by_path": {"training": t_launches_bwd,
                             "fleet": fleet["launches_bwd"],
                             "sim_fleet": sim["graph_launches_fleet"][1],
                             "fused": f_launch["graph_prop_bwd"]},
        "max_abs_err": max_err_bwd,
        "ms": bwd_graph_ms, "graph_ms": bwd_graph_ms,
        "back_to_back_ms": bwd_ms, "plain_ms": bwd_plain_ms,
        "bound_ms": bwd_bound_ms, "bound_by": bwd_bound_by,
        "library_ms": None, "ptxas": bwd_regs,
        "shape": {"B": b, "N": n, "levels": lv},
    }, {
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:67",
        "launches": fa_launches + jb["launches"][1],
        "launches_by_path": {"serving": fa_launches,
                             "serving_jamba": jb["launches"][1]},
        "max_abs_err": max(lm_errs["mha"].values()),
        "max_abs_err_f32": lm_errs["mha"][torch.float32],
        "ms": fa_dev, "back_to_back_ms": fa_ms, "plain_ms": fa_plain_ms,
        "bound_ms": fa_bound, "bound_by": fa_by, "library_ms": fa_lib_dev,
        "library_back_to_back_ms": fa_lib_ms, "ptxas": fa_regs,
        "shape": {"B": b, "S": p0, "H": h, "Kh": kh, "D": d,
                  "dtype": "bfloat16", "causal": True},
    }, {
        "name": "flash_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_decode/csrc/flash_decode.cu",
        "replaces": "src/repro/kernels/flash_decode/kernel.py:58",
        "launches": fd_launches + jb["launches"][2],
        "launches_by_path": {"serving": fd_launches,
                             "serving_jamba": jb["launches"][2]},
        "max_abs_err": max(lm_errs["decode"].values()),
        "max_abs_err_f32": lm_errs["decode"][torch.float32],
        "ms": fd_times[pos_main]["ms"],
        "plain_ms": fd_times[pos_main]["plain_ms"],
        "bound_ms": fd_times[pos_main]["bound_ms"],
        "bound_by": fd_times[pos_main]["bound_by"],
        "library_ms": fd_times[pos_main]["library_ms"],
        "back_to_back_ms": fd_times[pos_main]["back_to_back_ms"],
        "split_plan": fd_times[pos_main]["split_plan"],
        "ptxas": fd_regs,
        "shape": {"B": b, "H": h, "Kh": kh, "D": d, "cache": LM_MAX_LEN,
                  "pos": pos_main, "dtype": "bfloat16"},
        "at_pos_end": fd_times[LM_MAX_LEN - 1],
    }, {
        "name": "mlstm_chunk", "route": "cuda",
        "source": "src/repro_torch/kernels/mlstm_chunk/csrc/mlstm_chunk.cu",
        "replaces": "src/repro/kernels/mlstm_chunk/kernel.py:69",
        "launches": xl["launches"],
        "launches_by_path": {"serving_xlstm": xl["launches"]},
        "max_abs_err": max(ml_errs[torch.float32], ml_errs[torch.bfloat16]),
        "max_abs_err_f32": ml_errs[torch.float32],
        "max_abs_err_state": ml_errs["state"],
        "ms": xl["ms"], "graph_ms": xl["graph_ms"],
        "back_to_back_ms": xl["back_to_back_ms"], "plain_ms": xl["plain_ms"],
        "bound_ms": xl["bound_ms"], "bound_by": xl["bound_by"],
        "library_ms": None, "ptxas": xl["ptxas"], "shape": xl["shape"],
    }, {
        "name": "mamba_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/mamba_scan/csrc/mamba_scan.cu",
        "replaces": "src/repro/kernels/mamba_scan/kernel.py:49",
        "launches": jb["launches"][0],
        "launches_by_path": {"serving_jamba": jb["launches"][0]},
        "max_abs_err": ms_errs["y"], "max_abs_err_state": ms_errs["h"],
        "ms": jb["ms"], "graph_ms": jb["graph_ms"],
        "back_to_back_ms": jb["back_to_back_ms"], "plain_ms": jb["plain_ms"],
        "bound_ms": jb["bound_ms"], "bound_by": jb["bound_by"],
        "library_ms": None, "ptxas": jb["ptxas"], "shape": jb["shape"],
    }, {
        "name": "sim_step", "route": "cuda",
        "source": "src/repro_torch/kernels/sim_step/csrc/sim_step.cu",
        "replaces": "src/repro/sim/engine.py:167",
        "replaces_what": "a lax.scan under jax.jit, no pallas_call",
        "launches": sim["launches"] + f_launch["sim_step"],
        "launches_by_path": dict(sim["launches_by_path"],
                                 fused=f_launch["sim_step"]),
        "check_launches": dict(sim["check_launches"], **{
            f"kernel_vs_plain_{k}": v for k, v in sim_checked.items()}),
        "max_abs_err": 0.0,
        "ms": sim["kernel"][4]["ms"], "graph_ms": sim["kernel"][4]["ms"],
        "back_to_back_ms": sim["kernel"][4]["back_to_back_ms"],
        "plain_ms": sim["kernel"][4]["plain_ms"],
        "bound_ms": sim["kernel"][4]["bound_ms"],
        "bound_by": sim["kernel"][4]["bound_by"], "library_ms": None,
        "launch_floor_ms": sim["launch_floor"]["graph_ms"],
        "ptxas": sim_regs,
        "sass_ffma": {"all": sim_ffma_all, "contracted": sim_ffma},
        "shape": {"J": 4, "S": sim["kernel"][4]["S"]},
        "at_J": {str(n): sim["kernel"][n] for n in SIM_TIMING_J},
    }]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
