"""Build and drive the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

1. the card's name and power limit (``nvidia-smi``); no card -> exit 1;
2. build every kernel of the decision path with ``nvcc`` (``sm_90a``);
3. each kernel against its plain PyTorch version on the card;
4. the decision path of the four paper jobs (LR, MPC, K-Means, GBT): a
   context encoder on the card, a seeded simulated cluster, 3 profiling
   runs, then one normal and one failure-injected adaptive run with
   ``EnelScaler.recommend`` (``candidate_stride=2``) at every decision
   boundary; the model has ``init_enel`` weights from a seeded
   ``torch.Generator`` (fitting is not ported yet).  Each decision must
   launch the graph-prop kernel exactly once, and the largest sweep of each
   job is held against the plain route on the card;
5. timings with CUDA events at the LR decision shape and the per-decision
   latency of ``recommend``;
6. a ``{"kernels": [...]}`` line, then the device line last.

Imports torch, numpy and the port (``src/repro_torch``) only.
"""
from __future__ import annotations

import json
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
FP32_FLOPS = 67e12          # H100 SXM, fp32 outside the tensor cores
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


def close(a: torch.Tensor, b: torch.Tensor, what: str) -> float:
    torch.testing.assert_close(a, b, atol=ATOL, rtol=RTOL, msg=lambda m:
                               f"{what}: {m}")
    return float((a - b).abs().max()) if a.numel() else 0.0


def random_inputs(rng, b, n, device):
    x = rng.randn(b, n, 30).astype(np.float32)
    adj = np.tril(rng.rand(b, n, n) < 0.35, -1)
    adj[:, min(1, n - 1), :] = False             # rows with no predecessor
    valid = rng.rand(b, n) < 0.4                 # observed rows
    m = rng.rand(b, n, 5).astype(np.float32)
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
    """The kernel's C entry with its pointers bound once.  Back-to-back calls
    cost the host a few microseconds each, so the card stays busy and CUDA
    events time the kernel rather than the wrapper's Python checks."""
    fn = ops._kernel_fn()
    b, n = x.shape[:2]
    e = torch.empty((b, n, n), dtype=torch.float32, device=x.device)
    mh = torch.empty((b, n, 5), dtype=torch.float32, device=x.device)
    ptrs = [t.data_ptr() for t in (x, adj, m, valid) + ops._weights(params)]
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        rc = fn(*ptrs, e.data_ptr(), mh.data_ptr(), b, n, levels, stream)
        assert rc == 0, rc
    return launch


def profile_device(fn, reps: int = 10):
    """(device busy ms per call, ms per call of kernels named graph_prop)
    from a torch.profiler (CUPTI) trace of ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    busy = ours = 0.0
    for ev in prof.key_averages():
        t = float(getattr(ev, "self_device_time_total", 0.0) or 0.0)
        busy += t
        if "graph_prop" in ev.key:
            ours += t
    return busy / 1e3 / reps, ours / 1e3 / reps


def graph_prop_work(b: int, n: int, levels: int):
    """(FLOPs, bytes) graph_prop needs for b graphs of n nodes, in the split
    form: per node x @ W31 halves, per pair the rest of f3, attention and
    h3 @ W41[:16], per level m @ W41[16:] per node and f4 + sum per pair."""
    per_graph = (3840 * n + 2213 * n * n
                 + levels * (320 * n + 431 * n * n))
    weights = (60 * 32 + 32 + 32 * 16 + 16 + 16 + 21 * 32 + 32 + 32 * 5 + 5)
    per_graph_bytes = n * 30 * 4 + n * n + n * 5 * 4 + n + n * n * 4 + \
        n * 5 * 4
    return b * per_graph, b * per_graph_bytes + weights * 4


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


def run_job(job_key, device, ops):
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

    # 2. build
    from repro_torch.core.model import init_enel
    from repro_torch.kernels import build
    from repro_torch.kernels.graph_prop import ops
    t0 = time.perf_counter()
    ops._kernel_fn()
    info = build.BUILDS["graph_prop_fwd"]
    say(f"build graph_prop_fwd: {time.perf_counter() - t0:.2f}s "
        f"(nvcc {info.seconds:.2f}s, compiled={info.compiled})")
    say("\n".join(line for line in info.log.splitlines()
                  if "registers" in line or "spill" in line))

    # 3. kernel vs plain
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

    # 4. the main path; only its launches count
    ops.LAUNCHES = 0
    jobs = {key: run_job(key, device, ops) for key in JOB_KEYS}
    torch.cuda.synchronize()
    launches = ops.LAUNCHES
    n_decisions = sum(j["decisions"] for j in jobs.values())
    assert launches == n_decisions > 0, (launches, n_decisions)
    say(f"main path: {n_decisions} decisions, graph_prop_fwd launched "
        f"{launches} times")

    # 5. timings at the LR decision shape
    p, template, deltas = jobs["lr"]["sweep"]
    flat, levels = sweep_flat(template, deltas, device)
    from repro_torch.core import model
    _, _, x, adj = model._prelude(flat)
    args = (p, x, adj, flat["metrics"], flat["metrics_valid"])
    b, n = x.shape[:2]
    launch = raw_launcher(ops, *args, levels)
    kernel_ms = median_ms(launch, burst=50)
    plain_ms = median_ms(
        lambda: ops.graph_prop_plain(*args, levels=levels), burst=10)
    call_ms = median_ms(lambda: ops.graph_prop(*args, levels=levels),
                        burst=50)
    kernel_ms2 = median_ms(launch, burst=50)
    flops, nbytes = graph_prop_work(b, n, levels)
    bound_ms = max(flops / FP32_FLOPS, nbytes / HBM_BYTES) * 1e3
    bound_by = "operations" if flops / FP32_FLOPS >= nbytes / HBM_BYTES \
        else "bytes"
    _, prof_kernel_ms = profile_device(launch, reps=50)
    say(f"timing at B={b} N={n} levels={levels} on {card}: kernel "
        f"{kernel_ms:.4f} ms (again {kernel_ms2:.4f}; profiler "
        f"{prof_kernel_ms:.4f}; through the wrapper {call_ms:.4f}), plain "
        f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms by {bound_by} "
        f"({flops / 1e6:.1f} MFLOP, {nbytes / 1e6:.3f} MB)")
    # the device half of an LR decision: assembly, kernel, readout, copy
    trainer = jobs["lr"]["trainer"]
    sweep = lambda: trainer.predict_sweep_device(template, deltas).cpu()
    sweep_ms = median_wall_ms(sweep)
    busy_ms, sweep_kernel_ms = profile_device(sweep)
    say(f"LR sweep evaluation (C x K = {b}): {sweep_ms:.3f} ms wall, device "
        f"busy {busy_ms:.3f} ms (graph_prop {sweep_kernel_ms:.3f} ms), "
        f"idle share {1 - busy_ms / sweep_ms:.3f}")
    for key, j in jobs.items():
        c, k = j["largest"]
        say(f"recommend {key}: {j['decisions']} decisions, per decision "
            f"median {j['recommend_ms_median']:.2f} ms, p90 "
            f"{j['recommend_ms_p90']:.2f} ms (largest sweep {c}x{k})")

    say(json.dumps({"card": card, "recommend_ms": {
        key: {"median": j["recommend_ms_median"], "p90": j["recommend_ms_p90"]}
        for key, j in jobs.items()}}))

    # 6. results
    say(json.dumps({"kernels": [{
        "name": "graph_prop_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/graph_prop/csrc/graph_prop_fwd.cu",
        "replaces": "src/repro/kernels/graph_prop/kernel.py:271",
        "launches": launches, "max_abs_err": max_err,
        "ms": kernel_ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
