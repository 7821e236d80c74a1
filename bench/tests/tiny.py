"""Small stand-ins of the benchmark's configurations and traffic, for
runs on the CPU."""
from __future__ import annotations

import time

from bench.core import harness

TINY_MODEL = {"d_model": 64, "n_heads": 4, "d_head": 16, "vocab_size": 256,
              "raw_vocab_size": 251, "n_layers": 2}
TINY = {
    "olmoe-train-2k": {
        "config": dict(TINY_MODEL, n_kv_heads=4, moe_d_ff=32, n_experts=4,
                       top_k=2, moe_group=16),
        "traffic": {"batch": 4, "seq_len": 32, "trace_steps": 1},
        # the cell is pending (bench/pending): limits between the card's
        # program readings and its faults'
        "limits": {"loss_gap": 0.008, "grad_gap": 0.1, "change_gap": 0.05}},
    "pixtral-vqa": {
        "config": dict(TINY_MODEL, n_kv_heads=2, d_ff=96, n_patches=8),
        "traffic": {"wave": 2, "lengths": {"lo": 4, "hi": 12},
                    "new_tokens": 3, "cycle_waves": 4, "check_waves": 2,
                    "reference_rows": 2, "trace_waves": 1}},
    "olmoe-code": {
        "config": dict(TINY_MODEL, n_kv_heads=4, moe_d_ff=32, n_experts=4,
                       top_k=2, moe_group=16),
        "traffic": {"wave": 3, "lengths": {"lo": 8, "hi": 40},
                    "pad_multiple": 16, "new_tokens": 4, "cycle_waves": 4,
                    "check_waves": 2, "reference_rows": 2,
                    "trace_waves": 1}},
}


def benchmark():
    """``BENCHMARK.json`` with the pending cells' entries added."""
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    for p in sorted((harness.BENCH / "pending").glob("*.json")):
        for key, rows in harness.load_json(p).items():
            if key in ("workloads", "end_to_end", "per_layer"):
                bench[key] = bench[key] + rows
    return bench


def context(workload: str, seed: int = 2 ** 33 + 17, seconds: float = 0.5,
            trace: bool = False, dtype: str = "float32", device="cpu"):
    import torch
    bench = benchmark()
    over = {k: dict(v) for k, v in TINY[workload].items()}
    over["config"].update(dtype=dtype, param_dtype=dtype)
    ctx = harness.make_context(bench, workload, seed, seconds, trace,
                               torch.device(device), time.perf_counter(),
                               over)
    return bench, ctx
