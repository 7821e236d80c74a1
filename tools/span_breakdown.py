"""One traced run of a serving cell of the benchmark, read through the
program's spans.

Runs ``bench/run.py``'s cell in this process with ``--trace 1`` and prints,
for its traced stretch: the idle time (no device operation) split by the
innermost program span open at the middle of each idle gap ("benchmark"
where no ``serve.*`` or ``model.*`` span is open), over the whole stretch
and over its prefills; each span name's device seconds and count; and the
MoE's kept, routed and slot totals with the dropped share 1 - kept /
routed, over the prefills and over decode.  A span's host cost when on
falls inside the spans, so part of the idle it is given is its own.

Needs one card.  The result goes to standard output and to
``build/bench/span_breakdown.<cell>.json``.

    python tools/span_breakdown.py --workload olmoe-code --seed 31
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from collections import Counter
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def idle_by_span(kernels, recs, lo: float, hi: float) -> dict:
    """Seconds of [lo, hi] with no device operation, by the innermost span
    open at the middle of each gap."""
    from bench.core.trace import idle_gaps
    spans = [(r["name"], r["start_ns"] * 1e-9, r["end_ns"] * 1e-9)
             for r in recs]
    out: Counter = Counter()
    for name, s in idle_gaps(kernels, spans, lo, hi, k=len(kernels) + 1):
        out["benchmark" if name == "host, outside any op" else name] += s
    return dict(out.most_common())


def moe_totals(spans_mod, rec, root: str) -> dict:
    tot = spans_mod.moe_sums(spans_mod.spans_under(rec, root) or [])
    if tot["routed"]:
        tot["dropped_share"] = 1 - tot["kept"] / tot["routed"]
    return tot


def traced_run(workload: str, seed: int, seconds: float, dev) -> dict:
    from bench.core import harness
    from bench.drivers import serve_wave
    from repro_torch import obs
    spans_mod = harness.module_at(
        harness.BENCH / "metrics" / "moe_us_per_row.serve.py",
        "bench_metric_moe_us_per_row_serve")
    kept = []
    driver = SimpleNamespace(
        run=lambda ctx: kept.append(serve_wave.run(ctx)) or kept[-1],
        check=serve_wave.check)
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    ctx = harness.make_context(bench, workload, seed, seconds, True, dev,
                               time.perf_counter())
    result = harness.run_cell(ctx, bench, driver)
    rec = kept[0]
    tr = rec["trace"]
    lo, hi = tr["lo"], tr["hi"]
    recs = [r for r in obs.span_records()
            if lo <= r["start_ns"] * 1e-9 <= hi]
    device_s: Counter = Counter()
    counts: Counter = Counter()
    for r in recs:
        device_s[r["name"]] += r["device_s"]
        counts[r["name"]] += 1
    prefill_idle: Counter = Counter()
    for a, b in tr["prefill_intervals"]:
        prefill_idle.update(idle_by_span(tr["kernels"], recs, a, b))
    return {"metrics": result["metrics"], "window_s": hi - lo,
            "busy_s": tr["busy_s"],
            "idle_by_span": idle_by_span(tr["kernels"], recs, lo, hi),
            "prefill_idle_by_span": dict(prefill_idle.most_common()),
            "span_device_s": dict(device_s), "span_counts": dict(counts),
            "moe_prefill": moe_totals(spans_mod, rec, "serve.prefill"),
            "moe_decode": moe_totals(spans_mod, rec, "serve.decode"),
            "breakdown": result["breakdown"]}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30)
    args = ap.parse_args()
    import torch
    from bench.core.harness import power_limit
    dev = torch.device("cuda", 0)
    out = {"workload": args.workload, "seed": args.seed,
           "device": torch.cuda.get_device_name(dev),
           "power_limit_w": power_limit(),
           "traced": traced_run(args.workload, args.seed, args.seconds, dev)}
    text = json.dumps(out, indent=1, default=float)
    dest = ROOT / "build" / "bench" / f"span_breakdown.{args.workload}.json"
    dest.parent.mkdir(parents=True, exist_ok=True)
    dest.write_text(text)
    print(text)


if __name__ == "__main__":
    main()
