"""Summarise the dry run's records as a table: per (arch, shape) the
status and dominant term on both meshes, the FLOPs a device, the peak
live bytes a rank against a card's 80 GB, and the trace's seconds.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --both-meshes
    python tools/dryrun_summary.py [--dir artifacts/dryrun_torch]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

CARD_BYTES = 80e9          # one H100's HBM


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="artifacts/dryrun_torch")
    args = ap.parse_args()
    recs = {}
    for p in sorted(Path(args.dir).glob("*.json")):
        arch, shape, mesh = p.stem.split("--")[:3]
        recs[arch, shape, mesh] = json.loads(p.read_text())
    counts = {}
    for r in recs.values():
        counts[r["status"]] = counts.get(r["status"], 0) + 1
    print(f"records: {len(recs)}; " + ", ".join(
        f"{k} {v}" for k, v in sorted(counts.items())))
    print("| arch | shape | pod1 | pod2 | TFLOP a device pod1 / pod2 | "
          "peak live GB a rank pod1 / pod2 | trace s pod1 / pod2 |")
    print("|---|---|---|---|---|---|---|")
    over = []
    for arch, shape in sorted({(a, s) for a, s, _ in recs}):
        row = [recs.get((arch, shape, m), {}) for m in ("pod1", "pod2")]
        if all(r.get("status") == "skipped" for r in row):
            continue

        def cell(r):
            if r.get("status") != "ok":
                return r.get("status", "missing")
            return f"ok, {r['dominant'][2:]}"

        def pair(key, scale, fmt):
            return " / ".join(fmt.format(key(r) / scale)
                              if r.get("status") == "ok" else "-"
                              for r in row)
        for m, r in zip(("pod1", "pod2"), row):
            if r.get("status") == "ok" and \
                    r["memory_analysis"]["peak_live_bytes"] > CARD_BYTES:
                over.append(f"{arch}--{shape}--{m}")
        print(f"| {arch} | {shape} | {cell(row[0])} | {cell(row[1])} | "
              + pair(lambda r: r["flops_per_device"], 1e12, "{:.4f}")
              + " | " + pair(lambda r: r["memory_analysis"]
                             ["peak_live_bytes"], 1e9, "{:.1f}")
              + " | " + pair(lambda r: r["trace_s"], 1.0, "{:.1f}") + " |")
    print(f"peak live bytes above {CARD_BYTES / 1e9:.0f} GB: {len(over)} "
          f"cells: {', '.join(over)}")


if __name__ == "__main__":
    main()
