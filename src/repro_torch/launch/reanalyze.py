"""Recompute the cost fields of dry-run records from their saved op logs,
without tracing again (for when the cost model changes).

    PYTHONPATH=src python -m repro_torch.launch.reanalyze \\
        [--dir artifacts/dryrun_torch]

Counterpart of ``repro.launch.reanalyze``, which reads each cell's saved
HLO: the port's trace has no HLO, and ``launch.dryrun`` saves each cell's
op log beside its record (``<tag>.ops.json.xz``), which this reads
through ``launch.op_cost``: ``collectives``,
``collective_bytes_per_device``, ``flops_per_device``,
``bytes_per_device``, ``roofline``, ``dominant`` and
``useful_flops_ratio`` are recomputed.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.launch import op_cost
from repro_torch.launch.dryrun import OUT, cost_fields


def reanalyze_file(json_path: Path) -> bool:
    ops_path = json_path.parent / (json_path.stem + ".ops.json.xz")
    if not ops_path.exists():
        return False
    rec = json.loads(json_path.read_text())
    if rec.get("status") != "ok":
        return False
    rec.update(cost_fields(op_cost.load(ops_path),
                           rec.get("model_flops_per_device") or 0.0))
    json_path.write_text(json.dumps(rec, indent=1))
    return True


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=OUT)
    args = ap.parse_args()
    n = 0
    for p in sorted(Path(args.dir).glob("*.json")):
        if reanalyze_file(p):
            n += 1
            rec = json.loads(p.read_text())
            t = rec["roofline"]
            print(f"[reanalyze] {p.stem}: compute={t['t_compute']:.4f} "
                  f"mem={t['t_memory']:.4f} coll={t['t_collective']:.4f} "
                  f"dominant={rec['dominant']}")
    print(f"[reanalyze] updated {n} artifacts")


if __name__ == "__main__":
    main()
