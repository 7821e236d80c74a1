"""The benchmark's driver: finds a cell's configuration, traffic, driver,
limits and metric readers by the names in ``BENCHMARK.json``, runs it,
decides ``correct`` and prints the result line.

A run: set-up (imports, CUDA context, the program's kernels from its
build cache, weights from the seed, warm-up: all of it ``setup_s``), the
measured window, with ``--trace 1`` a traced stretch after it, then, with
the program's state freed, the comparison with the plain reference.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path
from typing import Dict, Optional

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Context:
    """Everything a driver needs for one run of one cell."""
    workload: str
    cell: Dict
    config: Dict                 # the configuration file
    traffic: Dict                # the traffic file
    limits: Dict                 # the cell's limits file
    seed: int
    seconds: float
    trace: bool
    device: object               # torch.device
    t0: float                    # process start (perf_counter)

    @property
    def c(self) -> Dict:
        return self.config["config"]

    def model_config(self):
        """The port's ``ModelConfig`` of this configuration: its module's
        ``CONFIG`` with every key of the file's ``config`` set."""
        mod = importlib.import_module(self.config["module"])
        fields = {f.name for f in dataclasses.fields(mod.CONFIG)}
        return dataclasses.replace(
            mod.CONFIG, **{k: v for k, v in self.c.items() if k in fields})


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def module_at(path: Path, name: str):
    """The Python file ``path`` loaded as module ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver_of(traffic: Dict):
    return importlib.import_module(f"bench.drivers.{traffic['driver']}")


def make_context(bench: Dict, workload: str, seed: int, seconds: float,
                 trace: bool, device, t0: float,
                 overrides: Optional[Dict] = None) -> Context:
    """The context of cell ``workload``; ``overrides`` ({"config": {...},
    "traffic": {...}}) replace keys of the files (the CPU tests' small
    sizes)."""
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = load_json(ROOT / conf["file"])
    traffic = load_json(BENCH / "traffic" / f"{cell['traffic']}.json")
    lim = BENCH / "limits" / f"{workload}.json"
    limits = load_json(lim) if lim.is_file() else {}
    for key, new in (overrides or {}).items():
        target = config["config"] if key == "config" else \
            traffic if key == "traffic" else limits
        target.update(new)
    return Context(workload, cell, config, traffic, limits, int(seed),
                   float(seconds), bool(trace), device, t0)


def applies(metric: Dict, bench: Dict, workload: str, per_layer: bool
            ) -> bool:
    if "workloads" in metric:
        return workload in metric["workloads"]
    if not per_layer:
        return True
    moves = next(m for m in bench["end_to_end"] if m["name"] == metric["moves"])
    return applies(moves, bench, workload, False)


def read_metrics(bench: Dict, workload: str, rec: Dict, trace: bool
                 ) -> Dict:
    out = {}
    for m in bench["per_layer" if trace else "end_to_end"]:
        if not applies(m, bench, workload, trace):
            continue
        reader = module_at(BENCH / "metrics" / f"{m['name']}.py",
                           "bench_metric_" + m["name"].replace(".", "_"))
        value = reader.read(rec)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules():
    """Top-level names of loaded modules that are JAX's or the JAX
    package's, compared whole."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> Optional[float]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30).stdout.strip()
        return float(out.splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def run_cell(ctx: Context, bench: Dict, driver=None) -> Dict:
    """One run of a cell; returns the result (the last line's object) and,
    under ``"_extra"``, what the output file keeps besides."""
    import torch
    driver = driver or driver_of(ctx.traffic)
    cuda = ctx.device.type == "cuda"
    rec = driver.run(ctx)
    rec["setup_s"] = rec["window_start"] - ctx.t0
    peak = torch.cuda.max_memory_allocated(ctx.device) if cuda else 0
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = driver.check(ctx, rec)
    limits = {name: ctx.limits[name] for name in checks}
    correct = (rec["failed"] == 0 and all(
        math.isfinite(v) and v <= limits[k] for k, v in checks.items()))
    result = {"correct": bool(correct), "attempted": int(rec["attempted"]),
              "failed": int(rec["failed"]),
              "metrics": read_metrics(bench, ctx.workload, rec, ctx.trace)}
    device = {"platform": "gpu" if cuda else ctx.device.type,
              "kind": torch.cuda.get_device_name(ctx.device) if cuda
              else "cpu",
              "count": int(ctx.cell["chips"]),
              "memory_peak_bytes": int(peak)}
    if cuda:
        device["power_limit_w"] = power_limit()
    if ctx.trace:
        device["busy_s"] = rec["trace"]["busy_s"]
        device["window_s"] = rec["trace"]["window_s"]
        result["breakdown"] = rec["trace"]["breakdown"]
    result["device"] = device
    result["checks"] = {k: {"value": v, "limit": limits[k]}
                        for k, v in checks.items()}
    result["_extra"] = rec.get("printed", {})
    return result


def main(argv, t0: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_json(ROOT / "BENCHMARK.json")
    names = [w["name"] for w in bench["workloads"]]
    if args.workload not in names:
        print(f"unknown workload {args.workload!r}; known: {names}",
              file=sys.stderr)
        return 2
    chips = next(w["chips"] for w in bench["workloads"]
                 if w["name"] == args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: the cell needs {chips} CUDA card(s); torch finds "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    ctx = make_context(bench, args.workload, args.seed, args.seconds,
                       bool(args.trace), device, t0)
    result = run_cell(ctx, bench)
    extra = result.pop("_extra")
    bad = forbidden_modules()
    if bad:
        print(f"no result: the process loaded {bad}, which the port's run "
              f"must not import", file=sys.stderr)
        return 3
    for key, value in extra.items():
        print(f"{key}: {json.dumps(value)}")
    out = ROOT / "build" / "bench" / \
        f"{args.workload}.{args.seed}.trace{args.trace}.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(result, printed=extra), indent=1))
    for name, chk in result["checks"].items():
        print(f"check {name}: {chk['value']!r} (limit {chk['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
