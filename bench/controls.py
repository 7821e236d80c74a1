"""Readings that set a cell's limits, on the chip at the cell's own size:
the program's numbers over many seeds, the precision control's (the
plain reference in float8 put in the program's place) and the planted
faults', all in one process.

    python3 bench/controls.py --workload <name> --seeds 1,2,3 \\
        --control-seeds 1,2,3 --fault-seeds 4,5,6 --seconds 4 \\
        --out chiprun_out/controls.jsonl

Each reading is one JSON line of ``--out`` and of standard output.  The
benchmark's own runs never run this.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:1] = [str(ROOT / "src"), str(ROOT)]

from bench.core import harness  # noqa: E402


def free(device):
    import torch
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def train_reading(ctx, kind: str):
    """kind: program | control | half_batch."""
    from bench.drivers import train_step as drv
    if kind == "control":
        prog = drv.reference_readings(ctx, fp8=True)
        free(ctx.device)
    else:
        step_fn, state = drv.program_step(ctx)
        if kind == "half_batch":
            inner = step_fn

            def step_fn(state, batch):
                return inner(state, {k: v[:v.shape[0] // 2]
                                     for k, v in batch.items()})
        prog = drv.run(ctx, step_fn, state)["readings"]
        del step_fn, state
        free(ctx.device)
    ref = drv.reference_readings(ctx)
    return drv.compare(prog, ref), {
        "program_losses": prog["losses"], "reference_losses": ref["losses"],
        "names": ref["names"], "program_grad": prog["grad_norms"],
        "reference_grad": ref["grad_norms"],
        "reference_raw_grad": ref["raw_grad_norms"],
        "program_change": prog["change"], "reference_change": ref["change"]}


class AlteredToken:
    """Row 0's next token replaced by its least likely one at every decode
    step, where the engine produces it."""

    def __enter__(self):
        from repro_torch.serve import engine
        self.engine, self.orig = engine, engine.decode_step

        def broken(*a, **kw):
            logits, cache = self.orig(*a, **kw)
            row = logits[0, -1]
            row[row.argmin()] = row.max() + 1.0
            return logits, cache
        engine.decode_step = broken
        return self

    def __exit__(self, *exc):
        self.engine.decode_step = self.orig


def serve_reading(ctx, kind: str):
    """kind: program | control | altered_token.  The control reads the
    float8 reference's first choice at every served position of the
    program's own run."""
    from bench.drivers import serve_wave as drv
    if kind == "altered_token":
        with AlteredToken():
            rec = drv.run(ctx)
    else:
        rec = drv.run(ctx)
    free(ctx.device)
    waves = drv.sample_waves(ctx, rec)
    out = drv.reference_gaps(ctx, waves, fp8_control=(kind == "control"))
    return drv.gap_numbers(out["gaps"]), {
        "waves": len(rec["waves"]), "checked": [w["k"] for w in waves],
        "moe_dropped_share": out.get("moe_dropped_share")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    seeds = lambda s: [int(x) for x in s.split(",") if x]
    out = open(args.out, "a") if args.out else None
    cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    traffic = harness.load_json(ROOT / "bench" / "traffic" /
                                f"{cell['traffic']}.json")
    train = traffic["driver"] == "train_step"
    fault = "half_batch" if train else "altered_token"
    jobs = ([("program", s) for s in seeds(args.seeds)]
            + [("control", s) for s in seeds(args.control_seeds)]
            + [(fault, s) for s in seeds(args.fault_seeds)])
    for kind, seed in jobs:
        ctx = harness.make_context(bench, args.workload, seed, args.seconds,
                                   False, device, time.perf_counter())
        t = time.perf_counter()
        nums, info = (train_reading if train else serve_reading)(ctx, kind)
        line = json.dumps({"workload": args.workload, "kind": kind,
                           "seed": seed, "numbers": nums, "info": info,
                           "seconds": time.perf_counter() - t})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        free(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
