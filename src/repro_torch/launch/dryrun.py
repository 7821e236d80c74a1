"""Multi-pod dry run: trace one step of every (arch, shape, mesh) cell on
``meta`` tensors, as rank 0 of a fake world of 256 or 512 ranks, and read
its cost per device.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --both-meshes
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
        --shape train_4k,decode_32k

Counterpart of ``repro.launch.dryrun``, which lowers and compiles each cell
with ``jax.jit`` on 512 forced host devices and reads the partitioned HLO.
Here a cell runs inside ``launch.world.fake_world`` (a ``"fake"`` process
group: collectives return at once and move nothing) on the production mesh
(``launch.mesh.make_production_mesh``, ``device_type="cpu"``).  Under
``logical_rules``, this rank's ``meta`` shards of the parameters, the
train state and the cache are placed as ``DTensor`` objects by
``tree_shardings``, ``state_shardings`` and ``cache_shardings``; the batch
is the global batch as a plain meta tensor, of which each step takes this
rank's rows (``batch_shardings``).  :func:`trace_cell` then runs one of
three steps under ``launch.op_cost.OpLog``:

- train: the sharded train step (``train.train.make_train_step``) with the
  reference's ``grad_accum`` rule, ``min(cfg.grad_accum, global batch /
  DP ranks)``, at least 1;
- prefill: ``models.prefill`` into a cache of ``seq_len`` rows, keeping
  ``logits[:, -1]`` and the cache;
- decode: ``models.decode_step`` then ``models.next_token``, at position
  ``pos = seq_len - 1``, the last row of the cache: every rank's slice of a
  sequence-split cache is then wholly visible.  The reference traces
  ``pos`` as a value; the port takes it as a host int.

Every LM kernel takes its meta route there: one op a call
(``kernels/observe.py``), nothing launched.  :func:`run_cell` writes the
reference's record (``<tag>.json``; statuses ``ok``, ``skipped``,
``error`` with the traceback's tail) with ``trace_s`` in place of
``lower_s`` / ``compile_s`` and no ``cost_analysis_xla``, and the op log
beside it (``<tag>.ops.json.xz``), which ``launch.reanalyze`` reads again.
``memory_analysis`` holds ``argument_size_in_bytes`` (this rank's shards of
the step's inputs), ``output_size_in_bytes`` (of its outputs) and
``peak_live_bytes``: the arguments plus the most bytes of the storages
that the step's ops had allocated and not yet freed at once
(``OpLog``'s weak references to them; no allocator rounding, no
workspace of a library).

The fake world gives rank 0's view (``"rank": 0``).  Where a layout's
work depends on the rank, rank 0's is counted: under ``cache_seq`` decode
writes row ``pos`` only on the rank that holds it (the last, here), and
where ``torch.chunk`` splits a sequence unevenly (``kv_seq``) the last
slice is the short one, so rank 0 holds a full slice.  The run exits 1
if any cell errs, as the reference does.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
import warnings
from pathlib import Path
from typing import Dict, Tuple

import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.configs import (SHAPES, get_config, get_shape, list_archs,
                                 shape_applicable)
from repro_torch.launch import op_cost
from repro_torch.launch.cost_analysis import dominant_term, roofline_terms
from repro_torch.launch.mesh import dp_size, make_production_mesh
from repro_torch.launch.shardings import (batch_shardings, cache_shardings,
                                          from_host, logical_rules,
                                          state_shardings, tree_shardings)
from repro_torch.launch.specs import (META, cache_specs, input_specs,
                                      param_specs, state_specs)
from repro_torch.launch.world import fake_world
from repro_torch.models import (active_param_count, decode_step,
                                next_token, prefill)
from repro_torch.models.sharding import use_rules
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train import make_train_step

OUT = "artifacts/dryrun_torch"


def model_flops(cfg, shape) -> float:
    n = active_param_count(cfg)
    if shape.kind == "train":
        toks = shape.global_batch * shape.seq_len
        return 6.0 * n * toks
    if shape.kind == "prefill":
        toks = shape.global_batch * shape.seq_len
        return 2.0 * n * toks
    return 2.0 * n * shape.global_batch           # decode: one token per seq


def _parse_overrides(spec: str) -> dict:
    out = {}
    for kv in filter(None, (spec or "").split(",")):
        k, v = kv.split("=", 1)
        if v in ("true", "True"):
            out[k] = True
        elif v in ("false", "False"):
            out[k] = False
        else:
            try:
                out[k] = int(v)
            except ValueError:
                try:
                    out[k] = float(v)
                except ValueError:
                    out[k] = v
    return out


def _place(t, specs, mesh):
    """Every meta tensor of ``t`` as a ``DTensor`` of this rank's shard,
    placed by its spec in ``specs``."""
    flat = dict(tree.leaves_with_paths(specs))
    return tree.map_with_paths(
        lambda path, x: from_host(x, mesh, flat[path], META), t)


def _local_bytes(t) -> int:
    """Bytes this rank holds of every tensor of ``t`` (a ``DTensor``'s
    local shard)."""
    from torch.distributed.tensor import DTensor
    total = 0
    for x in tree.leaves(t):
        if isinstance(x, DTensor):
            x = x.to_local()
        if isinstance(x, torch.Tensor):
            total += math.prod(x.shape) * x.element_size()
    return total


def _batch_bytes(batch: Dict, specs: Dict, mesh) -> int:
    """Bytes of this rank's rows of the global batch under ``specs``."""
    total = 0
    for k, x in batch.items():
        rows = specs[k][0] if len(specs[k]) else None
        n = math.prod(mesh.size(mesh.mesh_dim_names.index(a)) for a in (
            (rows,) if isinstance(rows, str) else rows or ()))
        total += math.prod(x.shape) * x.element_size() // n
    return total


def trace_cell(arch: str, shape_name: str, multi_pod: bool,
               opt: AdamWConfig = AdamWConfig(), overrides: dict = None
               ) -> Tuple[op_cost.OpLog, Dict]:
    """Trace one (arch, shape, mesh) cell in a fake world of 256 or 512
    ranks: (its op log, the record's fields that describe the cell)."""
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod, device_type="cpu")
        log, meta = trace_step(cfg, get_shape(shape_name), mesh, opt)
    return log, {"arch": arch, "shape": shape_name,
                 "mesh": "2x16x16" if multi_pod else "16x16", **meta}


def trace_step(cfg, shape, mesh, opt: AdamWConfig = AdamWConfig()
               ) -> Tuple[op_cost.OpLog, Dict]:
    """Trace the step ``shape.kind`` selects as this rank of ``mesh`` (on a
    fake world), on meta tensors: (its op log, the cell's fields)."""
    log = op_cost.OpLog()
    rules = logical_rules(cfg, mesh, shape)
    meta = {"n_devices": int(mesh.size()), "rank": dist.get_rank(),
            "rules": {k: str(v) for k, v in rules.items()}}
    with use_rules(mesh, rules):
        batch = input_specs(cfg, shape)
        bsh = batch_shardings(cfg, mesh, shape)
        if shape.kind == "train":
            sstruct = state_specs(cfg, opt)
            state = _place(sstruct, state_shardings(cfg, mesh, sstruct), mesh)
            args_bytes = _local_bytes(state) + _batch_bytes(batch, bsh, mesh)
            ga = max(1, min(cfg.grad_accum,
                            shape.global_batch // dp_size(mesh)))
            meta["grad_accum"] = ga
            step = make_train_step(cfg, opt, grad_accum=ga)
            t0 = time.time()
            with log:
                outs = step(state, batch)
        else:
            pstruct = param_specs(cfg)
            params = _place(pstruct, tree_shardings(mesh, pstruct), mesh)
            args_bytes = _local_bytes(params)
            if shape.kind == "prefill":
                args_bytes += _batch_bytes(batch, bsh, mesh)
                t0 = time.time()
                with torch.no_grad(), log:
                    logits, cache = prefill(params, cfg, batch,
                                            cache_len=shape.seq_len)
                    outs = (logits.to_local()[:, -1], cache)
            else:
                cache = _place(cache_specs(cfg, shape),
                               cache_shardings(cfg, mesh, shape), mesh)
                args_bytes += _local_bytes(cache) + _batch_bytes(
                    {"token": batch["token"]}, bsh, mesh)
                meta["pos"] = pos = shape.seq_len - 1
                t0 = time.time()
                with torch.no_grad(), log:
                    logits, cache = decode_step(params, cfg, cache,
                                                batch["token"], pos)
                    outs = (next_token(logits), cache)
        meta["trace_s"] = time.time() - t0
    meta["memory_analysis"] = {
        "argument_size_in_bytes": args_bytes,
        "output_size_in_bytes": _local_bytes(outs),
        "peak_live_bytes": args_bytes + log.peak}
    return log, meta


def cost_fields(items, model_flops_per_device: float) -> Dict:
    """The record's cost fields from an op log's ``(entry, count)`` pairs
    (what ``launch.reanalyze`` recomputes)."""
    hc = op_cost.analyze(items)
    terms = roofline_terms(hc["flops"], hc["hbm_bytes"],
                           hc["collective_bytes"])
    return {
        "collectives": hc["collectives"],
        "collective_bytes_per_device": hc["collective_bytes"],
        "flops_per_device": hc["flops"],
        "bytes_per_device": hc["hbm_bytes"],
        "useful_flops_ratio": (model_flops_per_device / hc["flops"]
                               if model_flops_per_device and hc["flops"]
                               else None),
        "roofline": terms,
        "dominant": dominant_term(terms),
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool, outdir: Path,
             verbose: bool = True, overrides: dict = None,
             tag_suffix: str = "") -> dict:
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    ok, reason = shape_applicable(cfg, shape)
    tag = f"{arch}--{shape_name}--{'pod2' if multi_pod else 'pod1'}{tag_suffix}"
    out_path = outdir / f"{tag}.json"
    if not ok:
        rec = {"arch": arch, "shape": shape_name, "status": "skipped",
               "reason": reason}
        out_path.write_text(json.dumps(rec, indent=1))
        if verbose:
            print(f"[dryrun] {tag}: SKIP ({reason})")
        return rec

    try:
        log, meta = trace_cell(arch, shape_name, multi_pod,
                               overrides=overrides)
        meta["overrides"] = overrides or {}
    except Exception as e:  # a failure here is a bug in the port
        rec = {"arch": arch, "shape": shape_name, "status": "error",
               "error": f"{type(e).__name__}: {e}",
               "trace": traceback.format_exc()[-4000:]}
        out_path.write_text(json.dumps(rec, indent=1))
        if verbose:
            print(f"[dryrun] {tag}: ERROR {type(e).__name__}: {e}")
        return rec

    op_cost.dump(log, outdir / f"{tag}.ops.json.xz")
    mf = model_flops(cfg, shape)
    n_dev = meta["n_devices"]
    rec = {**meta, "status": "ok",
           "model_flops_total": mf, "model_flops_per_device": mf / n_dev,
           **cost_fields(log.items(), mf / n_dev),
           "ops": log.n_ops, "distinct_ops": len(log.entries)}
    out_path.write_text(json.dumps(rec, indent=1))
    if verbose:
        terms = rec["roofline"]
        useful = rec["useful_flops_ratio"]
        print(f"[dryrun] {tag}: OK compute={terms['t_compute']:.4f}s "
              f"mem={terms['t_memory']:.4f}s "
              f"coll={terms['t_collective']:.4f}s "
              f"dominant={rec['dominant']} "
              f"useful={useful and round(useful, 3)} "
              f"(trace {meta['trace_s']:.0f}s, {rec['ops']} ops)")
        print(f"[dryrun] {tag}: memory_analysis={meta['memory_analysis']}")
    return rec


def main():
    # c10d's deprecation notice for all_gather_into_tensor, once per call
    warnings.filterwarnings("ignore", category=FutureWarning,
                            module="torch.distributed")
    ap = argparse.ArgumentParser(description="multi-pod dry run on meta "
                                 "tensors in a fake world")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--override", default="",
                    help="cfg overrides, e.g. moe_group=256,grad_accum=8")
    ap.add_argument("--tag", default="", help="artifact tag suffix")
    args = ap.parse_args()
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    overrides = _parse_overrides(args.override)

    archs = list_archs() if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    n_err = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}--{shape}--{'pod2' if mp else 'pod1'}{args.tag}"
                p = outdir / f"{tag}.json"
                if args.skip_existing and p.exists():
                    rec = json.loads(p.read_text())
                    if rec.get("status") in ("ok", "skipped"):
                        print(f"[dryrun] {tag}: cached ({rec['status']})")
                        continue
                rec = run_cell(arch, shape, mp, outdir, overrides=overrides,
                               tag_suffix=args.tag)
                n_err += rec.get("status") == "error"
    raise SystemExit(1 if n_err else 0)


if __name__ == "__main__":
    main()
