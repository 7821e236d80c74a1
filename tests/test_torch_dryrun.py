"""The dry run (``launch/dryrun.py``) and its cost readers against the
reference's.

Parity: smoke configurations (in bfloat16, as the production configs run)
of a dense arch (qwen3), a MoE arch (olmoe) and a hybrid recurrent arch
(jamba), for train, prefill and decode, on a (2, 2) mesh.  The reference
lowers its sharded step with ``jax.jit`` on 4 forced CPU devices in a
subprocess, as its ``launch/dryrun.py`` lowers a cell, and its
``compiled.as_text()`` goes through ``repro.launch.hlo_cost.analyze``;
the port traces the same step on meta tensors as rank 0 of a fake 4-rank
world (``dryrun.trace_step``) and reads its op log with
``launch.op_cost.analyze``.  ``model_flops`` must be equal and
``flops_per_device`` within :data:`FLOPS_RTOL`, once the port's train
step is rid of what the card runs and XLA does not: each kernel's
backward recomputes its plain forward (``kernels/vjp.py``), where XLA
keeps the forward's intermediates.  The collectives are held kind by
kind in :func:`test_collectives_against_reference`.

Production: qwen3-0.6b's ``train_4k`` cell on pod1 (256 ranks) and pod2
(512) through the launcher in a subprocess, each record held to
``tests/test_dryrun_artifacts.py``'s checks, pod2's train FLOPs a device
under 0.75 of pod1's, and ``launch.reanalyze`` of the saved op logs
giving the same fields back.

Every world here is destroyed when its test ends (``fake_world``).
"""
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch.distributed as dist

from repro_torch.configs import SHAPES, get_config, shape_applicable, \
    smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import op_cost
from repro_torch.launch.dryrun import model_flops, run_cell, trace_step
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.world import fake_world
from repro_torch.models import moe

ROOT = Path(__file__).resolve().parent.parent
ARCHS = ("qwen3-0.6b", "olmoe-1b-7b", "jamba-v0.1-52b")
KINDS = ("train", "prefill", "decode")
SEQ, BATCH = 64, 8
CELLS = [(a, k) for a in ARCHS for k in KINDS]
# the dot FLOPs of the two cost models; measured within 0.4 % (jamba's
# decode and train: its Mamba mixer's products outside the scan kernel)
FLOPS_RTOL = 0.05

REFERENCE = """
import dataclasses, json, sys
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
assert len(jax.devices()) == 4
from repro.configs import get_config, smoke_config
from repro.configs.base import ShapeConfig
from repro.launch.dryrun import model_flops
from repro.launch.hlo_cost import analyze
from repro.launch.mesh import dp_size, make_mesh
from repro.launch.shardings import (batch_shardings, cache_shardings,
    logical_rules, state_shardings, tree_shardings)
from repro.launch.specs import (cache_specs, input_specs, param_specs,
    state_specs)
from repro.models import decode_step, prefill
from repro.models.sharding import use_rules
from repro.train.optimizer import AdamWConfig
from repro.train.train import make_train_step
out = {}
for arch, kind in %(cells)r:
    cfg = dataclasses.replace(smoke_config(get_config(arch)),
                              dtype="bfloat16", param_dtype="bfloat16")
    shape = ShapeConfig("t", %(seq)d, %(batch)d, kind)
    mesh, opt = make_mesh(2, 2), AdamWConfig()
    rules = logical_rules(cfg, mesh, shape)
    with mesh, use_rules(mesh, rules):   # repro/launch/dryrun.py:91-162
        bsh = batch_shardings(cfg, mesh, shape)
        if kind == "train":
            sstruct = state_specs(cfg, opt)
            ssh = state_shardings(cfg, mesh, sstruct)
            ga = max(1, min(cfg.grad_accum,
                            shape.global_batch // dp_size(mesh)))
            jitted = jax.jit(make_train_step(cfg, opt, grad_accum=ga),
                             in_shardings=(ssh, bsh),
                             out_shardings=(ssh, NamedSharding(mesh, P())),
                             donate_argnums=0)
            lowered = jitted.lower(sstruct, input_specs(cfg, shape))
        elif kind == "prefill":
            pstruct = param_specs(cfg)
            def prefill_step(params, batch):
                logits, cache = prefill(params, cfg, batch,
                                        cache_len=shape.seq_len)
                return logits[:, -1], cache
            jitted = jax.jit(prefill_step, in_shardings=(
                tree_shardings(mesh, pstruct), bsh), out_shardings=(
                NamedSharding(mesh, P(rules["dp"], "model")),
                cache_shardings(cfg, mesh, shape)))
            lowered = jitted.lower(pstruct, input_specs(cfg, shape))
        else:
            pstruct = param_specs(cfg)
            csh = cache_shardings(cfg, mesh, shape)
            def serve_step(params, cache, token, pos):
                logits, new_cache = decode_step(params, cfg, cache, token,
                                                pos)
                nxt = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
                return nxt[:, None], new_cache
            jitted = jax.jit(serve_step, in_shardings=(
                tree_shardings(mesh, pstruct), csh, bsh["token"],
                bsh["pos"]), out_shardings=(
                NamedSharding(mesh, P(rules["dp"], None)), csh),
                donate_argnums=1)
            ins = input_specs(cfg, shape)
            lowered = jitted.lower(pstruct, cache_specs(cfg, shape),
                                   ins["token"], ins["pos"])
        hc = analyze(lowered.compile().as_text())
    out[arch + "/" + kind] = dict(hc, model_flops=model_flops(cfg, shape))
json.dump(out, open(sys.argv[1], "w"))
""" % dict(cells=CELLS, seq=SEQ, batch=BATCH)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's cost of every cell (one subprocess)."""
    path = tmp_path_factory.mktemp("ref") / "ref.json"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = str(ROOT / "src")
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(REFERENCE),
                          str(path)], capture_output=True, text=True,
                         timeout=400, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(path.read_text())


def _cfg(arch):
    return dataclasses.replace(smoke_config(get_config(arch)),
                               dtype="bfloat16", param_dtype="bfloat16")


_PORT = {}


def _port(arch, kind):
    """The port's (op log, analysis) of a cell, traced once per module."""
    if (arch, kind) not in _PORT:
        with fake_world(4):
            log, _ = trace_step(_cfg(arch), ShapeConfig("t", SEQ, BATCH, kind),
                                make_mesh(2, 2, device_type="cpu"))
        _PORT[arch, kind] = (log, op_cost.analyze(log))
    assert not dist.is_initialized()
    return _PORT[arch, kind]


def _recompute(log) -> float:
    """FLOPs of each kernel's forward recomputed in plain ops by its
    backward: one per kernel call of a train step (every call there is
    under grad)."""
    return sum(n * op_cost._kernel_cost(e)[0] for e, n in log.items()
               if e[0].startswith(op_cost.KERNEL_PREFIX))


@pytest.mark.parametrize("arch,kind", CELLS)
def test_flops_match_reference(ref, arch, kind):
    r = ref[f"{arch}/{kind}"]
    log, got = _port(arch, kind)
    shape = ShapeConfig("t", SEQ, BATCH, kind)
    assert model_flops(_cfg(arch), shape) == r["model_flops"]
    flops = got["flops"] - (_recompute(log) if kind == "train" else 0.0)
    want = r["flops"] - _dispatch_flops(arch, kind)
    assert abs(flops - want) <= FLOPS_RTOL * want, (flops, want)


def _dispatch_flops(arch, kind) -> float:
    """The reference's one-hot dispatch and combine contractions
    (``gtec,gtd->egcd`` and ``egcd,gtec->gtd``, 2 G T E C d FLOPs each) on
    one device of the (2, 2) mesh, groups split over "data" and experts
    over "model", over the MoE layers: the port gathers rows by slot index
    instead.  A train step adds three more: the gradients of the combine's
    two operands and of the dispatch's tokens (the one-hot dispatch itself
    has none)."""
    cfg = _cfg(arch)
    if not cfg.n_experts:
        return 0.0
    s = 1 if kind == "decode" else SEQ
    t = min(s, cfg.moe_group)
    g = BATCH * (s // t)
    per = 2 * (g // 2) * t * (cfg.n_experts // 2) * moe.capacity(cfg, t) * \
        cfg.d_model
    layers = sum("moe" in cfg.ffn_kind(i) for i in range(cfg.n_layers))
    return float(layers * per * (5 if kind == "train" else 2))


# port operand bytes / reference operand bytes, per kind, as measured:
# the port all-reduces and gathers bfloat16 activations and parameters
# where XLA moves some of them in float32 and re-lays others out by
# all-to-all and collective-permute
RATIOS = {"all-reduce": (0.25, 0.55), "all-gather": (0.25, 1.1)}


@pytest.mark.parametrize("arch,kind", CELLS)
def test_collectives_against_reference(ref, arch, kind):
    """Kind by kind, on the (2, 2) mesh:

    - all-reduce (the Megatron pair's sums, the vocabulary-parallel
      loss's, the gradients of replicated parameters) and all-gather (the
      per-layer parameter gathers over "data", the gathered decode q):
      both sides emit them in every cell, the port's operand bytes within
      :data:`RATIOS` of the reference's;
    - reduce-scatter: only the port, only in train, where the gradient of
      each gathered parameter is reduce-scattered back to its shard
      (``launch/shardings.py::_scatter``); XLA all-reduces those
      gradients and slices them;
    - all-to-all and collective-permute: only XLA, which re-lays out
      activations between the layouts its partitioner picks; the port
      computes each block in the layout it was placed in and emits
      neither."""
    r = ref[f"{arch}/{kind}"]["collectives"]
    _, got = _port(arch, kind)
    c = got["collectives"]
    for k, (lo, hi) in RATIOS.items():
        assert c[k]["count"] > 0 and r[k]["count"] > 0, k
        ratio = c[k]["operand_bytes"] / r[k]["operand_bytes"]
        assert lo <= ratio <= hi, (k, ratio)
    assert (c["reduce-scatter"]["count"] > 0) == (kind == "train")
    assert r["reduce-scatter"]["count"] == 0
    assert c["all-to-all"]["count"] == c["collective-permute"]["count"] == 0
    assert r["all-to-all"]["count"] + r["collective-permute"]["count"] > 0


def test_kernels_are_one_op_each():
    """Every kernel call of a cell is one op of the log; jamba's train
    step runs both attention and the Mamba scan through them."""
    log, _ = _port("jamba-v0.1-52b", "train")
    names = {e[0] for e, _ in log.items()}
    assert {"kernel.flash_attention", "kernel.mamba_scan"} <= names
    log, _ = _port("qwen3-0.6b", "decode")
    assert "kernel.flash_decode" in {e[0] for e, _ in log.items()}


def test_skipped_and_error_records(tmp_path):
    rec = run_cell("qwen3-0.6b", "long_500k", False, tmp_path,
                   verbose=False)
    assert rec["status"] == "skipped" and rec["reason"]
    rec = run_cell("qwen3-0.6b", "train_4k", False, tmp_path, verbose=False,
                   overrides={"n_kv_heads": 0})
    assert rec["status"] == "error" and rec["trace"]
    assert json.loads((tmp_path / "qwen3-0.6b--train_4k--pod1.json"
                       ).read_text())["status"] == "error"
    assert not dist.is_initialized()


# ------------------------------------------------------ production cells
@pytest.fixture(scope="module")
def production(tmp_path_factory):
    """qwen3-0.6b's train_4k cell on both meshes through the launcher."""
    out = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen3-0.6b", "--shape", "train_4k", "--both-meshes", "--out",
         str(out)], capture_output=True, text=True, timeout=300, env=env)
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-2000:]
    return out


@pytest.mark.parametrize("mesh", ["pod1", "pod2"])
def test_production_train_cell(production, mesh):
    """``tests/test_dryrun_artifacts.py``'s checks (:22-41) on the port's
    record."""
    rec = json.loads((production / f"qwen3-0.6b--train_4k--{mesh}.json"
                      ).read_text())
    assert shape_applicable(get_config("qwen3-0.6b"), SHAPES["train_4k"])[0]
    assert rec["status"] == "ok", rec.get("error")
    assert rec["n_devices"] == (512 if mesh == "pod2" else 256)
    assert rec["rank"] == 0 and rec["trace_s"] > 0
    assert rec["flops_per_device"] > 0
    assert rec["bytes_per_device"] > 0
    assert rec["roofline"]["t_compute"] > 0
    assert rec["dominant"] in ("t_compute", "t_memory", "t_collective")
    assert rec["collective_bytes_per_device"] > 0
    mem = rec["memory_analysis"]
    assert mem.get("argument_size_in_bytes", 1) > 0
    assert mem["peak_live_bytes"] >= mem["argument_size_in_bytes"]
    assert (production / f"qwen3-0.6b--train_4k--{mesh}.ops.json.xz"
            ).exists()


def test_multipod_shards_the_pod_axis(production):
    """``tests/test_dryrun_artifacts.py:44-60``: the pod axis halves a
    device's train FLOPs."""
    r1, r2 = (json.loads((production / f"qwen3-0.6b--train_4k--{m}.json"
                          ).read_text()) for m in ("pod1", "pod2"))
    assert r2["flops_per_device"] < r1["flops_per_device"] * 0.75


def test_reanalyze_gives_the_fields_back(production, tmp_path):
    from repro_torch.launch import reanalyze
    fields = ("collectives", "collective_bytes_per_device",
              "flops_per_device", "bytes_per_device", "roofline", "dominant",
              "useful_flops_ratio")
    for p in production.iterdir():
        shutil.copy(p, tmp_path / p.name)
    want = {}
    for p in sorted(tmp_path.glob("*.json")):
        rec = json.loads(p.read_text())
        want[p.name] = {k: rec[k] for k in fields}
        p.write_text(json.dumps({**rec, **{k: None for k in fields}}))
    assert len(want) == 2
    for p in sorted(tmp_path.glob("*.json")):
        assert reanalyze.reanalyze_file(p)
        rec = json.loads(p.read_text())
        assert {k: rec[k] for k in fields} == want[p.name]
