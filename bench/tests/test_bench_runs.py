"""Whole runs of each cell at a small size on the CPU: the program agrees
with the plain reference, the result line has the contract's keys, and a
broken timed path comes out not correct."""
import json
import subprocess
import sys

import pytest
import torch

from bench import controls
from bench.core import harness
from bench.tests import tiny

CELLS = ("olmoe-train-2k", "pixtral-vqa", "olmoe-code")
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_correct_with_the_contracts_keys(workload, trace):
    bench, ctx = tiny.context(workload, trace=trace)
    res = harness.run_cell(ctx, bench)
    res.pop("_extra")
    keys = KEYS[:4] + (["breakdown"] if trace else []) + KEYS[4:]
    assert list(res) == keys
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    for name, chk in res["checks"].items():
        assert chk["value"] < 1e-4, (name, chk)       # float32 both sides
    kind = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in bench[kind]
             if harness.applies(m, bench, workload, trace)}
    assert set(res["metrics"]) <= names
    if not trace:                    # host clocks read on the CPU too
        assert set(res["metrics"]) == names
    json.dumps(res)


def test_no_card_no_result(capsys):
    rc = harness.main(["--workload", "pixtral-vqa", "--seed", "1",
                       "--seconds", "1"], 0.0)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert rc != 0 and capsys.readouterr().out == ""


def test_nothing_loaded_is_jax_or_the_jax_package():
    """Every module the harness loads, in a fresh process: no top-level
    name is jax, jaxlib, flax or repro (compared whole)."""
    code = """
import sys
sys.path[:0] = [{src!r}, {root!r}]
from bench.core import harness
import bench.controls, bench.drivers.train_step, bench.drivers.serve_wave
import bench.reference.lm, bench.reference.train, bench.core.readers
import repro_torch.train.train, repro_torch.serve.engine
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_decode import ops
for p in (harness.BENCH / "metrics").glob("*.py"):
    harness.module_at(p, "m_" + p.stem.replace(".", "_"))
print(harness.forbidden_modules())
"""
    out = subprocess.run(
        [sys.executable, "-c", code.format(src=str(harness.ROOT / "src"),
                                           root=str(harness.ROOT))],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_reference_imports_nothing_of_the_program():
    code = """
import sys
sys.path[:0] = [{root!r}]
import bench.reference.lm, bench.reference.train
print(sorted({{m.split(".")[0] for m in sys.modules}}
             & {{"repro_torch", "repro", "jax"}}))
"""
    out = subprocess.run([sys.executable, "-c",
                          code.format(root=str(harness.ROOT))],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


class _Broken:
    """The program's train step with a fault planted under the harness."""

    def __init__(self, monkeypatch, kind):
        from repro_torch.train import train
        inner = train.make_train_step

        def make(*a, **kw):
            step = inner(*a, **kw)
            if kind == "unchanged":
                return lambda state, batch: (state, {"loss": torch.tensor(
                    5.0)})
            return lambda state, batch: step(
                state, {k: v[:v.shape[0] // 2] for k, v in batch.items()})
        monkeypatch.setattr(train, "make_train_step", make)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_a_broken_train_step_is_not_correct(monkeypatch, fault):
    _Broken(monkeypatch, fault)
    bench, ctx = tiny.context("olmoe-train-2k")
    res = harness.run_cell(ctx, bench)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("workload", ["pixtral-vqa", "olmoe-code"])
def test_an_altered_token_is_not_correct(workload):
    bench, ctx = tiny.context(workload)
    with controls.AlteredToken():
        res = harness.run_cell(ctx, bench)
    assert not res["correct"], res["checks"]


def test_precision_controls_read_far_above_the_program():
    """At a small size on the CPU: the float8 reference in the program's
    place reads at least 3x what the program reads on every number the
    limits hold, on one of them or more."""
    _, ctx = tiny.context("olmoe-train-2k")
    ctl, _ = controls.train_reading(ctx, "control")
    prog, _ = controls.train_reading(ctx, "program")
    assert any(ctl[k] > 3 * max(prog[k], 1e-6) for k in prog), (ctl, prog)
    for wl in ("pixtral-vqa", "olmoe-code"):
        _, ctx = tiny.context(wl)
        ctl, _ = controls.serve_reading(ctx, "control")
        prog, _ = controls.serve_reading(ctx, "program")
        assert ctl["max_gap"] > 3 * max(prog["max_gap"], 1e-6), (wl, ctl)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_the_cells_limits_on_the_card(card, workload):
    """At the cell's own size on the card: the float8 control fails one of
    the cell's limits and the program's own run meets them."""
    import time
    bench = tiny.benchmark()
    listed = harness.load_json(harness.ROOT / "BENCHMARK.json")["workloads"]
    if workload not in [w["name"] for w in listed]:
        pytest.skip(f"{workload} is pending (bench/pending): no limits yet")
    ctx = harness.make_context(bench, workload, 2 ** 31 + 11, 3.0, False,
                               card, time.perf_counter())
    reading = controls.train_reading if ctx.traffic["driver"] == \
        "train_step" else controls.serve_reading
    ctl, _ = reading(ctx, "control")
    assert any(v > ctx.limits[k] for k, v in ctl.items() if k in ctx.limits), ctl
    prog, _ = reading(ctx, "program")
    assert all(v <= ctx.limits[k] for k, v in prog.items() if k in ctx.limits), prog
