"""The Enel elastic trainer and the training launcher over spawned gloo
worlds on the CPU.

The elastic trainer at W = 4 holds the gates of the reference's
``tests/test_multidevice.py`` elastic run (DP choices (1, 2, 4), a
worker-group loss at component 2, 8 steps, at least one rescale, two DP
degrees), and more: every rank has the same DP trace and picks, every
re-mesh restores (resharded) the state it saved, bit for bit, and under the
scripted clock of ``tests/test_torch_elastic.py`` (on every rank; rank 0's
stage times are broadcast) the losses equal the port's world-size-1 run
with the same trace within 1e-5 relative: the sharded step computes the
global batch's loss.  The launcher runs under ``python -m
torch.distributed.run`` with 2 processes and must print the ``--dp 1``
run's losses; a mesh that does not match the world raises, naming both
sizes.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.launch.world import run_world

ROOT = Path(__file__).resolve().parent.parent
WORLD_TIMEOUT = 300
LOSS_RTOL = 1e-5
ELASTIC = dict(n_components=4, steps_per_component=2, dp_choices=(1, 2, 4),
               fail_at_component=2, seed=0)
# a loose target: Enel shrinks 4 -> 1 at once; a tight one: it keeps 4, the
# loss at component 2 shrinks to 2 (ranks 2 and 3 idle), then 2 -> 4
TARGETS = {"loose": 3600.0, "tight": 0.01}


class ScriptedClock:
    """``tests/test_torch_elastic.py``'s clock: ``time()`` advances by a
    fixed cycle of steps."""

    def __init__(self):
        self.calls, self.now = 0, 1000.0

    def time(self) -> float:
        self.calls += 1
        self.now += 0.01 * (1 + self.calls % 7)
        return self.now


def _setup():
    from repro_torch.configs import TRAIN_4K, get_config, smoke_config
    cfg = smoke_config(get_config("qwen3-0.6b"))
    shape = dataclasses.replace(TRAIN_4K, seq_len=32, global_batch=8)
    return cfg, shape


def _world_elastic(rank, world, ckdir, target):
    from repro_torch.launch.shardings import gather_tree
    from repro_torch.train import elastic
    cfg, shape = _setup()
    elastic.time = ScriptedClock()
    ecfg = elastic.ElasticConfig(target_runtime=target, ckpt_dir=ckdir,
                                 **ELASTIC)
    tr = elastic.ElasticTrainer(cfg, shape, ecfg, device="cpu")
    restores, meshes = [], []
    build = tr._build

    def checked_build(dp, restore_from=None):
        before = None
        if restore_from is not None and tr.in_mesh:
            before = gather_tree(tr._state)
        build(dp, restore_from)
        meshes.append((dp, id(tr._mesh)))
        after = gather_tree(tr._state) if tr.in_mesh else None
        if before is not None and after is not None:
            restores.append((dp, all(
                torch.equal(a, b) for a, b in zip(
                    _leaves(before), _leaves(after)))))
    tr._build = checked_build
    res = tr.run()
    try:
        build(8)
        too_big = None
    except ValueError as err:              # before any collective
        too_big = str(err)
    return dict(res=res, picks=tr.picks, losses=tr.losses, too_big=too_big,
                restores=restores, in_mesh=tr.in_mesh, meshes=meshes,
                made=sorted(tr._meshes),
                step=tr.global_step,
                logs=[(l.comp_idx, l.dp, l.rescaled_from, l.failed,
                       l.stage_times) for l in tr.logs])


def _leaves(t):
    from repro_torch import tree
    return tree.leaves(t)


@pytest.mark.parametrize("target", sorted(TARGETS))
def test_elastic_remesh_over_a_world_of_four(tmp_path, monkeypatch, target):
    """W = 4: the reference's gates, the same DP trace and picks on every
    rank, re-meshes restored bit for bit, rank 0's losses equal the
    world-size-1 run's with the same trace, and a DP degree above the
    world's size raises; each DP degree's mesh is made once and reused
    (its process groups are not made again at a re-mesh)."""
    res = run_world(_world_elastic, 4, str(tmp_path / "store"),
                    timeout=WORLD_TIMEOUT,
                    args=(str(tmp_path / "ck"), TARGETS[target]))
    r0 = res[0]
    out = r0["res"]
    assert out["final_step"] == 8, out
    assert out["n_rescales"] >= 1, out
    assert len(set(out["dp_trace"])) >= 2, out
    for r in res:
        assert "needs 8 ranks; the world has 4" in r["too_big"], r
        assert r["res"] == out and r["picks"] == r0["picks"]
        assert r["logs"] == r0["logs"] and r["step"] == 8
    restores = [x for r in res for x in r["restores"]]
    assert restores and all(ok for _, ok in restores), restores
    # one mesh per DP degree, made at its first use and reused after
    for r in res:
        ids = dict(r["meshes"])
        assert len(ids) == len(set(ids.values())), r["meshes"]
        assert all(ids[dp] == i for dp, i in r["meshes"]), r["meshes"]
        assert r["made"] == sorted((dp, 1) for dp in ids), r["made"]
    assert len(r0["losses"]) == 8 and all(np.isfinite(r0["losses"]))
    # the ranks past the last DP degree idled through its components
    last = r0["logs"][-1][1]
    assert [r["in_mesh"] for r in res] == [i < last for i in range(4)]
    if target == "tight":                 # the loss, then a regrowth
        assert out["dp_trace"] == [4, 4, 2, 2, 4], out
        assert [l[3] for l in r0["logs"]] == [False, False, True, False,
                                              False]
        # checked where a rank holds the state on both meshes: ranks 0-1
        assert sorted(dp for r in res for dp, _ in r["restores"]) == \
            [2, 2, 4, 4]
    # world size 1, the same clock: the same trace and the same losses
    from repro_torch.train import elastic
    cfg, shape = _setup()
    monkeypatch.setattr(elastic, "time", ScriptedClock())
    one = elastic.ElasticTrainer(
        cfg, shape, elastic.ElasticConfig(
            target_runtime=TARGETS[target], ckpt_dir=str(tmp_path / "one"),
            **ELASTIC), device="cpu")
    assert one.run() == out
    assert one.picks == r0["picks"]
    np.testing.assert_allclose(r0["losses"], one.losses, rtol=LOSS_RTOL)


def _torchrun(tmp_path, nproc: int, *flags: str):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["OMP_NUM_THREADS"] = "1"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(nproc), "-m", "repro_torch.launch.train",
           "--arch", "qwen3-0.6b", "--smoke", "--steps", "3", "--device",
           "cpu", "--ckpt", str(tmp_path / "ck"), *flags]
    return subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                          env=env, cwd=str(tmp_path))


def _losses(out: str):
    return [line.split("loss=")[1] for line in out.splitlines()
            if line.startswith("[train] step")]


def test_launcher_under_torchrun(tmp_path, capsys):
    """``--dp 2`` on 2 processes prints the ``--dp 1`` run's losses to 4
    decimals (rank 0 alone prints); ``--dp 3`` on 2 processes raises,
    naming the world's size."""
    from repro_torch.launch.train import main
    main(["--arch", "qwen3-0.6b", "--smoke", "--steps", "3", "--device",
          "cpu", "--ckpt", str(tmp_path / "one")])
    want = _losses(capsys.readouterr().out)
    assert len(want) == 2                           # steps 0 and 2
    got = _torchrun(tmp_path, 2, "--dp", "2")
    assert got.returncode == 0, got.stderr[-3000:]
    assert _losses(got.stdout) == want, (got.stdout, want)
    assert "mesh {'data': 2, 'model': 1}" in got.stdout
    assert got.stdout.count("[train] 3 steps in") == 1
    bad = _torchrun(tmp_path, 2, "--dp", "3")
    assert bad.returncode != 0
    assert "ValueError" in bad.stderr and "mesh of 3 ranks" in bad.stderr \
        and "the world has 2" in bad.stderr, bad.stderr[-2000:]
