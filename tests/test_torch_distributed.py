"""The port's distribution layer in spawned gloo worlds on the CPU, against
the JAX reference on fake XLA devices and against the port on one device.

The reference runs once, in a subprocess with 4 fake host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``, as
``tests/test_multidevice.py`` runs it): ``psum_compressed`` under
``shard_map`` at W = 4, ``make_dp_train_step(compress=False)`` on a mesh
of 2 devices (two steps, each from the state before it), its sharded
train step (``jax.jit`` with ``in_shardings`` from ``state_shardings``) on
meshes (2, 2) and (4, 1) (two steps each, likewise), and the GPipe
forward of its ``make_stage_params``.  Each port world (``launch.world.
run_world``: gloo over a ``FileStore`` under ``tmp_path``, ``spawn``ed
children, a timeout of its own, the group destroyed in ``finally``) runs
several checks.  Tolerances: the compressed all-reduce bit for bit (its
float32 arithmetic is the reference's, operation for operation); losses
1e-5 relative; moments atol 1e-4 / rtol 1e-3; parameters the same wherever
the reference's clipped gradient is at least 100 x Adam's eps and within
two learning-rate steps below that (``tests/test_torch_train.py``'s
``_check_steps``: Adam turns a summation-order difference at |g| ~ eps
into a different step); the compressed step against the uncompressed one
at the reference's gates (loss 1e-4, parameters 5e-3); GPipe at the
reference's 2e-4.
"""
import dataclasses
import math
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.launch.world import run_world

ROOT = Path(__file__).resolve().parent.parent
WORLD_TIMEOUT = 300
ATOL, RTOL, LOSS_RTOL = 1e-4, 1e-3, 1e-5
LR, WARMUP, TOTAL = 1e-3, 1, 8
DP_SHAPE = dict(seq_len=32, global_batch=4)
SHARDED_SHAPE = dict(seq_len=32, global_batch=8)

REFERENCE = """
import dataclasses, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.configs import get_config, smoke_config, TRAIN_4K
from repro.data.pipeline import DataConfig, global_batch
from repro.train.compression import psum_compressed
from repro.train.dp_step import make_dp_train_step
from repro.train.optimizer import AdamWConfig
from repro.train.pipeline import make_stage_params, pipelined_forward, stage_fn
from repro.train.shard_compat import shard_map
from repro.train.train import init_train_state
out = {}
np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
devs = jax.devices()
assert len(devs) == 4, devs
mesh4 = Mesh(np.array(devs), ("data",))
rng = np.random.RandomState(0)
g = rng.randn(4, 256).astype(np.float32)
g[1, :8] = 0.0
g[2, 5] = 40.0
e = (np.random.RandomState(1).randn(4, 256) * 0.01).astype(np.float32)
f = shard_map(lambda gg, ee: psum_compressed(gg[0], ee[0], "data"),
              mesh=mesh4, in_specs=(P("data"), P("data")),
              out_specs=(P(), P("data")))
o, ne = f(jnp.asarray(g), jnp.asarray(e))
out["psum"] = dict(g=g, err=e, out=np.asarray(o),
                   new_err=np.asarray(ne).reshape(4, 256))
cfg = smoke_config(get_config("qwen3-0.6b"))
opt = AdamWConfig(lr=%(lr)r, warmup_steps=%(warmup)r, total_steps=%(total)r)
shape = dataclasses.replace(TRAIN_4K, **%(shape)r)
mesh2 = Mesh(np.array(devs[:2]), ("data",))
step, init_extra = make_dp_train_step(cfg, opt, mesh2, compress=False)
step = jax.jit(step)
state = init_train_state(jax.random.PRNGKey(0), cfg, opt)
err = init_extra(state["params"])
steps = []
for i in range(2):
    b = global_batch(DataConfig(seed=3), cfg, shape, i)
    before = np_tree(state)
    state, err, m = step(state, err, {k: jnp.asarray(v) for k, v in b.items()})
    steps.append(dict(before=before, batch=b, loss=float(m["loss"]),
                      ce=float(m["ce"]), after=np_tree(state)))
out["dp"] = steps
from repro.launch.mesh import make_mesh
from repro.launch.shardings import logical_rules, state_shardings
from repro.models.sharding import use_rules
from repro.train.train import make_train_step
sshape = dataclasses.replace(TRAIN_4K, **%(sshape)r)
out["sharded"] = {}
for dp, tp in ((2, 2), (4, 1)):
    mesh = make_mesh(dp, tp)
    with mesh, use_rules(mesh, logical_rules(cfg, mesh, sshape)):
        host = np_tree(init_train_state(jax.random.PRNGKey(0), cfg, opt))
        ssh = state_shardings(cfg, mesh, host)
        fn = jax.jit(make_train_step(cfg, opt), in_shardings=(ssh, None),
                     out_shardings=None)
        steps = []
        for i in range(2):
            b = global_batch(DataConfig(seed=3), cfg, sshape, i)
            st, m = fn(jax.device_put(host, ssh),
                       {k: jnp.asarray(v) for k, v in b.items()})
            after = np_tree(st)
            steps.append(dict(before=host, batch=b, loss=float(m["loss"]),
                              grad_norm=float(m["grad_norm"]), after=after))
            host = after
    out["sharded"][(dp, tp)] = steps
meshs = Mesh(np.array(devs), ("stage",))
params = make_stage_params(jax.random.PRNGKey(0), n_stages=4, d=16)
x = jax.random.normal(jax.random.PRNGKey(1), (8, 4, 16))
y = pipelined_forward(params, x, meshs)
chain = x
for i in range(4):
    chain = stage_fn({k: v[i] for k, v in params.items()}, chain)
out["pipeline"] = dict(params=np_tree(params), x=np.asarray(x),
                       y=np.asarray(y), chain=np.asarray(chain))
pickle.dump(out, open(sys.argv[1], "wb"))
""" % dict(lr=LR, warmup=WARMUP, total=TOTAL, shape=DP_SHAPE,
         sshape=SHARDED_SHAPE)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's results on 4 fake XLA devices (one subprocess)."""
    path = tmp_path_factory.mktemp("ref") / "ref.pkl"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = str(ROOT / "src")
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(REFERENCE),
                          str(path)], capture_output=True, text=True,
                         timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    with open(path, "rb") as f:
        return pickle.load(f)


def _cfg():
    from repro_torch.configs import get_config, smoke_config
    return smoke_config(get_config("qwen3-0.6b"))


def _opt():
    from repro_torch.train.optimizer import AdamWConfig
    return AdamWConfig(lr=LR, warmup_steps=WARMUP, total_steps=TOTAL)


def _close_tree(port, ref, what, atol=ATOL, rtol=RTOL):
    from repro_torch import tree
    pl, rl = tree.leaves_with_paths(port), tree.leaves_with_paths(ref)
    assert [p for p, _ in pl] == [p for p, _ in rl], what
    for (path, a), (_, b) in zip(pl, rl):
        assert a.dtype == b.dtype and a.shape == b.shape, f"{what}/{path}"
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   atol=atol, rtol=rtol,
                                   err_msg=f"{what}/{path}")


def _params_close(got, want, mu0, step: int, what: str) -> None:
    """Parameters after a step at atol 1e-4 / rtol 1e-3 where ``want``'s
    clipped gradient (from its moments) is at least 100 x eps, and within
    two learning-rate steps everywhere (``_check_steps``)."""
    from repro_torch import tree
    from repro_torch.train.optimizer import lr_at
    opt = _opt()
    lr = float(lr_at(opt, step))
    for (path, a), b, m0, m1 in zip(
            tree.leaves_with_paths(got["params"]),
            tree.leaves(want["params"]), mu0,
            tree.leaves(want["opt"]["mu"])):
        g = (m1 - opt.b1 * m0) / (1 - opt.b1)
        resolved = g.abs() >= 100 * opt.eps
        d = (a - b).abs()
        assert bool((d <= ATOL + RTOL * b.abs())[resolved].all()), \
            f"{what} params/{path}: {float(d[resolved].max())}"
        most = 2 * lr * (1 + opt.weight_decay * b.abs()) + ATOL
        assert bool((d <= most).all()), f"{what} params/{path}"


def _state_close(got, want, mu0, step: int, what: str) -> None:
    _close_tree(got["opt"]["mu"], want["opt"]["mu"], f"{what} mu")
    _close_tree(got["opt"]["nu"], want["opt"]["nu"], f"{what} nu")
    assert int(got["opt"]["step"]) == int(want["opt"]["step"]), what
    _params_close(got, want, mu0, step, what)


def _bit_equal(a, b, what: str) -> None:
    from repro_torch import tree
    la, lb = tree.leaves_with_paths(a), tree.leaves_with_paths(b)
    assert [p for p, _ in la] == [p for p, _ in lb], what
    for (p, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y), f"{what} {p}"


# ------------------------------------------------ compression and GPipe
def _world_compression_pipeline(rank, world, ref_psum, ref_pipe):
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.train import compression as comp
    from repro_torch.train.pipeline import pipelined_forward, stage_fn
    out = {}
    g = torch.from_numpy(ref_psum["g"][rank])
    e = torch.from_numpy(ref_psum["err"][rank])
    got, new_err = comp.psum_compressed(g, e)
    out["psum_equal"] = (np.array_equal(got.numpy(), ref_psum["out"]),
                         np.array_equal(new_err.numpy(),
                                        ref_psum["new_err"][rank]))
    # error feedback over 30 steps at W = 4 and, on rank 0, W = 1
    solo = [dist.new_group([r]) for r in range(world)]
    for name, group, w in (("ef_w4", None, world), ("ef_w1", solo[rank], 1)):
        rng = np.random.RandomState(7)
        true_acc, comp_acc = np.zeros(64), np.zeros(64)
        err = torch.zeros(64)
        for _ in range(30):
            gs = rng.randn(w, 64).astype(np.float32)
            mine = torch.from_numpy(gs[rank % w])
            red, err = comp.psum_compressed(mine, err, group)
            comp_acc += red.numpy()
            true_acc += gs.mean(0)
        out[name] = float(np.abs(comp_acc - true_acc).max()
                          / (np.abs(true_acc).max() + 1e-9))
    # a tree (keys not in sorted order) over two steps: each leaf with its
    # own error state, as the leaf alone
    tree_g = {"b": [g[:8] * 2], "a": g.reshape(16, 16)}
    tree_e = comp.init_error_state(tree_g)
    ea, eb = torch.zeros(16, 16), torch.zeros(8)
    ok = True
    for _ in range(2):
        red, tree_e = comp.psum_compressed_tree(tree_g, tree_e)
        ra, ea = comp.psum_compressed(g.reshape(16, 16), ea)
        rb, eb = comp.psum_compressed(g[:8] * 2, eb)
        ok &= (torch.equal(red["a"], ra) and torch.equal(red["b"][0], rb)
               and torch.equal(tree_e["a"], ea)
               and torch.equal(tree_e["b"][0], eb))
    out["tree"] = ok
    mesh = DeviceMesh("cpu", torch.arange(world), mesh_dim_names=("stage",))
    params = {k: torch.from_numpy(v) for k, v in ref_pipe["params"].items()}
    x = torch.from_numpy(ref_pipe["x"])
    y = pipelined_forward(params, x, mesh)
    chain = x
    for i in range(world):
        chain = stage_fn({k: v[i] for k, v in params.items()}, chain)
    out["pipe_vs_ref"] = float(np.abs(y.numpy() - ref_pipe["y"]).max())
    out["pipe_vs_chain"] = float((y - chain).abs().max())
    out["pipe_finite"] = bool(torch.isfinite(y).all())
    return out


def test_compressed_allreduce_and_gpipe(ref, tmp_path):
    """W = 4: ``psum_compressed`` bit for bit against the reference under
    ``shard_map`` (output and error buffer, with a zeroed and an outlying
    row); error feedback over 30 steps at W = 4 and W = 1 within the
    reference's rel < 0.05; the tree form; 4 GPipe stages over 8
    microbatches against the reference's pipeline and its ``stage_fn``
    chain at 2e-4, from its ``make_stage_params``."""
    res = run_world(_world_compression_pipeline, 4, str(tmp_path),
                    timeout=WORLD_TIMEOUT,
                    args=(ref["psum"], ref["pipeline"]))
    ref_chain = np.abs(ref["pipeline"]["y"] - ref["pipeline"]["chain"]).max()
    assert ref_chain < 2e-4
    for rank, r in enumerate(res):
        assert r["psum_equal"] == (True, True), rank
        assert r["ef_w4"] < 0.05 and r["ef_w1"] < 0.05, r
        assert r["tree"], rank
        assert r["pipe_finite"]
        assert r["pipe_vs_ref"] < 2e-4 and r["pipe_vs_chain"] < 2e-4, r


# ------------------------------------------------------------ DP step
def _reduced_grads(params, cfg, batch, mesh) -> dict:
    """This rank's gradients of its rows of ``batch`` reduced over the
    mesh's ``"data"`` dim both ways, as the DP step reduces them: the int8
    ``psum_compressed_tree`` (``g_c``, from a zero error state) against the
    float32 mean (``u``) and the mean in the gradients' dtype (the
    uncompressed step's).  Returns the largest |g_c - u| in units of the
    leaf's shared scale (``half_steps``: int8 rounding keeps it within
    1/2), the largest gap between ``g_c`` and the mean of ``g - err`` in
    the same units (``ef_gap``: the error buffer holds exactly what the
    int8 payload left out), the norm of ``g_c`` less the uncompressed
    step's reduced gradients (``gap_norm``, which bounds the two steps'
    grad-norm gap) and the new error state (``err``)."""
    import torch.distributed as dist
    from repro_torch.train.compression import (init_error_state,
                                               psum_compressed_tree)
    from repro_torch.train.train import _value_and_grad, local_rows
    group = mesh.get_group("data")
    n = mesh.size(mesh.mesh_dim_names.index("data"))

    def mean(t):
        t = t.clone()
        dist.all_reduce(t, group=group)
        return t / torch.tensor(n, dtype=t.dtype)

    _, _, g = _value_and_grad(params, cfg, local_rows(batch, mesh, ("data",)))
    g_c, err = psum_compressed_tree(g, init_error_state(g), group)
    half, ef, gap2 = 0.0, 0.0, 0.0
    for x, c, e in zip(g, g_c, err):
        s = x.float().abs().max().reshape(1)
        dist.all_reduce(s, op=dist.ReduceOp.MAX, group=group)
        s = float(s) / 127.0
        if s == 0.0:
            continue
        half = max(half, float((c - mean(x.float())).abs().max()) / s)
        ef = max(ef, float((mean(x.float() - e) - c).abs().max()) / s)
        gap2 += float(torch.sum(torch.square(
            c.double() - mean(x).double())))
    return dict(half_steps=half, ef_gap=ef, gap_norm=math.sqrt(gap2),
                err=err)


def _world_dp_step(rank, world, dp_ref):
    from repro_torch import tree
    from repro_torch.convert import train_state_from_numpy
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.dp_step import make_dp_train_step
    from repro_torch.train.train import batch_to_device, make_train_step
    cfg, opt = _cfg(), _opt()
    mesh = make_mesh(2, 1, device_type="cpu")
    step_u, init_extra = make_dp_train_step(cfg, opt, mesh, compress=False)
    step_c, _ = make_dp_train_step(cfg, opt, mesh, compress=True)
    out = {"steps": []}
    for i, rec in enumerate(dp_ref):
        batch = batch_to_device(rec["batch"], "cpu")
        st = train_state_from_numpy(rec["before"], cfg, device="cpu")
        mu0 = [t.clone() for t in tree.leaves(st["opt"]["mu"])]
        err = init_extra(st["params"])
        st, err, m = step_u(st, err, batch)
        want = train_state_from_numpy(rec["after"], cfg, device="cpu")
        _state_close(st, want, mu0, i, f"rank {rank} step {i}")
        cst = train_state_from_numpy(rec["before"], cfg, device="cpu")
        reduced = _reduced_grads(cst["params"], cfg, batch, mesh)
        cst, cerr, cm = step_c(cst, init_extra(cst["params"]), batch)
        dp = max(float((a - b).abs().max()) for a, b in zip(
            tree.leaves(cst["params"]), tree.leaves(st["params"])))
        out["steps"].append(dict(
            loss=float(m["loss"]), ce=float(m["ce"]),
            c_loss=float(cm["loss"]), c_params=dp,
            err_max=max(float(e.abs().max()) for e in tree.leaves(cerr)),
            err_is_reduced=all(torch.equal(a, b) for a, b in zip(
                tree.leaves(cerr), reduced["err"])),
            norm=float(m["grad_norm"]), c_norm=float(cm["grad_norm"]),
            **{k: v for k, v in reduced.items() if k != "err"}))
    # W = 1 on rank 0: the uncompressed DP step is the plain step, bit for
    # bit, over two steps
    solo = make_mesh(1, 1, device_type="cpu")
    if rank == 0:
        step_1, extra_1 = make_dp_train_step(cfg, opt, solo, compress=False)
        plain = make_train_step(cfg, opt)
        a = train_state_from_numpy(dp_ref[0]["before"], cfg, device="cpu")
        b = train_state_from_numpy(dp_ref[0]["before"], cfg, device="cpu")
        err = extra_1(a["params"])
        for rec in dp_ref:
            batch = batch_to_device(rec["batch"], "cpu")
            a, err, ma = step_1(a, err, batch)
            b, mb = plain(b, batch)
            assert float(ma["loss"]) == float(mb["loss"])
            assert float(ma["grad_norm"]) == float(mb["grad_norm"])
        _bit_equal(a, b, "W = 1 DP step vs plain")
        out["w1_bit_equal"] = True
    return out


def test_dp_step_matches_reference(ref, tmp_path):
    """W = 2: the uncompressed DP step against the reference's
    ``make_dp_train_step(compress=False)`` on 2 fake devices, each step from
    the reference's state before it (loss 1e-5; moments and parameters as
    the module says); the compressed step against the uncompressed one at
    the reference's gates (loss < 1e-4, parameters < 5e-3) and at the int8
    bound from the same state: each rank's reduced gradients within half
    a quantization step (scale / 2) of the mean, the step's error buffer
    the one its payload leaves, its grad norm within the norm of the
    gradients' difference of the uncompressed step's (a missing division
    by the group's size or a wrong group fails all three); W = 1: the
    uncompressed DP step equals ``make_train_step`` bit for bit."""
    res = run_world(_world_dp_step, 2, str(tmp_path), timeout=WORLD_TIMEOUT,
                    args=(ref["dp"],))
    for rank, r in enumerate(res):
        for rec, got in zip(ref["dp"], r["steps"]):
            np.testing.assert_allclose(got["loss"], rec["loss"],
                                       rtol=LOSS_RTOL)
            np.testing.assert_allclose(got["ce"], rec["ce"], rtol=LOSS_RTOL)
            assert abs(got["c_loss"] - got["loss"]) < 1e-4, got
            assert got["c_params"] < 5e-3, got
            assert 0 < got["err_max"] < 1.0, got
            # what the compression changes: the reduced gradients within
            # half a quantization step of their mean, the error buffer the
            # step returns exactly the one of its int8 payload, and the
            # grad norm within the norm of the gradients' difference
            assert got["half_steps"] <= 0.5 + 1e-4, got
            assert got["ef_gap"] <= 1e-3, got
            assert got["err_is_reduced"], got
            assert got["gap_norm"] > 0, got
            assert abs(got["c_norm"] - got["norm"]) <= \
                got["gap_norm"] + 1e-5 * got["norm"], got
    assert res[0]["w1_bit_equal"]
    keys = ("loss", "ce", "c_loss", "c_params", "norm", "c_norm")
    for a, b in zip(res[0]["steps"], res[1]["steps"]):   # replicated
        assert {k: a[k] for k in keys} == {k: b[k] for k in keys}


# ------------------------------------------- sharded step and checkpoint
def _expected_local(shape, spec, sizes):
    from repro_torch.launch.shardings import _names
    out = list(shape)
    for d, axis in enumerate(spec):
        for a in _names(axis):
            out[d] //= sizes[a]
    return tuple(out)


def _world_sharded(rank, world, ckdir, ref_sharded):
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch import tree
    from repro_torch.configs import TRAIN_4K
    from repro_torch.convert import train_state_from_numpy
    from repro_torch.data.pipeline import DataConfig, global_batch
    from repro_torch.launch import shardings as sh
    from repro_torch.launch.mesh import make_mesh, mesh_shape
    from repro_torch.launch.specs import state_specs
    from repro_torch.models.sharding import use_rules
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.train import (batch_to_device, init_train_state,
                                         make_train_step)
    cfg, opt = _cfg(), _opt()
    shape = dataclasses.replace(TRAIN_4K, **SHARDED_SHAPE)
    batches = [batch_to_device(global_batch(DataConfig(seed=3), cfg, shape,
                                            i), "cpu") for i in range(2)]
    plain = init_train_state(0, cfg, opt, device="cpu")
    step = make_train_step(cfg, opt)
    plain_losses, plain_mu0 = [], None
    for i, b in enumerate(batches):
        if i == 1:
            plain_mu0 = [t.clone() for t in tree.leaves(plain["opt"]["mu"])]
        plain, m = step(plain, b)
        plain_losses.append(float(m["loss"]))
    out = {}
    for dp, tp, pods in ((2, 2, 1), (4, 1, 1), (2, 1, 2)):
        mesh = make_mesh(dp, tp, pods, device_type="cpu")
        rules = sh.logical_rules(cfg, mesh, shape)
        state = init_train_state(0, cfg, opt, device="cpu")
        specs = sh.state_shardings(cfg, mesh, state)
        state = sh.shard_tree(state, mesh, specs)
        sizes = mesh_shape(mesh)
        flat = dict(tree.leaves_with_paths(specs))
        n_sharded = 0
        for path, t in tree.leaves_with_paths(state):
            assert isinstance(t, DTensor), path
            want = _expected_local(t.shape, flat[path], sizes)
            assert tuple(t.to_local().shape) == want, (path, want)
            n_sharded += want != tuple(t.shape)
        losses, gnorms = [], []
        with use_rules(mesh, rules):
            for i, b in enumerate(batches):
                state, m = step(state, b)
                losses.append(float(m["loss"]))
                gnorms.append(float(m["grad_norm"]))
        full = sh.gather_tree(state)
        np.testing.assert_allclose(losses, plain_losses, rtol=LOSS_RTOL)
        out[tuple(mesh.mesh.shape)] = dict(
            losses=losses, sharded_leaves=n_sharded, rules_dp=rules["dp"])
        # moments and params against the one-device run's (step 2 from
        # the same state up to rounding)
        _close_tree(full["opt"]["mu"], plain["opt"]["mu"], "mu")
        _close_tree(full["opt"]["nu"], plain["opt"]["nu"], "nu")
        assert int(full["opt"]["step"]) == 2
        _params_close(full, plain, plain_mu0, 1, f"mesh {mesh_shape(mesh)}")
        # against the reference's sharded step on the same mesh (``jax.jit``
        # with the state's ``in_shardings``), each step from its state
        ref_losses, ref_norms = [], []
        for i, rec in enumerate(ref_sharded.get((dp, tp), []) if pods == 1
                                else []):
            st = train_state_from_numpy(rec["before"], cfg, device="cpu")
            mu0 = [t.clone() for t in tree.leaves(st["opt"]["mu"])]
            st = sh.shard_tree(st, mesh, sh.state_shardings(cfg, mesh, st))
            with use_rules(mesh, rules):
                st, m = step(st, batch_to_device(rec["batch"], "cpu"))
            want = train_state_from_numpy(rec["after"], cfg, device="cpu")
            _state_close(sh.gather_tree(st), want, mu0, i,
                         f"mesh {mesh_shape(mesh)} step {i} vs reference")
            ref_losses.append(float(m["loss"]))
            ref_norms.append(float(m["grad_norm"]))
        out[tuple(mesh.mesh.shape)].update(vs_ref_losses=ref_losses,
                                           vs_ref_norms=ref_norms)
    # checkpoint: saved on (4, 1), restored onto (2, 1) and one device
    saved = full
    ckpt.save_checkpoint(ckdir, 2, state, metadata={"mesh": [4, 1]})
    assert ckpt.latest_step(ckdir) == 2          # every rank sees it
    mesh2 = make_mesh(2, 1, device_type="cpu")
    template = state_specs(cfg, opt)
    if mesh2.get_coordinate() is not None:
        specs2 = sh.state_shardings(cfg, mesh2, template)
        st2, at, meta = ckpt.restore_checkpoint(
            ckdir, template, device="cpu", shardings=specs2, mesh=mesh2)
        assert at == 2 and meta == {"mesh": [4, 1]}
        _bit_equal(sh.gather_tree(st2), saved, "restored onto (2, 1)")
        out["restored_2x1"] = True
    one, _, _ = ckpt.restore_checkpoint(ckdir, template, device="cpu")
    _bit_equal(one, saved, "restored onto one device")
    dist.barrier()
    return out


def test_sharded_step_and_resharded_checkpoint(ref, tmp_path):
    """W = 4, qwen3 smoke: the state placed by ``state_shardings`` on
    meshes (2, 2), (4, 1) and (2, 2, 1) with ``"pod"`` (the batch split
    over two mesh dims), each rank's local shapes as the rules say; two
    sharded steps against the port's one-device steps (losses
    1e-5, moments and parameters as the module says); on (2, 2) and
    (4, 1), the sharded step against the reference's sharded step on 4
    fake devices, each step from the reference's state before it (loss and
    grad norm 1e-5, moments and parameters as the module says); a
    checkpoint saved on (4, 1) and restored onto (2, 1) and onto one
    device bit for bit."""
    res = run_world(_world_sharded, 4, str(tmp_path / "store"),
                    timeout=WORLD_TIMEOUT,
                    args=(str(tmp_path / "ck"), ref["sharded"]))
    for mesh, recs in ref["sharded"].items():
        for r in res:
            np.testing.assert_allclose(r[mesh]["vs_ref_losses"],
                                       [x["loss"] for x in recs],
                                       rtol=LOSS_RTOL)
            np.testing.assert_allclose(r[mesh]["vs_ref_norms"],
                                       [x["grad_norm"] for x in recs],
                                       rtol=LOSS_RTOL)
    for rank, r in enumerate(res):
        assert r[(2, 2)]["rules_dp"] == ("data",)
        assert r[(4, 1)]["rules_dp"] == ("data",)
        assert r[(2, 2, 1)]["rules_dp"] == ("pod", "data")
        assert r[(2, 2)]["sharded_leaves"] > 0
        assert r[(2, 2)]["losses"] == res[0][(2, 2)]["losses"]
        assert r.get("restored_2x1", False) == (rank < 2)
    assert all(math.isfinite(x) for x in res[0][(4, 1)]["losses"])


# ------------------------------------------------------------ on the card
@pytest.fixture
def card():
    """The CUDA card and nvcc (the attention kernel built here, loaded by
    the world's rank), or a skip naming what is missing."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fa
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is "
                    "False")
    try:
        build.find_nvcc()
    except RuntimeError as err:
        pytest.skip(f"needs nvcc: {err}")
    fa._kernel_fn()
    return torch.device("cuda")


def _world_card(rank, world):
    from repro_torch.configs import TRAIN_4K
    from repro_torch.data.pipeline import DataConfig, global_batch
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch import shardings as sh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.sharding import use_rules
    from repro_torch.train.dp_step import make_dp_train_step
    from repro_torch.train.train import (batch_to_device, init_train_state,
                                         make_train_step)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, opt = _cfg(), _opt()
    shape = dataclasses.replace(TRAIN_4K, **DP_SHAPE)
    batches = [batch_to_device(global_batch(DataConfig(seed=3), cfg, shape,
                                            i), "cuda") for i in range(2)]
    mesh = make_mesh(1, 1)
    rules = sh.logical_rules(cfg, mesh, shape)
    dp_step, _ = make_dp_train_step(cfg, opt, mesh, compress=False)
    plain_step = make_train_step(cfg, opt)
    runs = {}
    for name in ("plain", "dp", "sharded"):
        state = init_train_state(0, cfg, opt, device="cuda")
        if name == "sharded":
            state = sh.shard_tree(state, mesh,
                                  sh.state_shardings(cfg, mesh, state))
        before, losses, norms = fa.LAUNCHES, [], []
        for b in batches:
            if name == "dp":
                state, _, m = dp_step(state, None, b)
            else:
                with use_rules(mesh, rules):
                    state, m = plain_step(state, b)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        runs[name] = (sh.gather_tree(state), losses, norms,
                      fa.LAUNCHES - before)
    plain = runs["plain"]
    for name in ("dp", "sharded"):
        _bit_equal(runs[name][0], plain[0], f"{name} step on the card")
        assert runs[name][1:3] == plain[1:3], (name, runs[name][1:3],
                                               plain[1:3])
    return dict(launches={k: v[3] for k, v in runs.items()})


@pytest.mark.cuda
def test_world_size_one_nccl_steps_on_card(card, tmp_path):
    """A world of one process over NCCL, mesh (1, 1), on the card: the
    uncompressed DP step and the sharded step equal the plain step bit for
    bit over two steps (state, losses and grad norms); each step launches
    the attention kernel once a layer."""
    res = run_world(_world_card, 1, str(tmp_path), backend="nccl",
                    timeout=WORLD_TIMEOUT, threads=0)[0]
    n = _cfg().n_layers * 2
    assert res["launches"] == {"plain": n, "dp": n, "sharded": n}, res


def _world_card_serving(rank, world):
    import dataclasses
    from repro_torch.configs import TRAIN_4K
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_decode import ops as fd
    from repro_torch.launch import shardings as sh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import (decode_step, init_model, next_token,
                                    prefill)
    from repro_torch.models.sharding import use_rules
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(_cfg(), dtype="bfloat16",
                              param_dtype="bfloat16")
    rng = np.random.RandomState(0)
    toks = torch.tensor(rng.randint(0, cfg.raw_vocab_size, (4, 24)),
                        device="cuda")
    mesh = make_mesh(1, 1)
    shape = dataclasses.replace(TRAIN_4K, kind="prefill", seq_len=32,
                                global_batch=4)
    params = init_model(cfg, seed=0, device="cuda")
    runs, counts = {}, {}
    with torch.no_grad():
        for name in ("plain", "sharded"):
            p = params if name == "plain" else \
                sh.shard_tree(params, mesh, sh.tree_shardings(mesh, params))
            fa.LAUNCHES = fd.LAUNCHES = 0
            with use_rules(mesh, sh.logical_rules(cfg, mesh, shape)
                           if name == "sharded" else None):
                logits, cache = prefill(p, cfg, {"tokens": toks},
                                        cache_len=32)
                out = [sh.full_tensor(logits)]
                tok = next_token(logits)
                for i in range(8):
                    logits, cache = decode_step(p, cfg, cache, tok, 24 + i)
                    tok = next_token(logits)
                    out += [sh.full_tensor(logits), sh.full_tensor(tok)]
            runs[name] = out
            counts[name] = (fa.LAUNCHES, fd.LAUNCHES)
    for a, b in zip(runs["plain"], runs["sharded"]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    return counts


@pytest.mark.cuda
def test_world_size_one_nccl_serving_on_card(card, tmp_path):
    """A world of one process over NCCL, mesh (1, 1), qwen3 smoke in bf16
    on the card: the sharded prefill and 8 greedy decode steps on
    ``DTensor`` parameters and ``cache_shardings`` caches equal the plain
    ones bit for bit (logits and tokens), each launching both attention
    kernels once a layer."""
    from repro_torch.kernels.flash_decode import ops as fd
    fd._kernel_fn()
    res = run_world(_world_card_serving, 1, str(tmp_path), backend="nccl",
                    timeout=WORLD_TIMEOUT, threads=0)[0]
    n = _cfg().n_layers
    assert res == {"plain": (n, 8 * n), "sharded": (n, 8 * n)}, res
