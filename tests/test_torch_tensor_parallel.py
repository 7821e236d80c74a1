"""The sharded train step on local shards (tensor-, expert- and
vocabulary-parallel over ``"model"``, parameters gathered one layer at a
time) and its MoE aux loss over the global batch, in spawned gloo worlds
on the CPU, against the JAX reference on fake XLA devices.

The reference runs once, in a subprocess with 4 fake host devices (as
``tests/test_torch_distributed.py`` runs it): its sharded train step
(``jax.jit(make_train_step)`` with ``in_shardings`` from
``state_shardings``) for olmoe's smoke config on meshes (2, 2) and (4, 1),
two steps each from the state before it, and the gradient of its loss
(``jax.grad`` of ``loss_fn``, jitted on the same shardings) at the first
state.  The port runs one world of 4 ranks (``launch.world.run_world``)
that holds, on each mesh, each step from the reference's state (loss,
ce, aux and grad norm at 1e-5 relative; moments and parameters as
``tests/test_torch_distributed.py`` holds them), the gradients of every
leaf, the routers' among them, at the module's atol 1e-4 / rtol 1e-3, the
head and channel counts the kernels' wrappers see, the parameter bytes a
rank holds gathered at once, and the sequence-sharded layouts (ROADMAP.md
item 13d): qwen3's smoke config on (1, 4) and a two-head variant whose
heads do not split train as the one-device step does, and their prefill
raises, naming item 13d.
"""
import dataclasses
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
from test_torch_distributed import (ATOL, LOSS_RTOL, RTOL, SHARDED_SHAPE,
                                    WORLD_TIMEOUT, _close_tree, _opt,
                                    _state_close)

ROOT = Path(__file__).resolve().parent.parent
MOE_ARCH = "olmoe-1b-7b"
MESHES = ((2, 2), (4, 1))

REFERENCE = """
import dataclasses, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config, smoke_config, TRAIN_4K
from repro.data.pipeline import DataConfig, global_batch
from repro.launch.mesh import make_mesh
from repro.launch.shardings import logical_rules, state_shardings
from repro.models.sharding import use_rules
from repro.train.optimizer import AdamWConfig
from repro.train.train import init_train_state, loss_fn, make_train_step
np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
assert len(jax.devices()) == 4
cfg = smoke_config(get_config(%(arch)r))
opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=8)
shape = dataclasses.replace(TRAIN_4K, **%(shape)r)
out = {}
for dp, tp in %(meshes)r:
    mesh = make_mesh(dp, tp)
    with mesh, use_rules(mesh, logical_rules(cfg, mesh, shape)):
        host = np_tree(init_train_state(jax.random.PRNGKey(0), cfg, opt))
        ssh = state_shardings(cfg, mesh, host)
        fn = jax.jit(make_train_step(cfg, opt), in_shardings=(ssh, None),
                     out_shardings=None)
        grad = jax.jit(jax.grad(lambda p, b: loss_fn(p, cfg, b)[0]),
                       in_shardings=(ssh["params"], None))
        steps = []
        for i in range(2):
            b = global_batch(DataConfig(seed=3), cfg, shape, i)
            jb = {k: jnp.asarray(v) for k, v in b.items()}
            g = np_tree(grad(jax.device_put(host["params"], ssh["params"]),
                             jb)) if i == 0 else None
            st, m = fn(jax.device_put(host, ssh), jb)
            after = np_tree(st)
            steps.append(dict(before=host, batch=b, grads=g,
                              **{k: float(m[k]) for k in
                                 ("loss", "ce", "aux", "grad_norm")},
                              after=after))
            host = after
    out[(dp, tp)] = steps
pickle.dump(out, open(sys.argv[1], "wb"))
""" % dict(arch=MOE_ARCH, shape=SHARDED_SHAPE, meshes=MESHES)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's sharded steps and gradients (one subprocess)."""
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


def _smoke(arch, **kw):
    from repro_torch.configs import get_config, smoke_config
    return dataclasses.replace(smoke_config(get_config(arch)), **kw)


class _Shapes:
    """Records the shapes the kernels' wrappers are called with, as the
    models call them."""

    def __init__(self):
        self.seen = {}

    def wrap(self, module, name):
        fn = getattr(module, name)

        def rec(*args, **kw):
            self.seen.setdefault(name, set()).add(
                tuple(tuple(a.shape) for a in args[:3]
                      if isinstance(a, torch.Tensor)))
            return fn(*args, **kw)
        setattr(module, name, rec)


class _Live:
    """The parameter bytes a rank holds gathered (``launch.shardings.
    _gather``'s outputs that are still alive), and their most."""

    def __init__(self):
        import weakref
        from repro_torch.launch import shardings
        self.now = self.most = 0
        inner = shardings._gather

        def gather(local, mesh, pl, over):
            out = inner(local, mesh, pl, over)
            if out.data_ptr() != local.data_ptr():
                n = out.numel() * out.element_size()
                self.now += n
                self.most = max(self.most, self.now)
                weakref.finalize(out, self._free, n)
            return out
        shardings._gather = gather

    def _free(self, n):
        self.now -= n


def _layer_bytes(params) -> int:
    from repro_torch import tree
    size = lambda t: sum(x.numel() * x.element_size()
                         for x in tree.leaves(t))
    return max([size(lp) for lp in params["layers"]] +
               [size(params[k]) for k in ("embed", "unembed")
                if k in params])


def _sharded_state(rec, cfg, mesh):
    from repro_torch.convert import train_state_from_numpy
    from repro_torch.launch import shardings as sh
    st = train_state_from_numpy(rec, cfg, device="cpu")
    return sh.shard_tree(st, mesh, sh.state_shardings(cfg, mesh, st))


def _world_train(rank, world, ref_moe):
    from repro_torch import tree
    from repro_torch.configs import TRAIN_4K
    from repro_torch.convert import lm_params_from_numpy, \
        train_state_from_numpy
    from repro_torch.data.pipeline import DataConfig, global_batch
    from repro_torch.launch import shardings as sh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import attention, init_model, prefill, ssm
    from repro_torch.models.sharding import use_rules
    from repro_torch.train.train import (_sharded_value_and_grad,
                                         batch_to_device, init_train_state,
                                         make_train_step)
    opt = _opt()
    step = make_train_step(_smoke(MOE_ARCH), opt)
    shape = dataclasses.replace(TRAIN_4K, **SHARDED_SHAPE)
    out = {"moe": {}}
    cfg = _smoke(MOE_ARCH)
    for dp, tp in MESHES:
        mesh = make_mesh(dp, tp, device_type="cpu")
        rules = sh.logical_rules(cfg, mesh, shape)
        got = []
        for i, rec in enumerate(ref_moe[(dp, tp)]):
            st = _sharded_state(rec["before"], cfg, mesh)
            mu0 = [t.clone() for t in tree.leaves(
                train_state_from_numpy(rec["before"], cfg,
                                       device="cpu")["opt"]["mu"])]
            batch = batch_to_device(rec["batch"], "cpu")
            with use_rules(mesh, rules):
                if rec["grads"] is not None:
                    _, _, grads = _sharded_value_and_grad(st["params"], cfg,
                                                          batch)
                    paths = [q for q, _ in
                             tree.leaves_with_paths(st["params"])]
                    full = dict(zip(paths, (sh.full_tensor(g).detach()
                                            for g in grads)))
                    want = lm_params_from_numpy(rec["grads"], cfg, "cpu")
                    _close_tree(tree.map_with_paths(lambda q, _: full[q],
                                                    st["params"]), want,
                                f"grads on {(dp, tp)}")
                st, m = step(st, batch)
            want = train_state_from_numpy(rec["after"], cfg, device="cpu")
            _state_close(sh.gather_tree(st), want, mu0, i,
                         f"{MOE_ARCH} on {(dp, tp)} step {i}")
            got.append({k: float(m[k]) for k in ("loss", "ce", "aux",
                                                 "grad_norm")})
        out["moe"][(dp, tp)] = got

    # the wrappers' shapes and the gathered bytes: olmoe and qwen3 on
    # (2, 2) under remat, one step against the one-device step
    shapes = _Shapes()
    shapes.wrap(attention, "mha")
    shapes.wrap(ssm, "mlstm")
    shapes.wrap(ssm, "selective_scan")
    live = _Live()
    mesh = make_mesh(2, 2, device_type="cpu")
    out["layers"] = {}
    for arch in (MOE_ARCH, "qwen3-0.6b", "xlstm-350m", "jamba-v0.1-52b"):
        cfg = _smoke(arch, remat="full")
        rules = sh.logical_rules(cfg, mesh, shape)
        batch = batch_to_device(global_batch(DataConfig(seed=3), cfg, shape,
                                             0), "cpu")
        plain = init_train_state(0, cfg, opt, device="cpu")
        st = sh.shard_tree(init_train_state(0, cfg, opt, device="cpu"),
                           mesh, sh.state_shardings(cfg, mesh, plain))
        step = make_train_step(cfg, opt)
        shapes.seen.clear()
        live.most = 0
        with use_rules(mesh, rules):
            st, m = step(st, batch)
        seen = {k: sorted(v) for k, v in shapes.seen.items()}
        plain, mp = step(plain, batch)
        out["layers"][arch] = dict(
            shapes=seen, most=live.most, layer=_layer_bytes(plain["params"]),
            tree=sum(x.numel() * x.element_size()
                     for x in tree.leaves(plain["params"])),
            loss=(float(m["loss"]), float(mp["loss"])),
            norm=(float(m["grad_norm"]), float(mp["grad_norm"])))

    # the sequence-sharded layouts (ROADMAP.md item 13d) on (1, 4)
    mesh = make_mesh(1, 4, device_type="cpu")
    out["13d"] = {}
    for name, cfg in (("qwen3", _smoke("qwen3-0.6b")),
                      ("two_heads", _smoke("qwen3-0.6b", n_heads=2))):
        rules = sh.logical_rules(cfg, mesh, shape)
        batches = [batch_to_device(global_batch(DataConfig(seed=3), cfg,
                                                shape, i), "cpu")
                   for i in range(2)]
        plain = init_train_state(0, cfg, opt, device="cpu")
        st = sh.shard_tree(init_train_state(0, cfg, opt, device="cpu"),
                           mesh, sh.state_shardings(cfg, mesh, plain))
        step = make_train_step(cfg, opt)
        losses = []
        for b in batches:
            with use_rules(mesh, rules):
                st, m = step(st, b)
            plain, mp = step(plain, b)
            losses.append((float(m["loss"]), float(mp["loss"])))
        _close_tree(sh.gather_tree(st)["opt"]["mu"], plain["opt"]["mu"],
                    f"{name} on (1, 4) mu")
        pshape = dataclasses.replace(shape, kind="prefill")
        params = sh.shard_tree(init_model(cfg, seed=0, device="cpu"), mesh,
                               sh.tree_shardings(mesh, plain["params"]))
        try:
            with use_rules(mesh, sh.logical_rules(cfg, mesh, pshape)), \
                    torch.no_grad():
                prefill(params, cfg, {"tokens": batches[0]["tokens"]})
            raised = None
        except NotImplementedError as err:
            raised = str(err)
        out["13d"][name] = dict(losses=losses, raised=raised,
                                rules={k: rules[k] for k in (
                                    "tp_heads", "tp_kv", "kv_seq",
                                    "cache_seq")})
    return out


@pytest.fixture(scope="module")
def world(ref, tmp_path_factory):
    """The port's world of 4 ranks (the checks that need the reference's
    values run inside it; the results come back by rank)."""
    return run_world(_world_train, 4,
                     str(tmp_path_factory.mktemp("store")),
                     timeout=WORLD_TIMEOUT, args=(ref,))


@pytest.mark.parametrize("mesh", MESHES)
def test_moe_aux_of_the_global_batch(ref, world, mesh):
    """olmoe smoke on (2, 2) and (4, 1): each sharded step from the
    reference's state against the reference's sharded ``jax.jit`` step:
    loss, ce, the aux loss (the global batch's on every rank, not the
    mean of the ranks' own) and grad norm at 1e-5 relative; moments and
    parameters, and at the first state every gradient, the routers' too,
    held inside the world (they raise there)."""
    for rank, r in enumerate(world):
        for got, want in zip(r["moe"][mesh], ref[mesh]):
            for k in ("loss", "ce", "aux", "grad_norm"):
                np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL,
                                           err_msg=f"rank {rank} {k}")
    # the aux loss is a product of global means: a rank's own rows give
    # another value, so a per-rank mean could not pass the gate above
    assert ref[mesh][0]["aux"] > 0


@pytest.mark.parametrize("arch", [MOE_ARCH, "qwen3-0.6b", "xlstm-350m",
                                  "jamba-v0.1-52b"])
def test_local_shards_and_layer_gathers(world, arch):
    """On (2, 2) under ``remat="full"``: the kernels' wrappers see this
    rank's heads and channels (2 of 4 q heads, 1 of 2 kv heads; 2 of 4
    mLSTM heads; 64 of 128 Mamba channels), the most parameter bytes a
    rank holds gathered at once are at most one layer's or the
    embedding's (never the tree's), and the step equals the one-device
    step (loss 1e-5, grad norm 1e-4 relative)."""
    cfg = _smoke(arch)
    for r in world:
        got = r["layers"][arch]
        np.testing.assert_allclose(*got["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(*got["norm"], rtol=1e-4)
        assert 0 < got["most"] <= got["layer"] < got["tree"], got
        shapes = got["shapes"]
        if "mha" in shapes:
            for q, k, v in shapes["mha"]:
                assert (q[2], k[2], v[2]) == (2, 1, 1), shapes
        if "mlstm" in shapes:
            for q, k, v in shapes["mlstm"]:
                assert q[2] == k[2] == v[2] == cfg.n_heads // 2, shapes
        if "selective_scan" in shapes:
            di = cfg.mamba_expand * cfg.d_model
            for dt, a, x in shapes["selective_scan"]:
                assert dt[-1] == x[-1] == a[0] == di // 2, shapes
        assert shapes, arch


@pytest.mark.parametrize("name", ["qwen3", "two_heads"])
def test_sequence_sharded_layouts(world, name):
    """(1, 4): qwen3's smoke config (2 kv heads over 4 ranks: its cache
    would split along the sequence) and a two-head variant (heads do not
    split: the keys would) train as the one-device step does (loss 1e-5,
    first moments as the module holds them, inside the world); the
    two-head variant's attention runs whole on every rank.  Their sharded
    prefill raises ``NotImplementedError`` naming ROADMAP.md item 13d."""
    for r in world:
        got = r["13d"][name]
        for a, b in got["losses"]:
            np.testing.assert_allclose(a, b, rtol=LOSS_RTOL)
        assert got["raised"] is not None and "13d" in got["raised"], got
        if name == "two_heads":
            assert got["rules"]["kv_seq"] == "model", got["rules"]
        else:
            assert got["rules"]["cache_seq"] == "model", got["rules"]
