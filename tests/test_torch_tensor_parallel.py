"""The sharded train step on local shards (tensor-, expert- and
vocabulary-parallel over ``"model"``, parameters gathered one layer at a
time), its MoE aux loss over the global batch and the sequence-sharded
layouts, in spawned gloo worlds on the CPU, against the JAX reference on
fake XLA devices.

The reference runs once, in a subprocess with 4 fake host devices (as
``tests/test_torch_distributed.py`` runs it): its sharded train step
(``jax.jit(make_train_step)`` with ``in_shardings`` from
``state_shardings``), two steps each from the state before it, and the
gradient of its loss (``jax.grad`` of ``loss_fn``, jitted on the same
shardings) at the first state, for each cell of ``CELLS``: olmoe's smoke
config on meshes (2, 2) and (4, 1), and on (1, 4) the sequence-sharded
layouts: qwen3's smoke config (its 2 kv heads do not split over 4 ranks:
``cache_seq``), a two-head variant (the heads do not split: ``kv_seq``,
the keys split along the sequence and merged by log-sum-exp) and both
with ``seq_parallel_residual`` (Megatron-SP: the residual split along the
sequence between blocks).  The port runs one world of 4 ranks
(``launch.world.run_world``) that holds, in each cell, each step from the
reference's state (loss, ce, aux and grad norm at 1e-5 relative; moments
and parameters as ``tests/test_torch_distributed.py`` holds them), the
gradients of every leaf at the module's atol 1e-4 / rtol 1e-3, the head
and channel counts the kernels' wrappers see, the parameter bytes a rank
holds gathered at once, and, for the sequence-sharded cells, the sharded
prefill, which runs and gives the one-device prefill's logits.
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
# (name, arch, config overrides, mesh): the reference's sharded train steps
SEQ_CELLS = {"qwen3": {}, "two_heads": {"n_heads": 2},
             "sp": {"seq_parallel_residual": True},
             "sp_two_heads": {"n_heads": 2, "seq_parallel_residual": True}}
CELLS = [("moe", MOE_ARCH, {}, m) for m in MESHES] + \
    [(name, "qwen3-0.6b", kw, (1, 4)) for name, kw in SEQ_CELLS.items()]

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
opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=8)
shape = dataclasses.replace(TRAIN_4K, **%(shape)r)
out = {}
for name, arch, kw, (dp, tp) in %(cells)r:
    cfg = dataclasses.replace(smoke_config(get_config(arch)), **kw)
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
    out[(name, (dp, tp))] = dict(steps=steps, rules={
        k: logical_rules(cfg, mesh, shape)[k] for k in (
            "tp_heads", "tp_kv", "kv_seq", "cache_seq", "sp")})
pickle.dump(out, open(sys.argv[1], "wb"))
""" % dict(shape=SHARDED_SHAPE, cells=CELLS)


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


def _world_train(rank, world, ref):
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
    shape = dataclasses.replace(TRAIN_4K, **SHARDED_SHAPE)
    out = {"cells": {}, "prefill": {}}
    for name, arch, kw, (dp, tp) in CELLS:
        cfg = _smoke(arch, **kw)
        step = make_train_step(cfg, opt)
        mesh = make_mesh(dp, tp, device_type="cpu")
        rules = sh.logical_rules(cfg, mesh, shape)
        got = []
        for i, rec in enumerate(ref[(name, (dp, tp))]["steps"]):
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
                                f"{name} grads on {(dp, tp)}")
                st, m = step(st, batch)
            want = train_state_from_numpy(rec["after"], cfg, device="cpu")
            _state_close(sh.gather_tree(st), want, mu0, i,
                         f"{name} on {(dp, tp)} step {i}")
            got.append({k: float(m[k]) for k in ("loss", "ce", "aux",
                                                 "grad_norm")})
        out["cells"][(name, (dp, tp))] = dict(steps=got, rules={
            k: rules[k] for k in ("tp_heads", "tp_kv", "kv_seq",
                                  "cache_seq", "sp")})
        if name in SEQ_CELLS:
            # the sharded prefill on these layouts, against one device's
            pshape = dataclasses.replace(shape, kind="prefill")
            params = init_model(cfg, seed=0, device="cpu")
            sp = sh.shard_tree(params, mesh, sh.tree_shardings(mesh, params))
            toks = {"tokens": batch["tokens"][:, :12]}
            with torch.no_grad():
                want, _ = prefill(params, cfg, toks, cache_len=16)
                with use_rules(mesh, sh.logical_rules(cfg, mesh, pshape)):
                    logits, cache = prefill(sp, cfg, toks, cache_len=16)
            out["prefill"][name] = dict(
                err=float((sh.full_tensor(logits) - want).abs().max()),
                cache=[tuple(t.to_local().shape) for t in
                       cache["layers"][0].values()])

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

    return out


@pytest.fixture(scope="module")
def world(ref, tmp_path_factory):
    """The port's world of 4 ranks (the checks that need the reference's
    values run inside it, raising there; the results come back by
    rank)."""
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
    want = ref[("moe", mesh)]["steps"]
    for rank, r in enumerate(world):
        _steps_close(r["cells"][("moe", mesh)]["steps"], want, rank)
    # the aux loss is a product of global means: a rank's own rows give
    # another value, so a per-rank mean could not pass the gate above
    assert want[0]["aux"] > 0


def _steps_close(got, want, rank):
    for g, w in zip(got, want):
        for k in ("loss", "ce", "aux", "grad_norm"):
            np.testing.assert_allclose(g[k], w[k], rtol=LOSS_RTOL,
                                       err_msg=f"rank {rank} {k}")


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


@pytest.mark.parametrize("name", list(SEQ_CELLS))
def test_sequence_sharded_layouts(ref, world, name):
    """(1, 4), the sequence-sharded layouts: qwen3's smoke config (2 kv
    heads over 4 ranks: the cache splits along its sequence), a two-head
    variant (the heads do not split: the keys do, merged by log-sum-exp)
    and both with ``seq_parallel_residual`` (the residual split along the
    sequence between blocks).  Each sharded step from the reference's
    state against the reference's sharded ``jax.jit`` step (loss, ce,
    aux, grad norm at 1e-5 relative; every gradient at the first state,
    the moments and parameters held inside the world), the rules the
    reference gives, and the sharded prefill: it runs, its logits the
    one-device prefill's (atol 1e-4), its cache split along its
    sequence (16 rows, 4 a rank)."""
    cell = (name, (1, 4))
    want = ref[cell]
    for rank, r in enumerate(world):
        got = r["cells"][cell]
        _steps_close(got["steps"], want["steps"], rank)
        assert got["rules"] == want["rules"], (got["rules"], want["rules"])
        pre = r["prefill"][name]
        assert pre["err"] <= ATOL, pre
        assert all(shape[1] == 4 for shape in pre["cache"]), pre
    rules = want["rules"]
    assert rules["cache_seq"] == "model", rules
    assert rules["kv_seq"] == ("model" if "two_heads" in name else None)
    assert rules["sp"] == ("model" if name.startswith("sp") else None)


def test_block_runs_under_its_rules_on_any_thread(monkeypatch):
    """A sharded block enters the rules its ``Sharded`` carries: on a card
    the recompute of a checkpointed block runs on autograd's thread for
    the device, where the caller's rules (thread-local) are not set."""
    import threading
    from repro_torch.models import transformer as tfm
    from repro_torch.models.sharding import get_rules
    seen = []
    monkeypatch.setattr(tfm, "_layer_body",
                        lambda *a, **k: seen.append(get_rules()))
    sh = tfm.Sharded(mesh="mesh", rules={"sp": None}, tp=None, partial=(),
                     dp_groups=())
    run = threading.Thread(target=tfm._layer_apply, args=(
        {}, None, "attn", "dense", None, "train", None, None, None, None, sh))
    run.start()
    run.join()
    assert seen == [("mesh", {"sp": None})]
    assert get_rules() == (None, None)
