"""The port's distribution rules against the JAX reference, in one process
(no process group): the logical rules, every parameter's spec, the batch,
cache and state specs at the reference's abstract meshes, the meta-device
stand-ins of ``launch/specs.py``, the int8 quantizer, the logical-rule
context and the spec -> placement map.

The reference's meshes are ``jax.sharding.AbstractMesh`` objects; the
port's are ``launch.mesh.AbstractMesh`` with the same sizes and names.
The reference stacks a group's layers on a leading dim; the port keeps a
flat list of layers, so a stacked leaf's spec is compared without its
leading None.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.configs.base import shape_applicable
from repro_torch.launch import shardings as sh
from repro_torch.launch import specs
from repro_torch.launch.mesh import AbstractMesh, dp_axes, dp_size
from repro_torch.models import sharding
from repro_torch.train import compression as comp
from repro_torch.train.optimizer import AdamWConfig

MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((2, 4), ("data", "model")),
          ((2, 3), ("data", "model")),
          ((4, 1), ("data", "model"))]
MESH_IDS = ["x".join(map(str, s)) for s, _ in MESHES]


def _ref_cfg(cfg):
    from repro.configs.base import ModelConfig
    return ModelConfig(**dataclasses.asdict(cfg))


def _ref_shape(shape):
    from repro.configs.base import ShapeConfig
    return ShapeConfig(**dataclasses.asdict(shape))


def _meshes(sizes, names):
    from jax.sharding import AbstractMesh as JaxMesh
    return AbstractMesh(sizes, names), JaxMesh(sizes, names)


def _spec(p):
    """A reference PartitionSpec as a tuple of entries."""
    return tuple(p)


def _ref_paths(ref_tree):
    """{port path: (reference spec function's path, leaf, stacked)} for a
    reference parameter-shaped tree (``groups`` / ``tail`` / whisper's
    ``encoder``), keyed by the port's flat-layer path."""
    import jax
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(ref_tree)[0]:
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        out[tuple(keys)] = (path, leaf)
    return out


def _port_key(keys, cfg):
    """The port's path of a reference leaf, and how many leading stacked
    dims the reference's has (one per layer of a group)."""
    keys = list(keys)
    prefix = []
    if keys[0] in ("mu", "nu"):
        prefix, keys = keys[:1], keys[1:]
    if keys[0] == "encoder" and keys[1] == "groups":
        return prefix + ["encoder", "layers", "*"] + keys[3:], True
    if keys[0] == "groups":
        j = int(keys[1][1:])
        return prefix + ["layers", f"*{j}"] + keys[2:], True
    if keys[0] == "tail":
        t = int(keys[1])
        return prefix + ["layers", f"tail{t}"] + keys[2:], False
    return prefix + keys, False


def _expand(port_keys, cfg):
    """The port's layer indices a reference key stands for."""
    out = []
    for i, k in enumerate(port_keys):
        if k == "*":
            return [port_keys[:i] + [str(n)] + port_keys[i + 1:]
                    for n in range(cfg.enc_layers)]
        if k.startswith("*"):
            j = int(k[1:])
            return [port_keys[:i] + [str(g * cfg.layer_period + j)]
                    + port_keys[i + 1:] for g in range(cfg.n_groups)]
        if k.startswith("tail"):
            t = int(k[4:])
            return [port_keys[:i] + [str(cfg.n_groups * cfg.layer_period + t)]
                    + port_keys[i + 1:]]
    return [port_keys]


# ---------------------------------------------------------------- rules
@pytest.mark.parametrize("mesh_def", MESHES, ids=MESH_IDS)
def test_logical_rules_match_reference(mesh_def):
    """Every arch x every shape on the mesh."""
    from repro.launch.shardings import logical_rules as ref_rules
    mesh, jmesh = _meshes(*mesh_def)
    for arch in list_archs():
        cfg = get_config(arch)
        for shape in SHAPES.values():
            got = sh.logical_rules(cfg, mesh, shape)
            want = ref_rules(_ref_cfg(cfg), jmesh, _ref_shape(shape))
            assert got == want, (arch, shape.name, got, want)
    assert dp_axes(mesh) == tuple(a for a in ("pod", "data")
                                  if a in mesh_def[1])
    assert dp_size(mesh) == int(np.prod(mesh_def[0][:-1]))


def test_rules_reference_cases():
    """The reference's own cases (``tests/test_multidevice.py``)."""
    train, long = SHAPES["train_4k"], SHAPES["long_500k"]
    mesh4 = AbstractMesh((2, 4), ("data", "model"))
    mesh3 = AbstractMesh((2, 3), ("data", "model"))
    r = sh.logical_rules(get_config("olmoe-1b-7b"), mesh4, train)
    assert r["tp_heads"] == "model" and r["ep"] == "model", r
    r = sh.logical_rules(get_config("qwen2.5-14b"), mesh4, train)
    assert r["tp_heads"] == "model", r
    r = sh.logical_rules(get_config("qwen2.5-14b"), mesh3, train)
    assert r["tp_heads"] is None and r["kv_seq"] == "model", r
    r = sh.logical_rules(get_config("jamba-v0.1-52b"), mesh3, long)
    assert r["dp"] is None and r["cache_seq"] == ("data", "model"), r
    leaf = torch.empty((7, 1024), device="meta")
    assert sh.param_spec(mesh4, "layers/0/attn/wq", leaf) == \
        sh.P(None, "model")                       # 7 % 2 != 0 -> dropped


@pytest.mark.parametrize("mesh_def", MESHES, ids=MESH_IDS)
def test_param_and_state_specs_match_reference(mesh_def):
    """Every leaf of every arch at its published width (the port's
    ``init_model`` on the meta device, the reference's ``eval_shape``),
    params and both moments, through the unstacking; the step count is
    replicated."""
    from repro.launch.shardings import state_shardings as ref_state
    from repro.launch.specs import state_specs as ref_specs
    from repro.train.optimizer import AdamWConfig as RefAdamW
    mesh, jmesh = _meshes(*mesh_def)
    for arch in list_archs():
        cfg = get_config(arch)
        port = dict(tree.leaves_with_paths(
            sh.state_shardings(cfg, mesh, specs.state_specs(cfg,
                                                             AdamWConfig()))))
        rs = ref_specs(_ref_cfg(cfg), RefAdamW())
        ref = ref_state(_ref_cfg(cfg), jmesh, rs)
        seen = set()
        for keys, (path, ns) in _ref_paths(ref).items():
            keys = list(keys)
            root, rest = keys[0], keys[1:]
            if root == "opt" and rest == ["step"]:
                assert port["opt/step"] == sh.P() and _spec(ns.spec) == ()
                seen.add("opt/step")
                continue
            pkeys, stacked = _port_key(rest if root == "opt" else rest, cfg)
            want = _spec(ns.spec)[1:] if stacked else _spec(ns.spec)
            for k in _expand(pkeys, cfg):
                p = "/".join([root] + k)
                assert tuple(port[p]) == want, (arch, p, port[p], want)
                seen.add(p)
        assert seen == set(port), (arch, set(port) - seen)


@pytest.mark.parametrize("mesh_def", MESHES, ids=MESH_IDS)
def test_batch_and_cache_specs_match_reference(mesh_def):
    """``batch_shardings`` and ``cache_shardings`` for every arch and every
    shape that applies to it."""
    from repro.launch.shardings import batch_shardings as ref_batch
    from repro.launch.shardings import cache_shardings as ref_cache
    mesh, jmesh = _meshes(*mesh_def)
    for arch in list_archs():
        cfg = get_config(arch)
        for shape in SHAPES.values():
            if not shape_applicable(cfg, shape)[0]:
                continue
            rcfg, rshape = _ref_cfg(cfg), _ref_shape(shape)
            got = sh.batch_shardings(cfg, mesh, shape)
            want = ref_batch(rcfg, jmesh, rshape)
            assert {k: tuple(v) for k, v in got.items()} == \
                {k: _spec(v.spec) for k, v in want.items()}, (arch, shape)
            port = dict(tree.leaves_with_paths(
                sh.cache_shardings(cfg, mesh, shape)))
            n = 0
            for keys, (_, ns) in _ref_paths(
                    ref_cache(rcfg, jmesh, rshape)).items():
                pkeys, stacked = _port_key(list(keys), cfg)
                want_spec = _spec(ns.spec)[1:] if stacked else _spec(ns.spec)
                for k in _expand(pkeys, cfg):
                    assert tuple(port["/".join(k)]) == want_spec, \
                        (arch, shape.name, k)
                    n += 1
            assert n == len(port), (arch, shape.name)


# ---------------------------------------------------------------- specs
def test_input_cache_state_specs_match_reference():
    """Shapes and ``bytes_of`` of the meta-device stand-ins against the
    reference's ``ShapeDtypeStruct`` trees for every arch and applicable
    shape: token ids and the decode position int64 where the reference's
    are int32, the step count int64; every other dtype the same; nothing
    is allocated."""
    import jax
    from repro.launch import specs as ref
    from repro.train.optimizer import AdamWConfig as RefAdamW
    mapped = {"int32": torch.int64, "bfloat16": torch.bfloat16,
              "float32": torch.float32}
    for arch in list_archs():
        cfg = get_config(arch)
        rcfg = _ref_cfg(cfg)
        for shape in SHAPES.values():
            if not shape_applicable(cfg, shape)[0]:
                continue
            rshape = _ref_shape(shape)
            assert specs.text_len(cfg, shape) == ref.text_len(rcfg, rshape)
            got, want = specs.input_specs(cfg, shape), \
                ref.input_specs(rcfg, rshape)
            assert set(got) == set(want), (arch, shape.name)
            for k, v in got.items():
                assert v.device.type == "meta"
                assert tuple(v.shape) == tuple(want[k].shape), (arch, k)
                assert v.dtype == mapped[str(want[k].dtype)], (arch, k)
            ints = sum(int(np.prod(v.shape)) for v in want.values()
                       if str(v.dtype) == "int32")
            assert specs.bytes_of(got) == ref.bytes_of(want) + 4 * ints
            if shape.kind == "decode":
                c = specs.cache_specs(cfg, shape)
                rc = ref.cache_specs(rcfg, rshape)
                assert specs.bytes_of(c) == ref.bytes_of(rc), (arch, shape)
                assert len(tree.leaves(c)) * 1 >= len(
                    jax.tree_util.tree_leaves(rc))
        st = specs.state_specs(cfg, AdamWConfig())
        rst = ref.state_specs(rcfg, RefAdamW())
        assert all(t.device.type == "meta" for t in tree.leaves(st))
        assert specs.bytes_of(st) == ref.bytes_of(rst) + 4, arch
        assert specs.bytes_of(specs.param_specs(cfg)) == \
            ref.bytes_of(ref.param_specs(rcfg)), arch
        assert sum(t.numel() for t in tree.leaves(st["params"])) == \
            sum(int(np.prod(l.shape))
                for l in jax.tree_util.tree_leaves(rst["params"]))


# ----------------------------------------------------------- compression
def test_quantize_dequantize_bit_equal_to_reference():
    """Round half to even, clipping to +-127, at scales that put values on
    the .5 boundaries and past the clip."""
    import jax.numpy as jnp
    from repro.train import compression as ref
    rng = np.random.RandomState(0)
    g = np.concatenate([rng.randn(997) * 5, np.arange(-8, 8.5, 0.5),
                        [1e3, -1e3, 0.0]]).astype(np.float32)
    for scale in (np.float32(np.abs(g[:997]).max() / 127.0),
                  np.float32(0.5), np.float32(1.0), np.float32(3e-3)):
        q = comp.quantize(torch.from_numpy(g), torch.tensor(scale))
        rq = np.asarray(ref.quantize(jnp.asarray(g), jnp.asarray(scale)))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), rq)
        d = comp.dequantize(q, torch.tensor(scale)).numpy()
        np.testing.assert_array_equal(
            d, np.asarray(ref.dequantize(jnp.asarray(rq), jnp.asarray(scale))))


def test_quantization_error_bound_and_ratio():
    """The reference's gates (``tests/test_train_substrate.py``)."""
    rng = np.random.RandomState(0)
    g = torch.from_numpy(rng.randn(1000) * 5).float()
    scale = torch.max(torch.abs(g)) / 127.0
    err = g - comp.dequantize(comp.quantize(g, scale), scale)
    assert float(torch.max(torch.abs(err))) <= float(scale) / 2 + 1e-6
    params = {"a": torch.zeros((128, 128)), "b": torch.zeros((512,))}
    assert 3.5 < comp.compression_ratio(params) < 4.0
    from repro.train.compression import compression_ratio as ref_ratio
    import jax.numpy as jnp
    assert comp.compression_ratio(params) == ref_ratio(
        {"a": jnp.zeros((128, 128)), "b": jnp.zeros((512,))})
    e = comp.init_error_state(params)
    assert [t.dtype for t in tree.leaves(e)] == [torch.float32] * 2


# ------------------------------------------------------ rules and mapping
def test_constrain_without_rules_and_use_rules_restores():
    x = torch.randn(2, 3)
    assert sharding.constrain(x, "dp", None) is x
    assert sharding.logical_spec("dp", None) is None
    mesh = AbstractMesh((2, 1), ("data", "model"))
    rules = {"dp": ("data",), "tp_ff": "model"}
    sharding.set_rules("outer", {"dp": "x"})
    try:
        with sharding.use_rules(mesh, rules):
            assert sharding.get_rules() == (mesh, rules)
            assert sharding.logical_spec("dp", None, "tp_ff") == \
                sh.P(("data",), None, "model")
            # a plain tensor stays as it is inside a mesh (item 13c)
            assert sharding.constrain(x, "dp", None) is x
            with pytest.raises(AssertionError):
                sharding.constrain(x, "dp")
        assert sharding.get_rules() == ("outer", {"dp": "x"})
    finally:
        sharding.set_rules(None, None)
    assert sharding.get_rules() == (None, None)


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard

    class FakeMesh:                 # ``placements`` reads the dim names
        mesh_dim_names = ("pod", "data", "model")
    m = FakeMesh()
    assert sh.placements(m, sh.P("model", "data")) == \
        (Replicate(), Shard(1), Shard(0))
    assert sh.placements(m, sh.P(("data", "model"), None)) == \
        (Replicate(), Shard(0), Shard(0))
    assert sh.placements(m, sh.P(("pod", "data"), None)) == \
        (Shard(0), Shard(0), Replicate())
    assert sh.placements(m, sh.P()) == (Replicate(),) * 3
    assert sh.placements(m, None) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="order"):
        sh.placements(m, sh.P(("model", "data")))


def test_make_mesh_needs_a_world():
    """Without a process group a mesh of more than one rank raises, naming
    the ranks it needs, as ``jax.make_mesh`` does without the devices."""
    from repro_torch.launch.mesh import make_mesh, make_production_mesh
    with pytest.raises(RuntimeError, match="needs 4 ranks"):
        make_mesh(2, 2, device_type="cpu")
    with pytest.raises(RuntimeError, match="world of 512 ranks; it has 1"):
        make_production_mesh(True, device_type="cpu")
    assert AbstractMesh((2, 16, 16), ("pod", "data", "model")).size == 512
