"""Sharded prefill and decode (parameters as ``DTensor`` objects, caches
placed by ``launch.shardings.cache_shardings``, heads, channels, experts
and the vocabulary on local shards over ``"model"``) in spawned gloo
worlds on the CPU, against the reference's jitted ``prefill_step`` and
``serve_step`` (``repro/launch/dryrun.py:122-147``), executed on fake XLA
devices.

The reference runs once, in a subprocess with 4 fake host devices: for the
smoke configs of qwen3, olmoe, jamba, xlstm-350m and whisper, on meshes
(2, 2) and (1, 2), and for the sequence-sharded layouts of ``SEQ_CELLS``
(a cache split along its sequence over ``"model"``, ``("data",)`` or
``("data", "model")``, keys split over ``"model"`` where the heads do
not divide), its ``prefill_step`` (the last position's logits and the
cache, out-sharded as the dry run shards them) on 4 prompts (one at B =
1) of 12 tokens with a cache of 16 rows, then ``serve_step`` 4 times (the
next tokens, each fed back, and the cache); and it records that its
``pjit`` refuses a cache of 14 rows split over 4 ranks.  The dry run's functions are
closures over the cell's shape; they are written out here, the cache
length given so that decode has rows to write.  The port runs one world
of 4 ranks (``launch.world.run_world``; (1, 2) on its first two) from the
reference's weights: the prefill's logits and every cache leaf at atol
1e-4 / rtol 1e-3 (jamba and xlstm at the reference's 2e-4 between scan
forms, ``tests/test_kernels.py:101``), each cache leaf's local shape the
one ``cache_shardings`` gives, the next tokens equal to the reference's
wherever the port's two best logits are more than 1e-3 apart, and the
head and channel counts the kernels' wrappers see.
"""
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
from test_torch_distributed import ATOL, RTOL, WORLD_TIMEOUT, _expected_local
from test_torch_tensor_parallel import _Shapes, _smoke

ROOT = Path(__file__).resolve().parent.parent
ARCHS = ("qwen3-0.6b", "olmoe-1b-7b", "jamba-v0.1-52b", "xlstm-350m",
         "whisper-medium")
MESHES = ((2, 2), (1, 2))
BATCH, PROMPT, NEW = 4, 12, 4
CACHE = PROMPT + NEW
SCAN_ATOL = {"jamba-v0.1-52b": 2e-4, "xlstm-350m": 2e-4}
MARGIN = 1e-3
# the sequence-sharded layouts: name -> (arch, config overrides, mesh, batch)
SEQ_CELLS = {
    "qwen3@(1,4)": ("qwen3-0.6b", {}, (1, 4), BATCH),
    "qwen3-2heads@(1,4)": ("qwen3-0.6b", {"n_heads": 2}, (1, 4), BATCH),
    "gemma2-window5@(1,4)": ("gemma2-2b", {"sliding_window": 5}, (1, 4),
                             BATCH),
    "whisper-2heads@(1,4)": ("whisper-medium", {"n_heads": 2}, (1, 4),
                             BATCH),
    "jamba@(1,4)": ("jamba-v0.1-52b", {}, (1, 4), BATCH),
    "qwen3-b1@(2,2)": ("qwen3-0.6b", {}, (2, 2), 1),
    "qwen3-b1-1kv@(2,2)": ("qwen3-0.6b", {"n_kv_heads": 1}, (2, 2), 1)}
CELLS = [(a, a, {}, m, BATCH) for a in ARCHS for m in MESHES] + \
    [(name, *cell) for name, cell in SEQ_CELLS.items()]
REFUSED = 14                # a cache that does not split over 4 ranks

REFERENCE = """
import dataclasses, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config, smoke_config, TRAIN_4K
from repro.launch.mesh import make_mesh
from repro.launch.shardings import (batch_shardings, cache_shardings,
                                    logical_rules, tree_shardings)
from repro.models import decode_step, init_model, prefill
from repro.models.sharding import use_rules
np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
assert len(jax.devices()) == 4
PROMPT, NEW, CACHE = %(prompt)r, %(new)r, %(cache)r
out = {}
for name, arch, kw, (dp, tp), B in %(cells)r:
    cfg = dataclasses.replace(smoke_config(get_config(arch)), **kw)
    if name not in out:
        params = np_tree(init_model(jax.random.PRNGKey(0), cfg))
        rng = np.random.RandomState(1)
        batch = {"tokens": rng.randint(0, cfg.raw_vocab_size,
                                       (B, PROMPT)).astype(np.int32)}
        if cfg.family == "audio":
            batch["frames"] = rng.randn(B, cfg.enc_frames,
                                        cfg.d_model).astype(np.float32)
        out[name] = {"params": params, "batch": batch}
    params, batch = out[name]["params"], out[name]["batch"]
    mesh = make_mesh(dp, tp)
    shape = dataclasses.replace(TRAIN_4K, kind="prefill", seq_len=CACHE,
                                global_batch=B)
    dshape = dataclasses.replace(shape, kind="decode")
    rules = logical_rules(cfg, mesh, shape)
    dp_ax = rules["dp"]
    with mesh, use_rules(mesh, rules):
        psh = tree_shardings(mesh, params)
        bsh = batch_shardings(cfg, mesh, shape)
        dsh = batch_shardings(cfg, mesh, dshape)
        csh = cache_shardings(cfg, mesh, shape)

        def prefill_step(params, batch):
            logits, cache = prefill(params, cfg, batch, cache_len=CACHE)
            return logits[:, -1], cache

        def serve_step(params, cache, token, pos):
            logits, new_cache = decode_step(params, cfg, cache, token,
                                            pos)
            nxt = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
            return nxt[:, None], new_cache

        pre = jax.jit(prefill_step, in_shardings=(psh, bsh),
                      out_shardings=(NamedSharding(mesh, P(dp_ax,
                                                           "model")),
                                     csh))
        srv = jax.jit(serve_step,
                      in_shardings=(psh, csh, dsh["token"], dsh["pos"]),
                      out_shardings=(NamedSharding(mesh, P(dp_ax, None)),
                                     csh), donate_argnums=1)
        last, cache = pre(params, batch)
        rec = {"last": np.asarray(last), "cache": np_tree(cache),
               "tokens": [], "caches": []}
        tok = jnp.argmax(last, axis=-1).astype(jnp.int32)[:, None]
        for i in range(NEW):
            rec["tokens"].append(np.asarray(tok))
            tok, cache = srv(params, cache, tok,
                             jnp.asarray(PROMPT + i, jnp.int32))
            rec["caches"].append(np_tree(cache))
        rec["tokens"].append(np.asarray(tok))
        rec["rules"] = rules
    out[name][(dp, tp)] = rec
# a cache of REFUSED rows split over the 4 ranks of (1, 4)
cfg = smoke_config(get_config("qwen3-0.6b"))
mesh = make_mesh(1, 4)
shape = dataclasses.replace(TRAIN_4K, kind="prefill", seq_len=%(refused)r,
                            global_batch=%(b)r)
rules = logical_rules(cfg, mesh, shape)
with mesh, use_rules(mesh, rules):
    params = out["qwen3@(1,4)"]["params"]
    pre = jax.jit(lambda p, b: prefill(p, cfg, b, cache_len=%(refused)r)[1],
                  in_shardings=(tree_shardings(mesh, params),
                                batch_shardings(cfg, mesh, shape)),
                  out_shardings=cache_shardings(cfg, mesh, shape))
    try:
        pre(params, out["qwen3@(1,4)"]["batch"])
        out["refused"] = None
    except ValueError as err:
        out["refused"] = str(err)[:300]
pickle.dump(out, open(sys.argv[1], "wb"))
""" % dict(b=BATCH, prompt=PROMPT, new=NEW, cache=CACHE, cells=CELLS,
         refused=REFUSED)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's executed prefill and serve steps (one subprocess)."""
    path = tmp_path_factory.mktemp("ref") / "ref.pkl"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = str(ROOT / "src")
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(REFERENCE),
                          str(path)], capture_output=True, text=True,
                         timeout=400, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    with open(path, "rb") as f:
        return pickle.load(f)


def _diff(a: torch.Tensor, b: torch.Tensor, atol: float) -> float:
    """The largest |a - b| beyond rtol, as a share of ``atol`` (<= 1
    passes ``assert_allclose(atol=atol, rtol=RTOL)``)."""
    a, b = a.double(), b.double()
    return float(((a - b).abs() - RTOL * b.abs()).max()) / atol


def _world_serve(rank, world, ref):
    from repro_torch.convert import lm_cache_from_numpy, lm_params_from_numpy
    from repro_torch.launch import shardings as sh
    from repro_torch.launch.mesh import make_mesh, mesh_shape
    from repro_torch.models import (attention, decode_step, next_token,
                                    prefill, ssm)
    from repro_torch.models.sharding import use_rules
    from repro_torch import tree
    from repro_torch.configs import TRAIN_4K
    import dataclasses
    shapes = _Shapes()
    for module, name in ((attention, "mha"), (attention, "decode_attn"),
                         (ssm, "mlstm"), (ssm, "selective_scan")):
        shapes.wrap(module, name)
    out = {}
    torch.set_grad_enabled(False)
    for name, arch, kw, (dp, tp), b in CELLS:
        cfg = _smoke(arch, **kw)
        atol = SCAN_ATOL.get(arch, ATOL)
        params = lm_params_from_numpy(ref[name]["params"], cfg, "cpu")
        batch = {k: torch.from_numpy(np.asarray(v)).long()
                 if v.dtype.kind in "iu" else torch.from_numpy(v)
                 for k, v in ref[name]["batch"].items()}
        mesh = make_mesh(dp, tp, device_type="cpu")
        if mesh.get_coordinate() is None:
            continue
        rec = ref[name][(dp, tp)]
        shape = dataclasses.replace(TRAIN_4K, kind="prefill",
                                    seq_len=CACHE, global_batch=b)
        rules = sh.logical_rules(cfg, mesh, shape)
        specs = sh.cache_shardings(cfg, mesh, shape)["layers"]
        sizes = mesh_shape(mesh)
        sp = sh.shard_tree(params, mesh, sh.tree_shardings(mesh, params))
        shapes.seen.clear()
        res = {"cache": 0.0, "placed": True, "tokens": [], "close": []}

        def check_cache(cache, want, what):
            want = lm_cache_from_numpy(want, cfg, "cpu")
            for e, w, spec in zip(cache["layers"], want["layers"],
                                  specs):
                for k, t in e.items():
                    local = tuple(t.to_local().shape)
                    res["placed"] &= local == _expected_local(
                        tuple(t.shape), spec[k], sizes)
                    res["cache"] = max(res["cache"], _diff(
                        sh.full_tensor(t), w[k], atol))

        def check_tokens(logits, want):
            full = sh.full_tensor(logits)[:, -1].double()
            top2 = full.topk(2, dim=-1).values
            clear = (top2[:, 0] - top2[:, 1]) > MARGIN
            got = sh.full_tensor(next_token(logits))[:, 0]
            res["tokens"].append(bool(torch.equal(
                got[clear], torch.from_numpy(want[:, 0]).long()[clear])))
            res["close"].append(int(clear.sum()))

        with use_rules(mesh, rules):
            logits, cache = prefill(sp, cfg, batch, cache_len=CACHE)
            res["last"] = _diff(sh.full_tensor(logits)[:, -1],
                                torch.from_numpy(rec["last"]), atol)
            check_cache(cache, rec["cache"], "prefill")
            check_tokens(logits, rec["tokens"][0])
            for i in range(NEW):
                tok = torch.from_numpy(rec["tokens"][i]).long()
                logits, cache = decode_step(sp, cfg, cache, tok,
                                            PROMPT + i)
                check_cache(cache, rec["caches"][i], f"step {i}")
                check_tokens(logits, rec["tokens"][i + 1])
        res["shapes"] = {k: sorted(v) for k, v in shapes.seen.items()}
        res["rules"] = {k: rules[k] for k in ("tp_heads", "tp_kv",
                                              "kv_seq", "cache_seq")}
        res["ref_rules"] = {k: rec["rules"][k] for k in res["rules"]}
        out[(name, (dp, tp))] = res
    # the port refuses a cache that does not split, as the reference does
    cfg = _smoke("qwen3-0.6b")
    mesh = make_mesh(1, 4, device_type="cpu")
    params = lm_params_from_numpy(ref["qwen3@(1,4)"]["params"], cfg, "cpu")
    sp = sh.shard_tree(params, mesh, sh.tree_shardings(mesh, params))
    shape = dataclasses.replace(TRAIN_4K, kind="prefill", seq_len=REFUSED,
                                global_batch=BATCH)
    toks = torch.from_numpy(ref["qwen3@(1,4)"]["batch"]["tokens"]).long()
    try:
        with use_rules(mesh, sh.logical_rules(cfg, mesh, shape)):
            prefill(sp, cfg, {"tokens": toks}, cache_len=REFUSED)
        out["refused"] = None
    except ValueError as err:
        out["refused"] = str(err)
    return out


@pytest.fixture(scope="module")
def world(ref, tmp_path_factory):
    """The port's world of 4 ranks, its results by rank."""
    return run_world(_world_serve, 4, str(tmp_path_factory.mktemp("store")),
                     timeout=WORLD_TIMEOUT, args=(ref,))


@pytest.mark.parametrize("name", list(ARCHS) + list(SEQ_CELLS))
def test_sharded_prefill_and_decode_match_reference(world, name):
    """Each cell of the name (an arch on (2, 2) and (1, 2), or a
    sequence-sharded layout on its mesh): the sharded prefill's last
    logits and cache, then 4 decode steps' caches, against the
    reference's executed ``prefill_step`` / ``serve_step`` (atol as the
    module says, rtol 1e-3), under the reference's rules; every next token
    the reference's where the port's two best logits are more than 1e-3
    apart (most of them: a tie within rounding may go either way)."""
    cells = [(n, m, b) for n, _, _, m, b in CELLS if n == name]
    for rank, r in enumerate(world):
        for _, mesh, b in cells:
            got = r.get((name, mesh))
            if got is None:
                assert mesh == (1, 2) and rank >= 2
                continue
            assert got["rules"] == got["ref_rules"], got
            assert got["last"] <= 1.0, (mesh, got)
            assert got["cache"] <= 1.0, (mesh, got)
            assert all(got["tokens"]), (mesh, got)
            assert sum(got["close"]) >= -(-(NEW + 1) * b // 2), got
    if name in SEQ_CELLS:
        rules = world[0][(name, SEQ_CELLS[name][2])]["rules"]
        assert rules["cache_seq"] is not None, rules


@pytest.mark.parametrize("mesh", MESHES)
def test_cache_placements_and_local_heads(world, mesh):
    """Every cache leaf after prefill and each decode step holds the local
    shape ``cache_shardings`` gives it on the mesh, and at tp = 2 the
    wrappers see this rank's heads and channels: ``mha`` and
    ``decode_attn`` 2 of 4 q heads and 1 of 2 kv heads, ``mlstm`` 2 of 4
    heads, ``selective_scan`` 64 of 128 channels."""
    for r in world[:2]:
        for arch in ARCHS:
            got = r[(arch, mesh)]
            assert got["placed"], (arch, mesh)
            cfg = _smoke(arch)
            for name, seen in got["shapes"].items():
                for q, k, v in seen:
                    if name in ("mha", "decode_attn"):
                        assert (q[2], k[2], v[2]) == (2, 1, 1), (arch, seen)
                    elif name == "mlstm":
                        assert q[2] == cfg.n_heads // 2, (arch, seen)
                    else:
                        di = cfg.mamba_expand * cfg.d_model
                        assert q[-1] == v[-1] == k[0] == di // 2, seen
            assert got["shapes"], arch


@pytest.mark.parametrize("name", list(SEQ_CELLS))
def test_sequence_split_cache_placements_and_shapes(world, name):
    """The sequence-sharded layouts: every cache leaf after prefill and
    each decode step holds the local shape ``cache_shardings`` gives it
    (16 rows split over the ``cache_seq`` dims); ``decode_attn`` sees
    every q head where the cache holds every kv head (the one-token q
    gathered over ``"model"``) and this rank's rows; under ``kv_seq``
    ``mha`` sees every q head and at most ceil(S / 4) keys."""
    from repro_torch.models.attention import padded_heads
    arch, kw, mesh, _ = SEQ_CELLS[name]
    cfg = _smoke(arch, **kw)
    hp, kv = padded_heads(cfg), cfg.n_kv_heads
    for r in world:
        got = r[(name, mesh)]
        assert got["placed"], name
        rules = got["rules"]
        axes = rules["cache_seq"]
        n = 1
        for a in ((axes,) if isinstance(axes, str) else axes):
            n *= dict(zip(("data", "model"), mesh))[a]
        tp = mesh[1]
        q_heads = hp if rules["tp_heads"] is None or \
            rules["tp_kv"] is None else hp // tp
        kv_heads = kv if rules["tp_kv"] is None else kv // tp
        seen = got["shapes"]
        assert {(q[2], k[1], k[2]) for q, k, _ in seen["decode_attn"]
                if k[1] != cfg.enc_frames} == {(q_heads, CACHE // n,
                                                kv_heads)}, seen
        if rules["kv_seq"] is not None:
            assert {q[2] for q, _, _ in seen["mha"]} == {hp}, seen
            assert max(k[1] for _, k, _ in seen["mha"]) <= max(
                -(-PROMPT // tp), -(-cfg.enc_frames // tp)), seen


def test_cache_that_does_not_split_is_refused(ref, world):
    """A prefill into 14 cache rows split over 4 ranks: the reference's
    ``pjit`` refuses it with a ``ValueError``, and so does the port,
    saying why."""
    assert ref["refused"] is not None
    for r in world:
        assert r["refused"] is not None and "split" in r["refused"], r
