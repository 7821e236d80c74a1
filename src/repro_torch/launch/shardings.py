"""Sharding rules: parameter path -> PartitionSpec, logical activation rules,
and the DTensor placements they give.

Counterpart of ``repro.launch.shardings``.  Scheme: DP over ('pod',
'data'); FSDP over 'data'; TP/EP over 'model'.  Divisibility is checked
per dim: a mesh axis that does not divide the dim is dropped (e.g.
head-replicated attention for arctic/gemma2/qwen2.5).

A spec is a :class:`PartitionSpec`, one entry per tensor dim: None, a mesh
dim name, or a tuple of names (major to minor), as ``jax.sharding.
PartitionSpec``.  The port's parameter tree is a flat list of layers where
the reference stacks a group's layers on a leading dim, so a leaf's spec
here is the reference's with that leading None dropped.  The rules take a
``DeviceMesh`` or a ``launch.mesh.AbstractMesh``.  :func:`placements`
turns a spec into one placement per mesh dim (``Shard(d)`` on each mesh dim
named at tensor dim ``d``, ``Replicate()`` on the others);
:func:`shard_tree`, :func:`gather_tree` and :func:`full_tensor` move a
state between plain tensors and ``DTensor`` objects on a real mesh.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch import tree
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch.mesh import (Mesh, axis_names, dp_axes, dp_size,
                                     mesh_shape)
from repro_torch.models.attention import padded_heads

Axis = Optional[object]


class PartitionSpec:
    """One mesh-axis entry per tensor dim: None, a name or a tuple of
    names; a tuple of one name is that name and an empty one None, as in
    ``jax.sharding.PartitionSpec``.  A tree leaf (``repro_torch.tree``
    walks into tuples, not into this)."""

    __slots__ = ("axes",)

    def __init__(self, *axes: Axis):
        def norm(a):
            if isinstance(a, (list, tuple)):
                a = tuple(a)
                return None if not a else a[0] if len(a) == 1 else a
            return a
        self.axes = tuple(norm(a) for a in axes)

    def __iter__(self):
        return iter(self.axes)

    def __len__(self) -> int:
        return len(self.axes)

    def __getitem__(self, i):
        return self.axes[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, PartitionSpec) and self.axes == other.axes

    def __hash__(self) -> int:
        return hash(self.axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{self.axes!r}"


P = PartitionSpec


def _names(axis: Axis) -> Tuple[str, ...]:
    if axis is None:
        return ()
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _fits(mesh: Mesh, axis: Axis, dim: int) -> bool:
    if axis is None:
        return True
    shape = mesh_shape(mesh)
    n = 1
    for a in _names(axis):
        n *= shape[a]
    return dim % n == 0 and dim >= n


def _guard(mesh: Mesh, spec: Tuple[Axis, ...], shape) -> PartitionSpec:
    return P(*[a if _fits(mesh, a, d) else None for a, d in zip(spec, shape)])


# ------------------------------------------------------------- param rules
# (parent, name) -> spec of the leaf (a layer's, not a stack of them)
_IN = ("data", "model")     # (d_in, parallel_out)
_OUT = ("model", "data")    # (parallel_in, d_out)
_RULES: Dict[Tuple[str, str], Tuple[Axis, ...]] = {
    ("", "embed"): ("model", "data"),      # vocab x d, FSDP'd on d
    ("", "unembed"): ("model", "data"),
    ("attn", "wq"): _IN, ("attn", "wk"): _IN, ("attn", "wv"): _IN,
    ("attn", "wo"): _OUT,
    ("attn", "bq"): (None,), ("attn", "bk"): (None,), ("attn", "bv"): (None,),
    ("attn", "q_norm"): (None,), ("attn", "k_norm"): (None,),
    ("cross", "wq"): _IN, ("cross", "wk"): _IN, ("cross", "wv"): _IN,
    ("cross", "wo"): _OUT,
    ("cross", "q_norm"): (None,), ("cross", "k_norm"): (None,),
    ("ffn", "w_gate"): _IN, ("ffn", "w_up"): _IN, ("ffn", "w_down"): _OUT,
    ("moe", "router"): ("data", None),
    ("moe", "w_gate"): ("model", "data", None),
    ("moe", "w_up"): ("model", "data", None),
    ("moe", "w_down"): ("model", None, "data"),
    ("mamba", "in_proj"): _IN, ("mamba", "out_proj"): _OUT,
    ("mamba", "conv_w"): (None, "model"), ("mamba", "conv_b"): ("model",),
    ("mamba", "x_proj"): ("model", None),
    ("mamba", "dt_proj"): (None, "model"),
    ("mamba", "dt_bias"): ("model",), ("mamba", "A_log"): ("model", None),
    ("mamba", "D"): ("model",),
    ("mixer", "wq"): _IN, ("mixer", "wk"): _IN, ("mixer", "wv"): _IN,
    ("mixer", "w_gate"): _IN, ("mixer", "w_out"): _OUT,
    ("mixer", "w_i"): ("data", None), ("mixer", "w_f"): ("data", None),
    ("mixer", "b_i"): (None,), ("mixer", "b_f"): (None,),
    ("mixer", "w"): ("data", None), ("mixer", "r"): (None, None, None, None),
    ("mixer", "b"): (None,),
}
_PARENTS = ("attn", "cross", "ffn", "moe", "mamba", "mixer")


def _path_str(path: str) -> Tuple[str, str]:
    """("parent", "name") of a "/"-joined leaf path: the nearest enclosing
    sub-module key, or "" at the top."""
    keys = path.split("/")
    parent = next((k for k in reversed(keys[:-1]) if k in _PARENTS), "")
    return parent, keys[-1]


def param_spec(mesh: Mesh, path: str, leaf) -> PartitionSpec:
    """The spec of the parameter at ``path`` (an optimizer moment's path,
    "mu/..." or "nu/...", gives its parameter's); a leaf without a rule is
    replicated."""
    shape = tuple(leaf.shape)
    base = _RULES.get(_path_str(path), (None,) * len(shape))
    assert len(base) == len(shape), (path, shape, base)
    return _guard(mesh, base, shape)


def tree_shardings(mesh: Mesh, params):
    """A spec for every leaf of a parameter-shaped tree."""
    return tree.map_with_paths(
        lambda path, leaf: P() if len(leaf.shape) == 0
        else param_spec(mesh, path, leaf), params)


# ---------------------------------------------------------- logical rules
def logical_rules(cfg: ModelConfig, mesh: Mesh, shape: ShapeConfig) -> Dict:
    sizes = mesh_shape(mesh)
    tp = sizes["model"]
    b = shape.global_batch
    dpx = dp_axes(mesh)
    dp: Axis = dpx if (b % dp_size(mesh) == 0) else (
        ("data",) if b % sizes["data"] == 0 else None)
    kv_ok = cfg.n_kv_heads % tp == 0
    heads_ok = padded_heads(cfg) % tp == 0
    if b == 1:
        cache_seq: Axis = ("data", "model") if not kv_ok else ("data",)
    else:
        cache_seq = "model" if not kv_ok else None
    sp = "model" if (cfg.seq_parallel_residual and shape.kind == "train"
                     and shape.seq_len % tp == 0) else None
    return {
        "dp": dp,
        "tp_heads": "model" if heads_ok else None,
        "tp_kv": "model" if kv_ok else None,
        # sequence-parallel attention when heads aren't TP-shardable
        "kv_seq": None if heads_ok else "model",
        "tp_ff": "model",
        "ep": "model" if (cfg.n_experts and cfg.n_experts % tp == 0) else None,
        "cache_seq": cache_seq,
        "sp": sp,
        "vocab": "model",
    }


# ---------------------------------------------------------- batch / cache
def batch_shardings(cfg: ModelConfig, mesh: Mesh, shape: ShapeConfig):
    dp = logical_rules(cfg, mesh, shape)["dp"]
    if shape.kind in ("train", "prefill"):
        out = {"tokens": P(dp, None)}
        if shape.kind == "train":
            out["targets"] = P(dp, None)
        if cfg.family == "audio":
            out["frames"] = P(dp, None, None)
        if cfg.family == "vlm":
            out["patches"] = P(dp, None, None)
        return out
    return {"token": P(dp, None), "pos": P()}


def cache_shardings(cfg: ModelConfig, mesh: Mesh, shape: ShapeConfig):
    """Structure mirrors ``models.transformer.init_cache``: one entry per
    layer."""
    return cache_specs_of(cfg, logical_rules(cfg, mesh, shape))


def cache_specs_of(cfg: ModelConfig, rules: Dict):
    """:func:`cache_shardings` from the logical ``rules`` themselves (the
    sharded prefill places its cache with the rules it runs under).  A
    cache's sequence dim splits over ``cache_seq``'s mesh dims, major to
    minor, in equal parts: a length that does not divide raises
    (``models.transformer.check_cache_split``), as the reference's
    ``pjit`` refuses it."""
    dp, cseq, kv = rules["dp"], rules["cache_seq"], rules["tp_kv"]
    tpff = rules["tp_ff"]

    def entry(kind: str):
        if kind in ("attn", "attn_local"):
            e = {"k": P(dp, cseq, kv, None), "v": P(dp, cseq, kv, None)}
            if cfg.family == "audio":
                e["ck"] = P(dp, None, kv, None)
                e["cv"] = P(dp, None, kv, None)
            return e
        if kind == "mamba":
            return {"h": P(dp, tpff, None), "conv": P(dp, None, tpff)}
        if kind == "mlstm":
            return {"C": P(dp, None, None, tpff), "n": P(dp, None, None),
                    "m": P(dp, None)}
        if kind == "slstm":
            return {k: P(dp, None, None) for k in ("h", "c", "n", "m")}
        raise ValueError(kind)

    return {"layers": [entry(cfg.layer_kind(i)) for i in range(cfg.n_layers)]}


def state_shardings(cfg: ModelConfig, mesh: Mesh, state):
    """Specs for ``{"params", "opt": {"mu", "nu", "step"}}`` (tensors of
    any device, ``meta`` included)."""
    return {"params": tree_shardings(mesh, state["params"]),
            "opt": {"mu": tree_shardings(mesh, state["opt"]["mu"]),
                    "nu": tree_shardings(mesh, state["opt"]["nu"]),
                    "step": P()}}


def scalar_shardings(mesh: Mesh, t):
    return tree.tree_map(lambda _: P(), t)


# ------------------------------------------------------------ placements
def placements(mesh, spec: Optional[PartitionSpec]) -> Tuple:
    """One DTensor placement per mesh dim for ``spec``: ``Shard(d)`` where
    tensor dim ``d`` names the mesh dim, else ``Replicate()``.  A tensor
    dim under several mesh dims splits them major to minor (JAX's order),
    which is the mesh's own order; another order raises."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    out = [Replicate() for _ in names]
    for d, axis in enumerate(spec or ()):
        axes = _names(axis)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec} splits dim {d} over {axes}, not "
                             f"in the mesh's order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def shard_tree(t, mesh, specs):
    """Every tensor of ``t`` as a ``DTensor`` on ``mesh`` placed by its spec
    in ``specs`` (a tree of :class:`PartitionSpec` like ``t``).  Each rank
    keeps its own slice of the full tensor it holds (``distribute_tensor``
    with ``src_data_rank=None``: nothing is sent), so every rank of the mesh
    must hold the same values; a ``DTensor`` is gathered first."""
    from torch.distributed.tensor import distribute_tensor
    flat = dict(tree.leaves_with_paths(specs))

    def one(path, x):
        return distribute_tensor(full_tensor(x), mesh,
                                 placements(mesh, flat[path]),
                                 src_data_rank=None)
    return tree.map_with_paths(one, t)


def from_host(x: torch.Tensor, mesh, spec: Optional[PartitionSpec],
              device) -> "torch.distributed.tensor.DTensor":
    """A ``DTensor`` on ``mesh`` placed by ``spec`` from ``x``, the full
    tensor on the host: this rank cuts its slice on the host (mesh dims
    major to minor, as :func:`placements` lays them out) and moves only
    that to ``device``.  Nothing is sent.  Every rank calling it must be
    in the mesh, and each sharded dim must split evenly (the rules'
    ``_guard`` makes it so)."""
    from torch.distributed.tensor import DTensor
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh it places a tensor "
                         "on")
    pl = placements(mesh, spec)
    local = x
    for i, p in enumerate(pl):
        if p.is_shard():
            n = mesh.size(i)
            if local.shape[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(x.shape)} does not "
                                 f"split over {n} ranks")
            local = local.chunk(n, dim=p.dim)[coord[i]]
    return DTensor.from_local(local.contiguous().to(device), mesh, pl,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def gather_tree(t):
    """Every ``DTensor`` of ``t`` as its full tensor (a collective over its
    mesh); plain tensors as they are."""
    return tree.tree_map(lambda x: full_tensor(x).detach(), t)


# ----------------------------------------------------- gather and scatter
# The whole tensor of a DTensor, gathered with c10d collectives
# (``all_gather_into_tensor``; the gradient by ``reduce_scatter_tensor`` /
# ``all_reduce``) rather than ``DTensor.full_tensor``: those run on every
# backend the port uses, and DTensor's functional all-gather does not run
# over gloo on CUDA tensors (ROADMAP.md queue 3).
def full_tensor(x, partial: Sequence[str] = (),
                over: Optional[Sequence[str]] = None):
    """The full tensor of ``x`` (a ``DTensor``; a plain tensor is returned
    as it is) along the mesh dims ``over`` (default: all of them), as a
    plain tensor, differentiable; along the other mesh dims it stays this
    rank's shard (``full_tensor(x, over=("data",))`` gathers an FSDP shard
    and keeps the ``"model"`` shard local).  ``partial`` names the mesh
    dims over which ranks computed different parts of the gradient of the
    result (the dims that shard the batch): the gradient is summed over
    those (a reduce-scatter where ``x`` is sharded, an all-reduce where it
    is replicated) and taken as it is over the others, whose ranks
    computed the same one.  The gradient comes back with ``x``'s
    placements."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    names = axis_names(mesh)
    idx = range(len(names)) if over is None else \
        [names.index(a) for a in over if a in names]
    return _Gather.apply(x.to_local(), mesh, tuple(x.placements),
                         tuple(sorted(names.index(a) for a in partial)),
                         frozenset(idx))


def as_dtensor(local: torch.Tensor, mesh, spec: Optional[PartitionSpec]
               ) -> "torch.distributed.tensor.DTensor":
    """``local``, this rank's shard of a tensor placed by ``spec`` on
    ``mesh``, as a ``DTensor`` (its global shape the local one times the
    mesh dims that shard each dim; nothing is sent)."""
    from torch.distributed.tensor import DTensor
    pl = placements(mesh, spec)
    shape = list(local.shape)
    for i, p in enumerate(pl):
        if p.is_shard():
            shape[p.dim] *= mesh.size(i)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def _dim_group(mesh, i: int):
    return mesh.get_group(i), mesh.size(i)


def _gather(local: torch.Tensor, mesh, pl, over) -> torch.Tensor:
    import torch.distributed as dist
    x = local
    for i in reversed(range(mesh.ndim)):          # minor mesh dim first
        group, n = _dim_group(mesh, i)
        if i not in over or not pl[i].is_shard() or n == 1:
            continue
        d = pl[i].dim
        xt = x.movedim(d, 0).contiguous()
        out = xt.new_empty((n * xt.shape[0],) + tuple(xt.shape[1:]))
        dist.all_gather_into_tensor(out, xt, group=group)
        x = out.movedim(0, d)
    return x.contiguous()


def _scatter(g: torch.Tensor, mesh, pl, partial, over) -> torch.Tensor:
    import torch.distributed as dist
    x = g
    for i in range(mesh.ndim):                    # major mesh dim first
        group, n = _dim_group(mesh, i)
        if n == 1:
            continue
        if pl[i].is_shard() and i in over:
            d = pl[i].dim
            if i in partial:
                xt = x.movedim(d, 0).contiguous()
                out = xt.new_empty((xt.shape[0] // n,) + tuple(xt.shape[1:]))
                dist.reduce_scatter_tensor(out, xt, group=group)
                x = out.movedim(0, d)
            else:
                x = x.chunk(n, d)[mesh.get_local_rank(i)]
        elif i in partial:
            # a shard kept local is this rank's alone: its gradient sums
            # over the batch's ranks only where they hold the same shard
            assert not pl[i].is_shard(), (i, pl)
            x = x.clone(memory_format=torch.contiguous_format)
            dist.all_reduce(x, group=group)
    return x.contiguous()


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, mesh, pl, partial, over):
        ctx.mesh, ctx.pl, ctx.partial, ctx.over = mesh, pl, partial, over
        return _gather(local, mesh, pl, over)

    @staticmethod
    def backward(ctx, g):
        return (_scatter(g, ctx.mesh, ctx.pl, ctx.partial, ctx.over), None,
                None, None, None)
