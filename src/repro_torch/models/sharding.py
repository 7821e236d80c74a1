"""Logical-axis sharding constraints.

Counterpart of ``repro.models.sharding``.  Model code names the dims of an
activation with *logical* axis names; the launcher maps them to mesh dims
with :func:`set_rules`.  Outside a mesh (unit tests, one-device runs) a
constraint is a no-op.

Logical axes used by the model code:
  dp         batch dim (data parallel; ('pod', 'data') on the multi-pod mesh)
  tp_heads   query-head dim           tp_kv     kv-head dim
  tp_ff      ffn hidden / d_inner / flattened head-hidden
  ep         expert dim               cache_seq KV-cache sequence dim
  vocab      vocabulary dim           seq       activation sequence dim (SP)

:func:`constrain` on a ``DTensor`` inside a mesh redistributes it to the
rule's placements.  A plain tensor inside a mesh is this rank's shard of
the activation (the sharded model runs on local shards, ROADMAP.md item
13c): :func:`constrain` asserts that its shape is the local shape the
rule gives, each dim whose global size the caller names (``full``)
divided by the mesh dims the rule maps it to (where they divide it, as
``launch.shardings._guard`` keeps a parameter's), so that a wrong layout
fails where the reference places the activation.  A sequence dim
(``kv_seq``, ``cache_seq``, ``sp``; :data:`SEQ_AXES`) splits as
``torch.chunk`` splits it, unevenly where it must (812 keys over 3 ranks
are 271, 271, 270), over one or two mesh dims major to minor:
:func:`seq_split` gives this rank's chunk and the groups that hold the
others.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch

Axis = Union[None, str, Tuple[str, ...]]
SEQ_AXES = ("kv_seq", "cache_seq", "sp")

_state = threading.local()


def set_rules(mesh, rules: Optional[Dict[str, Axis]]) -> None:
    _state.mesh = mesh
    _state.rules = rules


def get_rules() -> Tuple[object, Optional[Dict[str, Axis]]]:
    return getattr(_state, "mesh", None), getattr(_state, "rules", None)


@contextmanager
def use_rules(mesh, rules: Optional[Dict[str, Axis]]):
    prev = get_rules()
    set_rules(mesh, rules)
    try:
        yield
    finally:
        set_rules(*prev)


def logical_spec(*names: Optional[str]):
    """The ``PartitionSpec`` of ``names`` under the active rules, or None
    outside a mesh."""
    from repro_torch.launch.shardings import PartitionSpec
    mesh, rules = get_rules()
    if mesh is None or rules is None:
        return None
    return PartitionSpec(*[rules.get(n) if n else None for n in names])


def _axis_names(axis: Axis) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis or ())


def chunk_bounds(size: int, n: int, index: int) -> Tuple[int, int]:
    """[start, stop) of chunk ``index`` when ``torch.chunk`` cuts ``size``
    rows into ``n``: ceil(size / n) rows a chunk, the last ones shorter or
    empty."""
    step = -(-size // n)
    start = min(index * step, size)
    return start, min(start + step, size)


def local_size(size: int, axis: Axis, sizes: Dict[str, int],
               index: Optional[int] = None) -> int:
    """A dim of global ``size`` under the mesh dims ``axis``: divided by
    their product where it divides evenly, else whole; with ``index`` (a
    sequence dim), chunk ``index`` of ``torch.chunk``'s cut."""
    n = 1
    for a in _axis_names(axis):
        n *= sizes.get(a, 1)
    if index is not None:
        lo, hi = chunk_bounds(size, n, index)
        return hi - lo
    return size // n if size % n == 0 and size >= n else size


class SeqSplit(NamedTuple):
    """A sequence dim split over the mesh dims of a logical axis: ``n``
    chunks (``torch.chunk``'s), this rank's ``index`` among them (the mesh
    dims major to minor) and the process groups of those dims of more than
    one rank (a merge over the chunks runs over each)."""
    n: int
    index: int
    groups: Tuple

    def bounds(self, size: int) -> Tuple[int, int]:
        """This rank's rows [start, stop) of a dim of ``size``."""
        return chunk_bounds(size, self.n, self.index)


def _chunk_index(mesh, names: Tuple[str, ...]) -> Tuple[int, int]:
    n, idx = 1, 0
    for a in names:
        k = mesh.mesh_dim_names.index(a)
        idx = idx * mesh.size(k) + mesh.get_local_rank(a)
        n *= mesh.size(k)
    return n, idx


def seq_split(name: str) -> Optional[SeqSplit]:
    """The :class:`SeqSplit` of the sequence axis ``name`` under the active
    rules, or None outside a mesh or where it is not split."""
    mesh, rules = get_rules()
    if mesh is None or rules is None:
        return None
    names = tuple(a for a in _axis_names(rules.get(name))
                  if a in mesh.mesh_dim_names)
    n, idx = _chunk_index(mesh, names)
    if n == 1:
        return None
    groups = tuple(mesh.get_group(a) for a in names
                   if mesh.size(mesh.mesh_dim_names.index(a)) > 1)
    return SeqSplit(n, idx, groups)


def constrain(x: torch.Tensor, *names: Optional[str],
              full: Optional[Tuple[Optional[int], ...]] = None
              ) -> torch.Tensor:
    """``x`` under the active logical rules: a ``DTensor`` redistributed to
    the rule's placements; a plain tensor returned as it is, after an
    assertion that each dim with a global size in ``full`` (None: not
    known here, as the batch) has the local size the rule gives.  Outside
    a mesh, ``x`` as it is."""
    mesh, rules = get_rules()
    if mesh is None or rules is None:
        return x
    assert x.dim() == len(names), (tuple(x.shape), names)
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        if full is not None:
            from repro_torch.launch.mesh import mesh_shape
            sizes = mesh_shape(mesh)

            def index(n):
                if n not in SEQ_AXES:
                    return None
                axes = tuple(a for a in _axis_names(rules.get(n))
                             if a in mesh.mesh_dim_names)
                return _chunk_index(mesh, axes)[1]
            want = tuple(None if f is None else
                         local_size(f, rules.get(n) if n else None, sizes,
                                    index(n))
                         for n, f in zip(names, full))
            got = tuple(x.shape)
            assert all(w is None or w == g for w, g in zip(want, got)), (
                f"activation {got} is not the local shard {want} of "
                f"{tuple(full)} under the rules {names} on {sizes}")
        return x
    from repro_torch.launch.shardings import placements
    return x.redistribute(x.device_mesh,
                          placements(x.device_mesh, logical_spec(*names)))


# --------------------------------------------------------- the batch's rows
def batch_axes(mesh) -> Tuple[str, ...]:
    """The mesh dims that shard the batch under the active rules (their
    ``"dp"``); none without rules."""
    _, rules = get_rules()
    dp = (rules or {}).get("dp")
    names = (dp,) if isinstance(dp, str) else tuple(dp or ())
    return tuple(a for a in names if a in mesh.mesh_dim_names)


def local_rows(batch: Dict, mesh, axes: Tuple[str, ...]) -> Dict:
    """This rank's rows of every batch leaf: the batch split evenly over
    the mesh dims ``axes``, major to minor (all rows when ``axes`` is
    empty).  Raises when the rows do not split evenly."""
    n, idx = _chunk_index(mesh, axes)
    if n == 1:
        return batch
    out = {}
    for k, v in batch.items():
        if v.dim() == 0:
            out[k] = v
            continue
        if v.shape[0] % n:
            raise ValueError(f"batch {k!r} has {v.shape[0]} rows, which do "
                             f"not split over {n} ranks of {axes}")
        rows = v.shape[0] // n
        out[k] = v[idx * rows:(idx + 1) * rows]
    return out
