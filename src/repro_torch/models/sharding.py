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
rule's placements.  On a plain tensor it returns the tensor: the model runs
on whole activations, and lowering the activation constraints to
redistributions of local head shards is ROADMAP.md queue 1 item 13c.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict, Optional, Tuple, Union

import torch

Axis = Union[None, str, Tuple[str, ...]]

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


def constrain(x: torch.Tensor, *names: Optional[str]) -> torch.Tensor:
    """``x`` under the active logical rules: a ``DTensor`` redistributed to
    the rule's placements; a plain tensor, or any tensor outside a mesh,
    as it is."""
    mesh, rules = get_rules()
    if mesh is None or rules is None:
        return x
    assert x.dim() == len(names), (tuple(x.shape), names)
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    from repro_torch.launch.shardings import placements
    return x.redistribute(x.device_mesh,
                          placements(x.device_mesh, logical_spec(*names)))
