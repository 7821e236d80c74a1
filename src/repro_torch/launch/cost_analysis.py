"""Collective kinds and the roofline terms of a traced step, on an H100.

Counterpart of ``repro.launch.hlo_analysis``, which sums the operand bytes
of each collective of the partitioned HLO text by kind.  The port's step
has no HLO: ``launch.op_cost`` logs its ops, and this module says which of
them are collectives and of which of the reference's five kinds.  Both
forms a torch step emits are mapped, the process-group calls of
``torch.distributed`` (the ``c10d`` ops: the port's own gathers, sums and
Megatron pair) and the functional collectives (``_c10d_functional``:
``DTensor``'s redistributions), under the names torch 2.11 and 2.13 give
them.  A collective's operand bytes are those of its input on this rank,
as the reference counts an HLO collective's operands
(``hlo_analysis.py:41-76``).

The roofline's constants are one H100 SXM5's.  Every 16-wide axis of the
production mesh ((16, 16) or (2, 16, 16), ``launch.mesh``) spans more than
one 8-GPU node, so its collectives leave the node, where each GPU has one
400 Gb/s InfiniBand NDR port: that link, not NVLink, sets
``t_collective``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# op packet -> (kind, the argument that holds its operand)
COLLECTIVE_OPS: Dict[str, Tuple[str, int]] = {
    # torch.distributed's process-group calls
    "c10d.allreduce_": ("all-reduce", 0),
    "c10d.allreduce_coalesced_": ("all-reduce", 0),
    "c10d._allgather_base_": ("all-gather", 1),
    "c10d.allgather_": ("all-gather", 1),
    "c10d.allgather_coalesced_": ("all-gather", 1),
    "c10d.allgather_into_tensor_coalesced_": ("all-gather", 1),
    "c10d._reduce_scatter_base_": ("reduce-scatter", 1),
    "c10d.reduce_scatter_": ("reduce-scatter", 1),
    "c10d.reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
    "c10d.alltoall_base_": ("all-to-all", 1),
    "c10d.alltoall_": ("all-to-all", 1),
    # functional collectives (DTensor's redistributions)
    "_c10d_functional.all_reduce": ("all-reduce", 0),
    "_c10d_functional.all_reduce_": ("all-reduce", 0),
    "_c10d_functional.all_reduce_coalesced": ("all-reduce", 0),
    "_c10d_functional.all_reduce_coalesced_": ("all-reduce", 0),
    "_c10d_functional.all_gather_into_tensor": ("all-gather", 0),
    "_c10d_functional.all_gather_into_tensor_out": ("all-gather", 0),
    "_c10d_functional.all_gather_into_tensor_coalesced": ("all-gather", 0),
    "_c10d_functional.reduce_scatter_tensor": ("reduce-scatter", 0),
    "_c10d_functional.reduce_scatter_tensor_coalesced": ("reduce-scatter",
                                                         0),
    "_c10d_functional.all_to_all_single": ("all-to-all", 0),
    "_dtensor.shard_dim_alltoall": ("all-to-all", 0),
}
# ops of those namespaces that move nothing: waits and autograd wrappers
BOOKKEEPING = frozenset({"_c10d_functional.wait_tensor",
                         "_c10d_functional._wrap_tensor_autograd"})
NAMESPACES = ("c10d.", "_c10d_functional.", "_dtensor.")


def collective_kind(packet: str) -> Optional[Tuple[str, int]]:
    """(kind, operand argument) of a collective op, None for any other op;
    raises ``KeyError`` for an op of a collective namespace that is not
    mapped, so that a torch that names its collectives otherwise fails
    loudly rather than counting nothing."""
    if packet in COLLECTIVE_OPS:
        return COLLECTIVE_OPS[packet]
    if packet in BOOKKEEPING or not packet.startswith(NAMESPACES):
        return None
    raise KeyError(f"collective op {packet!r} has no kind in "
                   f"launch/cost_analysis.py")


def total_collective_bytes(stats: Dict[str, Dict[str, float]]) -> float:
    return sum(v["operand_bytes"] for v in stats.values())


# ------------------------------------------------------------------ roofline
PEAK_FLOPS = 989e12    # bf16 dense tensor-core FLOP/s, H100 SXM5 data sheet
HBM_BW = 3.35e12       # HBM3 bytes/s, H100 SXM5 data sheet
LINK_BW = 50e9         # bytes/s: a DGX H100's one 400 Gb/s NDR port per GPU


def roofline_terms(flops_per_device: float, bytes_per_device: float,
                   coll_bytes_per_device: float) -> Dict[str, float]:
    """Three per-step time terms in seconds (one rank's view)."""
    return {
        "t_compute": flops_per_device / PEAK_FLOPS,
        "t_memory": bytes_per_device / HBM_BW,
        "t_collective": coll_bytes_per_device / LINK_BW,
    }


def dominant_term(terms: Dict[str, float]) -> str:
    return max(("t_compute", "t_memory", "t_collective"),
               key=lambda k: terms[k])
