"""Calls of the LM kernels, each reported as one operation for a cost model.

A kernel's wrapper reports every call it makes at the point of launch,
with :func:`report`: the kernel's name, the tensors it reads and writes,
and the options that set its work.  On CUDA tensors the kernel then
launches; on ``meta`` tensors (the meta route: the outputs' shapes and
dtypes, nothing launched) the wrapper stops there.  A listener installed
with :func:`listening` sees the reports for the duration of a block
(``launch.op_cost`` logs each as one op, as a ``pallas_call`` is one custom
call in the reference's HLO); without a listener a report does nothing.

Each kernel module has a ``cost(reads, writes, opts)`` beside its wrapper:
the FLOPs its plain version computes at those shapes (the products
``torch.utils.flop_counter`` counts in it) and the bytes the kernel moves,
each input it reads once and each output written once.  ``reads`` and
``writes`` are ``(shape, bytes per element)`` pairs.
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Callable, List, Sequence, Tuple

import torch

Spec = Tuple[Tuple[int, ...], int]      # (shape, bytes per element)

_LISTENERS: List[Callable] = []


def report(name: str, reads: Sequence[torch.Tensor],
           writes: Sequence[torch.Tensor], **opts) -> None:
    """Tell every listener that kernel ``name`` reads ``reads`` and writes
    ``writes`` with ``opts``."""
    for fn in tuple(_LISTENERS):
        fn(name, tuple(reads), tuple(writes), opts)


@contextmanager
def listening(fn: Callable):
    """``fn(name, reads, writes, opts)`` called for every report in the
    block."""
    _LISTENERS.append(fn)
    try:
        yield fn
    finally:
        _LISTENERS.remove(fn)


def nbytes(spec: Spec) -> int:
    shape, size = spec
    return math.prod(shape) * size


def moved(reads: Sequence[Spec], writes: Sequence[Spec]) -> int:
    """Bytes of every input read once and every output written once."""
    return sum(nbytes(s) for s in reads) + sum(nbytes(s) for s in writes)
