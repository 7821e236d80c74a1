"""A request's output list that stamps each token's arrival on the host."""
from __future__ import annotations

import time


class StampList(list):
    """A list whose ``append``, ``extend`` and item assignment record
    ``time.perf_counter()`` once per token, in ``stamps``.  With ``mark``
    set, each token also leaves a ``bench.token`` instant in a running
    profiler's trace."""

    mark = False

    def __init__(self, *a):
        super().__init__(*a)
        self.stamps = []

    def _stamp(self, n: int = 1) -> None:
        now = time.perf_counter()
        self.stamps.extend([now] * n)
        if self.mark:
            from torch.profiler import record_function
            with record_function("bench.token"):
                pass

    def append(self, x):
        super().append(x)
        self._stamp()

    def extend(self, xs):
        xs = list(xs)
        super().extend(xs)
        self._stamp(len(xs))

    def __setitem__(self, i, x):
        super().__setitem__(i, x)
        self._stamp()
