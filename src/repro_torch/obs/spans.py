"""Spans and counters of the port's LM paths, on the profiler's clock.

A span records only while a torch profiler is recording (and the obs gate
is on, which ``repro_torch.obs.span`` checks); otherwise the caller gets
the shared no-op context :data:`OFF` and nothing is recorded, launched or
synchronised.  A recording span:

* runs its body inside ``torch._C._profiler._RecordFunctionFast(name)``,
  so the trace shows it as a host op (``cpu_op``) on the same clock as the
  device's operations; a user annotation (``record_function``) would also
  be copied onto the device's timeline and read as device work;
* keeps ``seq``, its ``parent``'s seq (a stack per thread), ``name``,
  ``attrs``, host ``start_ns`` and ``end_ns`` from ``time.time_ns()``
  (the profiler's host clock) and ``device_s``: the time between two
  timing events recorded on the current CUDA stream at its start and end
  once CUDA is initialised in the process (and the stream is not being
  captured into a graph), else the host duration, since CPU work is
  synchronous;
* takes counters (:meth:`SpanRecorder.count`), which may be device
  scalars.

Events and device counters are resolved when the records are read, with
one synchronize there, never on the path that made them.  Records sit in a
bounded ring that counts what it dropped.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Dict, List

import torch
from torch._C._profiler import _RecordFunctionFast


class _Off:
    """The shared context of a span that does not record."""
    __slots__ = ()

    def __enter__(self):
        pass

    def __exit__(self, *exc):
        return False


OFF = _Off()


class _Span:
    __slots__ = ("spans", "name", "attrs", "rec", "fast", "events")

    def __init__(self, spans: "SpanRecorder", name: str, attrs: Dict):
        self.spans, self.name, self.attrs = spans, name, attrs

    def __enter__(self):
        stack = self.spans._stack()
        self.fast = _RecordFunctionFast(self.name)
        self.fast.__enter__()
        self.events = self.spans._event_pair()
        if self.events is not None:
            self.events[0].record()
        self.rec = {"seq": next(self.spans._seq),
                    "parent": stack[-1]["seq"] if stack else None,
                    "name": self.name, "attrs": self.attrs,
                    "start_ns": time.time_ns()}
        stack.append(self.rec)

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record()
            self.rec["_events"] = self.events
        self.rec["end_ns"] = time.time_ns()
        self.fast.__exit__(*exc)
        self.spans._close(self.rec)
        return False


class SpanRecorder:
    """The ring of span records and the per-thread stacks of open spans."""

    def __init__(self, capacity: int = 65536):
        self.capacity = int(capacity)
        self._ring: deque = deque(maxlen=self.capacity)
        self.dropped = 0
        self._seq = itertools.count()
        self._local = threading.local()
        self._lock = threading.Lock()
        self._free: List = []          # timing events already read

    def _stack(self) -> List[Dict]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _event_pair(self):
        if not torch.cuda.is_initialized() or \
                torch.cuda.is_current_stream_capturing():
            return None
        with self._lock:
            pair = [self._free.pop() if self._free else None
                    for _ in range(2)]
        return tuple(e or torch.cuda.Event(enable_timing=True)
                     for e in pair)

    def span(self, name: str, attrs: Dict) -> _Span:
        return _Span(self, name, attrs)

    def _close(self, rec: Dict) -> None:
        self._stack().pop()
        with self._lock:
            if len(self._ring) == self.capacity:
                self.dropped += 1
            self._ring.append(rec)

    def count(self, **values) -> None:
        """Add ``values`` (numbers or device scalars) to the counters of
        the innermost open span of this thread; nothing without one."""
        stack = self._stack()
        if not stack:
            return
        parts = stack[-1].setdefault("_parts", {})
        for key, value in values.items():
            parts.setdefault(key, []).append(value)

    def records(self) -> List[Dict]:
        """The closed spans, oldest first, as plain dicts with their device
        seconds and counters resolved."""
        with self._lock:
            recs = list(self._ring)
        if any("_events" in r or "_parts" in r for r in recs) and \
                torch.cuda.is_initialized():
            torch.cuda.synchronize()
        freed: List = []
        for r in recs:
            _resolve(r, freed)
        with self._lock:
            self._free.extend(freed)
        return [dict(r, attrs=dict(r["attrs"])) for r in recs]

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self.dropped = 0


def _resolve(rec: Dict, free: List) -> None:
    events = rec.pop("_events", None)
    if events is not None:
        rec["device_s"] = events[0].elapsed_time(events[1]) * 1e-3
        free.extend(events)
    elif "device_s" not in rec:
        rec["device_s"] = (rec["end_ns"] - rec["start_ns"]) * 1e-9
    for key, parts in rec.pop("_parts", {}).items():
        rec["attrs"][key] = rec["attrs"].get(key, 0) + sum(
            p.item() if isinstance(p, torch.Tensor) else p for p in parts)
