"""Controller-wide observability: unified metrics registry + flight
recorder, gated by ``ENEL_OBS`` (default on; ``ENEL_OBS=0`` disables).

Contract: with observability disabled, decisions are bit-exact vs the
instrumented controller and the count of distinct dispatch signatures
(``core.model.TRACE_COUNTS``) is unchanged — span emission and histogram
observation no-op.  Registry-backed *counters* stay live either way: they
are host-side and feed no decision, and the attribute APIs
(``service.retries`` etc.) keep working regardless of the flag.

Counterpart of ``repro.obs``: metric families, label names and span kinds
are the reference's letter for letter, so one dashboard reads both.

The LM paths' spans (:func:`span`, :func:`count`, :func:`span_records`;
``obs/spans.py``) are the port's own: they record only while the gate is
on and a torch profiler is recording, keep their own ring, and are no
part of :func:`snapshot` or the flight recorder.
"""
from __future__ import annotations

import os
from contextlib import contextmanager
from typing import Dict, Optional

import torch

from .metrics import (DEFAULT_LATENCY_BUCKETS, CounterSeries, GaugeSeries,
                      HistogramSeries, Metric, MetricsRegistry)
from .recorder import FlightRecorder
from .spans import OFF, SpanRecorder

_ENABLED = os.environ.get("ENEL_OBS", "1").lower() in ("1", "true", "yes")

REGISTRY = MetricsRegistry()
RECORDER = FlightRecorder(capacity=int(os.environ.get("ENEL_OBS_RING", "4096")),
                          gate=lambda: _ENABLED)
SPANS = SpanRecorder()
_profiling = torch._C._autograd._profiler_enabled


def enabled(override: Optional[bool] = None) -> bool:
    return _ENABLED if override is None else bool(override)


def set_enabled(value: bool) -> bool:
    """Flip the gate; returns the previous value (for try/finally)."""
    global _ENABLED
    prev = _ENABLED
    _ENABLED = bool(value)
    return prev


@contextmanager
def obs_enabled(value: bool = True):
    prev = set_enabled(value)
    try:
        yield
    finally:
        set_enabled(prev)


def registry() -> MetricsRegistry:
    return REGISTRY


def recorder() -> FlightRecorder:
    return RECORDER


def emit(_kind: str, _ts: Optional[float] = None, **attrs) -> int:
    """Emit a span into the global flight recorder (no-op when gated)."""
    return RECORDER.emit(_kind, _ts=_ts, **attrs)


def observe(name: str, value: float, **labels) -> None:
    """Observe ``value`` into histogram ``name`` (no-op when disabled)."""
    if _ENABLED:
        REGISTRY.histogram(name).labels(**labels).observe(value)


def recording() -> bool:
    """Whether spans record now: the gate is on and a torch profiler is
    recording."""
    return _ENABLED and _profiling()


def span(name: str, **attrs):
    """A span of the LM paths (``obs/spans.py``); the shared no-op context
    unless :func:`recording`."""
    if _ENABLED and _profiling():
        return SPANS.span(name, attrs)
    return OFF


count = SPANS.count                # counters of the innermost open span
span_records = SPANS.records       # resolved records, oldest first


def snapshot() -> Dict:
    """Combined pickle-safe obs state (registry + recorder ring)."""
    return {"metrics": REGISTRY.snapshot(), "recorder": RECORDER.state()}


def restore(state: Optional[Dict]) -> None:
    if not state:
        return
    REGISTRY.restore(state.get("metrics", {}))
    if "recorder" in state:
        RECORDER.load(state["recorder"])


def reset() -> None:
    """Clear all global obs state (test isolation)."""
    REGISTRY.reset()
    RECORDER.clear()
    SPANS.clear()


def registry_attributes(cls, attrs) -> None:
    """Expose the registry series ``self._obs_counters[attr]`` as integer
    attributes of ``cls`` for every ``attr``: reads and read-modify-writes
    (``svc.retries += 1``) hit the series in the registry."""
    def make(attr):
        def fget(self):
            return int(self._obs_counters[attr].value)

        def fset(self, value):
            self._obs_counters[attr].set(value)
        return property(fget, fset)

    for attr in attrs:
        setattr(cls, attr, make(attr))
