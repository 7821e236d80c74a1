"""Unified metrics registry: typed counters, gauges, and fixed-bucket
latency histograms with labeled families.

Design constraints:

* **No sample storage.** Histograms keep only per-bucket counts plus
  exact sum/count/min/max, so p50/p95/p99 are derivable by linear
  interpolation inside the owning bucket — memory is O(buckets) no
  matter how many observations land.
* **Pickle-safe snapshots.** ``snapshot()`` returns plain dicts/tuples
  so a checkpoint can embed registry state and restore it identically.
  ``restore`` merges: series present in the snapshot are overwritten,
  series created since are left alone (a checkpoint from campaign A must
  not clobber campaign B's metrics).
* **Attribute-API compatibility.** Scattered counters (service
  robustness counters, template-cache stats) register here behind their current attribute APIs via
  ``CounterSeries``/``GaugeSeries`` handles that support ``+=``-style
  read-modify-write through properties.
"""
from __future__ import annotations

import json
import math
from typing import Dict, Iterable, List, Optional, Tuple

LabelKey = Tuple[Tuple[str, str], ...]

# Log-spaced seconds ladder: 0.1 ms .. 30 s. Covers both per-request
# decision latencies (sub-ms at fleet scale) and scratch fits (seconds).
DEFAULT_LATENCY_BUCKETS: Tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)


def _label_key(labels: Dict[str, object]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _label_str(key: LabelKey) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in key)
    return "{" + inner + "}"


class CounterSeries:
    """One labeled counter time series. Monotonic by convention, but
    ``set`` exists so checkpoint restore can rewind trace-identically."""

    __slots__ = ("_value",)

    def __init__(self, value: float = 0.0):
        self._value = value

    def inc(self, amount: float = 1.0) -> None:
        self._value += amount

    def set(self, value: float) -> None:
        self._value = float(value)

    @property
    def value(self) -> float:
        return self._value

    def state(self) -> float:
        return self._value

    def load(self, state: float) -> None:
        self._value = float(state)


class GaugeSeries:
    __slots__ = ("_value",)

    def __init__(self, value: float = 0.0):
        self._value = value

    def set(self, value: float) -> None:
        self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        self._value += amount

    @property
    def value(self) -> float:
        return self._value

    def state(self) -> float:
        return self._value

    def load(self, state: float) -> None:
        self._value = float(state)


class HistogramSeries:
    """Fixed-bucket histogram: per-bucket counts + sum/count/min/max.

    ``buckets`` are inclusive upper bounds; an implicit +inf bucket
    catches the overflow. Quantiles interpolate linearly inside the
    owning bucket and are clamped to the observed [min, max] so p99 of
    three samples never reports a bucket edge wildly past the data.
    """

    __slots__ = ("buckets", "counts", "sum", "count", "vmin", "vmax")

    def __init__(self, buckets: Tuple[float, ...]):
        self.buckets = tuple(float(b) for b in buckets)
        self.counts = [0] * (len(self.buckets) + 1)
        self.sum = 0.0
        self.count = 0
        self.vmin = math.inf
        self.vmax = -math.inf

    def observe(self, value: float) -> None:
        v = float(value)
        if not math.isfinite(v):
            return
        i = 0
        for i, ub in enumerate(self.buckets):
            if v <= ub:
                break
        else:
            i = len(self.buckets)
        self.counts[i] += 1
        self.sum += v
        self.count += 1
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)

    def quantile(self, q: float) -> float:
        if self.count == 0:
            return float("nan")
        target = q * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if cum + c >= target:
                lo = self.buckets[i - 1] if i > 0 else min(self.vmin, self.buckets[0])
                hi = self.buckets[i] if i < len(self.buckets) else self.vmax
                frac = (target - cum) / c
                est = lo + (hi - lo) * max(0.0, min(1.0, frac))
                return max(self.vmin, min(self.vmax, est))
            cum += c
        return self.vmax

    def summary(self) -> Dict[str, float]:
        return {
            "count": self.count,
            "sum": self.sum,
            "min": self.vmin if self.count else float("nan"),
            "max": self.vmax if self.count else float("nan"),
            "p50": self.quantile(0.50),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
        }

    def state(self) -> Dict[str, object]:
        return {"counts": list(self.counts), "sum": self.sum,
                "count": self.count, "vmin": self.vmin, "vmax": self.vmax}

    def load(self, state: Dict[str, object]) -> None:
        self.counts = list(state["counts"])
        self.sum = float(state["sum"])
        self.count = int(state["count"])
        self.vmin = float(state["vmin"])
        self.vmax = float(state["vmax"])


_SERIES_CLS = {"counter": CounterSeries, "gauge": GaugeSeries,
               "histogram": HistogramSeries}


class Metric:
    """A named family of labeled series of one kind."""

    def __init__(self, name: str, kind: str, help: str = "",
                 buckets: Optional[Tuple[float, ...]] = None):
        if kind not in _SERIES_CLS:
            raise ValueError(f"unknown metric kind {kind!r}")
        self.name = name
        self.kind = kind
        self.help = help
        self.buckets = tuple(buckets) if buckets else None
        self._series: Dict[LabelKey, object] = {}

    def labels(self, **labels):
        key = _label_key(labels)
        s = self._series.get(key)
        if s is None:
            if self.kind == "histogram":
                s = HistogramSeries(self.buckets or DEFAULT_LATENCY_BUCKETS)
            else:
                s = _SERIES_CLS[self.kind]()
            self._series[key] = s
        return s

    def series(self) -> Dict[LabelKey, object]:
        return self._series

    def drop(self, **labels) -> None:
        self._series.pop(_label_key(labels), None)

    def state(self) -> Dict[str, object]:
        # label keys serialize as JSON strings so the whole snapshot is
        # both pickle- AND json-safe (checkpoints pickle it; artifact
        # dumps json it)
        return {"kind": self.kind, "help": self.help,
                "buckets": list(self.buckets) if self.buckets else None,
                "series": {json.dumps(k): s.state()
                           for k, s in self._series.items()}}

    def load(self, state: Dict[str, object]) -> None:
        for key, st in state.get("series", {}).items():
            if isinstance(key, str):
                key = json.loads(key)
            key = tuple(tuple(p) for p in key)
            s = self._series.get(key)
            if s is None:
                if self.kind == "histogram":
                    s = HistogramSeries(self.buckets or DEFAULT_LATENCY_BUCKETS)
                else:
                    s = _SERIES_CLS[self.kind]()
                self._series[key] = s
            s.load(st)


class MetricsRegistry:
    """Controller-wide registry. ``counter``/``gauge``/``histogram`` are
    idempotent by name (re-registration returns the existing family,
    kind-checked), so every subsystem can declare its instruments at
    import/construction time without coordination."""

    def __init__(self):
        self._metrics: Dict[str, Metric] = {}

    def _get(self, name: str, kind: str, help: str,
             buckets: Optional[Tuple[float, ...]] = None) -> Metric:
        m = self._metrics.get(name)
        if m is not None:
            if m.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}")
            if help and not m.help:
                m.help = help
            return m
        m = Metric(name, kind, help, buckets)
        self._metrics[name] = m
        return m

    def counter(self, name: str, help: str = "") -> Metric:
        return self._get(name, "counter", help)

    def gauge(self, name: str, help: str = "") -> Metric:
        return self._get(name, "gauge", help)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Tuple[float, ...]] = None) -> Metric:
        return self._get(name, "histogram", help,
                         buckets or DEFAULT_LATENCY_BUCKETS)

    def get(self, name: str) -> Optional[Metric]:
        return self._metrics.get(name)

    def names(self) -> List[str]:
        return list(self._metrics)

    def reset(self) -> None:
        self._metrics.clear()

    # -- snapshot / restore (pickle-safe: dicts, tuples, floats only) --

    def snapshot(self, prefix: Optional[str] = None) -> Dict[str, object]:
        return {name: m.state() for name, m in self._metrics.items()
                if prefix is None or name.startswith(prefix)}

    def restore(self, snap: Dict[str, object]) -> None:
        """Merge-restore: overwrite series present in ``snap``; series
        and metrics created since the snapshot are left untouched."""
        for name, st in (snap or {}).items():
            m = self._get(name, st.get("kind", "counter"),
                          st.get("help", ""), st.get("buckets"))
            m.load(st)

    # -- exporters ----------------------------------------------------

    def rows(self, prefix: Optional[str] = None) -> List[Dict[str, object]]:
        """Flatten to JSON-friendly rows for bench artifacts/reports."""
        out: List[Dict[str, object]] = []
        for name, m in sorted(self._metrics.items()):
            if prefix is not None and not name.startswith(prefix):
                continue
            for key, s in sorted(m.series().items()):
                row: Dict[str, object] = {"metric": name, "kind": m.kind,
                                          "labels": dict(key)}
                if m.kind == "histogram":
                    row.update(s.summary())
                else:
                    row["value"] = s.value
                out.append(row)
        return out

    def prometheus_text(self) -> str:
        """Prometheus exposition format (text/plain; version 0.0.4)."""
        lines: List[str] = []
        for name, m in sorted(self._metrics.items()):
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            for key, s in sorted(m.series().items()):
                if m.kind == "histogram":
                    cum = 0
                    for i, ub in enumerate(s.buckets):
                        cum += s.counts[i]
                        lk = _label_key(dict(key, le=_fmt_le(ub)))
                        lines.append(f"{name}_bucket{_label_str(lk)} {cum}")
                    lk = _label_key(dict(key, le="+Inf"))
                    lines.append(f"{name}_bucket{_label_str(lk)} {s.count}")
                    lines.append(f"{name}_sum{_label_str(key)} {s.sum}")
                    lines.append(f"{name}_count{_label_str(key)} {s.count}")
                else:
                    lines.append(f"{name}{_label_str(key)} {s.value}")
        return "\n".join(lines) + ("\n" if lines else "")


def _fmt_le(ub: float) -> str:
    return f"{ub:g}"
