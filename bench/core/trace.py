"""A traced stretch of a run: ``torch.profiler`` (CUPTI) events kept in
memory, reduced to device intervals, host ops and the benchmark's own
spans; and the program's kernel reports (``kernels/observe.py``) made in
the same stretch."""
from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, List, Tuple

Interval = Tuple[float, float]


@contextmanager
def traced(out: Dict):
    """Profile the block; on exit fill ``out`` with ``kernels`` [(name,
    start, end)] (every device operation), ``cpu`` [(name, start, end)]
    (host ops), ``spans`` [(name, start, end)] (the benchmark's
    ``bench.*`` record_function spans) and ``reports`` [(kernel, reads,
    writes, opts)], reads and writes as ((shape), bytes per element); times
    in seconds on the profiler's clock."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import observe
    reports: List = []

    def listen(name, reads, writes, opts):
        reports.append((name, tuple((tuple(t.shape), t.element_size())
                                    for t in reads),
                        tuple((tuple(t.shape), t.element_size())
                              for t in writes), dict(opts)))

    with observe.listening(listen):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            yield
    out.update(_events(prof))
    out["reports"] = reports


def _events(prof) -> Dict:
    from torch.autograd import DeviceType
    kernels, cpu, spans = [], [], []
    rows = ((e.name(), e.device_type(), e.start_ns() * 1e-9,
             (e.start_ns() + e.duration_ns()) * 1e-9)
            for e in prof.profiler.kineto_results.events())
    for name, dev, t0, t1 in rows:
        if name.startswith("bench."):
            if dev != DeviceType.CUDA:   # its copy on the device's timeline
                spans.append((name, t0, t1))   # is an annotation, no work
        elif dev == DeviceType.CUDA:
            kernels.append((name, t0, t1))
        else:
            cpu.append((name, t0, t1))
    return {"kernels": kernels, "cpu": cpu, "spans": spans}


def union(intervals: List[Interval]) -> List[Interval]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_in(kernels, lo: float, hi: float) -> float:
    """Seconds of [lo, hi] in which some device operation ran."""
    return sum(max(0.0, min(b, hi) - max(a, lo))
               for a, b in union([(k[1], k[2]) for k in kernels]))


def span_bounds(spans, name: str) -> List[Interval]:
    return [(a, b) for n, a, b in spans if n == name]


def device_ops(kernels, k: int = 10) -> List[List]:
    """The ``k`` device operations that took the most time, by name:
    [[name, seconds]]."""
    total: Dict[str, float] = {}
    for name, a, b in kernels:
        key = name[:120]
        total[key] = total.get(key, 0.0) + (b - a)
    return [[n, t] for n, t in sorted(total.items(), key=lambda x: -x[1])[:k]]


def idle_gaps(kernels, cpu, lo: float, hi: float, k: int = 10
              ) -> List[List]:
    """The ``k`` longest stretches of [lo, hi] with no device operation,
    each named by the host op running at its middle (the innermost one):
    [[host op, seconds]]."""
    busy = [(max(a, lo), min(b, hi)) for a, b in
            union([(x[1], x[2]) for x in kernels]) if b > lo and a < hi]
    edges = [lo] + [t for iv in busy for t in iv] + [hi]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                   for i in range(0, len(edges) - 1, 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:k]
    out = []
    for length, a, b in gaps:
        mid = 0.5 * (a + b)
        inner = [(s, n) for n, s, e in cpu if s <= mid <= e]
        out.append([max(inner)[1] if inner else "host, outside any op", length])
    return out
