"""Flight recorder: a bounded ring of structured span events.

Spans are plain dicts ``{"seq", "ts", "kind", "attrs"}``. ``seq`` is a
monotonic index (causal links between spans reference it — e.g. a
``decision.fallback`` span carries ``cause_seq`` pointing at the
guardrail/timeout/breaker event that forced it). ``ts`` is wall time
for live spans (or a caller-given logical timestamp); parity checks
compare the ``(kind, attrs)`` stream, which is free of both.

The ring is bounded (default 4096 spans): old spans fall off, the
recorder never grows without bound inside long campaigns.
"""
from __future__ import annotations

import json
from collections import deque
from typing import Callable, Dict, Iterable, List, Optional


class FlightRecorder:
    def __init__(self, capacity: int = 4096,
                 gate: Optional[Callable[[], bool]] = None):
        self.capacity = int(capacity)
        self.gate = gate            # None -> always on
        self._ring: deque = deque(maxlen=self.capacity)
        self._seq = 0
        self.dropped = 0            # spans evicted from the ring

    # -- emission -----------------------------------------------------

    def emit(self, _kind: str, _ts: Optional[float] = None, **attrs) -> int:
        """Append a span; returns its seq (-1 when gated off).

        The positional params are underscore-prefixed so span attrs named
        ``kind``/``ts`` (e.g. a run's scaler kind) stay usable as kwargs.
        """
        if self.gate is not None and not self.gate():
            return -1
        if _ts is None:
            import time
            _ts = time.time()
        seq = self._seq
        self._seq += 1
        if len(self._ring) == self.capacity:
            self.dropped += 1
        self._ring.append({"seq": seq, "ts": float(_ts), "kind": str(_kind),
                           "attrs": attrs})
        return seq

    # -- queries ------------------------------------------------------

    def events(self, kind: Optional[str] = None) -> List[Dict]:
        """Spans oldest-first; ``kind`` may be an exact kind or a
        ``"prefix."``-style prefix (trailing dot)."""
        if kind is None:
            return list(self._ring)
        if kind.endswith("."):
            return [e for e in self._ring if e["kind"].startswith(kind)]
        return [e for e in self._ring if e["kind"] == kind]

    def find(self, seq: int) -> Optional[Dict]:
        for e in self._ring:
            if e["seq"] == seq:
                return e
        return None

    def stream(self) -> List[tuple]:
        """(kind, attrs) pairs — the seq/ts-free view parity tests use."""
        return [(e["kind"], e["attrs"]) for e in self._ring]

    def __len__(self) -> int:
        return len(self._ring)

    def clear(self) -> None:
        self._ring.clear()
        self._seq = 0
        self.dropped = 0

    # -- snapshot / restore (pickle-safe) -----------------------------

    def state(self) -> Dict:
        return {"capacity": self.capacity, "seq": self._seq,
                "dropped": self.dropped,
                "ring": [dict(e, attrs=dict(e["attrs"])) for e in self._ring]}

    def load(self, state: Dict) -> None:
        self.capacity = int(state.get("capacity", self.capacity))
        self._ring = deque((dict(e, attrs=dict(e["attrs"]))
                            for e in state.get("ring", ())),
                           maxlen=self.capacity)
        self._seq = int(state.get("seq", len(self._ring)))
        self.dropped = int(state.get("dropped", 0))

    # -- exporters ----------------------------------------------------

    def to_jsonl(self, path: Optional[str] = None) -> str:
        """JSONL export (one span per line); writes ``path`` if given."""
        text = "\n".join(json.dumps(e, sort_keys=True, default=str)
                         for e in self._ring)
        if text:
            text += "\n"
        if path is not None:
            with open(path, "w") as f:
                f.write(text)
        return text

    def span_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for e in self._ring:
            out[e["kind"]] = out.get(e["kind"], 0) + 1
        return out
