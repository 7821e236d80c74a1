"""Attributed component DAGs, padded to a fixed size (paper §III-A/D).

A dataflow job execution is a sequence of component graphs G(1..n); each node
is a set of parallel tasks attributed with context embeddings, metrics,
start/end scale-out and the fraction of time spent in each.  Summary nodes
P(k) (current component) and H(k) (mean of the beta most scale-out-similar
historical summaries) are prepended as predecessors of the next component's
roots and participate only in metric propagation (flagged ``is_summary``).

Host-side numpy copy of ``repro.core.graph`` (graphs, stacking, the sweep
template, the decision service's shape ladders and edge lists, summaries)
plus the device-resident :class:`TrainingCache` ring
that the trainer fits on, whose buffers are torch tensors.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

MAX_NODES = 16          # padded node count per component graph
N_METRICS = 5           # CPU util, shuffle r/w, data I/O, GC frac, spill ratio
CTX_DIM = 24            # u ‖ v ‖ w, each an 8-dim AE embedding (paper: c in R^3N)
BETA = 3                # historical summaries averaged into H(k)


def scaleout_vec(s: np.ndarray) -> np.ndarray:
    """Ernest-style enrichment [1 - 1/s, log s, s] (paper §III-D)."""
    s = np.maximum(np.asarray(s, np.float32), 1e-6)
    return np.stack([1.0 - 1.0 / s, np.log(s), s], axis=-1)


@dataclass
class NodeAttrs:
    """One task-set node, host-side."""
    name: str
    context: np.ndarray                 # (CTX_DIM,)
    metrics: Optional[np.ndarray]       # (N_METRICS,) or None if unobserved
    start_scaleout: float
    end_scaleout: float
    time_fraction: float = 1.0          # r_i: fraction spent in end scale-out
    runtime: Optional[float] = None     # observed runtime (None = unobserved)
    overhead: Optional[float] = None    # observed rescale overhead
    is_summary: bool = False


@dataclass
class ComponentGraph:
    """Padded arrays for one component; built via :func:`build_graph`."""
    context: np.ndarray        # (MAX_NODES, CTX_DIM)
    metrics: np.ndarray        # (MAX_NODES, N_METRICS)
    metrics_valid: np.ndarray  # (MAX_NODES,) bool
    a_raw: np.ndarray          # (MAX_NODES,)
    z_raw: np.ndarray          # (MAX_NODES,)
    r: np.ndarray              # (MAX_NODES,)
    runtime: np.ndarray        # (MAX_NODES,)
    runtime_valid: np.ndarray  # (MAX_NODES,)
    overhead: np.ndarray       # (MAX_NODES,)
    overhead_valid: np.ndarray
    adj: np.ndarray            # (MAX_NODES, MAX_NODES) adj[i,j]: j -> i edge
    mask: np.ndarray           # (MAX_NODES,) real-node mask
    is_summary: np.ndarray     # (MAX_NODES,)
    names: List[str] = field(default_factory=list)
    component_id: int = 0

    @property
    def n_nodes(self) -> int:
        return int(self.mask.sum())


def build_graph(nodes: Sequence[NodeAttrs], edges: Sequence[tuple],
                component_id: int = 0, max_nodes: int = MAX_NODES
                ) -> ComponentGraph:
    n = len(nodes)
    if n > max_nodes:
        raise ValueError(f"{n} nodes > padded max {max_nodes}")
    g = ComponentGraph(
        context=np.zeros((max_nodes, CTX_DIM), np.float32),
        metrics=np.zeros((max_nodes, N_METRICS), np.float32),
        metrics_valid=np.zeros(max_nodes, bool),
        a_raw=np.ones(max_nodes, np.float32),
        z_raw=np.ones(max_nodes, np.float32),
        r=np.ones(max_nodes, np.float32),
        runtime=np.zeros(max_nodes, np.float32),
        runtime_valid=np.zeros(max_nodes, bool),
        overhead=np.zeros(max_nodes, np.float32),
        overhead_valid=np.zeros(max_nodes, bool),
        adj=np.zeros((max_nodes, max_nodes), bool),
        mask=np.zeros(max_nodes, bool),
        is_summary=np.zeros(max_nodes, bool),
        names=[a.name for a in nodes],
        component_id=component_id,
    )
    for i, a in enumerate(nodes):
        g.context[i] = a.context
        if a.metrics is not None:
            g.metrics[i] = a.metrics
            g.metrics_valid[i] = True
        g.a_raw[i] = max(a.start_scaleout, 1e-6)
        g.z_raw[i] = max(a.end_scaleout, 1e-6)
        g.r[i] = a.time_fraction
        if a.runtime is not None:
            g.runtime[i] = a.runtime
            g.runtime_valid[i] = True
        if a.overhead is not None:
            g.overhead[i] = a.overhead
            g.overhead_valid[i] = True
        g.mask[i] = True
        g.is_summary[i] = a.is_summary
    for (src, dst) in edges:
        g.adj[dst, src] = True
    return g


STACK_KEYS = ("context", "metrics", "metrics_valid", "a_raw", "z_raw", "r",
              "runtime", "runtime_valid", "overhead", "overhead_valid",
              "adj", "mask", "is_summary")


def stack_graphs(graphs: Sequence[ComponentGraph]) -> Dict[str, np.ndarray]:
    """Batch of padded graphs -> dict of stacked arrays for the model."""
    f = lambda attr: np.stack([getattr(g, attr) for g in graphs])
    return {k: f(k) for k in STACK_KEYS}


def pow2_bucket(n: int) -> int:
    """Smallest power of two >= n (batch padding)."""
    b = 1
    while b < n:
        b *= 2
    return b


# ------------------------------------------------------ sweep bucket ladders
# Fixed shape ladders for the fleet decision service: every sweep is padded
# up to a rung of each ladder so a whole multi-job campaign dispatches a
# handful of (C, K, N, E, levels) shapes instead of one per exact sweep.
# Padded components/candidates are all-masked empty graphs that contribute
# exactly 0 (and are sliced off the result).

CAND_LADDER = (6, 12, 18, 24, 36)        # candidate axis C
COMP_LADDER = (4, 8, 12, 16, 24, 32)     # remaining-component axis K
NODE_LADDER = (4, 8, 16)                 # node-slot axis N (compaction)
EDGE_LADDER = (2, 4, 6, 8, 16, 32)       # real-edge axis E (sparse engine)
LEVEL_LADDER = (2, 4, 6, 8)              # propagation depth


def ladder_bucket(n: int, ladder: Sequence[int]) -> int:
    """Smallest ladder rung >= n; doubles past the last rung if needed."""
    for b in ladder:
        if b >= n:
            return b
    b = ladder[-1]
    while b < n:
        b *= 2
    return b


# --------------------------------------------------------------- sweep engine
# Batched candidate-sweep representation: across the candidate scale-out axis
# only (a_raw, z_raw, r, summary-node attributes) change, so a decision point
# is ONE candidate-invariant template per remaining component plus small
# per-candidate delta arrays, evaluated in one batch (see core/scaling.py
# and model.sweep_per_component).

SWEEP_KEYS = ("context", "metrics", "metrics_valid", "a_raw", "z_raw", "r",
              "adj", "mask", "is_summary")


@dataclass
class SweepTemplate:
    """Candidate-invariant arrays for the K remaining components.

    ``base`` holds the stacked (K, MAX_NODES, ...) arrays of the template
    graphs (the subset of keys the forward pass reads, ``SWEEP_KEYS``).
    ``h_onehot[k, n]`` flags the node slot of component k's historical-summary
    H(k-1) node, whose attributes vary with the candidate scale-out;
    ``follows_a``/``follows_z`` flag nodes whose start/end scale-out track the
    builder's ``a``/``z`` arguments; ``r_eq``/``r_neq`` are the per-node time
    fractions when a == z vs. a != z.
    """
    base: Dict[str, np.ndarray]
    h_onehot: np.ndarray           # (K, MAX_NODES) float32
    a_follows_a: np.ndarray        # (K, MAX_NODES) bool: a_raw tracks `a`
    a_follows_z: np.ndarray        # (K, MAX_NODES) bool: a_raw tracks `z`
    z_follows_a: np.ndarray        # (K, MAX_NODES) bool
    z_follows_z: np.ndarray        # (K, MAX_NODES) bool
    r_eq: np.ndarray               # (K, MAX_NODES)
    r_neq: np.ndarray              # (K, MAX_NODES)
    comp_ids: List[int] = field(default_factory=list)
    levels: int = 8                # max DAG depth -> propagation rounds

    @property
    def n_components(self) -> int:
        return self.base["mask"].shape[0]


def propagation_depth(adj: np.ndarray, mask: np.ndarray) -> int:
    """Longest predecessor chain (in edges) of a padded DAG.

    Level-synchronous metric propagation reaches its fixed point after this
    many rounds, so the sweep can run exactly `depth` levels instead of the
    MAX_LEVELS worst case without changing a single bit of the result.
    """
    a = adj & mask[None, :] & mask[:, None]
    d = np.zeros(a.shape[0], np.int64)
    for _ in range(a.shape[0]):
        nd = np.where(a.any(axis=1), (a * (d[None, :] + 1)).max(axis=1), 0)
        if (nd == d).all():
            break
        d = nd
    return int(d.max())


def empty_graph(max_nodes: int = MAX_NODES) -> ComponentGraph:
    """Cached all-masked padding graph (bucketing filler)."""
    g = _EMPTY_GRAPHS.get(max_nodes)
    if g is None:
        g = build_graph([], [], max_nodes=max_nodes)
        _EMPTY_GRAPHS[max_nodes] = g
    return g


_EMPTY_GRAPHS: Dict[int, ComponentGraph] = {}


def historical_summaries_batch(candidates: Sequence[NodeAttrs],
                               targets: np.ndarray, beta: int = BETA
                               ) -> Dict[str, np.ndarray]:
    """Vectorized :func:`historical_summary` over a vector of target
    scale-outs.  Returns per-target H-node attribute arrays::

        context (C, CTX_DIM), metrics (C, N_METRICS), metrics_valid (C,),
        start (C,), end (C,)

    Matches the scalar path exactly: stable argsort on |end - target| mirrors
    the stable ``sorted`` ranking, means are taken over the beta chosen.
    """
    targets = np.asarray(targets, np.float32)
    ends = np.array([a.end_scaleout for a in candidates], np.float32)
    starts = np.array([a.start_scaleout for a in candidates], np.float32)
    ctxs = np.stack([a.context for a in candidates]).astype(np.float32)
    mets = np.stack([np.zeros(N_METRICS, np.float32) if a.metrics is None
                     else np.asarray(a.metrics, np.float32)
                     for a in candidates])
    mval = np.array([a.metrics is not None for a in candidates])
    d = np.abs(ends[None, :] - targets[:, None])           # (C, n_hist)
    idx = np.argsort(d, axis=1, kind="stable")[:, :beta]   # (C, chosen)
    chosen_valid = mval[idx]                               # (C, chosen)
    n_valid = chosen_valid.sum(axis=1)
    met_sum = (mets[idx] * chosen_valid[..., None]).sum(axis=1)
    metrics = met_sum / np.maximum(n_valid, 1)[:, None]
    return {"context": ctxs[idx].mean(axis=1),
            "metrics": metrics.astype(np.float32),
            "metrics_valid": n_valid > 0,
            "start": starts[idx].mean(axis=1),
            "end": ends[idx].mean(axis=1)}


def materialize_candidate(template: SweepTemplate,
                          deltas: Dict[str, np.ndarray],
                          c: int) -> Dict[str, np.ndarray]:
    """Apply candidate ``c``'s deltas host-side -> stacked (K, N, ...) dict:
    exactly the graph batch the device-side assembly produces for ``c``."""
    oh = template.h_onehot[..., None]                       # (K, N, 1)
    out = {k: v.copy() for k, v in template.base.items()}
    out["context"] = (out["context"] * (1.0 - oh) +
                      oh * deltas["h_context"][c][:, None, :])
    out["metrics"] = (out["metrics"] * (1.0 - oh) +
                      oh * deltas["h_metrics"][c][:, None, :])
    out["metrics_valid"] = deltas["metrics_valid"][c].astype(bool)
    out["a_raw"] = deltas["a_raw"][c]
    out["z_raw"] = deltas["z_raw"][c]
    out["r"] = deltas["r"][c]
    return out


# ------------------------------------------------------ sweep shape bucketing
def bucket_sweep(template: SweepTemplate, deltas: Dict[str, np.ndarray]
                 ) -> Tuple[SweepTemplate, Dict[str, np.ndarray],
                            Tuple[int, int]]:
    """Pad a (template, deltas) sweep to the fixed shape ladders.

    Returns the padded pair plus the REAL ``(n_candidates, n_components)``
    so callers can slice results back.  Padding semantics:

    * node axis N is COMPACTED to the smallest rung holding every real node
      slot (graphs fill slots from 0, so trailing slots are pure padding);
    * component axis K is padded with all-masked empty graphs whose
      per-component readout is exactly 0;
    * candidate axis C is padded by repeating the last candidate's deltas
      (rows past the real count are sliced off / masked in the pick);
    * ``levels`` is rounded up to a rung — extra propagation rounds past the
      DAG depth are a fixed point, so the result is unchanged.
    """
    c_real, k_real = deltas["a_raw"].shape[:2]
    n_now = template.base["mask"].shape[1]
    extent = 1
    if template.base["mask"].any():
        extent = int(np.flatnonzero(template.base["mask"].any(axis=0)).max()) + 1
    n_b = min(ladder_bucket(extent, NODE_LADDER), n_now)
    k_b = ladder_bucket(k_real, COMP_LADDER)
    c_b = ladder_bucket(c_real, CAND_LADDER)

    # which trailing structure each array key has around the node axis
    def fit_nodes(key: str, v: np.ndarray) -> np.ndarray:
        if key == "adj":
            return v[..., :n_b, :n_b]
        if key in ("context", "metrics"):            # (..., N, feature)
            return v[..., :n_b, :]
        if key in ("h_context", "h_metrics"):        # no node axis
            return v
        return v[..., :n_b]                          # (..., N)

    spec = _cache_spec(n_b)
    base = {}
    for key, v in template.base.items():
        v = fit_nodes(key, v)
        shape, dtype, fill = spec[key]
        pad = np.full((k_b - k_real,) + shape, fill, v.dtype)
        base[key] = np.concatenate([v, pad]) if k_b > k_real else v
    h_onehot = np.zeros((k_b, n_b), np.float32)
    h_onehot[:k_real] = template.h_onehot[:, :n_b]

    d_fill = {"a_raw": 1.0, "z_raw": 1.0, "r": 1.0, "metrics_valid": False,
              "h_context": 0.0, "h_metrics": 0.0}
    out = {}
    for key, v in deltas.items():
        v = fit_nodes(key, np.asarray(v))
        if k_b > k_real:
            pad = np.full((c_real, k_b - k_real) + v.shape[2:], d_fill[key],
                          v.dtype)
            v = np.concatenate([v, pad], axis=1)
        if c_b > c_real:
            v = np.concatenate([v, np.repeat(v[-1:], c_b - c_real, axis=0)])
        out[key] = v

    padded = replace(
        template, base=base, h_onehot=h_onehot,
        levels=min(ladder_bucket(max(template.levels, 1), LEVEL_LADDER),
                   LEVEL_LADDER[-1]))
    return padded, out, (c_real, k_real)


def sweep_edge_list(base: Dict[str, np.ndarray]
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-component (dst, src) edge lists for the sparse sweep engine.

    Returns ``(edge_dst, edge_src, edge_valid)`` of shape (K, E), int32 /
    int32 / bool as the reference's, with E the smallest EDGE_LADDER rung
    holding every component's real edge count.  Padding edges point at
    slot 0 with ``edge_valid`` False — the engine masks them out of the
    softmax and both reductions.
    """
    adj = base["adj"] & base["mask"][:, None, :] & base["mask"][:, :, None]
    k = adj.shape[0]
    counts = adj.reshape(k, -1).sum(axis=1)
    e_b = ladder_bucket(max(int(counts.max()) if k else 1, 1), EDGE_LADDER)
    dst = np.zeros((k, e_b), np.int32)
    src = np.zeros((k, e_b), np.int32)
    val = np.zeros((k, e_b), bool)
    for ki in range(k):
        pairs = np.argwhere(adj[ki])               # (n_edges, 2): [dst, src]
        m = len(pairs)
        if m:
            dst[ki, :m] = pairs[:, 0]
            src[ki, :m] = pairs[:, 1]
            val[ki, :m] = True
    return dst, src, val


# ------------------------------------------------------------ training cache
# Device-resident ring buffer of stacked graphs: the runner appends each
# run's graphs once, and every (re)fit trains straight on the resident
# (capacity, max_nodes, ...) tensors instead of restacking on the host.

def _cache_spec(max_nodes: int) -> Dict[str, tuple]:
    """(shape, dtype, fill) per stacked key; fills mirror build_graph's
    padding so an unfilled slot is exactly an ``empty_graph()``."""
    n = max_nodes
    return {
        "context": ((n, CTX_DIM), np.float32, 0.0),
        "metrics": ((n, N_METRICS), np.float32, 0.0),
        "metrics_valid": ((n,), bool, False),
        "a_raw": ((n,), np.float32, 1.0),
        "z_raw": ((n,), np.float32, 1.0),
        "r": ((n,), np.float32, 1.0),
        "runtime": ((n,), np.float32, 0.0),
        "runtime_valid": ((n,), bool, False),
        "overhead": ((n,), np.float32, 0.0),
        "overhead_valid": ((n,), bool, False),
        "adj": ((n, n), bool, False),
        "mask": ((n,), bool, False),
        "is_summary": ((n,), bool, False),
    }


def node_extent(g: ComponentGraph) -> int:
    """1 + index of the last real node slot (graphs fill slots from 0)."""
    idx = np.flatnonzero(g.mask)
    return int(idx.max()) + 1 if idx.size else 1


def _fit_nodes(v: np.ndarray, key: str, n: int) -> np.ndarray:
    """Slice or pad one graph attribute to ``n`` node slots."""
    spec = _cache_spec(n)[key]
    if key == "adj":
        out = np.full(spec[0], spec[2], spec[1])
        m = min(v.shape[0], n)
        out[:m, :m] = v[:m, :m]
        return out
    if v.shape[0] == n:
        return v.astype(spec[1], copy=False)
    out = np.full(spec[0], spec[2], spec[1])
    m = min(v.shape[0], n)
    out[:m] = v[:m]
    return out


def compact_rows(graphs: Sequence[ComponentGraph],
                 max_nodes: int) -> Dict[str, np.ndarray]:
    """Stack only the given graphs, sliced or padded to ``max_nodes`` slots.

    Runner graphs are padded to MAX_NODES but hold far fewer real nodes
    (longest job: 5 stages + 2 summary predecessors); training on compact
    8-slot rows quarters the N x N pair work with identical losses (the
    dropped slots are fully masked).
    """
    return {k: np.stack([_fit_nodes(getattr(g, k), k, max_nodes)
                         for g in graphs]) for k in STACK_KEYS}


def ring_append(buffers: Dict[str, torch.Tensor],
                rows: Dict[str, torch.Tensor], idx: torch.Tensor) -> None:
    """Write ``rows`` into the ring ``buffers`` at slots ``idx``, in place
    (the reference's functional ``.at[idx].set``)."""
    for k, b in buffers.items():
        b[idx] = rows[k].to(b.dtype)


# float keys scanned by the cache's non-finite quarantine (bool keys cannot
# be non-finite; adj is bool too)
_FINITE_KEYS = ("context", "metrics", "a_raw", "z_raw", "r", "runtime",
                "overhead")


def _torch_dtype(dtype) -> torch.dtype:
    return torch.bool if dtype is bool else torch.float32


class TrainingCache:
    """Device-resident ring buffer of stacked component graphs.

    ``extend`` appends incrementally (newest overwrite oldest once full);
    ``full_batch``/``latest_batch`` hand back resident tensors plus a
    per-slot 0/1 weight vector for the loss.  Unfilled or padding slots are
    all-masked empty graphs with weight 0, so the ring holds the same as a
    one-shot :func:`stack_graphs` of the same graphs.

    Quarantine: rows carrying non-finite values are replaced by empty-graph
    rows and get weight 0 (``slot_ok``); weighting alone would not do, as
    ``NaN * 0 == NaN``.  ``extend`` quarantines on the way in,
    :meth:`quarantine_nonfinite` re-scans the resident rows.

    Counterpart of ``repro.core.graph.TrainingCache`` on ``device``; the
    ring state (``pos``, ``count``, ``latest``, ``slot_ok``,
    ``quarantined``) matches it slot for slot.
    """

    def __init__(self, capacity: int, max_nodes: int = 8, *,
                 device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        self.capacity = int(capacity)
        self.max_nodes = int(max_nodes)
        self.buffers = self._empty(self.max_nodes)
        self.pos = 0          # next write slot
        self.count = 0        # filled slots
        self.latest = np.zeros(0, np.int64)   # slots of the last extend()
        self.slot_ok = np.ones(self.capacity, bool)  # quarantine mask
        self.quarantined = 0  # rows replaced by empty graphs (lifetime)

    def _empty(self, max_nodes: int) -> Dict[str, torch.Tensor]:
        return {k: torch.full((self.capacity,) + shape, fill,
                              dtype=_torch_dtype(dtype), device=self.device)
                for k, (shape, dtype, fill) in _cache_spec(max_nodes).items()}

    def _grow(self, new_nodes: int) -> None:
        """Reallocate with more node slots, padding existing rows."""
        grown = self._empty(new_nodes)
        for k, b in grown.items():
            old = self.buffers[k]
            if k == "adj":
                b[:, :old.shape[1], :old.shape[2]] = old
            else:
                b[:, :old.shape[1]] = old
        self.buffers = grown
        self.max_nodes = new_nodes

    def _to_device(self, rows: Dict[str, np.ndarray]
                   ) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in rows.items()}

    def extend(self, graphs: Sequence[ComponentGraph]) -> np.ndarray:
        """Append graphs (newest kept if more than ``capacity``); returns the
        ring slots written, also kept as ``latest`` for fine-tuning."""
        graphs = list(graphs)[-self.capacity:]
        if not graphs:
            return np.zeros(0, np.int64)
        need = max(node_extent(g) for g in graphs)
        if need > self.max_nodes:
            self._grow(pow2_bucket(need))
        rows = compact_rows(graphs, self.max_nodes)
        ok = self._rows_finite(rows)
        if not ok.all():                # quarantine poisoned rows on entry
            empty = compact_rows([empty_graph(self.max_nodes)],
                                 self.max_nodes)
            for k in rows:
                rows[k][~ok] = empty[k][0]
            self.quarantined += int((~ok).sum())
        idx = (self.pos + np.arange(len(graphs))) % self.capacity
        ring_append(self.buffers, self._to_device(rows),
                    torch.as_tensor(idx, device=self.device))
        self.pos = int((self.pos + len(graphs)) % self.capacity)
        self.count = min(self.capacity, self.count + len(graphs))
        self.latest = idx
        self.slot_ok[idx] = ok
        return idx

    @staticmethod
    def _rows_finite(rows: Dict[str, np.ndarray]) -> np.ndarray:
        """(B,) bool: every float value of each stacked row is finite."""
        ok = None
        for k in _FINITE_KEYS:
            v = np.asarray(rows[k])
            fin = np.isfinite(v).all(axis=tuple(range(1, v.ndim)))
            ok = fin if ok is None else (ok & fin)
        return ok

    def quarantine_nonfinite(self) -> int:
        """Re-scan resident rows for non-finite values (one host fetch),
        replace offenders with empty-graph rows and drop them from
        ``slot_ok``.  Returns how many rows were newly quarantined."""
        host = {k: self.buffers[k].cpu().numpy() for k in _FINITE_KEYS}
        bad = ~self._rows_finite(host) & self.slot_ok
        n = int(bad.sum())
        if n == 0:
            return 0
        empty = compact_rows([empty_graph(self.max_nodes)], self.max_nodes)
        idx = np.flatnonzero(bad)
        ring_append(self.buffers,
                    self._to_device({k: np.repeat(v, n, axis=0)
                                     for k, v in empty.items()}),
                    torch.as_tensor(idx, device=self.device))
        self.slot_ok[idx] = False
        self.quarantined += n
        return n

    def full_batch(self):
        """(resident batch over all slots, per-slot weights) for scratch
        fits; quarantined slots train with weight 0."""
        w = np.zeros(self.capacity, np.float32)
        w[:self.count] = 1.0
        w *= self.slot_ok
        return self.buffers, w

    def latest_batch(self):
        """(gathered batch, weights) over the newest extend(), padded to a
        power-of-two row count; quarantined slots train with weight 0."""
        m = len(self.latest)
        b = pow2_bucket(max(m, 1))
        idx = np.zeros(b, np.int64)
        idx[:m] = self.latest
        w = np.zeros(b, np.float32)
        w[:m] = self.slot_ok[self.latest]
        dev_idx = torch.as_tensor(idx, device=self.device)
        return {k: v[dev_idx] for k, v in self.buffers.items()}, w

    def stacked_host(self) -> Dict[str, np.ndarray]:
        """Host copy of the filled slots, oldest -> newest (tests/debug)."""
        if self.count < self.capacity:
            order = np.arange(self.count)
        else:
            order = (self.pos + np.arange(self.capacity)) % self.capacity
        return {k: v.cpu().numpy()[order] for k, v in self.buffers.items()}


def summary_node(nodes: Sequence[NodeAttrs], name: str,
                 is_historical: bool = False) -> NodeAttrs:
    """P(k): mean context/metrics + component start/end scale-out (§III-D)."""
    real = [a for a in nodes if not a.is_summary]
    ctx = np.mean([a.context for a in real], axis=0)
    mets = [a.metrics for a in real if a.metrics is not None]
    m = np.mean(mets, axis=0) if mets else None
    return NodeAttrs(
        name=name, context=ctx.astype(np.float32),
        metrics=None if m is None else m.astype(np.float32),
        start_scaleout=real[0].start_scaleout,
        end_scaleout=real[-1].end_scaleout,
        time_fraction=1.0, is_summary=True)


def historical_summary(candidates: List[NodeAttrs], target_scaleout: float,
                       beta: int = BETA, name: str = "H") -> Optional[NodeAttrs]:
    """H(k): average of the beta scale-out-nearest historical summaries."""
    if not candidates:
        return None
    ranked = sorted(candidates,
                    key=lambda a: abs(a.end_scaleout - target_scaleout))
    chosen = ranked[:beta]
    ctx = np.mean([a.context for a in chosen], axis=0).astype(np.float32)
    mets = [a.metrics for a in chosen if a.metrics is not None]
    m = np.mean(mets, axis=0).astype(np.float32) if mets else None
    return NodeAttrs(
        name=name, context=ctx, metrics=m,
        start_scaleout=float(np.mean([a.start_scaleout for a in chosen])),
        end_scaleout=float(np.mean([a.end_scaleout for a in chosen])),
        time_fraction=1.0, is_summary=True)
