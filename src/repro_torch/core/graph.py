"""Attributed component DAGs, padded to a fixed size (paper §III-A/D).

A dataflow job execution is a sequence of component graphs G(1..n); each node
is a set of parallel tasks attributed with context embeddings, metrics,
start/end scale-out and the fraction of time spent in each.  Summary nodes
P(k) (current component) and H(k) (mean of the beta most scale-out-similar
historical summaries) are prepended as predecessors of the next component's
roots and participate only in metric propagation (flagged ``is_summary``).

Host-side numpy copy of ``repro.core.graph`` (graphs, stacking, the sweep
template, summaries); the device-resident training cache comes with the
training slice.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

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
