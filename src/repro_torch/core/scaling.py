"""Enel's dynamic scale-out optimizer (paper §IV-A), PyTorch.

Upon each request: construct the *remaining* component graphs from static
component characteristics (a graph_builder supplied by the job layer), attach
P/H summary nodes, run propagation for EVERY candidate scale-out in the valid
range, and pick the configuration that best complies with the runtime target
(smallest scale-out among the feasible; else the argmin).

Counterpart of ``repro.core.scaling``.  :meth:`EnelScaler.recommend` is the
*batched candidate-sweep* engine: the graph builder is probed twice per
remaining component to derive ONE candidate-invariant template plus
per-candidate delta arrays (a_raw, z_raw, r, H-summary attributes); the
whole (candidate x component) batch is evaluated on the device in one
``graph_prop`` launch, the compliant pick runs on the device, and the host
fetches (pick, per-candidate totals) in one transfer.  The per-candidate
graph path is kept as :meth:`EnelScaler.recommend_pergraph` for reference.
:meth:`EnelScaler.prepare_request` builds the same sweep as a
shape-bucketed :class:`~repro_torch.core.service.DecisionRequest` for the
fleet :class:`~repro_torch.core.service.DecisionService` (which the
experiment runner decides through), and :meth:`EnelScaler.apply_decision`
records its answer.

Builder contract for the batched path: ``a``/``z`` may flow *unchanged* into
node start/end scale-outs (identity only — derived values like (a+z)/2 keep
the template's base value), and time fractions may depend on ``a``/``z``
only through the predicate ``a == z``.  The builder must also be
*structurally deterministic*: for a fixed (component index, predecessor
count) the node count, edge wiring, a/z slot wiring and time-fraction
pattern may not change between calls — the probe that discovers the wiring
runs once per key and is cached.  Node contexts are treated as
candidate-invariant: the template is built once at the current scale-out.
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import OrderedDict, defaultdict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.bell import initial_scaleout
from repro_torch.core.fallback import FallbackPolicy
from repro_torch.core.graph import (CTX_DIM, N_METRICS, ComponentGraph,
                                    NodeAttrs, SWEEP_KEYS, SweepTemplate,
                                    bucket_sweep, historical_summaries_batch,
                                    historical_summary, propagation_depth,
                                    summary_node, sweep_edge_list)
from repro_torch.core.model import pick_candidate
from repro_torch.core.service import DecisionRequest, DecisionResult
from repro_torch.core.training import EnelTrainer

# graph_builder(comp_idx, a, z, predecessors) -> ComponentGraph with
# unobserved metrics/runtimes; predecessors = list of summary NodeAttrs.
GraphBuilder = Callable[[int, float, float, List[NodeAttrs]], ComponentGraph]

# Probe scale-outs used to classify which node slots track the builder's
# a/z arguments.  Exactly representable in float32 and far outside any real
# scale-out range, so equality against the built arrays is unambiguous.
A_PROBE = 1.0e5
Z_PROBE = 2.0e5
H_SLOT = "__H__"          # placeholder name marking the H-summary node slot


class _TemplateDeviceCache:
    """Device-resident sweep-template reuse ACROSS decision points.

    The template base arrays (K, N, ...) are candidate-invariant and change
    little between decision points with the same remaining-component count:
    only the entries derived from the current scale-out or the latest
    summaries move.  One device copy is kept per (remaining components, node
    slots, candidate count) key, and a per-key host diff re-ships ONLY the
    arrays whose values changed.  A bounded LRU over keys (default 8 slots).
    ``transfers``/``skips``/``evictions`` count uploads, uploads avoided and
    slots dropped, registry-backed behind those attributes.
    """

    _ids = itertools.count()        # obs label allocator

    def __init__(self, device: torch.device, max_slots: int = 8):
        self.device = device
        self.max_slots = max_slots
        self._slots: "OrderedDict[Tuple[int, int, int], Tuple[Dict, Dict]]" \
            = OrderedDict()
        reg = obs.registry()
        name = f"tc{next(self._ids)}"
        self._obs_counters = {
            attr: reg.counter(family, help).labels(cache=name)
            for attr, (family, help) in _CACHE_COUNTERS.items()}

    def adopt(self, template: SweepTemplate, n_candidates: int
              ) -> SweepTemplate:
        """Return ``template`` with ``base``/``h_onehot`` swapped for cached
        device tensors (uploading only what changed since last decision)."""
        k, n = template.base["mask"].shape
        key = (k, n, n_candidates)
        host_new = dict(template.base, __h_onehot__=template.h_onehot)
        slot = self._slots.get(key)
        if slot is None:
            dev = {kk: torch.as_tensor(v, device=self.device)
                   for kk, v in host_new.items()}
            self._slots[key] = ({kk: v.copy() for kk, v in host_new.items()},
                                dev)
            self.transfers += len(host_new)
            while len(self._slots) > self.max_slots:
                self._slots.popitem(last=False)
                self.evictions += 1
        else:
            self._slots.move_to_end(key)
            host, dev = slot
            for kk, v in host_new.items():
                if np.array_equal(host[kk], v):
                    self.skips += 1
                    continue
                dev[kk] = torch.as_tensor(v, device=self.device)
                host[kk] = v.copy()
                self.transfers += 1
        _, dev = self._slots[key]
        return dataclasses.replace(
            template, base={kk: dev[kk] for kk in template.base},
            h_onehot=dev["__h_onehot__"])


_CACHE_COUNTERS = {
    "transfers": ("enel_template_cache_transfers_total",
                  "device uploads performed"),
    "skips": ("enel_template_cache_skips_total",
              "uploads avoided by the host diff"),
    "evictions": ("enel_template_cache_evictions_total",
                  "LRU slots dropped"),
}


obs.registry_attributes(_TemplateDeviceCache, _CACHE_COUNTERS)


def _totals_pick(per_comp: torch.Tensor, cand: torch.Tensor,
                 cand_valid: torch.Tensor, elapsed: torch.Tensor,
                 target: torch.Tensor) -> torch.Tensor:
    """Device-side reduction + compliant pick over the sweep output, packed
    as one float32 vector [pick index, per-candidate totals...] so the host
    fetches both in a single transfer."""
    totals = per_comp.sum(dim=1) + elapsed
    idx = pick_candidate(cand, cand_valid, totals, target)
    return torch.cat([idx.to(totals.dtype).reshape(1), totals])


class EnelScaler:
    def __init__(self, trainer: EnelTrainer, scaleout_range: Tuple[int, int],
                 beta: int = 3, candidate_stride: int = 1):
        self.trainer = trainer
        self.device = trainer.device
        self.range = scaleout_range
        self.beta = beta
        self.candidate_stride = max(1, candidate_stride)
        # historical summary nodes per component index (across runs)
        self.hist_summaries: Dict[int, List[NodeAttrs]] = defaultdict(list)
        # first-component (scaleout, runtime) pairs for Bell initial alloc
        self.first_component_history: List[Tuple[float, float]] = []
        # last sweep diagnostics: candidates list + (C, K) per-component preds
        # (held as a DecisionResult — device-resident, transferred lazily)
        self.last_candidates: List[int] = []
        self._last_result: Optional[DecisionResult] = None
        # device-resident template arrays reused across decision points
        self.template_cache = _TemplateDeviceCache(self.device)
        # guardrail backstop: non-finite sweep totals never reach a pick —
        # the bounded model-free clamp answers instead
        self.fallback = FallbackPolicy()
        self.fallback_decisions = 0
        # probe-derived structural masks per (comp idx, #predecessors); one
        # probe per key serves the whole campaign.  NOT perf-only: a miss
        # calls the graph builder once more, which consumes encoder draws
        self._probe_cache: Dict[Tuple[int, int], Tuple] = {}
        # identity-stable request constants (edge lists, candidate arrays):
        # reusing the SAME ndarray objects across decisions lets the service
        # skip re-stacking them when nothing changed
        self._edge_cache: Dict[Tuple[int, int, int], Tuple] = {}
        self._cand_cache: Dict[Tuple, Tuple[np.ndarray, np.ndarray]] = {}

    @property
    def last_per_component(self) -> Optional[np.ndarray]:
        """(C, K) per-component predictions of the last sweep (lazy fetch)."""
        if self._last_result is None:
            return None
        return self._last_result.per_component

    def _note_sweep(self, candidates: Sequence[int],
                    result: DecisionResult) -> None:
        self.last_candidates = list(candidates)
        self._last_result = result

    # --------------------------------------------------------------- history
    def record_component(self, comp_idx: int, nodes: Sequence[NodeAttrs],
                         runtime: float) -> None:
        self.hist_summaries[comp_idx].append(
            summary_node(nodes, name=f"P{comp_idx}"))
        if comp_idx == 0:
            scaleout = nodes[-1].end_scaleout
            self.first_component_history.append((scaleout, runtime))

    # ------------------------------------------------------------ initial alloc
    def initial_allocation(self, target_runtime: float,
                           n_components: int) -> int:
        """Bell on the first component + Enel on the rest (paper §IV-A)."""
        if len(self.first_component_history) < 3:
            return max(self.range[0], (self.range[0] + self.range[1]) // 2)
        lo, hi = self.range
        per_comp_target = target_runtime / max(n_components, 1)
        return initial_scaleout(self.first_component_history,
                                per_comp_target, (lo, hi))

    # ------------------------------------------------------------ candidates
    def candidate_scaleouts(self, current_scaleout: int) -> List[int]:
        lo, hi = self.range
        candidates = sorted(set(range(lo, hi + 1, self.candidate_stride))
                            | {hi, current_scaleout})
        return [s for s in candidates if lo <= s <= hi]

    # ---------------------------------------------------------- sweep builder
    def build_sweep(self, *, graph_builder: GraphBuilder, next_comp: int,
                    n_components: int, current_scaleout: int,
                    candidates: Sequence[int],
                    current_summary: Optional[NodeAttrs] = None
                    ) -> Tuple[SweepTemplate, Dict[str, np.ndarray]]:
        """Probe the builder twice per remaining component and assemble the
        candidate-invariant template plus the per-candidate delta arrays."""
        remaining = list(range(next_comp, n_components))
        cand = np.array(candidates, np.float32)
        n_cand, n_rem = len(candidates), len(remaining)
        s_now = float(current_scaleout)

        base_graphs: List[ComponentGraph] = []
        probes: List[Tuple] = []    # (a==A, a==Z, z==A, z==Z, r) per component
        hists: Dict[int, List[NodeAttrs]] = {}
        for k in remaining:
            preds: List[NodeAttrs] = []
            if k == next_comp and current_summary is not None:
                preds.append(current_summary)        # P of the just-finished comp
            hist = self.hist_summaries.get(k - 1, []) if k > 0 else []
            if hist:
                # placeholder H(k-1) slot; attributes are per-candidate deltas
                preds.append(NodeAttrs(
                    name=H_SLOT, context=np.zeros(CTX_DIM, np.float32),
                    metrics=np.zeros(N_METRICS, np.float32),
                    start_scaleout=1.0, end_scaleout=1.0, is_summary=True))
                hists[k] = hist
            base_graphs.append(graph_builder(k, s_now, s_now, list(preds)))
            probe_key = (k, len(preds))
            probe = self._probe_cache.get(probe_key)
            if probe is None:
                pg = graph_builder(k, A_PROBE, Z_PROBE, list(preds))
                probe = (pg.a_raw == A_PROBE, pg.a_raw == Z_PROBE,
                         pg.z_raw == A_PROBE, pg.z_raw == Z_PROBE,
                         pg.r.copy())
                self._probe_cache[probe_key] = probe
            probes.append(probe)

        base = {key: np.stack([getattr(g, key) for g in base_graphs])
                for key in SWEEP_KEYS}
        max_nodes = base["mask"].shape[1]
        h_onehot = np.zeros((n_rem, max_nodes), np.float32)
        for ki, g in enumerate(base_graphs):
            if remaining[ki] in hists:
                if H_SLOT in g.names:
                    h_onehot[ki, g.names.index(H_SLOT)] = 1.0
                else:                    # builder dropped the pred: no H delta
                    del hists[remaining[ki]]
        template = SweepTemplate(
            base=base, h_onehot=h_onehot,
            a_follows_a=np.stack([p[0] for p in probes]),
            a_follows_z=np.stack([p[1] for p in probes]),
            z_follows_a=np.stack([p[2] for p in probes]),
            z_follows_z=np.stack([p[3] for p in probes]),
            r_eq=base["r"].copy(),
            r_neq=np.stack([p[4] for p in probes]),
            comp_ids=remaining,
            levels=max(propagation_depth(g.adj, g.mask)
                       for g in base_graphs) or 1)

        # per-candidate builder arguments (paper: the component about to start
        # rescales from the current allocation; later ones run at z == s)
        z_sel = np.broadcast_to(cand[:, None], (n_cand, n_rem))    # (C, K)
        a_sel = np.where(np.array(remaining)[None, :] == next_comp,
                         s_now, z_sel)
        a3, z3 = a_sel[:, :, None], z_sel[:, :, None]
        a_raw = np.where(template.a_follows_a[None], a3,
                         np.where(template.a_follows_z[None], z3,
                                  base["a_raw"][None]))
        z_raw = np.where(template.z_follows_a[None], a3,
                         np.where(template.z_follows_z[None], z3,
                                  base["z_raw"][None]))
        r = np.where((a_sel == z_sel)[:, :, None],
                     template.r_eq[None], template.r_neq[None])
        metrics_valid = np.broadcast_to(
            base["metrics_valid"][None], (n_cand, n_rem, max_nodes)).copy()
        h_context = np.zeros((n_cand, n_rem, CTX_DIM), np.float32)
        h_metrics = np.zeros((n_cand, n_rem, N_METRICS), np.float32)
        for ki, k in enumerate(remaining):
            if k not in hists:
                continue
            h = historical_summaries_batch(hists[k], cand, beta=self.beta)
            slot = int(np.argmax(h_onehot[ki]))
            h_context[:, ki] = h["context"]
            h_metrics[:, ki] = h["metrics"]
            metrics_valid[:, ki, slot] = h["metrics_valid"]
            a_raw[:, ki, slot] = np.maximum(h["start"], 1e-6)
            z_raw[:, ki, slot] = np.maximum(h["end"], 1e-6)
        deltas = {"a_raw": a_raw.astype(np.float32),
                  "z_raw": z_raw.astype(np.float32),
                  "r": r.astype(np.float32),
                  "metrics_valid": metrics_valid,
                  "h_context": h_context, "h_metrics": h_metrics}
        return template, deltas

    # ------------------------------------------------------------- recommend
    def recommend(self, *, graph_builder: GraphBuilder, next_comp: int,
                  n_components: int, elapsed: float, current_scaleout: int,
                  target_runtime: float,
                  current_summary: Optional[NodeAttrs] = None
                  ) -> Tuple[int, float, Dict[int, float]]:
        """Batched sweep: returns (scaleout, predicted_total, per-cand totals)."""
        candidates = self.candidate_scaleouts(current_scaleout)
        if next_comp >= n_components:
            return current_scaleout, elapsed, {}
        template, deltas = self.build_sweep(
            graph_builder=graph_builder, next_comp=next_comp,
            n_components=n_components, current_scaleout=current_scaleout,
            candidates=candidates, current_summary=current_summary)
        template = self.template_cache.adopt(template, len(candidates))
        per_dev = self.trainer.predict_sweep_device(template, deltas)  # (C, K)
        dev = self.device
        packed = _totals_pick(
            per_dev, torch.as_tensor(np.array(candidates, np.float32),
                                     device=dev),
            torch.ones(len(candidates), dtype=torch.bool, device=dev),
            torch.tensor(np.float32(elapsed), device=dev),
            torch.tensor(np.float32(target_runtime), device=dev))
        # single host transfer: the pick + the per-candidate totals
        packed = packed.cpu().numpy()
        idx, totals_np = int(packed[0]), packed[1:]
        if not np.isfinite(totals_np).all():    # guardrail: poisoned model
            self.fallback_decisions += 1
            best, pred = self.fallback.decide(
                candidates, totals_np, current_scaleout, elapsed,
                target_runtime)
            totals = {s: float(t) for s, t in zip(candidates, totals_np)
                      if np.isfinite(t)}
            return best, pred, totals
        totals = {s: float(totals_np[i]) for i, s in enumerate(candidates)}
        best = candidates[idx]
        self._note_sweep(candidates, DecisionResult(
            scaleout=best, predicted=totals[best], totals=totals,
            per_component_dev=per_dev, n_candidates=per_dev.shape[0],
            n_components=per_dev.shape[1]))
        return best, totals[best], totals

    # ------------------------------------------------- fleet decision service
    def prepare_request(self, *, graph_builder: GraphBuilder, next_comp: int,
                        n_components: int, elapsed: float,
                        current_scaleout: int, target_runtime: float,
                        current_summary: Optional[NodeAttrs] = None,
                        best_effort: bool = False
                        ) -> Optional[DecisionRequest]:
        """Build this job's pending decision as a shape-bucketed request for
        :class:`repro_torch.core.service.DecisionService`.

        The sweep is assembled exactly as :meth:`recommend` would, then
        padded to the fixed shape ladders (padded components read out as
        exactly 0 and padded candidates are masked from the pick), the real
        edges are gathered for the sparse engine, and the template base
        arrays are swapped for the device-resident cache copies.  Returns
        ``None`` when there is nothing left to decide.
        """
        candidates = self.candidate_scaleouts(current_scaleout)
        if next_comp >= n_components:
            return None
        template, deltas = self.build_sweep(
            graph_builder=graph_builder, next_comp=next_comp,
            n_components=n_components, current_scaleout=current_scaleout,
            candidates=candidates, current_summary=current_summary)
        template, deltas, (c_real, k_real) = bucket_sweep(template, deltas)
        c_b = deltas["a_raw"].shape[0]
        # keyed by the REAL remaining-component count too: decision points
        # sharing a K rung but differing in real adj/mask must not thrash
        # one slot (identity-stable edges keep the service stack memo warm)
        ekey = (k_real,) + template.base["mask"].shape
        cached = self._edge_cache.get(ekey)
        if cached is not None and \
                np.array_equal(cached[0], template.base["adj"]) and \
                np.array_equal(cached[1], template.base["mask"]):
            edge_dst, edge_src, edge_valid = cached[2]
        else:
            edges = sweep_edge_list(template.base)
            self._edge_cache[ekey] = (template.base["adj"].copy(),
                                      template.base["mask"].copy(), edges)
            edge_dst, edge_src, edge_valid = edges
        template = self.template_cache.adopt(template, c_b)
        ckey = (c_b,) + tuple(candidates)
        if ckey in self._cand_cache:
            cand_arr, cand_valid = self._cand_cache[ckey]
        else:
            cand_arr = np.full(c_b, candidates[-1], np.float32)
            cand_arr[:c_real] = candidates
            cand_valid = np.zeros(c_b, bool)
            cand_valid[:c_real] = True
            self._cand_cache[ckey] = (cand_arr, cand_valid)
        return DecisionRequest(
            params=self.trainer.params, base=template.base,
            h_onehot=template.h_onehot, deltas=deltas, edge_dst=edge_dst,
            edge_src=edge_src, edge_valid=edge_valid, candidates=cand_arr,
            cand_valid=cand_valid, elapsed=float(elapsed),
            target=float(target_runtime), levels=template.levels,
            candidate_list=list(candidates), n_components=k_real,
            current_scaleout=int(current_scaleout),
            best_effort=bool(best_effort))

    def apply_decision(self, request: DecisionRequest,
                       result: DecisionResult
                       ) -> Tuple[int, float, Dict[int, float]]:
        """Record a service decision's diagnostics; returns the same
        (scaleout, predicted_total, totals) triple as :meth:`recommend`."""
        self._note_sweep(request.candidate_list, result)
        return result.scaleout, result.predicted, result.totals

    def recommend_pergraph(self, *, graph_builder: GraphBuilder,
                           next_comp: int, n_components: int, elapsed: float,
                           current_scaleout: int, target_runtime: float,
                           current_summary: Optional[NodeAttrs] = None
                           ) -> Tuple[int, float, Dict[int, float]]:
        """Original per-candidate graph-construction path (reference/bench)."""
        candidates = self.candidate_scaleouts(current_scaleout)
        totals: Dict[int, float] = {}
        remaining_idx = list(range(next_comp, n_components))
        if not remaining_idx:
            return current_scaleout, elapsed, totals

        # one vmapped forward over all (candidate x remaining-component) graphs
        all_graphs: List[ComponentGraph] = []
        for s in candidates:
            for k in remaining_idx:
                # P(k-1)/H(k-1) are predecessors of G(k)'s roots (paper Fig.3)
                preds: List[NodeAttrs] = []
                if k == next_comp and current_summary is not None:
                    preds.append(current_summary)    # P of the just-finished comp
                if k > 0:
                    h = historical_summary(self.hist_summaries.get(k - 1, []),
                                           float(s), beta=self.beta)
                    if h is not None:
                        preds.append(h)
                a = current_scaleout if k == next_comp else s
                all_graphs.append(graph_builder(k, float(a), float(s), preds))
        per_comp = self.trainer.predict(all_graphs).reshape(
            len(candidates), len(remaining_idx))
        for i, s in enumerate(candidates):
            totals[s] = elapsed + float(per_comp[i].sum())
        return self._pick(candidates, totals, target_runtime)

    @staticmethod
    def _pick(candidates: Sequence[int], totals: Dict[int, float],
              target_runtime: float) -> Tuple[int, float, Dict[int, float]]:
        feasible = [s for s in candidates if totals[s] <= target_runtime]
        if feasible:
            best = min(feasible)                 # cheapest compliant scale-out
        else:
            best = min(totals, key=totals.get)   # least violation
        return best, totals[best], totals
