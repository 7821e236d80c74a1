"""Fleet-scale decision service: shape-bucketed, cross-job batched sweeps.

Counterpart of ``repro.core.service``.  One rescaling decision is a
(template, deltas) candidate sweep (see ``core/scaling.py``).  This module
turns decisions into a batched service:

* every request arrives padded to the fixed shape ladders of
  :func:`repro_torch.core.graph.bucket_sweep`, so the whole fleet shares a
  handful of dispatch signatures instead of one per exact sweep;
* requests with the same bucket key are stacked along a job axis J
  (per-request model parameters included — each tenant keeps its own model)
  and evaluated in ONE dispatch: the sweep assembly and the sparse-edge
  engine (:func:`~repro_torch.core.model.sweep_sparse_totals_jobs`) with the
  MLPs as batched products over J;
* the compliant-scale-out pick runs on the device
  (:func:`~repro_torch.core.model.pick_candidate`); the host fetches the
  picked indices, per-candidate totals and finite-check flags in ONE
  device-to-host copy per group (the pick index and the flag packed as
  float32 beside the totals, exact below 2^24), and the (J, C, K)
  per-component diagnostics stay on the device until someone asks.

The service holds no device of its own: a group dispatches where its
requests' tensors lie, and a group whose requests lie on different devices
raises ``ValueError``.  Eager PyTorch does not compile, so
``record_trace("fleet_sweep")`` counts each new static signature (bucket
key, job rung) the service dispatches, once.

Fault tolerance (the control plane assumes the model CAN fail):

* a per-row on-device ``isfinite`` reduce
  (:func:`~repro_torch.core.model.sweep_totals_ok`) rides the pick
  transfer; rows whose valid totals are non-finite are answered by the
  bounded model-free :class:`~repro_torch.core.fallback.FallbackPolicy`;
* dispatch is wrapped in a retry envelope — capped exponential backoff with
  seeded jitter under a per-call deadline — and a :class:`CircuitBreaker`
  that trips the whole service into fallback mode after K consecutive
  failed dispatches, then half-opens on a probe cadence;
* overload shedding: above ``shed_capacity`` pending requests per call,
  excess requests — best-effort ones first — go to the fallback policy
  without touching the dispatch path.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from collections import OrderedDict, defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.fallback import FallbackPolicy
from repro_torch.core.graph import ladder_bucket
from repro_torch.core.model import (assemble_sweep_batch, pick_candidate,
                                    record_trace, stack_params,
                                    sweep_sparse_totals_jobs, sweep_totals_ok)

JOB_LADDER = (1, 2, 4, 8, 16, 32)       # job axis J (pad by repeating a row)

# service robustness counters: attribute name -> (metric family, help),
# registered in the obs registry behind the attribute API (end of module)
_SERVICE_COUNTERS = {
    "decisions": ("enel_service_decisions_total", "requests served"),
    "dispatches": ("enel_service_dispatches_total", "jit dispatches issued"),
    "batched_away": ("enel_service_batched_away_total",
                     "dispatches saved vs one-per-request"),
    "fallback_decisions": ("enel_service_fallback_decisions_total",
                           "requests answered by the fallback policy"),
    "guardrail_trips": ("enel_service_guardrail_trips_total",
                        "non-finite sweep rows caught by the guardrail"),
    "retries": ("enel_service_retries_total",
                "dispatch attempts beyond the first"),
    "dispatch_failures": ("enel_service_dispatch_failures_total",
                          "failed dispatch attempts (incl. retried)"),
    "shed_requests": ("enel_service_shed_requests_total",
                      "requests rejected under overload"),
}

# static signatures (bucket key, job rung) dispatched so far in this process
_SIGNATURES: set = set()


class DispatchFault(RuntimeError):
    """A decision dispatch failed (retryable)."""


class DispatchTimeout(DispatchFault):
    """A decision dispatch exceeded its deadline (chaos injection raises
    this; a real deployment would raise it from an RPC timer)."""


def _job_bucket(j: int) -> int:
    return ladder_bucket(j, JOB_LADDER)


def _leaves(tree) -> list:
    """Leaves of a nest of dicts (sorted keys) and lists, in a fixed order."""
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in _leaves(tree[k])]
    if isinstance(tree, list):
        return [l for v in tree for l in _leaves(v)]
    return [tree]


def _unflatten(tree, leaves):
    """Inverse of :func:`_leaves`: ``tree``'s structure over ``leaves``
    (an iterator)."""
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_unflatten(v, leaves) for v in tree]
    return next(leaves)


def _ident(leaf):
    """Memo identity of one leaf: tensors are updated in place (the
    trainer's Adam step), so their version counter is part of it."""
    if isinstance(leaf, torch.Tensor):
        return id(leaf), leaf._version
    return id(leaf)


def _stack_leaves(device: torch.device, xs) -> torch.Tensor:
    """Host leaves: one np.stack + one upload (integer indices as int64,
    what torch gathers take); device leaves: a view at J = 1, else stack."""
    if isinstance(xs[0], torch.Tensor):
        return xs[0][None] if len(xs) == 1 else torch.stack(xs)
    a = np.stack(xs)
    if np.issubdtype(a.dtype, np.integer):
        a = a.astype(np.int64)
    return torch.as_tensor(a, device=device)


def _group_device(group) -> torch.device:
    """The one device a group's tensors lie on (the CPU for host-only
    requests); several devices raise ``ValueError``."""
    devs = {l.device for r in group
            for l in _leaves([r.params, r.base, r.h_onehot])
            if isinstance(l, torch.Tensor)}
    if len(devs) > 1:
        raise ValueError("a decision group's requests lie on several "
                         f"devices: {sorted(map(str, devs))}")
    return devs.pop() if devs else torch.device("cpu")


@dataclasses.dataclass
class DecisionRequest:
    """One job's pending rescaling decision, already shape-bucketed.

    ``params`` are the tenant's model tensors; ``base``/``h_onehot`` may be
    device tensors (the scaler's template cache keeps them resident across
    decision points); ``deltas`` and the edge lists are host arrays.

    ``current_scaleout`` carries the requester's live allocation so a
    fallback answer can step FROM somewhere; ``best_effort`` marks requests
    the service may shed first under overload.
    """
    params: Dict                      # this tenant's model parameters
    base: Dict                        # (K, N, ...) template arrays
    h_onehot: object                  # (K, N)
    deltas: Dict[str, np.ndarray]     # (C, K, ...)
    edge_dst: np.ndarray              # (K, E) int32
    edge_src: np.ndarray              # (K, E) int32
    edge_valid: np.ndarray            # (K, E) bool
    candidates: np.ndarray            # (C,) float32, padded ascending
    cand_valid: np.ndarray            # (C,) bool
    elapsed: float
    target: float
    levels: int
    candidate_list: List[int]         # the real candidate scale-outs
    n_components: int                 # real K (pre-padding)
    current_scaleout: int = 0         # requester's live allocation
    best_effort: bool = False         # sheddable under overload

    @property
    def bucket_key(self):
        k, n = self.h_onehot.shape
        return (len(self.candidates), k, n, self.edge_dst.shape[1],
                self.levels)


class DecisionResult:
    """Pick + totals (fetched in one transfer); per-component preds lazy.

    ``service_seconds`` is this request's amortized share of the service
    call that produced it — the runner bills it to the run's decision
    latency.  ``fallback``/``shed`` flag decisions the model did not make:
    answered by the heuristic policy (guardrail trip, breaker open, retries
    exhausted) or rejected under overload, respectively.
    """

    def __init__(self, scaleout: int, predicted: float,
                 totals: Dict[int, float],
                 per_component_dev: Optional[torch.Tensor],
                 n_candidates: int, n_components: int):
        self.scaleout = scaleout
        self.predicted = predicted
        self.totals = totals
        self.service_seconds = 0.0
        self.fallback = False
        self.shed = False
        self._per_dev = per_component_dev       # (C_bucket, K_bucket) device
        self._shape = (n_candidates, n_components)
        self._per_np: Optional[np.ndarray] = None

    @property
    def per_component(self) -> np.ndarray:
        """(C, K) per-component predictions; device->host on first access.
        Fallback decisions carry no sweep: their diagnostics read as 0."""
        if self._per_np is None:
            if self._per_dev is None:
                self._per_np = np.zeros(self._shape, np.float32)
            else:
                c, k = self._shape
                self._per_np = self._per_dev.cpu().numpy()[:c, :k]
        return self._per_np


@torch.no_grad()
def _fleet_eval(params, base, h_onehot, deltas, edge_dst, edge_src,
                edge_valid, cand, cand_valid, elapsed, target, levels):
    """Job-axis evaluation: assemble + sparse sweep + on-device pick.

    Every argument carries a leading job axis J.  Returns per job row (pick
    index, per-candidate totals, (C, K) per-component predictions,
    finite-totals ok flag).
    """
    j, c, k = deltas["a_raw"].shape[:3]
    flat = assemble_sweep_batch(base, h_onehot, deltas)
    tile = lambda a: a[:, None].expand(j, c, k, a.shape[-1]).reshape(
        j, c * k, a.shape[-1])
    per = sweep_sparse_totals_jobs(params, flat, tile(edge_dst),
                                   tile(edge_src), tile(edge_valid),
                                   levels).reshape(j, c, k)
    totals = per.sum(dim=2) + elapsed[:, None]
    idx = pick_candidate(cand, cand_valid, totals, target)
    ok = sweep_totals_ok(totals, cand_valid)
    return idx, totals, per, ok


def sweep_eval_one(p, b, oh, d, ed, es, ev, cd, cv, el, tg, levels):
    """One job's sweep: assemble + sparse totals + on-device compliant pick,
    through the same ops the service dispatches at J = 1.

    Tensors as in :class:`DecisionRequest` (``el``/``tg`` 0-d).  Returns
    (pick index, per-candidate totals, (C, K) per-component predictions,
    finite-totals ok flag).
    """
    one = lambda t: {k: v[None] for k, v in t.items()}
    out = _fleet_eval(stack_params(p), one(b), oh[None], one(d),
                      ed.long()[None], es.long()[None], ev[None], cd[None],
                      cv[None], el.reshape(1), tg.reshape(1), levels)
    return tuple(o[0] for o in out)


def apply_capacity(request: DecisionRequest, max_scaleout: int
                   ) -> DecisionRequest:
    """Capacity-capped pick: mask candidates above ``max_scaleout`` (a
    multi-tenant executor-pool constraint) so the on-device compliant pick
    can only choose a scale-out the shrunken pool can actually grant.

    Returns ``request`` unchanged when the cap does not bind.  If the cap
    excludes every candidate, the smallest valid candidate stays eligible.
    """
    over = request.cand_valid & (request.candidates > max_scaleout)
    if not over.any():
        return request
    cv = request.cand_valid & ~over
    if not cv.any():
        lo = request.candidates[request.cand_valid].min()
        cv = request.cand_valid & (request.candidates <= lo)
    return dataclasses.replace(request, cand_valid=cv)


class CircuitBreaker:
    """Dispatch-path circuit breaker: CLOSED -> OPEN after ``threshold``
    consecutive failed dispatch calls; OPEN serves every request from the
    fallback policy; after ``probe_after`` blocked calls the breaker
    HALF-OPENs and lets one probe call through — success closes it,
    failure re-opens (counting another trip)."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, threshold: int = 3, probe_after: int = 4,
                 name: str = "breaker"):
        self.threshold = int(threshold)
        self.probe_after = int(probe_after)
        self.name = name
        self.state = self.CLOSED
        self.consecutive_failures = 0
        self._blocked_calls = 0
        self.last_transition_seq = -1   # flight-recorder seq of last flip
        reg = obs.registry()
        self._trips = reg.counter(
            "enel_breaker_trips_total",
            "breaker transitions into OPEN").labels(service=name)
        self._state_gauge = reg.gauge(
            "enel_breaker_state",
            "1 for the current breaker state, 0 otherwise")
        self._sync_state_gauge()

    @property
    def trips(self) -> int:
        return int(self._trips.value)

    @trips.setter
    def trips(self, v: int) -> None:
        self._trips.set(v)

    def _sync_state_gauge(self) -> None:
        for s in (self.CLOSED, self.OPEN, self.HALF_OPEN):
            self._state_gauge.labels(service=self.name, state=s).set(
                1.0 if s == self.state else 0.0)

    def _transition(self, new_state: str, reason: str) -> None:
        if new_state == self.state:
            return
        self.last_transition_seq = obs.emit(
            "breaker.transition", service=self.name,
            src=self.state, dst=new_state, reason=reason,
            trips=self.trips, failures=self.consecutive_failures)
        self.state = new_state
        self._sync_state_gauge()

    def allow(self) -> bool:
        """One call per service decide(): may this call dispatch?"""
        if self.state == self.OPEN:
            self._blocked_calls += 1
            if self._blocked_calls >= self.probe_after:
                self._transition(self.HALF_OPEN, "probe_window")
            return False
        return True                     # closed, or half-open (the probe)

    def record(self, success: bool) -> None:
        if success:
            self.consecutive_failures = 0
            self._transition(self.CLOSED, "dispatch_ok")
            return
        self.consecutive_failures += 1
        if self.state == self.HALF_OPEN or \
                self.consecutive_failures >= self.threshold:
            reason = ("probe_failed" if self.state == self.HALF_OPEN
                      else "failure_threshold")
            self._blocked_calls = 0
            self.trips += 1
            self._transition(self.OPEN, reason)

    def snapshot(self) -> Dict:
        return {"state": self.state,
                "consecutive_failures": self.consecutive_failures,
                "trips": self.trips,
                "blocked_calls": self._blocked_calls,
                "last_transition_seq": self.last_transition_seq}

    def restore(self, st: Dict) -> None:
        self.state = st["state"]
        self.consecutive_failures = st["consecutive_failures"]
        self.trips = st["trips"]
        self._blocked_calls = st["blocked_calls"]
        self.last_transition_seq = st.get("last_transition_seq", -1)
        self._sync_state_gauge()        # registry labels track restored state


class DecisionService:
    """Collects concurrent decision requests and dispatches them batched.

    ``decide`` groups requests by bucket key, pads each group to a
    JOB_LADDER rung along the job axis, evaluates every group in one
    dispatch and fetches each group's picks, totals and ok flags in a
    single host copy.

    Dispatch is double-buffered by default: every group is stacked and
    enqueued on the current stream first (PyTorch's launches return before
    the device finishes), and the host copies are fetched in a second pass
    — so host stacking of the next bucket overlaps device compute of the
    current one.  ``double_buffer=False`` restores the synchronous
    stack -> dispatch -> fetch loop; both give bit-equal decisions.

    Failure envelope: each group dispatch retries up to ``max_retries``
    times under capped exponential backoff with seeded jitter, bounded by
    ``deadline_s`` per decide() call; consecutive decide() calls whose
    dispatches fail trip the :class:`CircuitBreaker` into fallback-for-all
    mode.  Rows whose predictions come back non-finite are answered by the
    :class:`~repro_torch.core.fallback.FallbackPolicy` WITHOUT tripping the
    breaker (a poisoned tenant model is a per-row condition, not a service
    outage).  ``fault_injector`` is the chaos hook: a callable invoked once
    per dispatch attempt that may raise :class:`DispatchFault`.
    """

    _ids = itertools.count()        # default obs label allocator

    def __init__(self, double_buffer: bool = True, *,
                 fallback: Optional[FallbackPolicy] = None,
                 max_retries: int = 2, backoff_base_s: float = 0.02,
                 backoff_cap_s: float = 0.25,
                 deadline_s: Optional[float] = None,
                 breaker_threshold: int = 3, breaker_probe_after: int = 4,
                 shed_capacity: Optional[int] = None, seed: int = 0,
                 obs_name: Optional[str] = None):
        self.double_buffer = double_buffer
        self.fallback = fallback or FallbackPolicy()
        self.max_retries = int(max_retries)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self.deadline_s = deadline_s
        # obs_name keys this instance's registry series; pass a stable name
        # to make a restored-from-checkpoint service label-identical.
        self.obs_name = obs_name or f"svc{next(self._ids)}"
        reg = obs.registry()
        self._obs_counters = {
            attr: reg.counter(family, help).labels(service=self.obs_name)
            for attr, (family, help) in _SERVICE_COUNTERS.items()}
        self.breaker = CircuitBreaker(breaker_threshold, breaker_probe_after,
                                      name=self.obs_name)
        self.shed_capacity = shed_capacity
        self.fault_injector = None      # chaos hook (see repro_torch.sim.chaos)
        self._rng = np.random.RandomState(seed ^ 0xbac0ff)  # backoff jitter
        # memoized stacks: params, template-base tensors and edge lists are
        # object-stable across decision rounds (the scalers' caches re-serve
        # the same objects while values are unchanged), so their (J, ...)
        # stacks are reused instead of re-stacked per round.  Tensor leaves
        # are keyed on their version counter too: a fit updates the params
        # in place.  LRU-bounded.
        self._stack_memo: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._stack_memo_slots = 64

    @property
    def breaker_trips(self) -> int:
        return self.breaker.trips

    def _stack_tree(self, cache_key: tuple, rows, get, device):
        trees = [get(r) for r in rows]
        all_leaves = [_leaves(t) for t in trees]
        ids = tuple(_ident(l) for row in all_leaves for l in row)
        hit = self._stack_memo.get(cache_key)
        if hit is not None and hit[0] == ids:
            self._stack_memo.move_to_end(cache_key)
            return hit[2]
        stacked = _unflatten(trees[0], iter(
            [_stack_leaves(device, col) for col in zip(*all_leaves)]))
        # keep the leaf refs alive so the memo's ids cannot be recycled
        self._stack_memo[cache_key] = (ids, all_leaves, stacked)
        while len(self._stack_memo) > self._stack_memo_slots:
            self._stack_memo.popitem(last=False)
        return stacked

    def _dispatch_group(self, key: tuple, group: List[DecisionRequest]):
        """Stack one bucket group and enqueue its evaluation; returns the
        packed (J, 2 + C) [pick, totals, ok] tensor and the (J, C, K)
        per-component predictions, both on the group's device."""
        if self.fault_injector is not None:
            self.fault_injector()       # chaos: may raise DispatchFault
        device = _group_device(group)
        j_b = _job_bucket(len(group))
        if (key, j_b) not in _SIGNATURES:
            _SIGNATURES.add((key, j_b))
            record_trace("fleet_sweep")
        rows = group + [group[-1]] * (j_b - len(group))
        memo = lambda name, get: self._stack_tree((key, j_b, name), rows,
                                                  get, device)
        deltas = {k: _stack_leaves(device, [r.deltas[k] for r in rows])
                  for k in rows[0].deltas}
        scalars = torch.as_tensor(
            np.array([[r.elapsed, r.target] for r in rows], np.float32),
            device=device)
        idx, totals, per, ok = _fleet_eval(
            memo("params", lambda r: r.params),
            memo("base", lambda r: r.base),
            memo("h_onehot", lambda r: r.h_onehot), deltas,
            memo("edge_dst", lambda r: r.edge_dst),
            memo("edge_src", lambda r: r.edge_src),
            memo("edge_valid", lambda r: r.edge_valid),
            memo("candidates", lambda r: r.candidates),
            memo("cand_valid", lambda r: r.cand_valid),
            scalars[:, 0], scalars[:, 1], group[0].levels)
        packed = torch.cat([idx.to(totals.dtype)[:, None], totals,
                            ok.to(totals.dtype)[:, None]], dim=1)
        self.dispatches += 1
        self.batched_away += len(group) - 1
        return packed, per

    # ------------------------------------------------------ failure envelope
    def _fallback_result(self, req: DecisionRequest,
                         totals_row: Optional[np.ndarray] = None,
                         shed: bool = False, cause: str = "guardrail",
                         cause_seq: int = -1) -> DecisionResult:
        """Answer one request from the bounded heuristic policy.

        ``cause`` names why the model did not answer (shed, breaker_open,
        retries_exhausted, guardrail); ``cause_seq`` links the span to the
        flight-recorder event that forced the fallback."""
        totals = None
        if totals_row is not None:
            totals = {s: float(totals_row[ci])
                      for ci, s in enumerate(req.candidate_list)}
        s, pred = self.fallback.decide(
            req.candidate_list, totals, req.current_scaleout,
            req.elapsed, req.target)
        res = DecisionResult(
            scaleout=int(s), predicted=pred,
            totals=self.fallback._finite_totals(req.candidate_list, totals),
            per_component_dev=None,
            n_candidates=len(req.candidate_list),
            n_components=req.n_components)
        res.fallback = True
        res.shed = shed
        self.fallback_decisions += 1
        if shed:
            self.shed_requests += 1
        obs.emit("decision.fallback", service=self.obs_name, cause=cause,
                 cause_seq=cause_seq, shed=shed, scaleout=int(s),
                 from_scaleout=int(req.current_scaleout))
        return res

    def _dispatch_with_retry(self, key: tuple,
                             group: List[DecisionRequest],
                             t_start: float, deadline: Optional[float]):
        """Dispatch one group under the retry/backoff/deadline envelope;
        returns (dispatch output or None when the envelope is exhausted,
        retries used, flight-recorder seq of the last fault span)."""
        attempt = 0
        fault_seq = -1
        while True:
            try:
                return self._dispatch_group(key, group), attempt, fault_seq
            except DispatchFault as e:
                self.dispatch_failures += 1
                fault_seq = obs.emit(
                    "dispatch.fault", service=self.obs_name,
                    bucket=str(key), group=len(group), attempt=attempt,
                    fault=type(e).__name__)
                sleep = min(self.backoff_cap_s,
                            self.backoff_base_s * (2 ** attempt))
                sleep *= 0.5 + self._rng.rand()     # seeded jitter
                if attempt >= self.max_retries or (
                        deadline is not None and
                        time.perf_counter() - t_start + sleep > deadline):
                    return None, attempt, fault_seq
                time.sleep(sleep)
                self.retries += 1
                attempt += 1

    def _shed(self, requests: Sequence[DecisionRequest],
              results: List[Optional[DecisionResult]]) -> List[int]:
        """Admission control: above ``shed_capacity`` pending requests,
        reject the excess — best-effort requests first, newest first —
        straight to the fallback policy.  Returns the surviving indices."""
        live = list(range(len(requests)))
        if self.shed_capacity is None or len(live) <= self.shed_capacity:
            return live
        excess = len(live) - int(self.shed_capacity)
        order = [i for i in reversed(live) if requests[i].best_effort] + \
                [i for i in reversed(live) if not requests[i].best_effort]
        for i in order[:excess]:
            results[i] = self._fallback_result(requests[i], shed=True)
        return [i for i in live if results[i] is None]

    def decide(self, requests: Sequence[DecisionRequest]
               ) -> List[DecisionResult]:
        t_start = time.perf_counter()
        results: List[Optional[DecisionResult]] = [None] * len(requests)
        live = self._shed(requests, results)
        if live and not self.breaker.allow():       # open: fallback for all
            for i in live:
                results[i] = self._fallback_result(
                    requests[i], cause="breaker_open",
                    cause_seq=self.breaker.last_transition_seq)
            live = []
        groups: Dict[tuple, List[int]] = defaultdict(list)
        for i in live:
            groups[requests[i].bucket_key].append(i)
        staged = []
        dispatch_ok = True
        for key, idxs in groups.items():
            out, retried, fault_seq = self._dispatch_with_retry(
                key, [requests[i] for i in idxs], t_start, self.deadline_s)
            if out is None:                         # envelope exhausted
                dispatch_ok = False
                for i in idxs:
                    results[i] = self._fallback_result(
                        requests[i], cause="retries_exhausted",
                        cause_seq=fault_seq)
                continue
            packed, per = out
            if not self.double_buffer:
                # synchronous mode: fetch before stacking the next bucket
                packed = packed.cpu()
            staged.append((idxs, key, retried, packed, per))
        for idxs, key, retried, packed, per in staged:
            # ONE host copy per group: picks + totals + ok flags
            host = packed.cpu().numpy()
            picked_np, totals_np, ok_np = host[:, 0], host[:, 1:-1], \
                host[:, -1]
            obs.emit("decision.dispatch", service=self.obs_name,
                     bucket=str(key), group=len(idxs), retries=retried,
                     latency_s=round(time.perf_counter() - t_start, 6))
            for gi, ri in enumerate(idxs):
                req = requests[ri]
                if not ok_np[gi]:           # guardrail: poisoned sweep row
                    self.guardrail_trips += 1
                    trip_seq = obs.emit(
                        "guardrail.trip", service=self.obs_name,
                        bucket=str(key), row=gi)
                    results[ri] = self._fallback_result(
                        req, totals_row=totals_np[gi], cause="guardrail",
                        cause_seq=trip_seq)
                    continue
                sl = int(picked_np[gi])
                tot = {s: float(totals_np[gi, ci])
                       for ci, s in enumerate(req.candidate_list)}
                results[ri] = DecisionResult(
                    scaleout=req.candidate_list[sl],
                    predicted=float(totals_np[gi, sl]), totals=tot,
                    per_component_dev=per[gi],
                    n_candidates=len(req.candidate_list),
                    n_components=req.n_components)
        if groups:
            self.breaker.record(dispatch_ok)
        self.decisions += len(requests)
        if requests:
            share = (time.perf_counter() - t_start) / len(requests)
            for r in results:
                r.service_seconds = share
            if obs.enabled():
                hist = obs.registry().histogram(
                    "enel_decision_latency_seconds",
                    "per-request share of decide() wall time"
                ).labels(service=self.obs_name)
                for _ in requests:
                    hist.observe(share)
        return results

    # ----------------------------------------------------------- telemetry
    def stats(self) -> Dict:
        """All robustness counters + breaker state as one plain dict."""
        out = {attr: getattr(self, attr) for attr in _SERVICE_COUNTERS}
        out["breaker_trips"] = self.breaker_trips
        out["breaker_state"] = self.breaker.state
        return out

    # --------------------------------------------------- checkpoint support
    def snapshot_state(self) -> Dict:
        """Counters + breaker + jitter-RNG state for checkpoints (the stack
        memo is a pure performance cache and is rebuilt)."""
        st = {attr: getattr(self, attr) for attr in _SERVICE_COUNTERS}
        st["breaker"] = self.breaker.snapshot()
        st["rng"] = self._rng.get_state()
        if self.fault_injector is not None and \
                hasattr(self.fault_injector, "snapshot"):
            st["fault_injector"] = self.fault_injector.snapshot()
        return st

    def restore_state(self, st: Dict) -> None:
        for attr in _SERVICE_COUNTERS:
            setattr(self, attr, st[attr])
        self.breaker.restore(st["breaker"])
        self._rng.set_state(st["rng"])
        if "fault_injector" in st and self.fault_injector is not None and \
                hasattr(self.fault_injector, "restore"):
            self.fault_injector.restore(st["fault_injector"])


# the counters live in the obs registry, behind the attribute API
# (``svc.retries``, ``svc.decisions += 1`` ...)
obs.registry_attributes(DecisionService, _SERVICE_COUNTERS)
