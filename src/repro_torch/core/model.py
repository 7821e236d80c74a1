"""Enel's graph-propagation prediction model (paper §III-D, eqs. 3-7), PyTorch.

Four 2-layer MLPs (f1..f4) + a GATv2-style attention vector define a spatial
GNN over padded component DAGs:

  eq.6  |e_ij| = softmax_j( a^T sigma( f3(x_i, x_j) ) ),  x = a_vec‖c‖z_vec
  eq.7  m_hat_i = sum_j |e_ij| * f4( f3(x_i,x_j), m_j )   (metric propagation)
  eq.3  o_hat_i = f1(c_i, m_i, a_vec_i, z_vec_i, r_i)     (rescale overhead)
  eq.4  t_hat_i = f2(c_i, m_i, z_vec_i, o_hat_i)          (node runtime)
  eq.5  tt_hat_i = t_hat_i + max_{j in N(i)} tt_hat_j     (critical path)

Counterpart of ``repro.core.model``.  Parameters are a plain dict of float32
tensors with the reference's structure and ``(in, out)`` weight layout
(``{"f1".."f4": [{"w", "b"}, {"w", "b"}], "attn_a"}``).  Every function
takes stacked (B, N, ...) graphs; ``forward`` is the B = 1 case.

Routing of eqs. 6-7 in :func:`forward_stacked`: CUDA tensors always go
through :func:`repro_torch.kernels.graph_prop.ops.graph_prop` (the CUDA
kernel, differentiable through the backward kernel when grad is on).  On
the CPU ``use_kernel`` picks between that op's plain version and the inline
:func:`_propagate`; both are plain PyTorch there.

The fleet decision service evaluates its sweeps with the sparse-edge engine
:func:`sweep_sparse_totals_jobs` instead: plain PyTorch ops over padded
(dst, src) edge lists, with per-job parameters stacked on a leading job
axis J, as the reference's ``sweep_sparse_totals`` is plain ``jnp``.
"""
from __future__ import annotations

import math
from collections import Counter
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.graph import CTX_DIM, N_METRICS
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.graph_prop.ops import graph_prop

HIDDEN = 32
EDGE_DIM = 16
X_DIM = 3 + CTX_DIM + 3          # a_vec ‖ c ‖ z_vec
MAX_LEVELS = 8                   # longest DAG chain the propagation supports

Params = Dict

# ------------------------------------------------------- signature counter
# The reference counts jit traces; eager PyTorch does not compile, so the
# decision service calls ``record_trace`` once per distinct static signature
# it dispatches (bucket key, job rung): the count of shapes the decision path
# specialises on, which shape bucketing keeps bounded.
TRACE_COUNTS: Counter = Counter()


def record_trace(name: str) -> None:
    TRACE_COUNTS[name] += 1
    # mirrored into the obs registry; TRACE_COUNTS stays the canonical API
    from repro_torch import obs
    if obs.enabled():
        obs.registry().counter(
            "enel_jit_traces_total", "jit retraces per instrumented fn"
        ).labels(fn=name).inc()


def trace_count(name: str) -> int:
    return TRACE_COUNTS[name]


def reset_trace_counts() -> None:
    TRACE_COUNTS.clear()


def _leaky(z: torch.Tensor) -> torch.Tensor:
    """leaky_relu(z, 0.1) with the reference's z >= 0 branch."""
    return torch.where(z >= 0, z, 0.1 * z)


def _mlp_init(generator: torch.Generator, dims, dev: torch.device):
    layers = []
    for i, o in zip(dims[:-1], dims[1:]):
        w = torch.randn(i, o, generator=generator, dtype=torch.float32)
        layers.append({"w": (w / math.sqrt(i)).to(dev),
                       "b": torch.zeros(o, dtype=torch.float32, device=dev)})
    return layers


def _mlp(layers, x: torch.Tensor, final_linear: bool = True) -> torch.Tensor:
    for li, l in enumerate(layers):
        x = x @ l["w"] + l["b"]
        if li < len(layers) - 1 or not final_linear:
            x = _leaky(x)
    return x


def init_enel(generator: torch.Generator,
              device: DeviceLike = "cuda") -> Params:
    """Fresh parameters, drawn on the CPU from ``generator`` (so a seed gives
    the same weights on every device) and moved to ``device``."""
    dev = resolve_device(device)
    return {
        # eq.3: f1(c, m, a_vec, z_vec, r) -> overhead
        "f1": _mlp_init(generator,
                        [CTX_DIM + N_METRICS + 3 + 3 + 1, HIDDEN, 1], dev),
        # eq.4: f2(c, m, z_vec, o_hat) -> runtime
        "f2": _mlp_init(generator, [CTX_DIM + N_METRICS + 3 + 1, HIDDEN, 1],
                        dev),
        # eq.6: f3(x_i, x_j) -> edge hidden
        "f3": _mlp_init(generator, [2 * X_DIM, HIDDEN, EDGE_DIM], dev),
        # eq.7: f4(edge hidden, m_j) -> propagated metrics
        "f4": _mlp_init(generator, [EDGE_DIM + N_METRICS, HIDDEN, N_METRICS],
                        dev),
        "attn_a": (torch.randn(EDGE_DIM, generator=generator,
                               dtype=torch.float32) / 4.0).to(dev),
    }


def n_params(params: Params) -> int:
    return sum(l["w"].numel() + l["b"].numel()
               for k in ("f1", "f2", "f3", "f4") for l in params[k]) + \
        params["attn_a"].numel()


def scaleout_vec(s: torch.Tensor) -> torch.Tensor:
    s = torch.clamp_min(s, 1e-6)
    return torch.stack([1.0 - 1.0 / s, torch.log(s), s], dim=-1)


def _prelude(g: Dict[str, torch.Tensor]):
    """Shared input lift over stacked (B, N, ...) graphs."""
    a_vec = scaleout_vec(g["a_raw"])
    z_vec = scaleout_vec(g["z_raw"])
    x = torch.cat([a_vec, g["context"], z_vec], dim=-1)
    adj = g["adj"] & g["mask"][..., None, :] & g["mask"][..., :, None]
    return a_vec, z_vec, x, adj


def edge_weights(params: Params, x: torch.Tensor, adj: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """eq.6: masked softmax over predecessors.  x (B, N, X), adj (B, N, N)
    bool; returns (e (B, N, N), h3 (B, N, N, E)); i = dst, j = src."""
    b, n, xd = x.shape
    xi = x[:, :, None, :].expand(b, n, n, xd)
    xj = x[:, None, :, :].expand(b, n, n, xd)
    h3 = _mlp(params["f3"], torch.cat([xi, xj], dim=-1))
    logits = _leaky(h3) @ params["attn_a"]
    logits = torch.where(adj, logits, torch.full_like(logits, -1e30))
    has_pred = adj.any(dim=-1, keepdim=True)
    e = torch.softmax(logits, dim=-1)
    return torch.where(has_pred, e, torch.zeros_like(e)), h3


def _propagate(params: Params, x, adj, m_obs, valid,
               levels: int = MAX_LEVELS) -> Tuple[torch.Tensor, torch.Tensor]:
    """eqs. 6-7 inline: edge weights + level-synchronous metric propagation
    (observed metrics are fixed inputs).  Returns (e, m_hat).

    ``levels`` may be lowered to the graphs' DAG depth: propagation reaches
    its fixed point after ``depth`` rounds, so fewer rounds are exact.
    """
    e, h3 = edge_weights(params, x, adj)
    w0, b0 = params["f4"][0]["w"], params["f4"][0]["b"]
    pre_h = h3 @ w0[:EDGE_DIM]                               # (B, N, N, H)
    w_m = w0[EDGE_DIM:]
    f4_tail = params["f4"][1:]
    keep = valid[..., None]
    m_cur = m_obs
    for _ in range(levels):
        mj = torch.where(keep, m_obs, m_cur)                    # (B, N, M)
        hidden = _leaky(pre_h + (mj @ w_m)[:, None, :, :] + b0)
        msg = _mlp(f4_tail, hidden)                              # (B,N,N,M)
        m_prop = torch.einsum("bij,bijm->bim", e, msg)
        m_cur = torch.where(keep, m_obs, m_prop)
    return e, m_cur


def _readout(params: Params, g: Dict[str, torch.Tensor], a_vec, z_vec, adj,
             e, m_hat, levels: int = MAX_LEVELS) -> Dict[str, torch.Tensor]:
    """eqs. 3-5 given propagated metrics and edge weights.

    ``levels`` bounds the eq.5 accumulation rounds; the longest real-edge
    chain never exceeds the propagation depth, so a depth-lowered value is
    exact.
    """
    valid = g["metrics_valid"]
    m_used = torch.where(valid[..., None], g["metrics"], m_hat)

    # eq.3 overhead
    f1_in = torch.cat([g["context"], m_used, a_vec, z_vec, g["r"][..., None]],
                      dim=-1)
    o_hat = _mlp(params["f1"], f1_in)[..., 0]

    # eq.4 runtime (end scale-out only + predicted overhead)
    f2_in = torch.cat([g["context"], m_used, z_vec, o_hat[..., None]], dim=-1)
    f2_out = _mlp(params["f2"], f2_in)[..., 0]
    t_hat = torch.logaddexp(f2_out, torch.zeros_like(f2_out))   # softplus

    # eq.5 accumulated runtime over the DAG (summary nodes excluded)
    real = g["mask"] & ~g["is_summary"]
    t_node = torch.where(real, t_hat, torch.zeros_like(t_hat))
    real_edge = adj & ~g["is_summary"][..., None, :]   # drop summary precedents
    zero = torch.zeros((), dtype=t_hat.dtype, device=t_hat.device)
    tt_hat = t_node
    for _ in range(levels):
        pred_best = torch.where(real_edge, tt_hat[..., None, :], zero).amax(-1)
        tt_hat = t_node + pred_best
    tt_hat = torch.where(real, tt_hat, zero)

    return {"overhead": o_hat, "runtime": t_hat, "acc_runtime": tt_hat,
            "metrics": m_hat, "edges": e,
            "total_runtime": tt_hat.amax(-1)}


def forward_stacked(params: Params, batch: Dict[str, torch.Tensor],
                    use_kernel: Optional[bool] = None,
                    levels: int = MAX_LEVELS) -> Dict[str, torch.Tensor]:
    """Batched inference over stacked (B, N, ...) graph tensors.

    eqs. 6-7 run in the ``graph_prop`` op whenever the tensors lie on a card
    (its CUDA kernel), and on the CPU when ``use_kernel`` is true (its plain
    version); otherwise inline.
    """
    a_vec, z_vec, x, adj = _prelude(batch)
    if x.device.type != "cpu" or use_kernel:
        e, m_hat = graph_prop(params, x, adj, batch["metrics"],
                              batch["metrics_valid"], levels=levels)
    else:
        e, m_hat = _propagate(params, x, adj, batch["metrics"],
                              batch["metrics_valid"], levels)
    return _readout(params, batch, a_vec, z_vec, adj, e, m_hat, levels)


def forward(params: Params, g: Dict[str, torch.Tensor],
            levels: int = MAX_LEVELS) -> Dict[str, torch.Tensor]:
    """Full propagation over one padded graph (dict of (N, ...) tensors)."""
    out = forward_stacked(params, {k: v[None] for k, v in g.items()},
                          levels=levels)
    return {k: v[0] for k, v in out.items()}


def predict_total_runtime(params: Params, graphs: Dict[str, torch.Tensor],
                          use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Total predicted runtime per component graph in a stacked batch."""
    return forward_stacked(params, graphs, use_kernel)["total_runtime"]


# ------------------------------------------------------------ candidate sweep
def assemble_sweep_batch(base: Dict[str, torch.Tensor], h_onehot, deltas
                         ) -> Dict[str, torch.Tensor]:
    """Template + per-candidate deltas -> flat stacked (C*K, N, ...) batch.

    Shapes (any leading axes, e.g. the service's job axis J, carry through
    to ``(..., C*K, N, ...)``):

      base[...]           (..., K, N, ...)   candidate-invariant template
      h_onehot            (..., K, N)        H-summary slot indicator
      deltas["a_raw"|"z_raw"|"r"|"metrics_valid"]   (..., C, K, N)
      deltas["h_context"] (..., C, K, CTX)   per-candidate H-node context
      deltas["h_metrics"] (..., C, K, M)     per-candidate H-node metrics
    """
    lead = tuple(deltas["a_raw"].shape[:-3])
    c, k = deltas["a_raw"].shape[-3:-1]
    n = base["mask"].shape[-1]
    oh = h_onehot.unsqueeze(-3).unsqueeze(-1)               # (.., 1, K, N, 1)
    ctx = (base["context"].unsqueeze(-4) * (1.0 - oh) +
           oh * deltas["h_context"].unsqueeze(-2))
    met = (base["metrics"].unsqueeze(-4) * (1.0 - oh) +
           oh * deltas["h_metrics"].unsqueeze(-2))
    batch = {
        "context": ctx, "metrics": met,
        "metrics_valid": deltas["metrics_valid"],
        "a_raw": deltas["a_raw"], "z_raw": deltas["z_raw"],
        "r": deltas["r"],
        "adj": base["adj"].unsqueeze(-4).expand(lead + (c, k, n, n)),
        "mask": base["mask"].unsqueeze(-3).expand(lead + (c, k, n)),
        "is_summary": base["is_summary"].unsqueeze(-3).expand(
            lead + (c, k, n)),
    }
    return {key: v.reshape(lead + (c * k,) + tuple(v.shape[len(lead) + 2:]))
            for key, v in batch.items()}


def sweep_per_component(params: Params, base: Dict[str, torch.Tensor],
                        h_onehot: torch.Tensor,
                        deltas: Dict[str, torch.Tensor],
                        use_kernel: Optional[bool] = None,
                        levels: int = MAX_LEVELS) -> torch.Tensor:
    """Assemble every (candidate x component) graph from template + deltas
    on the device and evaluate them in one batch -> totals (C, K)."""
    c, k = deltas["a_raw"].shape[:2]
    flat = assemble_sweep_batch(base, h_onehot, deltas)
    total = forward_stacked(params, flat, use_kernel=use_kernel,
                            levels=levels)
    return total["total_runtime"].reshape(c, k)


# ------------------------------------------------------ sparse-edge engine
# The component DAGs are near-chains: a graph holds a handful of real edges,
# yet the dense engine evaluates f3/f4 on all N x N node pairs and masks the
# rest away.  The decision service instead gathers the real (dst, src) pairs
# into padded (B, E) edge lists and runs eqs. 6-7 over them, with edge->node
# sums and maxes as one-hot broadcast reductions over the small edge axis and
# node->edge reads as gathers: the reference's math on the real edges (the
# dense path's masked pairs contribute exact zeros), at E/N^2 of the pair
# work.  Every tensor carries a leading job axis J, parameters included
# (each tenant keeps its own model): the MLPs are batched products over J.

def _mlp_jobs(layers, x: torch.Tensor,
              final_linear: bool = True) -> torch.Tensor:
    """:func:`_mlp` with per-job weights: x (J, ..., in), w (J, in, out),
    b (J, out)."""
    for li, l in enumerate(layers):
        j, d_in = x.shape[0], x.shape[-1]
        y = torch.bmm(x.reshape(j, -1, d_in), l["w"]) + l["b"][:, None, :]
        x = y.reshape(tuple(x.shape[:-1]) + (y.shape[-1],))
        if li < len(layers) - 1 or not final_linear:
            x = _leaky(x)
    return x


def _gather_nodes(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of ``t`` (J, B, N[, F]) at node indices ``idx`` (J, B, E) ->
    (J, B, E[, F])."""
    if t.dim() == idx.dim():
        return torch.gather(t, 2, idx)
    return torch.gather(
        t, 2, idx[..., None].expand(tuple(idx.shape) + (t.shape[-1],)))


def sweep_sparse_totals_jobs(params: Params, flat: Dict[str, torch.Tensor],
                             edge_dst: torch.Tensor, edge_src: torch.Tensor,
                             edge_valid: torch.Tensor,
                             levels: int = MAX_LEVELS) -> torch.Tensor:
    """Total predicted runtime per graph, sparse, for J jobs at once.

    ``params`` has every leaf stacked on a leading job axis J; ``flat``
    holds (J, B, N, ...) graph tensors (``adj`` unused); ``edge_dst`` /
    ``edge_src`` (int64) / ``edge_valid`` are (J, B, E) padded edge lists
    (j -> i edges as (dst=i, src=j)).  Returns (J, B) totals.
    """
    n = flat["mask"].shape[-1]
    a_vec = scaleout_vec(flat["a_raw"])
    z_vec = scaleout_vec(flat["z_raw"])
    x = torch.cat([a_vec, flat["context"], z_vec], dim=-1)
    nodes = torch.arange(n, device=edge_dst.device)
    oh_dst = (edge_dst[..., None] == nodes) & edge_valid[..., None]
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    oh_dst_f = torch.where(oh_dst, 1.0, zero)               # (J, B, E, N)

    # eq.6 on real edges only: masked softmax over each node's predecessors
    xe = torch.cat([_gather_nodes(x, edge_dst), _gather_nodes(x, edge_src)],
                   dim=-1)
    h3 = _mlp_jobs(params["f3"], xe)                        # (J, B, E, ED)
    logits = torch.einsum("jbef,jf->jbe", _leaky(h3), params["attn_a"])
    lmax = torch.where(oh_dst, logits[..., None], -math.inf).amax(dim=2)
    lmax = torch.where(torch.isfinite(lmax), lmax, zero)    # no-pred nodes
    lm_e = _gather_nodes(lmax, edge_dst)
    w = torch.where(edge_valid, torch.exp(logits - lm_e), zero)
    den = (oh_dst_f * w[..., None]).sum(dim=2)              # (J, B, N)
    den_e = _gather_nodes(den, edge_dst)
    e = w / torch.where(den_e > 0, den_e, torch.ones_like(den_e))

    # eq.7 level-synchronous propagation via per-edge messages
    w0, b0 = params["f4"][0]["w"], params["f4"][0]["b"]
    j = w0.shape[0]
    pre_h = torch.bmm(h3.reshape(j, -1, EDGE_DIM), w0[:, :EDGE_DIM]
                      ).reshape(tuple(h3.shape[:-1]) + (w0.shape[-1],))
    w_m = w0[:, EDGE_DIM:]
    f4_tail = params["f4"][1:]
    m_obs, keep = flat["metrics"], flat["metrics_valid"][..., None]
    m_cur = m_obs
    for _ in range(levels):
        mj = _gather_nodes(torch.where(keep, m_obs, m_cur), edge_src)
        mw = torch.bmm(mj.reshape(j, -1, N_METRICS), w_m).reshape(
            tuple(mj.shape[:-1]) + (w_m.shape[-1],))
        hidden = _leaky(pre_h + mw + b0[:, None, None, :])
        msg = _mlp_jobs(f4_tail, hidden)                     # (J, B, E, M)
        m_prop = (oh_dst_f[..., None] *
                  (e[..., None] * msg)[:, :, :, None, :]).sum(dim=2)
        m_cur = torch.where(keep, m_obs, m_prop)

    # eqs. 3-5 readout (per node; eq.5 max over real predecessors)
    m_used = torch.where(keep, m_obs, m_cur)
    f1_in = torch.cat([flat["context"], m_used, a_vec, z_vec,
                       flat["r"][..., None]], dim=-1)
    o_hat = _mlp_jobs(params["f1"], f1_in)[..., 0]
    f2_in = torch.cat([flat["context"], m_used, z_vec, o_hat[..., None]],
                      dim=-1)
    f2_out = _mlp_jobs(params["f2"], f2_in)[..., 0]
    t_hat = torch.logaddexp(f2_out, torch.zeros_like(f2_out))   # softplus

    real_node = flat["mask"] & ~flat["is_summary"]
    t_node = torch.where(real_node, t_hat, zero)
    oh_real = oh_dst & ~_gather_nodes(flat["is_summary"], edge_src)[..., None]
    tt = t_node
    for _ in range(levels):
        best = torch.where(oh_real, _gather_nodes(tt, edge_src)[..., None],
                           zero).amax(dim=2)             # no-pred nodes -> 0
        tt = t_node + best
    return torch.where(real_node, tt, zero).amax(dim=-1)


def stack_params(params: Params) -> Params:
    """One job's parameters with a job axis of 1 (views, no copy)."""
    return {k: ([{kk: t[None] for kk, t in layer.items()} for layer in v]
                if isinstance(v, list) else v[None])
            for k, v in params.items()}


def sweep_sparse_totals(params: Params, flat: Dict[str, torch.Tensor],
                        edge_dst: torch.Tensor, edge_src: torch.Tensor,
                        edge_valid: torch.Tensor,
                        levels: int = MAX_LEVELS) -> torch.Tensor:
    """Total predicted runtime per graph of a flat stacked (B, N, ...)
    batch, sparse; ``edge_*`` are (B, E) (any integer dtype).  Returns (B,)
    totals equal (up to float summation order) to
    ``forward_stacked(...)["total_runtime"]`` on the same graphs."""
    return sweep_sparse_totals_jobs(
        stack_params(params), {k: v[None] for k, v in flat.items()},
        edge_dst.long()[None], edge_src.long()[None], edge_valid[None],
        levels)[0]


# ------------------------------------------------------------ on-device pick
def pick_candidate(candidates: torch.Tensor, cand_valid: torch.Tensor,
                   totals: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Index of the smallest compliant candidate scale-out, else the
    least-violating one, on the device, per row of the last axis (``target``
    has the leading shape).  ``candidates`` must be ascending over the
    valid entries; ``argmin`` returns the first of equal minima, as the
    host pick's tie-breaking needs.

    Non-finite totals count as +inf, so they can neither look compliant nor
    win the least-violating argmin; callers detect the condition with
    :func:`sweep_totals_ok` and route to the fallback policy."""
    inf = torch.full_like(totals, math.inf)
    totals = torch.where(torch.isfinite(totals), totals, inf)
    feasible = cand_valid & (totals <= target[..., None])
    idx_feasible = torch.argmin(torch.where(feasible, candidates, inf),
                                dim=-1)
    idx_min = torch.argmin(torch.where(cand_valid, totals, inf), dim=-1)
    return torch.where(feasible.any(dim=-1), idx_feasible, idx_min)


def sweep_totals_ok(totals: torch.Tensor,
                    cand_valid: torch.Tensor) -> torch.Tensor:
    """True iff every VALID candidate's predicted total is finite (per row
    of the last axis)."""
    return torch.where(cand_valid, torch.isfinite(totals),
                       torch.ones_like(cand_valid)).all(dim=-1)
