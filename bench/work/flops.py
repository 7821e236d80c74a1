"""Frozen model-FLOP and least-work formulas: the benchmark's yardstick.

These never count what the program executes.  Model FLOPs follow the PaLM
convention: 6 N per trained token and 2 N per prefilled row, where N is
the active parameters without the input embedding, plus the causal
attention products, 4 H d_head for each visible (query, key) pair and
layer, times 3 in training.  The least work of an attention call counts
its products once and each input byte read and output byte written once.

Copied from the port's own arithmetic when this benchmark was written
(``models/model.py::active_param_count``, ``launch/dryrun.py::model_flops``,
``chip_smoke.py::attention_work`` / ``decode_work``) and frozen here, so
that a change to the program cannot move the yardstick.
"""
from __future__ import annotations

from typing import Dict, Iterable


def _layer_kinds(c: Dict):
    """(number of attention layers, of dense-FFN layers, of MoE layers)."""
    n = c["n_layers"]
    moe = n if c.get("n_experts") else 0
    return n, n - moe, moe


def param_counts(c: Dict) -> Dict[str, int]:
    """Parameter counts of a dense / MoE / vlm decoder config (a config
    file's ``config`` dict): ``total``, ``active`` (an MoE layer's top-k
    experts only) and ``embed`` (the input embedding)."""
    d, v = c["d_model"], c["vocab_size"]
    qh, kvh = c["n_heads"] * c["d_head"], c["n_kv_heads"] * c["d_head"]
    attn = d * qh + 2 * d * kvh + qh * d
    if c.get("qk_norm"):
        attn += 2 * c["d_head"]
    if c.get("qkv_bias"):
        attn += qh + 2 * kvh
    n_attn, n_dense, n_moe = _layer_kinds(c)
    expert = 3 * d * c.get("moe_d_ff", 0)
    e, k = c.get("n_experts", 0), c.get("top_k", 0)
    layer_common = 2 * d + attn                       # ln1, ln2, attention
    dense = 3 * d * c.get("d_ff", 0)
    moe = d * e + e * expert                          # router, experts
    embed = v * d
    head = 0 if c.get("tie_embeddings") else v * d
    total = (embed + head + d + n_attn * layer_common + n_dense * dense
             + n_moe * moe)
    active = total - n_moe * (e - k) * expert
    return {"total": total, "active": active, "embed": embed}


def flops_params(c: Dict) -> int:
    """N of the PaLM convention: active parameters without the input
    embedding."""
    p = param_counts(c)
    return p["active"] - p["embed"]


def causal_pairs(rows: int) -> int:
    """Visible (query, key) pairs of causal attention over ``rows`` rows."""
    return rows * (rows + 1) // 2


def attention_flops_per_pair(c: Dict) -> int:
    """4 H d_head FLOPs per visible pair in each attention layer, summed
    over the layers."""
    return 4 * c["n_heads"] * c["d_head"] * c["n_layers"]


def train_step_flops(c: Dict, batch: int, seq: int) -> float:
    """Model FLOPs of one training step over ``batch`` rows of ``seq``
    tokens (each row causal over itself)."""
    return (6.0 * flops_params(c) * batch * seq
            + 3.0 * attention_flops_per_pair(c) * batch * causal_pairs(seq))


def prefill_flops(c: Dict, rows: Iterable[int]) -> float:
    """Model FLOPs of prefilling requests of ``rows`` rows each (a
    request's own rows: patches and prompt, padding left out)."""
    rows = list(rows)
    return (2.0 * flops_params(c) * sum(rows)
            + attention_flops_per_pair(c) * sum(causal_pairs(r) for r in rows))


def attention_work(b, sq, sk, h, kh, d, causal, elt=2):
    """(FLOPs, bytes) of attention of Sq queries over Sk keys: 4 * D FLOPs
    per visible (query, key) pair and head (all Sq x Sk pairs, or S(S + 1)
    / 2 when causal with Sq = Sk); q, k, v read once, the output written
    once."""
    pairs = sq * (sq + 1) // 2 if causal else sq * sk
    return (4 * b * h * d * pairs,
            elt * (2 * b * sq * h * d + 2 * b * sk * kh * d))


def decode_work(b, h, kh, d, pos, elt=2):
    """(FLOPs, bytes) of one-token attention over positions 0..pos: 4 * D
    FLOPs per key and query head; the pos + 1 cache rows of K and V read
    once, q read and the output written once."""
    n = pos + 1
    return 4 * b * h * d * n, elt * (2 * b * kh * n * d + 2 * b * h * d)


def least_seconds(flops: float, nbytes: float, peak_flops: float,
                  peak_bytes: float) -> float:
    """The roofline's least time: the larger of the two bounds."""
    return max(flops / peak_flops, nbytes / peak_bytes)
