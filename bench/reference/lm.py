"""Plain float32 decoder forward of the dense, MoE and vlm configs.

Written from the model's description, independently of the program:
pre-norm blocks (RMSNorm scaled by 1 + s), grouped-query causal attention
with rotary positions (split halves) and optional per-head QK-norm, a
SwiGLU FFN, or a top-k MoE FFN whose experts take at most their capacity
of (token, choice) pairs in each routing group, choices of rank 0 first in
token order, then rank 1, and so on; a vlm's patch rows come before its
text.  Each expert runs on the tokens routed to it (gathered), not on a
dense dispatch.  Every product is float32 with TF32 off; with ``fp8`` each
product's operands are first rounded to float8 e4m3 with one scale per
tensor (the precision control; gradients pass straight through).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

FP8_MAX = 448.0


def exact_float32() -> None:
    """Float32 products in float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def q8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one per-tensor scale; the
    gradient passes through unchanged."""
    s = t.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    q = (t.detach() / s).to(torch.float8_e4m3fn).to(t.dtype) * s
    return t + (q - t).detach()


def mm(a: torch.Tensor, b: torch.Tensor, fp8: bool) -> torch.Tensor:
    if fp8:
        a, b = q8(a), q8(b)
    return a @ b


def rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + scale)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, D) rotated by positions ``pos`` (S,), split halves."""
    d = x.shape[-1]
    inv = theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                  device=x.device) / d)
    ang = pos.float()[:, None] * inv[None]                  # (S, D/2)
    cos, sin = ang.cos()[None, :, None], ang.sin()[None, :, None]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(w: Dict, c: Dict, x: torch.Tensor, pos: torch.Tensor,
              fp8: bool) -> torch.Tensor:
    b, s, _ = x.shape
    h, kh, dh = c["n_heads"], c["n_kv_heads"], c["d_head"]
    q = mm(x, w["wq"], fp8)
    k = mm(x, w["wk"], fp8)
    v = mm(x, w["wv"], fp8)
    if c.get("qkv_bias"):
        q, k, v = q + w["bq"], k + w["bk"], v + w["bv"]
    q, k, v = (t.view(b, s, -1, dh) for t in (q, k, v))
    if c.get("qk_norm"):
        q = rms(q, w["q_norm"], c["norm_eps"])
        k = rms(k, w["k_norm"], c["norm_eps"])
    if c.get("rope_theta"):
        q = rope(q, pos, c["rope_theta"])
        k = rope(k, pos, c["rope_theta"])
    q = q.transpose(1, 2)                                    # (B, H, S, D)
    k = k.transpose(1, 2).repeat_interleave(h // kh, dim=1)
    v = v.transpose(1, 2).repeat_interleave(h // kh, dim=1)
    scores = mm(q, k.transpose(-1, -2), fp8) / math.sqrt(dh)
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    o = mm(torch.softmax(scores, dim=-1), v, fp8)
    return mm(o.transpose(1, 2).reshape(b, s, h * dh), w["wo"], fp8)


def swiglu(w_gate, w_up, w_down, x, fp8: bool) -> torch.Tensor:
    return mm(F.silu(mm(x, w_gate, fp8)) * mm(x, w_up, fp8), w_down, fp8)


def capacity(c: Dict, group: int) -> int:
    """Slots per expert in a routing group of ``group`` tokens: the
    capacity factor's share rounded up to a multiple of 4, at least 4."""
    n = int(math.ceil(group * c["top_k"] * c["capacity_factor"] /
                      c["n_experts"]))
    return max(4, ((n + 3) // 4) * 4)


def kept_choices(c: Dict, idx: torch.Tensor,
                 groups: Sequence[int]) -> torch.Tensor:
    """Which (token, choice) pairs of ``idx`` (B, S, K) an expert takes:
    within each group of consecutive tokens of a row (``groups``, lengths
    summing to S), an expert's pairs count up in the order (choice rank,
    token) and those at or past its capacity are dropped."""
    b, s, k = idx.shape
    e = c["n_experts"]
    keep = torch.ones_like(idx, dtype=torch.bool)
    start = 0
    for n in groups:
        seg = idx[:, start:start + n]                         # (B, n, K)
        order = seg.transpose(1, 2).reshape(b, k * n)          # rank-major
        onehot = F.one_hot(order, e).to(torch.int32)
        slot = (onehot.cumsum(dim=1) - 1).gather(2, order[..., None])[..., 0]
        keep[:, start:start + n] = (slot.view(b, k, n).transpose(1, 2)
                                    < capacity(c, n))
        start += n
    assert start == s, (groups, s)
    return keep


def moe(w: Dict, c: Dict, x: torch.Tensor, groups: Sequence[int],
        fp8: bool, stats: Optional[Dict] = None):
    """(output, aux loss): the MoE FFN over x (B, S, d).  The aux loss is E
    times the sum over experts of the mean router probability and the
    share of top-1 choices, over every token of x.  ``stats`` gathers the
    dropped pairs."""
    b, s, d = x.shape
    e, k = c["n_experts"], c["top_k"]
    probs = torch.softmax(mm(x, w["router"], fp8), dim=-1)   # (B, S, E)
    top, idx = torch.topk(probs, k, dim=-1)
    gates = top / top.sum(-1, keepdim=True)
    me = probs.mean(dim=(0, 1))
    ce = F.one_hot(idx[..., 0], e).float().mean(dim=(0, 1))
    aux = (me * ce).sum() * e
    keep = kept_choices(c, idx, groups)
    if stats is not None:
        stats["pairs"] = stats.get("pairs", 0) + keep.numel()
        stats["dropped"] = stats.get("dropped", 0) + int((~keep).sum())
    xf = x.reshape(b * s, d)
    idx, gates, keep = (t.reshape(b * s, k) for t in (idx, gates, keep))
    out = torch.zeros_like(xf)
    for ex in range(e):
        rows, cols = torch.nonzero((idx == ex) & keep, as_tuple=True)
        if rows.numel() == 0:
            continue
        y = swiglu(w["w_gate"][ex], w["w_up"][ex], w["w_down"][ex], xf[rows],
                   fp8)
        out = out.index_add(0, rows, y * gates[rows, cols][:, None])
    return out.view(b, s, d), aux


def block(lw: Dict, c: Dict, x: torch.Tensor, pos: torch.Tensor,
          groups: Sequence[int], fp8: bool, stats: Optional[Dict] = None):
    """One pre-norm block on float32 copies of its weights: (x, aux)."""
    w = {k: ({kk: t.float() for kk, t in v.items()} if isinstance(v, dict)
             else v.float()) for k, v in lw.items()}
    eps = c["norm_eps"]
    x = x + attention(w["attn"], c, rms(x, w["ln1"], eps), pos, fp8)
    h = rms(x, w["ln2"], eps)
    if "moe" in w:
        y, aux = moe(w["moe"], c, h, groups, fp8, stats)
    else:
        f = w["ffn"]
        y, aux = swiglu(f["w_gate"], f["w_up"], f["w_down"], h, fp8), None
    return x + y, aux


def embed(params: Dict, c: Dict, tokens: torch.Tensor,
          patches: Optional[torch.Tensor] = None) -> torch.Tensor:
    x = params["embed"][tokens].float()
    if c["family"] == "vlm":
        x = torch.cat([patches.float(), x], dim=1)
    return x


def hidden(params: Dict, c: Dict, tokens: torch.Tensor,
           patches: Optional[torch.Tensor], groups: Sequence[int],
           fp8: bool = False, remat: bool = False,
           stats: Optional[Dict] = None):
    """(final-normed hidden states (B, S', d), summed aux loss) of the
    rows ``tokens`` (B, S) (after a vlm's patches; S' counts them)."""
    x = embed(params, c, tokens, patches)
    pos = torch.arange(x.shape[1], device=x.device)
    aux = torch.zeros((), device=x.device)
    for lw in params["layers"]:
        if remat:
            x, a = checkpoint(block, lw, c, x, pos, groups, fp8, stats,
                              use_reentrant=False)
        else:
            x, a = block(lw, c, x, pos, groups, fp8, stats)
        if a is not None:
            aux = aux + a
    return rms(x, params["final_norm"].float(), c["norm_eps"]), aux


def logits(params: Dict, c: Dict, h: torch.Tensor, fp8: bool = False
           ) -> torch.Tensor:
    table = params["embed"] if c.get("tie_embeddings") else params["unembed"]
    return mm(h, table.float().T, fp8)


def routing_groups(c: Dict, rows: int, tail: int = 0) -> List[int]:
    """The program's routing groups along a row: ``rows`` tokens of one
    full-sequence pass in groups of min(rows, moe_group) (it must divide),
    then ``tail`` tokens decoded one at a time, each its own group."""
    g = min(rows, c.get("moe_group", 1024))
    assert rows % g == 0, (rows, g)
    return [g] * (rows // g) + [1] * tail
