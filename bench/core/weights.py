"""Weights made by the benchmark from ``--seed``, on the device, in the
layout of the port's parameter tree (``models.transformer.init_model``'s
dicts and lists), so that the program and the plain reference are handed
the same values.

Every leaf is a view of one of two flat buffers (the parameter dtype's and
float32), each filled by one ``torch.randn`` call from a
``torch.Generator`` seeded with the seed on the device, then scaled leaf by
leaf in place: N(0, 1) / sqrt(fan-in) for projections and experts, 0.02
for the output table, the configuration's ``embed_std`` (0.02 where it
gives none) for the input table, 0.1 for the norm scales (stored as
offsets from 1, as the port's are).  Each leaf starts on a 256-byte
boundary.
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Tuple

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}
ALIGN = 128                        # elements: 256 bytes of bf16


class Leaf(NamedTuple):
    path: Tuple                    # keys and list indices into the tree
    shape: Tuple[int, ...]
    dtype: str
    scale: float


def leaf_specs(c: Dict) -> List[Leaf]:
    """Every parameter of a dense / MoE / vlm decoder config ``c`` (a
    config file's ``config``), in a fixed order."""
    d, v, dh = c["d_model"], c["vocab_size"], c["d_head"]
    qh, kvh = c["n_heads"] * dh, c["n_kv_heads"] * dh
    pd, f32 = c["param_dtype"], "float32"
    out = [Leaf(("embed",), (v, d), pd, c.get("embed_std", 0.02)),
           Leaf(("final_norm",), (d,), f32, 0.1)]
    if not c.get("tie_embeddings"):
        out.append(Leaf(("unembed",), (v, d), pd, 0.02))
    for i in range(c["n_layers"]):
        L = ("layers", i)
        out += [Leaf(L + ("ln1",), (d,), f32, 0.1),
                Leaf(L + ("attn", "wq"), (d, qh), pd, d ** -0.5),
                Leaf(L + ("attn", "wk"), (d, kvh), pd, d ** -0.5),
                Leaf(L + ("attn", "wv"), (d, kvh), pd, d ** -0.5),
                Leaf(L + ("attn", "wo"), (qh, d), pd, qh ** -0.5)]
        if c.get("qkv_bias"):
            out += [Leaf(L + ("attn", "bq"), (qh,), pd, 0.02),
                    Leaf(L + ("attn", "bk"), (kvh,), pd, 0.02),
                    Leaf(L + ("attn", "bv"), (kvh,), pd, 0.02)]
        if c.get("qk_norm"):
            out += [Leaf(L + ("attn", "q_norm"), (dh,), f32, 0.1),
                    Leaf(L + ("attn", "k_norm"), (dh,), f32, 0.1)]
        out.append(Leaf(L + ("ln2",), (d,), f32, 0.1))
        if c.get("n_experts"):
            e, f = c["n_experts"], c["moe_d_ff"]
            out += [Leaf(L + ("moe", "router"), (d, e), f32, d ** -0.5),
                    Leaf(L + ("moe", "w_gate"), (e, d, f), pd, d ** -0.5),
                    Leaf(L + ("moe", "w_up"), (e, d, f), pd, d ** -0.5),
                    Leaf(L + ("moe", "w_down"), (e, f, d), pd, f ** -0.5)]
        else:
            f = c["d_ff"]
            out += [Leaf(L + ("ffn", "w_gate"), (d, f), pd, d ** -0.5),
                    Leaf(L + ("ffn", "w_up"), (d, f), pd, d ** -0.5),
                    Leaf(L + ("ffn", "w_down"), (f, d), pd, f ** -0.5)]
    return out


def path_name(path: Tuple) -> str:
    return "/".join(str(p) for p in path)


def _set(tree: Dict, path: Tuple, value) -> None:
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(node, list):
            while len(node) <= key:
                node.append({})
            node = node[key]
        else:
            node = node.setdefault(key, [] if isinstance(nxt, int) else {})
    node[path[-1]] = value


def get(tree, path: Tuple):
    for key in path:
        tree = tree[key]
    return tree


def make_params(c: Dict, seed: int, device) -> Dict:
    """The parameter tree of config ``c`` drawn from ``seed`` on
    ``device``."""
    device = torch.device(device)
    specs = leaf_specs(c)
    offsets, sizes = [], {}
    for leaf in specs:
        n = math.prod(leaf.shape)
        at = sizes.get(leaf.dtype, 0)
        offsets.append(at)
        sizes[leaf.dtype] = at + -(-n // ALIGN) * ALIGN
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    flat = {}
    for name in sorted(sizes):
        buf = torch.empty(sizes[name], dtype=DTYPES[name], device=device)
        torch.randn(sizes[name], generator=gen, out=buf)
        flat[name] = buf
    tree: Dict = {}
    for leaf, at in zip(specs, offsets):
        n = math.prod(leaf.shape)
        t = flat[leaf.dtype][at:at + n].view(leaf.shape)
        t.mul_(leaf.scale)
        _set(tree, leaf.path, t)
    return tree


def leaves(tree, c: Dict) -> List[Tuple[str, torch.Tensor]]:
    """(name, tensor) of every leaf of ``tree`` in ``leaf_specs`` order."""
    return [(path_name(leaf.path), get(tree, leaf.path))
            for leaf in leaf_specs(c)]
