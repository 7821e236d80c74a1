"""Where two computations of xlstm-350m that should agree come apart.

Runs the port's xlstm-350m (full width and depth, seeded random weights) on
wave 0 of ``chip_smoke.py``'s xLSTM serving phase (B = 8, 1024 tokens) and
prints, for bf16 and for float32 weights:

  floor   per layer, the residual stream of a forward over all P tokens
          against one over the first P0 = 768, at positions P0-4..P0-1;
  ulp@t   per layer, the same forward over P0 tokens against one whose
          embedding at position t was moved by one step of its dtype
          (t = 0: what the recurrences carry over time; t = P0-4: what the
          depth alone amplifies);
  mixer   per layer, the mixer's step from its prefill state over P0
          tokens against its full-sequence form over P, on the layer's
          real inputs (chip_smoke.layer_continuation_errs);
  depth   teacher-forced decode vs forward, and forward vs forward, on the
          first k layers of the same weights.

Each difference is max|a - b| / max|a| over batch, positions and width.

    python tools/xlstm_rounding.py [--out build/xlstm_rounding.json]
    python tools/xlstm_rounding.py --device cpu --smoke      # rehearsal
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs                                          # noqa: E402
from repro_torch.configs import get_config, smoke_config          # noqa: E402
from repro_torch.models import init_model                         # noqa: E402
from repro_torch.models import transformer as tr                  # noqa: E402
from repro_torch.models.layers import embed_lookup                # noqa: E402

DEPTHS = (1, 2, 3, 4, 8, 16, 24)


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / a.abs().max())


def stream(params, cfg, toks, bump_at=None):
    """The residual stream after the embedding and after each layer of a
    train-mode forward, plus the logits; ``bump_at`` moves the embedding
    at that position up by one step of its dtype."""
    x = embed_lookup(params["embed"], toks, cfg)
    if bump_at is not None:
        x = x.clone()
        step = torch.finfo(x.dtype).eps * x[:, bump_at].float().abs()
        x[:, bump_at] = (x[:, bump_at].float() + step).to(x.dtype)
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device).expand(b, s)
    xs = [x]
    for i, lp in enumerate(params["layers"]):
        x, _, _ = tr._layer_apply(lp, cfg, cfg.layer_kind(i),
                                  cfg.ffn_kind(i), x, "train", positions,
                                  None, None)
        xs.append(x)
    return xs, tr._logits(params, cfg, x)


def per_layer(xa, xb, sl):
    return [rel(a[:, sl], b[:, sl]) for a, b in zip(xa, xb)]


def probe(params, cfg, toks, p0, depths):
    full, lg_full = stream(params, cfg, toks)
    part, lg_part = stream(params, cfg, toks[:, :p0])
    again, lg_again = stream(params, cfg, toks[:, :p0])
    tail = slice(p0 - cs.TF_STEPS, p0)
    out = {"floor": per_layer(full, part, tail) + [rel(lg_full[:, tail],
                                                       lg_part[:, tail])],
           "repeat_bit_equal": all(torch.equal(a, b) for a, b in
                                   zip(part + [lg_part], again + [lg_again]))}
    del again, lg_again
    for t in (0, p0 - cs.TF_STEPS):
        bumped, lg = stream(params, cfg, toks[:, :p0], bump_at=t)
        out[f"ulp@{t}"] = per_layer(part, bumped, tail) + [
            rel(lg_part[:, tail], lg[:, tail])]
        del bumped, lg
    del full, part, lg_part, lg_full
    out["mixer"] = cs.layer_continuation_errs(params, cfg, toks, p0)
    out["depth"] = {}
    for k in depths:
        pk, ck = cs.first_layers(params, cfg, k)
        out["depth"][k] = {"teacher_forced": cs.teacher_forced_err(
            pk, ck, toks, p0), "floor": cs.forward_floor(pk, ck, toks, p0)}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="smoke-size config (for a CPU rehearsal)")
    ap.add_argument("--out", default=None, help="write the JSON here too")
    args = ap.parse_args()
    device = torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(cs.XLSTM_ARCH)
    p, p0, depths = cs.XLSTM_TOP[0], cs.XLSTM_TF_PREFIX, DEPTHS
    if args.smoke:
        cfg, p, p0, depths = smoke_config(cfg), 256, 128, (1, 2, 3)
    toks = cs.padded(cs.capped_waves(cfg, cs.XLSTM_TOP)[0])[:, -p:]
    toks = torch.tensor(np.ascontiguousarray(toks), device=device)
    card = cs.card_line() if device.type == "cuda" else "cpu"
    params = init_model(cfg, seed=cs.SEED, device=device)
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    result = {"card": card, "arch": cfg.name, "B": int(toks.shape[0]),
              "P": p, "P0": p0, "kinds": [cfg.layer_kind(i)
                                          for i in range(cfg.n_layers)]}
    for name, prm, c in (("bf16", params, cfg),
                         ("float32", cs.as_float32(params), cfg32)):
        t0 = time.perf_counter()
        with torch.no_grad():
            result[name] = r = probe(prm, c, toks, p0, depths)
        print(f"{name} weights ({time.perf_counter() - t0:.1f}s), repeat "
              f"bit-equal: {r['repeat_bit_equal']}")
        print("  layer kind     floor     ulp@0  ulp@P0-4     mixer")
        for i in range(cfg.n_layers + 2):
            kind = ("embed" if i == 0 else "logits" if i > cfg.n_layers
                    else result["kinds"][i - 1])
            mix = r["mixer"][i - 1] if 0 < i <= cfg.n_layers else None
            print(f"  {i:5d} {kind:6s} {r['floor'][i]:9.3g} "
                  f"{r['ulp@0'][i]:9.3g} {r[f'ulp@{p0 - cs.TF_STEPS}'][i]:9.3g}"
                  + (f" {mix:9.3g}" if mix is not None else ""))
        for k, d in r["depth"].items():
            print(f"  first {k:2d} layers: teacher-forced "
                  f"{d['teacher_forced']:.3g}, forward vs forward "
                  f"{d['floor']:.3g}")
    print(json.dumps(result))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
