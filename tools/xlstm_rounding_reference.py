"""The JAX reference's side of ``tools/xlstm_rounding.py``, on the CPU.

Builds the reference's xlstm-350m at full width (d 1024, 4 heads of 256,
vocab 50,304) in float32 with seeded random weights, its depth cut to the
first ``--layers`` layers (one period of 8 by default: seven mLSTM and the
sLSTM at layer 2), and runs it on the same tokens as the port's probe
(wave 0 of ``chip_smoke.py``'s xLSTM serving phase).  It prints, per
layer, the same differences as the port's probe: ``floor`` (a forward over
P tokens against one over the first P0 at positions P0-4..P0-1) and
``ulp@t`` (the forward over P0 tokens against one whose embedding at
position t moved up by one float32 step, as the port's probe moves it).

With ``--port`` it also runs the port's CPU route (``src/repro_torch``,
float32) on the reference's weights, converted with
``convert.lm_params_from_numpy``, over the same P tokens, and prints per
layer ``port`` (the port's residual stream against the reference's, at
positions P0-4..P0-1, the logits last): the full-depth witness of the
port's rounding.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/xlstm_rounding_reference.py
    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/xlstm_rounding_reference.py \
        --layers 24 --port
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro.configs import get_config                              # noqa: E402
from repro.models import transformer as tr                        # noqa: E402
from repro.models.layers import embed_lookup, rms_norm, unembed_logits  # noqa

SEED, P, P0, STEPS = 0, 1024, 768, 4


def wave0_tokens(vocab: int, batch: int) -> np.ndarray:
    """Wave 0 of chip_smoke.xlstm_waves, left-padded with 0 as the engine
    pads it: lengths in [128, 1024] from RandomState(0), the longest 1024."""
    rng = np.random.RandomState(SEED)
    lens = rng.randint(128, P + 1, batch)
    lens[np.argmax(lens)] = P
    out = np.zeros((batch, P), np.int64)
    for row, n in enumerate(lens):
        out[row, P - n:] = rng.randint(2, vocab, n)
    return out


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(a).max())


def port_stream(params, cfg, toks: np.ndarray, tail: slice):
    """The port's residual stream (embedding and each layer, at ``tail``)
    and its logits at ``tail``, on the CPU in float32, over the
    reference's ``params`` (numpy leaves)."""
    import torch
    from repro_torch import configs as pconfigs
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.models import transformer as ptr
    from repro_torch.models.layers import embed_lookup as pembed
    pcfg = pconfigs.ModelConfig(**dataclasses.asdict(cfg))
    pp = lm_params_from_numpy(params, pcfg, device="cpu")
    with torch.no_grad():
        x = pembed(pp["embed"], torch.tensor(toks), pcfg)
        b, s = x.shape[:2]
        positions = torch.arange(s).expand(b, s)
        xs = [x[:, tail].numpy()]
        for i, lp in enumerate(pp["layers"]):
            x, _, _ = ptr._layer_apply(lp, pcfg, pcfg.layer_kind(i),
                                       pcfg.ffn_kind(i), x, "train",
                                       positions, None, None)
            xs.append(x[:, tail].numpy())
        return xs, ptr._logits(pp, pcfg, x[:, tail]).numpy()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=8,
                    help="a multiple of the layer period, 8")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--port", action="store_true",
                    help="also the port's CPU route on the same weights")
    ap.add_argument("--out", default=None, help="write the JSON here too")
    args = ap.parse_args()
    cfg = dataclasses.replace(get_config("xlstm-350m"), n_layers=args.layers,
                              dtype="float32", param_dtype="float32")
    if args.layers % cfg.layer_period:
        ap.error(f"--layers must be a multiple of {cfg.layer_period}")
    params = tr.init_model(jax.random.PRNGKey(SEED), cfg)
    layers = [jax.tree_util.tree_map(lambda a: a[g], params["groups"][f"p{j}"])
              for g in range(cfg.n_groups) for j in range(cfg.layer_period)]
    kinds = [cfg.layer_kind(i) for i in range(cfg.n_layers)]

    @jax.jit
    def embed(toks):
        return embed_lookup(params["embed"], toks, cfg)

    table = params["embed"] if cfg.tie_embeddings else params["unembed"]

    @jax.jit
    def logits(x):
        return unembed_logits(rms_norm(x, params["final_norm"], cfg.norm_eps),
                              table, cfg)

    apply = {kind: jax.jit(lambda lp, x, kind=kind: tr._layer_apply(
        lp, cfg, kind, "none", x, "train", None, None, None, None)[0])
        for kind in set(kinds)}

    tail = slice(P0 - STEPS, P0)

    def stream(x):
        """The residual stream after the embedding and each layer, and the
        logits at the tail positions."""
        xs = [x]
        for lp, kind in zip(layers, kinds):
            xs.append(apply[kind](lp, xs[-1]))
        return ([np.asarray(t) for t in xs],
                np.asarray(logits(xs[-1][:, tail])))

    toks = jnp.asarray(wave0_tokens(cfg.raw_vocab_size, args.batch))
    t0 = time.perf_counter()
    full, lg_full = stream(embed(toks))
    part, lg_part = stream(embed(toks[:, :P0]))
    result = {"arch": cfg.name, "layers": cfg.n_layers, "B": args.batch,
              "P": P, "P0": P0, "kinds": kinds, "float32": {}}
    r = result["float32"]
    r["floor"] = [rel(a[:, tail], b[:, tail]) for a, b in zip(full, part)] \
        + [rel(lg_full, lg_part)]
    if args.port:
        t1 = time.perf_counter()
        xs, lg_port = port_stream(jax.tree_util.tree_map(np.asarray, params),
                                  cfg, np.asarray(toks), tail)
        r["port"] = [rel(a[:, tail], b) for a, b in zip(full, xs)] \
            + [rel(lg_full, lg_port)]
        print(f"port, float32, on the reference's weights "
              f"({time.perf_counter() - t1:.1f}s on the CPU): logits at "
              f"{P0 - STEPS}..{P0 - 1} of the forward over {P} tokens differ "
              f"from the reference's by {r['port'][-1]:.3g} of the largest")
    del full
    for t in (0, P0 - STEPS):
        x = np.array(embed(toks[:, :P0]))
        x[:, t] += np.finfo(np.float32).eps * np.abs(x[:, t])
        bumped, lg = stream(jnp.asarray(x))
        r[f"ulp@{t}"] = [rel(a[:, tail], b[:, tail])
                         for a, b in zip(part, bumped)] \
            + [rel(lg_part, lg)]
    print(f"reference, float32, {cfg.n_layers} layers at full width, B = "
          f"{args.batch} ({time.perf_counter() - t0:.1f}s on the CPU)")
    print("  layer kind     floor     ulp@0  ulp@P0-4"
          + ("      port" if args.port else ""))
    for i in range(cfg.n_layers + 2):
        kind = ("embed" if i == 0 else "logits" if i > cfg.n_layers
                else kinds[i - 1])
        print(f"  {i:5d} {kind:6s} {r['floor'][i]:9.3g} {r['ulp@0'][i]:9.3g} "
              f"{r[f'ulp@{P0 - STEPS}'][i]:9.3g}"
              + (f" {r['port'][i]:9.3g}" if args.port else ""))
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
