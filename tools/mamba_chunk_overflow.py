"""Where the reference's Pallas ``mamba_scan`` overflows, on the CPU.

The TPU kernel (``src/repro/kernels/mamba_scan/kernel.py``) forms each
chunk's prefix decays as exp(cumsum(log decay)) and divides the drive by
them: exp(-cum) overflows float32 once dt |A| summed over a 64-step chunk
passes about 88.  This prints

- jamba's dt at full width: the reference's ``init_mamba`` and
  ``_mamba_core`` (jamba-v0.1-52b, d_model 4096, d_inner 8192, N 16) on
  random inputs normed as the model norms them; its median, p90 and
  maximum, and the share of (token, channel) pairs whose dt x 16 x 64
  exceeds 88;
- the reference wrapper ``selective_scan`` (the Pallas kernel in
  interpret mode, chunk 64) against the strict oracle
  ``ref.py::mamba_scan_ref`` with A = -(1..16) and dt uniform up to each
  ``--dt-max``: the non-finite outputs and the largest difference of the
  finite ones.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/mamba_chunk_overflow.py
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro.configs import get_config                              # noqa: E402
from repro.configs.base import ModelConfig                        # noqa: E402
from repro.kernels.mamba_scan.ops import selective_scan           # noqa: E402
from repro.kernels.mamba_scan.ref import mamba_scan_ref           # noqa: E402
from repro.models import ssm                                      # noqa: E402
from repro.models.layers import norm_init, rms_norm               # noqa: E402

SEED = 0
CHUNK = 64
EXP_LIMIT = 88.0            # exp(x) overflows float32 just above x = 88.7


def jamba_dt(cfg: ModelConfig, batch: int, seq: int) -> np.ndarray:
    """dt (B, S, d_inner) of one freshly initialised Mamba mixer of ``cfg``
    on N(0, 1) inputs passed through the model's pre-norm."""
    p = ssm.init_mamba(jax.random.PRNGKey(SEED), cfg)
    x = jax.random.normal(jax.random.PRNGKey(SEED + 1),
                          (batch, seq, cfg.d_model), jnp.float32)
    x = rms_norm(x, norm_init(cfg.d_model), cfg.norm_eps).astype(jnp.bfloat16)
    di, r = ssm.mamba_dims(cfg)
    x1, _ = jnp.split(x @ p["in_proj"], 2, axis=-1)
    x1 = jax.nn.silu(ssm._mamba_conv_full(p, x1))
    dbc = x1 @ p["x_proj"]
    dt = jax.nn.softplus((dbc[..., :r] @ p["dt_proj"]).astype(jnp.float32)
                         + p["dt_bias"])
    assert dt.shape == (batch, seq, di)
    return np.asarray(dt)


def chunk_form_vs_oracle(dt_max: float, b: int, s: int, d: int, n: int):
    """(non-finite outputs, their total, max |diff| of the finite ones)."""
    rng = np.random.RandomState(SEED)
    dt = rng.uniform(0.0, dt_max, (b, s, d)).astype(np.float32)
    a = -np.tile(np.arange(1, n + 1, dtype=np.float32), (d, 1))
    x = rng.randn(b, s, d).astype(np.float32)
    bm = rng.randn(b, s, n).astype(np.float32)
    cm = rng.randn(b, s, n).astype(np.float32)
    y = np.asarray(selective_scan(*(jnp.asarray(v) for v in (dt, a, x, bm,
                                                               cm)),
                                  chunk=CHUNK, block_d=min(128, d)))
    decay = np.exp(dt[..., None] * a)
    drive = (dt * x)[..., None] * bm[:, :, None, :]
    ref = np.asarray(mamba_scan_ref(jnp.asarray(decay), jnp.asarray(drive),
                                    jnp.asarray(cm)))
    bad = ~np.isfinite(y)
    diff = float(np.abs(y[~bad] - ref[~bad]).max()) if (~bad).any() else None
    return int(bad.sum()), int(y.size), diff


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--dt-max", type=float, nargs="+",
                    default=[0.05, 0.15, 0.5, 1.0])
    args = ap.parse_args()
    cfg = get_config("jamba-v0.1-52b")
    dt = jamba_dt(cfg, args.batch, args.seq)
    steps = cfg.mamba_d_state * CHUNK          # |A| up to N, 64 steps
    out = {"dt": {"median": float(np.median(dt)),
                  "p90": float(np.percentile(dt, 90)),
                  "max": float(dt.max()),
                  "share_over_limit": float(np.mean(dt * steps > EXP_LIMIT)),
                  "pairs": int(dt.size)},
           "chunk_form": {}}
    print(f"jamba dt at full width ({dt.size} (token, channel) pairs): "
          f"median {out['dt']['median']:.3g}, p90 {out['dt']['p90']:.3g}, "
          f"max {out['dt']['max']:.3g}; dt x {steps} > {EXP_LIMIT:g} for "
          f"{100 * out['dt']['share_over_limit']:.1f} %", flush=True)
    for dt_max in args.dt_max:
        bad, total, diff = chunk_form_vs_oracle(dt_max, 1, 128, 64, 16)
        out["chunk_form"][str(dt_max)] = {"non_finite": bad, "outputs": total,
                                          "max_abs_diff_finite": diff}
        print(f"selective_scan (Pallas, interpret, chunk {CHUNK}) vs "
              f"mamba_scan_ref, A = -(1..16), dt <= {dt_max}: {bad} of "
              f"{total} outputs non-finite, finite ones within {diff}",
              flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
