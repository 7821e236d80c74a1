"""The port's two attention kernels in two checkouts, on one card, in one run.

Times ``flash_attention_fwd`` at qwen3-0.6b's prefill shape (B 8, S 812, H 16,
Kh 8, D 128, bf16, causal) and ``flash_decode`` at its decode shape (B 8,
H 16, Kh 8, D 128, cache 2048, pos 875 and 2047, bf16, the caches cold in
L2 as ``chip_smoke.py`` phase 10 keeps them), beside one
``scaled_dot_product_attention`` call, each as the device time per call
of a CUDA graph of back-to-back calls.  With ``--jamba`` it also takes
jamba's bf16 teacher-forced reading (``chip_smoke.py`` phase 15: all 8
layers of one period, B = 2, capacity 16, decode_step vs forward at
768..771 on the rows routed alike) and its routing flips.

Each checkout runs in its own process, in the order other, this, this,
other, so that a drift of the card over the run shows.  ``--other`` names a
checkout of another commit, e.g. the parent unpacked with ``git archive``
into a git-ignored directory; both must have ``chip_smoke.py`` at their
root.  Needs one card.

    python tools/attention_before_after.py --other build/parent [--jamba]
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def measure(root: str, jamba: bool) -> dict:
    """One checkout's numbers; ``root`` is put first on ``sys.path``."""
    sys.path[:0] = [root, os.path.join(root, "src")]
    import numpy as np
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_decode import ops as fd

    def device_ms(fn, reps):
        """Per call, ``reps`` calls in one CUDA graph between CUDA events."""
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        return cs.median_ms(graph.replay, burst=1, reps=10) / reps
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_grad_enabled(False)
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    rng = np.random.RandomState(cs.SEED + 1)
    b, s, h, kh, d = 8, 812, 16, 8, 128
    out = {"root": root}
    q = cs._randn(rng, (b, s, h, d), bf16, dev)
    k, v = (cs._randn(rng, (b, s, kh, d), bf16, dev) for _ in range(2))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    out["fa_ms"] = device_ms(lambda: fa.mha(q, k, v), reps=20)
    out["fa_sdpa_ms"] = device_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), reps=20)
    out["fa_err"] = float((fa.mha(q, k, v).float()
                           - fa.mha_plain(q, k, v).float()).abs().max())
    del q, k, v, qt, kt, vt
    caches = [tuple(cs._randn(rng, (b, 2048, kh, d), bf16, dev)
                    for _ in range(2)) for _ in range(cs.LM_COPIES)]
    qd = cs._randn(rng, (b, 1, h, d), bf16, dev)
    qdt = qd.transpose(1, 2).contiguous()
    for pos in (875, 2047):
        turn = itertools.cycle(range(cs.LM_COPIES))
        rows = [tuple(x[:, :pos + 1].transpose(1, 2).contiguous()
                      for x in kv) for kv in caches]
        out[f"fd_ms_{pos}"] = device_ms(lambda: fd.decode_attn(
            qd, *caches[next(turn)], pos), reps=48)
        out[f"fd_sdpa_ms_{pos}"] = device_ms(
            lambda: F.scaled_dot_product_attention(
                qdt, *rows[next(turn)], enable_gqa=True), reps=48)
        out[f"fd_err_{pos}"] = float(
            (fd.decode_attn(qd, *caches[0], pos).float()
             - fd.decode_attn_plain(qd, *caches[0], pos).float())
            .abs().max())
        del rows
    del caches
    torch.cuda.empty_cache()
    if jamba:
        import dataclasses
        from repro_torch.configs import get_config
        from repro_torch.models import init_model
        cfg = dataclasses.replace(get_config(cs.JAMBA_ARCH),
                                  n_layers=cs.JAMBA_LAYERS)
        params = init_model(cfg, seed=cs.SEED, device=dev)
        toks0 = cs.padded(cs.capped_waves(cfg, cs.JAMBA_TOP)[0])
        toks = torch.tensor(toks0[:cs.JAMBA_TF_BATCH], device=dev)
        cfg16 = dataclasses.replace(cfg,
                                    capacity_factor=cs.JAMBA_TF_CAPACITY)
        err, flip, nflip = cs.routed_teacher_forced(params, cfg16, toks,
                                                    cs.JAMBA_TF_PREFIX)
        kept = ~flip
        out["jamba_bf16_rel_err_routed_alike"] = float(err[kept].max())
        out["jamba_bf16_rel_err_all_rows"] = float(err.max())
        out["jamba_rows_left_out"] = int(flip.sum())
        out["jamba_rows"] = int(flip.numel())
        out["jamba_routings_flipped"] = int(nflip)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", help="checkout to hold this one against")
    ap.add_argument("--jamba", action="store_true",
                    help="also jamba's bf16 teacher-forced reading")
    ap.add_argument("--measure", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure:
        print(json.dumps(measure(os.path.abspath(args.measure), args.jamba)),
              flush=True)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    other = os.path.abspath(args.other)
    order = [(other, args.jamba), (HERE, args.jamba), (HERE, False),
             (other, False)]
    for root, jamba in order:
        cmd = [sys.executable, os.path.abspath(__file__), "--measure", root]
        res = subprocess.run(cmd + (["--jamba"] if jamba else []),
                             capture_output=True, text=True, cwd=root)
        if res.returncode:
            print(res.stdout + res.stderr, flush=True)
            return res.returncode
        print(res.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
