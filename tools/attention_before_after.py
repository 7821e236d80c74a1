"""The port's two attention kernels in two checkouts, on one card, in one run.

Times ``flash_attention_fwd`` at qwen3-0.6b's prefill shape (B 8, S 812, H 16,
Kh 8, D 128, bf16, causal) and ``flash_decode`` at its decode shape (B 8,
H 16, Kh 8, D 128, cache 2048, pos 875 and 2047, bf16, the caches cold in
L2 as ``chip_smoke.py`` phase 10 keeps them), beside one
``scaled_dot_product_attention`` call, each as the device time per call
of a CUDA graph of back-to-back calls, and holds the two checkouts'
outputs of those calls (the same seeded inputs) bit for bit against each
other (``other_vs_this``).  With ``--jamba`` it also takes
jamba's bf16 teacher-forced reading (``chip_smoke.py`` phase 15: all 8
layers of one period, B = 2, capacity 16, decode_step vs forward at
768..771 on the rows routed alike) and its routing flips.

Each checkout runs in its own process, in the order other, this, this,
other (``before_after.py``), so that a drift of the card over the run
shows.  ``--other`` names a checkout of another commit, e.g. the parent
unpacked with ``git archive`` into a git-ignored directory, whose
``chip_smoke.py`` has ``graph_ms``.  Needs one card.

    python tools/attention_before_after.py --other build/parent [--jamba]
"""
from __future__ import annotations

import itertools
import sys

import before_after


def measure(root: str, args) -> dict:
    """One checkout's numbers; ``root`` is first on ``sys.path``."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_decode import ops as fd

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_grad_enabled(False)
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    rng = np.random.RandomState(cs.SEED + 1)
    b, s, h, kh, d = 8, 812, 16, 8, 128
    out = {"root": root}
    q = cs._randn(rng, (b, s, h, d), bf16, dev)
    k, v = (cs._randn(rng, (b, s, kh, d), bf16, dev) for _ in range(2))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    out["fa_ms"] = cs.graph_ms(lambda: fa.mha(q, k, v), calls=20)
    out["fa_sdpa_ms"] = cs.graph_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), calls=20)
    outputs = {"fa": fa.mha(q, k, v)}
    out["fa_err"] = float((outputs["fa"].float()
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
        out[f"fd_ms_{pos}"] = cs.graph_ms(lambda: fd.decode_attn(
            qd, *caches[next(turn)], pos), calls=48)
        out[f"fd_sdpa_ms_{pos}"] = cs.graph_ms(
            lambda: F.scaled_dot_product_attention(
                qdt, *rows[next(turn)], enable_gqa=True), calls=48)
        outputs[f"fd_{pos}"] = fd.decode_attn(qd, *caches[0], pos)
        out[f"fd_err_{pos}"] = float(
            (outputs[f"fd_{pos}"].float()
             - fd.decode_attn_plain(qd, *caches[0], pos).float())
            .abs().max())
        del rows
    del caches
    torch.save({k: t.cpu() for k, t in outputs.items()}, args.save)
    torch.cuda.empty_cache()
    if args.jamba and args.run < 2:
        out.update(before_after.jamba(cs, dev, teacher_forced=True,
                                      prefill=False))
    return out


def bit_equal(other: str, this: str) -> dict:
    """Whether each output of the other checkout's run equals this one's,
    bit for bit."""
    import torch
    a, b = torch.load(other), torch.load(this)
    return {k: bool(torch.equal(a[k], b[k])) for k in sorted(a)}


if __name__ == "__main__":
    sys.exit(before_after.main(__file__, __doc__, measure, flags=[
        ("--jamba", "also jamba's bf16 teacher-forced reading")],
        compare=bit_equal))
