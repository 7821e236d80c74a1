"""The port's two recurrent kernels in two checkouts, on one card, in one run.

Times ``mlstm_chunk`` at xlstm-350m's prefill shape (B 8, S 1024, H 4, D
256, bf16) and ``mamba_scan`` at jamba's (B 8, S 1024, D 8192, N 16, x
bf16, dt up to 1.0), each as the device time per call of a CUDA graph of
back-to-back raw launches (``chip_smoke.graph_ms``; and as CUDA events
around back-to-back launches), on the same seeded inputs in every
checkout, with each kernel's ``ptxas -v`` registers and spills.  It then
reports whether ``mamba_scan``'s y and final h are bit-equal between the
checkouts, and the largest difference of ``mlstm_chunk``'s h and state
(C, n, m).  With ``--jamba`` it also times jamba's wave-0 prefill (one
period at full width, B 8, P 1024: host wall, device busy, ``mamba_scan``'s
part) in every run and takes its bf16 teacher-forced reading and routing
flips (``chip_smoke.py`` phase 15) in the first two; with ``--xlstm`` it
times xlstm-350m's wave-0 prefill the same way (``mlstm_chunk``'s part).

Each checkout runs in its own process, in the order other, this, this,
other (``before_after.py``), so that a drift of the card over the run
shows.  ``--other`` names a checkout of another commit, e.g. the parent
unpacked with ``git archive`` into a git-ignored directory, whose
``chip_smoke.py`` has ``graph_ms``.  Needs one card.

    python tools/ssm_kernels_before_after.py --other build/parent \
        [--jamba] [--xlstm]
"""
from __future__ import annotations

import sys

import before_after

# the mLSTM kernel's entry in ptxas's log: the tensor-core route since this
# design, the generic one before it
MLSTM_SYMBOLS = ("mlstm_kernel_tcILi256E",
                 "mlstm_kernelI13__nv_bfloat16Li256E")
MAMBA_SYMBOL = "mamba_scan_kernelI13__nv_bfloat16Li16E"


def measure(root: str, args) -> dict:
    """One checkout's numbers; ``root`` is first on ``sys.path``.  In the
    first two runs the kernels' outputs go to ``args.save``."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.mamba_scan import ops as ms
    from repro_torch.kernels.mlstm_chunk import ops as ml

    def regs(kname, symbols):
        for sym in symbols:
            got = cs.ptxas_usage(kname, sym)
            if "registers" in got:
                return got
        return got
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_grad_enabled(False)
    dev, f32, bf16 = torch.device("cuda"), torch.float32, torch.bfloat16
    out = {"root": root}
    saved = {}

    b, s, h, d = 8, 1024, 4, 256
    rng = np.random.RandomState(cs.SEED + 3)
    q, k, v, gi, gf = cs.mlstm_inputs(rng, b, s, h, d, bf16, dev)
    o = torch.empty_like(q)
    st = (torch.empty((b, h, d, d), dtype=f32, device=dev),
          torch.empty((b, h, d), dtype=f32, device=dev),
          torch.empty((b, h), dtype=f32, device=dev))
    launch = lambda: ml._launch(q, k, v, gi, gf, o, *st)
    out["mlstm_ms"] = cs.graph_ms(launch, calls=20)
    out["mlstm_back_to_back_ms"] = cs.median_ms(launch, burst=5, reps=10)
    out["mlstm_ptxas"] = regs("mlstm_chunk", MLSTM_SYMBOLS)
    launch()
    torch.cuda.synchronize()
    saved.update(mlstm_h=o.clone(), mlstm_C=st[0].clone(),
                 mlstm_n=st[1].clone(), mlstm_m=st[2].clone())
    ref, rst = ml.mlstm_plain(q, k, v, gi, gf, chunk=256, return_state=True)
    out["mlstm_err_vs_plain"] = float((o.float() - ref.float()).abs().max())
    out["mlstm_state_err_vs_plain"] = max(
        float((a - rst[key]).abs().max())
        for a, key in zip(st, ("C", "n", "m")))
    del q, k, v, gi, gf, o, st, ref, rst

    b, s, d, n = 8, 1024, 8192, 16
    rng = np.random.RandomState(cs.SEED + 5)
    dt, a, x, bm, cm = cs.mamba_inputs(rng, b, s, d, n, (0.0, 1.0), bf16, dev)
    y = torch.empty((b, s, d), dtype=f32, device=dev)
    hs = torch.empty((b, d, n), dtype=f32, device=dev)
    launch = lambda: ms._launch(dt, a, x, bm, cm, y, hs)
    out["mamba_ms"] = cs.graph_ms(launch, calls=10)
    out["mamba_back_to_back_ms"] = cs.median_ms(launch, burst=10, reps=10)
    out["mamba_ptxas"] = regs("mamba_scan", (MAMBA_SYMBOL,))
    launch()
    torch.cuda.synchronize()
    saved.update(mamba_y=y.clone(), mamba_h=hs.clone())
    del dt, a, x, bm, cm, y, hs
    torch.cuda.empty_cache()
    if args.run < 2:
        torch.save({key: t.cpu() for key, t in saved.items()}, args.save)
    if args.jamba:
        out.update(before_after.jamba(cs, dev, teacher_forced=args.run < 2,
                                      prefill=True))
    if args.xlstm:
        out.update(before_after.xlstm_prefill(cs, dev))
    return out


def compare(other: str, this: str) -> dict:
    """Bit-equality of mamba_scan's y and h, largest mLSTM differences."""
    import torch
    a, b = torch.load(other), torch.load(this)
    res = {"mamba_y_bit_equal": bool(torch.equal(a["mamba_y"],
                                                 b["mamba_y"])),
           "mamba_h_bit_equal": bool(torch.equal(a["mamba_h"],
                                                 b["mamba_h"]))}
    for key in ("mamba_y", "mamba_h"):
        diff = (a[key] - b[key]).abs()
        res[f"{key}_max_abs_diff"] = float(diff.max())
        res[f"{key}_elements_differing"] = int((diff > 0).sum())
    for key in ("mlstm_h", "mlstm_C", "mlstm_n", "mlstm_m"):
        res[f"{key}_max_abs_diff"] = float(
            (a[key].float() - b[key].float()).abs().max())
    return res


if __name__ == "__main__":
    sys.exit(before_after.main(__file__, __doc__, measure, flags=[
        ("--jamba", "also jamba's prefill times and bf16 teacher-forced "
                    "reading"),
        ("--xlstm", "also xlstm-350m's prefill times")], compare=compare))
