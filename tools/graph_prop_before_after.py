"""The port's two graph-propagation kernels in two checkouts, on one card, in
one run.

Times ``graph_prop_bwd`` at the training shape (B 96, N 8, levels 8: the
96-graph ring of a scratch fit) and ``graph_prop_fwd`` at that shape and at
the LR decision shape (B 378, N 16, levels 3: 18 candidates x 21
components), each as the device time per call of a CUDA graph of
back-to-back calls through the checkout's ``ops`` (``graph_prop``,
``_launch_bwd``), on seeded random graphs (``chip_smoke.random_inputs``; the
kernels' work does not depend on the values).  Then a 128-step scratch fit
of LR (``JobExperiment("lr").profile()``, then ``fit_resident(steps=160,
from_scratch=True)`` as ``chip_smoke.py`` phase 7 times it): its host wall
time and, from a profiler trace, its device-busy time and the part of it in
the graph-propagation kernels.

Each checkout runs in its own process, in the order other, this, this,
other (``before_after.py``), so that a drift of the card over the run
shows.  ``--other`` names a checkout of another commit, e.g. the parent
unpacked with ``git archive`` into a git-ignored directory, whose
``chip_smoke.py`` has ``graph_ms``.  Needs one card.

    python tools/graph_prop_before_after.py --other build/parent
"""
from __future__ import annotations

import sys

import before_after

SHAPES = ((96, 8, 8), (378, 16, 3))     # (B, N, levels): training, decision


def measure(root: str, args) -> dict:
    """One checkout's numbers; ``root`` is first on ``sys.path``."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.core.model import init_enel
    from repro_torch.dataflow.runner import JobExperiment
    from repro_torch.kernels.graph_prop import ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_grad_enabled(False)
    dev = torch.device("cuda")
    rng = np.random.RandomState(cs.SEED + 1)
    params = init_enel(torch.Generator().manual_seed(cs.SEED), device=dev)
    out = {"root": root}
    for b, n, levels in SHAPES:
        x, adj, m, valid = cs.random_inputs(rng, b, n, dev)
        tag = f"B{b}_N{n}_L{levels}"
        out[f"fwd_ms_{tag}"] = cs.graph_ms(
            lambda: ops.graph_prop(params, x, adj, m, valid, levels=levels))
        if n == 8:
            g_e = torch.tensor(rng.randn(b, n, n).astype(np.float32),
                               device=dev)
            g_m = torch.tensor(rng.randn(b, n, 5).astype(np.float32),
                               device=dev)
            w = ops._weights(params)
            out[f"bwd_ms_{tag}"] = cs.graph_ms(
                lambda: ops._launch_bwd(x, adj, m, valid, w, g_e, g_m,
                                        levels))
    torch.set_grad_enabled(True)
    ex = JobExperiment("lr", seed=cs.SEED, device=dev)
    ex.profile()
    tr = ex.trainer
    fit = lambda: tr.fit_resident(steps=160, from_scratch=True)
    out["fit_steps"] = 128
    out["fit_wall_ms"] = cs.median_wall_ms(fit, reps=3, warmup=1)
    busy, per, kernels = cs.profile_device(
        fit, reps=2, names=("graph_prop_fwd", "graph_prop_bwd", "sum_slots"))
    out["fit_busy_ms"] = busy
    out["fit_graph_prop_ms"] = sum(per.values())
    out["fit_graph_prop_ms_by_kernel"] = per
    out["fit_kernels"] = kernels
    return out


if __name__ == "__main__":
    sys.exit(before_after.main(__file__, __doc__, measure))
