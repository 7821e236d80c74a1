"""Where the graph-propagation kernels spend their time, phase by phase.

There is no ``ncu`` on the card's machine, so this copies both kernels of
``src/repro_torch/kernels/graph_prop/csrc`` into ``build/phase_clock/``
with ``clock64()`` stamps of block 0, thread 0 at their phase boundaries
(and per-level sums inside the level loops), builds the copies, runs them
through the port's own launchers (``chip_smoke.raw_launcher``,
``bwd_raw_launcher``) and prints the SM cycles of each phase beside the
kernel's time per call in a CUDA graph.  The stamps cost a few
instructions per phase; the cycles are one block's, which is the kernel's
time where one wave of blocks covers the batch (the training shape, B 96
on 132 SMs).

Shapes: B 96, N 8, levels 8 and levels 3 (the training ring), both
kernels; B 378, N 16, levels 3 (the LR decision sweep), the forward.
Each anchor below must occur once in the current sources; the tool stops
naming the one it does not find.  Needs one card.

    python tools/graph_prop_phase_clock.py
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src" / "repro_torch" / "kernels" / "graph_prop" / "csrc"
OUT = ROOT / "build" / "phase_clock"

PRELUDE = """__device__ long long phase_clock[64];
#define STAMP(k) do { if (threadIdx.x == 0 && blockIdx.x == 0) \\
    phase_clock[k] = clock64(); } while (0)
#define STAMP_ADD(k, v) do { if (threadIdx.x == 0 && blockIdx.x == 0) \\
    phase_clock[k] += (v); } while (0)
"""
READER = """
extern "C" int read_phase_clock(long long* host) {
  return (int)cudaMemcpyFromSymbol(host, phase_clock, sizeof(long long) * 64);
}
"""

# (anchor, text inserted after it); slots 0-9 are stamps, 20-24 sums
FWD = [
    ("  const bool edge = pair && in.adj[row + j];\n", "  STAMP(0);\n"),
    ("  cp_wait();\n  __syncthreads();\n", "  STAMP(1);\n"),
    ("  node_halves<S>(sw, sx, su, sv, i, lane);\n  __syncthreads();\n",
     "  STAMP(2);\n"),
    ("  if (pair && s == 0) e_out[row + j] = e;\n", "  STAMP(3);\n"),
    ("  for (int lv = 0; lv < levels; ++lv) {\n",
     "    const long long q0 = clock64();\n"),
    ("      smh[i * HS + lane] = node_mh((obs ? smobs : smcur) + i * MS, "
     "w41m);\n    }\n    __syncthreads();\n",
     "    const long long q1 = clock64();\n    STAMP_ADD(21, q1 - q0);\n"),
    ("                                      lane, c);\n",
     "    const long long q2 = clock64();\n    STAMP_ADD(24, q2 - q1);\n"),
    ("                              : fmaf(esum, sw[L::B42 + c], mi);\n"
     "    __syncthreads();\n", "    STAMP_ADD(22, clock64() - q2);\n"),
    ("        (levels == 0 ? smobs : smcur)[node * MS + c];\n  }\n",
     "  STAMP(4);\n"),
]
BWD = [
    ("  const float ge_in = pair ? g_e[row + j] : 0.f;\n", "  STAMP(0);\n"),
    ("  cp_wait();\n  __syncthreads();\n", "  STAMP(1);\n"),
    ("  node_halves<S>(sw, sx, su, sv, i, lane);\n  __syncthreads();\n",
     "  STAMP(2);\n"),
    ("  if (lane == 0) sesum[i] = esum;\n", "  STAMP(3);\n"),
    ("  float gp[NM];\n", "  STAMP(4);\n"),
    ("  for (int t = levels - 1; t >= 0; --t) {\n",
     "    const long long t0 = clock64();\n"),
    ("          st_v[p * MS + 4] = v[4];\n        }\n      }\n    }\n"
     "    __syncthreads();\n",
     "    const long long t1 = clock64();\n    STAMP_ADD(20, t1 - t0);\n"),
    ("      for (int c = 0; c < NM; ++c) gp[c] = obs ? 0.f : gmj[c];\n"
     "    }\n", "    STAMP_ADD(23, clock64() - t1);\n"),
    ("  __syncthreads();              // the pair vectors below reuse the "
     "staging\n", "  STAMP(5);\n"),
    ("    sab[i * HID + lane] = accb;\n  }\n  __syncthreads();\n",
     "  STAMP(6);\n"),
    ("  // ---- f3's first layer per node: gW31, gx; and gm_obs\n",
     "  STAMP(7);\n"),
    ("      gmo_out[g * n * NM + r] = sgmo[(r / NM) * MS + r % NM];\n"
     "    }\n  }\n", "  STAMP(8);\n"),
]
FWD_PHASES = ("staging", "node halves", "pair forward + softmax", "levels")
BWD_PHASES = ("staging", "node halves", "pair forward + softmax",
              "forward levels", "reverse levels", "pair backward",
              "weight tiles", "per-node sums")


def patched(name: str, marks) -> Path:
    text = (SRC / name).read_text()
    include = '#include "graph_prop_common.cuh"\n'
    text = text.replace(include, include + PRELUDE)
    for anchor, ins in marks:
        if text.count(anchor) != 1:
            raise SystemExit(f"{name}: anchor found {text.count(anchor)} "
                             f"times, not once:\n{anchor}")
        text = text.replace(anchor, anchor + ins)
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "graph_prop_common.cuh").write_text(
        (SRC / "graph_prop_common.cuh").read_text())
    path = OUT / name
    path.write_text(text + READER)
    return path


def main() -> int:
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.core.model import init_enel
    from repro_torch.kernels import build
    from repro_torch.kernels.graph_prop import ops

    if not torch.cuda.is_available():
        print("graph_prop_phase_clock: needs a card")
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    libs = {}
    for kind, name, marks in (("fwd", "graph_prop_fwd.cu", FWD),
                              ("bwd", "graph_prop_bwd.cu", BWD)):
        libs[kind] = build.load(patched(name, marks), f"phase_clock_{kind}")
    ops._FN = libs["fwd"].graph_prop_fwd
    ops._FN.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 7 + \
        [ctypes.c_void_p]
    ops._FN_BWD = libs["bwd"].graph_prop_bwd
    ops._FN_BWD.argtypes = [ctypes.c_void_p] * 19 + [ctypes.c_int] * 7 + \
        [ctypes.c_void_p]

    def clock(kind):
        buf = (ctypes.c_longlong * 64)()
        assert libs[kind].read_phase_clock(buf) == 0
        return list(buf)

    def run(kind, launch, levels, phases):
        for _ in range(10):
            launch()
        torch.cuda.synchronize()
        before = clock(kind)
        launch()
        torch.cuda.synchronize()
        c = clock(kind)
        out = {nm: c[k + 1] - c[k] for k, nm in enumerate(phases)}
        out["total"] = c[len(phases)] - c[0]
        per_level = {"fwd": {"node phase": 21, "message": 24,
                             "write + sync": 22},
                     "bwd": {"pair phase": 20, "column phase": 23}}[kind]
        out["per_level"] = {nm: (c[k] - before[k]) / max(levels, 1)
                            for nm, k in per_level.items()}
        out["graph_ms"] = cs.graph_ms(launch)
        return out

    dev = torch.device("cuda")
    params = init_enel(torch.Generator().manual_seed(cs.SEED), device=dev)
    rng = np.random.RandomState(cs.SEED)
    results = {"card": card}
    for b, n, levels in ((96, 8, 8), (96, 8, 3), (378, 16, 3)):
        x, adj, m, valid = cs.random_inputs(rng, b, n, dev)
        tag = f"B{b}_N{n}_L{levels}"
        fl = cs.raw_launcher(ops, params, x, adj, m, valid, levels)
        results[f"fwd_{tag}"] = run("fwd", fl, levels, FWD_PHASES)
        if n == 8:
            g_e = torch.tensor(rng.randn(b, n, n).astype(np.float32),
                               device=dev)
            g_m = torch.tensor(rng.randn(b, n, 5).astype(np.float32),
                               device=dev)
            bl = cs.bwd_raw_launcher(ops, params, x, adj, m, valid, g_e,
                                     g_m, levels)
            results[f"bwd_{tag}"] = run("bwd", bl, levels, BWD_PHASES)
    for key, val in results.items():
        if key != "card":
            print(key, json.dumps(val), flush=True)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
