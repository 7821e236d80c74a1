"""Where the mLSTM kernel's bf16 route spends its time, phase by phase.

There is no ``ncu`` on the card's machine, so this copies
``src/repro_torch/kernels/mlstm_chunk/csrc/mlstm_chunk.cu`` into
``build/phase_clock/`` with ``clock64()`` laps taken by lane 0 of every warp
of block (0, 0, 0) at the phase boundaries of the tensor-core route's chunk
loop, summed over the chunks, builds the copy, runs it at xlstm-350m's
prefill shape (B 8, S 1024, H 4, D 256, bf16) through the port's own
launcher (``ops._launch``) and prints each warp's SM cycles per phase beside
the kernel's time per call in a CUDA graph.  A warp's cycles in the two
barrier phases are its waits for the others (and for the next chunk's
copies), so the per-warp rows show both the work of each phase and the
imbalance between warps.  The laps cost a few instructions each.

Each anchor below must occur once in the current source; the tool stops
naming the one it does not find.  Needs one card.

    python tools/mlstm_phase_clock.py
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src" / "repro_torch" / "kernels" / "mlstm_chunk" / "csrc"
OUT = ROOT / "build" / "phase_clock"
WARPS, SLOTS = 8, 8

PRELUDE = f"""__device__ long long phase_clock[{WARPS}][{SLOTS}];
#define LAP(k) do {{ if ((threadIdx.x & 31) == 0 && blockIdx.x == 0 && \\
    blockIdx.y == 0 && blockIdx.z == 0) {{ const long long now = clock64(); \\
    phase_clock[threadIdx.x >> 5][k] += now - lap_t; lap_t = now; }} }} \\
    while (0)
"""
READER = f"""
extern "C" int read_phase_clock(long long* host) {{
  return (int)cudaMemcpyFromSymbol(host, phase_clock,
                                   sizeof(long long) * {WARPS * SLOTS});
}}
"""
PHASES = ("wait + barrier (next chunk in)", "issue the next copies",
          "outputs (q k^T, q C, W V, store h)",
          "C and n update (mma)", "gates of the next chunk (warp 0)",
          "barrier (C readers done)", "store C hi, lo and n",
          "prologue and epilogue")

# (anchor, text inserted after it)
MARKS = [
    ("  const size_t gate0 = (size_t)bb * S * H + hh;\n",
     "  long long lap_t = clock64();\n"),
    ("  load_chunk(0, 0);\n", "  LAP(7);\n"),
    ("    __syncthreads();   // chunk c is in; every thread is past chunk "
     "c - 1\n", "    LAP(0);\n"),
    ("      if (warp == 0) load_gates(c + 1);\n    }\n", "    LAP(1);\n"),
    ("    // ---- C <- g C + (k e / sqrt(D))^T V and n <- g n + sum_s k e / "
     "sqrt(D)\n", "    LAP(2);\n"),
    ("        n_r[i][e] = g_old * n_r[i][e] + x;\n      }\n",
     "    LAP(3);\n"),
    ("    if (warp == 0 && c + 1 < n_chunks) gate_phase(c + 1, st ^ 1);\n",
     "    LAP(4);\n"),
    ("    __syncthreads();   // every reader of C hi, lo and n is done\n",
     "    LAP(5);\n"),
    ("  if (slice == 0 && tid == 0) m_out[head] = m_run;\n", "  LAP(7);\n"),
]
# the store phase ends where the next chunk's wait begins
STORE_END = ("    const int st = c & 1, c0 = c * kL, lv = min(kL, S - c0);\n",
             "    if (c > 0) LAP(6);\n")


def patched() -> Path:
    text = (SRC / "mlstm_chunk.cu").read_text()
    include = "#include <stdint.h>\n"
    text = text.replace(include, include + PRELUDE, 1)
    for anchor, ins in MARKS + [STORE_END]:
        if text.count(anchor) != 1:
            raise SystemExit(f"mlstm_chunk.cu: anchor found "
                             f"{text.count(anchor)} times, not once:\n"
                             f"{anchor}")
        text = text.replace(anchor, anchor + ins)
    OUT.mkdir(parents=True, exist_ok=True)
    path = OUT / "mlstm_chunk.cu"
    path.write_text(text + READER)
    return path


def main() -> int:
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.mlstm_chunk import ops

    if not torch.cuda.is_available():
        print("mlstm_phase_clock: needs a card")
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    lib = build.load(patched(), "phase_clock_mlstm")
    ops._FN = lib.mlstm_chunk
    ops._FN.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + \
        [ctypes.c_void_p]
    ops._FN.restype = ctypes.c_int

    def clock():
        buf = (ctypes.c_longlong * (WARPS * SLOTS))()
        assert lib.read_phase_clock(buf) == 0
        return np.array(list(buf), dtype=np.int64).reshape(WARPS, SLOTS)

    dev = torch.device("cuda")
    b, s, h, d = 8, 1024, 4, 256
    rng = np.random.RandomState(cs.SEED + 3)
    q, k, v, gi, gf = cs.mlstm_inputs(rng, b, s, h, d, torch.bfloat16, dev)
    out = torch.empty_like(q)
    st = (torch.empty((b, h, d, d), dtype=torch.float32, device=dev),
          torch.empty((b, h, d), dtype=torch.float32, device=dev),
          torch.empty((b, h), dtype=torch.float32, device=dev))
    launch = lambda: ops._launch(q, k, v, gi, gf, out, *st)
    for _ in range(5):
        launch()
    torch.cuda.synchronize()
    before = clock()
    launch()
    torch.cuda.synchronize()
    cyc = clock() - before
    res = {"card": card, "shape": {"B": b, "S": s, "H": h, "D": d},
           "graph_ms": cs.graph_ms(launch),
           "phases": list(PHASES),
           "cycles_per_warp": cyc.tolist(),
           "total_per_warp": cyc.sum(axis=1).tolist()}
    print(f"mlstm_chunk bf16 at B={b} S={s} H={h} D={d}: "
          f"{res['graph_ms']:.4f} ms a call in a CUDA graph; SM cycles of "
          f"block 0, summed over {(s + 63) // 64} chunks")
    print("  phase" + " " * 36 + "".join(f"  warp {w}" for w in range(WARPS)))
    for k, name in enumerate(PHASES):
        print(f"  {name:40s}" + "".join(f"{c:8d}" for c in cyc[:, k]))
    print(f"  {'total':40s}" + "".join(f"{c:8d}" for c in cyc.sum(axis=1)))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
