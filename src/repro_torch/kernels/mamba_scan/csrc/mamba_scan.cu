// Mamba selective scan for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel `mamba_scan` (src/repro/kernels/mamba_scan/
// kernel.py:49, body `_kernel` :25; wrapper `ops.py::selective_scan` :13).
// Per batch row b, channel d and state index n, from h_0 = 0:
//   h_t[d, n] = exp(dt_t[d] a[d, n]) h_{t-1}[d, n] + (dt_t[d] x_t[d]) B_t[n]
//   y_t[d]    = sum_n h_t[d, n] C_t[n]
// with dt already through softplus and a < 0.  y (B, S, D) comes out without
// the D x skip term, and the final h (B, D, N) too: the prefill cache needs
// it, while the TPU kernel keeps it in VMEM scratch and drops it.  This is
// the strict recurrence of the oracle `ref.py::mamba_scan_ref`.
//
// Why not the TPU kernel's chunk form.  Inside a 64-step chunk it forms the
// prefix decays as P = exp(cumsum(log a)) and divides the drive by them,
// b exp(-cum).  exp(-cum) overflows float32 once dt |a| summed over the chunk
// passes about 88, which jamba's dt (up to 1.0, A down to -16) reaches: at
// dt <= 0.5 thousands of outputs turn non-finite.  The recurrence has no
// such limit, and a serial walk over t costs the card little here.
//
// What bounds it on the H100: bytes.  dt and x are read once (float32: 33.5
// MB each at B = 8, S = 1024, D = 8192), B, C and a once (~1.5 MB), y
// written once (33.5 MB) and h once (4.2 MB): ~106 MB, 0.032 ms at 3.35
// TB/s, against ~7 float32 operations per state update (134 M updates,
// 0.014 ms at 67 TFLOP/s).
//
// Design.  One thread holds one h[d, n] in a register for the whole walk;
// the N threads of a channel are neighbouring lanes of one warp, so y_t is
// a shuffle (xor) tree over them, with no shared-memory round trip and no
// atomics (repeats are bit-equal).  A block of CPB = min(64, 256 / N)
// channels (16 at N = 16: 256 threads) walks t in order; grid (D / CPB, B),
// 4,096 blocks at the serving shape.  Every kTile steps the block stages
// dt and x of its channels and B_t, C_t (shared by every channel) in shared
// memory with coalesced loads, and writes the tile's y back coalesced from
// shared memory.  Everything is float32; x may be bf16 and is widened on
// load.  expf is the precise one (no fast math).  Ragged channels (D not a
// multiple of CPB) run on zeros and write nothing.  Several steps in flight
// per sync, cp.async/TMA staging and a chunked tensor-core form are the
// levers of a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;       // steps staged per sync

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <int N>
struct Shape {
  static constexpr int kChannels = (256 / N) < 64 ? (256 / N) : 64;
  static constexpr int kThreads = kChannels * N;
};

template <typename T, int N>
__global__ void __launch_bounds__(Shape<N>::kThreads)
mamba_scan_kernel(const float* __restrict__ dt, const float* __restrict__ a,
                  const T* __restrict__ x, const float* __restrict__ bm,
                  const float* __restrict__ cm, float* __restrict__ y,
                  float* __restrict__ h_out, int S, int D) {
  constexpr int CPB = Shape<N>::kChannels;
  constexpr int kThreads = Shape<N>::kThreads;
  __shared__ float dt_s[kTile][CPB];
  __shared__ float x_s[kTile][CPB];
  __shared__ float y_s[kTile][CPB];
  __shared__ float b_s[kTile][N];
  __shared__ float c_s[kTile][N];

  const int tid = threadIdx.x;
  const int ch = tid / N, n = tid % N;
  const int d0 = blockIdx.x * CPB;
  const int d = d0 + ch;
  const int row = blockIdx.y;
  const bool live = d < D;
  const float a_dn = live ? a[(size_t)d * N + n] : 0.0f;
  const size_t seq = (size_t)row * S;           // first step of this row
  float h = 0.0f;

  for (int t0 = 0; t0 < S; t0 += kTile) {
    const int steps = min(kTile, S - t0);
    __syncthreads();                            // the last tile's y is out
    for (int i = tid; i < kTile * CPB; i += kThreads) {
      const int tt = i / CPB, cc = i % CPB;
      const bool ok = tt < steps && d0 + cc < D;
      const size_t off = (seq + t0 + tt) * D + d0 + cc;
      dt_s[tt][cc] = ok ? dt[off] : 0.0f;
      x_s[tt][cc] = ok ? widen(x[off]) : 0.0f;
    }
    for (int i = tid; i < kTile * N; i += kThreads) {
      const int tt = i / N, nn = i % N;
      const bool ok = tt < steps;
      const size_t off = (seq + t0 + tt) * N + nn;
      b_s[tt][nn] = ok ? bm[off] : 0.0f;
      c_s[tt][nn] = ok ? cm[off] : 0.0f;
    }
    __syncthreads();
    for (int tt = 0; tt < steps; ++tt) {
      const float dtv = dt_s[tt][ch];
      const float decay = expf(dtv * a_dn);
      const float drive = (dtv * x_s[tt][ch]) * b_s[tt][n];
      h = decay * h + drive;
      float p = h * c_s[tt][n];
#pragma unroll
      for (int off = N / 2; off > 0; off >>= 1)
        p += __shfl_xor_sync(0xffffffffu, p, off);
      if (n == 0) y_s[tt][ch] = p;
    }
    __syncthreads();
    for (int i = tid; i < steps * CPB; i += kThreads) {
      const int tt = i / CPB, cc = i % CPB;
      if (d0 + cc < D) y[(seq + t0 + tt) * D + d0 + cc] = y_s[tt][cc];
    }
  }
  if (live) h_out[((size_t)row * D + d) * N + n] = h;
}

template <typename T, int N>
cudaError_t launch(const float* dt, const float* a, const void* x,
                   const float* b, const float* c, float* y, float* h, int B,
                   int S, int D, cudaStream_t stream) {
  constexpr int CPB = Shape<N>::kChannels;
  const dim3 grid((D + CPB - 1) / CPB, B);
  mamba_scan_kernel<T, N><<<grid, Shape<N>::kThreads, 0, stream>>>(
      dt, a, static_cast<const T*>(x), b, c, y, h, S, D);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const float* dt, const float* a, const void* x,
                     const float* b, const float* c, float* y, float* h,
                     int B, int S, int D, int N, cudaStream_t st) {
  switch (N) {
    case 1: return launch<T, 1>(dt, a, x, b, c, y, h, B, S, D, st);
    case 2: return launch<T, 2>(dt, a, x, b, c, y, h, B, S, D, st);
    case 4: return launch<T, 4>(dt, a, x, b, c, y, h, B, S, D, st);
    case 8: return launch<T, 8>(dt, a, x, b, c, y, h, B, S, D, st);
    case 16: return launch<T, 16>(dt, a, x, b, c, y, h, B, S, D, st);
    case 32: return launch<T, 32>(dt, a, x, b, c, y, h, B, S, D, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dt: (B, S, D) float32; a: (D, N) float32; x: (B, S, D) float32 (dtype 0)
// or bfloat16 (1); b, c: (B, S, N) float32; y: (B, S, D) and h: (B, D, N)
// float32; all contiguous.  Returns cudaGetLastError() after the launch.
extern "C" int mamba_scan(const float* dt, const float* a, const void* x,
                          const float* b, const float* c, float* y, float* h,
                          int B, int S, int D, int N, int dtype,
                          void* stream) {
  if (B < 1 || S < 1 || D < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 1 ? dispatch<__nv_bfloat16>(dt, a, x, b, c, y, h, B, S, D, N,
                                           st)
      : dtype == 0 ? dispatch<float>(dt, a, x, b, c, y, h, B, S, D, N, st)
                   : cudaErrorInvalidValue;
  return (int)err;
}
