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
// such limit.
//
// What bounds it on the H100.  The bytes: dt (float32) and x (bf16) read
// once, y (float32) written once, at B = 8, S = 1024, D = 8192: 268 + 134 +
// 268 MB, with B, C, a and the final h ~6.8 MB more, 676.9 MB in all, 0.202
// ms at 3.35 TB/s (`chip_smoke.py::mamba_work`).  But the precise exp of
// every state update is the nearer floor: B S D N = 1.07 G exponentials at
// 16 MUFU.EX2 per SM per clock take 0.2568 ms on 132 SMs at the card's
// highest SM clock, 1.98 GHz (`chip_smoke.py::mamba_exp_floor_ms`), more
// at any lower clock, and the ~12 issued instructions an update needs
// (the exp's range reduction, dt a, the drive, one fma, h C and the sum)
// ~0.39 ms of issue at that clock.  A kernel that keeps the precise exp
// cannot reach half of the bytes bound.
//
// Design: one thread per channel, its N states in registers.
//   - Thread d of a block holds h[d, 0..N-1] and a[d, 0..N-1] in registers
//     for the whole walk over t: N independent recurrences of ILP, and y_t
//     is a sum in registers, with no shuffles (N lanes a channel would need
//     log2 N shuffles per state update, 4.3 G at the serving shape).
//   - Consecutive threads are consecutive channels, so dt_t[d] and x_t[d]
//     are read, and y_t[d] written, straight from and to global memory in
//     coalesced 128-byte rows.  The next kU steps of dt and x are loaded into
//     registers while the current kU steps compute.
//   - B_t and C_t (2 N floats a step, shared by every channel of the batch
//     row) are staged kTile steps at a time in shared memory with cp.async,
//     double-buffered (one barrier per tile), and read as broadcasts.
//   - Block of kThreads = 128 channels, grid (ceil(D / 128), B): 512 blocks
//     at the serving shape, ~500 threads per SM.  Ragged channels (D not a
//     multiple of 128) load nothing and write nothing.
//   - Every rounding is fixed, so that y and h stay bit for bit those of
//     the shuffle design before it (jamba's bf16 teacher-forced check has
//     little margin): the precise expf of the rounded dt a; drive = (dt x)
//     B_n, two rounded products; h = fmaf(decay, h, drive); p_n = h_n C_n
//     rounded (__fmul_rn); y_t summed in the order an xor butterfly over N
//     lanes gives lane 0, ((p0 + p8) + (p4 + p12)) + ((p2 + p10) + (p6 +
//     p14)), then the same over the odd indices, added last (__fadd_rn, so
//     that nvcc contracts nothing).  Repeats are bit-equal.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // channels per block, one thread each
constexpr int kTile = 32;       // steps of B_t, C_t staged per barrier
constexpr int kU = 8;           // steps of dt, x loaded ahead into registers

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The sum of p[0..N) in the order an xor butterfly over N lanes gives lane
// 0: p[i] += p[i + H] for H = N / 2, N / 4, .., 1, unrolled at compile time
// (a loop whose bound halves stays a loop and puts p in local memory).
template <int N, int H = N / 2>
struct ButterflySum {
  static __device__ __forceinline__ float at0(float (&p)[N]) {
#pragma unroll
    for (int i = 0; i < H; ++i) p[i] = __fadd_rn(p[i], p[i + H]);
    return ButterflySum<N, H / 2>::at0(p);
  }
};
template <int N>
struct ButterflySum<N, 0> {
  static __device__ __forceinline__ float at0(float (&p)[N]) { return p[0]; }
};

// B and C of steps [t0, t0 + steps) of one batch row into one tile buffer:
// row tt holds B_t (N floats) then C_t (N floats).
template <int N>
__device__ __forceinline__ void stage_bc(float (*buf)[2 * N],
                                         const float* __restrict__ bm,
                                         const float* __restrict__ cm,
                                         size_t first, int steps) {
  for (int i = threadIdx.x; i < steps * N; i += kThreads) {
    const int tt = i / N, nn = i % N;
    cp_async4(&buf[tt][nn], bm + (first + tt) * N + nn);
    cp_async4(&buf[tt][N + nn], cm + (first + tt) * N + nn);
  }
  cp_async_commit();
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
    mamba_scan_kernel(const float* __restrict__ dt,
                      const float* __restrict__ a, const T* __restrict__ x,
                      const float* __restrict__ bm,
                      const float* __restrict__ cm, float* __restrict__ y,
                      float* __restrict__ h_out, int S, int D) {
  __shared__ __align__(16) float bc_s[2][kTile][2 * N];
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const int row = blockIdx.y;
  const bool live = d < D;
  const size_t seq = (size_t)row * S;           // first step of this row
  float a_r[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a_r[n] = live ? a[(size_t)d * N + n] : 0.f;
    h[n] = 0.f;
  }
  // dt, x of the next kU steps, in flight while the current ones compute
  float dt_n[kU], x_n[kU];
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const bool ok = live && u < S;
    dt_n[u] = ok ? dt[(seq + u) * D + d] : 0.f;
    x_n[u] = ok ? widen(x[(seq + u) * D + d]) : 0.f;
  }
  stage_bc<N>(bc_s[0], bm, cm, seq, min(kTile, S));

  for (int t0 = 0, tile = 0; t0 < S; t0 += kTile, ++tile) {
    const int steps = min(kTile, S - t0);
    cp_async_wait_all();
    __syncthreads();   // this tile is in; every thread is past the last one
    if (t0 + kTile < S)
      stage_bc<N>(bc_s[(tile + 1) & 1], bm, cm, seq + t0 + kTile,
                  min(kTile, S - t0 - kTile));
    const float(*bc)[2 * N] = bc_s[tile & 1];
    for (int g0 = 0; g0 < steps; g0 += kU) {
      float dt_c[kU], x_c[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        dt_c[u] = dt_n[u];
        x_c[u] = x_n[u];
        const int t = t0 + g0 + kU + u;
        const bool ok = live && t < S;
        dt_n[u] = ok ? dt[(seq + t) * D + d] : 0.f;
        x_n[u] = ok ? widen(x[(seq + t) * D + d]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int tt = g0 + u;
        if (tt < steps) {
          const float dtv = dt_c[u];
          const float dx = __fmul_rn(dtv, x_c[u]);
          float p[N];
#pragma unroll
          for (int n = 0; n < N; ++n) {
            const float decay = expf(__fmul_rn(dtv, a_r[n]));
            const float drive = __fmul_rn(dx, bc[tt][n]);
            h[n] = fmaf(decay, h[n], drive);
            p[n] = __fmul_rn(h[n], bc[tt][N + n]);
          }
          if (live) y[(seq + t0 + tt) * D + d] = ButterflySum<N>::at0(p);
        }
      }
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < N; ++n) h_out[((size_t)row * D + d) * N + n] = h[n];
  }
}

template <typename T, int N>
cudaError_t launch(const float* dt, const float* a, const void* x,
                   const float* b, const float* c, float* y, float* h, int B,
                   int S, int D, cudaStream_t stream) {
  const dim3 grid((D + kThreads - 1) / kThreads, B);
  mamba_scan_kernel<T, N><<<grid, kThreads, 0, stream>>>(
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
