// Flash attention forward for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel `flash_attention` (src/repro/kernels/flash_attention/
// kernel.py:67, body `_kernel` :25): online-softmax attention with GQA (query
// head h reads kv head h / (H / Kh)), causal and sliding-window masks, the
// tanh logit softcap and the `kv_len` tail mask, for head dims up to 256.
//
// What bounds it on the H100: at prefill shapes the work is 4 * B * H * D *
// (pairs seen) FLOPs against reading q, k, v and writing o once, about 300
// operations per byte at S = 1024, D = 128: operations, at the tensor cores'
// 989 TFLOP/s in bf16.  This first kernel does its products on the CUDA
// cores in float32 (about 67 TFLOP/s at best), so it sits well above that
// bound; `wgmma` with TMA-fed tiles is the step of a later change.
//
// Design.  The TPU kernel walks the kv blocks as a sequential grid axis and
// carries (m, l, acc) in VMEM from one grid step to the next.  Blocks on a
// GPU run in no order, so here one block of 256 threads owns one (batch,
// head, q-tile) and loops over the kv tiles itself:
//   - q, k, v are read in the model's (B, S, H, D) / (B, S, Kh, D) layout
//     through strides; nothing is transposed or padded by the caller.  Tiles
//     are staged in shared memory as float32 (rows padded by one float so the
//     column reads of the score loop hit 16 different banks); the ragged tail
//     of S is masked in the kernel.
//   - the 16 x 16 threads each hold an RQ x RK block of scores and RQ rows of
//     the output accumulator in registers; the row max and row sum of the
//     online softmax are xor-shuffles over the 16 lanes that share a row, so
//     every lane ends with the same value.
//   - kv tiles that lie wholly above the causal diagonal or before the window
//     of every row of the block are skipped (the TPU kernel visits and masks
//     them).  Masked logits inside a visited tile are -1e30 and l is floored
//     at 1e-20, as in the reference, so the result is the same as visiting
//     every tile.  A block holding a row that sees no key at all visits every
//     tile, which gives that row the mean of V as the reference does.
//   - q-tiles are issued last-first, so the longest causal rows start first.
// bf16 and float32 inputs are loaded as they are; scores, softmax state and
// accumulators are float32; the output is rounded to the input's type.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

struct Args {
  long long qb, qs, qh, qd;   // strides, in elements
  long long kb, ks, kh, kd;
  long long vb, vs, vh, vd;
  long long ob, os, oh, od;
  int b, sq, sk, h, n_kv, d, causal, window, kv_len;
  float scale, softcap;
};

template <typename T, int DMAX, int RQ, int RK>
__global__ void __launch_bounds__(kThreads)
    fa_fwd(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ o, Args a) {
  constexpr int BQ = 16 * RQ, BK = 16 * RK;
  constexpr int RS = DMAX + 1;   // padded row stride of the Q and K tiles
  constexpr int PS = BK + 1;     // padded row stride of the P tile
  constexpr int DC = DMAX / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;              // BQ x RS
  float* ks = qs + BQ * RS;      // BK x RS
  float* vs = ks + BK * RS;      // BK x DMAX
  float* ps = vs + BK * DMAX;    // BQ x PS

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int hq = blockIdx.y, bb = blockIdx.z;
  const int hk = hq / (a.h / a.n_kv);
  const int d = a.d;

  const T* qbase = q + bb * a.qb + hq * a.qh;
  for (int i = tid; i < BQ * DMAX; i += kThreads) {
    const int r = i / DMAX, c = i % DMAX;
    float x = 0.f;
    if (q0 + r < a.sq && c < d)
      x = to_f(qbase[(long long)(q0 + r) * a.qs + c * a.qd]);
    qs[r * RS + c] = x;
  }

  // Row i sees keys [lo_i, hi_i]; a row with none makes the block visit all.
  bool empty = false;
  if (tid < BQ && q0 + tid < a.sq) {
    const int i = q0 + tid;
    const int lo = a.window ? max(0, i - a.window + 1) : 0;
    const int hi = a.causal ? min(i, a.kv_len - 1) : a.kv_len - 1;
    empty = lo > hi;
  }
  int kbeg = 0, kend = a.sk;
  if (!__syncthreads_or(empty)) {
    const int qlast = min(q0 + BQ, a.sq) - 1;
    kbeg = a.window ? max(0, q0 - a.window + 1) : 0;
    kend = a.causal ? min(a.kv_len, qlast + 1) : a.kv_len;
  }

  float m[RQ], l[RQ], acc[RQ][DC];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  const T* kbase = k + bb * a.kb + hk * a.kh;
  const T* vbase = v + bb * a.vb + hk * a.vh;
  for (int k0 = (kbeg / BK) * BK; k0 < kend; k0 += BK) {
    __syncthreads();   // the previous tile's readers are done
    for (int i = tid; i < BK * DMAX; i += kThreads) {
      const int r = i / DMAX, c = i % DMAX;
      float kx = 0.f, vx = 0.f;
      if (k0 + r < a.sk && c < d) {
        const long long key = k0 + r;
        kx = to_f(kbase[key * a.ks + c * a.kd]);
        vx = to_f(vbase[key * a.vs + c * a.vd]);
      }
      ks[r * RS + c] = kx;
      vs[r * DMAX + c] = vx;
    }
    __syncthreads();

    float s[RQ][RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < DMAX; ++c) {
      float qv[RQ], kv[RK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) qv[i] = qs[(ty * RQ + i) * RS + c];
#pragma unroll
      for (int j = 0; j < RK; ++j) kv[j] = ks[(tx + 16 * j) * RS + c];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int qi = q0 + ty * RQ + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const int kj = k0 + tx + 16 * j;
        float x = s[i][j] * a.scale;
        if (a.softcap > 0.f) x = tanhf(x / a.softcap) * a.softcap;
        const bool ok = kj < a.kv_len && (!a.causal || kj <= qi) &&
                        (!a.window || qi - kj < a.window);
        x = ok ? x : kNegInf;
        s[i][j] = x;
        if (kj < a.sk) mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const int kj = k0 + tx + 16 * j;
        const float pj = kj < a.sk ? expf(s[i][j] - m_new) : 0.f;
        ps[(ty * RQ + i) * PS + tx + 16 * j] = pj;
        rs += pj;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float vv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = vs[kk * DMAX + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const float pv = ps[(ty * RQ + i) * PS + kk];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pv, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qi = q0 + ty * RQ + i;
    if (qi >= a.sq) continue;
    const float den = fmaxf(l[i], 1e-20f);
    T* orow = o + bb * a.ob + (long long)qi * a.os + hq * a.oh;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = tx + 16 * c;
      if (col < d) store(orow + col * a.od, acc[i][c] / den);
    }
  }
}

template <typename T, int DMAX, int RQ, int RK>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const Args& a, cudaStream_t stream) {
  constexpr int BQ = 16 * RQ, BK = 16 * RK;
  const size_t smem = sizeof(float) * (BQ * (DMAX + 1) + BK * (DMAX + 1) +
                                       BK * DMAX + BQ * (BK + 1));
  auto kern = fa_fwd<T, DMAX, RQ, RK>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.sq + BQ - 1) / BQ, a.h, a.b);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     const Args& a, cudaStream_t stream) {
  if (a.d <= 32) return launch<T, 32, 4, 4>(q, k, v, o, a, stream);
  if (a.d <= 64) return launch<T, 64, 4, 4>(q, k, v, o, a, stream);
  if (a.d <= 128) return launch<T, 128, 4, 2>(q, k, v, o, a, stream);
  return launch<T, 256, 2, 2>(q, k, v, o, a, stream);
}

}  // namespace

// q (B, Sq, H, D), k and v (B, Sk, Kh, D), o (B, Sq, H, D), each with its
// strides in elements; dtype 0 = float32, 1 = bfloat16.  Returns the CUDA
// error of the launch (0 on success).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, long long qb,
    long long qs, long long qh, long long qd, long long kb, long long ks,
    long long kh, long long kd, long long vb, long long vs, long long vh,
    long long vd, long long ob, long long os, long long oh, long long od,
    int b, int sq, int sk, int h, int n_kv, int d, int causal, int window,
    int kv_len, int dtype, float scale, float softcap, void* stream) {
  if (d < 1 || d > 256 || n_kv < 1 || h % n_kv != 0 || kv_len < 0 ||
      kv_len > sk)
    return (int)cudaErrorInvalidValue;
  const Args a{qb, qs, qh, qd, kb, ks, kh, kd, vb, vs, vh, vd,
               ob, os, oh, od, b, sq, sk, h, n_kv, d, causal, window,
               kv_len, scale, softcap};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 1 ? dispatch<__nv_bfloat16>(q, k, v, o, a, st)
      : dtype == 0 ? dispatch<float>(q, k, v, o, a, st)
                   : cudaErrorInvalidValue;
  return (int)err;
}
