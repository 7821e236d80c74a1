// Chunkwise mLSTM (xLSTM matrix memory) for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel `mlstm_chunk` (src/repro/kernels/mlstm_chunk/
// kernel.py:69, body `_kernel` :20), the chunkwise form of the stabilised
// mLSTM recurrence that `repro.models.ssm.mlstm_chunk_scan` (:170) also
// computes.  Per (batch, head), with k scaled by 1/sqrt(D) and
// lf = log_sigmoid(f), over chunks of rows t with F the inclusive cumsum of
// lf inside the chunk:
//   m_t     = max(max_{s<=t} (F_t - F_s) + i_s,  F_t + m_prev)
//   h_t     = num_t / max(|den_t|, 1)
//   num_t   = sum_{s<=t} w_ts (q_t.k_s) v_s + w_t (q_t C)
//   den_t   = sum_{s<=t} w_ts (q_t.k_s)     + w_t (q_t.n)
//   w_ts = exp((F_t - F_s) + i_s - m_t),  w_t = exp(F_t + m_prev - m_t)
// and at the chunk's end (F, m at its last row)
//   C <- g C + sum_s e_s k_s v_s^T,  n <- g n + sum_s e_s k_s,
// with g = exp(F + m_prev - m), e_s = exp(F - F_s + i_s - m).  The final
// C (D x D), n (D) and m are written out as well: the prefill cache needs
// them, while the TPU kernel drops them.
//
// What bounds it on the H100: bytes, at the serving shape.  q, k, v (bf16)
// are read once, h written once and the float32 state written once: ~75 MB
// at B = 8, S = 1024, H = 4, D = 256, 0.023 ms at 3.35 TB/s, against ~9
// GFLOP of least work (4 S D^2 per head for the state plus the causal
// intra-chunk products), 0.01 ms at the bf16 tensor-core rate.
//
// Design.  The TPU kernel keeps C (D x D float32, 256 KB at D = 256) in VMEM
// across a sequential chunk grid axis.  A Hopper block has at most 227 KB of
// shared memory and blocks run in no order, so here:
//   - C's value columns are split over blocks: grid (D / DV, H, B) with DV =
//     64 columns each; a block holds its D x DV slice of C (64 KB) and all of
//     n in shared memory and walks the chunks in order itself.  Blocks carry
//     nothing to each other: no second pass, no atomics.  Each block
//     recomputes the chunk's scores and den (they do not depend on the value
//     column); the slice-0 block writes n and m;
//   - the kernel's chunk is 32 rows (its own choice: m_t is the recurrence's
//     max(lf + m, i), which does not depend on the chunking), so that q and k
//     of a chunk (float32, 33 KB each at D = 256), the v slice, C, n and the
//     32 x 32 weighted-score tile fit one block: 148 KB.  A ragged last chunk
//     is masked;
//   - m_t is the reference's, row by row (the output's max(|den|, 1) floor
//     makes the result depend on the scale of num and den, so no running max
//     of the kernel's own choosing would do).  Masked pairs are skipped by
//     explicit tests, not -inf arithmetic; m starts at -1e30 as in the
//     reference;
//   - everything is float32 on the CUDA cores, each thread keeping a small
//     register tile (2 x 2 scores, 2 x 4 outputs, up to 16 x 4 of C) and
//     reading shared memory as float4.  No TF32, no bf16 rounding of the
//     weighted scores.
// At B = 8, H = 4, D = 256 that is 128 blocks on 132 SMs.  Tensor-core
// products (mma/wgmma) and TMA loads overlapped with compute are the levers
// of a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kL = 32;          // rows per chunk
constexpr int kPS = 48;         // row stride of the score tile (bank spread)
constexpr float kMInit = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ float at(const float4& a, int j) {
  return j == 0 ? a.x : j == 1 ? a.y : j == 2 ? a.z : a.w;
}

// jax.nn.log_sigmoid: -softplus(-x),
// softplus(y) = max(y, 0) + log1p(exp(-|y|))
__device__ __forceinline__ float log_sigmoid(float x) {
  return -(fmaxf(-x, 0.f) + log1pf(expf(-fabsf(x))));
}

template <int D>
struct Shape {
  static constexpr int DV = D < 64 ? D : 64;   // value columns per block
  static constexpr int QS = D + 4;             // row stride of q, k tiles
  static constexpr int CG = DV / 4;            // float4 column groups
  static constexpr int RG = kThreads / CG;     // row groups of the C update
  static constexpr int RD = D >= RG ? D / RG : 1;   // C rows per thread
  static constexpr int kFloats =
      2 * kL * QS + kL * DV + D * DV + D + kL * kPS + 5 * kL;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    mlstm_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ ig,
                 const float* __restrict__ fg, T* __restrict__ h,
                 float* __restrict__ c_out, float* __restrict__ n_out,
                 float* __restrict__ m_out, int S, int H, float sqrt_d) {
  using Sh = Shape<D>;
  constexpr int DV = Sh::DV, QS = Sh::QS, CG = Sh::CG, RD = Sh::RD;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                 // kL x QS
  float* ks = qs + kL * QS;         // kL x QS, scaled by 1 / sqrt(D)
  float* vs = ks + kL * QS;         // kL x DV: this block's value columns
  float* cs = vs + kL * DV;         // D x DV: this block's slice of C
  float* ns = cs + D * DV;          // D
  float* ps = ns + D;               // kL x kPS: w_ts (q_t . k_s)
  float* g_i = ps + kL * kPS;       // log input gate
  float* g_f = g_i + kL;            // lf, then its inclusive cumsum F
  float* g_m = g_f + kL;            // m_t
  float* g_w = g_m + kL;            // w_t = exp(F_t + m_prev - m_t)
  float* g_e = g_w + kL;            // e_s, 0 past the chunk's end

  const int tid = threadIdx.x;
  const int slice = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int c_base = slice * DV;
  for (int x = tid; x < D * DV; x += kThreads) cs[x] = 0.f;
  for (int x = tid; x < D; x += kThreads) ns[x] = 0.f;
  float m_prev = kMInit;

  for (int c0 = 0; c0 < S; c0 += kL) {
    const int lv = min(kL, S - c0);            // valid rows of this chunk
    __syncthreads();   // the previous chunk's readers of q, k, v are done
    for (int x = tid; x < kL * (D / 4); x += kThreads) {
      const int t = x / (D / 4), d = (x % (D / 4)) * 4;
      float4 qv = make_float4(0.f, 0.f, 0.f, 0.f), kv = qv;
      if (t < lv) {
        const size_t off = (((size_t)bb * S + c0 + t) * H + hh) * D + d;
        qv = load4(q + off);
        kv = load4(k + off);
        kv = make_float4(kv.x / sqrt_d, kv.y / sqrt_d, kv.z / sqrt_d,
                         kv.w / sqrt_d);
      }
      *reinterpret_cast<float4*>(qs + t * QS + d) = qv;
      *reinterpret_cast<float4*>(ks + t * QS + d) = kv;
    }
    for (int x = tid; x < kL * CG; x += kThreads) {
      const int t = x / CG, c = (x % CG) * 4;
      float4 vv = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t < lv)
        vv = load4(v + (((size_t)bb * S + c0 + t) * H + hh) * D + c_base + c);
      *reinterpret_cast<float4*>(vs + t * DV + c) = vv;
    }
    if (tid < kL) {
      const size_t g = ((size_t)bb * S + c0 + tid) * H + hh;
      g_i[tid] = tid < lv ? ig[g] : 0.f;
      g_f[tid] = tid < lv ? log_sigmoid(fg[g]) : 0.f;
    }
    __syncthreads();
    if (tid == 0) {                            // F: inclusive cumsum of lf
      float acc = 0.f;
      for (int t = 0; t < lv; ++t) {
        acc += g_f[t];
        g_f[t] = acc;
      }
    }
    __syncthreads();
    if (tid < lv) {                            // the stabiliser m_t
      const float ft = g_f[tid];
      float m_intra = ft - g_f[0] + g_i[0];
      for (int s = 1; s <= tid; ++s)
        m_intra = fmaxf(m_intra, ft - g_f[s] + g_i[s]);
      const float m_inter = ft + m_prev;
      const float mt = fmaxf(m_intra, m_inter);
      g_m[tid] = mt;
      g_w[tid] = expf(m_inter - mt);
    }
    __syncthreads();
    const float f_tot = g_f[lv - 1], m_end = g_m[lv - 1];
    const float g_old = expf(f_tot + m_prev - m_end);
    if (tid < kL)
      g_e[tid] = tid < lv ? expf(f_tot - g_f[tid] + g_i[tid] - m_end) : 0.f;

    {  // weighted scores: rows ti, ti + 16; columns sj, sj + 16
      const int ti = tid / 16, sj = tid % 16;
      float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll 4
      for (int d = 0; d < D; d += 4) {
        float4 a[2], b[2];
        a[0] = load4(qs + ti * QS + d);
        a[1] = load4(qs + (ti + 16) * QS + d);
        b[0] = load4(ks + sj * QS + d);
        b[1] = load4(ks + (sj + 16) * QS + d);
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            acc[r][c] = fmaf(a[r].x, b[c].x, acc[r][c]);
            acc[r][c] = fmaf(a[r].y, b[c].y, acc[r][c]);
            acc[r][c] = fmaf(a[r].z, b[c].z, acc[r][c]);
            acc[r][c] = fmaf(a[r].w, b[c].w, acc[r][c]);
          }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int t = ti + 16 * r, s = sj + 16 * c;
          float p = 0.f;
          if (s <= t && t < lv)
            p = expf(g_f[t] - g_f[s] + g_i[s] - g_m[t]) * acc[r][c];
          ps[t * kPS + s] = p;
        }
    }
    __syncthreads();

    if (tid % 16 < CG) {  // outputs: rows ti, ti + 16; columns 4 c4 .. + 3
      const int ti = tid / 16, c = (tid % 16) * 4;
      float pv[2][4] = {}, qc[2][4] = {}, psum[2] = {0.f, 0.f},
            qn[2] = {0.f, 0.f};
      for (int s = 0; s < kL; ++s) {
        const float4 vv = load4(vs + s * DV + c);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float p = ps[(ti + 16 * r) * kPS + s];
          psum[r] += p;
#pragma unroll
          for (int j = 0; j < 4; ++j) pv[r][j] = fmaf(p, at(vv, j), pv[r][j]);
        }
      }
#pragma unroll 2
      for (int d = 0; d < D; d += 4) {
        float4 a[2];
        a[0] = load4(qs + ti * QS + d);
        a[1] = load4(qs + (ti + 16) * QS + d);
        const float4 nn = load4(ns + d);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 cc = load4(cs + (d + j) * DV + c);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float x = at(a[r], j);
            qc[r][0] = fmaf(x, cc.x, qc[r][0]);
            qc[r][1] = fmaf(x, cc.y, qc[r][1]);
            qc[r][2] = fmaf(x, cc.z, qc[r][2]);
            qc[r][3] = fmaf(x, cc.w, qc[r][3]);
            qn[r] = fmaf(x, at(nn, j), qn[r]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int t = ti + 16 * r;
        if (t < lv) {
          const float w = g_w[t];
          const float den = fmaxf(fabsf(psum[r] + w * qn[r]), 1.f);
          T* out = h + (((size_t)bb * S + c0 + t) * H + hh) * D + c_base + c;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            store(out + j, (pv[r][j] + w * qc[r][j]) / den);
        }
      }
    }
    __syncthreads();   // C and n are read; now they advance to the chunk's end

    {
      const int c = (tid % CG) * 4, d0 = (tid / CG) * RD;
      if (d0 < D) {
        float acc[RD][4] = {};
        for (int s = 0; s < lv; ++s) {
          const float e = g_e[s];
          const float4 vv = load4(vs + s * DV + c);
#pragma unroll
          for (int r = 0; r < RD; ++r) {
            const float kw = ks[s * QS + d0 + r] * e;
            acc[r][0] = fmaf(kw, vv.x, acc[r][0]);
            acc[r][1] = fmaf(kw, vv.y, acc[r][1]);
            acc[r][2] = fmaf(kw, vv.z, acc[r][2]);
            acc[r][3] = fmaf(kw, vv.w, acc[r][3]);
          }
        }
#pragma unroll
        for (int r = 0; r < RD; ++r) {
          float* row = cs + (d0 + r) * DV + c;
          float4 cc = load4(row);
          cc.x = g_old * cc.x + acc[r][0];
          cc.y = g_old * cc.y + acc[r][1];
          cc.z = g_old * cc.z + acc[r][2];
          cc.w = g_old * cc.w + acc[r][3];
          *reinterpret_cast<float4*>(row) = cc;
        }
      }
    }
    for (int d = tid; d < D; d += kThreads) {
      float acc = 0.f;
      for (int s = 0; s < lv; ++s) acc = fmaf(ks[s * QS + d], g_e[s], acc);
      ns[d] = g_old * ns[d] + acc;
    }
    m_prev = m_end;
  }
  __syncthreads();

  const size_t head = (size_t)bb * H + hh;
  for (int x = tid; x < D * CG; x += kThreads) {
    const int d = x / CG, c = (x % CG) * 4;
    *reinterpret_cast<float4*>(c_out + (head * D + d) * D + c_base + c) =
        load4(cs + d * DV + c);
  }
  if (slice == 0) {
    for (int d = tid; d < D; d += kThreads) n_out[head * D + d] = ns[d];
    if (tid == 0) m_out[head] = m_prev;
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* ig, const float* fg, void* h, float* c,
                   float* n, float* m, int B, int S, int H,
                   cudaStream_t stream) {
  constexpr int bytes = Shape<D>::kFloats * (int)sizeof(float);
  auto kern = mlstm_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(D / Shape<D>::DV, H, B);
  kern<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), ig, fg, static_cast<T*>(h), c, n, m, S, H,
      sqrtf((float)D));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const float* ig, const float* fg, void* h, float* c,
                     float* n, float* m, int B, int S, int H, int D,
                     cudaStream_t st) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, ig, fg, h, c, n, m, B, S, H, st);
    case 32: return launch<T, 32>(q, k, v, ig, fg, h, c, n, m, B, S, H, st);
    case 64: return launch<T, 64>(q, k, v, ig, fg, h, c, n, m, B, S, H, st);
    case 128: return launch<T, 128>(q, k, v, ig, fg, h, c, n, m, B, S, H, st);
    case 256: return launch<T, 256>(q, k, v, ig, fg, h, c, n, m, B, S, H, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, h: (B, S, H, D) contiguous, float32 (dtype 0) or bfloat16 (1);
// i, f: (B, S, H) float32; c: (B, H, D, D), n: (B, H, D), m: (B, H) float32.
extern "C" int mlstm_chunk(const void* q, const void* k, const void* v,
                           const float* i, const float* f, void* h, float* c,
                           float* n, float* m, int B, int S, int H, int D,
                           int dtype, void* stream) {
  if (B < 1 || S < 1 || H < 1 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 1 ? dispatch<__nv_bfloat16>(q, k, v, i, f, h, c, n, m, B, S,
                                           H, D, st)
      : dtype == 0 ? dispatch<float>(q, k, v, i, f, h, c, n, m, B, S, H, D,
                                     st)
                   : cudaErrorInvalidValue;
  return (int)err;
}
