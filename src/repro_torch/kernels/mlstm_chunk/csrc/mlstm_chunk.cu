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
// them, while the TPU kernel drops them.  m_t does not depend on the
// chunking (it is the recurrence's max(lf + m, i)), so each route walks
// chunks of its own length; a ragged last chunk is masked.
//
// What bounds it on the H100: bytes, at the serving shape.  q, k, v (bf16)
// are read once, h written once and the float32 state written once: 75.8 MB
// at B = 8, S = 1024, H = 4, D = 256, 0.0226 ms at 3.35 TB/s, against 8.6
// GFLOP of least work (4 S D^2 per head), 0.009 ms at the bf16 tensor-core
// rate.  Only the tensor cores come near that: the CUDA cores give ~67
// TFLOP/s in float32.
//
// Two routes, chosen by dtype.
//
// bfloat16, the serving route: `mlstm_kernel_tc`, on the tensor cores
// (`mma.sync.m16n8k16` bf16 with float32 accumulation).
//   - Grid (D / DV, H, B), DV = min(D, 64) value columns per block: 128
//     blocks of 8 warps at the serving shape, one per SM.  A block walks the
//     chunks of its (batch, head) in order and carries its D x DV slice of
//     C in the accumulator registers of the C update (each warp 32 rows of
//     d at D = 256) and n in float32 registers beside it.  Blocks carry
//     nothing to each other: no second pass, no atomics; repeats are
//     bit-equal.  Each value slice recomputes the chunk's 64 x 64 scores
//     (a fifth of its tensor-core work); sharing them over a cluster is left
//     until a phase clock shows that it matters.
//   - Chunks of kL = 64 rows, from the 227 KB of shared memory: q and k in
//     bf16 take 32 KB each per stage and v's slice 8 KB, two stages (144
//     KB); C's slice as the bf16 hi and lo operands of q C takes 64 KB; n
//     and the gates 2.6 KB: 211 KB in all.  At kL = 128 one stage of q and k
//     alone would take 128 KB.  The next chunk's q, k, v are copied with
//     16-byte `cp.async` (zero-filled past S) while the current one
//     computes; each copying thread waits for its own copies
//     (`cp.async.wait_all`) before the barrier that opens the chunk, so no
//     `mbarrier` is needed: every thread both copies and computes.  Tiles
//     sit in shared memory in an XOR-swizzled layout that `ldmatrix` reads
//     without bank conflicts.
//   - The gates of the next chunk go through warp 0 while the other warps
//     finish the current one: log_sigmoid(f), F as a warp scan (shuffles,
//     no serial loop), m at the chunk's end as a warp max of the reference's
//     own (F - F_s) + i_s (a max is exact in any order), g and e_s / sqrt(D).
//   - Per chunk each warp takes 16 rows and half of the block's value
//     columns; the two warps of an SM sub-partition take row tiles r and
//     3 - r, which see 2 (r + 1) and 2 (4 - r) tiles of s, so that every
//     sub-partition does the same work.  Scores Q K^T: exact bf16 products
//     (q, k as given), summed in float32, then scaled by 1 / sqrt(D) (exact
//     at D = 16, 64, 256; at 32 and 128 one rounding in another place).  m_t is the reference's, row by
//     row: the row max of (F_t - F_s) + i_s over the lanes that hold the
//     row.  Masked pairs (s > t, rows past the chunk's end) are skipped by
//     test, not by -inf arithmetic.  The weighted scores stay in the score
//     accumulators and feed W V as A operands; q.n is a float32 dot on the
//     CUDA cores beside the q C products.
//   - Float32 operands keep float32 precision on bf16 tensor cores: each is
//     split into hi = bf16(x) and lo = bf16(x - hi), and two products go
//     into one float32 accumulator (~16 bits of x where bf16 keeps 8).  So
//     W V runs on W's hi and lo, q C on C's hi and lo, and the C update
//     (k e / sqrt(D))^T V on the hi and lo of k e / sqrt(D).  No TF32
//     anywhere, and no bf16 rounding of a float32 operand without its lo
//     half.  n's update is a float32 sum of k e / sqrt(D) on the CUDA cores.
//
// float32, the checking route: `mlstm_kernel`, the CUDA-core kernel of the
//   first port, unchanged.  The port keeps float32 at full precision (no
//   TF32), which the tensor cores do not give; this route serves only the
//   float32 checks.  C's value columns are split over blocks as above; each
//   block walks chunks of 32 rows with q and k of a chunk (float32, 33 KB
//   each at D = 256), the v slice, C, n and the 32 x 32 weighted-score tile
//   in shared memory (148 KB), each thread keeping a small register tile (2
//   x 2 scores, 2 x 4 outputs, up to 16 x 4 of C) and reading shared
//   memory as float4.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kL = 32;          // rows per chunk
constexpr int kPS = 48;         // row stride of the score tile (bank spread)
constexpr float kMInit = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
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

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    mlstm_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ ig,
                 const float* __restrict__ fg, float* __restrict__ h,
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
          float* out = h + (((size_t)bb * S + c0 + t) * H + hh) * D + c_base + c;
#pragma unroll
          for (int j = 0; j < 4; ++j) out[j] = (pv[r][j] + w * qc[r][j]) / den;
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

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core route
namespace tc {

constexpr int kL = 64;          // rows per chunk
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

template <int V>
struct Int {
  static constexpr int value = V;
};

template <int D>
struct Plan {
  static constexpr int DV = D < 64 ? D : 64;    // value columns per block
  static constexpr int CQ = D / 8;              // 16-byte pieces of a q, k row
  static constexpr int CV = DV / 8;             // ... of a v row and a C row
  static constexpr int NH = DV / 16;            // n8 tiles of a warp's outputs
  static constexpr int NV = DV / 8;             // n8 tiles of the C update
  static constexpr int MT = D / 16;             // m16 tiles (rows of C)
  static constexpr int MW = (MT + kWarps - 1) / kWarps;   // per warp
  // shared memory, in bytes: q, k, v two stages each, C hi, C lo, n, gates
  static constexpr int kQ = kL * D * 2;
  static constexpr int kV = kL * DV * 2;
  static constexpr int kC = D * DV * 2;
  static constexpr int kGate = (3 * kL + 4) * 4;  // F, i, e / sqrt(D); m_prev,
                                                  // m_end, g
  static constexpr int oQ = 0, oK = 2 * kQ, oV = 4 * kQ;
  static constexpr int oChi = oV + 2 * kV, oClo = oChi + kC, oN = oClo + kC;
  static constexpr int oG = oN + D * 4;
  static constexpr int kBytes = oG + 2 * kGate;
};

// Byte offset of 16-byte piece `pc` of row `row` in a tile of CH pieces a
// row, XOR-swizzled so that the 8 rows an `ldmatrix` reads at one piece
// fall in 8 distinct 16-byte bank groups.
template <int CH>
__device__ __forceinline__ int tile_off(int row, int pc) {
  if constexpr (CH >= 8) pc ^= row & 7;
  else if constexpr (CH == 4) pc ^= (row >> 1) & 3;
  else pc ^= (row >> 2) & 1;
  return (row * CH + pc) * 16;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 bytes from global to shared memory, zeros where !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
__device__ __forceinline__ void ldsm_x4(const void* p, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(const void* p, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2_t(const void* p, uint32_t (&r)[2]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p)));
}
// c += a b, m16n8k16, bf16 operands, float32 accumulator
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the two bf16 of a packed pair, widened (exactly)
__device__ __forceinline__ float lo_f(uint32_t p) {
  return __uint_as_float(p << 16);
}
__device__ __forceinline__ float hi_f(uint32_t p) {
  return __uint_as_float(p & 0xffff0000u);
}
__device__ __forceinline__ uint32_t pack(float a, float b) {
  __nv_bfloat162 p = __floats2bfloat162_rn(a, b);   // a in the low half
  return *reinterpret_cast<uint32_t*>(&p);
}
// (a, b) = hi + lo: hi rounds them to bf16, lo rounds what hi leaves
__device__ __forceinline__ void split(float a, float b, uint32_t& hi,
                                      uint32_t& lo) {
  hi = pack(a, b);
  lo = pack(a - lo_f(hi), b - hi_f(hi));
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    mlstm_kernel_tc(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const float* __restrict__ ig,
                    const float* __restrict__ fg, __nv_bfloat16* __restrict__ h,
                    float* __restrict__ c_out, float* __restrict__ n_out,
                    float* __restrict__ m_out, int S, int H,
                    float inv_sqrt_d) {
  using P = Plan<D>;
  constexpr int DV = P::DV, CQ = P::CQ, CV = P::CV, NH = P::NH, NV = P::NV;
  constexpr int MT = P::MT, MW = P::MW;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  unsigned char* const smem = smem_tc;
  unsigned char* const chi = smem + P::oChi;   // C's slice, D x DV: hi
  unsigned char* const clo = smem + P::oClo;   // ... and lo
  float* const nf = reinterpret_cast<float*>(smem + P::oN);   // n, float32

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;      // mma fragment row, column
  const int slice = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int c_base = slice * DV;
  const int n_chunks = (S + kL - 1) / kL;
  const size_t rs = (size_t)H * D;             // elements from row t to t + 1
  const size_t head0 = (size_t)bb * S * rs + (size_t)hh * D;
  const size_t gate0 = (size_t)bb * S * H + hh;

  for (int x = tid; x < (2 * P::kC + D * 4) / 16; x += kThreads)
    reinterpret_cast<uint4*>(chi)[x] = make_uint4(0u, 0u, 0u, 0u);

  // q, k and v's slice of chunk c into stage st, zero-filled past S: thread
  // tid copies 16-byte piece tid % CH of rows tid / CH + i kThreads / CH
  auto load_chunk = [&](int c, int st) {
    const int c0 = c * kL, lv = min(kL, S - c0);
    const size_t src = head0 + (size_t)c0 * rs;
    unsigned char* qd = smem + P::oQ + st * P::kQ;
    unsigned char* kd = smem + P::oK + st * P::kQ;
    unsigned char* vd = smem + P::oV + st * P::kV;
    constexpr int RQ = kThreads / CQ, RV = kThreads / CV;
#pragma unroll
    for (int i = 0; i < (kL + RQ - 1) / RQ; ++i) {
      const int r = tid / CQ + i * RQ, pc = tid % CQ;
      if (r < kL) {
        const size_t off = src + (size_t)(r < lv ? r : 0) * rs + pc * 8;
        cp_async16(qd + tile_off<CQ>(r, pc), q + off, r < lv);
        cp_async16(kd + tile_off<CQ>(r, pc), k + off, r < lv);
      }
    }
#pragma unroll
    for (int i = 0; i < (kL + RV - 1) / RV; ++i) {
      const int r = tid / CV + i * RV, pc = tid % CV;
      if (r < kL) {
        const size_t off =
            src + (size_t)(r < lv ? r : 0) * rs + c_base + pc * 8;
        cp_async16(vd + tile_off<CV>(r, pc), v + off, r < lv);
      }
    }
    cp_async_commit();
  };

  // warp 0: the gates of a chunk, rows lane and lane + 32, in registers
  float gi_r[2] = {0.f, 0.f}, gf_r[2] = {0.f, 0.f};
  float m_run = kMInit;    // warp 0: m at the end of the last gated chunk
  auto load_gates = [&](int c) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int t = c * kL + lane + 32 * j;
      gi_r[j] = t < S ? ig[gate0 + (size_t)t * H] : 0.f;
      gf_r[j] = t < S ? fg[gate0 + (size_t)t * H] : 0.f;
    }
  };
  // warp 0: F, i, e_s / sqrt(D) and m_prev, m_end, g of chunk c -> stage st
  auto gate_phase = [&](int c, int st) {
    const int lv = min(kL, S - c * kL);
    float* G = reinterpret_cast<float*>(smem + P::oG + st * P::kGate);
    float F[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float ls = log_sigmoid(gf_r[j]);   // rows past S hold f = 0
      float x = lane + 32 * j < lv ? ls : 0.f;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float y = __shfl_up_sync(kFull, x, off);
        if (lane >= off) x += y;
      }
      F[j] = x;
    }
    F[1] += __shfl_sync(kFull, F[0], 31);
    const float f_tot =
        __shfl_sync(kFull, lv - 1 < 32 ? F[0] : F[1], (lv - 1) & 31);
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 2; ++j)
      if (lane + 32 * j < lv) mx = fmaxf(mx, (f_tot - F[j]) + gi_r[j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
    const float m_end = fmaxf(mx, f_tot + m_run);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int s = lane + 32 * j;
      G[s] = F[j];
      G[kL + s] = s < lv ? gi_r[j] : 0.f;
      const float e = expf(((f_tot - F[j]) + gi_r[j]) - m_end);
      G[2 * kL + s] = s < lv ? e * inv_sqrt_d : 0.f;
    }
    if (lane == 0) {
      G[3 * kL] = m_run;
      G[3 * kL + 1] = m_end;
      G[3 * kL + 2] = expf((f_tot + m_run) - m_end);
    }
    m_run = m_end;
  };

  float acc_c[MW][NV][4];   // C's slice: rows 16 mt + (g, g + 8), mt = warp + 8 i
  float n_r[MW][2];         // n at those rows
#pragma unroll
  for (int i = 0; i < MW; ++i) {
    n_r[i][0] = n_r[i][1] = 0.f;
#pragma unroll
    for (int nt = 0; nt < NV; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_c[i][nt][e] = 0.f;
  }
  if (warp == 0) {
    load_gates(0);
    gate_phase(0, 0);
  }
  load_chunk(0, 0);

  for (int c = 0; c < n_chunks; ++c) {
    const int st = c & 1, c0 = c * kL, lv = min(kL, S - c0);
    cp_async_wait_all();
    __syncthreads();   // chunk c is in; every thread is past chunk c - 1
    if (c + 1 < n_chunks) {
      load_chunk(c + 1, st ^ 1);
      if (warp == 0) load_gates(c + 1);
    }
    const unsigned char* Qs = smem + P::oQ + st * P::kQ;
    const unsigned char* Ks = smem + P::oK + st * P::kQ;
    const unsigned char* Vs = smem + P::oV + st * P::kV;
    const float* G = reinterpret_cast<const float*>(smem + P::oG +
                                                    st * P::kGate);

    // ---- outputs: rows 16 r + (g, g + 8), value columns of half hc.  Row
    // tile r sees 2 (r + 1) tiles of s; warps w and w + 4 share an SM
    // sub-partition, so they take r and 3 - r: each pair does equal work
    const int hc = warp >> 2, r = hc ? 3 - (warp & 3) : warp & 3;
    // one row tile's outputs, R a compile-time constant, so that the loops
    // over the 2 (R + 1) tiles of s it sees unroll without branches
    auto outputs = [&](auto row_tile) {
      constexpr int R = decltype(row_tile)::value;
      constexpr int nsp = R + 1;      // 16-column groups of s that R sees
      const int t0 = 16 * R + g, t1 = t0 + 8;
      float sacc[kL / 8][4], oacc[NH][4];
      float qn0 = 0.f, qn1 = 0.f;
#pragma unroll
      for (int j = 0; j < kL / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[j][e] = 0.f;
#pragma unroll
      for (int j = 0; j < NH; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) oacc[j][e] = 0.f;
#pragma unroll 2
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4];
        ldsm_x4(Qs + tile_off<CQ>(16 * r + (lane & 15), 2 * kk + (lane >> 4)),
                a);
        // q . n, float32 on the CUDA cores
        const float2 n01 = *reinterpret_cast<const float2*>(nf + 16 * kk +
                                                            2 * t4);
        const float2 n89 = *reinterpret_cast<const float2*>(nf + 16 * kk +
                                                            2 * t4 + 8);
        qn0 = fmaf(lo_f(a[0]), n01.x, qn0);
        qn0 = fmaf(hi_f(a[0]), n01.y, qn0);
        qn0 = fmaf(lo_f(a[2]), n89.x, qn0);
        qn0 = fmaf(hi_f(a[2]), n89.y, qn0);
        qn1 = fmaf(lo_f(a[1]), n01.x, qn1);
        qn1 = fmaf(hi_f(a[1]), n01.y, qn1);
        qn1 = fmaf(lo_f(a[3]), n89.x, qn1);
        qn1 = fmaf(hi_f(a[3]), n89.y, qn1);
        // scores q k^T over the s this row tile sees
#pragma unroll
        for (int jp = 0; jp < nsp; ++jp) {
          uint32_t b[4];
          ldsm_x4(Ks + tile_off<CQ>(16 * jp + (lane & 7) + 8 * (lane >> 4),
                                    2 * kk + ((lane >> 3) & 1)),
                  b);
          mma_bf16(sacc[2 * jp], a, b[0], b[1]);
          mma_bf16(sacc[2 * jp + 1], a, b[2], b[3]);
        }
        // q C, C as hi + lo
        const int crow = 16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1);
        if constexpr (NH == 1) {
          uint32_t bh[2], bl[2];
          ldsm_x2_t(chi + tile_off<CV>(crow, hc), bh);
          ldsm_x2_t(clo + tile_off<CV>(crow, hc), bl);
          mma_bf16(oacc[0], a, bh[0], bh[1]);
          mma_bf16(oacc[0], a, bl[0], bl[1]);
        } else {
#pragma unroll
          for (int np = 0; np < NH; np += 2) {
            uint32_t bh[4], bl[4];
            const int pc = hc * NH + np + (lane >> 4);
            ldsm_x4_t(chi + tile_off<CV>(crow, pc), bh);
            ldsm_x4_t(clo + tile_off<CV>(crow, pc), bl);
            mma_bf16(oacc[np], a, bh[0], bh[1]);
            mma_bf16(oacc[np + 1], a, bh[2], bh[3]);
            mma_bf16(oacc[np], a, bl[0], bl[1]);
            mma_bf16(oacc[np + 1], a, bl[2], bl[3]);
          }
        }
      }
      qn0 += __shfl_xor_sync(kFull, qn0, 1);
      qn0 += __shfl_xor_sync(kFull, qn0, 2);
      qn1 += __shfl_xor_sync(kFull, qn1, 1);
      qn1 += __shfl_xor_sync(kFull, qn1, 2);

      // m_t, the reference's, row by row; then the weighted scores
      const float* F = G;
      const float* I = G + kL;
      const float m_prev = G[3 * kL];
      const float Ft0 = F[t0], Ft1 = F[t1];
      const bool ok0 = t0 < lv, ok1 = t1 < lv;
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < 2 * nsp; ++j) {
        const int s = 8 * j + 2 * t4;
        const float2 Fs = *reinterpret_cast<const float2*>(F + s);
        const float2 Is = *reinterpret_cast<const float2*>(I + s);
        if (ok0 && s <= t0) mx0 = fmaxf(mx0, (Ft0 - Fs.x) + Is.x);
        if (ok0 && s + 1 <= t0) mx0 = fmaxf(mx0, (Ft0 - Fs.y) + Is.y);
        if (ok1 && s <= t1) mx1 = fmaxf(mx1, (Ft1 - Fs.x) + Is.x);
        if (ok1 && s + 1 <= t1) mx1 = fmaxf(mx1, (Ft1 - Fs.y) + Is.y);
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, off));
      }
      const float mi0 = Ft0 + m_prev, mi1 = Ft1 + m_prev;   // m_inter
      const float m0 = fmaxf(mx0, mi0), m1 = fmaxf(mx1, mi1);
      float den0 = 0.f, den1 = 0.f;
#pragma unroll
      for (int j = 0; j < 2 * nsp; ++j) {
        const int s = 8 * j + 2 * t4;
        const float2 Fs = *reinterpret_cast<const float2*>(F + s);
        const float2 Is = *reinterpret_cast<const float2*>(I + s);
        // the exponentials of masked pairs are taken too (finite inputs;
        // an overflow to inf is selected away): a select, not a branch
        const float e0 = expf(((Ft0 - Fs.x) + Is.x) - m0);
        const float e1 = expf(((Ft0 - Fs.y) + Is.y) - m0);
        const float e2 = expf(((Ft1 - Fs.x) + Is.x) - m1);
        const float e3 = expf(((Ft1 - Fs.y) + Is.y) - m1);
        float(&w)[4] = sacc[j];
        w[0] = ok0 && s <= t0 ? e0 * (w[0] * inv_sqrt_d) : 0.f;
        w[1] = ok0 && s + 1 <= t0 ? e1 * (w[1] * inv_sqrt_d) : 0.f;
        w[2] = ok1 && s <= t1 ? e2 * (w[2] * inv_sqrt_d) : 0.f;
        w[3] = ok1 && s + 1 <= t1 ? e3 * (w[3] * inv_sqrt_d) : 0.f;
        den0 += w[0] + w[1];
        den1 += w[2] + w[3];
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        den0 += __shfl_xor_sync(kFull, den0, off);
        den1 += __shfl_xor_sync(kFull, den1, off);
      }
      const float w0 = expf(mi0 - m0), w1 = expf(mi1 - m1);
      // 1 / max(|den|, 1): one division a row, not one an output
      const float inv0 = 1.f / fmaxf(fabsf(den0 + w0 * qn0), 1.f);
      const float inv1 = 1.f / fmaxf(fabsf(den1 + w1 * qn1), 1.f);
#pragma unroll
      for (int j = 0; j < NH; ++j) {
        oacc[j][0] *= w0;
        oacc[j][1] *= w0;
        oacc[j][2] *= w1;
        oacc[j][3] *= w1;
      }
      // + W V: the weighted scores as A operands, hi + lo
#pragma unroll
      for (int kk = 0; kk < nsp; ++kk) {
        uint32_t ah[4], al[4];
        split(sacc[2 * kk][0], sacc[2 * kk][1], ah[0], al[0]);
        split(sacc[2 * kk][2], sacc[2 * kk][3], ah[1], al[1]);
        split(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1], ah[2], al[2]);
        split(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3], ah[3], al[3]);
        const int vrow = 16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1);
        if constexpr (NH == 1) {
          uint32_t b[2];
          ldsm_x2_t(Vs + tile_off<CV>(vrow, hc), b);
          mma_bf16(oacc[0], ah, b[0], b[1]);
          mma_bf16(oacc[0], al, b[0], b[1]);
        } else {
#pragma unroll
          for (int np = 0; np < NH; np += 2) {
            uint32_t b[4];
            ldsm_x4_t(Vs + tile_off<CV>(vrow, hc * NH + np + (lane >> 4)),
                      b);
            mma_bf16(oacc[np], ah, b[0], b[1]);
            mma_bf16(oacc[np + 1], ah, b[2], b[3]);
            mma_bf16(oacc[np], al, b[0], b[1]);
            mma_bf16(oacc[np + 1], al, b[2], b[3]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < NH; ++j) {
        const size_t col = (size_t)c_base + (hc * NH + j) * 8 + 2 * t4;
        if (ok0)
          *reinterpret_cast<uint32_t*>(h + head0 + (size_t)(c0 + t0) * rs +
                                       col) =
              pack(oacc[j][0] * inv0, oacc[j][1] * inv0);
        if (ok1)
          *reinterpret_cast<uint32_t*>(h + head0 + (size_t)(c0 + t1) * rs +
                                       col) =
              pack(oacc[j][2] * inv1, oacc[j][3] * inv1);
      }
    };
    if (16 * r < lv) {
      switch (r) {
        case 0: outputs(Int<0>()); break;
        case 1: outputs(Int<1>()); break;
        case 2: outputs(Int<2>()); break;
        default: outputs(Int<3>());
      }
    }

    // ---- C <- g C + (k e / sqrt(D))^T V and n <- g n + sum_s k e / sqrt(D)
    const float g_old = G[3 * kL + 2];
    const float* E = G + 2 * kL;
    float nsum[MW][2];
#pragma unroll
    for (int i = 0; i < MW; ++i) {
      nsum[i][0] = nsum[i][1] = 0.f;
#pragma unroll
      for (int nt = 0; nt < NV; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc_c[i][nt][e] *= g_old;
    }
#pragma unroll
    for (int kk = 0; kk < kL / 16; ++kk) {
      const float2 e01 =
          *reinterpret_cast<const float2*>(E + 16 * kk + 2 * t4);
      const float2 e89 =
          *reinterpret_cast<const float2*>(E + 16 * kk + 2 * t4 + 8);
      uint32_t bv[NV][2];
      const int vrow = 16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
      for (int np = 0; np < NV; np += 2) {
        uint32_t b[4];
        ldsm_x4_t(Vs + tile_off<CV>(vrow, np + (lane >> 4)), b);
        bv[np][0] = b[0];
        bv[np][1] = b[1];
        bv[np + 1][0] = b[2];
        bv[np + 1][1] = b[3];
      }
#pragma unroll
      for (int i = 0; i < MW; ++i) {
        const int mt = warp + kWarps * i;
        if (MT >= kWarps * (i + 1) || mt < MT) {
          uint32_t kr[4];
          ldsm_x4_t(Ks + tile_off<CQ>(16 * kk + (lane & 7) + 8 * (lane >> 4),
                                      2 * mt + ((lane >> 3) & 1)),
                    kr);
          // rows d = g (kr 0, 2) and g + 8 (kr 1, 3); s = 2 t4 + (0, 1)
          // in kr 0, 1 and + 8 in kr 2, 3
          const float x00 = lo_f(kr[0]) * e01.x, x01 = hi_f(kr[0]) * e01.y;
          const float x10 = lo_f(kr[1]) * e01.x, x11 = hi_f(kr[1]) * e01.y;
          const float x20 = lo_f(kr[2]) * e89.x, x21 = hi_f(kr[2]) * e89.y;
          const float x30 = lo_f(kr[3]) * e89.x, x31 = hi_f(kr[3]) * e89.y;
          nsum[i][0] += (x00 + x01) + (x20 + x21);
          nsum[i][1] += (x10 + x11) + (x30 + x31);
          uint32_t ah[4], al[4];
          split(x00, x01, ah[0], al[0]);
          split(x10, x11, ah[1], al[1]);
          split(x20, x21, ah[2], al[2]);
          split(x30, x31, ah[3], al[3]);
#pragma unroll
          for (int nt = 0; nt < NV; ++nt)
            mma_bf16(acc_c[i][nt], ah, bv[nt][0], bv[nt][1]);
#pragma unroll
          for (int nt = 0; nt < NV; ++nt)
            mma_bf16(acc_c[i][nt], al, bv[nt][0], bv[nt][1]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MW; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x = nsum[i][e];
        x += __shfl_xor_sync(kFull, x, 1);
        x += __shfl_xor_sync(kFull, x, 2);
        n_r[i][e] = g_old * n_r[i][e] + x;
      }
    if (warp == 0 && c + 1 < n_chunks) gate_phase(c + 1, st ^ 1);
    __syncthreads();   // every reader of C hi, lo and n is done

#pragma unroll
    for (int i = 0; i < MW; ++i) {
      const int mt = warp + kWarps * i;
      if (mt < MT) {
        const int d0 = 16 * mt + g;
#pragma unroll
        for (int nt = 0; nt < NV; ++nt) {
          uint32_t hi, lo;
          split(acc_c[i][nt][0], acc_c[i][nt][1], hi, lo);
          *reinterpret_cast<uint32_t*>(chi + tile_off<CV>(d0, nt) + 4 * t4) = hi;
          *reinterpret_cast<uint32_t*>(clo + tile_off<CV>(d0, nt) + 4 * t4) = lo;
          split(acc_c[i][nt][2], acc_c[i][nt][3], hi, lo);
          *reinterpret_cast<uint32_t*>(chi + tile_off<CV>(d0 + 8, nt) + 4 * t4) =
              hi;
          *reinterpret_cast<uint32_t*>(clo + tile_off<CV>(d0 + 8, nt) + 4 * t4) =
              lo;
        }
        if (t4 == 0) {
          nf[d0] = n_r[i][0];
          nf[d0 + 8] = n_r[i][1];
        }
      }
    }
  }

  const size_t head = (size_t)bb * H + hh;
#pragma unroll
  for (int i = 0; i < MW; ++i) {
    const int mt = warp + kWarps * i;
    if (mt < MT) {
      const int d0 = 16 * mt + g;
#pragma unroll
      for (int nt = 0; nt < NV; ++nt) {
        const int col = c_base + 8 * nt + 2 * t4;
        *reinterpret_cast<float2*>(c_out + (head * D + d0) * D + col) =
            make_float2(acc_c[i][nt][0], acc_c[i][nt][1]);
        *reinterpret_cast<float2*>(c_out + (head * D + d0 + 8) * D + col) =
            make_float2(acc_c[i][nt][2], acc_c[i][nt][3]);
      }
      if (slice == 0 && t4 == 0) {
        n_out[head * D + d0] = n_r[i][0];
        n_out[head * D + d0 + 8] = n_r[i][1];
      }
    }
  }
  if (slice == 0 && tid == 0) m_out[head] = m_run;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* ig, const float* fg, void* h, float* c,
                   float* n, float* m, int B, int S, int H,
                   cudaStream_t stream) {
  auto kern = mlstm_kernel_tc<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Plan<D>::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(D / Plan<D>::DV, H, B);
  kern<<<grid, kThreads, Plan<D>::kBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), ig, fg,
      static_cast<__nv_bfloat16*>(h), c, n, m, S, H, 1.f / sqrtf((float)D));
  return cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const float* ig, const float* fg, void* h, float* c,
                       float* n, float* m, int B, int S, int H,
                       cudaStream_t stream) {
  constexpr int bytes = Shape<D>::kFloats * (int)sizeof(float);
  auto kern = mlstm_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(D / Shape<D>::DV, H, B);
  kern<<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), ig, fg, static_cast<float*>(h), c, n, m,
      S, H, sqrtf((float)D));
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* ig, const float* fg, void* h, float* c,
                   float* n, float* m, int B, int S, int H, int dtype,
                   cudaStream_t st) {
  return dtype == 1 ? tc::launch<D>(q, k, v, ig, fg, h, c, n, m, B, S, H, st)
         : dtype == 0
             ? launch_f32<D>(q, k, v, ig, fg, h, c, n, m, B, S, H, st)
             : cudaErrorInvalidValue;
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
  cudaError_t err;
  switch (D) {
    case 16: err = launch<16>(q, k, v, i, f, h, c, n, m, B, S, H, dtype, st); break;
    case 32: err = launch<32>(q, k, v, i, f, h, c, n, m, B, S, H, dtype, st); break;
    case 64: err = launch<64>(q, k, v, i, f, h, c, n, m, B, S, H, dtype, st); break;
    case 128: err = launch<128>(q, k, v, i, f, h, c, n, m, B, S, H, dtype, st); break;
    case 256: err = launch<256>(q, k, v, i, f, h, c, n, m, B, S, H, dtype, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}
