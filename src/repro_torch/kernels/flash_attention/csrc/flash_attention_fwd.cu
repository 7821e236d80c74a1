// Flash attention forward for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel `flash_attention` (src/repro/kernels/flash_attention/
// kernel.py:67, body `_kernel` :25): online-softmax attention with GQA (query
// head h reads kv head h / (H / Kh)), causal and sliding-window masks, the
// tanh logit softcap and the `kv_len` tail mask, for head dims up to 256.
// Masked logits are -1e30 and l is floored at 1e-20, as in the reference, so
// a row that sees no key comes out as the mean of V.
//
// What bounds it on the H100: at qwen3's prefill (B 8, S 812, H 16, Kh 8,
// D 128, bf16, causal) the work is 4 * B * H * D * (visible pairs) = 21.6
// GFLOP against 80 MB of q, k, v and o: 0.022 ms at the tensor cores' 989
// TFLOP/s and 0.024 ms at 3.35 TB/s, so the two are about even.  Only the
// tensor cores come near that: the CUDA cores give ~67 TFLOP/s in float32.
//
// Two routes, chosen by dtype:
//
// bfloat16, the serving route: `fa_fwd_tc`, on the tensor cores (`wgmma`).
//   - One CTA of 384 threads owns one (batch, head, 128-row q-tile).  Warp-
//     group 0 is the producer: it copies Q once, then K and V tiles into a
//     2-stage ring in shared memory with 16-byte `cp.async` (the zero-fill
//     form past S and past D), and signals each stage on an `mbarrier`
//     (`cp.async.mbarrier.arrive.noinc`).  Warpgroups 1 and 2 are consumers
//     of 64 query rows each; `setmaxnreg` moves registers from the producer
//     to them.  `cp.async` rather than TMA: q, k and v arrive as strided
//     (B, S, H, D) views and the library is built without `-lcuda`, so a
//     per-call 4-D tensor map buys little here.
//   - Tiles sit in shared memory in the 128-byte swizzled layout that the
//     `wgmma` descriptors name (64-byte for D <= 32), in panels of 64
//     columns; Q stays there for the whole tile.
//   - S = Q K^T is `wgmma.mma_async ... .f32.bf16.bf16` with A = Q and B =
//     K from shared memory.  bf16 x bf16 products are exact in float32, so
//     only the order of the sums differs from the float32 route.
//   - Scale, softcap (`tanhf`), the masks and the online softmax run on the
//     float32 accumulator fragments; the row max is a shuffle over the 4
//     lanes of a row, l a per-lane partial summed at the end.  The softcap
//     and the masks branch once per tile, not per element, and the masks
//     run only on tiles that cross the diagonal, the window's edge, kv_len
//     or the end of the keys.  exp is 2^(x log2 e) on the SFU, with the
//     logit scale folded into that factor when there is no softcap.  Tiles
//     wholly above the causal diagonal or before the window are skipped.
//   - O += P V keeps P at float32 precision on bf16 tensor cores: each p is
//     split into hi = bf16(p) and lo = bf16(p - hi), and two `wgmma` (A =
//     hi, then lo, from registers; B = V from shared memory, transposed by
//     the instruction) add into one float32 accumulator.  That keeps ~16
//     bits of p where bf16 P keeps 8, for 1.5x the tensor-core work of bf16
//     P.  The reason is jamba's bf16 teacher-forced check, which compares
//     `decode_step` (flash_decode, float32 p) with `forward` (this kernel)
//     and has little margin left: rounding P to bf16 here alone would add a
//     difference that the other side lacks.  l is summed from float32 p.
//   - The output is normalised, rounded to bf16, staged through Q's shared
//     memory and written with 16-byte stores.
//   - Layout contract (the wrapper's `ops.py` copies an input that breaks
//     it): D a multiple of 8, innermost stride 1, other strides multiples
//     of 8 elements, 16-byte aligned bases.  D is padded to 32, 64, 128 or
//     256 with zeros in shared memory.
//
// float32, the checking route: `fa_fwd`, the CUDA-core kernel of the first
//   port, unchanged.  The port keeps float32 at full precision (no TF32),
//   and the tensor cores give nothing to full float32 products; this route
//   serves only the float32 checks.  One block of 256 threads owns one
//   (batch, head, q-tile) and loops over the kv tiles itself; tiles are
//   staged as float32 in shared memory, each thread holds an RQ x RK block
//   of scores and RQ rows of the accumulator, and the softmax's row max and
//   sum are xor-shuffles over the 16 lanes of a row.
//
// Both routes take the q-tiles last-first, so the longest causal rows
// start first, and visit every tile when some row of the block sees no key.
//
// Partial attention (a rank's slice of the keys, merged across ranks by
// log-sum-exp): `koff` is the global position of key 0, so key j sits at
// koff + j in the causal and window masks and in the tile-skip tests
// (`kv_len` stays local).  With `lse` non-null the kernel also writes each
// row's float32 log-sum-exp of its visible logits, (B, H, Sq) contiguous,
// and then a row that sees no key of this slice comes out as o = 0 and
// lse = -inf; such a block skips the tiles it does not need instead of
// visiting every tile.  With koff = 0 and no lse a launch computes what it
// computed before, bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

struct Args {
  long long qb, qs, qh, qd;   // strides, in elements
  long long kb, ks, kh, kd;
  long long vb, vs, vh, vd;
  long long ob, os, oh, od;
  int b, sq, sk, h, n_kv, d, causal, window, kv_len, koff;
  float scale, softcap;
  float* lse;                 // (B, H, Sq) or null
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

  // Row i sees local keys [lo_i, hi_i]; without lse a row with none makes
  // the block visit all.
  bool empty = false;
  if (tid < BQ && q0 + tid < a.sq) {
    const int i = q0 + tid - a.koff;
    const int lo = a.window ? max(0, i - a.window + 1) : 0;
    const int hi = a.causal ? min(i, a.kv_len - 1) : a.kv_len - 1;
    empty = lo > hi;
  }
  int kbeg = 0, kend = a.sk;
  if (a.lse != nullptr || !__syncthreads_or(empty)) {
    const int qlast = min(q0 + BQ, a.sq) - 1;
    kbeg = a.window ? max(0, q0 - a.koff - a.window + 1) : 0;
    kend = a.causal ? min(a.kv_len, qlast + 1 - a.koff) : a.kv_len;
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
        const int kg = kj + a.koff;
        const bool ok = kj < a.kv_len && (!a.causal || kg <= qi) &&
                        (!a.window || qi - kg < a.window);
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
    // with lse, a row that saw no key of the slice (m still the mask
    // value) is o = 0, lse = -inf
    const bool none = a.lse != nullptr && m[i] == kNegInf;
    if (a.lse != nullptr && tx == 0)
      a.lse[((long long)bb * a.h + hq) * a.sq + qi] =
          none ? -__builtin_huge_valf() : m[i] + logf(l[i]);
    T* orow = o + bb * a.ob + (long long)qi * a.os + hq * a.oh;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = tx + 16 * c;
      if (col < d) store(orow + col * a.od, none ? 0.f : acc[i][c] / den);
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

// ------------------------------------------------------------ bf16 route
// `fa_fwd_tc`: see the header.  Everything below is for bfloat16 inputs.

using bf16 = __nv_bfloat16;

constexpr int kTcBQ = 128;       // query rows per CTA: 2 consumers x 64
constexpr int kTcThreads = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int kTcStages = 2;     // K/V ring depth
// setmaxnreg: registers moved from the producer to the consumers (56 +
// 2 x 224 = 3 x 168, the share of each at 384 threads)
constexpr int kTcProducerRegs = 56;
constexpr int kTcConsumerRegs = 224;
constexpr float kMinusInf = -__builtin_huge_valf();   // keys past S

struct TcArgs {
  long long qb, qs, qh;          // strides in elements; the innermost is 1
  long long kb, ks, kh;
  long long vb, vs, vh;
  long long ob, os, oh;
  int b, sq, sk, h, n_kv, d, causal, window, kv_len, koff;
  float scale, softcap;
  float* lse;                    // (B, H, Sq) or null
};

// Shared-memory geometry of one instantiation: DP = D padded to 32, 64,
// 128 or 256, BK = keys per tile.  Tiles are stored as panels of PW <= 64
// columns, each row of a panel one swizzle row of RB bytes.
template <int DP, int BK>
struct TcCfg {
  static constexpr int PW = DP < 64 ? DP : 64;
  static constexpr int RB = PW * 2;
  static constexpr int NP = DP / PW;
  static constexpr int CPR = RB / 16;          // 16-byte chunks per panel row
  static constexpr int CH = DP / 8;            // 16-byte chunks per row
  static constexpr int Q_BYTES = NP * kTcBQ * RB;
  static constexpr int T_BYTES = NP * BK * RB;  // one K or V tile
  static constexpr int BAR_BYTES = 8 * (1 + 3 * kTcStages);
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * kTcStages * T_BYTES +
                              BAR_BYTES;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c of row r in a panel: the 128-byte swizzle
// (Swizzle<3,4,3>) for 128-byte rows, the 64-byte one (Swizzle<2,4,3>) for
// 64-byte rows, as the wgmma descriptors' layout types 1 and 2 expect.
template <int RB>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return RB == 128 ? r * 128 + ((c ^ (r & 7)) << 4)
                   : r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
}

// wgmma shared-memory descriptor: start address, stride between 8-row
// groups (SBO = 8 rows), swizzle layout type; the leading offset is unused
// by these layouts (K-major within one swizzle row; MN-major within one
// panel).
template <int RB>
__device__ __forceinline__ uint64_t make_desc(uint32_t addr) {
  constexpr uint64_t layout = RB == 128 ? 1 : 2;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)((8 * RB) >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

// Waits for the phase of `bar` with this parity.  A wait that outlasts
// ~2^26 polls (seconds) traps, so a broken pipeline fails the launch
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (polls > (1u << 26)) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// Arrive on `bar` once every earlier cp.async of this thread has landed.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(bar) : "memory");
}

// 16 bytes global -> shared; zeros when !valid (src is then not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Pins registers that an in-flight wgmma reads or writes at this point of
// the instruction stream.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

// m64nNk16, A and B from shared memory (both K-major).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// m64nNk16, A from registers, B from shared memory transposed (MN-major).
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (N == 64) wgmma_ss_n64(d, da, db, scale_d);
  else wgmma_ss_n128(d, da, db, scale_d);
}
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  if constexpr (N == 32) wgmma_rs_n32(d, a, db, scale_d);
  else wgmma_rs_n64(d, a, db, scale_d);
}

// 2^x on the SFU.  The softmax takes exp(x) as 2^(x log2 e): relative error
// ~1e-6 where |x| < 20, far below the bf16 rounding of the output; `expf`'s
// range reduction cost ~17 % of the kernel's time at qwen3's prefill shape.
constexpr float kLog2e = 1.4426950408889634f;
__device__ __forceinline__ float exp2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo_col, float hi_col) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copies a (ROWS, DP) tile from global memory (row stride rs elements) into
// its swizzled panels at `dst`; rows >= valid_rows and columns >= d are
// zero.  Thread t of the producer's 128 always copies the same 16-byte
// column chunk, of every (128 / CH)-th row.
template <int DP, int BK, int ROWS>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src,
                                          long long rs, int valid_rows,
                                          int d, int t) {
  using C = TcCfg<DP, BK>;
  constexpr int STEP = 128 / C::CH;
  const int cc = t % C::CH, c = cc % C::CPR;
  const bool col_ok = cc * 8 < d;
  dst += (cc / C::CPR) * ROWS * C::RB;
  const bf16* from = src + cc * 8 + (t / C::CH) * rs;
#pragma unroll 4
  for (int r = t / C::CH; r < ROWS; r += STEP, from += STEP * rs) {
    const bool ok = col_ok && r < valid_rows;
    cp_async16(dst + swz<C::RB>(r, c), ok ? from : src, ok);
  }
}

template <int DP, int BK>
__global__ void __launch_bounds__(kTcThreads, 1)
    fa_fwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, bf16* __restrict__ o, TcArgs a) {
  using C = TcCfg<DP, BK>;
  constexpr int RB = C::RB, PW = C::PW, NP = C::NP;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sbase = (raw + 1023u) & ~1023u;   // swizzle atoms: 1 KB
  unsigned char* gbase = smem_raw + (sbase - raw);
  const uint32_t sq = sbase;
  const uint32_t skv = sq + C::Q_BYTES;      // stage s: K, then V
  const uint32_t bars = skv + 2 * kTcStages * C::T_BYTES;
  const uint32_t bar_q = bars;
  auto full_k = [&](int s) { return bars + 8 * (1 + s); };
  auto full_v = [&](int s) { return bars + 8 * (1 + kTcStages + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + 2 * kTcStages + s); };

  const int tid = threadIdx.x;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTcBQ;
  const int hq = blockIdx.y, bb = blockIdx.z;
  const int hk = hq / (a.h / a.n_kv);

  // Row i sees local keys [lo_i, hi_i]; without lse a row with none makes
  // the block visit all.
  bool none = false;
  if (tid < kTcBQ && q0 + tid < a.sq) {
    const int i = q0 + tid - a.koff;
    const int lo = a.window ? max(0, i - a.window + 1) : 0;
    const int hi = a.causal ? min(i, a.kv_len - 1) : a.kv_len - 1;
    none = lo > hi;
  }
  int kbeg = 0, kend = a.sk;
  if (a.lse != nullptr || !__syncthreads_or(none)) {
    const int qlast = min(q0 + kTcBQ, a.sq) - 1;
    kbeg = a.window ? max(0, q0 - a.koff - a.window + 1) : 0;
    kend = a.causal ? min(a.kv_len, qlast + 1 - a.koff) : a.kv_len;
  }
  const int t0 = kbeg / BK, nt = max(0, (kend + BK - 1) / BK - t0);

  if (tid == 0) {
    mbar_init(bar_q, 128);
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(full_k(s), 128);
      mbar_init(full_v(s), 128);
      mbar_init(empty(s), 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = tid / 128, t = tid % 128;
  if (wg == 0) {
    // ---- producer: Q once, then K and V tiles into the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kTcProducerRegs));
    load_tile<DP, BK, kTcBQ>(
        sq, q + bb * a.qb + (long long)q0 * a.qs + hq * a.qh, a.qs,
        a.sq - q0, a.d, t);
    cp_async_arrive(bar_q);
    const bf16* kg = k + bb * a.kb + hk * a.kh;
    const bf16* vg = v + bb * a.vb + hk * a.vh;
    for (int i = 0; i < nt; ++i) {
      const int s = i % kTcStages;
      if (i >= kTcStages) mbar_wait(empty(s), ((i / kTcStages) - 1) & 1);
      const long long k0 = (long long)(t0 + i) * BK;
      const uint32_t kt = skv + 2 * s * C::T_BYTES;
      load_tile<DP, BK, BK>(kt, kg + k0 * a.ks, a.ks, a.sk - (int)k0, a.d,
                            t);
      cp_async_arrive(full_k(s));
      load_tile<DP, BK, BK>(kt + C::T_BYTES, vg + k0 * a.vs, a.vs,
                            a.sk - (int)k0, a.d, t);
      cp_async_arrive(full_v(s));
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else {
    // ---- consumers: 64 query rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(kTcConsumerRegs));
    const int cw = wg - 1;
    const int warp = t / 32, lane = t % 32, ct = lane % 4;
    const int r0 = cw * 64 + warp * 16 + lane / 4;   // rows r0, r0 + 8
    const int qa = q0 + r0, qb = qa + 8;
    const int qlo = q0 + cw * 64, qhi = qlo + 63;
    const uint32_t qw = sq + cw * 64 * RB;           // this group's Q rows

    float acc[NP][PW / 2];
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int j = 0; j < PW / 2; ++j) acc[p][j] = 0.f;
    float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
    // exp(x) = 2^(x log2 e), with the logit scale folded in when uncapped
    const float lsc = kLog2e * (a.softcap > 0.f ? 1.f : a.scale);

    mbar_wait(bar_q, 0);
    for (int i = 0; i < nt; ++i) {
      const int s = i % kTcStages, ph = (i / kTcStages) & 1;
      const int k0 = (t0 + i) * BK;
      const uint32_t kt = skv + 2 * s * C::T_BYTES, vt = kt + C::T_BYTES;

      // S = Q K^T on the tensor cores
      float sc[BK / 2];
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) sc[j] = 0.f;
      mbar_wait(full_k(s), ph);
      fence_proxy_async();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const int p = kk * 16 / PW, off = (kk * 16 % PW) * 2;
        wgmma_ss<BK>(sc, make_desc<RB>(qw + p * kTcBQ * RB + off),
                     make_desc<RB>(kt + p * BK * RB + off), kk > 0);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(sc);

      // scale, softcap, masks, online softmax on the fragments: element e
      // of n8-block c sits at row (e < 2 ? qa : qb), key k0 + 8c + 2ct +
      // (e & 1)
      // logits: with a softcap, scaled and capped here; without, the scale
      // rides in the exponent's factor (the max and the masks are the same
      // in either unit).  Each pass branches once per tile.
      if (a.softcap > 0.f) {
#pragma unroll
        for (int j = 0; j < BK / 2; ++j)
          sc[j] = tanhf(sc[j] * a.scale / a.softcap) * a.softcap;
      }
      // masks, only on tiles that cross the diagonal, the window's edge,
      // kv_len or the end of the keys
      const int g0 = k0 + a.koff;   // the tile's first key, global
      if (k0 + BK > a.kv_len || (a.causal && g0 + BK - 1 > qlo) ||
          (a.window && qhi - g0 >= a.window)) {
#pragma unroll
        for (int c = 0; c < BK / 8; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = k0 + 8 * c + 2 * ct + (e & 1);
            const int jg = j + a.koff;
            const int qi = e < 2 ? qa : qb;
            const bool ok = j < a.kv_len && (!a.causal || jg <= qi) &&
                            (!a.window || qi - jg < a.window);
            sc[4 * c + e] = j >= a.sk ? kMinusInf
                            : ok      ? sc[4 * c + e]
                                      : kNegInf;
          }
      }
      float mx_a = kMinusInf, mx_b = kMinusInf;
#pragma unroll
      for (int c = 0; c < BK / 8; ++c) {
        mx_a = fmaxf(mx_a, fmaxf(sc[4 * c], sc[4 * c + 1]));
        mx_b = fmaxf(mx_b, fmaxf(sc[4 * c + 2], sc[4 * c + 3]));
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
      }
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      const float al_a = exp2_sfu((m_a - mn_a) * lsc);
      const float al_b = exp2_sfu((m_b - mn_b) * lsc);
      m_a = mn_a;
      m_b = mn_b;
      float rs_a = 0.f, rs_b = 0.f;
      uint32_t hi[BK / 16][4], lo[BK / 16][4];
#pragma unroll
      for (int c = 0; c < BK / 8; ++c)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const float mn = e < 2 ? mn_a : mn_b;
          const float p0 = exp2_sfu((sc[4 * c + e] - mn) * lsc);
          const float p1 = exp2_sfu((sc[4 * c + e + 1] - mn) * lsc);
          if (e < 2) rs_a += p0 + p1;
          else rs_b += p0 + p1;
          // the A fragment of key slice c / 2: registers (c % 2) * 2 + e / 2
          const __nv_bfloat162 h2 = __floats2bfloat162_rn(p0, p1);
          const float2 hf = __bfloat1622float2(h2);
          hi[c / 2][(c % 2) * 2 + e / 2] =
              *reinterpret_cast<const uint32_t*>(&h2);
          lo[c / 2][(c % 2) * 2 + e / 2] = pack_bf16(p0 - hf.x, p1 - hf.y);
        }
      l_a = l_a * al_a + rs_a;
      l_b = l_b * al_b + rs_b;
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int j = 0; j < PW / 2; ++j) acc[p][j] *= (j & 2) ? al_b : al_a;

      // O += P V: hi and lo halves of P from registers, V from shared memory
      mbar_wait(full_v(s), ph);
      fence_proxy_async();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          const uint64_t db = make_desc<RB>(vt + p * BK * RB + kk * 16 * RB);
          wgmma_rs<PW>(acc[p], hi[kk], db, 1);
          wgmma_rs<PW>(acc[p], lo[kk], db, 1);
        }
      wgmma_commit();
      wgmma_wait0();
#pragma unroll
      for (int p = 0; p < NP; ++p) fence_regs(acc[p]);
      fence_regs(hi);
      fence_regs(lo);
      mbar_arrive(empty(s));
    }

    // normalise, round to bf16, stage in this group's Q rows, store 16 B
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
    }
    float inv_a = 1.f / fmaxf(l_a, 1e-20f);
    float inv_b = 1.f / fmaxf(l_b, 1e-20f);
    if (a.lse != nullptr) {
      // a row that saw no key of the slice (m still the mask value): o = 0,
      // lse = -inf; else lse = m (in logit units) + log l
      const float unit = a.softcap > 0.f ? 1.f : a.scale;
      const bool none_a = m_a == kNegInf, none_b = m_b == kNegInf;
      if (none_a) inv_a = 0.f;
      if (none_b) inv_b = 0.f;
      float* lrow = a.lse + ((long long)bb * a.h + hq) * a.sq;
      if (ct == 0 && qa < a.sq)
        lrow[qa] = none_a ? kMinusInf : m_a * unit + logf(l_a);
      if (ct == 0 && qb < a.sq)
        lrow[qb] = none_b ? kMinusInf : m_b * unit + logf(l_b);
    }
    const uint32_t bar_id = 1 + cw;
    asm volatile("bar.sync %0, 128;\n" :: "r"(bar_id) : "memory");
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int c = 0; c < PW / 8; ++c) {
        unsigned char* panel = gbase + p * kTcBQ * RB + 4 * ct;
        *reinterpret_cast<uint32_t*>(panel + swz<RB>(r0, c)) =
            pack_bf16(acc[p][4 * c] * inv_a, acc[p][4 * c + 1] * inv_a);
        *reinterpret_cast<uint32_t*>(panel + swz<RB>(r0 + 8, c)) =
            pack_bf16(acc[p][4 * c + 2] * inv_b, acc[p][4 * c + 3] * inv_b);
      }
    asm volatile("bar.sync %0, 128;\n" :: "r"(bar_id) : "memory");
    for (int i = t; i < 64 * C::CH; i += 128) {
      const int r = i / C::CH, cc = i % C::CH;
      const int qi = qlo + r;
      if (qi < a.sq && cc * 8 < a.d) {
        const uint4 val = *reinterpret_cast<const uint4*>(
            gbase + (cc / C::CPR) * kTcBQ * RB +
            swz<RB>(cw * 64 + r, cc % C::CPR));
        *reinterpret_cast<uint4*>(o + bb * a.ob + (long long)qi * a.os +
                                  hq * a.oh + cc * 8) = val;
      }
    }
  }
}

template <int DP, int BK>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o,
                      const TcArgs& a, cudaStream_t stream) {
  constexpr int smem = TcCfg<DP, BK>::SMEM;
  auto kern = fa_fwd_tc<DP, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.sq + kTcBQ - 1) / kTcBQ, a.h, a.b);
  kern<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), a);
  return cudaGetLastError();
}

cudaError_t dispatch_tc(const void* q, const void* k, const void* v, void* o,
                        const TcArgs& a, cudaStream_t stream) {
  if (a.d <= 32) return launch_tc<32, 128>(q, k, v, o, a, stream);
  if (a.d <= 64) return launch_tc<64, 128>(q, k, v, o, a, stream);
  if (a.d <= 128) return launch_tc<128, 128>(q, k, v, o, a, stream);
  return launch_tc<256, 64>(q, k, v, o, a, stream);
}

}  // namespace

// q (B, Sq, H, D), k and v (B, Sk, Kh, D), o (B, Sq, H, D), each with its
// strides in elements; dtype 0 = float32 (CUDA-core kernel), 1 = bfloat16
// (tensor-core kernel, which needs unit innermost strides, the other strides
// and D multiples of 8 and 16-byte aligned bases).  `koff` is the global
// position of key 0 (>= 0); `lse`, when not null, receives (B, H, Sq)
// float32 row log-sum-exps (see the header).  Returns the CUDA error of the
// launch (0 on success).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, long long qb,
    long long qs, long long qh, long long qd, long long kb, long long ks,
    long long kh, long long kd, long long vb, long long vs, long long vh,
    long long vd, long long ob, long long os, long long oh, long long od,
    int b, int sq, int sk, int h, int n_kv, int d, int causal, int window,
    int kv_len, int koff, int dtype, float scale, float softcap, void* lse,
    void* stream) {
  if (d < 1 || d > 256 || n_kv < 1 || h % n_kv != 0 || kv_len < 0 ||
      kv_len > sk || koff < 0)
    return (int)cudaErrorInvalidValue;
  float* lf = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const long long strides = qb | qs | qh | kb | ks | kh | vb | vs | vh |
                              ob | os | oh;
    const unsigned long long ptrs =
        reinterpret_cast<unsigned long long>(q) |
        reinterpret_cast<unsigned long long>(k) |
        reinterpret_cast<unsigned long long>(v) |
        reinterpret_cast<unsigned long long>(o);
    if (qd != 1 || kd != 1 || vd != 1 || od != 1 || (d & 7) ||
        (strides & 7) || (ptrs & 15))
      return (int)cudaErrorInvalidValue;
    const TcArgs a{qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh,
                   b, sq, sk, h, n_kv, d, causal, window, kv_len, koff,
                   scale, softcap, lf};
    return (int)dispatch_tc(q, k, v, o, a, st);
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  const Args a{qb, qs, qh, qd, kb, ks, kh, kd, vb, vs, vh, vd,
               ob, os, oh, od, b, sq, sk, h, n_kv, d, causal, window,
               kv_len, koff, scale, softcap, lf};
  return (int)dispatch<float>(q, k, v, o, a, st);
}
