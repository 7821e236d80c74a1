// Shared pieces of the two graph-propagation kernels (graph_prop_fwd.cu,
// graph_prop_bwd.cu): sizes, the staged weight layout, the lane geometry,
// warp reductions, cp.async staging and the eq.6 pair forward.
//
// Lane geometry.  One warp per destination row i of a graph.  Its 32 lanes
// are W = max(4, next_pow2(N)) source lanes j times S = 32 / W hidden
// slices s, lane = j * S + s, so that
//   - a sum over the S slices of one pair is an xor shuffle with offsets
//     1 .. S/2 (`sreduce`),
//   - a sum over the W sources of a row is an xor shuffle with offsets
//     S .. 16 (`jsum`, `jmax`),
// and every lane owns K = 32 / S = W consecutive hidden units s*K .. s*K+K-1
// of f3's first layer, of pre_h = h3 @ W41[:16] and of f4's hidden layer.
// A block is N warps.  The host computes the same plan (`ops.launch_plan`)
// and passes it in; the entry points refuse a plan that differs.
//
// Butterfly (xor) reductions leave bitwise the same value in every lane
// (float addition commutes), so the S copies of a pair's h3, logit and
// message agree exactly.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace gp {

constexpr int XD = 30;     // x = a_vec(3) ‖ context(24) ‖ z_vec(3)
constexpr int HID = 32;    // MLP hidden width
constexpr int ED = 16;     // edge hidden width (f3 output)
constexpr int NM = 5;      // metrics per node
constexpr int MAXN = 16;   // largest padded graph
constexpr int HS = HID + 4;   // row stride of hidden-wide rows in shared
constexpr int XS = 32;        // row stride of x rows in shared
constexpr int MS = 8;         // row stride of metric rows in shared
constexpr float SLOPE = 0.1f;
constexpr float MASKED = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

// The nine weights in the callers' order and (in, out) layout; also the
// layout of a gradient slot.  Float offsets.
constexpr int O_W31 = 0;                        // (2*XD, HID)
constexpr int O_B31 = O_W31 + 2 * XD * HID;
constexpr int O_W32 = O_B31 + HID;              // (HID, ED)
constexpr int O_B32 = O_W32 + HID * ED;
constexpr int O_A = O_B32 + ED;                 // (ED,)
constexpr int O_W41 = O_A + ED;                 // (ED + NM, HID)
constexpr int O_B41 = O_W41 + (ED + NM) * HID;
constexpr int O_W42 = O_B41 + HID;              // (HID, NM)
constexpr int O_B42 = O_W42 + HID * NM;
constexpr int W_TOTAL = O_B42 + NM;             // 3365

__host__ __device__ constexpr int r4(int v) { return (v + 3) & ~3; }

// Weights as staged in shared memory for S slices.  W31, W41 and the
// vectors keep their layout; a lane reads its slice of a W41 row as
// float4s, and the S slices sit 16 bytes apart in the banks already.
// W32 (rows k) and W42 (rows k, padded to 8) are read row by row by a lane
// of slice s, k = s*K + t: the S rows read at once would share their banks,
// so slice s's rows start 4*s floats later.  Every offset is a multiple of
// 4 floats.
template <int S>
struct Layout {
  static constexpr int K = HID / S;             // hidden units per lane
  static constexpr int W = 32 / S;              // source lanes per row
  static constexpr int W31 = 0;
  static constexpr int B31 = W31 + 2 * XD * HID;
  static constexpr int W32 = B31 + HID;
  static constexpr int B32 = W32 + HID * ED + 4 * S;
  static constexpr int A = B32 + ED;
  static constexpr int W41 = A + ED;
  static constexpr int B41 = W41 + (ED + NM) * HID;
  static constexpr int W42 = B41 + HID;
  static constexpr int B42 = W42 + HID * 8 + 4 * S;
  static constexpr int TOTAL = B42 + 8;         // 3464 + 8 S
  __device__ static __forceinline__ int w32_row(int k) {
    return W32 + k * ED + (k / K) * 4;
  }
  __device__ static __forceinline__ int w42_row(int k) {
    return W42 + k * 8 + (k / K) * 4;
  }
};

struct Inputs {
  const float* x;             // (B, N, 30)
  const unsigned char* adj;   // (B, N, N), adj[b, i, j]: edge j -> i
  const float* m_obs;         // (B, N, 5)
  const unsigned char* valid; // (B, N)
  const float* w31;
  const float* b31;
  const float* w32;
  const float* b32;
  const float* attn;
  const float* w41;
  const float* b41;
  const float* w42;
  const float* b42;
  int vec;                    // every weight pointer 16-byte aligned
};

// max(z, 0.1 z): the same bits as z >= 0 ? z : 0.1 z (also at -0, inf
// and NaN), in one instruction fewer
__device__ __forceinline__ float leaky(float z) {
  return fmaxf(z, SLOPE * z);
}

// d leaky / dz with the reference's convention: 1 at z == 0
__device__ __forceinline__ float dleaky(float z) {
  return z >= 0.f ? 1.f : SLOPE;
}

// Butterfly sums of N values over the lanes that differ in the bits of
// [lo, hi): every shuffle of a stage is issued before its adds, so the N
// chains overlap instead of running one after another.
template <int LO, int HI, int N>
__device__ __forceinline__ void xor_sum(float (&v)[N]) {
#pragma unroll
  for (int off = LO; off < HI; off <<= 1) {
    float t[N];
#pragma unroll
    for (int c = 0; c < N; ++c) t[c] = __shfl_xor_sync(FULL, v[c], off);
#pragma unroll
    for (int c = 0; c < N; ++c) v[c] += t[c];
  }
}

// sums over the S slices of one pair
template <int S, int N>
__device__ __forceinline__ void sreduce(float (&v)[N]) {
  xor_sum<1, S, N>(v);
}

template <int S>
__device__ __forceinline__ float sreduce(float v) {
  float a[1] = {v};
  xor_sum<1, S, 1>(a);
  return a[0];
}

// sums / max over the W sources of one row
template <int S, int N>
__device__ __forceinline__ void jsum(float (&v)[N]) {
  xor_sum<S, 32, N>(v);
}

template <int S>
__device__ __forceinline__ float jsum(float v) {
  float a[1] = {v};
  xor_sum<S, 32, 1>(a);
  return a[0];
}

template <int S>
__device__ __forceinline__ float jmax(float v) {
#pragma unroll
  for (int off = S; off < 32; off <<= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

// Reduce-scatter over the W sources of a row: each lane holds K == W values
// v[0..K); lane j gets the sum over the row's lanes of element j.  W - 1
// shuffles where an all-reduce of every element would take K log2 W.
template <int S>
__device__ __forceinline__ float reduce_scatter(float (&v)[HID / S], int j) {
  constexpr int W = 32 / S;
#pragma unroll
  for (int half = W / 2; half >= 1; half >>= 1) {
    const bool upper = (j & half) != 0;
    float got[W / 2];
#pragma unroll
    for (int q = 0; q < half; ++q)
      got[q] = __shfl_xor_sync(FULL, upper ? v[q] : v[q + half], half * S);
#pragma unroll
    for (int q = 0; q < half; ++q) v[q] = (upper ? v[q + half] : v[q]) + got[q];
  }
  return v[0];
}

// cp.async copies into shared memory (16 bytes need both addresses 16-byte
// aligned); completion is awaited by cp_wait() and made visible to the
// block by the __syncthreads() that follows it.
__device__ __forceinline__ void cp4(float* dst, const float* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
#else
  *dst = *src;
#endif
}

__device__ __forceinline__ void cp16(float* dst, const float* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
#else
  memcpy(dst, src, 16);
#endif
}

__device__ __forceinline__ void cp_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// `count` floats of src to sw + map(e) for element e; map keeps runs of 4
// that start at a multiple of 4 contiguous, so with `vec` the copy goes in
// 16-byte pieces.
template <class Map>
__device__ __forceinline__ void stage(float* sw, const float* src, int count,
                                      bool vec, Map map) {
  if (vec) {
    for (int q = threadIdx.x; q < count / 4; q += blockDim.x)
      cp16(sw + map(4 * q), src + 4 * q);
  } else {
    for (int e = threadIdx.x; e < count; e += blockDim.x)
      cp4(sw + map(e), src + e);
  }
}

// Every weight, graph g's x (rows of XS) and m_obs (rows of MS) into shared
// memory with cp.async, and valid as 0/1 floats; the caller waits.
template <int S>
__device__ __forceinline__ void stage_inputs(float* sw, float* sx,
                                             float* smobs, float* svalid,
                                             const Inputs& in, size_t g,
                                             int n) {
  using L = Layout<S>;
  const bool v = in.vec != 0;
  stage(sw, in.w31, 2 * XD * HID, v, [](int e) { return L::W31 + e; });
  stage(sw, in.b31, HID, v, [](int e) { return L::B31 + e; });
  stage(sw, in.w32, HID * ED, v,
        [](int e) { return L::w32_row(e / ED) + e % ED; });
  stage(sw, in.b32, ED, v, [](int e) { return L::B32 + e; });
  stage(sw, in.attn, ED, v, [](int e) { return L::A + e; });
  stage(sw, in.w41, (ED + NM) * HID, v, [](int e) { return L::W41 + e; });
  stage(sw, in.b41, HID, v, [](int e) { return L::B41 + e; });
  stage(sw, in.w42, HID * NM, false,
        [](int e) { return L::w42_row(e / NM) + e % NM; });
  stage(sw, in.b42, NM, false, [](int e) { return L::B42 + e; });
  stage(sx, in.x + g * n * XD, n * XD, false,
        [](int e) { return (e / XD) * XS + e % XD; });
  stage(smobs, in.m_obs + g * n * NM, n * NM, false,
        [](int e) { return (e / NM) * MS + e % NM; });
  for (int k = threadIdx.x; k < n; k += blockDim.x)
    svalid[k] = in.valid[g * n + k] ? 1.f : 0.f;
}

// f3's first layer split into its per-node halves, thread (node, k):
// su[node] = x_node @ W31[:30] + b31 (destination half, bias folded in),
// sv[node] = x_node @ W31[30:] (source half).
template <int S>
__device__ __forceinline__ void node_halves(const float* sw, const float* sx,
                                            float* su, float* sv, int node,
                                            int k) {
  using L = Layout<S>;
  const float* xr = sx + node * XS;
  float a = sw[L::B31 + k], c = 0.f;
#pragma unroll
  for (int d = 0; d < XD; ++d) {
    a = fmaf(xr[d], sw[L::W31 + d * HID + k], a);
    c = fmaf(xr[d], sw[L::W31 + (XD + d) * HID + k], c);
  }
  su[node * HS + k] = a;
  sv[node * HS + k] = c;
}

// column k of W41[16:] (the metric rows of f4's first layer)
template <int S>
__device__ __forceinline__ void w41m_column(const float* sw, int k,
                                            float (&w)[NM]) {
#pragma unroll
  for (int c = 0; c < NM; ++c) w[c] = sw[Layout<S>::W41 + (ED + c) * HID + k];
}

// m_j @ W41[16:] for one node's metric row, at the hidden unit whose
// W41[16:] column is w
__device__ __forceinline__ float node_mh(const float* mrow,
                                         const float (&w)[NM]) {
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < NM; ++c) acc = fmaf(mrow[c], w[c], acc);
  return acc;
}

// eq.6 for pair (i, j), this lane's slice s: h3 (all 16, summed over the
// slices), the attention logit and this lane's K units of the
// level-invariant pre_h = h3 @ W41[:16] + b41.  su_i / sv_j are the rows
// of node_halves.
template <int S>
__device__ __forceinline__ void pair_forward(const float* sw,
                                             const float* su_i,
                                             const float* sv_j, int s,
                                             float (&h3)[ED],
                                             float (&preh)[HID / S],
                                             float& logit) {
  using L = Layout<S>;
  constexpr int K = L::K;
  float h1[K];
#pragma unroll
  for (int t = 0; t < K; t += 4) {
    const float4 a = *reinterpret_cast<const float4*>(su_i + s * K + t);
    const float4 b = *reinterpret_cast<const float4*>(sv_j + s * K + t);
    h1[t] = leaky(a.x + b.x);
    h1[t + 1] = leaky(a.y + b.y);
    h1[t + 2] = leaky(a.z + b.z);
    h1[t + 3] = leaky(a.w + b.w);
  }
#pragma unroll
  for (int c = 0; c < ED; ++c) h3[c] = 0.f;
#pragma unroll
  for (int t = 0; t < K; ++t) {
    const float4* wr = reinterpret_cast<const float4*>(sw + L::w32_row(s * K + t));
#pragma unroll
    for (int q = 0; q < ED / 4; ++q) {
      const float4 w = wr[q];
      h3[4 * q] = fmaf(h1[t], w.x, h3[4 * q]);
      h3[4 * q + 1] = fmaf(h1[t], w.y, h3[4 * q + 1]);
      h3[4 * q + 2] = fmaf(h1[t], w.z, h3[4 * q + 2]);
      h3[4 * q + 3] = fmaf(h1[t], w.w, h3[4 * q + 3]);
    }
  }
  sreduce<S>(h3);
  logit = 0.f;
#pragma unroll
  for (int c = 0; c < ED; ++c) {
    h3[c] += sw[L::B32 + c];
    logit = fmaf(leaky(h3[c]), sw[L::A + c], logit);
  }
#pragma unroll
  for (int t = 0; t < K; t += 4) {
    const float4 b = *reinterpret_cast<const float4*>(sw + L::B41 + s * K + t);
    preh[t] = b.x;
    preh[t + 1] = b.y;
    preh[t + 2] = b.z;
    preh[t + 3] = b.w;
  }
#pragma unroll
  for (int c = 0; c < ED; ++c) {
    const float4* wr =
        reinterpret_cast<const float4*>(sw + L::W41 + c * HID + s * K);
#pragma unroll
    for (int q = 0; q < K / 4; ++q) {
      const float4 w = wr[q];
      preh[4 * q] = fmaf(h3[c], w.x, preh[4 * q]);
      preh[4 * q + 1] = fmaf(h3[c], w.y, preh[4 * q + 1]);
      preh[4 * q + 2] = fmaf(h3[c], w.z, preh[4 * q + 2]);
      preh[4 * q + 3] = fmaf(h3[c], w.w, preh[4 * q + 3]);
    }
  }
}

// Masked softmax over the predecessors j of row i (lanes of the warp):
// sm (the softmax), e (0 in a row with no predecessor) and whether the row
// has one.
template <int S>
__device__ __forceinline__ void row_softmax(float logit, bool pair, bool edge,
                                            float& sm, float& e,
                                            float& n_pred) {
  const float lg = !pair ? -INFINITY : (edge ? logit : MASKED);
  const float mx = jmax<S>(lg);
  const float ex = pair ? expf(lg - mx) : 0.f;
  const float den = jsum<S>(ex);
  n_pred = jsum<S>(edge ? 1.f : 0.f);
  sm = pair ? ex / den : 0.f;
  e = n_pred > 0.f ? sm : 0.f;
}

// This lane's rows of W42 (its slice s, padded rows of 8): held in
// registers across the levels where they fit (K <= 8), else read from
// shared memory at each level (at N > 8 the decision sweeps keep two
// blocks of 64-register threads on an SM; holding the 16 rows there, or
// forming the per-node S_i first, spills).
template <int S, bool REGS = (HID / S <= 8)>
struct W42Slice {
  float w[HID / S][NM];
  __device__ __forceinline__ W42Slice(const float* sw, int s) {
#pragma unroll
    for (int t = 0; t < HID / S; ++t) {
      const float* r = sw + Layout<S>::w42_row(s * (HID / S) + t);
#pragma unroll
      for (int c = 0; c < NM; ++c) w[t][c] = r[c];
    }
  }
  __device__ __forceinline__ void row(int t, float (&out)[NM]) const {
#pragma unroll
    for (int c = 0; c < NM; ++c) out[c] = w[t][c];
  }
};

template <int S>
struct W42Slice<S, false> {
  const float* base;
  __device__ __forceinline__ W42Slice(const float* sw, int s)
      : base(sw + Layout<S>::w42_row(s * (HID / S))) {}
  __device__ __forceinline__ void row(int t, float (&out)[NM]) const {
    const float* r = base + t * 8;    // a slice's rows are 8 floats apart
    const float4 a = *reinterpret_cast<const float4*>(r);
    out[0] = a.x;
    out[1] = a.y;
    out[2] = a.z;
    out[3] = a.w;
    out[4] = r[4];
  }
};

// Sum of v[0..8) over all 32 lanes, scattered: halving on lane bits 4, 3,
// 2 (7 shuffles), then summing over bits 1, 0 (2 more) leaves each lane the
// total of element c = 4 b4 + 2 b3 + b2 of its lane bits; 9 shuffles where
// summing 5 elements over the warp each would take 25.
__device__ __forceinline__ float warp_scatter_sum(float (&v)[8], int lane,
                                                  int& c) {
#pragma unroll
  for (int half = 4; half >= 1; half >>= 1) {
    const bool upper = (lane & (4 * half)) != 0;
    float got[4];
#pragma unroll
    for (int q = 0; q < half; ++q)
      got[q] = __shfl_xor_sync(FULL, upper ? v[q] : v[q + half], 4 * half);
#pragma unroll
    for (int q = 0; q < half; ++q) v[q] = (upper ? v[q + half] : v[q]) + got[q];
  }
  float r = v[0];
  r += __shfl_xor_sync(FULL, r, 2);
  r += __shfl_xor_sync(FULL, r, 1);
  c = ((lane >> 4) & 1) * 4 + ((lane >> 3) & 1) * 2 + ((lane >> 2) & 1);
  return r;
}

// One level's message into row i: m_i = sum_j e_ij (hh_ij @ W42 + b42),
// hh_ij = leaky(pre_h_ij + m_j @ W41[16:]), with mh_j the row of node j's
// m_j @ W41[16:].  Returns sum_j e_ij (hh_ij @ W42)[c] for the element c
// this lane is left with (lanes with lane % 4 == 0 and c < 5 hold one
// each); the caller adds (sum_j e_ij) b42[c].
template <int S>
__device__ __forceinline__ float level_message(const W42Slice<S>& w42,
                                               const float* mh_j,
                                               const float (&preh)[HID / S],
                                               float e, bool pair, int s,
                                               int lane, int& c) {
  constexpr int K = HID / S;
  float mp[NM];
#pragma unroll
  for (int q = 0; q < NM; ++q) mp[q] = 0.f;
#pragma unroll
  for (int t4 = 0; t4 < K; t4 += 4) {
    const float4 m4 = *reinterpret_cast<const float4*>(mh_j + s * K + t4);
    const float mv[4] = {m4.x, m4.y, m4.z, m4.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float hh = leaky(preh[t4 + u] + mv[u]);
      float w[NM];
      w42.row(t4 + u, w);
#pragma unroll
      for (int q = 0; q < NM; ++q) mp[q] = fmaf(hh, w[q], mp[q]);
    }
  }
  float v[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) v[q] = (q < NM && pair) ? e * mp[q] : 0.f;
  return warp_scatter_sum(v, lane, c);
}

}  // namespace gp
