// Enel graph propagation, eqs. 6-7 forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `graph_prop_kernel` (body `_kernel`) of
// src/repro/kernels/graph_prop/kernel.py.  For each padded component graph
// (N <= 16 nodes) it computes
//   eq.6  h3_ij = f3([x_i ‖ x_j]) (60 -> 32 -> 16, leaky 0.1),
//         e_ij  = softmax_j(adj_ij ? leaky(h3_ij) . a : -1e30),
//                 rows with no predecessor set to 0;
//   eq.7  `levels` rounds of m_j = valid_j ? m_obs_j : m_cur_j,
//         msg_ij = f4([h3_ij ‖ m_j]), m_i = sum_j e_ij msg_ij, observed rows
//         pinned to m_obs.
//
// Design.  One thread block per graph, one thread per (dst i, src j) pair:
// a row i is W = next_pow2(N) consecutive lanes, so the softmax over j and
// the sum over j are xor-shuffle reductions inside a warp.  The ~3.4k
// weights (13.5 KB) are staged in shared memory once per block.  f3's first
// layer is split, pair @ W31 = x_i @ W31[:30] + x_j @ W31[30:], so the two
// per-node halves are computed once per node into shared memory (N x 32
// each) instead of once per pair; likewise f4's first layer is split so the
// level-invariant h3 @ W41[:16] (32 floats) stays in registers and each
// level only recomputes m_j @ W41[16:] per node into shared memory.  The
// level state m_cur (N x 5) lives in shared memory, two __syncthreads()
// per level.  Nothing is allocated; the launch goes on the caller's stream.
//
// Bound.  At N = 16 a graph moves ~3.9 KB (x, adj as bytes, m_obs, valid
// in; e, m_hat out) and does ~0.97 MFLOP at levels = 3 in this split form
// (~1.83 MFLOP in the dense pair form), all float32 on the CUDA cores: the
// 67 TFLOP/s fp32 rate bounds it, not the 3.35 TB/s of HBM.
//
// Numerics: nvcc contracts a*b+c into FMA and the shuffle trees sum in
// another order than the plain PyTorch version, so the two agree to float32
// rounding (a few ulp), not bit for bit.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int XD = 30;     // x = a_vec(3) ‖ context(24) ‖ z_vec(3)
constexpr int HID = 32;    // MLP hidden width
constexpr int ED = 16;     // edge hidden width (f3 output)
constexpr int NM = 5;      // metrics per node
constexpr int MAXN = 16;   // largest padded graph
constexpr float SLOPE = 0.1f;
constexpr float MASKED = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

// shared-memory weight layout (float offsets), weights in (in, out) layout
constexpr int O_W31 = 0;                        // (2*XD, HID)
constexpr int O_B31 = O_W31 + 2 * XD * HID;
constexpr int O_W32 = O_B31 + HID;              // (HID, ED)
constexpr int O_B32 = O_W32 + HID * ED;
constexpr int O_A = O_B32 + ED;                 // (ED,)
constexpr int O_W41 = O_A + ED;                 // (ED + NM, HID)
constexpr int O_B41 = O_W41 + (ED + NM) * HID;
constexpr int O_W42 = O_B41 + HID;              // (HID, NM)
constexpr int O_B42 = O_W42 + HID * NM;
constexpr int W_TOTAL = O_B42 + NM;

__device__ __forceinline__ float leaky(float z) {
  return z >= 0.f ? z : SLOPE * z;
}

__device__ __forceinline__ float row_sum(float v, int w) {
  for (int off = w >> 1; off > 0; off >>= 1)
    v += __shfl_xor_sync(FULL, v, off, w);
  return v;
}

__device__ __forceinline__ float row_max(float v, int w) {
  for (int off = w >> 1; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL, v, off, w));
  return v;
}

__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src,
                                      int count) {
  for (int k = threadIdx.x; k < count; k += blockDim.x) dst[k] = src[k];
}

__global__ void __launch_bounds__(256) graph_prop_fwd_kernel(
    const float* __restrict__ x, const unsigned char* __restrict__ adj,
    const float* __restrict__ m_obs, const unsigned char* __restrict__ valid,
    const float* __restrict__ w31, const float* __restrict__ b31,
    const float* __restrict__ w32, const float* __restrict__ b32,
    const float* __restrict__ attn, const float* __restrict__ w41,
    const float* __restrict__ b41, const float* __restrict__ w42,
    const float* __restrict__ b42, float* __restrict__ e_out,
    float* __restrict__ mh_out, int n, int row_w, int levels) {
  __shared__ float sw[W_TOTAL];
  __shared__ float sx[MAXN * XD];
  __shared__ float su[MAXN * HID];     // x_i @ W31[:XD]  (dst half)
  __shared__ float sv[MAXN * HID];     // x_j @ W31[XD:]  (src half)
  __shared__ float s_mobs[MAXN * NM];
  __shared__ float s_mcur[MAXN * NM];
  __shared__ float s_mh[MAXN * HID];   // m_j @ W41[ED:] of the current level
  __shared__ unsigned char s_valid[MAXN];

  const size_t g = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  stage(sw + O_W31, w31, 2 * XD * HID);
  stage(sw + O_B31, b31, HID);
  stage(sw + O_W32, w32, HID * ED);
  stage(sw + O_B32, b32, ED);
  stage(sw + O_A, attn, ED);
  stage(sw + O_W41, w41, (ED + NM) * HID);
  stage(sw + O_B41, b41, HID);
  stage(sw + O_W42, w42, HID * NM);
  stage(sw + O_B42, b42, NM);
  stage(sx, x + g * n * XD, n * XD);
  for (int k = tid; k < n * NM; k += nt) {
    const float v = m_obs[g * n * NM + k];
    s_mobs[k] = v;
    s_mcur[k] = v;
  }
  for (int k = tid; k < n; k += nt) s_valid[k] = valid[g * n + k];
  __syncthreads();

  // eq.6, f3 first layer split into its per-node halves
  for (int k = tid; k < 2 * n * HID; k += nt) {
    const int half = k / (n * HID);
    const int r = k - half * n * HID;
    const int node = r / HID, h = r - node * HID;
    const float* wcol = sw + O_W31 + half * XD * HID + h;
    const float* xr = sx + node * XD;
    float acc = 0.f;
#pragma unroll
    for (int d = 0; d < XD; ++d) acc = fmaf(xr[d], wcol[d * HID], acc);
    (half ? sv : su)[node * HID + h] = acc;
  }
  __syncthreads();

  const int i = tid / row_w, j = tid - (tid / row_w) * row_w;
  const bool pair = (i < n) && (j < n);
  const int ii = pair ? i : 0, jj = pair ? j : 0;  // in-range for idle lanes

  float pre_h[HID];   // h3 @ W41[:ED], level-invariant
  float logit = 0.f;
  {
    float h3[ED];
#pragma unroll
    for (int c = 0; c < ED; ++c) h3[c] = 0.f;
#pragma unroll
    for (int k = 0; k < HID; ++k) {
      const float h1 = leaky(su[ii * HID + k] + sv[jj * HID + k] + sw[O_B31 + k]);
#pragma unroll
      for (int c = 0; c < ED; ++c) h3[c] = fmaf(h1, sw[O_W32 + k * ED + c], h3[c]);
    }
#pragma unroll
    for (int c = 0; c < ED; ++c) {
      h3[c] += sw[O_B32 + c];
      logit = fmaf(leaky(h3[c]), sw[O_A + c], logit);
    }
#pragma unroll
    for (int k = 0; k < HID; ++k) pre_h[k] = 0.f;
#pragma unroll
    for (int c = 0; c < ED; ++c) {
#pragma unroll
      for (int k = 0; k < HID; ++k)
        pre_h[k] = fmaf(h3[c], sw[O_W41 + c * HID + k], pre_h[k]);
    }
  }

  // masked softmax over the predecessors j of row i
  const float edge = pair ? (adj[g * n * n + i * n + j] ? 1.f : 0.f) : 0.f;
  const float lg = !pair ? -INFINITY : (edge > 0.f ? logit : MASKED);
  const float mx = row_max(lg, row_w);
  const float ex = pair ? expf(lg - mx) : 0.f;
  const float den = row_sum(ex, row_w);
  const float n_pred = row_sum(edge, row_w);
  const float e_ij = n_pred > 0.f ? ex / den : 0.f;
  if (pair) e_out[g * n * n + i * n + j] = e_ij;

  // eq.7, level-synchronous metric propagation
  for (int lv = 0; lv < levels; ++lv) {
    for (int k = tid; k < n * HID; k += nt) {
      const int node = k / HID, h = k - node * HID;
      const float* mrow = (s_valid[node] ? s_mobs : s_mcur) + node * NM;
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < NM; ++c)
        acc = fmaf(mrow[c], sw[O_W41 + (ED + c) * HID + h], acc);
      s_mh[k] = acc;
    }
    __syncthreads();
    float msg[NM];
#pragma unroll
    for (int c = 0; c < NM; ++c) msg[c] = 0.f;
#pragma unroll
    for (int k = 0; k < HID; ++k) {
      const float hh = leaky(pre_h[k] + s_mh[jj * HID + k] + sw[O_B41 + k]);
#pragma unroll
      for (int c = 0; c < NM; ++c) msg[c] = fmaf(hh, sw[O_W42 + k * NM + c], msg[c]);
    }
#pragma unroll
    for (int c = 0; c < NM; ++c) {
      const float m_i = row_sum(e_ij * (msg[c] + sw[O_B42 + c]), row_w);
      if (pair && j == 0)
        s_mcur[i * NM + c] = s_valid[i] ? s_mobs[i * NM + c] : m_i;
    }
    __syncthreads();
  }

  for (int k = tid; k < n * NM; k += nt) mh_out[g * n * NM + k] = s_mcur[k];
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Pointers are device pointers of
// contiguous tensors: x (B,N,30) f32, adj (B,N,N) u8 0/1, m_obs (B,N,5) f32,
// valid (B,N) u8, the nine f3/attn/f4 weights and biases in (in, out)
// layout, and the outputs e (B,N,N) f32 and m_hat (B,N,5) f32.  Returns the
// cudaError_t of the launch.
extern "C" int graph_prop_fwd(const void* x, const void* adj, const void* m_obs,
                              const void* valid, const void* w31,
                              const void* b31, const void* w32,
                              const void* b32, const void* attn,
                              const void* w41, const void* b41,
                              const void* w42, const void* b42, void* e_out,
                              void* mh_out, int batch, int n, int levels,
                              void* stream) {
  if (batch < 1 || n < 1 || n > MAXN || levels < 0)
    return (int)cudaErrorInvalidValue;
  int row_w = 1;
  while (row_w < n) row_w <<= 1;
  const int threads = ((n * row_w + 31) / 32) * 32;
  graph_prop_fwd_kernel<<<batch, threads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const unsigned char*)adj, (const float*)m_obs,
      (const unsigned char*)valid, (const float*)w31, (const float*)b31,
      (const float*)w32, (const float*)b32, (const float*)attn,
      (const float*)w41, (const float*)b41, (const float*)w42,
      (const float*)b42, (float*)e_out, (float*)mh_out, n, row_w, levels);
  return (int)cudaGetLastError();
}
