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
// Design.  One thread block per graph, one warp per destination row i, the
// row's 32 lanes split into W = max(4, next_pow2(N)) source lanes times
// S = 32 / W hidden slices (graph_prop_common.cuh): N = 8 is 8 warps of
// 8 sources x 4 slices, N = 16 is 16 warps of 16 x 2.  A lane owns 32 / S
// of the 32 hidden units, so each lane's serial FMA chain and its live
// registers are S times shorter than with one lane per pair; the partial
// h3 and message sums meet in xor shuffles over the S slices, the softmax
// and the sum over j in xor shuffles over the W sources.  The ~3.4k weights
// (13.9 KB) are staged once per block with 16-byte cp.async copies,
// together with the graph's x and m_obs, and laid out so that a lane reads
// its slice of a weight row as float4s without bank conflicts.  f3's first
// layer is split, pair @ W31 = x_i @ W31[:30] + x_j @ W31[30:], into two
// per-node halves computed once per node; f4's first layer likewise, so
// the level-invariant h3 @ W41[:16] + b41 stays in registers and each level
// recomputes only m_j @ W41[16:] per node.  A row's message sums its five
// components over the warp in one reduce-scatter (9 shuffles), with the
// lane's W42 rows in registers where they fit.  Two __syncthreads() per
// level.
// Every buffer is dynamic shared memory whose size the host passes in
// (`ops.launch_plan`).  Nothing is allocated; the launch goes on the
// caller's stream.
//
// Bound.  At N = 16 a graph moves ~3.9 KB (x, adj as bytes, m_obs, valid
// in; e, m_hat out) and needs ~0.77 MFLOP at levels = 3, float32 on the
// CUDA cores: the 67 TFLOP/s fp32 rate bounds it, not the 3.35 TB/s of HBM
// (chip_smoke.graph_prop_work).
//
// Numerics: nvcc contracts a*b+c into FMA and the shuffle trees sum in
// another order than the plain PyTorch version, so the two agree to float32
// rounding (a few ulp), not bit for bit; two launches agree bit for bit.
#include "graph_prop_common.cuh"

namespace {

using namespace gp;

// threads of the largest graph an S-slice block takes, and blocks per SM
// to keep resident: at N = 16 two blocks of 512 threads (64 registers a
// thread; the decision sweeps' 378 graphs then take 1.4 waves), otherwise
// 128 registers a thread, room for the W42 slice held in registers
template <int S>
struct Fwd {
  static constexpr int MAX_THREADS = 32 * (S == 2 ? 16 : S == 4 ? 8 : 4);
  static constexpr int MIN_BLOCKS = S == 2 ? 2 : 65536 / 128 / MAX_THREADS;
};

template <int S>
__global__ void __launch_bounds__(Fwd<S>::MAX_THREADS, Fwd<S>::MIN_BLOCKS)
    graph_prop_fwd_kernel(const Inputs in, float* __restrict__ e_out,
                          float* __restrict__ mh_out, int n, int levels) {
  using L = Layout<S>;
  extern __shared__ __align__(16) float smem[];
  float* sw = smem;
  float* sx = sw + L::TOTAL;
  float* su = sx + n * XS;
  float* sv = su + n * HS;
  float* smh = sv + n * HS;
  float* smobs = smh + n * HS;
  float* smcur = smobs + n * MS;
  float* svalid = smcur + n * MS;

  const size_t g = blockIdx.x;
  const int tid = threadIdx.x;
  const int i = tid >> 5, lane = tid & 31;
  const int j = lane / S, s = lane % S;
  const bool pair = j < n;
  const int jj = pair ? j : 0;          // in range for the idle lanes
  const size_t row = (g * n + i) * n;
  const bool edge = pair && in.adj[row + j];

  stage_inputs<S>(sw, sx, smobs, svalid, in, g, n);
  cp_wait();
  __syncthreads();
  node_halves<S>(sw, sx, su, sv, i, lane);
  __syncthreads();

  float h3[ED], preh[L::K], logit;
  pair_forward<S>(sw, su + i * HS, sv + jj * HS, s, h3, preh, logit);
  float sm, e, n_pred;
  row_softmax<S>(logit, pair, edge, sm, e, n_pred);
  if (pair && s == 0) e_out[row + j] = e;

  // eq.7, level-synchronous metric propagation; m^0 = m_obs
  const float esum = jsum<S>(e);
  const W42Slice<S> w42(sw, s);
  float w41m[NM];
  w41m_column<S>(sw, lane, w41m);
  for (int lv = 0; lv < levels; ++lv) {
    {
      const bool obs = lv == 0 || svalid[i] != 0.f;
      smh[i * HS + lane] = node_mh((obs ? smobs : smcur) + i * MS, w41m);
    }
    __syncthreads();
    int c;
    const float mi = level_message<S>(w42, smh + jj * HS, preh, e, pair, s,
                                      lane, c);
    if ((lane & 3) == 0 && c < NM)
      smcur[i * MS + c] = svalid[i] != 0.f
                              ? smobs[i * MS + c]
                              : fmaf(esum, sw[L::B42 + c], mi);
    __syncthreads();
  }

  for (int k = tid; k < n * NM; k += blockDim.x) {
    const int node = k / NM, c = k % NM;
    mh_out[g * n * NM + k] =
        (levels == 0 ? smobs : smcur)[node * MS + c];
  }
}

// dynamic shared memory of one block, bytes (ops.launch_plan mirrors it)
template <int S>
size_t fwd_smem(int n) {
  return sizeof(float) *
         (size_t)(Layout<S>::TOTAL + n * XS + 3 * n * HS + 2 * n * MS + r4(n));
}

template <int S>
cudaError_t launch(const Inputs& in, float* e_out, float* mh_out, int batch,
                   int n, int levels, int threads, int smem,
                   cudaStream_t st) {
  if (threads != 32 * n || (size_t)smem != fwd_smem<S>(n))
    return cudaErrorInvalidValue;
  static int smem_set = 48 * 1024;
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        graph_prop_fwd_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  graph_prop_fwd_kernel<S><<<batch, threads, smem, st>>>(in, e_out, mh_out, n, levels);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Pointers are device pointers of
// contiguous tensors: x (B,N,30) f32, adj (B,N,N) u8 0/1, m_obs (B,N,5) f32,
// valid (B,N) u8, the nine f3/attn/f4 weights and biases in (in, out)
// layout, and the outputs e (B,N,N) f32 and m_hat (B,N,5) f32.  `threads`,
// `slices`, `width` and `smem` are the host's launch plan; a plan other
// than this file's is refused.  Returns the cudaError_t of the launch.
extern "C" int graph_prop_fwd(const void* x, const void* adj, const void* m_obs,
                              const void* valid, const void* w31,
                              const void* b31, const void* w32,
                              const void* b32, const void* attn,
                              const void* w41, const void* b41,
                              const void* w42, const void* b42, void* e_out,
                              void* mh_out, int batch, int n, int levels,
                              int threads, int slices, int width, int smem,
                              void* stream) {
  if (batch < 1 || n < 1 || n > MAXN || levels < 0)
    return (int)cudaErrorInvalidValue;
  int w = 4;
  while (w < n) w <<= 1;
  if (width != w || slices * width != 32) return (int)cudaErrorInvalidValue;
  const void* ws[] = {w31, b31, w32, b32, attn, w41, b41, w42, b42};
  int vec = 1;
  for (const void* p : ws) vec &= ((uintptr_t)p & 15) == 0;
  const Inputs in{(const float*)x, (const unsigned char*)adj,
                  (const float*)m_obs, (const unsigned char*)valid,
                  (const float*)w31, (const float*)b31, (const float*)w32,
                  (const float*)b32, (const float*)attn, (const float*)w41,
                  (const float*)b41, (const float*)w42, (const float*)b42,
                  vec};
  cudaStream_t st = (cudaStream_t)stream;
  float* e = (float*)e_out;
  float* mh = (float*)mh_out;
  switch (slices) {
    case 2: return (int)launch<2>(in, e, mh, batch, n, levels, threads, smem, st);
    case 4: return (int)launch<4>(in, e, mh, batch, n, levels, threads, smem, st);
    case 8: return (int)launch<8>(in, e, mh, batch, n, levels, threads, smem, st);
  }
  return (int)cudaErrorInvalidValue;
}
