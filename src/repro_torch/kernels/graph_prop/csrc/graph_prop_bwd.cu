// Enel graph propagation, eqs. 6-7 backward (VJP), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `graph_prop_bwd_kernel` (body
// `_bwd_kernel`) of src/repro/kernels/graph_prop/kernel.py.  Given the
// primal inputs of `graph_prop_fwd.cu` and the cotangents (g_e, g_mhat) of
// its outputs, it returns the gradients of x, m_obs and the nine f3/attn/f4
// weights.  Only the primal inputs are saved between the passes, so each
// graph first recomputes its forward: the f3 pair MLP, the masked softmax
// and the `levels` rounds of eq.7, stashing every level's input state m^t.
// It then sweeps back through the levels (observed rows send their
// cotangent to m_obs at every level) and through the softmax and the
// f4/f3 MLPs.
//
// Design.  One thread block (256 threads) per graph, one thread per
// (dst i, src j) pair as in the forward kernel: a row i is W =
// next_pow2(N) consecutive lanes, so softmax sums over j are xor shuffles.
// Sums over i at a fixed j (the cotangent of m_j @ W41[16:], the source
// half of f3's first layer) cross warps, and the parameter gradients are
// sums of per-pair outer products (e.g. h3 ⊗ g_pre_h, 16 x 32), so the
// per-pair vectors are staged in shared memory, k-major with a row stride
// of P + 1 (P = N*W pair slots) so that 32 lanes touch 32 banks, and each
// output element is summed by one thread in a fixed order.  f3's first
// layer is split as in the forward kernel, so its weight gradient needs
// only per-node row and column sums of g_z1:
//   gW31[:30] = sum_i x_i ⊗ (sum_j g_z1_ij),
//   gW31[30:] = sum_j x_j ⊗ (sum_i g_z1_ij),
// never the (N*N, 60) pair matrix.  The gradient of f4's second layer is
// likewise taken per node: sum_ij e_ij g_m_i ⊗ hh_ij = sum_i g_m_i ⊗ S_i
// with S_i = sum_j e_ij hh_ij.  The staging buffers (2 x 32 x (P+1)
// floats) and the level stash (levels x N x 5) live in dynamic shared
// memory (66.5 KB at N = 16, levels = 8; with the 30 KB of static shared
// memory above the 48 KB default, hence cudaFuncSetAttribute).
//
// No float atomics: each graph writes its parameter gradients to its own
// slot of a (B, 3365) scratch tensor, and a second kernel sums the slots in
// graph order, so two launches on the same inputs agree bit for bit.
//
// Bound.  At N = 8, levels = 8 the VJP needs at least ~0.80 MFLOP per
// graph: the forward once (~0.28 MFLOP, with f4's second layer taken per
// node through S_i), then per level u_i = W42 g_m_i once per node, so a
// pair's cotangents g_e_ij = hh_ij . u_i + g_m_i . b42 and g_zz_ij =
// e_ij u_i dleaky(zz_ij) cost ~64 FLOPs each, and the cotangent of
// h3 @ W41[:16] is summed over the levels before its one matmul.  This
// kernel does more: it recomputes each level's f4 hidden layer and its
// message per pair in the reverse sweep, ~1.35 MFLOP per graph.  Against
// ~2.7 KB of graph data in and out, float32 on the CUDA cores, so the
// 67 TFLOP/s fp32 rate bounds it, not the 3.35 TB/s of HBM.  The design
// keeps every intermediate in registers and shared memory; what it does
// not do yet is use more than one block per graph, the per-node u_i, or
// the tensor cores, so at the training shape (B = 96, one block per
// graph) most SMs run one block and the kernel sits far above its bound.
//
// Numerics: FMA contraction and the summation order differ from the plain
// PyTorch VJP, so the two agree to float32 rounding, not bit for bit.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int XD = 30;
constexpr int HID = 32;
constexpr int ED = 16;
constexpr int NM = 5;
constexpr int MAXN = 16;
constexpr int BLOCK = 256;
constexpr int MAX_LEVELS = 64;
constexpr float SLOPE = 0.1f;
constexpr float MASKED = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

// weight (and gradient-slot) layout, float offsets, (in, out) weights
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

// level-loop parameter accumulators (shared memory, one owner each)
constexpr int A_W42 = 0;                        // (HID, NM)
constexpr int A_B42 = A_W42 + HID * NM;
constexpr int A_B41 = A_B42 + NM;
constexpr int A_WM = A_B41 + HID;               // (NM, HID): W41[ED:]
constexpr int A_TOTAL = A_WM + NM * HID;

__device__ __forceinline__ float leaky(float z) {
  return z >= 0.f ? z : SLOPE * z;
}

// d leaky / dz with the reference's convention: 1 at z == 0
__device__ __forceinline__ float dleaky(float z) {
  return z >= 0.f ? 1.f : SLOPE;
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
  for (int k = threadIdx.x; k < count; k += BLOCK) dst[k] = src[k];
}

__global__ void __launch_bounds__(BLOCK) graph_prop_bwd_kernel(
    const float* __restrict__ x, const unsigned char* __restrict__ adj,
    const float* __restrict__ m_obs, const unsigned char* __restrict__ valid,
    const float* __restrict__ w31, const float* __restrict__ b31,
    const float* __restrict__ w32, const float* __restrict__ b32,
    const float* __restrict__ attn, const float* __restrict__ w41,
    const float* __restrict__ b41, const float* __restrict__ w42,
    const float* __restrict__ b42, const float* __restrict__ g_e,
    const float* __restrict__ g_mhat, float* __restrict__ gx_out,
    float* __restrict__ gmo_out, float* __restrict__ slots, int n, int row_w,
    int levels) {
  __shared__ float sw[W_TOTAL];
  __shared__ float sx[MAXN * XD];
  __shared__ float su[MAXN * HID];     // x_i @ W31[:XD]  (dst half)
  __shared__ float sv[MAXN * HID];     // x_j @ W31[XD:]  (src half)
  __shared__ float s_mobs[MAXN * NM];
  __shared__ float s_mcur[MAXN * NM];
  __shared__ float s_mh[MAXN * HID];   // m_j @ W41[ED:] of the current level
  __shared__ float s_esum[MAXN];       // sum_j e_ij
  __shared__ float s_gm[MAXN * NM];    // cotangent of the level's output
  __shared__ float s_gprop[MAXN * NM]; // its unobserved part
  __shared__ float s_gmo[MAXN * NM];   // gradient of m_obs
  __shared__ float s_rs[MAXN * HID];   // per-node row sums (S_i, R_i)
  __shared__ float s_cs[MAXN * HID];   // per-node column sums (G_j, C_j)
  __shared__ float s_acc[A_TOTAL];
  __shared__ float s_glog[MAXN * MAXN];
  __shared__ unsigned char s_valid[MAXN];
  extern __shared__ float dyn[];

  const int P = n * row_w;             // pair slots
  const int PS = P + 1;                // staging row stride (bank spread)
  float* s_ms = dyn;                   // (levels, n, NM) level inputs m^t
  float* buf_a = s_ms + levels * n * NM;
  float* buf_b = buf_a + HID * PS;

  const size_t g = blockIdx.x;
  const int tid = threadIdx.x;

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
  for (int k = tid; k < n * NM; k += BLOCK) {
    const float v = m_obs[g * n * NM + k];
    s_mobs[k] = v;
    s_mcur[k] = v;
    s_gm[k] = g_mhat[g * n * NM + k];
    s_gmo[k] = 0.f;
  }
  for (int k = tid; k < n; k += BLOCK) s_valid[k] = valid[g * n + k];
  for (int k = tid; k < A_TOTAL; k += BLOCK) s_acc[k] = 0.f;
  __syncthreads();

  // f3 first layer, split into its per-node halves
  for (int k = tid; k < 2 * n * HID; k += BLOCK) {
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
  const int p = tid;                               // pair slot when `pair`

  // ---- forward recompute: logit and the level-invariant h3 @ W41[:ED]
  float pre_h[HID];
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
  const bool edge = pair && adj[g * n * n + i * n + j];
  const float lg = !pair ? -INFINITY : (edge ? logit : MASKED);
  const float mx = row_max(lg, row_w);
  const float ex = pair ? expf(lg - mx) : 0.f;
  const float den = row_sum(ex, row_w);
  const float n_pred = row_sum(edge ? 1.f : 0.f, row_w);
  const float sm = pair ? ex / den : 0.f;
  const float e_ij = n_pred > 0.f ? sm : 0.f;
  const float esum = row_sum(e_ij, row_w);
  if (pair && j == 0) s_esum[i] = esum;

  // ---- forward level loop again, stashing each level's input state
  for (int lv = 0; lv < levels; ++lv) {
    for (int k = tid; k < n * NM; k += BLOCK) s_ms[lv * n * NM + k] = s_mcur[k];
    for (int k = tid; k < n * HID; k += BLOCK) {
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

  // ---- reverse sweep through the level loop
  float g_preh[HID];
#pragma unroll
  for (int k = 0; k < HID; ++k) g_preh[k] = 0.f;
  float g_eacc = 0.f;
  for (int lv = levels - 1; lv >= 0; --lv) {
    const float* m_t = s_ms + lv * n * NM;
    // per node: m_j @ W41[ED:] and the split of the incoming cotangent
    for (int k = tid; k < n * HID; k += BLOCK) {
      const int node = k / HID, h = k - node * HID;
      const float* mrow = (s_valid[node] ? s_mobs : m_t) + node * NM;
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < NM; ++c)
        acc = fmaf(mrow[c], sw[O_W41 + (ED + c) * HID + h], acc);
      s_mh[k] = acc;
    }
    for (int k = tid; k < n * NM; k += BLOCK) {
      const float gm = s_gm[k];
      if (s_valid[k / NM]) {
        s_gmo[k] += gm;
        s_gprop[k] = 0.f;
      } else {
        s_gprop[k] = gm;
      }
    }
    __syncthreads();
    // per pair: msg, the cotangents of e and of the f4 hidden layer
    {
      float gprop[NM], gmsg[NM], msg[NM];
#pragma unroll
      for (int c = 0; c < NM; ++c) {
        gprop[c] = s_gprop[ii * NM + c];
        gmsg[c] = e_ij * gprop[c];
        msg[c] = 0.f;
      }
#pragma unroll
      for (int k = 0; k < HID; ++k) {
        const float zz = pre_h[k] + s_mh[jj * HID + k] + sw[O_B41 + k];
        const float hh = leaky(zz);
        float gz = 0.f;
#pragma unroll
        for (int c = 0; c < NM; ++c) {
          msg[c] = fmaf(hh, sw[O_W42 + k * NM + c], msg[c]);
          gz = fmaf(gmsg[c], sw[O_W42 + k * NM + c], gz);
        }
        gz *= dleaky(zz);
        g_preh[k] += gz;
        if (pair) {
          buf_a[k * PS + p] = e_ij * hh;
          buf_b[k * PS + p] = gz;
        }
      }
#pragma unroll
      for (int c = 0; c < NM; ++c) g_eacc = fmaf(gprop[c], msg[c] + sw[O_B42 + c], g_eacc);
    }
    __syncthreads();
    // per node: S_i = sum_j e_ij hh_ij (row), G_j = sum_i g_zz_ij (column)
    for (int k = tid; k < 2 * n * HID; k += BLOCK) {
      const int half = k / (n * HID);
      const int r = k - half * n * HID;
      const int node = r / HID, h = r - node * HID;
      float acc = 0.f;
      if (half == 0) {
        const float* row = buf_a + h * PS + node * row_w;
        for (int q = 0; q < n; ++q) acc += row[q];
        s_rs[r] = acc;
      } else {
        const float* col = buf_b + h * PS + node;
        for (int q = 0; q < n; ++q) acc += col[q * row_w];
        s_cs[r] = acc;
      }
    }
    __syncthreads();
    // parameter accumulators and the cotangent carried to the level before
    for (int k = tid; k < A_TOTAL + n * NM; k += BLOCK) {
      if (k < A_B42) {                         // gW42[h][c]
        const int h = k / NM, c = k - (k / NM) * NM;
        float acc = 0.f;
        for (int q = 0; q < n; ++q) acc = fmaf(s_gprop[q * NM + c], s_rs[q * HID + h], acc);
        s_acc[k] += acc;
      } else if (k < A_B41) {                  // gb42[c]
        const int c = k - A_B42;
        float acc = 0.f;
        for (int q = 0; q < n; ++q) acc = fmaf(s_gprop[q * NM + c], s_esum[q], acc);
        s_acc[k] += acc;
      } else if (k < A_WM) {                   // gb41[h]
        const int h = k - A_B41;
        float acc = 0.f;
        for (int q = 0; q < n; ++q) acc += s_cs[q * HID + h];
        s_acc[k] += acc;
      } else if (k < A_TOTAL) {                // gW41[ED + c][h]
        const int r = k - A_WM;
        const int c = r / HID, h = r - (r / HID) * HID;
        float acc = 0.f;
        for (int q = 0; q < n; ++q) {
          const float mj = s_valid[q] ? s_mobs[q * NM + c] : m_t[q * NM + c];
          acc = fmaf(mj, s_cs[q * HID + h], acc);
        }
        s_acc[k] += acc;
      } else {                                 // g of m_j, node j = q
        const int r = k - A_TOTAL;
        const int q = r / NM, c = r - (r / NM) * NM;
        float acc = 0.f;
#pragma unroll
        for (int h = 0; h < HID; ++h)
          acc = fmaf(s_cs[q * HID + h], sw[O_W41 + (ED + c) * HID + h], acc);
        if (s_valid[q]) {
          s_gmo[r] += acc;
          s_gm[r] = 0.f;
        } else {
          s_gm[r] = acc;
        }
      }
    }
    __syncthreads();
  }
  // m^0 == m_obs: the cotangent left over goes to m_obs
  for (int k = tid; k < n * NM; k += BLOCK)
    gmo_out[g * n * NM + k] = s_gmo[k] + s_gm[k];

  // ---- masked softmax and attention readout backward
  const float g_et = pair ? g_e[g * n * n + i * n + j] + g_eacc : 0.f;
  const float g_sm = n_pred > 0.f ? g_et : 0.f;
  const float dot = row_sum(sm * g_sm, row_w);
  const float g_logit = edge ? sm * (g_sm - dot) : 0.f;

  float* slot = slots + g * W_TOTAL;
  float g_h3[ED];
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
      float acc = g_logit * sw[O_A + c] * dleaky(h3[c]);
#pragma unroll
      for (int k = 0; k < HID; ++k) acc = fmaf(g_preh[k], sw[O_W41 + c * HID + k], acc);
      g_h3[c] = acc;
    }
    if (pair) {
#pragma unroll
      for (int c = 0; c < ED; ++c) buf_a[c * PS + p] = h3[c];
#pragma unroll
      for (int k = 0; k < HID; ++k) buf_b[k * PS + p] = g_preh[k];
      s_glog[p] = g_logit;
    }
  }
  __syncthreads();
  // gW41[:ED] = sum_p h3 ⊗ g_pre_h, g_attn = sum_p g_logit * leaky(h3)
  for (int k = tid; k < ED * HID + ED; k += BLOCK) {
    float acc = 0.f;
    if (k < ED * HID) {
      const int c = k / HID, h = k - (k / HID) * HID;
      for (int a = 0; a < n; ++a)
        for (int b = 0; b < n; ++b) {
          const int q = a * row_w + b;
          acc = fmaf(buf_a[c * PS + q], buf_b[h * PS + q], acc);
        }
      slot[O_W41 + k] = acc;
    } else {
      const int c = k - ED * HID;
      for (int a = 0; a < n; ++a)
        for (int b = 0; b < n; ++b) {
          const int q = a * row_w + b;
          acc = fmaf(s_glog[q], leaky(buf_a[c * PS + q]), acc);
        }
      slot[O_A + c] = acc;
    }
  }
  __syncthreads();

  // ---- f3 second layer: gW32 = sum_p h1 ⊗ g_h3, gb32 = sum_p g_h3
  if (pair) {
#pragma unroll
    for (int k = 0; k < HID; ++k)
      buf_a[k * PS + p] = leaky(su[ii * HID + k] + sv[jj * HID + k] + sw[O_B31 + k]);
#pragma unroll
    for (int c = 0; c < ED; ++c) buf_b[c * PS + p] = g_h3[c];
  }
  __syncthreads();
  for (int k = tid; k < HID * ED + ED; k += BLOCK) {
    float acc = 0.f;
    if (k < HID * ED) {
      const int h = k / ED, c = k - (k / ED) * ED;
      for (int a = 0; a < n; ++a)
        for (int b = 0; b < n; ++b) {
          const int q = a * row_w + b;
          acc = fmaf(buf_a[h * PS + q], buf_b[c * PS + q], acc);
        }
      slot[O_W32 + k] = acc;
    } else {
      const int c = k - HID * ED;
      for (int a = 0; a < n; ++a)
        for (int b = 0; b < n; ++b) acc += buf_b[c * PS + a * row_w + b];
      slot[O_B32 + c] = acc;
    }
  }
  __syncthreads();

  // ---- f3 first layer: g_z1 and its per-node row / column sums
  if (pair) {
#pragma unroll
    for (int k = 0; k < HID; ++k) {
      const float z1 = su[ii * HID + k] + sv[jj * HID + k] + sw[O_B31 + k];
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < ED; ++c) acc = fmaf(g_h3[c], sw[O_W32 + k * ED + c], acc);
      buf_a[k * PS + p] = acc * dleaky(z1);
    }
  }
  __syncthreads();
  for (int k = tid; k < 2 * n * HID; k += BLOCK) {
    const int half = k / (n * HID);
    const int r = k - half * n * HID;
    const int node = r / HID, h = r - node * HID;
    float acc = 0.f;
    if (half == 0) {                           // R_i = sum_j g_z1_ij
      const float* row = buf_a + h * PS + node * row_w;
      for (int q = 0; q < n; ++q) acc += row[q];
      s_rs[r] = acc;
    } else {                                   // C_j = sum_i g_z1_ij
      const float* col = buf_a + h * PS + node;
      for (int q = 0; q < n; ++q) acc += col[q * row_w];
      s_cs[r] = acc;
    }
  }
  __syncthreads();
  const int n_w31 = 2 * XD * HID;
  for (int k = tid; k < n_w31 + HID + n * XD + A_TOTAL; k += BLOCK) {
    if (k < n_w31) {                           // gW31[d][h]
      const int d = k / HID, h = k - (k / HID) * HID;
      const int dd = d < XD ? d : d - XD;
      const float* sums = d < XD ? s_rs : s_cs;
      float acc = 0.f;
      for (int q = 0; q < n; ++q) acc = fmaf(sx[q * XD + dd], sums[q * HID + h], acc);
      slot[O_W31 + k] = acc;
    } else if (k < n_w31 + HID) {              // gb31[h]
      const int h = k - n_w31;
      float acc = 0.f;
      for (int q = 0; q < n; ++q) acc += s_rs[q * HID + h];
      slot[O_B31 + h] = acc;
    } else if (k < n_w31 + HID + n * XD) {     // gx[node][d]
      const int r = k - n_w31 - HID;
      const int node = r / XD, d = r - (r / XD) * XD;
      float acc = 0.f;
#pragma unroll
      for (int h = 0; h < HID; ++h) {
        acc = fmaf(s_rs[node * HID + h], sw[O_W31 + d * HID + h], acc);
        acc = fmaf(s_cs[node * HID + h], sw[O_W31 + (XD + d) * HID + h], acc);
      }
      gx_out[g * n * XD + r] = acc;
    } else {                                   // the level-loop accumulators
      const int r = k - n_w31 - HID - n * XD;
      if (r < A_B42) slot[O_W42 + r] = s_acc[r];
      else if (r < A_B41) slot[O_B42 + r - A_B42] = s_acc[r];
      else if (r < A_WM) slot[O_B41 + r - A_B41] = s_acc[r];
      else slot[O_W41 + ED * HID + r - A_WM] = s_acc[r];
    }
  }
}

// sum of the per-graph gradient slots, in graph order (deterministic)
__global__ void sum_slots_kernel(const float* __restrict__ slots,
                                 float* __restrict__ out, int batch) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= W_TOTAL) return;
  float acc = 0.f;
  for (int b = 0; b < batch; ++b) acc += slots[(size_t)b * W_TOTAL + k];
  out[k] = acc;
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Pointers are device pointers of
// contiguous tensors: the forward's inputs (x (B,N,30) f32, adj (B,N,N) u8,
// m_obs (B,N,5) f32, valid (B,N) u8, the nine weights in (in, out) layout),
// the cotangents g_e (B,N,N) and g_mhat (B,N,5) f32, and the outputs gx
// (B,N,30), gm_obs (B,N,5), a scratch of per-graph slots (B, 3365) and the
// summed parameter gradients (3365,) f32 in the weights' order and layout.
// Launches the per-graph kernel, then the slot sum, on `stream`.  Returns
// the first cudaError_t.
extern "C" int graph_prop_bwd(const void* x, const void* adj, const void* m_obs,
                              const void* valid, const void* w31,
                              const void* b31, const void* w32,
                              const void* b32, const void* attn,
                              const void* w41, const void* b41,
                              const void* w42, const void* b42,
                              const void* g_e, const void* g_mhat, void* gx,
                              void* gmo, void* slots, void* gparams,
                              int batch, int n, int levels, void* stream) {
  if (batch < 1 || n < 1 || n > MAXN || levels < 0 || levels > MAX_LEVELS)
    return (int)cudaErrorInvalidValue;
  int row_w = 1;
  while (row_w < n) row_w <<= 1;
  const size_t dyn = sizeof(float) *
      ((size_t)levels * n * NM + 2 * (size_t)HID * (n * row_w + 1));
  static size_t dyn_set = 0;
  if (dyn > dyn_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        graph_prop_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)dyn);
    if (err != cudaSuccess) return (int)err;
    dyn_set = dyn;
  }
  cudaStream_t st = (cudaStream_t)stream;
  graph_prop_bwd_kernel<<<batch, BLOCK, dyn, st>>>(
      (const float*)x, (const unsigned char*)adj, (const float*)m_obs,
      (const unsigned char*)valid, (const float*)w31, (const float*)b31,
      (const float*)w32, (const float*)b32, (const float*)attn,
      (const float*)w41, (const float*)b41, (const float*)w42,
      (const float*)b42, (const float*)g_e, (const float*)g_mhat, (float*)gx,
      (float*)gmo, (float*)slots, n, row_w, levels);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_slots_kernel<<<(W_TOTAL + 255) / 256, 256, 0, st>>>(
      (const float*)slots, (float*)gparams, batch);
  return (int)cudaGetLastError();
}
