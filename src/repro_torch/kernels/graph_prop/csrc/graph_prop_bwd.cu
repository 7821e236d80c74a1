// Enel graph propagation, eqs. 6-7 backward (VJP), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `graph_prop_bwd_kernel` (body
// `_bwd_kernel`) of src/repro/kernels/graph_prop/kernel.py.  Given the
// primal inputs of `graph_prop_fwd.cu` and the cotangents (g_e, g_mhat) of
// its outputs, it returns the gradients of x, m_obs and the nine f3/attn/f4
// weights.  Only the primal inputs are saved between the passes, so each
// graph first recomputes its forward: the f3 pair MLP, the masked softmax
// and the `levels` rounds of eq.7, stashing every level's input rows m_j.
// It then sweeps back through the levels (observed rows send their
// cotangent to m_obs) and through the softmax and the f4/f3 MLPs.
//
// Design.  One thread block per graph with the forward kernel's geometry
// (graph_prop_common.cuh): a warp per destination row i, its lanes W
// sources j times S hidden slices, each lane owning K = 32 / S hidden units,
// so each lane keeps K of a pair's pre_h and of its summed cotangent.  The
// reverse sweep takes the per-node form of the VJP:
//   u_i = W42 g_prop_i, then per pair
//   g_e_ij += hh_ij . u_i + g_prop_i . b42,
//   g_zz_ij = e_ij u_i ⊙ dleaky(zz_ij),
// and gW42 from S_i = sum_j e_ij hh_ij, reduce-scattered over the row's
// lanes so that lane (j, s) holds S_i[s*K + j] and accumulates its five
// gW42 entries in registers over the levels.  Sums over j (rows) are
// shuffles; sums over i (columns: G_j = sum_i g_zz_ij, the cotangent of
// m_j) cross warps, so each level stages g_zz and its W41[16:] product in
// shared memory, and warp j sums column j in row order.  That column is
// node j's cotangent, which is what row j's warp needs at the level
// before: each warp keeps its row's g_prop in registers, each lane forms
// its own units of u_i and of m_j @ W41[16:] from the level stash, and the
// staging alternates between two buffers, so a level takes one
// __syncthreads().  What a lane reads of W42 and W41[16:] at every level
// stays in registers where it fits (K <= 8: the training ring's N = 8);
// the shared-memory and shuffle pipe, not the FMAs, is what these loops
// wait on.  After the sweep every lane stages its pair vectors (h3,
// g_pre_h, h1, g_h3, g_z1, g_logit) pair-major with padded rows, and the
// parameter gradients are summed as register tiles (2 x 4 outputs a thread
// for gW41[:16], gW32 and gW31) over the real pairs in a fixed order.
// f3's first layer is split as in the forward, so gW31 and gx need only
// per-node row and column sums of g_z1:
//   gW31[:30] = sum_i x_i ⊗ R_i,  gW31[30:] = sum_j x_j ⊗ C_j.
// Everything lives in dynamic shared memory, whose size the host passes
// in (`ops.launch_plan`; 212 KB at N = 16, levels = 64).
//
// No float atomics: each graph writes its parameter gradients to its own
// slot of a (B, 3365) scratch tensor, and a second kernel sums the slots in
// graph order, so two launches on the same inputs agree bit for bit.
//
// Bound.  At N = 8, levels = 8 the VJP needs at least ~0.80 MFLOP per graph
// (chip_smoke.graph_prop_bwd_work: the forward once, then per level ~64
// FLOPs a pair) against ~2.7 KB of graph data in and out, float32 on the
// CUDA cores, so the 67 TFLOP/s fp32 rate bounds it, not the 3.35 TB/s of
// HBM.  At the training shape (B = 96) one block per graph leaves 36 of
// the 132 SMs idle, and the kernel's time is one block's latency.
//
// Numerics: FMA contraction and the summation order differ from the plain
// PyTorch VJP, so the two agree to float32 rounding, not bit for bit.
#include "graph_prop_common.cuh"

namespace {

using namespace gp;

constexpr int MAX_LEVELS = 64;
constexpr int PAIR_FLOATS = ED + HS + HS + ED + HS;   // h3 gph h1 gh3 gz1

template <int S>
struct Bwd {
  static constexpr int MAX_THREADS = 32 * (S == 2 ? 16 : S == 4 ? 8 : 4);
};

// float offsets of the dynamic shared-memory buffers of one block
// (ops.launch_plan mirrors `total`)
struct BwdLayout {
  int sx, su, sv, smobs, smcur, svalid, sms, smh, sgmo, sgp, sesum, sr, sc,
      sa42, sam, sab, region, total;
  __host__ __device__ BwdLayout(int wtotal, int n, int w, int levels) {
    const int p = n * w;
    sx = wtotal;
    su = sx + n * XS;
    sv = su + n * HS;
    smobs = sv + n * HS;
    smcur = smobs + n * MS;
    svalid = smcur + n * MS;
    sms = svalid + r4(n);
    smh = sms + r4(levels * n * NM);
    sgmo = smh + n * HS;
    sgp = sgmo + n * MS;
    sesum = sgp + n * MS;
    sr = sesum + r4(n);
    sc = sr + n * HS;
    sa42 = sc + n * HS;
    sam = sa42 + n * HID * NM;
    sab = sam + n * HID * NM;
    region = sab + n * HID;
    total = region + p * PAIR_FLOATS + r4(p);
  }
};

template <int S>
__global__ void __launch_bounds__(Bwd<S>::MAX_THREADS, 1)
    graph_prop_bwd_kernel(const Inputs in, const float* __restrict__ g_e,
                          const float* __restrict__ g_mhat,
                          float* __restrict__ gx_out,
                          float* __restrict__ gmo_out,
                          float* __restrict__ slots, int n, int levels) {
  using L = Layout<S>;
  constexpr int K = L::K, W = L::W;
  extern __shared__ __align__(16) float smem[];
  const BwdLayout bl(L::TOTAL, n, W, levels);
  float* sw = smem;
  float* sx = smem + bl.sx;
  float* su = smem + bl.su;
  float* sv = smem + bl.sv;
  float* smobs = smem + bl.smobs;
  float* smcur = smem + bl.smcur;
  float* svalid = smem + bl.svalid;
  float* sms = smem + bl.sms;        // (levels, n, NM): level inputs m_j
  float* smh = smem + bl.smh;        // m_j @ W41[16:] of the current level
  float* sgmo = smem + bl.sgmo;      // gradient of m_obs
  float* sgp = smem + bl.sgp;        // sum over levels of g_prop_i
  float* sesum = smem + bl.sesum;    // sum_j e_ij
  float* sr = smem + bl.sr;          // R_i = sum_j g_z1_ij
  float* sc = smem + bl.sc;          // C_j = sum_i g_z1_ij
  float* sa42 = smem + bl.sa42;      // per row: gW42[k][c] terms
  float* sam = smem + bl.sam;        // per column: gW41[16 + c][k] terms
  float* sab = smem + bl.sab;        // per column: gb41[k] terms
  const int P = n * W;
  // the reverse sweep's two staging buffers and, after it, the pair vectors
  float* stage = smem + bl.region;   // 2 x ((P, HS) g_zz_ij, (P, MS))
  float* t_h3 = smem + bl.region;    // (P, ED)
  float* t_gph = t_h3 + P * ED;      // (P, HS)
  float* t_h1 = t_gph + P * HS;      // (P, HS)
  float* t_gh3 = t_h1 + P * HS;      // (P, ED)
  float* t_gz1 = t_gh3 + P * ED;     // (P, HS)
  float* t_glog = t_gz1 + P * HS;    // (P,)

  const size_t g = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int i = tid >> 5, lane = tid & 31;
  const int j = lane / S, s = lane % S;
  const bool pair = j < n;
  const int jj = pair ? j : 0;          // in range for the idle lanes
  const int p = i * W + j;              // pair slot when `pair`
  const size_t row = (g * n + i) * n;
  const bool edge = pair && in.adj[row + j];
  const float ge_in = pair ? g_e[row + j] : 0.f;

  stage_inputs<S>(sw, sx, smobs, svalid, in, g, n);
  cp_wait();
  __syncthreads();
  node_halves<S>(sw, sx, su, sv, i, lane);
  __syncthreads();

  // ---- forward recompute
  float h3[ED], preh[K], logit;
  pair_forward<S>(sw, su + i * HS, sv + jj * HS, s, h3, preh, logit);
  float sm, e, n_pred;
  row_softmax<S>(logit, pair, edge, sm, e, n_pred);
  const float esum = jsum<S>(e);
  if (lane == 0) sesum[i] = esum;
  // this lane's W42 rows and W41[16:] columns (its slice s), in registers
  // across both sweeps where they fit (K <= 8)
  const W42Slice<S> w42(sw, s);
  constexpr bool WREG = K <= 8;
  float w41s[NM][WREG ? K : 1];
#pragma unroll
  for (int c = 0; c < NM; ++c)
#pragma unroll
    for (int t = 0; t < (WREG ? K : 1); ++t)
      w41s[c][t] = sw[L::W41 + (ED + c) * HID + s * K + t];
  {
    float w41m_k[NM];                 // column k = lane of W41[16:]
    w41m_column<S>(sw, lane, w41m_k);
    for (int lv = 0; lv < levels; ++lv) {
      {
        const bool obs = lv == 0 || svalid[i] != 0.f;
        const float* mrow = (obs ? smobs : smcur) + i * MS;
        smh[i * HS + lane] = node_mh(mrow, w41m_k);
        if (lane < NM) sms[(lv * n + i) * NM + lane] = mrow[lane];
      }
      __syncthreads();
      int c;
      const float mi = level_message<S>(w42, smh + jj * HS, preh, e, pair,
                                        s, lane, c);
      if ((lane & 3) == 0 && c < NM)
        smcur[i * MS + c] = svalid[i] != 0.f
                                ? smobs[i * MS + c]
                                : fmaf(esum, sw[L::B42 + c], mi);
      __syncthreads();
    }
  }

  // ---- reverse sweep, one __syncthreads() a level.  Warp i holds g_prop
  // of its row in registers (observed rows 0: their cotangent goes to
  // m_obs), and each lane forms its units of u_i = W42 g_prop_i and of
  // m_j @ W41[16:] from the stash.  Warp i's column phase yields node i's
  // cotangent, which is row i's g_prop at the level before, so no other
  // warp waits for it; the staging alternates between two buffers.
  float gp[NM];
  {
    const bool obs = svalid[i] != 0.f;
    float gm[NM];
#pragma unroll
    for (int c = 0; c < NM; ++c) {
      gm[c] = g_mhat[(g * n + i) * NM + c];
      gp[c] = obs ? 0.f : gm[c];
    }
    if (lane < NM) {
      float v = 0.f;
#pragma unroll
      for (int c = 0; c < NM; ++c) if (lane == c) v = gm[c];
      sgmo[i * MS + lane] = (obs || levels == 0) ? v : 0.f;
      sgp[i * MS + lane] = (obs || levels == 0) ? 0.f : v;
    }
  }
  float gph[K];                 // g_pre_h, summed over the levels
#pragma unroll
  for (int t = 0; t < K; ++t) gph[t] = 0.f;
  float ge_part = 0.f;          // sum over levels of this slice of hh . u
  float acc42[NM];              // gW42[s*K + j][c], this row's part
  float accm[NM], accb = 0.f;   // gW41[16 + c][lane], gb41[lane]: column i
#pragma unroll
  for (int c = 0; c < NM; ++c) acc42[c] = accm[c] = 0.f;
  for (int t = levels - 1; t >= 0; --t) {
    float* st_gz = stage + (t & 1) * P * (HS + MS);   // (P, HS): g_zz_ij
    float* st_v = st_gz + P * HS;                      // (P, MS): its W41m
    // per pair (i, j), slice s
    {
      const float* mrow = sms + (t * n + jj) * NM;
      float mj[NM];
#pragma unroll
      for (int c = 0; c < NM; ++c) mj[c] = mrow[c];
      float gz[K], rs[K];
#pragma unroll
      for (int q = 0; q < K; ++q) {
        float w[NM];
        w42.row(q, w);
        float u = 0.f, mh = 0.f;
#pragma unroll
        for (int c = 0; c < NM; ++c) {
          u = fmaf(w[c], gp[c], u);
          mh = fmaf(mj[c], WREG ? w41s[c][WREG ? q : 0]
                                : sw[L::W41 + (ED + c) * HID + s * K + q],
                    mh);
        }
        const float zz = preh[q] + mh;
        const float hh = leaky(zz);
        gz[q] = e * u * dleaky(zz);
        gph[q] += gz[q];
        ge_part = fmaf(hh, u, ge_part);
        rs[q] = e * hh;
      }
      float v[NM];
#pragma unroll
      for (int c = 0; c < NM; ++c) {
        float acc = 0.f;
        if constexpr (WREG) {
#pragma unroll
          for (int q = 0; q < K; ++q) acc = fmaf(w41s[c][q], gz[q], acc);
        } else {
          const float4* wr = reinterpret_cast<const float4*>(
              sw + L::W41 + (ED + c) * HID + s * K);
#pragma unroll
          for (int q = 0; q < K / 4; ++q) {
            const float4 w = wr[q];
            acc = fmaf(w.x, gz[4 * q], acc);
            acc = fmaf(w.y, gz[4 * q + 1], acc);
            acc = fmaf(w.z, gz[4 * q + 2], acc);
            acc = fmaf(w.w, gz[4 * q + 3], acc);
          }
        }
        v[c] = acc;
      }
      sreduce<S>(v);
      const float si = reduce_scatter<S>(rs, j);    // S_i[s*K + j]
#pragma unroll
      for (int c = 0; c < NM; ++c) acc42[c] = fmaf(si, gp[c], acc42[c]);
      if (pair) {
        float4* dst = reinterpret_cast<float4*>(st_gz + p * HS + s * K);
#pragma unroll
        for (int q = 0; q < K / 4; ++q)
          dst[q] = make_float4(gz[4 * q], gz[4 * q + 1], gz[4 * q + 2],
                               gz[4 * q + 3]);
        if (s == 0) {
          *reinterpret_cast<float4*>(st_v + p * MS) =
              make_float4(v[0], v[1], v[2], v[3]);
          st_v[p * MS + 4] = v[4];
        }
      }
    }
    __syncthreads();
    // per column j = i (this warp's node), hidden unit k = lane
    {
      const int col = i, k = lane;
      float gcol = 0.f, gmj[NM];
#pragma unroll
      for (int c = 0; c < NM; ++c) gmj[c] = 0.f;
#pragma unroll 4
      for (int r = 0; r < n; ++r) {
        const int q = r * W + col;
        gcol += st_gz[q * HS + k];
        const float4 v4 = *reinterpret_cast<const float4*>(st_v + q * MS);
        gmj[0] += v4.x;
        gmj[1] += v4.y;
        gmj[2] += v4.z;
        gmj[3] += v4.w;
        gmj[4] += st_v[q * MS + 4];
      }
      const float* mrow = sms + (t * n + col) * NM;
#pragma unroll
      for (int c = 0; c < NM; ++c) accm[c] = fmaf(mrow[c], gcol, accm[c]);
      accb += gcol;
      // gmj: the cotangent of this level's input m_j
      const bool obs = svalid[col] != 0.f;
      if (k < NM) {
        float v = 0.f;
#pragma unroll
        for (int c = 0; c < NM; ++c) if (k == c) v = gmj[c];
        if (obs || t == 0) sgmo[col * MS + k] += v;
        if (t > 0) sgp[col * MS + k] += obs ? 0.f : v;
      }
#pragma unroll
      for (int c = 0; c < NM; ++c) gp[c] = obs ? 0.f : gmj[c];
    }
  }
  __syncthreads();              // the pair vectors below reuse the staging

  // ---- softmax, attention readout, f3 backward per pair
  float ge_acc = sreduce<S>(ge_part);
#pragma unroll
  for (int c = 0; c < NM; ++c)
    ge_acc = fmaf(sgp[i * MS + c], sw[L::B42 + c], ge_acc);
  const float g_et = pair ? ge_in + ge_acc : 0.f;
  const float g_sm = n_pred > 0.f ? g_et : 0.f;
  const float dot = jsum<S>(sm * g_sm);
  const float g_logit = edge ? sm * (g_sm - dot) : 0.f;

  float gh3[ED];
#pragma unroll
  for (int c = 0; c < ED; ++c) {
    const float4* wr =
        reinterpret_cast<const float4*>(sw + L::W41 + c * HID + s * K);
    float acc = 0.f;
#pragma unroll
    for (int q = 0; q < K / 4; ++q) {
      const float4 w = wr[q];
      acc = fmaf(w.x, gph[4 * q], acc);
      acc = fmaf(w.y, gph[4 * q + 1], acc);
      acc = fmaf(w.z, gph[4 * q + 2], acc);
      acc = fmaf(w.w, gph[4 * q + 3], acc);
    }
    gh3[c] = acc;
  }
  sreduce<S>(gh3);
#pragma unroll
  for (int c = 0; c < ED; ++c)
    gh3[c] = fmaf(g_logit * sw[L::A + c], dleaky(h3[c]), gh3[c]);

  float h1[K], gz1[K];
  {
    const float* su_i = su + i * HS + s * K;
    const float* sv_j = sv + jj * HS + s * K;
#pragma unroll
    for (int t = 0; t < K; ++t) {
      const float z1 = su_i[t] + sv_j[t];
      h1[t] = leaky(z1);
      const float4* wr =
          reinterpret_cast<const float4*>(sw + L::w32_row(s * K + t));
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < ED / 4; ++q) {
        const float4 w = wr[q];
        acc = fmaf(w.x, gh3[4 * q], acc);
        acc = fmaf(w.y, gh3[4 * q + 1], acc);
        acc = fmaf(w.z, gh3[4 * q + 2], acc);
        acc = fmaf(w.w, gh3[4 * q + 3], acc);
      }
      gz1[t] = acc * dleaky(z1);
    }
  }
  if (pair) {
    if (s == 0) {
      float4* a = reinterpret_cast<float4*>(t_h3 + p * ED);
      float4* b = reinterpret_cast<float4*>(t_gh3 + p * ED);
#pragma unroll
      for (int q = 0; q < ED / 4; ++q) {
        a[q] = make_float4(h3[4 * q], h3[4 * q + 1], h3[4 * q + 2],
                           h3[4 * q + 3]);
        b[q] = make_float4(gh3[4 * q], gh3[4 * q + 1], gh3[4 * q + 2],
                           gh3[4 * q + 3]);
      }
      t_glog[p] = g_logit;
    }
    float4* a = reinterpret_cast<float4*>(t_gph + p * HS + s * K);
    float4* b = reinterpret_cast<float4*>(t_h1 + p * HS + s * K);
    float4* c = reinterpret_cast<float4*>(t_gz1 + p * HS + s * K);
#pragma unroll
    for (int q = 0; q < K / 4; ++q) {
      a[q] = make_float4(gph[4 * q], gph[4 * q + 1], gph[4 * q + 2],
                         gph[4 * q + 3]);
      b[q] = make_float4(h1[4 * q], h1[4 * q + 1], h1[4 * q + 2],
                         h1[4 * q + 3]);
      c[q] = make_float4(gz1[4 * q], gz1[4 * q + 1], gz1[4 * q + 2],
                         gz1[4 * q + 3]);
    }
  }
  {
    const float ri = reduce_scatter<S>(gz1, j);   // R_i[s*K + j]
    sr[i * HS + s * K + j] = ri;
#pragma unroll
    for (int c = 0; c < NM; ++c) {
      sa42[(i * HID + s * K + j) * NM + c] = acc42[c];
      sam[(i * HID + lane) * NM + c] = accm[c];
    }
    sab[i * HID + lane] = accb;
  }
  __syncthreads();

  // ---- parameter gradients: register tiles over the real pairs, in order
  float* slot = slots + g * W_TOTAL;
  for (int it = tid; it < 128; it += nt) {
    // gW41[:16] (c 2 x k 4 tiles) or gW32 (k 4 x c 2 tiles)
    const bool w41 = it < 64;
    const int r = w41 ? it : it - 64;
    const int c0 = 2 * (w41 ? r / 8 : r % 8);
    const int k0 = 4 * (w41 ? r % 8 : r / 8);
    const float* a_buf = w41 ? t_h3 : t_gh3;
    const float* b_buf = w41 ? t_gph : t_h1;
    float acc[2][4] = {};
    for (int a = 0; a < n; ++a)
#pragma unroll 4
      for (int b = 0; b < n; ++b) {
        const int q = a * W + b;
        const float2 x2 = *reinterpret_cast<const float2*>(a_buf + q * ED + c0);
        const float4 y4 = *reinterpret_cast<const float4*>(b_buf + q * HS + k0);
        const float xv[2] = {x2.x, x2.y};
        const float yv[4] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(xv[u], yv[v], acc[u][v]);
      }
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        if (w41) slot[O_W41 + (c0 + u) * HID + k0 + v] = acc[u][v];
        else slot[O_W32 + (k0 + v) * ED + c0 + u] = acc[u][v];
      }
  }
  // the other sums, one item a thread, after the tiles
  const int n_items = 81 + 8 * n;
  for (int it0 = tid; it0 < n_items + 128; it0 += nt) {
    const int it = it0 - 128;
    if (it < 0) continue;
    if (it < 8) {
      // gb32 = sum g_h3 (it < 4), g_attn = sum g_logit leaky(h3)
      const bool gb = it < 4;
      const int c0 = 4 * (gb ? it : it - 4);
      float acc[4] = {};
      for (int a = 0; a < n; ++a)
#pragma unroll 4
        for (int b = 0; b < n; ++b) {
          const int q = a * W + b;
          const float4 y4 = *reinterpret_cast<const float4*>(
              (gb ? t_gh3 : t_h3) + q * ED + c0);
          const float yv[4] = {y4.x, y4.y, y4.z, y4.w};
          const float gl = gb ? 1.f : t_glog[q];
#pragma unroll
          for (int v = 0; v < 4; ++v)
            acc[v] = gb ? acc[v] + yv[v] : fmaf(gl, leaky(yv[v]), acc[v]);
        }
#pragma unroll
      for (int v = 0; v < 4; ++v) slot[(gb ? O_B32 : O_A) + c0 + v] = acc[v];
    } else if (it < 8 + 8 * n) {
      // C_j = sum_i g_z1_ij
      const int r = it - 8, col = r / 8, k0 = 4 * (r % 8);
      float acc[4] = {};
#pragma unroll 4
      for (int a = 0; a < n; ++a) {
        const float4 y4 = *reinterpret_cast<const float4*>(
            t_gz1 + (a * W + col) * HS + k0);
        acc[0] += y4.x;
        acc[1] += y4.y;
        acc[2] += y4.z;
        acc[3] += y4.w;
      }
      *reinterpret_cast<float4*>(sc + col * HS + k0) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else if (it < 16 + 8 * n) {
      // gb31 = sum_i R_i
      const int k0 = 4 * (it - 8 - 8 * n);
      float acc[4] = {};
      for (int a = 0; a < n; ++a) {
        const float4 y4 = *reinterpret_cast<const float4*>(sr + a * HS + k0);
        acc[0] += y4.x;
        acc[1] += y4.y;
        acc[2] += y4.z;
        acc[3] += y4.w;
      }
#pragma unroll
      for (int v = 0; v < 4; ++v) slot[O_B31 + k0 + v] = acc[v];
    } else if (it < 48 + 8 * n) {
      // gW41[16:] and gb41: the columns' terms summed in column order
      const int k = it - 16 - 8 * n;
      float acc[NM] = {}, accb1 = 0.f;
      for (int col = 0; col < n; ++col) {
#pragma unroll
        for (int c = 0; c < NM; ++c) acc[c] += sam[(col * HID + k) * NM + c];
        accb1 += sab[col * HID + k];
      }
#pragma unroll
      for (int c = 0; c < NM; ++c) slot[O_W41 + (ED + c) * HID + k] = acc[c];
      slot[O_B41 + k] = accb1;
    } else if (it < 80 + 8 * n) {
      // gW42: the rows' terms summed in row order
      const int k = it - 48 - 8 * n;
      float acc[NM] = {};
      for (int a = 0; a < n; ++a)
#pragma unroll
        for (int c = 0; c < NM; ++c) acc[c] += sa42[(a * HID + k) * NM + c];
#pragma unroll
      for (int c = 0; c < NM; ++c) slot[O_W42 + k * NM + c] = acc[c];
    } else {
      // gb42 = sum_i (sum_j e_ij) (sum over levels of g_prop_i)
      float acc[NM] = {};
      for (int a = 0; a < n; ++a)
#pragma unroll
        for (int c = 0; c < NM; ++c)
          acc[c] = fmaf(sesum[a], sgp[a * MS + c], acc[c]);
#pragma unroll
      for (int c = 0; c < NM; ++c) slot[O_B42 + c] = acc[c];
    }
  }
  __syncthreads();

  // ---- f3's first layer per node: gW31, gx; and gm_obs
  // gW31 in d 2 x k 4 tiles (rows d and d + 1 of one half)
  for (int it = tid; it < XD * 8 + n * XD + n * NM; it += nt) {
    if (it < XD * 8) {
      const int d = 2 * (it / 8), k0 = 4 * (it % 8);
      const float* sums = d < XD ? sr : sc;
      const int dd = d < XD ? d : d - XD;
      float acc[2][4] = {};
#pragma unroll 4
      for (int node = 0; node < n; ++node) {
        const float2 x2 = *reinterpret_cast<const float2*>(sx + node * XS + dd);
        const float4 y4 = *reinterpret_cast<const float4*>(sums + node * HS + k0);
        const float xv[2] = {x2.x, x2.y};
        const float yv[4] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(xv[u], yv[v], acc[u][v]);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v)
          slot[O_W31 + (d + u) * HID + k0 + v] = acc[u][v];
    } else if (it < XD * 8 + n * XD) {
      const int r = it - XD * 8, node = r / XD, d = r % XD;
      const float4* wa = reinterpret_cast<const float4*>(sw + L::W31 + d * HID);
      const float4* wb =
          reinterpret_cast<const float4*>(sw + L::W31 + (XD + d) * HID);
      const float4* ra = reinterpret_cast<const float4*>(sr + node * HS);
      const float4* cb = reinterpret_cast<const float4*>(sc + node * HS);
      float acc[4] = {};           // four chains, summed at the end
#pragma unroll
      for (int q = 0; q < HID / 4; ++q) {
        const float4 a = wa[q], b = wb[q], x = ra[q], y = cb[q];
        acc[0] = fmaf(a.x, x.x, acc[0]);
        acc[1] = fmaf(a.y, x.y, acc[1]);
        acc[2] = fmaf(a.z, x.z, acc[2]);
        acc[3] = fmaf(a.w, x.w, acc[3]);
        acc[0] = fmaf(b.x, y.x, acc[0]);
        acc[1] = fmaf(b.y, y.y, acc[1]);
        acc[2] = fmaf(b.z, y.z, acc[2]);
        acc[3] = fmaf(b.w, y.w, acc[3]);
      }
      gx_out[g * n * XD + r] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
    } else {
      const int r = it - XD * 8 - n * XD;
      gmo_out[g * n * NM + r] = sgmo[(r / NM) * MS + r % NM];
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

template <int S>
cudaError_t launch(const Inputs& in, const float* g_e, const float* g_mhat,
                   float* gx, float* gmo, float* slots, int batch, int n,
                   int levels, int threads, int smem, cudaStream_t st) {
  const BwdLayout bl(Layout<S>::TOTAL, n, Layout<S>::W, levels);
  if (threads != 32 * n || (size_t)smem != sizeof(float) * (size_t)bl.total)
    return cudaErrorInvalidValue;
  static int smem_set = 48 * 1024;
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        graph_prop_bwd_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  graph_prop_bwd_kernel<S><<<batch, threads, smem, st>>>(in, g_e, g_mhat, gx, gmo, slots, n, levels);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Pointers are device pointers of
// contiguous tensors: the forward's inputs (x (B,N,30) f32, adj (B,N,N) u8,
// m_obs (B,N,5) f32, valid (B,N) u8, the nine weights in (in, out) layout),
// the cotangents g_e (B,N,N) and g_mhat (B,N,5) f32, and the outputs gx
// (B,N,30), gm_obs (B,N,5), a scratch of per-graph slots (B, 3365) and the
// summed parameter gradients (3365,) f32 in the weights' order and layout.
// `threads`, `slices`, `width` and `smem` are the host's launch plan; a
// plan other than this file's is refused.  Launches the per-graph kernel,
// then the slot sum, on `stream`.  Returns the first cudaError_t.
extern "C" int graph_prop_bwd(const void* x, const void* adj, const void* m_obs,
                              const void* valid, const void* w31,
                              const void* b31, const void* w32,
                              const void* b32, const void* attn,
                              const void* w41, const void* b41,
                              const void* w42, const void* b42,
                              const void* g_e, const void* g_mhat, void* gx,
                              void* gmo, void* slots, void* gparams,
                              int batch, int n, int levels, int threads,
                              int slices, int width, int smem, void* stream) {
  if (batch < 1 || n < 1 || n > MAXN || levels < 0 || levels > MAX_LEVELS)
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
  const float* ge = (const float*)g_e;
  const float* gm = (const float*)g_mhat;
  float* gxo = (float*)gx;
  float* gmoo = (float*)gmo;
  float* sl = (float*)slots;
  cudaError_t err = cudaErrorInvalidValue;
  switch (slices) {
    case 2: err = launch<2>(in, ge, gm, gxo, gmoo, sl, batch, n, levels, threads, smem, st); break;
    case 4: err = launch<4>(in, ge, gm, gxo, gmoo, sl, batch, n, levels, threads, smem, st); break;
    case 8: err = launch<8>(in, ge, gm, gxo, gmoo, sl, batch, n, levels, threads, smem, st); break;
  }
  if (err != cudaSuccess) return (int)err;
  sum_slots_kernel<<<(W_TOTAL + 255) / 256, 256, 0, st>>>(sl, (float*)gparams, batch);
  return (int)cudaGetLastError();
}
