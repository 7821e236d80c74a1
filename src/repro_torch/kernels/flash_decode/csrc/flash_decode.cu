// Flash decode for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel `flash_decode` (src/repro/kernels/flash_decode/
// kernel.py:58, body `_kernel` :23): one-token attention of q (B, 1, H, D)
// against a KV cache over positions <= pos, and > pos - window when a window
// is set; GQA with query head h reading kv head h / (H / Kh).  It also takes
// the tanh logit softcap of `flash_attention`, which the models' decode
// needs (gemma2) and the TPU kernel lacks.
//
// What bounds it on the H100: bytes.  Every visible cache row is read once
// (B * Kh * (pos + 1) * D * 2 tensors * element size) for 4 FLOPs per
// element, far below the ~295 operations per byte at which the tensor cores
// would be the limit; the least time is those bytes at 3.35 TB/s (28.8 MB,
// 0.0086 ms, at qwen3's B 8, Kh 8, D 128, pos 875).  Reaching it takes
// enough bytes in flight on every SM: at B * Kh = 64 (batch, kv head) pairs,
// one block per pair leaves half of the 132 SMs idle and each of the rest
// waiting on one serial walk of the cache.
//
// Design (split-K, one launch):
//   - The visible range [kbeg, kend) is cut into `n_chunks` chunks of `chunk`
//     keys by the wrapper's host function `split_plan` (ops.py), none empty.
//     One block of 128 threads owns one (chunk, kv head, batch) and serves
//     all `group` = H / Kh <= 8 query heads of that kv head, so each K and V
//     row is read once, not once per query head.
//   - The cache is read in place in its (B, S, Kh, D) layout.  D / 8 threads
//     share a row, each holding 8 columns: one 16-byte load per row of K and
//     of V in bfloat16 (two in float32), neighbouring threads on
//     neighbouring addresses.  A thread walks 4 rows per step (2 at group 8)
//     and loads the next step's rows into registers while it computes
//     this one.
//   - Dot products, the online softmax and the accumulators stay float32 on
//     the CUDA cores (4 FLOPs per element; the tensor cores would not help a
//     bytes-bound kernel).  Each group of D / 8 lanes reduces a row's dot
//     products with xor-shuffles; each lane group keeps its own (m, l, acc)
//     over the rows it saw, and the block merges them in shared memory in a
//     fixed order.
//   - Chunks are merged inside the same launch: each block writes its float32
//     (m, l, acc[group][D]) to scratch from the wrapper, then takes an integer
//     ticket (`atomicAdd` after `__threadfence`).  The block that draws the
//     last ticket of its (batch, kv head) merges the chunks in chunk order,
//     writes the output and resets the ticket for the next call.  No float
//     atomics: results repeat bit for bit.
//   - The visible rows [kbeg, kend) are host ints shared by the batch,
//     passed by value: no device scalar and no sync.  The wrapper derives
//     them from `pos` and the window ([pos - window + 1, pos], clipped at
//     0), or takes them from its caller: a rank holding one slice of a
//     cache split along its sequence passes the rows of its slice that
//     the token sees, local to the slice.  Every key in the range is
//     visible, so visiting only those gives what the reference's -1e30
//     masking gives.  The range is never empty (the wrapper answers an
//     empty one without a launch: o = 0, lse = -inf).
//   - With `lse` non-null the kernel also writes each query head's
//     float32 log-sum-exp over the range, (B, H) contiguous: the merged
//     (M, L) of the chunks as M + log L, which a merge across ranks needs.
//     Without it a launch computes what it computed before, bit for bit.
// Layout contract (ops.py copies a cache that breaks it): D a multiple of 8,
// unit innermost stride, the other strides multiples of 16 bytes, 16-byte
// aligned bases.  q and o are read and written through any strides.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kMaxGroup = 8;    // query heads per kv head
constexpr int kMaxChunks = 64;  // chunks per (batch, kv head); ops.MAX_CHUNKS

struct Args {
  long long qb, qh, qd;         // strides, in elements
  long long kb, ks, kh;         // the cache's innermost stride is 1
  long long vb, vs, vh;
  long long ob, oh, od;
  int b, h, n_kv, d, kbeg, kend, chunk, n_chunks;
  float scale, softcap;
  float* lse;                   // (B, H) or null
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// 8 consecutive cache elements as loaded: 16 bytes of bf16, 32 of float.
template <typename T> struct Raw;
template <> struct Raw<__nv_bfloat16> { uint4 u[1]; };
template <> struct Raw<float> { uint4 u[2]; };

template <typename T>
__device__ __forceinline__ void fetch(Raw<T>& r, const T* p, bool ok) {
#pragma unroll
  for (int i = 0; i < (int)(sizeof(r.u) / 16); ++i)
    r.u[i] = ok ? __ldg(reinterpret_cast<const uint4*>(p) + i)
                : make_uint4(0u, 0u, 0u, 0u);
}

__device__ __forceinline__ void widen(const Raw<__nv_bfloat16>& r,
                                      float (&x)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(r.u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void widen(const Raw<float>& r, float (&x)[8]) {
  const float* f = reinterpret_cast<const float*>(r.u);
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = f[i];
}

template <typename T, int DP, int G>
__global__ void __launch_bounds__(kThreads)
    fd_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o,
              float* __restrict__ part, int* __restrict__ tickets, Args a) {
  constexpr int TPR = DP / 8;            // threads per cache row
  constexpr int RL = kThreads / TPR;     // rows in flight per step
  constexpr int R = G >= 8 ? 2 : 4;      // rows per thread per step
  constexpr int STEP = RL * R;
  __shared__ float sm_m[RL][G], sm_l[RL][G];
  __shared__ float sm_acc[RL * G * DP];
  __shared__ float sm_f[kMaxChunks][G];  // merge factors exp(m_i - M)
  __shared__ float sm_big_m[G], sm_big_l[G];
  __shared__ int sm_last;

  const int tid = threadIdx.x, rl = tid / TPR, cc = tid % TPR;
  const int ci = blockIdx.x, hk = blockIdx.y, bb = blockIdx.z;
  const int group = a.h / a.n_kv;
  const int c0 = a.kbeg + ci * a.chunk;
  const int c1 = min(c0 + a.chunk, a.kend);      // this chunk: [c0, c1)
  const bool col_ok = cc * 8 < a.d;

  float qv[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int col = cc * 8 + e;
      qv[g][e] = g < group && col < a.d
                     ? to_f(q[bb * a.qb + (hk * group + g) * a.qh +
                              col * a.qd])
                     : 0.f;
    }
  float m[G], l[G], acc[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  }

  const T* kbase = k + bb * a.kb + hk * a.kh + cc * 8;
  const T* vbase = v + bb * a.vb + hk * a.vh + cc * 8;
  Raw<T> kr[R], vr[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int key = c0 + j * RL + rl;
    const bool ok = key < c1 && col_ok;
    fetch(kr[j], kbase + (long long)key * a.ks, ok);
    fetch(vr[j], vbase + (long long)key * a.vs, ok);
  }
  for (int s0 = c0; s0 < c1; s0 += STEP) {
    // the next step's rows, in flight while this one computes
    Raw<T> kn[R], vn[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int key = s0 + STEP + j * RL + rl;
      const bool ok = key < c1 && col_ok;
      fetch(kn[j], kbase + (long long)key * a.ks, ok);
      fetch(vn[j], vbase + (long long)key * a.vs, ok);
    }

    float sc[R][G];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      float kx[8];
      widen(kr[j], kx);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) dot = fmaf(qv[g][e], kx[e], dot);
        sc[j][g] = dot;
      }
    }
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1)
#pragma unroll
      for (int j = 0; j < R; ++j)
#pragma unroll
        for (int g = 0; g < G; ++g)
          sc[j][g] += __shfl_xor_sync(0xffffffffu, sc[j][g], off);

#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        float x = sc[j][g] * a.scale;
        if (a.softcap > 0.f) x = tanhf(x / a.softcap) * a.softcap;
        sc[j][g] = x;
        if (s0 + j * RL + rl < c1) mx = fmaxf(mx, x);
      }
      const float mn = fmaxf(m[g], mx);
      const float alpha = expf(m[g] - mn);
      m[g] = mn;
      l[g] *= alpha;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] *= alpha;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        if (s0 + j * RL + rl >= c1) continue;
        const float p = expf(sc[j][g] - mn);
        l[g] += p;
        float vx[8];
        widen(vr[j], vx);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(p, vx[e], acc[g][e]);
      }
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      kr[j] = kn[j];
      vr[j] = vn[j];
    }
  }

  // merge the RL lane groups of this block, in order
  if (cc == 0)
#pragma unroll
    for (int g = 0; g < G; ++g) {
      sm_m[rl][g] = m[g];
      sm_l[rl][g] = l[g];
    }
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e)
      sm_acc[(rl * G + g) * DP + cc * 8 + e] = acc[g][e];
  __syncthreads();
  if (tid < G) {
    float big = kNegInf;
    for (int r = 0; r < RL; ++r) big = fmaxf(big, sm_m[r][tid]);
    float sum = 0.f;
    for (int r = 0; r < RL; ++r) {
      const float f = expf(sm_m[r][tid] - big);
      sm_f[r][tid] = f;
      sum = fmaf(sm_l[r][tid], f, sum);
    }
    sm_big_m[tid] = big;
    sm_big_l[tid] = sum;
  }
  __syncthreads();

  const long long pair = (long long)bb * a.n_kv + hk;
  const long long stride = (long long)group * (a.d + 2);   // one chunk
  float* mine = a.n_chunks > 1 ? part + (pair * a.n_chunks + ci) * stride
                               : nullptr;
  for (int i = tid; i < G * DP; i += kThreads) {
    const int g = i / DP, col = i % DP;
    if (g >= group || col >= a.d) continue;
    float s = 0.f;
    for (int r = 0; r < RL; ++r)
      s = fmaf(sm_acc[(r * G + g) * DP + col], sm_f[r][g], s);
    if (a.n_chunks == 1) {
      store(o + bb * a.ob + (hk * group + g) * a.oh + col * a.od,
            s / fmaxf(sm_big_l[g], 1e-20f));
    } else {
      mine[2 * group + g * a.d + col] = s;
    }
  }
  if (a.n_chunks == 1) {
    if (a.lse != nullptr && tid < group)
      a.lse[(long long)bb * a.h + hk * group + tid] =
          sm_big_m[tid] + logf(sm_big_l[tid]);
    return;
  }
  if (tid < group) {
    mine[tid] = sm_big_m[tid];
    mine[group + tid] = sm_big_l[tid];
  }

  // the last block of this (batch, kv head) merges the chunks, in order
  __threadfence();
  __syncthreads();
  if (tid == 0)
    sm_last = atomicAdd(tickets + pair, 1) == a.n_chunks - 1;
  __syncthreads();
  if (!sm_last) return;
  __threadfence();
  const float* first = part + pair * a.n_chunks * stride;
  if (tid < group) {
    float big = kNegInf;
    for (int c = 0; c < a.n_chunks; ++c)
      big = fmaxf(big, __ldcg(first + c * stride + tid));
    float sum = 0.f;
    for (int c = 0; c < a.n_chunks; ++c) {
      const float* pc = first + c * stride;
      const float f = expf(__ldcg(pc + tid) - big);
      sm_f[c][tid] = f;
      sum = fmaf(__ldcg(pc + group + tid), f, sum);
    }
    sm_big_l[tid] = sum;
    if (a.lse != nullptr)
      a.lse[(long long)bb * a.h + hk * group + tid] = big + logf(sum);
  }
  __syncthreads();
  for (int i = tid; i < group * a.d; i += kThreads) {
    const int g = i / a.d, col = i % a.d;
    float s = 0.f;
    for (int c = 0; c < a.n_chunks; ++c)
      s = fmaf(__ldcg(first + c * stride + 2 * group + i), sm_f[c][g], s);
    store(o + bb * a.ob + (hk * group + g) * a.oh + col * a.od,
          s / fmaxf(sm_big_l[g], 1e-20f));
  }
  if (tid == 0) tickets[pair] = 0;
}

template <typename T, int DP, int G>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* part, int* tickets, const Args& a,
                   cudaStream_t stream) {
  const dim3 grid(a.n_chunks, a.n_kv, a.b);
  fd_kernel<T, DP, G><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), part, tickets, a);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t by_group(const void* q, const void* k, const void* v, void* o,
                     float* part, int* tickets, const Args& a,
                     cudaStream_t stream) {
  const int group = a.h / a.n_kv;
  if (group <= 1) return launch<T, DP, 1>(q, k, v, o, part, tickets, a, stream);
  if (group <= 2) return launch<T, DP, 2>(q, k, v, o, part, tickets, a, stream);
  if (group <= 4) return launch<T, DP, 4>(q, k, v, o, part, tickets, a, stream);
  return launch<T, DP, 8>(q, k, v, o, part, tickets, a, stream);
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     float* part, int* tickets, const Args& a,
                     cudaStream_t stream) {
  if (a.d <= 32) return by_group<T, 32>(q, k, v, o, part, tickets, a, stream);
  if (a.d <= 64) return by_group<T, 64>(q, k, v, o, part, tickets, a, stream);
  if (a.d <= 128)
    return by_group<T, 128>(q, k, v, o, part, tickets, a, stream);
  return by_group<T, 256>(q, k, v, o, part, tickets, a, stream);
}

}  // namespace

// q (B, 1, H, D) and o (B, 1, H, D) with strides for (b, h, d); cache_k and
// cache_v (B, S, Kh, D) with strides for (b, s, kh, d), in elements; dtype
// 0 = float32, 1 = bfloat16.  The visible keys [kbeg, kend) (not empty)
// are cut into n_chunks chunks of `chunk` keys, none empty.  `part` holds
// B * Kh * n_chunks * (H / Kh) * (D + 2) floats of scratch (unused when
// n_chunks is 1) and `tickets` B * Kh zeroed ints, which the kernel leaves
// zeroed; `lse`, when not null, receives (B, H) float32 log-sum-exps.
// Returns the CUDA error of the launch.
extern "C" int flash_decode(
    const void* q, const void* k, const void* v, void* o, long long qb,
    long long qh, long long qd, long long kb, long long ks, long long kh,
    long long kd, long long vb, long long vs, long long vh, long long vd,
    long long ob, long long oh, long long od, int b, int h, int n_kv, int d,
    int kbeg, int kend, int chunk, int n_chunks, int dtype, float scale,
    float softcap, void* part, void* tickets, void* lse, void* stream) {
  if (d < 1 || d > 256 || (d & 7) || n_kv < 1 || h % n_kv != 0 ||
      h / n_kv > kMaxGroup || kbeg < 0 || kend <= kbeg || softcap < 0.f ||
      kd != 1 || vd != 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int n_keys = kend - kbeg;
  if (chunk < 1 || n_chunks < 1 || n_chunks > kMaxChunks ||
      (long long)chunk * n_chunks < n_keys ||
      (long long)chunk * (n_chunks - 1) >= n_keys ||
      (n_chunks > 1 && (part == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  const long long vec = dtype == 1 ? 8 : 4;   // elements per 16 bytes
  const unsigned long long ptrs = reinterpret_cast<unsigned long long>(k) |
                                  reinterpret_cast<unsigned long long>(v);
  if (((kb | ks | kh | vb | vs | vh) % vec) || (ptrs & 15))
    return (int)cudaErrorInvalidValue;
  const Args a{qb, qh, qd, kb, ks, kh, vb, vs, vh, ob, oh, od,
               b, h, n_kv, d, kbeg, kend, chunk, n_chunks, scale, softcap,
               static_cast<float*>(lse)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pf = static_cast<float*>(part);
  int* tk = static_cast<int*>(tickets);
  const cudaError_t err =
      dtype == 1 ? dispatch<__nv_bfloat16>(q, k, v, o, pf, tk, a, st)
                 : dispatch<float>(q, k, v, o, pf, tk, a, st);
  return (int)err;
}
