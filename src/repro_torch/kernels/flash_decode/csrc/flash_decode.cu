// Flash decode for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel `flash_decode` (src/repro/kernels/flash_decode/
// kernel.py:58, body `_kernel` :23): one-token attention of q (B, 1, H, D)
// against a KV cache over positions <= pos, and > pos - window when a window
// is set; GQA with query head h reading kv head h / (H / Kh).  It also takes
// the tanh logit softcap of `flash_attention`, which the models' decode
// needs (gemma2) and the TPU kernel lacks.
//
// What bounds it on the H100: bytes.  Every cache row up to `pos` is read
// once (B * Kh * (pos + 1) * D * 2 tensors * element size) for 4 FLOPs per
// element, far below the ~295 operations per byte at which the tensor cores
// would be the limit; the least time is those bytes at 3.35 TB/s.
//
// Design.  The TPU kernel walks the cache in blocks along a sequential grid
// axis, carrying (m, l, acc) in VMEM, and its JAX wrapper transposes the
// whole cache to (B, Kh, S, D) on every call.  Here:
//   - the cache is read in place in its (B, S, Kh, D) layout through strides;
//     nothing is copied;
//   - one block of 128 threads owns one (batch, kv head) and serves all
//     `group` = H / Kh query heads of that kv head, so each K and V row is
//     read from device memory once, not once per query head;
//   - the block loops over 64-key tiles from the first visible key up to
//     `pos` only, staging K and V as float32 in shared memory (K rows padded
//     by one float so a thread per key reads conflict-free); one warp per
//     query head keeps the online-softmax state (m, l) in shared memory, and
//     each thread keeps float32 accumulators for its output columns;
//   - `pos` is a host int shared by the batch, passed by value: no device
//     scalar and no sync.
// Every visited tile holds at least one visible key (the range [pos - window
// + 1, pos] is never empty), so skipping the rest of the cache gives what the
// reference's -1e30 masking gives.
//
// At B = 8 with 8 kv heads this is 64 blocks on 132 SMs, each walking up to
// pos / 64 tiles in turn.  Splitting the cache over several blocks per (b,
// kv head) with a combine pass (split-K) is the first lever of a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kTile = 64;       // keys per tile
constexpr int kMaxGroup = 8;    // query heads per kv head

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

struct Args {
  long long qb, qh, qd;       // strides, in elements
  long long kb, ks, kh, kd;
  long long vb, vs, vh, vd;
  long long ob, oh, od;
  int b, h, n_kv, d, pos, window;
  float scale, softcap;
};

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
    fd_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, Args a) {
  constexpr int RS = DMAX + 1;
  constexpr int DC = (DMAX + kThreads - 1) / kThreads;
  const int group = a.h / a.n_kv;
  extern __shared__ float smem[];
  float* qs = smem;                    // group x DMAX
  float* ks = qs + group * DMAX;       // kTile x RS
  float* vs = ks + kTile * RS;         // kTile x DMAX
  float* ss = vs + kTile * DMAX;       // group x kTile: scores, then p
  float* ms = ss + group * kTile;      // group: running max
  float* ls = ms + group;              // group: running sum
  float* as = ls + group;              // group: this tile's rescale

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hk = blockIdx.x, bb = blockIdx.y;
  const int d = a.d;

  for (int i = tid; i < group * DMAX; i += kThreads) {
    const int g = i / DMAX, c = i % DMAX;
    qs[i] = c < d ? to_f(q[bb * a.qb + (hk * group + g) * a.qh + c * a.qd])
                  : 0.f;
  }
  for (int g = tid; g < group; g += kThreads) {
    ms[g] = kNegInf;
    ls[g] = 0.f;
  }
  float acc[kMaxGroup][DC];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[g][c] = 0.f;

  const int kbeg = a.window ? max(0, a.pos - a.window + 1) : 0;
  const int kend = a.pos + 1;
  const T* kbase = k + bb * a.kb + hk * a.kh;
  const T* vbase = v + bb * a.vb + hk * a.vh;
  for (int k0 = kbeg; k0 < kend; k0 += kTile) {
    __syncthreads();   // q staged / the previous tile's readers are done
    for (int i = tid; i < kTile * DMAX; i += kThreads) {
      const int r = i / DMAX, c = i % DMAX;
      float kx = 0.f, vx = 0.f;
      if (k0 + r < kend && c < d) {
        const long long key = k0 + r;
        kx = to_f(kbase[key * a.ks + c * a.kd]);
        vx = to_f(vbase[key * a.vs + c * a.vd]);
      }
      ks[r * RS + c] = kx;
      vs[r * DMAX + c] = vx;
    }
    __syncthreads();

    for (int i = tid; i < group * kTile; i += kThreads) {
      const int g = i / kTile, r = i % kTile;
      float dot = 0.f;
#pragma unroll 8
      for (int c = 0; c < DMAX; ++c)
        dot = fmaf(qs[g * DMAX + c], ks[r * RS + c], dot);
      float x = dot * a.scale;
      if (a.softcap > 0.f) x = tanhf(x / a.softcap) * a.softcap;
      ss[i] = x;
    }
    __syncthreads();

    for (int g = warp; g < group; g += kThreads / 32) {
      float mx = kNegInf;
      for (int r = lane; r < kTile; r += 32)
        if (k0 + r < kend) mx = fmaxf(mx, ss[g * kTile + r]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = ms[g];
      const float m_new = fmaxf(m_old, mx);
      const float alpha = expf(m_old - m_new);
      float sum = 0.f;
      for (int r = lane; r < kTile; r += 32) {
        const float p = k0 + r < kend ? expf(ss[g * kTile + r] - m_new) : 0.f;
        ss[g * kTile + r] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (lane == 0) {
        ms[g] = m_new;
        ls[g] = ls[g] * alpha + sum;
        as[g] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      if (g >= group) break;
      const float alpha = as[g];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int col = tid + kThreads * c;
        if (col >= DMAX) continue;
        float t = acc[g][c] * alpha;
#pragma unroll 8
        for (int r = 0; r < kTile; ++r)
          t = fmaf(ss[g * kTile + r], vs[r * DMAX + col], t);
        acc[g][c] = t;
      }
    }
  }

#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    if (g >= group) break;
    const float den = fmaxf(ls[g], 1e-20f);
    T* orow = o + bb * a.ob + (hk * group + g) * a.oh;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = tid + kThreads * c;
      if (col < d) store(orow + col * a.od, acc[g][c] / den);
    }
  }
}

template <typename T, int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const Args& a, cudaStream_t stream) {
  const int group = a.h / a.n_kv;
  const size_t smem =
      sizeof(float) * (group * DMAX + kTile * (DMAX + 1) + kTile * DMAX +
                       group * kTile + 3 * group);
  auto kern = fd_kernel<T, DMAX>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.n_kv, a.b);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     const Args& a, cudaStream_t stream) {
  if (a.d <= 32) return launch<T, 32>(q, k, v, o, a, stream);
  if (a.d <= 64) return launch<T, 64>(q, k, v, o, a, stream);
  if (a.d <= 128) return launch<T, 128>(q, k, v, o, a, stream);
  return launch<T, 256>(q, k, v, o, a, stream);
}

}  // namespace

// q (B, 1, H, D) and o (B, 1, H, D) with strides for (b, h, d); cache_k and
// cache_v (B, S, Kh, D) with strides for (b, s, kh, d), in elements; dtype
// 0 = float32, 1 = bfloat16.  Returns the CUDA error of the launch.
extern "C" int flash_decode(
    const void* q, const void* k, const void* v, void* o, long long qb,
    long long qh, long long qd, long long kb, long long ks, long long kh,
    long long kd, long long vb, long long vs, long long vh, long long vd,
    long long ob, long long oh, long long od, int b, int h, int n_kv, int d,
    int pos, int window, int dtype, float scale, float softcap,
    void* stream) {
  if (d < 1 || d > 256 || n_kv < 1 || h % n_kv != 0 ||
      h / n_kv > kMaxGroup || pos < 0 || window < 0 || softcap < 0.f)
    return (int)cudaErrorInvalidValue;
  const Args a{qb, qh, qd, kb, ks, kh, kd, vb, vs, vh, vd, ob, oh, od,
               b, h, n_kv, d, pos, window, scale, softcap};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 1 ? dispatch<__nv_bfloat16>(q, k, v, o, a, st)
      : dtype == 0 ? dispatch<float>(q, k, v, o, a, st)
                   : cudaErrorInvalidValue;
  return (int)err;
}
