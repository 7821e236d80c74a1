// The vectorized simulator's stage recipe for Hopper (sm_90a), CUDA C++.
//
// Replaces the jitted scans of the JAX package's fleet engine:
// `_step_kernel_impl` (src/repro/sim/engine.py:167, one fleet step) and
// `_run_stages` (:158, one whole run), both a `lax.scan` of `_make_body`
// (:86) under `jax.jit`; there is no `pallas_call`.  Each job carries
// (clock, AR(1) interference) through its stages; a stage reads its noise,
// its gathered Ernest-form table entries, its straggler multiplier, the
// job's burst / preemption / kill-second windows, and writes clock,
// runtime, five metrics, the failure count and the eight windows' kill
// seconds and hits (the output layout of `ops.py`, NO = 24 floats).
//
// Mode 0 (stepped): job j runs `ctrl[j, 5]` stages of the device-resident
// run block at its cursor `ctrl[j, 7]`, the first with the rescale
// overhead `ctrl[j, 6]`; S rows are computed for every job and rows past
// its stages leave the carry alone.  Mode 1 (whole run): every stage of
// `block` with its own z / inject (`ipack`), valid flag and overhead.
// One `__device__` stage function serves both, as `_make_body` does.
//
// Bit parity with the per-job numpy simulator: every product and sum is
// rounded on its own, in the reference's order.  nvcc contracts `a*b + c`
// into an FMA by default, so every product that feeds a sum is
// `__fmul_rn` and every sum `__fadd_rn` / `__fsub_rn`, and both divisions
// are `__fdiv_rn`: the stage function compiles to no FFMA.
//
// What bounds it on the H100: nothing the card computes.  A fleet step
// moves a few kB (J rows of S stages, 11 floats read and 24 written each,
// plus the J x 128 window rows) and does ~200 float operations per stage:
// under a microsecond of bytes at 3.35 TB/s, so the launch itself (a few
// microseconds) is the floor.  One thread per job, the stages walked in
// order with the carry in registers, blocks of 128 jobs; the J of a fleet
// (1-32) fits one block.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kNF = 120;          // packed inputs per stage row
constexpr int kNO = 24;           // packed outputs per stage row
constexpr int kTab = 37;          // scale-outs 0..36
constexpr int kWMax = 128;        // windows per run horizon
constexpr int kFailWindows = 8;   // windows one stage may span
constexpr int kRt = 4, kSq = 4 + kTab, kSlow = 4 + 2 * kTab;
constexpr int kCpu0 = 115, kShuf0 = 116, kIo0 = 117, kStrag = 118, kOv = 119;

struct Consts {
  const float* kill_row;   // (J, W_MAX)
  const float* burst;      // (J, W_MAX)
  const int* preempt;      // (J, W_MAX)
  const float* iscale2;    // (J,)
  const float* mem_tab;    // (37,)
  const float* shuf_tab;   // (37,)
};

__device__ __forceinline__ int clamp_window(int w) {
  return min(max(w, 0), kWMax - 1);
}

// One stage of job j: advances (clock, interf) when `val` and writes the
// stage's NO outputs to `out`.
__device__ void stage(const float* __restrict__ f, int z, int inject,
                      bool val, float ov, int j, const Consts& c,
                      float& clock, float& interf_prev,
                      float* __restrict__ out) {
  const float n0 = f[0], n1 = f[1], n2 = f[2], n3 = f[3];
  const int w0 = static_cast<int>(floorf(__fdiv_rn(clock, 90.0f)));
  const int wi0 = clamp_window(w0);
  const float burst_w = c.burst[j * kWMax + wi0];
  const float innov = __fmul_rn(fabsf(n0), __fmul_rn(c.iscale2[j], burst_w));
  float interf = __fadd_rn(__fmul_rn(interf_prev, 0.85f),
                           __fmul_rn(innov, 0.15f));
  interf = fminf(fmaxf(interf, 0.0f), 0.45f);
  const float loc =
      __fadd_rn(1.0f, fmaxf(__fadd_rn(__fmul_rn(n1, 0.04f), 0.02f), 0.0f));
  const int loss = c.preempt[j * kWMax + wi0];
  const int z_eff = max(z - loss, 1);
  const float base = f[kRt + z_eff], sqb = f[kSq + z_eff];
  const float slow = f[kSlow + z_eff];
  float t = __fadd_rn(__fmul_rn(__fmul_rn(base, __fadd_rn(1.0f, interf)), loc),
                      __fmul_rn(n2, __fmul_rn(sqb, 0.15f)));
  t = fmaxf(t, 0.2f);
  t = __fmul_rn(t, f[kStrag]);
  const float end0 = __fadd_rn(clock, t);
  const bool fail_ok = inject > 0 && z > 4 && val;
  const int w_hi = min(static_cast<int>(floorf(__fdiv_rn(end0, 90.0f))),
                       w0 + kFailWindows - 1);
  const float* kill = c.kill_row + j * kWMax;
  int failed = 0;
#pragma unroll
  for (int k = 0; k < kFailWindows; ++k) {
    const int w = w0 + k;
    const float when = kill[clamp_window(w)];
    const bool hit = fail_ok && w <= w_hi && when >= clock && when < end0;
    if (hit) {
      // degraded scale until restart + retry recompute, on the running t
      const float frac = __fdiv_rn(fminf(t, 25.0f), fmaxf(t, 1e-6f));
      t = __fadd_rn(__fadd_rn(__fmul_rn(t, __fsub_rn(1.0f, frac)),
                              __fmul_rn(__fmul_rn(t, frac), slow)),
                    18.0f);
      ++failed;
    }
    out[8 + k] = when;
    out[8 + kFailWindows + k] = hit ? 1.0f : 0.0f;
  }
  const float runtime = __fadd_rn(t, ov);
  const float mem = c.mem_tab[z_eff];
  float gc = __fadd_rn(__fmul_rn(mem, 0.05f), 0.04f);
  if (failed > 0) gc = __fadd_rn(gc, 0.05f);
  const float spill = __fmul_rn(fmaxf(__fsub_rn(mem, 1.4f), 0.0f), 0.3f);
  float cpu = __fadd_rn(__fmul_rn(f[kCpu0], __fsub_rn(1.0f, interf)),
                        __fmul_rn(n3, 0.02f));
  cpu = fminf(fmaxf(cpu, 0.0f), 1.0f);
  const float shuffle = __fmul_rn(f[kShuf0], c.shuf_tab[z_eff]);
  const float io = failed > 0 ? __fmul_rn(f[kIo0], 1.3f) : f[kIo0];
  out[0] = clock;
  out[1] = runtime;
  out[2] = cpu;
  out[3] = shuffle;
  out[4] = io;
  out[5] = gc;
  out[6] = spill;
  out[7] = static_cast<float>(failed);
  if (val) {
    clock = __fadd_rn(clock, runtime);
    interf_prev = interf;
  }
}

__global__ void __launch_bounds__(kThreads)
sim_stages_kernel(const float* __restrict__ block,
                  const float* __restrict__ ctrl,
                  const float* __restrict__ state0,
                  const int* __restrict__ ipack,
                  const uint8_t* __restrict__ valid, Consts c,
                  float* __restrict__ out, int t_max, int n_jobs, int s_len,
                  int mode) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= n_jobs) return;
  float* outs = out + 2 * n_jobs;
  float clock, interf;
  if (mode == 0) {
    const float* r = ctrl + j * 8;
    clock = r[0];
    interf = r[1];
    const int z = static_cast<int>(r[3]), inject = static_cast<int>(r[4]);
    const int n = static_cast<int>(r[5]), cursor = static_cast<int>(r[7]);
    const float ov0 = r[6];
    for (int s = 0; s < s_len; ++s) {
      const int row = min(max(cursor + s, 0), t_max - 1);
      stage(block + (static_cast<int64_t>(row) * n_jobs + j) * kNF, z, inject,
            s < n, s == 0 ? ov0 : 0.0f, j, c, clock, interf,
            outs + (static_cast<int64_t>(s) * n_jobs + j) * kNO);
    }
  } else {
    clock = state0[2 * j];
    interf = state0[2 * j + 1];
    for (int s = 0; s < s_len; ++s) {
      const int64_t at = static_cast<int64_t>(s) * n_jobs + j;
      const float* f = block + at * kNF;
      stage(f, ipack[2 * at], ipack[2 * at + 1], valid[at] != 0, f[kOv], j, c,
            clock, interf, outs + at * kNO);
    }
  }
  out[2 * j] = clock;
  out[2 * j + 1] = interf;
}

}  // namespace

extern "C" int sim_stages(const float* block, const float* ctrl,
                          const float* state0, const int* ipack,
                          const uint8_t* valid, const float* kill_row,
                          const float* burst, const int* preempt,
                          const float* iscale2, const float* mem_tab,
                          const float* shuf_tab, float* out, int t_max,
                          int n_jobs, int s_len, int mode,
                          cudaStream_t stream) {
  const Consts c{kill_row, burst, preempt, iscale2, mem_tab, shuf_tab};
  const int blocks = (n_jobs + kThreads - 1) / kThreads;
  sim_stages_kernel<<<blocks, kThreads, 0, stream>>>(
      block, ctrl, state0, ipack, valid, c, out, t_max, n_jobs, s_len, mode);
  return static_cast<int>(cudaGetLastError());
}
