// Compositing over the ray-major packed sample buffer, for sm_90a: the
// transmittance scan, the weights and every per-ray sum in one pass.
//
// For the samples that the budget march packs (occupancy/grid.py
// march_rays_budget: ray r owns slots [ray_start[r], its end) clipped at B,
// the last ray ends at the first slot that is not real), per sample
//   dt    = max(t1 - t0, 0)
//   alpha = 1 - exp(-max(sigma, 0) * dt), 0 below alpha_thre when it is > 0
//   trans = exp(sum over the ray's earlier samples of log(1 - alpha + 1e-10))
//   w     = alpha * trans
// and per ray
//   rgb = sum w * rgb (+ (1 - acc) * bg),  depth = sum w * (t0 + t1) / 2,
//   acc = sum w,  wmax = max(0, max w),
//   went = log(max(acc, 1e-12)) - sum w * log(max(w, 1e-12)) / max(acc, 1e-12).
//
// Replaces no TPU kernel of its own: `composite_packed`
// (acn_tpu/nerfs/render.py:143) is the Pallas scan `_seg_excl_sum_pallas`
// (acn_tpu/ops/segscan.py:180) followed by XLA segment sums. The port ran
// the same composition (csrc/segscan.cu, then `index_add_` with atomics);
// this kernel replaces both on every serving path, where no gradient is
// recorded. Bound to PyTorch through a plain C interface (ctypes) in
// acn_tpu_torch/ops/composite.py.
//
// Bound. Memory: 24 bytes a sample read (sigma, rgb, t0, t1), 8 a ray read
// (ray_start) plus 12 with a background, and 28 a ray written (20 without
// the stats), a handful of flops each. A dense 1080p chunk (B = 983,040,
// N = 30,720) is at most 25 MB, 7.5 us at the H100's 3.35 TB/s; only its
// real samples are read (57 % of the smoke's chunk: 15 MB, 4.5 us).
//
// Design. One warp per ray. The warp starts at ray_start[r], walks the ray's
// samples 32 at a time, scans each step's log-transmittance by shuffles and
// carries the step's total to the next; each lane keeps its own partial
// sums, and a butterfly of shuffles ends the ray. Every sum is taken in one
// fixed order, with no atomics, so two launches on the same inputs give the
// same bits. A slot past the ray's end is never read, so the pad tail of a
// chunk, the part that overflow cut at B and the rays dropped whole cost
// nothing but their ray_start. Only the last ray reads slot_real, to find
// where the real slots end (one byte a slot of that ray). Inputs may be
// strided views (sigma and t0 / t1 any element stride, rgb any row stride
// with unit column stride), read with scalar loads.
//
// Rounding follows the plain version's eager ops: no contraction into fused
// multiply-adds (__fmul_rn / __fadd_rn), accurate expf / logf. The scan adds
// in another order than the plain scan, within the tolerance the tests
// state.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // rays a block: one warp each
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const float* sigma;
  long long s_sigma;
  const float* rgb;
  long long s_rgb;  // row stride; columns are adjacent
  const float* t0;
  long long s_t0;
  const float* t1;
  long long s_t1;
  const long long* ray_start;
  const uint8_t* slot_real;
  const float* bg;  // null: no background
  long long s_bg;
  long long n_rays;
  long long B;
  float alpha_thre;
  int with_stats;
  float* out;  // rgb (N, 3), depth, acc, then wmax, went with the stats
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int d = 16; d > 0; d >>= 1) v = __fadd_rn(v, __shfl_xor_sync(kFull, v, d));
  return v;
}

// The larger of a and b, NaN if either is: as the plain version's
// scatter_reduce_ "amax" keeps a NaN weight (fmaxf would drop it).
__device__ __forceinline__ float nan_max(float a, float b) { return (a > b || a != a) ? a : b; }

// The end of ray r's real slots: the next ray's start clipped at B; for the
// last ray the first slot that is not real (slot_real is a prefix of the
// buffer). A ray that starts at or past B was dropped whole.
__device__ __forceinline__ long long ray_end(const Args& a, long long r, long long start,
                                             int lane) {
  if (start >= a.B) return start;
  if (r + 1 < a.n_rays) return min(a.ray_start[r + 1], a.B);
  for (long long base = start; base < a.B; base += 32) {
    const long long i = base + lane;
    const unsigned pad = __ballot_sync(kFull, i < a.B && !a.slot_real[i]);
    if (pad) return base + __ffs(pad) - 1;
  }
  return a.B;
}

__global__ void __launch_bounds__(kThreads) composite_packed_kernel(const Args a) {
  const int lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= a.n_rays) return;  // the whole warp leaves together
  const long long start = a.ray_start[r];
  const long long end = ray_end(a, r, start, lane);

  float carry = 0.f;  // log-transmittance of the ray's samples before this step
  float s_r = 0.f, s_g = 0.f, s_b = 0.f, s_d = 0.f, s_a = 0.f, s_m = 0.f, s_e = 0.f;
  for (long long base = start; base < end; base += 32) {
    const long long i = base + lane;
    const bool in = i < end;
    float alpha = 0.f, c0 = 0.f, c1 = 0.f, c2 = 0.f, tm = 0.f;
    if (in) {
      const float sg = a.sigma[i * a.s_sigma];
      const float u0 = a.t0[i * a.s_t0], u1 = a.t1[i * a.s_t1];
      const float* c = a.rgb + i * a.s_rgb;
      c0 = c[0];
      c1 = c[1];
      c2 = c[2];
      float dt = __fsub_rn(u1, u0);
      dt = dt < 0.f ? 0.f : dt;
      const float s = sg < 0.f ? 0.f : sg;  // NaN stays NaN, as torch.clamp keeps it
      alpha = __fsub_rn(1.f, expf(-__fmul_rn(s, dt)));
      if (a.alpha_thre > 0.f && !(alpha >= a.alpha_thre)) alpha = 0.f;
      tm = __fmul_rn(0.5f, __fadd_rn(u0, u1));
    }
    const float lt = in ? logf(__fadd_rn(__fsub_rn(1.f, alpha), 1e-10f)) : 0.f;
    float incl = lt;  // inclusive scan of the step, lanes past the end add 0
    for (int d = 1; d < 32; d <<= 1) {
      const float v = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl = __fadd_rn(incl, v);
    }
    float excl = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) excl = 0.f;
    const float trans = expf(__fadd_rn(carry, excl));
    carry = __fadd_rn(carry, __shfl_sync(kFull, incl, 31));
    if (in) {
      const float w = __fmul_rn(alpha, trans);
      s_r = __fadd_rn(s_r, __fmul_rn(w, c0));
      s_g = __fadd_rn(s_g, __fmul_rn(w, c1));
      s_b = __fadd_rn(s_b, __fmul_rn(w, c2));
      s_d = __fadd_rn(s_d, __fmul_rn(w, tm));
      s_a = __fadd_rn(s_a, w);
      s_m = nan_max(s_m, w);
      s_e = __fadd_rn(s_e, __fmul_rn(w, logf(w < 1e-12f ? 1e-12f : w)));
    }
  }
  s_r = warp_sum(s_r);
  s_g = warp_sum(s_g);
  s_b = warp_sum(s_b);
  s_d = warp_sum(s_d);
  s_a = warp_sum(s_a);
  if (a.with_stats) {
    s_e = warp_sum(s_e);
    for (int d = 16; d > 0; d >>= 1) s_m = nan_max(s_m, __shfl_xor_sync(kFull, s_m, d));
  }
  if (lane != 0) return;
  if (a.bg != nullptr) {
    const float k = __fsub_rn(1.f, s_a);
    const float* g = a.bg + r * a.s_bg;
    s_r = __fadd_rn(s_r, __fmul_rn(k, g[0]));
    s_g = __fadd_rn(s_g, __fmul_rn(k, g[1]));
    s_b = __fadd_rn(s_b, __fmul_rn(k, g[2]));
  }
  const long long n = a.n_rays;
  a.out[3 * r] = s_r;
  a.out[3 * r + 1] = s_g;
  a.out[3 * r + 2] = s_b;
  a.out[3 * n + r] = s_d;
  a.out[4 * n + r] = s_a;
  if (a.with_stats) {
    const float ws = s_a < 1e-12f ? 1e-12f : s_a;
    a.out[5 * n + r] = s_m;
    a.out[6 * n + r] = __fsub_rn(logf(ws), __fdiv_rn(s_e, ws));
  }
}

}  // namespace

extern "C" {

// One launch on `stream` over n_rays rays and B packed slots; `out` holds
// 5 * n_rays floats (7 * n_rays with the stats). Strides are in elements.
// Returns the launch's CUDA error (0 = ok).
int composite_packed_f32(const float* sigma, long long s_sigma, const float* rgb,
                         long long s_rgb, const float* t0, long long s_t0, const float* t1,
                         long long s_t1, const long long* ray_start, const uint8_t* slot_real,
                         const float* bg, long long s_bg, long long n_rays, long long B,
                         float alpha_thre, int with_stats, float* out, void* stream) {
  if (n_rays <= 0) return 0;
  const long long blocks = (n_rays + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL || B < 0) return (int)cudaErrorInvalidValue;
  const Args a{sigma,     s_sigma,   rgb,  s_rgb, t0,     s_t0, t1,         s_t1,       ray_start,
               slot_real, bg,        s_bg, n_rays, B, alpha_thre, with_stats, out};
  composite_packed_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
