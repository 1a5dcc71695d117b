// Compositing over the ray-major packed sample buffer, for sm_90a: the
// transmittance scan, the weights and every per-ray sum in one pass
// (forward), and the gradient of the per-ray rgb, depth and acc with respect
// to the densities, the colours and the background in one more (backward).
//
// For the samples that the budget march packs (occupancy/grid.py
// march_rays_budget: ray r owns slots [ray_start[r], its end) clipped at B,
// the last ray ends at the first slot that is not real), per sample
//   dt    = max(t1 - t0, 0),  e = exp(-max(sigma, 0) * dt)
//   alpha = 1 - e, 0 below alpha_thre when it is > 0
//   T     = exp(sum over the ray's earlier samples of log(1 - alpha + 1e-10))
//   w     = alpha * T
// and per ray
//   rgb = sum w * rgb (+ (1 - acc) * bg),  depth = sum w * (t0 + t1) / 2,
//   acc = sum w,  wmax = max(0, max w),
//   went = log(max(acc, 1e-12)) - sum w * log(max(w, 1e-12)) / max(acc, 1e-12).
// The backward takes the cotangents g (rgb, per ray), gd (depth), ga (acc):
//   u_i = g . (c_i - bg) + gd * t_mid_i + ga,   S_i = sum_{k > i in the ray} w_k u_k
//   d rgb_i = w_i * g,   d alpha_i = T_i * u_i - S_i / (1 - alpha_i + 1e-10)
//   d sigma_i = d alpha_i * e_i * dt_i * (1 if sigma > 0, 1/2 if sigma == 0, else 0),
//               0 where alpha was cut and on slots that are not real
//   d bg_r = (1 - acc_r) * g.
//
// Replaces no TPU kernel of its own: `composite_packed`
// (acn_tpu/nerfs/render.py:143) is the Pallas scan `_seg_excl_sum_pallas`
// (acn_tpu/ops/segscan.py:180) followed by XLA segment sums; its gradient
// runs the same Pallas kernel on the reversed cotangent (`_bwd`,
// acn_tpu/ops/segscan.py:251). Bound to PyTorch through a plain C interface
// (ctypes) in acn_tpu_torch/ops/composite.py.
//
// Bound. Memory, a handful of flops a byte. Forward: 24 bytes a real sample
// read (sigma, rgb, t0, t1), 8 a ray (ray_start) plus 12 with a background,
// 28 a ray written (20 without the stats). A dense 1080p chunk (B = 983,040,
// N = 30,720, 57 % of it real) is 15 MB, 4.5 us at 3.35 TB/s. Backward: the
// same 24 bytes a real sample read and 16 written (d sigma, d rgb), 16 a pad
// slot written (zeros) and its real flag read, 32 a ray read (ray_start, the
// cotangents, acc) and 24 more with a background (bg read, d bg written).
//
// Forward design: kLanes = 16 lanes a ray (2 rays a warp), each lane
// kItems = 2 consecutive samples a step, so a step covers kLanes * kItems = 32
// samples of the ray: a dense chunk's rays hold 18 real samples on average
// and at most 32, so most take one step, and a warp walks two rays at once.
// A lane sums its samples' log-transmittance in order, the group scans the
// lanes' sums by shuffles (width kLanes) and carries the step's total to the
// next step; each lane keeps its own partial sums over the ray's steps, and a
// butterfly within the group closes them. The max is PTX max.NaN.f32, which
// keeps a NaN weight as acn_tpu's segment max does. The extents were chosen
// by a one-off sweep (PERF.md, Findings): on an H100 a dense chunk took 0.0155 ms at 16 lanes x 2 samples against 0.0163 at
// 8 x 4 and 0.0188 at 32 x 1, and a flat pass of 4 to 16 rays a warp with
// segmented scans over the warp 0.0215-0.036 ms (a warp a ray: 0.0207).
//
// Backward design: one warp a ray, two walks of 32 slots a step. The first,
// from the ray's start, scans the log-transmittance and keeps T in d sigma's
// own slot; the second, from the ray's end, re-reads the sample, takes T
// back, and sums S by a reverse shuffle scan with the carry from the ray's
// end, as the plain reverse scan sums it (never as a total minus a prefix,
// which cancels where late weights are tiny). Blocks past the rays write the
// zeros of the pad slots. A sample is read twice; the second read finds it
// in L2 at a training episode's size.
//
// Both: every sum in one fixed order, no atomics, so two launches on the
// same inputs give the same bits. A slot past a ray's end (the pad tail, the
// part overflow cut at B, rays dropped whole) is never read; only the
// buffer's last ray reads slot_real, to find where the real slots end.
// Inputs may be strided views (sigma, t0, t1 any element stride; rgb any row
// stride with adjacent columns), read with scalar loads. Rounding follows the
// plain version's eager ops: no contraction into fused multiply-adds
// (__fmul_rn / __fadd_rn), accurate expf / logf; the scans add in another
// order than the plain ones, within the tolerance the tests state.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kItems = 2;   // consecutive samples a lane a step, forward
constexpr int kLanes = 16;  // lanes a ray, forward
constexpr int kWarps = 8;   // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

struct Inputs {
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
};

struct FwdArgs {
  Inputs p;
  float* rgb;    // (N, 3)
  float* depth;  // (N,)
  float* acc;    // (N,)
  float* wmax;   // (N,), null without the stats
  float* went;   // (N,)
};

struct BwdArgs {
  Inputs p;
  const float* acc;  // (N,) the forward's
  const float* g_rgb;  // (N, 3), null: zero
  long long s_g_rgb, s_g_rgb_c;
  const float* g_depth;  // (N,), null: zero
  long long s_g_depth;
  const float* g_acc;  // (N,), null: zero
  long long s_g_acc;
  float* d_sigma;  // (B,)
  float* d_rgb;    // (B, 3)
  float* d_bg;     // (N, 3), null: no background gradient
  long long ray_blocks;
};

// The larger of a and b, NaN if either is (PTX max.NaN, sm_80+): as the
// plain version's scatter_reduce_ "amax" keeps a NaN weight.
__device__ __forceinline__ float nan_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// The end of the buffer's last ray, which starts at `start` (clipped at B):
// the first slot from there that is not real (slot_real is a prefix of the
// buffer), B if there is none. Called by the whole warp.
__device__ __forceinline__ long long real_end(const Inputs& p, long long start, int lane) {
  for (long long base = start; base < p.B; base += 32) {
    const long long i = base + lane;
    const unsigned pad = __ballot_sync(kFull, i < p.B && !p.slot_real[i]);
    if (pad) return base + __ffs(pad) - 1;
  }
  return p.B;
}

// One sample's alpha: dt, e = exp(-max(sigma, 0) dt), alpha = 1 - e, and
// whether alpha_thre cut it to 0. NaN stays NaN, as torch.clamp keeps it.
__device__ __forceinline__ float sample_alpha(const Inputs& p, float sg, float u0, float u1,
                                              float& dt, float& e, bool& cut) {
  dt = __fsub_rn(u1, u0);
  dt = dt < 0.f ? 0.f : dt;
  const float s = sg < 0.f ? 0.f : sg;
  e = expf(-__fmul_rn(s, dt));
  float alpha = __fsub_rn(1.f, e);
  cut = p.alpha_thre > 0.f && !(alpha >= p.alpha_thre);
  return cut ? 0.f : alpha;
}

__device__ __forceinline__ float one_minus_eps(float alpha) {
  return __fadd_rn(__fsub_rn(1.f, alpha), 1e-10f);
}

// Inclusive scan over the lanes of a width-`width` group (the whole warp by
// default): lane l adds lanes l-1, l-2, ... of its group, in a fixed order.
__device__ __forceinline__ float lane_scan_add(float v, int sub, int width = 32) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    if (d >= width) break;
    const float u = __shfl_up_sync(kFull, v, d, width);
    if (sub >= d) v = __fadd_rn(u, v);
  }
  return v;
}

template <bool STATS>
__device__ __forceinline__ void write_ray(const FwdArgs& a, long long r, float sr, float sg,
                                          float sb, float sd, float sa, float se, float sm) {
  const Inputs& p = a.p;
  if (p.bg != nullptr) {
    const float k = __fsub_rn(1.f, sa);
    const float* g = p.bg + r * p.s_bg;
    sr = __fadd_rn(sr, __fmul_rn(k, g[0]));
    sg = __fadd_rn(sg, __fmul_rn(k, g[1]));
    sb = __fadd_rn(sb, __fmul_rn(k, g[2]));
  }
  a.rgb[3 * r] = sr;
  a.rgb[3 * r + 1] = sg;
  a.rgb[3 * r + 2] = sb;
  a.depth[r] = sd;
  a.acc[r] = sa;
  if (STATS) {
    const float ws = sa < 1e-12f ? 1e-12f : sa;
    a.wmax[r] = sm;
    a.went[r] = __fsub_rn(logf(ws), __fdiv_rn(se, ws));
  }
}

// kLanes lanes a ray, each kItems consecutive samples a step, a step
// kLanes * kItems samples of the ray; the group's scan and reductions are
// shuffles within the group (width kLanes).
template <bool STATS>
__global__ void __launch_bounds__(kThreads) composite_fwd_kernel(const FwdArgs a) {
  constexpr int G = kLanes;
  constexpr int kStep = G * kItems;
  constexpr int kPerWarp = 32 / G;
  const Inputs& p = a.p;
  const int lane = threadIdx.x & 31, sub = lane % G;
  const long long r0 = ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * kPerWarp;
  if (r0 >= p.n_rays) return;  // the whole warp leaves together
  const long long r = r0 + lane / G;
  const bool valid = r < p.n_rays;
  const long long start = valid ? min(p.ray_start[r], p.B) : p.B;
  long long end = valid && r + 1 < p.n_rays ? min(p.ray_start[r + 1], p.B) : start;
  const long long last = p.n_rays - 1;
  if (last < r0 + kPerWarp) {  // warp-uniform: this warp holds the last ray
    const long long le = real_end(p, __shfl_sync(kFull, start, (int)(last - r0) * G), lane);
    if (r == last) end = le;
  }
  const unsigned steps =
      __reduce_max_sync(kFull, (unsigned)((end - start + kStep - 1) / kStep));
  const int ss = (int)p.s_sigma, s0 = (int)p.s_t0, s1 = (int)p.s_t1, sc = (int)p.s_rgb;

  float carry = 0.f;  // the ray's log-transmittance before this step
  float s_r = 0.f, s_g = 0.f, s_b = 0.f, s_d = 0.f, s_a = 0.f, s_e = 0.f, s_m = 0.f;
  for (unsigned st = 0; st < steps; ++st) {
    const long long i0 = start + (long long)st * kStep + sub * kItems;
    const int n_in = (int)max(0LL, min((long long)kItems, end - i0));
    const float* sg_p = p.sigma + i0 * p.s_sigma;
    const float* t0_p = p.t0 + i0 * p.s_t0;
    const float* t1_p = p.t1 + i0 * p.s_t1;
    const float* c_p = p.rgb + i0 * p.s_rgb;
    float alpha[kItems], ex[kItems], c0[kItems], c1[kItems], c2[kItems], tm[kItems];
    float run = 0.f;  // the lane's exclusive log-transmittance, in order
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      alpha[k] = c0[k] = c1[k] = c2[k] = tm[k] = 0.f;
      ex[k] = run;
      if (k < n_in) {
        const float u0 = t0_p[k * s0], u1 = t1_p[k * s1];
        float dt, e;
        bool cut;
        alpha[k] = sample_alpha(p, sg_p[k * ss], u0, u1, dt, e, cut);
        run = __fadd_rn(run, logf(one_minus_eps(alpha[k])));
        const float* c = c_p + k * sc;
        c0[k] = c[0];
        c1[k] = c[1];
        c2[k] = c[2];
        tm[k] = __fmul_rn(0.5f, __fadd_rn(u0, u1));
      }
    }
    const float v = lane_scan_add(run, sub, G);  // the group's inclusive scan
    float before = __shfl_up_sync(kFull, v, 1, G);
    before = __fadd_rn(carry, sub == 0 ? 0.f : before);
    carry = __fadd_rn(carry, __shfl_sync(kFull, v, G - 1, G));
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (k < n_in) {
        const float w = __fmul_rn(alpha[k], expf(__fadd_rn(before, ex[k])));
        s_r = __fadd_rn(s_r, __fmul_rn(w, c0[k]));
        s_g = __fadd_rn(s_g, __fmul_rn(w, c1[k]));
        s_b = __fadd_rn(s_b, __fmul_rn(w, c2[k]));
        s_d = __fadd_rn(s_d, __fmul_rn(w, tm[k]));
        s_a = __fadd_rn(s_a, w);
        if (STATS) {
          s_e = __fadd_rn(s_e, __fmul_rn(w, logf(w < 1e-12f ? 1e-12f : w)));
          s_m = nan_max(s_m, w);
        }
      }
    }
  }
#pragma unroll
  for (int d = G / 2; d > 0; d >>= 1) {
    s_r = __fadd_rn(s_r, __shfl_xor_sync(kFull, s_r, d, G));
    s_g = __fadd_rn(s_g, __shfl_xor_sync(kFull, s_g, d, G));
    s_b = __fadd_rn(s_b, __shfl_xor_sync(kFull, s_b, d, G));
    s_d = __fadd_rn(s_d, __shfl_xor_sync(kFull, s_d, d, G));
    s_a = __fadd_rn(s_a, __shfl_xor_sync(kFull, s_a, d, G));
    if (STATS) {
      s_e = __fadd_rn(s_e, __shfl_xor_sync(kFull, s_e, d, G));
      s_m = nan_max(s_m, __shfl_xor_sync(kFull, s_m, d, G));
    }
  }
  if (valid && sub == 0) write_ray<STATS>(a, r, s_r, s_g, s_b, s_d, s_a, s_e, s_m);
}

__device__ __forceinline__ float lane_rscan_add(float v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float u = __shfl_down_sync(kFull, v, d);
    if (lane + d < 32) v = __fadd_rn(v, u);
  }
  return v;
}

__global__ void __launch_bounds__(kThreads) composite_bwd_kernel(const BwdArgs a) {
  const Inputs& p = a.p;
  if ((long long)blockIdx.x >= a.ray_blocks) {  // the pad slots' zeros
    const long long i = ((long long)blockIdx.x - a.ray_blocks) * kThreads + threadIdx.x;
    if (i < p.B && !p.slot_real[i]) {
      a.d_sigma[i] = 0.f;
      a.d_rgb[3 * i] = a.d_rgb[3 * i + 1] = a.d_rgb[3 * i + 2] = 0.f;
    }
    return;
  }
  const int lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= p.n_rays) return;  // the whole warp leaves together
  const long long start = min(p.ray_start[r], p.B);
  const long long end = r + 1 < p.n_rays ? min(p.ray_start[r + 1], p.B) : real_end(p, start, lane);

  float g0 = 0.f, g1 = 0.f, g2 = 0.f;
  if (a.g_rgb != nullptr) {
    const float* g = a.g_rgb + r * a.s_g_rgb;
    g0 = g[0];
    g1 = g[a.s_g_rgb_c];
    g2 = g[2 * a.s_g_rgb_c];
  }
  const float gd = a.g_depth != nullptr ? a.g_depth[r * a.s_g_depth] : 0.f;
  float ga = a.g_acc != nullptr ? a.g_acc[r * a.s_g_acc] : 0.f;
  if (p.bg != nullptr) {  // acc's share of the background term: -g . bg
    const float* b = p.bg + r * p.s_bg;
    ga = __fsub_rn(ga, __fadd_rn(__fadd_rn(__fmul_rn(g0, b[0]), __fmul_rn(g1, b[1])),
                                 __fmul_rn(g2, b[2])));
    if (a.d_bg != nullptr && lane == 0) {
      const float k = __fsub_rn(1.f, a.acc[r]);
      a.d_bg[3 * r] = __fmul_rn(g0, k);
      a.d_bg[3 * r + 1] = __fmul_rn(g1, k);
      a.d_bg[3 * r + 2] = __fmul_rn(g2, k);
    }
  }

  // from the ray's start: T, kept in d_sigma's slot until the second walk
  float carry = 0.f;
  for (long long base = start; base < end; base += 32) {
    const long long i = base + lane;
    float lt = 0.f;
    if (i < end) {
      float dt, ex;
      bool cut;
      lt = logf(one_minus_eps(sample_alpha(p, p.sigma[i * p.s_sigma], p.t0[i * p.s_t0],
                                           p.t1[i * p.s_t1], dt, ex, cut)));
    }
    const float incl = lane_scan_add(lt, lane);
    float excl = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) excl = 0.f;
    if (i < end) a.d_sigma[i] = expf(__fadd_rn(carry, excl));
    carry = __fadd_rn(carry, __shfl_sync(kFull, incl, 31));
  }

  // from the ray's end: S, summed from the end, and the gradients
  float s_carry = 0.f;
  for (long long base = end > start ? start + ((end - 1 - start) / 32) * 32 : start - 1;
       base >= start; base -= 32) {
    const long long i = base + lane;
    const bool in = i < end;
    float dt = 0.f, ex = 0.f, alpha = 0.f, T = 0.f, w = 0.f, u = 0.f, sg = 0.f;
    bool cut = false;
    if (in) {
      sg = p.sigma[i * p.s_sigma];
      const float u0 = p.t0[i * p.s_t0], u1 = p.t1[i * p.s_t1];
      alpha = sample_alpha(p, sg, u0, u1, dt, ex, cut);
      T = a.d_sigma[i];
      w = __fmul_rn(alpha, T);
      const float* c = p.rgb + i * p.s_rgb;
      const float tmid = __fmul_rn(0.5f, __fadd_rn(u0, u1));
      u = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(g0, c[0]), __fmul_rn(g1, c[1])),
                                        __fmul_rn(g2, c[2])),
                              __fmul_rn(gd, tmid)),
                    ga);
    }
    const float incl = lane_rscan_add(__fmul_rn(w, u), lane);
    float S = __shfl_down_sync(kFull, incl, 1);
    if (lane == 31) S = 0.f;
    S = __fadd_rn(s_carry, S);
    s_carry = __fadd_rn(s_carry, __shfl_sync(kFull, incl, 0));
    if (in) {
      const float d_alpha = __fsub_rn(__fmul_rn(T, u), __fdiv_rn(S, one_minus_eps(alpha)));
      // clip_half_ties' share at sigma = 0, none below (NaN: 0, times NaN)
      const float share = sg > 0.f ? 1.f : (sg == 0.f ? 0.5f : 0.f);
      a.d_sigma[i] = cut ? 0.f : __fmul_rn(__fmul_rn(__fmul_rn(d_alpha, ex), dt), share);
      float* d = a.d_rgb + 3 * i;
      d[0] = __fmul_rn(w, g0);
      d[1] = __fmul_rn(w, g1);
      d[2] = __fmul_rn(w, g2);
    }
  }
}

}  // namespace

extern "C" {

// One forward launch on `stream` over n_rays rays and B packed slots. The
// outputs are contiguous; wmax and went null without the stats. Strides are
// in elements. Returns the launch's CUDA error (0 = ok).
int composite_fwd_f32(const float* sigma, long long s_sigma, const float* rgb, long long s_rgb,
                      const float* t0, long long s_t0, const float* t1, long long s_t1,
                      const long long* ray_start, const uint8_t* slot_real, const float* bg,
                      long long s_bg, long long n_rays, long long B, float alpha_thre,
                      float* rgb_out, float* depth, float* acc, float* wmax, float* went,
                      void* stream) {
  if (n_rays <= 0) return 0;
  const long long warps = (n_rays + 32 / kLanes - 1) / (32 / kLanes);
  const long long blocks = (warps + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL || B < 0) return (int)cudaErrorInvalidValue;
  const FwdArgs a{{sigma, s_sigma, rgb, s_rgb, t0, s_t0, t1, s_t1, ray_start, slot_real, bg,
                   s_bg, n_rays, B, alpha_thre},
                  rgb_out, depth, acc, wmax, went};
  const auto st = static_cast<cudaStream_t>(stream);
  if (wmax != nullptr)
    composite_fwd_kernel<true><<<(unsigned)blocks, kThreads, 0, st>>>(a);
  else
    composite_fwd_kernel<false><<<(unsigned)blocks, kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// One backward launch on `stream`: d_sigma (B,) and d_rgb (B, 3) contiguous,
// every slot written; d_bg (N, 3) contiguous or null. A null cotangent is
// zero; g_rgb has a row and a column stride. Returns the CUDA error.
int composite_bwd_f32(const float* sigma, long long s_sigma, const float* rgb, long long s_rgb,
                      const float* t0, long long s_t0, const float* t1, long long s_t1,
                      const long long* ray_start, const uint8_t* slot_real, const float* bg,
                      long long s_bg, long long n_rays, long long B, float alpha_thre,
                      const float* acc, const float* g_rgb, long long s_g_rgb,
                      long long s_g_rgb_c, const float* g_depth, long long s_g_depth,
                      const float* g_acc, long long s_g_acc, float* d_sigma, float* d_rgb,
                      float* d_bg, void* stream) {
  if (n_rays < 0 || B < 0) return (int)cudaErrorInvalidValue;
  const long long ray_blocks = (n_rays + kWarps - 1) / kWarps;
  const long long blocks = ray_blocks + (B + kThreads - 1) / kThreads;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const BwdArgs a{{sigma, s_sigma, rgb, s_rgb, t0, s_t0, t1, s_t1, ray_start, slot_real, bg,
                   s_bg, n_rays, B, alpha_thre},
                  acc, g_rgb, s_g_rgb, s_g_rgb_c, g_depth, s_g_depth, g_acc, s_g_acc,
                  d_sigma, d_rgb, d_bg, ray_blocks};
  composite_bwd_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
