// Cell-layout multiresolution hash-grid encode for sm_90a: the forward and
// the table cotangent of its backward.
//
//   forward: out[p, l*F + f] = sum_c w_c(p, l) * T_l[h(p, l), c*F + f]
//   backward: G_l[h(p, l), c*F + f] += w_c(p, l) * g[p, l*F + f]
//
// for every point p and level l, where h is the level's row for the cell
// that holds x01[p] (a dense index of the clipped cell on dense levels, the
// 3-prime XOR hash masked to log2_size bits on the others) and w_c the eight
// trilinear corner weights (corner c = 4*dx + 2*dy + dz) of the intra-cell
// fraction after the interpolation (Linear, Smoothstep or Nearest). One row
// of 8*F values holds a cell's eight corners, so a (point, level) gathers
// one row.
//
// Replaces the cell-layout encode of the JAX package, which wrote no TPU
// kernel for it (a per-lane table gather does not lower to Mosaic): the
// forward `_cell_saved_fwd_impl` / `_hash_encode_cell_impl` and the table
// half of the hand-written VJP `_saved_bwd`
// (acn_tpu/models/encodings.py:314-501). Bound to PyTorch through a plain C
// interface (ctypes) in acn_tpu_torch/ops/hashgrid.py; the x cotangent stays
// PyTorch there.
//
// Bound. Memory: per (point, level) one row of 8*F values is read (forward)
// or added into (backward), against 8 multiplies and adds per feature. The
// smoke's model (8 levels, F = 4, f32) reads 1 KB of rows per point, so the
// serving chunk's 983,040 points need 1.0 GB: 0.31 ms at 3.35 TB/s. Most
// levels' tables are smaller than the 50 MB L2, so the gathers mostly hit
// L2 and the kernel can run under that byte bound.
//
// Design: one thread per (point, level), the grid level-major
// (blockIdx.y = level), so the blocks resident at a time gather from one
// level's table and keep it in L2. The thread recomputes the cell and the
// weights from x01 (no indices or rows are kept between the passes), reads
// its row with scalar loads (neighbouring loads of a thread share a sector,
// so L1 serves all but the first) and writes its F outputs. The backward
// adds with vector atomics (float4 or float2, bf16x2: one per corner for
// F = 4 in f32) into tables zeroed by a first launch of the same call, and
// skips a (point, level) whose F cotangent values are all zero (a pad slot
// of the packed budget march): an accumulator that starts at +0 stays +0
// under any number of added zeros, so skipping changes no bit.
//
// Bits. Every step rounds as PyTorch's eager ops round it: each product,
// difference and the Smoothstep terms are taken in f32 and rounded to the
// input's type (bf16 by __float2bfloat16_rn, as PyTorch's bf16 elementwise
// kernels do), with __fmul_rn / __fsub_rn so that nvcc contracts nothing into
// a fused multiply-add. The level's scale is its resolution rounded to x01's
// type on the host (bf16 turns 4095 into 4096). The weight is rounded to
// the table's type, each weight-row product rounded to it, and the eight
// products summed in f32 and rounded once. In the backward the weight is
// rounded to the cotangent's type and each weight-cotangent product rounded
// before its atomic add; a bf16 atomic add rounds its sum to bf16, as the
// plain index_add_ does. Only the order of the atomic adds is free.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 32;
constexpr int kThreads = 256;
constexpr int kZeroBlocks = 1024;  // per level, grid-stride over its table

enum Interp { kLinear = 0, kSmoothstep = 1, kNearest = 2 };

// Per-level arguments, passed by value in the kernel's parameter space.
struct Levels {
  const void* table[kMaxLevels];  // forward: the tables
  void* grad[kMaxLevels];         // backward: the cotangent tables
  long long rows[kMaxLevels];     // rows of each table
  float scale[kMaxLevels];        // resolution rounded to x01's type
  int res[kMaxLevels];            // resolution (dense index, clip)
  int dense[kMaxLevels];          // 1: dense index, 0: hash
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T, back in f32: what a PyTorch op of type T stores.
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<T>(v));
}

// The row and the eight corner weights of point p at level l, as
// `_cell_index` and `_corner_weights(_interp_frac(.))` compute them.
template <typename XT>
__device__ __forceinline__ long long locate(const XT* __restrict__ x, long long p,
                                            const Levels& lv, int l, int interp,
                                            uint32_t mask, float w[8]) {
  const float scale = lv.scale[l];
  float f[3];
  int c[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float s = rnd<XT>(__fmul_rn(to_f(x[3 * p + a]), scale));
    const float cell = floorf(s);
    float fr = rnd<XT>(__fsub_rn(s, cell));
    if (interp == kSmoothstep) {  // frac * frac * (3 - 2 * frac), op by op
      const float sq = rnd<XT>(__fmul_rn(fr, fr));
      const float tw = rnd<XT>(__fmul_rn(fr, 2.0f));
      fr = rnd<XT>(__fmul_rn(sq, rnd<XT>(__fsub_rn(3.0f, tw))));
    } else if (interp == kNearest) {
      fr = rintf(fr);  // half to even, as torch.round
    }
    f[a] = fr;
    c[a] = (int)cell;
  }
  long long h;
  if (lv.dense[l]) {
    const long long r = lv.res[l];
    long long ci[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) ci[a] = c[a] < 0 ? 0 : (c[a] > r - 1 ? r - 1 : c[a]);
    h = (ci[0] * r + ci[1]) * r + ci[2];
  } else {  // uint32 wraparound: the low 32 bits of the int64 hash
    h = (long long)((((uint32_t)c[0] * 1u) ^ ((uint32_t)c[1] * 2654435761u)
                     ^ ((uint32_t)c[2] * 805459861u)) & mask);
  }
  float A[3][2];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    A[a][0] = rnd<XT>(__fsub_rn(1.0f, f[a]));
    A[a][1] = f[a];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float xy = rnd<XT>(__fmul_rn(A[0][i], A[1][j]));
#pragma unroll
      for (int k = 0; k < 2; ++k) w[4 * i + 2 * j + k] = rnd<XT>(__fmul_rn(xy, A[2][k]));
    }
  return h;
}

template <typename XT, typename TT, int F>
__global__ void __launch_bounds__(kThreads)
hash_cell_fwd_kernel(const XT* __restrict__ x, const Levels lv, int levels,
                     int interp, uint32_t mask, long long n, TT* __restrict__ out) {
  const int l = blockIdx.y;
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= n) return;
  float w[8];
  const long long h = locate<XT>(x, p, lv, l, interp, mask, w);
  const TT* __restrict__ row = static_cast<const TT*>(lv.table[l]) + h * (8 * F);
  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float wk = rnd<TT>(w[k]);
#pragma unroll
    for (int f = 0; f < F; ++f)
      acc[f] = __fadd_rn(acc[f], rnd<TT>(__fmul_rn(to_f(row[k * F + f]), wk)));
  }
  TT* o = out + p * (long long)(levels * F) + l * F;
#pragma unroll
  for (int f = 0; f < F; ++f) o[f] = from_f<TT>(acc[f]);
}

// Zero every level's cotangent table, 16 bytes a store (a row of 8*F values
// is a multiple of 16 bytes; the wrapper checks the alignment).
__global__ void __launch_bounds__(kThreads)
hash_cell_zero_kernel(const Levels lv, int row_bytes) {
  const int l = blockIdx.y;
  const long long n16 = lv.rows[l] * row_bytes / 16;
  uint4* t = static_cast<uint4*>(lv.grad[l]);
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n16;
       i += (long long)gridDim.x * kThreads)
    t[i] = make_uint4(0u, 0u, 0u, 0u);
}

// Add F values (already rounded to the row's type) into a row's corner with
// vector atomics: float4 (F a multiple of 4) or float2 in f32, bf16x2 in
// bf16. Each element is added and rounded on its own, as by scalar atomics.
template <int F> __device__ __forceinline__ void add_corner(float* row, const float* v) {
  if constexpr (F % 4 == 0) {
#pragma unroll
    for (int i = 0; i < F / 4; ++i)
      atomicAdd(reinterpret_cast<float4*>(row) + i,
                make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]));
  } else {
#pragma unroll
    for (int i = 0; i < F / 2; ++i)
      atomicAdd(reinterpret_cast<float2*>(row) + i, make_float2(v[2 * i], v[2 * i + 1]));
  }
}
template <int F> __device__ __forceinline__ void add_corner(__nv_bfloat16* row, const float* v) {
#pragma unroll
  for (int i = 0; i < F / 2; ++i)
    atomicAdd(reinterpret_cast<__nv_bfloat162*>(row) + i,
              __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]));
}

template <typename XT, typename TT, int F>
__global__ void __launch_bounds__(kThreads)
hash_cell_bwd_kernel(const XT* __restrict__ x, const TT* __restrict__ g,
                     const Levels lv, int levels, int interp, uint32_t mask,
                     long long n) {
  const int l = blockIdx.y;
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= n) return;
  const TT* gp = g + p * (long long)(levels * F) + l * F;
  float gv[F];
  bool any = false;
#pragma unroll
  for (int f = 0; f < F; ++f) {
    gv[f] = to_f(gp[f]);
    any |= gv[f] != 0.0f;
  }
  if (!any) return;  // adds of (signed) zeros change no bit of the sums
  float w[8];
  const long long h = locate<XT>(x, p, lv, l, interp, mask, w);
  TT* row = static_cast<TT*>(lv.grad[l]) + h * (8 * F);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float wk = rnd<TT>(w[k]);
    float v[F];
#pragma unroll
    for (int f = 0; f < F; ++f) v[f] = rnd<TT>(__fmul_rn(wk, gv[f]));
    add_corner<F>(row + k * F, v);
  }
}

int fill_levels(Levels* lv, const void* const* ptrs, const long long* rows,
                const float* scale, const int* res, const int* dense, int levels,
                bool grad) {
  if (levels < 1 || levels > kMaxLevels) return (int)cudaErrorInvalidValue;
  for (int l = 0; l < kMaxLevels; ++l) {
    const bool on = l < levels;
    lv->table[l] = on && !grad ? ptrs[l] : nullptr;
    lv->grad[l] = on && grad ? const_cast<void*>(ptrs[l]) : nullptr;
    lv->rows[l] = on ? rows[l] : 0;
    lv->scale[l] = on ? scale[l] : 0.0f;
    lv->res[l] = on ? res[l] : 0;
    lv->dense[l] = on ? dense[l] : 0;
  }
  return 0;
}

dim3 point_grid(long long n, int levels) {
  return dim3((unsigned)((n + kThreads - 1) / kThreads), (unsigned)levels);
}

template <typename XT, typename TT>
int launch_fwd(const void* x, const Levels& lv, int levels, int features, int interp,
               uint32_t mask, long long n, void* out, cudaStream_t s) {
  const dim3 grid = point_grid(n, levels);
  const XT* xt = static_cast<const XT*>(x);
  TT* o = static_cast<TT*>(out);
  switch (features) {
    case 2: hash_cell_fwd_kernel<XT, TT, 2><<<grid, kThreads, 0, s>>>(xt, lv, levels, interp, mask, n, o); break;
    case 4: hash_cell_fwd_kernel<XT, TT, 4><<<grid, kThreads, 0, s>>>(xt, lv, levels, interp, mask, n, o); break;
    case 8: hash_cell_fwd_kernel<XT, TT, 8><<<grid, kThreads, 0, s>>>(xt, lv, levels, interp, mask, n, o); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename XT, typename TT>
int launch_bwd(const void* x, const void* g, const Levels& lv, int levels, int features,
               int interp, uint32_t mask, long long n, cudaStream_t s) {
  const dim3 grid = point_grid(n, levels);
  const XT* xt = static_cast<const XT*>(x);
  const TT* gt = static_cast<const TT*>(g);
  switch (features) {
    case 2: hash_cell_bwd_kernel<XT, TT, 2><<<grid, kThreads, 0, s>>>(xt, gt, lv, levels, interp, mask, n); break;
    case 4: hash_cell_bwd_kernel<XT, TT, 4><<<grid, kThreads, 0, s>>>(xt, gt, lv, levels, interp, mask, n); break;
    case 8: hash_cell_bwd_kernel<XT, TT, 8><<<grid, kThreads, 0, s>>>(xt, gt, lv, levels, interp, mask, n); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int check_args(int levels, int features, int log2_size, int interp, long long n) {
  if (levels < 1 || levels > kMaxLevels || log2_size < 1 || log2_size > 31
      || interp < kLinear || interp > kNearest
      || (features != 2 && features != 4 && features != 8)
      || (n + kThreads - 1) / kThreads > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

extern "C" {

int hash_cell_max_levels() { return kMaxLevels; }

// One launch of the forward on `stream`. x: (n, 3) of x_bf16 ? bf16 : f32;
// tables: `levels` pointers to (rows[l], 8 * features) of t_bf16 ? bf16 :
// f32, each with at least the rows its level indexes; out: (n, levels *
// features) of the tables' type. Returns the launch's CUDA error (0 = ok).
int hash_cell_fwd(const void* x, int x_bf16, const void* const* tables,
                  const long long* rows, int t_bf16, const float* scale,
                  const int* res, const int* dense, int levels, int features,
                  int log2_size, int interp, long long n, void* out, void* stream) {
  if (n <= 0) return 0;
  int err = check_args(levels, features, log2_size, interp, n);
  if (err) return err;
  Levels lv;
  err = fill_levels(&lv, tables, rows, scale, res, dense, levels, false);
  if (err) return err;
  const uint32_t mask = (uint32_t)((1ull << log2_size) - 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    return t_bf16 ? launch_fwd<__nv_bfloat16, __nv_bfloat16>(x, lv, levels, features, interp, mask, n, out, s)
                  : launch_fwd<__nv_bfloat16, float>(x, lv, levels, features, interp, mask, n, out, s);
  }
  return t_bf16 ? launch_fwd<float, __nv_bfloat16>(x, lv, levels, features, interp, mask, n, out, s)
                : launch_fwd<float, float>(x, lv, levels, features, interp, mask, n, out, s);
}

// The table cotangent on `stream`: zero the `levels` tables at `grads`
// (rows[l] x 8 * features of t_bf16 ? bf16 : f32, 16-byte aligned), then add
// w * g into them. g: (n, levels * features) of the tables' type. Two
// launches; returns the first CUDA error (0 = ok).
int hash_cell_bwd_tables(const void* x, int x_bf16, const void* g, void* const* grads,
                         const long long* rows, int t_bf16, const float* scale,
                         const int* res, const int* dense, int levels, int features,
                         int log2_size, int interp, long long n, void* stream) {
  int err = check_args(levels, features, log2_size, interp, n < 0 ? 0 : n);
  if (err) return err;
  Levels lv;
  err = fill_levels(&lv, const_cast<const void* const*>(grads), rows, scale, res,
                    dense, levels, true);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int row_bytes = 8 * features * (t_bf16 ? 2 : 4);
  long long most = 0;
  for (int l = 0; l < levels; ++l) most = rows[l] > most ? rows[l] : most;
  const long long want = (most * row_bytes / 16 + kThreads - 1) / kThreads;
  if (want > 0) {
    const dim3 zgrid((unsigned)(want < kZeroBlocks ? want : kZeroBlocks), (unsigned)levels);
    hash_cell_zero_kernel<<<zgrid, kThreads, 0, s>>>(lv, row_bytes);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  if (n <= 0) return 0;
  const uint32_t mask = (uint32_t)((1ull << log2_size) - 1);
  if (x_bf16) {
    return t_bf16 ? launch_bwd<__nv_bfloat16, __nv_bfloat16>(x, g, lv, levels, features, interp, mask, n, s)
                  : launch_bwd<__nv_bfloat16, float>(x, g, lv, levels, features, interp, mask, n, s);
  }
  return t_bf16 ? launch_bwd<float, __nv_bfloat16>(x, g, lv, levels, features, interp, mask, n, s)
                : launch_bwd<float, float>(x, g, lv, levels, features, interp, mask, n, s);
}

}  // extern "C"
