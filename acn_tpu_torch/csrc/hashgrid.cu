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
// forward `_cell_saved_fwd_impl` / `_hash_encode_cell_impl`
// (acn_tpu/models/encodings.py:314-433) and the table half of the
// hand-written VJP `_saved_bwd` (:444-501). Bound to PyTorch through a plain
// C interface (ctypes) in acn_tpu_torch/ops/hashgrid.py; the x cotangent
// stays PyTorch there.
//
// Bound: bytes, each distinct byte once. The forward reads x01, the distinct
// rows its points fall in, and writes the output; at the smoke's model (8
// levels, F = 4, 833,403 rows of 32 values) and the serving chunk's 983,040
// points that is 0.0726 ms in f32 and 0.0359 ms in bf16 at 3.35 TB/s. The
// cotangent reads x01 and g and writes the tables once (0.0729 / 0.0365
// ms). The operations, a few dozen per (point, level), are far below.
// What held the first version (one thread per (point, level)) back was
// neither: it read its row with 8 * F scalar loads, so each load
// instruction of a warp touched 32 rows, and added with one atomic per
// corner on 32 scattered rows. Rows are gathered at random, so the rows a
// chunk reads (1 GB in f32 at 983,040 points) come from L2, not from
// device memory: L2 and the issue of instructions are what bound this
// design, the cotangent's count of vector reductions at L2 too.
//
// Design. A block takes kPoints points by kLevelGroup levels (kTasks =
// 256 (point, level) tasks). Phase A: one thread a task computes the row
// and the eight weights once and keeps them in shared memory. Phase B: a
// group of G = row bytes / 16 lanes a task (2 for bf16 at F = 2 to 16 for
// f32 at F = 8), lane j taking the row's j-th 16 bytes with one read-only
// load, so a warp's load instruction reads 32 / G whole rows; up to 8
// passes' loads are in flight at once. The group sums its products in f32
// by recursive halving over xor shuffles (F - 1 shuffles, then one per
// remaining lane bit) and each lane ends with one output value to store;
// the tasks of a pass are point-major, so one store instruction writes a
// point's kLevelGroup * F outputs whole (f32 at F = 4: 64 bytes, two full
// sectors; with one level a grid row it wrote half a sector). The grid is
// level-major (blockIdx.y = a group of kLevelGroup levels), so the blocks
// resident at a time gather from kLevelGroup tables, which the 50 MB L2
// holds in bf16 (4 hashed tables: 33.6 MB; in f32 67 MB, of which the
// points' rows are what stays). kLevelGroup = 4 was the fastest forward of
// 1, 2 and 4 in f32 and bf16, on random and on ray-ordered points; the
// cotangent took the same time as with 2 but for random f32 points, 7 %
// slower (PERF.md section 6). To measure another value, edit kLevelGroup
// in a copy of the tree and time it with scripts/bench_hashgrid.py, that
// copy first on PYTHONPATH.
//
// The forward takes this design at F = 2, 4, 8 and 16, where a row's
// 16-byte pieces spread over a power-of-two group of lanes and a corner over
// at most 4 lanes (a row of 2 to 32 pieces in f32, 2 to 16 in bf16); the
// cotangent at F = 1 too. Two other forwards, each chosen among variants of
// itself timed on the card (PERF.md section 6), which showed both bound by
// their instruction count as much as by L2: with no row read at all, each
// took over half of its time.
//
// F = 1 (hash_cell_fwd_one_kernel): a row is 32 bytes in f32, 16 in bf16,
// one or two 16-byte loads, so a task's cost is its cell, its weights and
// its products, not its row, and moving the weights through shared memory
// and a barrier, as the template does, costs more than the gather. One
// thread takes a (point, run of levels), no shared memory, no barrier: it
// reads x01 and its levels' constants together, locates every row of its
// run and starts all their loads before it uses one, weighs them in registers
// and stores its run of outputs (16 bytes where aligned: an out= slice, or
// an odd level count, may not be, and then value by value). f32: two lanes
// of four levels a point, whole rows (two 16-byte loads each); bf16: eight
// lanes of one level, each bf16x2 multiply weighing two corners (a quarter
// of the instructions of converting each product, bit for bit the same). A
// grid row takes 8 levels.
//
// Any other F (a row of 2F pieces in f32, F in bf16, a corner straddling
// pieces), F a runtime argument: hash_cell_fwd_any_kernel. A row's pieces
// are not a power of two and a feature's eight values lie F apart, so the
// products of one feature meet only through shared memory; what must not
// happen is one load in flight at a time, or a block waiting at barriers.
// Each warp works alone on 4 points by 8 levels: one lane a task computes
// the row and weights into shared memory, the warp copies its 32 rows into
// its own stage by cp.async, consecutive lanes on consecutive 16-byte pieces
// (a copy instruction reads 32 / pieces whole rows, all in flight together,
// no registers held), and one lane an output sums the eight corners in
// corner order, so that a store instruction writes the warp's points' 8F
// values contiguous (whole sectors at F = 3 in f32). A staged row takes an
// odd count of 16-byte units (one unit of padding at even counts), which
// halves the bank conflicts of those sums. No block barrier; one round for
// rows of up to 7 units (F = 3 in f32, F ≤ 7 in bf16), rounds of fewer
// tasks for wider rows up to the stage's 4 KB, past that rows read where
// they lie; divisions by F and by the pieces done as multiplications by
// reciprocals made on the host. 8 levels a grid row beat 4 (whole output
// sectors at F = 3, x01 read half as often) though the tables resident
// together double. The general cotangent gives one thread a
// (run of kRun neighbouring points of one level, piece j), computes each of
// the piece's values with its own corner and feature (a bf16x2 pair may span
// two corners) and adds the piece with one vector reduction when its row
// changes.
//
// The per-level constants (scale, resolution, dense flag) and the forward's
// table pointers live in device memory (the wrappers keep them on the card,
// the pointers cached by value), so the level count is bounded by memory
// alone; the cotangent's tables are row blocks of one allocation, given as
// its base and each level's offset. A grid row takes kLevelGroup levels (8
// in the F = 1 and the general forwards), the last one ragged where L is not
// a multiple.
//
// The cotangent's phase B is level-major: a group walks G neighbouring
// points of one level, and lane j adds its 16 bytes of the row with one
// vector reduction (red.v4.f32, or red.v4.bf16x2: 8 bf16 values). A lane
// sums its products in f32 while its points stay in one row (the budget
// march packs samples ray-major, so on coarse levels a ray's samples share
// cells) and adds when the row changes, together with the lanes of its
// slot j in the warp whose runs end in the same row (__match_any_sync,
// asked only when a neighbouring group's run ends in that row: random
// points never pay for it): on coarse levels up to 32 points' adds become
// one. A zero fill of the tables is a first launch of the same call.
//
// Bits. Every step rounds as PyTorch's eager ops round it: each product,
// difference and the Smoothstep terms are taken in f32 and rounded to the
// input's type (bf16 by __float2bfloat16_rn, as PyTorch's bf16 elementwise
// kernels do), with __fmul_rn / __fsub_rn so that nvcc contracts nothing into
// a fused multiply-add. The level's scale is its resolution rounded to x01's
// type on the host (bf16 turns 4095 into 4096). The weight is rounded to
// the table's type, each weight-row product rounded to it, and the eight
// products summed in f32 and rounded once. In the backward the weight is
// rounded to the cotangent's type and each weight-cotangent product rounded;
// a pre-sum of such products runs in f32 and is rounded once before its add;
// a bf16 add rounds its sum to bf16, as the plain index_add_ does. So the
// cell, the row and the weights are the plain version's bits; only the
// order of the sums is free. A (point, level) whose F cotangent values are
// all zero (a pad slot of the packed budget march) adds nothing: an
// accumulator that starts at +0 stays +0 under any number of added zeros,
// so the skip changes no bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kZeroBlocks = 1024;  // grid-stride over the cotangent's tables
constexpr int kLevelGroup = 4;  // levels per grid row
constexpr int kRun = 8;  // the general cotangent's points a thread

enum Interp { kLinear = 0, kSmoothstep = 1, kNearest = 2 };

// Per-level arguments: pointers to arrays of `levels` entries in device
// memory (the kernel's parameters stay a few dozen bytes at any L).
struct Levels {
  const void* const* table;   // forward: the tables
  const float* scale;         // resolution rounded to x01's type
  const int* res;             // resolution (dense index, clip)
  const int* dense;           // 1: dense index, 0: hash
  void* grad;                 // backward: the cotangent tables' one allocation
  const long long* grad_off;  // backward: each level's first value in it
};

// How a row of 8 * F values of type TT spreads over a group of lanes.
template <typename TT, int F> struct Group {
  static constexpr int V = 16 / (int)sizeof(TT);  // values per lane: 4 f32, 8 bf16
  static constexpr int G = 8 * F / V;             // lanes per (point, level)
  static constexpr int CPL = V >= F ? V / F : 1;  // corners per lane
  static constexpr int LPC = F > V ? F / V : 1;   // lanes per corner (f32 F = 8, 16)
  static_assert(G >= 1 && G <= 32 && (G & (G - 1)) == 0, "1 to 32 lanes");
  static_assert(CPL <= 8 && LPC <= 4, "a lane holds whole corners or a quarter");
};

// Lanes j, j + G, j + 2G, ... of a warp.
__host__ __device__ constexpr unsigned same_slot_lanes(int G) {
  unsigned m = 0;
  for (int q = 0; q < 32; q += G) m |= 1u << q;
  return m;
}

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

// The i-th value of a 16-byte load of T, in f32.
template <typename T> __device__ __forceinline__ float lane_value(const uint4& raw, int i);
template <> __device__ __forceinline__ float lane_value<float>(const uint4& raw, int i) {
  const unsigned w = i == 0 ? raw.x : i == 1 ? raw.y : i == 2 ? raw.z : raw.w;
  return __uint_as_float(w);
}
template <> __device__ __forceinline__ float lane_value<__nv_bfloat16>(const uint4& raw, int i) {
  const unsigned w = (i >> 1) == 0 ? raw.x : (i >> 1) == 1 ? raw.y : (i >> 1) == 2 ? raw.z : raw.w;
  return __uint_as_float((i & 1) ? (w & 0xffff0000u) : (w << 16));
}

// Two values as a 32-bit word of bf16.
__device__ __forceinline__ unsigned bf16_word(const float* v) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(v[0]))
         | ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(v[1])) << 16);
}

// A level's constants: its scale (the resolution rounded to x01's type), its
// resolution, its dense flag and its table. The kernels that take several
// levels a thread read them all before they locate any.
struct Level {
  float scale;
  int res, dense;
  const void* table;
};

__device__ __forceinline__ Level level_at(const Levels& lv, int l) {
  const unsigned long long t = __ldg(reinterpret_cast<const unsigned long long*>(lv.table) + l);
  return {__ldg(lv.scale + l), __ldg(lv.res + l), __ldg(lv.dense + l),
          reinterpret_cast<const void*>(t)};
}

// The row of point x at a level and the interpolated fraction f of each
// axis, as `_cell_index` and `_interp_frac` compute them.
template <typename XT>
__device__ __forceinline__ long long locate_at(const float xf[3], const Level& lc, int interp,
                                               uint32_t mask, float f[3]) {
  int c[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float s = rnd<XT>(__fmul_rn(xf[a], lc.scale));
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
  if (lc.dense) {
    const long long r = lc.res;
    long long ci[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) ci[a] = c[a] < 0 ? 0 : (c[a] > r - 1 ? r - 1 : c[a]);
    return (ci[0] * r + ci[1]) * r + ci[2];
  }
  // uint32 wraparound: the low 32 bits of the int64 hash
  return (long long)((((uint32_t)c[0] * 1u) ^ ((uint32_t)c[1] * 2654435761u)
                      ^ ((uint32_t)c[2] * 805459861u)) & mask);
}

// The per-axis corner factors (1 - f, f).
template <typename XT>
__device__ __forceinline__ void factors(const float f[3], float A[3][2]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    A[a][0] = rnd<XT>(__fsub_rn(1.0f, f[a]));
    A[a][1] = f[a];
  }
}

// The row and the per-axis factors (1 - f, f) of point x at level l.
template <typename XT>
__device__ __forceinline__ long long locate(const float xf[3], const Levels& lv, int l,
                                            int interp, uint32_t mask, float A[3][2]) {
  float f[3];
  const long long h = locate_at<XT>(xf, level_at(lv, l), interp, mask, f);
  factors<XT>(f, A);
  return h;
}

// Corner c's weight (A_x[dx] * A_y[dy]) * A_z[dz], each product rounded to
// x01's type: `_corner_weights`' order. c is a lane's own, so the factors
// are picked with selects, not by indexing.
template <typename XT>
__device__ __forceinline__ float corner_weight(const float A[3][2], int c) {
  const float ax = (c & 4) ? A[0][1] : A[0][0];
  const float ay = (c & 2) ? A[1][1] : A[1][0];
  const float az = (c & 1) ? A[2][1] : A[2][0];
  return rnd<XT>(__fmul_rn(rnd<XT>(__fmul_rn(ax, ay)), az));
}

template <typename XT>
__device__ __forceinline__ void load_point(const XT* __restrict__ x, long long p, float xf[3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) xf[a] = to_f(x[3 * p + a]);
}

// A block's tasks: kTasks (point, level)s, kPoints points by kLevelGroup
// levels. Phase A (one thread a task) writes each task's row and its eight
// weights, already rounded to the table's type, to shared memory; phase B
// (a group of lanes a task) reads them.
constexpr int kTasks = kThreads;
constexpr int kPoints = kTasks / kLevelGroup;
static_assert(kPoints % 32 == 0, "a warp's tasks of phase B share a level");

template <typename XT, typename TT>
__device__ __forceinline__ int locate_task(const float xf[3], const Levels& lv, int l,
                                           int interp, uint32_t mask, float* w) {
  float A[3][2];
  const int row = (int)locate<XT>(xf, lv, l, interp, mask, A);
  float wk[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) wk[c] = rnd<TT>(corner_weight<XT>(A, c));
  reinterpret_cast<float4*>(w)[0] = make_float4(wk[0], wk[1], wk[2], wk[3]);
  reinterpret_cast<float4*>(w)[1] = make_float4(wk[4], wk[5], wk[6], wk[7]);
  return row;
}

// The weights of a lane's CPL corners (or of the corner half of which it
// holds) from its task's eight in shared memory.
template <typename TT, int F>
__device__ __forceinline__ void lane_weights(const float* w8, int j, float* w) {
  using Gr = Group<TT, F>;
  if constexpr (Gr::CPL == 8) {
    const float4 a = reinterpret_cast<const float4*>(w8)[0];
    const float4 b = reinterpret_cast<const float4*>(w8)[1];
    w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
    w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
  } else if constexpr (Gr::CPL == 4) {
    const float4 v = reinterpret_cast<const float4*>(w8)[j];
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else if constexpr (Gr::CPL == 2) {
    const float2 v = reinterpret_cast<const float2*>(w8)[j];
    w[0] = v.x; w[1] = v.y;
  } else {
    w[0] = w8[j / Gr::LPC];
  }
}

// Sum v over the lanes of a group that hold the same features (lanes apart
// by O, O / 2, ... down to LO): halve the values a lane holds at each step
// while it holds more than one (send one half, add the partner's other
// half), then add the partner's one value. `feat` ends as the first of the
// lane's features among the M it started with, `writer` true on one lane
// per feature. Every lane of the warp takes every shuffle.
template <int M, int O, int LO, int N>
__device__ __forceinline__ void group_sum(float (&v)[N], int j, int& feat, bool& writer) {
  if constexpr (O >= LO) {
    if constexpr (M > 1) {
      const bool up = (j & O) != 0;
#pragma unroll
      for (int i = 0; i < M / 2; ++i) {
        const float send = up ? v[i] : v[i + M / 2];
        const float keep = up ? v[i + M / 2] : v[i];
        v[i] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, O));
      }
      if (up) feat += M / 2;
      group_sum<M / 2, O / 2, LO>(v, j, feat, writer);
    } else {
      v[0] = __fadd_rn(v[0], __shfl_xor_sync(0xffffffffu, v[0], O));
      if (j & O) writer = false;
      group_sum<1, O / 2, LO>(v, j, feat, writer);
    }
  }
}

// The forward's phase A: task t = (point t / kLevelGroup, level t %
// kLevelGroup) computes its row (or -1: past n, past the levels) and its
// weights; the group's table pointers into shared memory. Ends with a
// barrier.
template <typename XT, typename TT>
__device__ __forceinline__ void fwd_phase_a(const XT* __restrict__ x, const Levels& lv,
                                            int levels, int interp, uint32_t mask, long long n,
                                            int l0, long long p0, float* s_w, int* s_row,
                                            const TT** s_table) {
  const int t = threadIdx.x;
  const long long p = p0 + t / kLevelGroup;
  const int l = l0 + t % kLevelGroup;
  int row = -1;
  if (p < n && l < levels) {
    float xf[3];
    load_point<XT>(x, p, xf);
    row = locate_task<XT, TT>(xf, lv, l, interp, mask, s_w + 8 * t);
  }
  s_row[t] = row;
  if (t < kLevelGroup)
    s_table[t] = static_cast<const TT*>(lv.table[l0 + t < levels ? l0 + t : l0]);
  __syncthreads();
}

template <typename XT, typename TT, int F>
__global__ void __launch_bounds__(kThreads)
hash_cell_fwd_kernel(const XT* __restrict__ x, const Levels lv, int levels,
                     int interp, uint32_t mask, long long n, TT* __restrict__ out) {
  using Gr = Group<TT, F>;
  constexpr int G = Gr::G, V = Gr::V, M = F / Gr::LPC;
  __shared__ __align__(16) float s_w[kTasks * 8];
  __shared__ int s_row[kTasks];
  __shared__ const TT* s_table[kLevelGroup];
  const int l0 = blockIdx.y * kLevelGroup;
  const long long p0 = (long long)blockIdx.x * kPoints;
  fwd_phase_a<XT, TT>(x, lv, levels, interp, mask, n, l0, p0, s_w, s_row, s_table);
  const int lane = threadIdx.x & 31;
  const int j = lane & (G - 1);
  // phase B: G passes of kTasks / G tasks, kBatch passes' loads in flight
  // together; a task without a row (past n, past the levels) reads row 0 of
  // level l0 and stores nothing, so every lane takes every shuffle
  constexpr int kBatch = G < 8 ? G : 8;
#pragma unroll
  for (int q0 = 0; q0 < G; q0 += kBatch) {
    uint4 raw[kBatch];
    int rows[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int t = (q0 + b) * (kTasks / G) + threadIdx.x / G;
      rows[b] = s_row[t];
      const TT* table = s_table[rows[b] >= 0 ? t % kLevelGroup : 0];
      raw[b] = __ldg(reinterpret_cast<const uint4*>(table + (long long)max(rows[b], 0) * (8 * F)) + j);
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int t = (q0 + b) * (kTasks / G) + threadIdx.x / G;
      float w[Gr::CPL];
      lane_weights<TT, F>(s_w + 8 * t, j, w);
      float v[M];
      if constexpr (Gr::LPC == 1) {  // the lane's corners, summed in order
#pragma unroll
        for (int f = 0; f < F; ++f) v[f] = 0.0f;
#pragma unroll
        for (int c = 0; c < Gr::CPL; ++c)
#pragma unroll
          for (int f = 0; f < F; ++f)
            v[f] = __fadd_rn(v[f], rnd<TT>(__fmul_rn(lane_value<TT>(raw[b], c * F + f), w[c])));
      } else {  // half a corner
#pragma unroll
        for (int i = 0; i < V; ++i) v[i] = rnd<TT>(__fmul_rn(lane_value<TT>(raw[b], i), w[0]));
      }
      int feat = 0;
      bool writer = rows[b] >= 0;
      group_sum<M, G / 2, Gr::LPC>(v, j, feat, writer);
      if (writer) {
        const long long p = p0 + t / kLevelGroup;
        const int f = (j & (Gr::LPC - 1)) * V + feat;
        out[p * (long long)(levels * F) + (l0 + t % kLevelGroup) * F + f] = from_f<TT>(v[0]);
      }
    }
  }
}


// Zero the cotangent's tables, one allocation of n16 16-byte pieces (a row
// of 8*F values is a multiple of 16 bytes; the wrapper checks the
// alignment).
__global__ void __launch_bounds__(kThreads) hash_cell_zero_kernel(uint4* t, long long n16) {
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n16;
       i += (long long)gridDim.x * kThreads)
    t[i] = make_uint4(0u, 0u, 0u, 0u);
}

// Add a lane's 16 bytes (4 f32 or 8 bf16, each already rounded to the
// row's type) with one vector reduction; each element is added and rounded
// on its own, as by scalar atomics.
__device__ __forceinline__ void add16(float* dst, const float* v) {
  atomicAdd(reinterpret_cast<float4*>(dst), make_float4(v[0], v[1], v[2], v[3]));
}
__device__ __forceinline__ void add16(__nv_bfloat16* dst, const float* v) {
  asm volatile("red.global.add.noftz.v4.bf16x2 [%0], {%1, %2, %3, %4};"
               :: "l"(dst), "r"(bf16_word(v)), "r"(bf16_word(v + 2)),
                  "r"(bf16_word(v + 4)), "r"(bf16_word(v + 6))
               : "memory");
}

template <typename XT, typename TT, int F>
__global__ void __launch_bounds__(kThreads)
hash_cell_bwd_kernel(const XT* __restrict__ x, const TT* __restrict__ g,
                     const Levels lv, int levels, int interp, uint32_t mask,
                     long long n) {
  using Gr = Group<TT, F>;
  constexpr int G = Gr::G, V = Gr::V;
  __shared__ __align__(16) float s_w[kTasks * 8];
  __shared__ __align__(16) float s_g[kTasks * F];
  __shared__ int s_row[kTasks];
  const int l0 = blockIdx.y * kLevelGroup;
  const long long p0 = (long long)blockIdx.x * kPoints;
  {  // phase A: task t = (level t / kPoints, point t % kPoints), level-major,
     // so that a warp's tasks of phase B are neighbouring points of one level
    const int t = threadIdx.x;
    const long long p = p0 + t % kPoints;
    const int l = l0 + t / kPoints;
    int row = -1;
    if (p < n && l < levels) {
      bool any = false;
#pragma unroll
      for (int f = 0; f < F; ++f) {
        const float gv = to_f(g[p * (long long)(levels * F) + l * F + f]);
        s_g[F * t + f] = gv;
        any |= gv != 0.0f;
      }
      if (any) {  // adds of (signed) zeros change no bit of the sums
        float xf[3];
        load_point<XT>(x, p, xf);
        row = locate_task<XT, TT>(xf, lv, l, interp, mask, s_w + 8 * t);
      }
    }
    s_row[t] = row;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int j = lane & (G - 1);
  const unsigned slot = same_slot_lanes(G) << j;
  // phase B: group i of warp w walks tasks t0 + q, q < G: neighbouring
  // points of one level (a warp's 32 tasks share it). A lane sums its
  // products in f32 while its tasks' row stays the same (a pad task, with
  // no row, does not end the run) and adds the sum when the run ends,
  // together with the lanes of its slot j whose runs end in the same row
  const int t0 = (threadIdx.x >> 5) * 32 + (lane / G) * G;
  TT* const grad = static_cast<TT*>(lv.grad) + lv.grad_off[min(l0 + t0 / kPoints, levels - 1)];
  float acc[V];
  int cur = -1;
#pragma unroll
  for (int q = 0; q <= G; ++q) {
    const int row = q < G ? s_row[t0 + q] : -1;
    float v[V];
    if (row >= 0) {
      const int t = t0 + q;
      float w[Gr::CPL];
      lane_weights<TT, F>(s_w + 8 * t, j, w);
      const float* gt = s_g + F * t;
      if constexpr (Gr::LPC == 1) {
#pragma unroll
        for (int c = 0; c < Gr::CPL; ++c)
#pragma unroll
          for (int f = 0; f < F; ++f) v[c * F + f] = rnd<TT>(__fmul_rn(w[c], gt[f]));
      } else {  // part of a corner: the lane's share of the features
        const int half = (j & (Gr::LPC - 1)) * V;
#pragma unroll
        for (int i = 0; i < V; ++i) v[i] = rnd<TT>(__fmul_rn(w[0], gt[half + i]));
      }
    }
    const bool flush = cur >= 0 && (q == G || (row >= 0 && row != cur));
    const unsigned flushing = __ballot_sync(0xffffffffu, flush);
    // only where a neighbouring group's run ends in the same row is it worth
    // looking for every lane of the slot that does (random points: never)
    bool merge = false;  // a group of 32 lanes has no neighbour in the warp
    if constexpr (G < 32) {
      const int other = __shfl_xor_sync(0xffffffffu, cur, G);
      merge = __any_sync(0xffffffffu, flush && ((flushing >> (lane ^ G)) & 1u) && other == cur);
    }
    if (flush) {
      const unsigned peers =
          merge ? __match_any_sync(flushing, (unsigned)cur) & slot : 1u << lane;
      bool add = true;
      if (peers != (1u << lane)) {  // sum the runs in lane order
        float sum[V];
#pragma unroll
        for (int i = 0; i < V; ++i) sum[i] = 0.0f;
        for (unsigned m = peers; m; m &= m - 1) {
          const int src = __ffs(m) - 1;
#pragma unroll
          for (int i = 0; i < V; ++i) sum[i] = __fadd_rn(sum[i], __shfl_sync(peers, acc[i], src));
        }
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] = sum[i];
        add = lane == __ffs(peers) - 1;
      }
      if (add) {
        float out[V];
#pragma unroll
        for (int i = 0; i < V; ++i) out[i] = rnd<TT>(acc[i]);
        add16(grad + (long long)cur * (8 * F) + j * V, out);
      }
    }
    if (row >= 0) {
      if (row == cur) {
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] = __fadd_rn(acc[i], v[i]);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] = v[i];
        cur = row;
      }
    }
  }
}

// ------------------------------------------------------------------ F = 1

// m values of v (f32, rounded here to TT) to dst, a run of M (2 or 16
// bytes): one 16-byte store where the run is whole and dst 16-byte aligned,
// else value by value (an out= slice at any offset, a point's row of an odd
// level count).
template <typename TT, int M>
__device__ __forceinline__ void store_run(TT* dst, const float* v, int m) {
  if constexpr (M * sizeof(TT) == 16) {
    if (m == M && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
      if constexpr (sizeof(TT) == 4) {
        *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
        *reinterpret_cast<uint4*>(dst) =
            make_uint4(bf16_word(v), bf16_word(v + 2), bf16_word(v + 4), bf16_word(v + 6));
      }
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < M; ++k)
    if (k < m) dst[k] = from_f<TT>(v[k]);
}

// The F = 1 forward's geometry: kLanes lanes a point, kRun levels a lane,
// kLanes * kRun levels a grid row. f32 tables: two lanes of four levels (a
// lane's outputs one 16-byte store; a row is two 16-byte loads); bf16: eight
// lanes of one level (a row is one 16-byte load). Both were the fastest of
// the geometries timed (PERF.md section 6).
template <typename TT> struct One {
  static constexpr bool kF32 = sizeof(TT) == 4;
  static constexpr int kLanes = kF32 ? 2 : 8;       // lanes a point
  static constexpr int kRun = kF32 ? 4 : 1;         // levels a lane
  static constexpr int kLevels = kLanes * kRun;     // levels a grid row
  static constexpr int kPieces = kF32 ? 2 : 1;      // 16-byte loads a row
  static constexpr int kPoints = kThreads / kLanes;  // points a block
};

// One thread a (point, kRun levels): it reads x01 and its levels' constants
// together, locates its rows and starts all their loads before it uses one,
// then weighs them in registers; no shared memory, no barrier. Each lane's
// kRun outputs are contiguous, a point's grid row of outputs is its lanes'
// in order. bf16 rows are weighed two corners a bf16x2 multiply, which
// rounds the exact product of two bf16 values once, as rnd<bf16>(v * w) in
// f32 does, at a quarter of the instructions.
template <typename XT, typename TT>
__global__ void __launch_bounds__(kThreads)
hash_cell_fwd_one_kernel(const XT* __restrict__ x, const Levels lv, int levels, int interp,
                         uint32_t mask, long long n, TT* __restrict__ out) {
  using O = One<TT>;
  constexpr int V = 16 / (int)sizeof(TT);  // values a 16-byte load
  const int j = threadIdx.x % O::kLanes;
  const long long p = (long long)blockIdx.x * O::kPoints + threadIdx.x / O::kLanes;
  const int l0 = blockIdx.y * O::kLevels + O::kRun * j;  // the lane's first level
  const int nl = p < n ? min(O::kRun, levels - l0) : 0;  // levels the lane gathers
  if (nl <= 0) return;
  float xf[3];
  load_point<XT>(x, p, xf);
  Level lc[O::kRun];
#pragma unroll
  for (int i = 0; i < O::kRun; ++i)
    if (i < nl) lc[i] = level_at(lv, l0 + i);
  float fr[O::kRun][3];
  uint4 raw[O::kRun][O::kPieces];
#pragma unroll
  for (int i = 0; i < O::kRun; ++i) {
    if (i < nl) {
      const long long row = locate_at<XT>(xf, lc[i], interp, mask, fr[i]);
      const TT* table = static_cast<const TT*>(lc[i].table);
      const uint4* src = reinterpret_cast<const uint4*>(table + row * 8);
#pragma unroll
      for (int q = 0; q < O::kPieces; ++q) raw[i][q] = __ldg(src + q);
    }
  }
  float o[O::kRun];
#pragma unroll
  for (int i = 0; i < O::kRun; ++i) {
    o[i] = 0.0f;
    if (i < nl) {
      float A[3][2];
      factors<XT>(fr[i], A);
      if constexpr (O::kF32) {
#pragma unroll
        for (int k = 0; k < 8; ++k)
          o[i] = __fadd_rn(o[i], __fmul_rn(lane_value<TT>(raw[i][k / V], k % V),
                                           corner_weight<XT>(A, k)));
      } else {
        const unsigned* vw = reinterpret_cast<const unsigned*>(&raw[i][0]);
#pragma unroll
        for (int q = 0; q < 4; ++q) {  // corners 2q and 2q + 1
          __nv_bfloat162 v2;
          *reinterpret_cast<unsigned*>(&v2) = vw[q];
          const __nv_bfloat162 w2 = __floats2bfloat162_rn(corner_weight<XT>(A, 2 * q),
                                                          corner_weight<XT>(A, 2 * q + 1));
          const __nv_bfloat162 p2 = __hmul2(v2, w2);
          o[i] = __fadd_rn(__fadd_rn(o[i], __low2float(p2)), __high2float(p2));
        }
      }
    }
  }
  store_run<TT, O::kRun>(out + p * levels + l0, o, nl);
}

// ------------------------------------------------------------------ any F

// The general forward's geometry: a warp takes kAnyPoints points by
// kAnyLevels levels (32 tasks, point-major), a grid row kAnyLevels levels;
// a warp stages at most kStagePieces 16-byte pieces of rows at a time.
constexpr int kAnyLevels = 8;
constexpr int kAnyPoints = 32 / kAnyLevels;
constexpr int kWarps = kThreads / 32;
constexpr int kStagePieces = 256;  // 4 KB a warp

// A staged row's 16-byte units: its pieces, one more where they are even, so
// that 8 lanes reading their own rows' unit u hit 8 different 16-byte bank
// groups (phase C's reads of a feature across tasks conflict at most twice).
__host__ __device__ constexpr int stage_stride(int pieces) { return pieces | 1; }

__device__ __forceinline__ void copy16(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;"
               :: "r"((unsigned)__cvta_generic_to_shared(smem)), "l"(gmem) : "memory");
}

// The forward for any F ≥ 3 (a runtime argument), each warp on its own (no
// block barrier). Phase A: lane t of the warp computes its task's row and
// eight weights into shared memory. Then in rounds of `round` tasks (all 32
// where the rows fit in the warp's stage): phase B, the round's rows into the
// stage by asynchronous 16-byte copies (no registers held while they fly),
// piece k of the round (task k / pieces, piece k % pieces) on lane k % 32;
// phase C, output k of the round (task k / F, feature k % F) on lane k % 32,
// the eight products summed in corner order, so that a warp's store covers
// its points' kAnyLevels * F values, contiguous. Rows wider than the stage
// (F > 127 in f32) are read where they lie. The divisions are
// multiplications by host-made reciprocals (f_inv, p_inv: ceil(2^32 / d),
// exact for the warp's counts). The stage is dynamic shared memory,
// `round` rows of stage_stride(pieces) units a warp.
template <typename XT, typename TT>
__global__ void __launch_bounds__(kThreads)
hash_cell_fwd_any_kernel(const XT* __restrict__ x, const Levels lv, int levels, int F,
                         uint32_t f_inv, uint32_t p_inv, int round, int interp, uint32_t mask,
                         long long n, TT* __restrict__ out) {
  __shared__ __align__(16) float s_w[kThreads * 8];
  __shared__ int s_row[kThreads];
  __shared__ const TT* s_table[kWarps][kAnyLevels];
  extern __shared__ uint4 s_stage[];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int l0 = blockIdx.y * kAnyLevels;
  const long long pw = ((long long)blockIdx.x * kWarps + w) * kAnyPoints;  // the warp's first point
  {  // phase A: task `lane` = (point lane / kAnyLevels, level lane % kAnyLevels)
    const long long p = pw + lane / kAnyLevels;
    const int l = l0 + lane % kAnyLevels;
    int row = -1;
    if (p < n && l < levels) {
      float xf[3], f[3], A[3][2];
      load_point<XT>(x, p, xf);
      const Level lc = level_at(lv, l);
      row = (int)locate_at<XT>(xf, lc, interp, mask, f);
      factors<XT>(f, A);
      float wk[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) wk[k] = rnd<TT>(corner_weight<XT>(A, k));
      float4* ws = reinterpret_cast<float4*>(s_w + 8 * threadIdx.x);
      ws[0] = make_float4(wk[0], wk[1], wk[2], wk[3]);
      ws[1] = make_float4(wk[4], wk[5], wk[6], wk[7]);
      if (lane < kAnyLevels) s_table[w][lane] = static_cast<const TT*>(lc.table);
    }
    s_row[threadIdx.x] = row;
  }
  __syncwarp();
  const int row_vals = 8 * F, pieces = F * (int)sizeof(TT) / 2;  // a row's 16-byte pieces
  const int stride = stage_stride(pieces);
  const bool staged = stride <= kStagePieces;
  const int* rows = s_row + 32 * w;
  const float* wts = s_w + 8 * 32 * w;
  uint4* stage = s_stage + (staged ? w * round * stride : 0);
  const long long out_row = (long long)levels * F;
  for (int r0 = 0; r0 < 32; r0 += round) {
    const int nt = min(round, 32 - r0);
    if (staged) {  // phase B
      for (int k = lane; k < nt * pieces; k += 32) {
        const int ti = (int)__umulhi((unsigned)k, p_inv), j = k - ti * pieces;
        const int row = rows[r0 + ti];
        if (row >= 0)
          copy16(stage + ti * stride + j, reinterpret_cast<const uint4*>(
              s_table[w][(r0 + ti) % kAnyLevels] + (long long)row * row_vals) + j);
      }
      asm volatile("cp.async.wait_all;" ::: "memory");
      __syncwarp();
    }
    for (int k = lane; k < nt * F; k += 32) {  // phase C
      const int ti = (int)__umulhi((unsigned)k, f_inv), f = k - ti * F, t = r0 + ti;
      const int row = rows[t];
      if (row < 0) continue;
      const float4 wa = reinterpret_cast<const float4*>(wts + 8 * t)[0];
      const float4 wb = reinterpret_cast<const float4*>(wts + 8 * t)[1];
      const float wk[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
      float v = 0.0f;
      if (staged) {
        const TT* src = reinterpret_cast<const TT*>(stage + ti * stride) + f;
#pragma unroll
        for (int c = 0; c < 8; ++c) v = __fadd_rn(v, rnd<TT>(__fmul_rn(to_f(src[c * F]), wk[c])));
      } else {
        const TT* src = s_table[w][t % kAnyLevels] + (long long)row * row_vals + f;
#pragma unroll
        for (int c = 0; c < 8; ++c)
          v = __fadd_rn(v, rnd<TT>(__fmul_rn(to_f(__ldg(src + c * F)), wk[c])));
      }
      out[(pw + t / kAnyLevels) * out_row + (long long)(l0 + t % kAnyLevels) * F + f] =
          from_f<TT>(v);
    }
    __syncwarp();  // the next round rewrites the stage
  }
}

// The table cotangent for any F. Phase A as the templated kernel's (level-
// major tasks), the cotangents read where they lie. Phase B: one thread a
// (level, run of kRun neighbouring points, 16-byte piece j of the row); the
// piece's V values each take their own corner c and feature f (value e of
// the row: c = e / F, f = e % F, so a bf16x2 pair may span two corners);
// the thread sums them in f32 while the run's row stays the same (a pad
// task does not end it) and adds the piece with one vector reduction when
// it changes.
template <typename XT, typename TT>
__global__ void __launch_bounds__(kThreads)
hash_cell_bwd_any_kernel(const XT* __restrict__ x, const TT* __restrict__ g, const Levels lv,
                         int levels, int F, int interp, uint32_t mask, long long n) {
  constexpr int V = 16 / (int)sizeof(TT);
  __shared__ __align__(16) float s_w[kTasks * 8];
  __shared__ int s_row[kTasks];
  const int l0 = blockIdx.y * kLevelGroup;
  const long long p0 = (long long)blockIdx.x * kPoints;
  const long long gw = (long long)levels * F;  // g's row
  {  // phase A: task t = (level t / kPoints, point t % kPoints)
    const int t = threadIdx.x;
    const long long p = p0 + t % kPoints;
    const int l = l0 + t / kPoints;
    int row = -1;
    if (p < n && l < levels) {
      bool any = false;
      for (int f = 0; f < F && !any; ++f) any = to_f(g[p * gw + l * F + f]) != 0.0f;
      if (any) {  // adds of (signed) zeros change no bit of the sums
        float xf[3];
        load_point<XT>(x, p, xf);
        row = locate_task<XT, TT>(xf, lv, l, interp, mask, s_w + 8 * t);
      }
    }
    s_row[t] = row;
  }
  __syncthreads();
  const int row_vals = 8 * F, pieces = F * (int)sizeof(TT) / 2;
  constexpr int runs = kPoints / kRun;
  for (int it = threadIdx.x; it < kLevelGroup * runs * pieces; it += kThreads) {
    const int run = it / pieces, j = it - run * pieces;
    const int lt = run / runs, r0 = (run - lt * runs) * kRun, l = l0 + lt;
    if (l >= levels) continue;
    TT* const grad = static_cast<TT*>(lv.grad) + lv.grad_off[l];
    float acc[V];
    int cur = -1;
    for (int q = 0; q < kRun; ++q) {
      const int t = lt * kPoints + r0 + q, row = s_row[t];
      if (row < 0) continue;
      const float* w = s_w + 8 * t;
      const TT* gp = g + (p0 + r0 + q) * gw + l * F;
      float v[V];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int e = j * V + i, c = e / F;
        v[i] = rnd<TT>(__fmul_rn(w[c], to_f(gp[e - c * F])));
      }
      if (row == cur) {
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] = __fadd_rn(acc[i], v[i]);
        continue;
      }
      if (cur >= 0) {
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] = rnd<TT>(acc[i]);
        add16(grad + (long long)cur * row_vals + j * V, acc);
      }
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = v[i];
      cur = row;
    }
    if (cur >= 0) {
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = rnd<TT>(acc[i]);
      add16(grad + (long long)cur * row_vals + j * V, acc);
    }
  }
}

// ------------------------------------------------------------------ launch

dim3 task_grid(long long n, int levels) {
  return dim3((unsigned)((n + kPoints - 1) / kPoints),
              (unsigned)((levels + kLevelGroup - 1) / kLevelGroup));
}

template <typename XT, typename TT, int F>
void fwd_one(const XT* x, const Levels& lv, int levels, int interp, uint32_t mask, long long n,
             TT* out, cudaStream_t s) {
  hash_cell_fwd_kernel<XT, TT, F><<<task_grid(n, levels), kThreads, 0, s>>>(
      x, lv, levels, interp, mask, n, out);
}

// ceil(2^32 / d) for d ≥ 2: k * it >> 32 is k / d for every k < 2^32 / d.
uint32_t reciprocal(int d) { return (uint32_t)(((1ull << 32) + (uint64_t)d - 1) / (uint64_t)d); }

template <typename XT, typename TT>
int launch_fwd(const void* x, const Levels& lv, int levels, int features, int interp,
               uint32_t mask, long long n, void* out, cudaStream_t s) {
  const XT* xp = static_cast<const XT*>(x);
  TT* o = static_cast<TT*>(out);
  switch (features) {
    case 1: {
      using O = One<TT>;
      const dim3 grid((unsigned)((n + O::kPoints - 1) / O::kPoints),
                      (unsigned)((levels + O::kLevels - 1) / O::kLevels));
      hash_cell_fwd_one_kernel<XT, TT><<<grid, kThreads, 0, s>>>(xp, lv, levels, interp, mask,
                                                                  n, o);
      break;
    }
    case 2: fwd_one<XT, TT, 2>(xp, lv, levels, interp, mask, n, o, s); break;
    case 4: fwd_one<XT, TT, 4>(xp, lv, levels, interp, mask, n, o, s); break;
    case 8: fwd_one<XT, TT, 8>(xp, lv, levels, interp, mask, n, o, s); break;
    case 16: fwd_one<XT, TT, 16>(xp, lv, levels, interp, mask, n, o, s); break;
    default: {
      constexpr long long kBlockPoints = kWarps * kAnyPoints;
      const long long cols = (n + kBlockPoints - 1) / kBlockPoints;
      if (cols > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
      if (features > 4096) return (int)cudaErrorInvalidValue;  // the reciprocals' range
      const int pieces = features * (int)sizeof(TT) / 2, stride = stage_stride(pieces);
      const int fit = kStagePieces / stride;  // tasks whose rows the stage holds
      const int round = fit < 1 ? 32 : (fit < 32 ? fit : 32);
      const dim3 grid((unsigned)cols, (unsigned)((levels + kAnyLevels - 1) / kAnyLevels));
      const size_t stage = fit < 1 ? 0 : (size_t)kWarps * round * stride * 16;
      hash_cell_fwd_any_kernel<XT, TT><<<grid, kThreads, stage, s>>>(
          xp, lv, levels, features, reciprocal(features), reciprocal(pieces), round, interp,
          mask, n, o);
    }
  }
  return (int)cudaGetLastError();
}

template <typename XT, typename TT, int F>
void bwd_one(const XT* x, const TT* g, const Levels& lv, int levels, int interp, uint32_t mask,
             long long n, cudaStream_t s) {
  hash_cell_bwd_kernel<XT, TT, F><<<task_grid(n, levels), kThreads, 0, s>>>(
      x, g, lv, levels, interp, mask, n);
}

template <typename XT, typename TT>
int launch_bwd(const void* x, const void* g, const Levels& lv, int levels, int features,
               int interp, uint32_t mask, long long n, cudaStream_t s) {
  const XT* xp = static_cast<const XT*>(x);
  const TT* gp = static_cast<const TT*>(g);
  switch (features) {
    case 1: bwd_one<XT, TT, 1>(xp, gp, lv, levels, interp, mask, n, s); break;
    case 2: bwd_one<XT, TT, 2>(xp, gp, lv, levels, interp, mask, n, s); break;
    case 4: bwd_one<XT, TT, 4>(xp, gp, lv, levels, interp, mask, n, s); break;
    case 8: bwd_one<XT, TT, 8>(xp, gp, lv, levels, interp, mask, n, s); break;
    case 16: bwd_one<XT, TT, 16>(xp, gp, lv, levels, interp, mask, n, s); break;
    default:
      hash_cell_bwd_any_kernel<XT, TT><<<task_grid(n, levels), kThreads, 0, s>>>(
          xp, gp, lv, levels, features, interp, mask, n);
  }
  return (int)cudaGetLastError();
}

// The grid's rows of kLevelGroup levels and columns of kPoints points stay
// within CUDA's grid limits.
int check_args(int levels, int features, int log2_size, int interp, long long n) {
  if (levels < 1 || (levels + kLevelGroup - 1) / kLevelGroup > 65535 || features < 1
      || log2_size < 1 || log2_size > 31 || interp < kLinear || interp > kNearest
      || (n + kPoints - 1) / kPoints > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

extern "C" {

// One launch of the forward on `stream`. x: (n, 3) of x_bf16 ? bf16 : f32;
// tables: a device array of `levels` pointers to (rows, 8 * features) of
// t_bf16 ? bf16 : f32, 16-byte aligned, each with at least the rows its
// level indexes; scale, res, dense: device arrays of `levels` entries (the
// resolution rounded to x01's type, the resolution, 1 for a dense level);
// out: (n, levels * features) of the tables' type. Returns the launch's CUDA
// error (0 = ok).
int hash_cell_fwd(const void* x, int x_bf16, const void* tables, int t_bf16,
                  const void* scale, const void* res, const void* dense, int levels,
                  int features, int log2_size, int interp, long long n, void* out,
                  void* stream) {
  if (n <= 0) return 0;
  const int err = check_args(levels, features, log2_size, interp, n);
  if (err) return err;
  const Levels lv = {static_cast<const void* const*>(tables), static_cast<const float*>(scale),
                     static_cast<const int*>(res), static_cast<const int*>(dense), nullptr,
                     nullptr};
  const uint32_t mask = (uint32_t)((1ull << log2_size) - 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    return t_bf16 ? launch_fwd<__nv_bfloat16, __nv_bfloat16>(x, lv, levels, features, interp, mask, n, out, s)
                  : launch_fwd<__nv_bfloat16, float>(x, lv, levels, features, interp, mask, n, out, s);
  }
  return t_bf16 ? launch_fwd<float, __nv_bfloat16>(x, lv, levels, features, interp, mask, n, out, s)
                : launch_fwd<float, float>(x, lv, levels, features, interp, mask, n, out, s);
}

// The table cotangent on `stream`: zero the `total_rows` rows of 8 *
// features values (t_bf16 ? bf16 : f32) at `grads`, one 16-byte aligned
// allocation holding the `levels` tables, level l's first value at
// grad_off[l] (a device array), then add w * g into them. g: (n, levels *
// features) of the tables' type; scale, res, dense as for the forward. Two
// launches; returns the first CUDA error (0 = ok).
int hash_cell_bwd_tables(const void* x, int x_bf16, const void* g, void* grads,
                         const void* grad_off, long long total_rows, int t_bf16,
                         const void* scale, const void* res, const void* dense, int levels,
                         int features, int log2_size, int interp, long long n, void* stream) {
  int err = check_args(levels, features, log2_size, interp, n < 0 ? 0 : n);
  if (err) return err;
  const Levels lv = {nullptr, static_cast<const float*>(scale), static_cast<const int*>(res),
                     static_cast<const int*>(dense), grads,
                     static_cast<const long long*>(grad_off)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n16 = total_rows * 8 * features * (t_bf16 ? 2 : 4) / 16;
  const long long want = (n16 + kThreads - 1) / kThreads;
  if (want > 0) {
    hash_cell_zero_kernel<<<(unsigned)(want < kZeroBlocks ? want : kZeroBlocks), kThreads, 0, s>>>(
        static_cast<uint4*>(grads), n16);
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
