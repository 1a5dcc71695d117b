// The Instant-NGP expert's network after the hash encode, and the
// container's blend over experts, for sm_90a. Per point p and expert k, from
// the expert's hash features h_k(p) (L*F values) and the view direction d(p):
//
//   t = relu(... relu(h W_0 + b_0) ... )           sigma trunk, sigma_depth layers
//   s = exp(clamp(t w_s + b_s, -88, 88))           sigma head, trunc_exp (f32)
//   g = t W_g + b_g                                geo head, 15 values
//   e = SH(d / |d|) or the frequency encoding      direction encoding
//   c = sigmoid(colour MLP([g, e]))                color_depth ReLU layers + 3
//
// and, by the template's MODE, what the port does with the K experts:
//   kSingle       one expert: [c, s]
//   kSigmaBlend   s_mix = max(sum_k w_k s_k, 1e-12), c_mix = sum_k w_k s_k c_k / s_mix
//   kLinearBlend  sum_k w_k [c_k, s_k]
//   kDensity      s of one expert, or sum_k w_k s_k
//
// Replaces no TPU kernel: the JAX package leaves this to XLA
// (acn_tpu/models/ngp.py:112-156, acn_tpu/models/nn.py:44-85, vmapped in
// acn_tpu/nerfs/render_occ.py:147-168 and acn_tpu/models/container.py:181,221).
// Bound to PyTorch through a plain C interface (ctypes) in
// acn_tpu_torch/ops/ngp_net.py, which holds the plain version.
//
// Bound: operations, on the tensor cores. Every layer product runs as
// "3xTF32" on mma.sync.m16n8k8 (wgmma.m64n64k8 on the wide path; below):
// three TF32 products a multiply-add.
// At the smoke's widths (L*F 32, hidden 64, depth 2, colour 64 deep 2, SH 4
// levels) a (point, expert) pair costs 13,440 multiply-adds (13,824 with the
// tiles' padding), so 3 x 2 x 13,440 flops; at 495 TFLOP/s (dense TF32) a
// serving chunk whose routing needs 2.24 M pairs takes at least 0.36 ms, its
// bytes (each needed feature row once, d, w, 4 outputs) about 0.1 ms at
// 3.35 TB/s.
//
// Design.
// * Points of a block come in slabs of S (at most kSlabMax; shared memory
//   sets it: 640 at the smoke's widths, 1,024 in density; a call of fewer
//   points than S slabs an SM takes slabs of P / SMs, at least kSlabMin, so
//   that every SM has work). For each slab the block encodes
//   each point's direction once into shared memory; then, for each expert in
//   turn, it compacts the slab's points whose routing weight is not 0 into a
//   list (ballots and a prefix count in shared memory) and its warps run
//   16-point tiles of that list, gathering each point's feature row from
//   h[k]. The epilogue adds the expert's share into the point's accumulators
//   in shared memory. A point is in a list at most once and the experts go
//   in order, so no atomics are needed and every sum runs over k in the
//   plain version's order: the outputs are deterministic. Unweighted modes
//   list every point. The grid is one block an SM, each taking every
//   grid-th slab.
// * A warp keeps its tile's activations in registers: a layer's input as
//   the A fragments of m16n8k8, its output as the accumulator fragments. The
//   accumulator puts columns (2t, 2t+1) of an 8-column tile in lane t of a
//   quad, where A wants columns (t, t+4): instead of moving the values,
//   every layer reads its weight rows permuted, k-slot t from row 2t and
//   k-slot t+4 from row 2t+1, so a layer's output fragment is the next
//   layer's input fragment as it stands (no shuffle, no shared memory, no
//   barrier). The hash features are loaded into the same layout.
// * The weights, split once per (slab, expert) and read as the mma's want
//   them: for each (input tile of 8, output tile of 8, lane) one 16-byte
//   {b0 big, b1 big, b0 small, b1 small}, so that the products' inner loop
//   is one shared-memory read and three mma's (splitting f32 weights at
//   each use made the integer pipe the limit). The split image (112 KB at
//   the smoke's widths) has no room for a second one beside a slab, so the
//   next expert's f32 layers land by cp.async in a landing buffer (62 KB)
//   while the current expert computes, and all threads split them into the
//   image after the barrier that ends it. An expert that stays (one-expert
//   modes) is neither landed nor split again. When an expert does not fit
//   beside a slab (widths 96-128 at depth 4: up to 470 KB an expert), its
//   layers land and split one at a time, all warps taking one tile each per
//   pass.
// * The three products of a multiply-add chain through one accumulator and
//   a warp issues in order: for each input tile the mma's go one product at
//   a time across up to 4 output tiles (asm volatile keeps that order), so
//   that no mma waits on the one before it. They sum into a partial from 0,
//   added to the layer's sum with one rounded add (the mma's own
//   accumulation does not round to nearest).
// * The sigma and geo heads are one layer of 16 columns (sigma in column 0).
//   Its output fragments are the colour MLP's first two input tiles: the
//   colour layer 0 is staged with a zero row in front of its own rows, and
//   the sigma column is set to 0 after it is read. The direction encoding
//   follows from column 16, padded with zeros to the tile. The last colour
//   layer is 8 columns wide (3 used). Zero rows and columns add exact zeros.
// * Two classes of width, templated: up to 64 (16 warps a block, at most
//   128 registers a thread) and up to 128 (8 warps), chosen by every width
//   the network carries (hidden, color_hidden, L*F and the colour input,
//   1 + 15 + the direction encoding). A hidden layer is computed at its
//   class's width (zero columns past its own), its input at its own.
// * Anything wider takes the wide path, two launches a chunk (mode a
//   runtime argument): a warp cannot carry 16 points x W columns in
//   registers there, nor a block a layer's split image in shared memory (at
//   width 256, 512 KB). The slabs, the point lists, the direction encodings
//   and the accumulators are the classes'. What bounds it is the tensor
//   cores (3xTF32 at the wide expert of chip_smoke.py, trunk 256 x 8, colour
//   128 x 5: 541,696 multiply-adds a pair, a dense chunk of random points,
//   1.02 M pairs, at least 6.7 ms) and the weights' path into shared memory;
//   its design:
//   - The split launch (ngp_net_split_kernel) writes every expert's layers
//     once a call into a device buffer of TF32 big and small parts, in the
//     layout wgmma reads (wide_index), with the classes' row permutation;
//     nothing is kept across calls, so an in-place weight update is seen.
//   - The network launch: one block an SM, two warpgroups, each a 64-point
//     tile of the list (a pass: two tiles). Thread 0 streams the expert's
//     split layers into a ring of kWideStages 16 KB stages by
//     cp.async.bulk under mbarriers (full: landed; empty: read by all eight
//     warps), kWideStages - 1 ahead of the stage it reads, one stage a k-step
//     of 8 input rows by up to 256 output columns; both tiles read each
//     stage, so the weights cross from L2 once every 128 points. A
//     producer warp of its own was tried first: the compiler gives a block
//     of 288 threads a warpgroup's registers for the 32 (168 a thread,
//     spilling the sums), and the kernel ran slower than the mma.sync path
//     it replaces (PERF.md).
//   - The products are wgmma.m64n64k8 in TF32, A (the activations) from
//     registers, B from the stage: each k-step a warpgroup splits its A
//     fragment into big and small parts and, for each 64-column block, runs
//     small.big, big.small and big.big into a partial from 0 (scale-d 0),
//     added with one rounded add: each input tile's partial, as in the
//     classes, so a layer's outputs are theirs to the mma's rounding. Two
//     partials alternate, so that a block's add runs while the next block's
//     products do. A warpgroup keeps up to 256 columns (4 blocks, 128
//     registers a thread) of a layer's sum in registers.
//   - The slab keeps only the accumulators and the list (18 bytes a point),
//     so slabs are large and the lists fill their passes; a tile's
//     direction encodings are computed at its heads layer into 64 rows of
//     shared memory a warpgroup.
//   - A tile's activations stay in shared memory (64 KB at width 256), in
//     the fragment layout: each thread reads back only what it wrote, so a
//     layer's outputs overwrite its inputs after the thread's last product
//     (no barrier, one buffer). A network whose layers are wider than 256
//     (more rounds of columns than registers hold) or whose buffers leave
//     no room for a slab of kWideSlabMin keeps them in a scratch buffer of
//     the block's in device memory instead, two per tile (a round's outputs
//     must not overwrite what the next round reads): shared memory cannot
//     hold them.
// * The expert and layer tables are in device memory: the layer weights'
//   pointers an array of K x slots (w, b) pairs that the wrapper keeps on
//   the card (a block copies the row of the expert it stages next into
//   shared memory, all slots at once, before the barrier that precedes the
//   staging), the layers' staged shapes computed by each block into shared
//   memory, the K feature sets one buffer at a stride. K and the depth are
//   bounded by memory alone.
//
// Bits. A product a*b is summed as a_small*b_big + a_big*b_small +
// a_big*b_big in the f32 accumulators, with big = cvt.rna.tf32.f32(x) and
// small = cvt.rna.tf32.f32(x - big) (small*small dropped), for the weights
// and the activations alike: within ~1e-7 of an f32 product's sum
// (tests/test_torch_ngp_net.py emulates it). The bias is added after the
// sum, as (x @ w) + b adds it. ReLU, trunc_exp at +-88, the sigmoid, the
// direction's normalisation and its encoding round every step as PyTorch's
// eager ops do (__fmul_rn / __fadd_rn / __fdiv_rn, no contraction),
// normalising twice on the SH path as enc_dir and sh_encode do; the blends
// take w * s and (w * s) * c as two rounded products, as the plain version
// does.

#include <cuda_runtime.h>
#include <stdint.h>

#include <vector>

namespace {

constexpr int kGeo = 15;
constexpr int kMaxShLevels = 5;  // spherical harmonics levels sh_encode takes
constexpr int kClassWidth = 128;  // the widest class; wider networks take the wide path
constexpr int kSlabMax = 1024;  // points a slab, at most (the list indices are 16-bit)
constexpr int kSlabMin = 256;   // one 16-point tile a warp of a 16-warp block
// the wide path
constexpr int kWideWGs = 2;     // consumer warpgroups a block, a 64-point tile each
constexpr int kWideThreads = kWideWGs * 128;
constexpr int kRoundBlocks = 4;  // 64-column blocks a warpgroup sums in registers (256 columns)
constexpr int kBlockFloats = 512;  // one TF32 part of a block's k-step of 8: 64 columns x 8 rows
constexpr int kStageFloats = kRoundBlocks * 2 * kBlockFloats;  // a stage: 16 KB
constexpr int kWideStages = 3;   // stages of the ring (4: +3 %, 5: +43 % on an H100)
constexpr int kWideSlabMax = 4096;  // points a slab, at most
constexpr int kWideSlabMin = 128;   // a pass: one tile a warpgroup

enum Mode { kSingle = 0, kSigmaBlend = 1, kLinearBlend = 2, kDensity = 3 };

// warps a block (above 64 wide, a thread's activations and accumulators
// take twice the registers; 0: the wide path)
__host__ __device__ constexpr int threads_for(int W) {
  return W == 0 ? kWideThreads : W > 64 ? 8 * 32 : 16 * 32;
}

__host__ __device__ constexpr int tiles8(int n) { return (n + 7) / 8; }

struct Layer {
  const float* w;  // (in, out) row-major, as the port stores it
  const float* b;  // (out,)
};

// A layer: kt input tiles of 8 rows, nt output tiles of 8 columns. As it
// lands (f32, row-major): rows ds floats apart, the bias (8 nt floats) after
// the 8 kt rows, at off in an expert's landed image. As the mma's read it:
// for each (input tile, output tile, lane) the lane's B fragment split into
// TF32 parts, {b0 big, b1 big, b0 small, b1 small}, then the bias, at foff
// in the expert's split image.
struct Shape {
  int kt, nt, ds, off, foff;
};

// The floats that nl shapes take at the front of shared memory (16-byte
// multiples, so that what follows stays aligned for float4).
__host__ __device__ constexpr int shape_floats(int nl) { return (5 * nl + 3) / 4 * 4; }

// Passed by value in the kernel's parameter space, read in place
// (__grid_constant__). The tables it points to are in device memory.
struct Net {
  const float* h;       // (K, P, in_dim): expert k's features at h + k * h_stride
  const Layer* layers;  // K x nslots (w, b) pairs: trunk, sigma, geo, colour (+ last)
  const float* dirs;    // (P, >= 3) rows dir_stride apart
  const float* w;       // (P, K) routing weights, or null
  float* rgb;           // rows rgb_stride apart, or null
  float* sigma;         // rows sigma_stride apart
  const float* wsplit;  // wide path: the experts' split weights, wexpert floats each
  float* scratch;       // wide path, spilled activations: scratch_block floats a block
  long long P, h_stride, dir_stride, rgb_stride, sigma_stride, slabs, scratch_block, wexpert;
  int mode, K, in_dim, hidden, sigma_depth, color_hidden, color_depth;
  int dir_kind, dir_param, sigmoid, enc_dim;
  int W;               // width class: 64, 128, or 0 (the wide path)
  int nl, nslots;      // layers an expert (density: the trunk and the heads); weight slots
  int streamed;        // 0: whole experts; 1: one layer at a time
  int land, split;     // floats of the landing and split buffers
  int S, ES;           // points a slab; floats a point's encoding row (even)
  int KW;              // wide path: 8-column tiles of an activation row (the widest layer)
  int onchip;          // wide path: 1, activations in shared memory; 0, spilled
  int ring_off, act_off, enc_off;  // wide path: floats into shared memory
};

__host__ __device__ inline void add_shape(Shape* s, int& n, int& limage, int& fimage, int in,
                                          int nt) {
  Shape& x = s[n++];
  x.kt = tiles8(in);
  x.nt = nt;
  x.ds = 8 * nt + 4;
  x.off = limage;
  x.foff = fimage;
  limage += 8 * x.kt * x.ds + 8 * nt;
  fimage += 128 * x.kt * nt + 8 * nt;
}

// An expert's layers as staged: the trunk, the heads (16 columns: sigma,
// geo), the colour MLP and its last layer (8 columns, 3 used); density: the
// trunk and the heads. Hidden layers are as wide as the class W (zero
// columns past their width), or their own width on the wide path (W = 0).
// Writes net.nl shapes.
__host__ __device__ inline void layer_shapes(const Net& net, Shape* s) {
  int n = 0, limage = 0, fimage = 0;
  const int hid = net.W ? net.W / 8 : tiles8(net.hidden);
  const int col = net.W ? net.W / 8 : tiles8(net.color_hidden);
  for (int l = 0; l < net.sigma_depth; ++l)
    add_shape(s, n, limage, fimage, l == 0 ? net.in_dim : net.hidden, hid);
  add_shape(s, n, limage, fimage, net.hidden, tiles8(1 + kGeo));
  if (net.mode != kDensity) {
    add_shape(s, n, limage, fimage, 1 + kGeo + net.enc_dim, col);
    for (int c = 1; c < net.color_depth; ++c) add_shape(s, n, limage, fimage, net.color_hidden, col);
    add_shape(s, n, limage, fimage, net.color_hidden, 1);
  }
}

// ------------------------------------------------------------------ PTX

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

// 4 bytes, or a zero when n is 0 (src is then not read)
__device__ __forceinline__ void cp4(float* dst, const float* src, int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(n));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

__device__ __forceinline__ unsigned tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small, each a TF32 value
__device__ __forceinline__ void split(float x, unsigned& big, unsigned& small) {
  big = tf32(x);
  small = tf32(__fsub_rn(x, __uint_as_float(big)));
}

// volatile: the mma's issue in the order written (see dense)
__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                    unsigned b1) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ------------------------------------------------------------------ staging

// A source of a staged layer: rows [row0, row0 + rows) and columns
// [col0, col0 + cols) of the staged matrix come from w (rows x cols), the
// bias columns from b.
struct Part {
  const float* w;
  const float* b;
  int rows, cols, row0, col0;
};

// Expert k's weight slots (its trunk layers, sigma, geo, its colour layers)
// into the block's table in shared memory, all slots' loads at once: the
// staging that follows (after a barrier) reads its pointers from there.
__device__ __forceinline__ void load_table(const Net& net, int k, Layer* tab) {
  const ulonglong2* src = reinterpret_cast<const ulonglong2*>(net.layers) + (long long)k * net.nslots;
  for (int i = threadIdx.x; i < net.nslots; i += blockDim.x) {
    const ulonglong2 v = __ldg(src + i);
    tab[i] = {reinterpret_cast<const float*>(v.x), reinterpret_cast<const float*>(v.y)};
  }
}

// Layer l's sources, from the expert's table: one part, or two for the heads
// (b.cols = 0 where none).
__device__ __forceinline__ void parts_of(const Net& net, const Layer* tab, int l, Part& a,
                                         Part& b) {
  const int sd = net.sigma_depth, cd = net.color_depth;
  b = {nullptr, nullptr, 0, 0, 0, 0};
  if (l < sd) {
    a = {tab[l].w, tab[l].b, l == 0 ? net.in_dim : net.hidden, net.hidden, 0, 0};
  } else if (l == sd) {  // [sigma | geo]
    a = {tab[sd].w, tab[sd].b, net.hidden, 1, 0, 0};
    b = {tab[sd + 1].w, tab[sd + 1].b, net.hidden, kGeo, 0, 1};
  } else if (l == sd + 1) {  // behind a zero row: the heads' sigma column
    a = {tab[sd + 2].w, tab[sd + 2].b, kGeo + net.enc_dim, net.color_hidden, 1, 0};
  } else {
    const int c = l - sd - 1;
    a = {tab[sd + 2 + c].w, tab[sd + 2 + c].b, net.color_hidden, c < cd ? net.color_hidden : 3,
         0, 0};
  }
}

// the source of element (i, j) of a staged layer, or null (a zero)
__device__ __forceinline__ const float* source(const Part& p, int i, int j) {
  const int r = i - p.row0, c = j - p.col0;
  return r >= 0 && r < p.rows && c >= 0 && c < p.cols ? p.w + (long long)r * p.cols + c : nullptr;
}

// Issue the cp.asyncs of rows [ro, ro + 8 kt) and columns [co, co + 8 nt)
// of a layer (parts a, b; kt, nt, ds from s) into dst, weights then bias,
// every padded element included: zeros where no part covers it. Arguments
// by value: nothing in the loop is read through a pointer that a store
// could alias.
__device__ __noinline__ void stage_layer(float* dst, const Part a, const Part b, const Shape s,
                                         int ro, int co) {
  const int lq = __ffs(2 * s.nt) - 1, n = 8 * s.kt << lq;  // 2 nt quads a row (nt: a power of 2)
  for (int q = threadIdx.x; q < n; q += blockDim.x) {
    const int i = q >> lq, j = 4 * (q - (i << lq)), gi = ro + i, gj = co + j;
    float* d = dst + i * s.ds + j;
    const int r = gi - a.row0;
    if (b.cols == 0 && r >= 0 && r < a.rows && gj + 4 <= a.cols) {
      const float* src = a.w + (long long)r * a.cols + gj;
      if ((reinterpret_cast<unsigned long long>(src) & 15) == 0) {
        cp16(d, src);
        continue;
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float* src = source(a, gi, gj + u);
      if (src == nullptr && b.cols) src = source(b, gi, gj + u);
      cp4(d + u, src ? src : a.w, src ? 4 : 0);
    }
  }
  float* bias = dst + 8 * s.kt * s.ds;
  for (int j = threadIdx.x; j < 8 * s.nt; j += blockDim.x) {
    const int gj = co + j;
    const float* src = gj < a.col0 + a.cols ? a.b + (gj - a.col0)
                       : b.cols && gj >= b.col0 && gj < b.col0 + b.cols ? b.b + (gj - b.col0)
                                                                      : nullptr;
    cp4(bias + j, src ? src : a.b, src ? 4 : 0);
  }
}

__device__ __forceinline__ void stage(float* dst, const Net& net, const Layer* tab, int l,
                                      const Shape* shp) {
  Part a, b;
  parts_of(net, tab, l, a, b);
  stage_layer(dst, a, b, shp[l], 0, 0);
}

__device__ __forceinline__ void stage_expert(float* dst, const Net& net, const Layer* tab,
                                             const Shape* shp) {
  for (int l = 0; l < net.nl; ++l) stage(dst + shp[l].off, net, tab, l, shp);
}

// A landed layer into its split B fragments (every thread of the block):
// lane (g, t) of the mma reads k-slot t from row 2t and k-slot t + 4 from
// row 2t + 1 of the input tile, column g of the output tile.
__device__ __noinline__ void split_layer(float* dst, const float* src, const Shape s) {
  const int n = s.kt * s.nt * 32, ln = __ffs(s.nt) - 1;  // nt: a power of 2
#pragma unroll 4
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int lane = i & 31, tile = i >> 5, kt = tile >> ln, nt = tile - (kt << ln);
    const float* r = src + (kt * 8 + 2 * (lane & 3)) * s.ds + nt * 8 + (lane >> 2);
    unsigned b0, s0, b1, s1;
    split(r[0], b0, s0);
    split(r[s.ds], b1, s1);
    reinterpret_cast<uint4*>(dst)[i] = make_uint4(b0, b1, s0, s1);
  }
  for (int j = threadIdx.x; j < 8 * s.nt; j += blockDim.x) dst[4 * n + j] = src[8 * s.kt * s.ds + j];
}

__device__ __forceinline__ void split_expert(float* dst, const float* src, const Net& net,
                                             const Shape* shp) {
  for (int l = 0; l < net.nl; ++l) split_layer(dst + shp[l].foff, src + shp[l].off, shp[l]);
}

// ------------------------------------------------------------------ layers

// c[0, NT) = a @ W + b on one tile of 16 points: a, the input's kt_n tiles
// as A fragments (column 2t of an input tile in k-slot t, 2t + 1 in slot
// t + 4, rows g and g + 8); c, NT output tiles as accumulator fragments. w:
// the layer's split B fragments, then its bias. NT is fixed at compile time
// and kt_n tested once an input tile, so the products of an input tile form
// one block of independent mma's.
template <int NT, int KA, int NC>
__device__ __forceinline__ void dense(const float (&a)[KA][4], float (&c)[NC][4], const float* w,
                                      int kt_n) {
  const int lane = threadIdx.x & 31, t = lane & 3;
  const uint4* b = reinterpret_cast<const uint4*>(w) + lane;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[nt][i] = 0.f;
#pragma unroll
  for (int kt = 0; kt < KA; ++kt) {
    if (kt < kt_n) {
      unsigned ab[4], as[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split(a[kt][i], ab[i], as[i]);
      // up to 4 output tiles at a time: their B fragments, then each of the
      // three products across the tiles, so that an mma never waits on the
      // one issued just before it (they chain through an accumulator; the
      // warp issues in order). The 24 products of an input tile sum into a
      // partial from 0, added to the layer's sum with one rounded add: the
      // long sum does not pass through the mma's own accumulation, whose
      // rounding, repeated three times an input tile at the sum's magnitude,
      // put sigma 2e-6 off f32 at large activations.
      constexpr int G = NT < 4 ? NT : 4;
#pragma unroll
      for (int n0 = 0; n0 < NT; n0 += G) {
        uint4 f[G];  // b0, b1 big; b0, b1 small
        float d[G][4];
#pragma unroll
        for (int j = 0; j < G; ++j) {
          f[j] = b[(kt * NT + n0 + j) * 32];
#pragma unroll
          for (int i = 0; i < 4; ++i) d[j][i] = 0.f;
        }
#pragma unroll
        for (int j = 0; j < G; ++j) mma(d[j], as, f[j].x, f[j].y);
#pragma unroll
        for (int j = 0; j < G; ++j) mma(d[j], ab, f[j].z, f[j].w);
#pragma unroll
        for (int j = 0; j < G; ++j) mma(d[j], ab, f[j].x, f[j].y);
#pragma unroll
        for (int j = 0; j < G; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) c[n0 + j][i] = __fadd_rn(c[n0 + j][i], d[j][i]);
      }
    }
  }
  const float* bias = w + 128 * kt_n * NT + 2 * t;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const float2 bv = *reinterpret_cast<const float2*>(bias + nt * 8);
    c[nt][0] = __fadd_rn(c[nt][0], bv.x);
    c[nt][1] = __fadd_rn(c[nt][1], bv.y);
    c[nt][2] = __fadd_rn(c[nt][2], bv.x);
    c[nt][3] = __fadd_rn(c[nt][3], bv.y);
  }
}

// the output tiles [0, N) as the next layer's input, through ReLU or not
template <int N, int KA, int NC>
__device__ __forceinline__ void feed(const float (&c)[NC][4], float (&a)[KA][4], bool relu) {
#pragma unroll
  for (int kt = 0; kt < N; ++kt) {
    a[kt][0] = relu ? fmaxf(c[kt][0], 0.f) : c[kt][0];
    a[kt][1] = relu ? fmaxf(c[kt][2], 0.f) : c[kt][2];
    a[kt][2] = relu ? fmaxf(c[kt][1], 0.f) : c[kt][1];
    a[kt][3] = relu ? fmaxf(c[kt][3], 0.f) : c[kt][3];
  }
}

// ------------------------------------------------------------------ direction

__device__ __forceinline__ float rn_mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float rn_sub(float a, float b) { return __fsub_rn(a, b); }

// d / clamp(sqrt((x*x + y*y) + z*z), 1e-9), as nn.norm3 and the division round it
__device__ __forceinline__ void normalise(float& x, float& y, float& z) {
  float n = __fsqrt_rn(__fadd_rn(__fadd_rn(rn_mul(x, x), rn_mul(y, y)), rn_mul(z, z)));
  n = fmaxf(n, 1e-9f);
  x = __fdiv_rn(x, n);
  y = __fdiv_rn(y, n);
  z = __fdiv_rn(z, n);
}

// The constants as PyTorch rounds a Python float to f32.
#define C(v) ((float)(v))

// The direction encoding into o[0, enc_dim): components_from_spherical_harmonics
// (acn_tpu_torch/models/encodings.py) term by term, or frequency_encode.
__device__ __forceinline__ void encode_dir(float x, float y, float z, int kind, int param,
                                           float* o) {
  normalise(x, y, z);  // enc_dir
  if (kind == 0) {
    normalise(x, y, z);  // sh_encode normalises again
    const int levels = param;
    const float xx = rn_mul(x, x), yy = rn_mul(y, y), zz = rn_mul(z, z);
    o[0] = C(0.28209479177387814);
    if (levels > 1) {
      o[1] = rn_mul(C(0.4886025119029199), y);
      o[2] = rn_mul(C(0.4886025119029199), z);
      o[3] = rn_mul(C(0.4886025119029199), x);
    }
    if (levels > 2) {
      o[4] = rn_mul(rn_mul(C(1.0925484305920792), x), y);
      o[5] = rn_mul(rn_mul(C(1.0925484305920792), y), z);
      o[6] = rn_sub(rn_mul(C(0.9461746957575601), zz), C(0.31539156525251999));
      o[7] = rn_mul(rn_mul(C(1.0925484305920792), x), z);
      o[8] = rn_mul(C(0.5462742152960396), rn_sub(xx, yy));
    }
    if (levels > 3) {
      o[9] = rn_mul(rn_mul(C(0.5900435899266435), y), rn_sub(rn_mul(3.f, xx), yy));
      o[10] = rn_mul(rn_mul(rn_mul(C(2.890611442640554), x), y), z);
      o[11] = rn_mul(rn_mul(C(0.4570457994644658), y), rn_sub(rn_mul(5.f, zz), 1.f));
      o[12] = rn_mul(rn_mul(C(0.3731763325901154), z), rn_sub(rn_mul(5.f, zz), 3.f));
      o[13] = rn_mul(rn_mul(C(0.4570457994644658), x), rn_sub(rn_mul(5.f, zz), 1.f));
      o[14] = rn_mul(rn_mul(C(1.445305721320277), z), rn_sub(xx, yy));
      o[15] = rn_mul(rn_mul(C(0.5900435899266435), x), rn_sub(xx, rn_mul(3.f, yy)));
    }
    if (levels > 4) {
      o[16] = rn_mul(rn_mul(rn_mul(C(2.5033429417967046), x), y), rn_sub(xx, yy));
      o[17] = rn_mul(rn_mul(rn_mul(C(1.7701307697799304), y), z),
                     rn_sub(rn_mul(3.f, xx), yy));
      o[18] = rn_mul(rn_mul(rn_mul(C(0.9461746957575601), x), y),
                     rn_sub(rn_mul(7.f, zz), 1.f));
      o[19] = rn_mul(rn_mul(rn_mul(C(0.6690465435572892), y), z),
                     rn_sub(rn_mul(7.f, zz), 3.f));
      o[20] = rn_mul(C(0.10578554691520431),
                     __fadd_rn(rn_sub(rn_mul(rn_mul(35.f, zz), zz), rn_mul(30.f, zz)), 3.f));
      o[21] = rn_mul(rn_mul(rn_mul(C(0.6690465435572892), x), z),
                     rn_sub(rn_mul(7.f, zz), 3.f));
      o[22] = rn_mul(rn_mul(C(0.47308734787878004), rn_sub(xx, yy)),
                     rn_sub(rn_mul(7.f, zz), 1.f));
      o[23] = rn_mul(rn_mul(rn_mul(C(1.7701307697799304), x), z),
                     rn_sub(xx, rn_mul(3.f, yy)));
      o[24] = rn_mul(C(0.6258357354491761),
                     rn_sub(rn_mul(xx, rn_sub(xx, rn_mul(3.f, yy))),
                            rn_mul(yy, rn_sub(rn_mul(3.f, xx), yy))));
    }
    return;
  }
  // frequency: [x, y, z], then per axis cos(2^b v) for b < pe, then sin(2^b v)
  const int pe = param;
  o[0] = x;
  o[1] = y;
  o[2] = z;
  const float v3[3] = {x, y, z};
  for (int a = 0; a < 3; ++a) {
    float band = 1.f;
    for (int b = 0; b < pe; ++b, band *= 2.f) {
      const float t = rn_mul(v3[a], band);
      o[3 + a * 2 * pe + b] = cosf(t);
      o[3 + a * 2 * pe + pe + b] = sinf(t);
    }
  }
}

#undef C

// ------------------------------------------------------------------ a tile

// Where layer l's split weights are. Resident: in the expert's split image.
// Streamed: every thread of the block calls it for every layer in turn; it
// waits for layer l to land, splits it (between two barriers), then stages
// the next layer of the pass (or layer 0 of the next pass) into the landing
// slot, to land while layer l computes.
struct Weights {
  const Net& net;
  const Shape* shp;
  const Layer* tab;  // the expert's weight pointers
  float* landing;
  float* frags;
  int pass, passes;

  __device__ __forceinline__ const float* operator()(int l) {
    if (!net.streamed) return frags + shp[l].foff;
    cp_wait_all();
    __syncthreads();  // layer l landed; every warp left layer l - 1
    split_layer(frags, landing, shp[l]);
    __syncthreads();  // layer l split; the landing slot is free
    const int next = l + 1 < net.nl ? l + 1 : 0;
    if (next > 0 || pass + 1 < passes) stage(landing, net, tab, next, shp);
    cp_commit();
    return frags;
  }
};

// One expert's network on tile `tile` of the list (16 points; its rows past
// n_k idle), adding into the slab's accumulators. Every thread of the block
// calls `weights` for every layer, active or not (the streamed layers'
// barriers).
template <int MODE, int W>
__device__ __forceinline__ void run_tile(const Net& net, int k, long long base, bool active,
                                         int tile, int n_k, const unsigned short* list,
                                         const float* enc, float4* acc, Weights& weights) {
  constexpr int NC = W / 8;             // a hidden layer's tiles (zero columns past its width)
  constexpr int KA = NC > 8 ? NC : 8;   // input tiles, at most: L*F and the colour input reach 8 KA
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const Shape* shp = weights.shp;
  int slot[2];  // rows g and g + 8
  bool valid[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = tile * 16 + 8 * h + g;
    valid[h] = active && r < n_k;
    slot[h] = valid[h] ? list[r] : 0;
  }

  float a[KA][4], c[NC][4];
  if (active) {  // the feature rows
    const int kt0 = shp[0].kt;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* row = net.h + k * net.h_stride + (base + slot[h]) * net.in_dim;
#pragma unroll
      for (int kt = 0; kt < KA; ++kt) {
        if (kt < kt0) {
          const int j = kt * 8 + 2 * t;
          a[kt][h] = valid[h] && j < net.in_dim ? __ldg(row + j) : 0.f;
          a[kt][2 + h] = valid[h] && j + 1 < net.in_dim ? __ldg(row + j + 1) : 0.f;
        }
      }
    }
  }
  // the layers in order: the trunk, the heads, the colour MLP, its last
  // layer; one call site a kind
  const int heads = net.sigma_depth, last = net.nl - 1;
  float sig[2], o[2][3];
  for (int l = 0; l < net.nl; ++l) {
    const float* w = weights(l);
    if (!active) continue;
    const Shape s = shp[l];
    if (l == heads) {  // sigma in column 0 (lane t = 0), geo in 1..15
      dense<2>(a, c, w, s.kt);
      sig[0] = expf(fminf(fmaxf(c[0][0], -88.f), 88.f));  // trunc_exp
      sig[1] = expf(fminf(fmaxf(c[0][2], -88.f), 88.f));
      if (MODE == kDensity) continue;
      if (t == 0) c[0][0] = c[0][2] = 0.f;  // the colour layer's zero row
      feed<2>(c, a, false);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* x = enc + slot[h] * net.ES - 16 + 2 * t;
#pragma unroll
        for (int kt = 2; kt < KA; ++kt) {
          if (kt < shp[l + 1].kt) {
            const float2 v = *reinterpret_cast<const float2*>(x + kt * 8);
            a[kt][h] = v.x;
            a[kt][2 + h] = v.y;
          }
        }
      }
    } else if (MODE != kDensity && l == last) {  // rgb: 3 of 8 columns
      dense<1>(a, c, w, s.kt);
    } else {  // a hidden layer, through ReLU
      dense<NC>(a, c, w, s.kt);
      feed<NC>(c, a, true);
    }
  }
  if (!active) return;
  if (MODE != kDensity) {
    // columns 0, 1 in lane t = 0, column 2 in lane t = 1
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      o[h][0] = c[0][2 * h];
      o[h][1] = c[0][2 * h + 1];
      o[h][2] = __shfl_sync(0xffffffffu, c[0][2 * h], (lane & ~3) | 1);
#pragma unroll
      for (int j = 0; j < 3; ++j)
        if (net.sigmoid) o[h][j] = 1.f / (1.f + expf(-o[h][j]));
    }
  }
  if (t != 0) return;
  const bool weighted = net.w != nullptr;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!valid[h]) continue;
    const int p = slot[h];
    const float wk = weighted ? __ldg(net.w + (base + p) * net.K + k) : 1.f;
    float4 A = acc[p];
    if (MODE == kSingle) {
      A = make_float4(o[h][0], o[h][1], o[h][2], sig[h]);
    } else if (MODE == kSigmaBlend) {
      const float ws = __fmul_rn(wk, sig[h]);
      A.x = __fadd_rn(A.x, __fmul_rn(ws, o[h][0]));
      A.y = __fadd_rn(A.y, __fmul_rn(ws, o[h][1]));
      A.z = __fadd_rn(A.z, __fmul_rn(ws, o[h][2]));
      A.w = __fadd_rn(A.w, ws);
    } else if (MODE == kLinearBlend) {
      A.x = __fadd_rn(A.x, __fmul_rn(wk, o[h][0]));
      A.y = __fadd_rn(A.y, __fmul_rn(wk, o[h][1]));
      A.z = __fadd_rn(A.z, __fmul_rn(wk, o[h][2]));
      A.w = __fadd_rn(A.w, __fmul_rn(wk, sig[h]));
    } else {
      A.w = weighted ? __fadd_rn(A.w, __fmul_rn(wk, sig[h])) : sig[h];
    }
    acc[p] = A;
  }
}

// ------------------------------------------------------------------ a slab

// Zero the slab's accumulators and encode its points' directions into
// their rows of enc (zeros to ES).
__device__ __forceinline__ void encode_slab(const Net& net, int mode, long long base, int n_here,
                                            float* enc, float4* acc) {
  for (int i = threadIdx.x; i < net.S; i += blockDim.x) {
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (mode != kDensity && i < n_here) {
      const float* d = net.dirs + (base + i) * net.dir_stride;
      float* row = enc + i * net.ES;
      encode_dir(__ldg(d), __ldg(d + 1), __ldg(d + 2), net.dir_kind, net.dir_param, row);
      for (int j = net.enc_dim; j < net.ES; ++j) row[j] = 0.f;
    }
  }
}

// Expert k's list, first half: a ballot a 32 points of whether its weight
// is not 0, into masks.
template <int NW>
__device__ __forceinline__ void ballots(const Net& net, int k, long long base, int n_here,
                                        unsigned* masks) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int ch = warp; ch < net.S / 32; ch += NW) {
    const int i = ch * 32 + lane;
    bool on = i < n_here;
    if (on && net.w != nullptr) on = __ldg(net.w + (base + i) * net.K + k) != 0.f;
    const unsigned m = __ballot_sync(0xffffffffu, on);
    if (lane == 0) masks[ch] = m;
  }
}

// Second half (after a barrier): a prefix count over the masks writes the
// list, the points in slab order; every warp returns its length.
template <int NW>
__device__ __forceinline__ int compact(int nch, const unsigned* masks, unsigned short* list) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int n_k = 0;
  for (int c0 = 0; c0 < nch; c0 += 32) {
    const unsigned m = c0 + lane < nch ? masks[c0 + lane] : 0u;
    int inc = __popc(m);
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, inc, d);
      if (lane >= d) inc += v;
    }
    const int excl = n_k + inc - __popc(m);
    for (int j = warp; j < 32 && c0 + j < nch; j += NW) {
      const unsigned mj = __shfl_sync(0xffffffffu, m, j);
      const int off = __shfl_sync(0xffffffffu, excl, j);
      if ((mj >> lane) & 1u)
        list[off + __popc(mj & ((1u << lane) - 1u))] = (unsigned short)((c0 + j) * 32 + lane);
    }
    n_k += __shfl_sync(0xffffffffu, inc, 31);
  }
  return n_k;
}

// The slab's outputs from its accumulators (after a barrier).
__device__ __forceinline__ void write_slab(const Net& net, int mode, long long base, int n_here,
                                           const float4* acc) {
  for (int i = threadIdx.x; i < n_here; i += blockDim.x) {
    const float4 A = acc[i];
    const long long p = base + i;
    if (mode == kSigmaBlend) {
      const float s = fmaxf(A.w, 1e-12f);
      net.rgb[p * net.rgb_stride + 0] = __fdiv_rn(A.x, s);
      net.rgb[p * net.rgb_stride + 1] = __fdiv_rn(A.y, s);
      net.rgb[p * net.rgb_stride + 2] = __fdiv_rn(A.z, s);
      net.sigma[p * net.sigma_stride] = s;
    } else {
      if (mode != kDensity) {
        net.rgb[p * net.rgb_stride + 0] = A.x;
        net.rgb[p * net.rgb_stride + 1] = A.y;
        net.rgb[p * net.rgb_stride + 2] = A.z;
      }
      net.sigma[p * net.sigma_stride] = A.w;
    }
  }
}

// ------------------------------------------------------------------ kernel

template <int MODE, int W>
__global__ void __launch_bounds__(threads_for(W), 1) ngp_net_kernel(const __grid_constant__ Net net) {
  constexpr int NW = threads_for(W) / 32;
  extern __shared__ __align__(16) float smem[];
  const int S = net.S, ES = net.ES, nch = S / 32;
  Shape* shp = reinterpret_cast<Shape*>(smem);      // the layers' staged shapes
  Layer* tab = reinterpret_cast<Layer*>(smem + shape_floats(net.nl));  // the staged expert's
  float* frags = smem + shape_floats(net.nl) + 4 * net.nslots;  // the split weights the mma's read
  float* landing = frags + net.split;               // where cp.async lands the next weights
  float* enc = landing + net.land;
  float4* acc = reinterpret_cast<float4*>(enc + (MODE == kDensity ? 0 : S * ES));
  unsigned* masks = reinterpret_cast<unsigned*>(acc + S);
  unsigned short* list = reinterpret_cast<unsigned short*>(masks + nch);
  const int warp = threadIdx.x >> 5;

  if (threadIdx.x == 0) layer_shapes(net, shp);
  load_table(net, 0, tab);
  __syncthreads();
  if (!net.streamed && blockIdx.x < net.slabs) stage_expert(landing, net, tab, shp);
  cp_commit();
  int split_k = -1;  // the expert whose layers frags holds (resident)

  for (long long slab = blockIdx.x; slab < net.slabs; slab += gridDim.x) {
    const long long base = slab * S;
    const int n_here = (int)min((long long)S, net.P - base);
    encode_slab(net, MODE, base, n_here, enc, acc);
    for (int k = 0; k < net.K; ++k) {
      // the expert's list: a ballot a 32 points, then a prefix count
      ballots<NW>(net, k, base, n_here, masks);
      const bool restage = !net.streamed && split_k != k;  // one expert stays put
      if (restage) cp_wait_all();  // this expert's layers landed
      __syncthreads();  // also: every warp is done with the previous expert
      if (restage) {
        split_expert(frags, landing, net, shp);
        split_k = k;
      }
      // the pointers of the expert staged next: the next (slab, expert)'s
      // where whole experts stay resident, this one's where layers stream
      load_table(net, net.streamed ? k : (k + 1 < net.K ? k + 1 : 0), tab);
      const int n_k = compact<NW>(nch, masks, list);
      __syncthreads();  // the list, the table and the split layers are in; the landing buffer is free
      const int tiles = (n_k + 15) / 16;
      Weights weights{net, shp, tab, landing, frags, 0, 0};
      if (!net.streamed) {
        // the next (slab, expert)'s layers land while this expert computes
        long long ns = slab;
        int nk = k + 1;
        if (nk == net.K) {
          nk = 0;
          ns += gridDim.x;
        }
        if (ns < net.slabs && nk != k) stage_expert(landing, net, tab, shp);
        cp_commit();
        for (int tile = warp; tile < tiles; tile += NW)
          run_tile<MODE, W>(net, k, base, true, tile, n_k, list, enc, acc, weights);
      } else if (tiles > 0) {
        // one layer at a time, one tile a warp a pass
        weights.passes = (tiles + NW - 1) / NW;
        stage(landing, net, tab, 0, shp);
        cp_commit();
        for (; weights.pass < weights.passes; ++weights.pass) {
          const int tile = weights.pass * NW + warp;
          run_tile<MODE, W>(net, k, base, tile < tiles, tile, n_k, list, enc, acc, weights);
        }
      }
    }
    __syncthreads();  // every expert's adds are in
    write_slab(net, MODE, base, n_here, acc);
  }
  cp_wait_all();
}

// ------------------------------------------------------------------ the wide path

// A layer of the wide path: kt input tiles of 8 rows, nb output blocks of 64
// columns; its split image at off in an expert's (for each round of up to
// kRoundBlocks blocks, each k-step: the round's blocks' big parts, then their
// small parts, kBlockFloats each), its bias (64 nb floats) at bias.
struct WShape {
  int kt, nb, off, bias;
};

__host__ __device__ inline void add_wide(WShape* s, int& n, int& off, int in, int out) {
  WShape& x = s[n++];
  x.kt = tiles8(in);
  x.nb = (out + 63) / 64;
  x.off = off;
  off += 2 * kBlockFloats * x.kt * x.nb;
}

// The wide path's layers, in layer_shapes' order and with its staged
// inputs; returns the floats of an expert's split image.
__host__ __device__ inline int wide_shapes(const Net& net, WShape* s) {
  int n = 0, off = 0;
  for (int l = 0; l < net.sigma_depth; ++l)
    add_wide(s, n, off, l == 0 ? net.in_dim : net.hidden, net.hidden);
  add_wide(s, n, off, net.hidden, 1 + kGeo);
  if (net.mode != kDensity) {
    add_wide(s, n, off, 1 + kGeo + net.enc_dim, net.color_hidden);
    for (int c = 1; c < net.color_depth; ++c) add_wide(s, n, off, net.color_hidden, net.color_hidden);
    add_wide(s, n, off, net.color_hidden, 3);
  }
  for (int l = 0; l < n; ++l) {
    s[l].bias = off;
    off += 64 * s[l].nb;
  }
  return off;
}

// Where element (row i, column j) of a layer lands in its split image, the
// big part (the small one kBlockFloats x blocks-of-its-round later): the
// k-step i / 8, k-slot t from row 2t and t + 4 from row 2t + 1 (as the
// width classes read their weight rows), and wgmma's K-major layout without
// swizzle: 8 x 4 core matrices of 128 bytes, k-halves 128 bytes apart
// (LBO), 8-column groups 256 bytes apart (SBO).
__host__ __device__ inline int wide_index(const WShape& s, int i, int j, int& round_blocks) {
  const int o = i & 7, slot = (o & 1) ? 4 + (o >> 1) : o >> 1;
  const int blk = j >> 6, r = blk / kRoundBlocks, b = blk - r * kRoundBlocks;
  round_blocks = min(kRoundBlocks, s.nb - r * kRoundBlocks);
  const int n = j & 63;
  return s.off + 2 * kBlockFloats * (s.kt * kRoundBlocks * r + (i >> 3) * round_blocks) +
         b * kBlockFloats + (n >> 3) * 64 + (slot >> 2) * 32 + (n & 7) * 4 + (slot & 3);
}

// Every expert's layers split once a call (grid: blocks x experts): each
// weight into its TF32 big and small parts at wide_index, each bias as it
// is; zeros past a layer's rows and columns.
__global__ void __launch_bounds__(256) ngp_net_split_kernel(const __grid_constant__ Net net) {
  extern __shared__ __align__(16) float smem[];
  WShape* shp = reinterpret_cast<WShape*>(smem);
  if (threadIdx.x == 0) wide_shapes(net, shp);
  __syncthreads();
  const int k = blockIdx.y;
  const Layer* tab = net.layers + (long long)k * net.nslots;
  float* img = const_cast<float*>(net.wsplit) + (long long)k * net.wexpert;
  const int stride = gridDim.x * blockDim.x;
  for (int l = 0; l < net.nl; ++l) {
    const WShape s = shp[l];
    Part a, b;
    parts_of(net, tab, l, a, b);
    const int cols = 64 * s.nb, n = 8 * s.kt * cols;
    for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n; e += stride) {
      const int i = e / cols, j = e - i * cols;
      const float* src = source(a, i, j);
      if (src == nullptr && b.cols) src = source(b, i, j);
      unsigned big, small;
      split(src ? *src : 0.f, big, small);
      int nbr;
      const int at = wide_index(s, i, j, nbr);
      img[at] = __uint_as_float(big);
      img[at + nbr * kBlockFloats] = __uint_as_float(small);
    }
    for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < cols; j += stride) {
      const float* src = j < a.col0 + a.cols ? a.b + (j - a.col0)
                         : b.cols && j >= b.col0 && j < b.col0 + b.cols ? b.b + (j - b.col0)
                                                                        : nullptr;
      img[s.bias + j] = src ? *src : 0.f;
    }
  }
}

// mbarriers, the bulk copy, wgmma (PTX ISA 8.0, sm_90a)

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, unsigned parity) {
  unsigned ok;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return ok != 0;
}

// A wait that has not ended after ~2^34 cycles (seconds) traps: a launch
// error where a fault in the ring's order would otherwise hang the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1LL << 34)) __trap();
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// bytes from global src into shared dst, completing on bar's transaction count
__device__ __forceinline__ void bulk_load(float* dst, const float* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// B's descriptor: K-major, no swizzle, LBO 128 bytes, SBO 256 bytes
__device__ __forceinline__ unsigned long long wgmma_desc(const float* p) {
  return (unsigned long long)((smem_addr(p) & 0x3FFFF) >> 4) | (128ull >> 4) << 16 |
         (256ull >> 4) << 32;
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// until at most N of the warpgroup's committed groups are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

#define ACC8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
    "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (+)= a b on 64 points x 64 columns x 8: a, the warp's A fragment in
// registers (rows g, g + 8 of its 16; k-slots t, t + 4); b by descriptor;
// d, the accumulator fragments of the 8 column tiles (rows g, g + 8,
// columns 2t, 2t + 1 of each). scale_d 0: d = a b.
__device__ __forceinline__ void wgmma64(float (&d)[32], const unsigned (&a)[4],
                                        unsigned long long desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

#undef ACC8

static_assert(kRoundBlocks == 4, "wide_kstep's dispatch takes rounds of 1 to 4 blocks");

// One k-step of a round of NBR blocks: for each block the three products
// into a partial from 0, added to the block's sum with one rounded add
// while the next block's products run (two partials alternate). NBR is a
// compile-time constant so that no wgmma, commit or wait sits under a
// branch of its own: the compiler serializes every wgmma of a kernel where
// one does.
template <int NBR>
__device__ __forceinline__ void wide_kstep(float (&c)[kRoundBlocks][32], float (&d)[2][32],
                                           const unsigned (&ab)[4], const unsigned (&as)[4],
                                           unsigned long long desc) {
#pragma unroll
  for (int b = 0; b <= NBR; ++b) {
    if (b < NBR) {
      const unsigned long long big = desc + b * (kBlockFloats * 4 / 16);
      const unsigned long long small = desc + (NBR + b) * (kBlockFloats * 4 / 16);
      wgmma_fence();
      wgmma64(d[b & 1], as, big, 0);
      wgmma64(d[b & 1], ab, small, 1);
      wgmma64(d[b & 1], ab, big, 1);
      wgmma_commit();
    }
    if (b >= 1) {
      if (b < NBR)
        wgmma_wait<1>();
      else
        wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 32; ++i) c[b - 1][i] = __fadd_rn(c[b - 1][i], d[(b - 1) & 1][i]);
    }
  }
}

// Where thread 0 stands in an expert's stream of stages: layers in order,
// each its rounds of up to kRoundBlocks blocks, each round its k-steps, and
// every pass the same again. next() gives the current stage's offset in the
// expert's split image and its bytes, and steps on.
struct StageCursor {
  const WShape* shp;
  int nl, l = 0, r = 0, j = 0;

  __device__ __forceinline__ void next(int& off, unsigned& bytes) {
    const WShape s = shp[l];
    const int nbr = min(kRoundBlocks, s.nb - r * kRoundBlocks);
    off = s.off + 2 * kBlockFloats * (s.kt * kRoundBlocks * r + j * nbr);
    bytes = nbr * 2 * kBlockFloats * 4;
    if (++j == s.kt) {
      j = 0;
      if (++r * kRoundBlocks >= s.nb) {
        r = 0;
        if (++l == nl) l = 0;
      }
    }
  }
};

// Networks wider than 128 (the module note). One block an SM: two
// warpgroups, each a 64-point tile of the list; thread 0 also streams the
// split weights through the ring. Every thread takes the list's barriers.
__global__ void __launch_bounds__(kWideThreads, 1)
ngp_net_wide_kernel(const __grid_constant__ Net net) {
  extern __shared__ __align__(16) float smem[];
  const int mode = net.mode, S = net.S, ES = net.ES, nch = S / 32, KW = net.KW;
  const bool density = mode == kDensity;
  WShape* shp = reinterpret_cast<WShape*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + 4 * net.nl);  // a stage landed
  uint64_t* empty = full + kWideStages;                             // a stage read
  float* ring = smem + net.ring_off;
  float* enc = smem + net.enc_off;  // a tile's direction encodings, 64 rows a warpgroup
  float4* acc = reinterpret_cast<float4*>(enc + (density ? 0 : kWideWGs * 64 * ES));
  unsigned* masks = reinterpret_cast<unsigned*>(acc + S);
  unsigned short* list = reinterpret_cast<unsigned short*>(masks + nch);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, w4 = warp & 3, g = lane >> 2, t = lane & 3;
  const int nl = net.nl, heads = net.sigma_depth, last = nl - 1;
  // the warpgroup's activations, a thread's own fragments at w4 KW 32 + lane:
  // on chip one buffer, a layer's outputs over its inputs (a thread reads
  // back only what it wrote, and writes after its last product); spilled,
  // two in the block's scratch
  const long long tile_f4 = 4LL * KW * 32;
  float4* const buf_a = net.onchip
      ? reinterpret_cast<float4*>(smem + net.act_off) + wg * tile_f4
      : reinterpret_cast<float4*>(net.scratch + blockIdx.x * net.scratch_block) +
            2 * wg * tile_f4;
  float4* const buf_b = net.onchip ? buf_a : buf_a + tile_f4;
  float* const enc_rows = enc + (wg * 64 + w4 * 16) * ES;  // the warp's 16 rows

  if (threadIdx.x == 0) {
    wide_shapes(net, shp);
    for (int st = 0; st < kWideStages; ++st) {
      mbar_init(full + st, 1);
      mbar_init(empty + st, 4 * kWideWGs);  // a warp each
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int per_pass = 0;  // stages of a pass
  for (int l = 0; l < nl; ++l)
    per_pass += (shp[l].nb + kRoundBlocks - 1) / kRoundBlocks * shp[l].kt;

  unsigned it = 0;  // the ring's position, the same in every thread
  for (long long slab = blockIdx.x; slab < net.slabs; slab += gridDim.x) {
    const long long base = slab * S;
    const int n_here = (int)min((long long)S, net.P - base);
    for (int i = threadIdx.x; i < S; i += blockDim.x) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = 0; k < net.K; ++k) {
      ballots<kWideThreads / 32>(net, k, base, n_here, masks);
      __syncthreads();  // also: every warp is done with the previous expert
      const int n_k = compact<kWideThreads / 32>(nch, masks, list);
      __syncthreads();
      const int tiles = (n_k + 63) / 64;
      const int passes = (tiles + kWideWGs - 1) / kWideWGs;
      const int stages = passes * per_pass;
      const float* wk = net.wsplit + (long long)k * net.wexpert;
      const unsigned it0 = it;
      // stage q of the expert into ring position it0 + q, once every warp
      // has read what that position held (thread 0): kWideStages - 1 ahead,
      // so that the warp that issues waits for the other warpgroup to finish
      // the stage before the one it reads, not that one
      StageCursor cursor{shp, nl};  // thread 0's: stages are issued in order
      auto issue = [&](int q) {
        const unsigned at = it0 + q;
        const int st = at % kWideStages;
        mbar_wait(empty + st, ((at / kWideStages) & 1) ^ 1);
        int off;
        unsigned bytes;
        cursor.next(off, bytes);
        bulk_load(ring + st * kStageFloats, wk + off, bytes, full + st);
      };
      if (threadIdx.x == 0)
        for (int q = 0; q < kWideStages - 1 && q < stages; ++q) issue(q);
      __syncwarp();
      const float* hk = net.h + k * net.h_stride;
      for (int pass = 0; pass < passes; ++pass) {
        const int tile = pass * kWideWGs + wg;
        const bool active = tile < tiles;  // the warpgroup's
        int slot[2];
        bool valid[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = tile * 64 + w4 * 16 + 8 * h + g;
          valid[h] = active && r < n_k;
          slot[h] = valid[h] ? list[r] : 0;
        }
        float4* in = buf_a;
        float4* out = buf_b;
        if (active) {  // layer 0's input: the feature rows, as A fragments
          const float* r0 = hk + (base + slot[0]) * net.in_dim;
          const float* r1 = hk + (base + slot[1]) * net.in_dim;
          for (int kt = 0; kt < shp[0].kt; ++kt) {
            const int j = kt * 8 + 2 * t;
            float4 v;
            v.x = valid[0] && j < net.in_dim ? __ldg(r0 + j) : 0.f;
            v.y = valid[1] && j < net.in_dim ? __ldg(r1 + j) : 0.f;
            v.z = valid[0] && j + 1 < net.in_dim ? __ldg(r0 + j + 1) : 0.f;
            v.w = valid[1] && j + 1 < net.in_dim ? __ldg(r1 + j + 1) : 0.f;
            in[(w4 * KW + kt) * 32 + lane] = v;
          }
        }
        float sig[2] = {0.f, 0.f}, o[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
        for (int l = 0; l < nl; ++l) {
          const WShape s = shp[l];
          float4* const mine = in + w4 * KW * 32 + lane;
          float4* const outs = out + w4 * KW * 32 + lane;
          for (int r = 0; r * kRoundBlocks < s.nb; ++r) {
            const int nbr = min(kRoundBlocks, s.nb - r * kRoundBlocks);
            float c[kRoundBlocks][32], d[2][32];
#pragma unroll
            for (int i = 0; i < 32; ++i) {
              d[0][i] = d[1][i] = 0.f;
#pragma unroll
              for (int b = 0; b < kRoundBlocks; ++b) c[b][i] = 0.f;
            }
            for (int j = 0; j < s.kt; ++j, ++it) {
              const int st = it % kWideStages;
              mbar_wait(full + st, (it / kWideStages) & 1);
              if (active) {
                // each input tile's 24 products into a partial from 0, added
                // with one rounded add (as the width classes sum them); a
                // block's partial is added while the next block's products run
                const float4 a = mine[j * 32];
                unsigned ab[4], as[4];
                split(a.x, ab[0], as[0]);
                split(a.y, ab[1], as[1]);
                split(a.z, ab[2], as[2]);
                split(a.w, ab[3], as[3]);
                const unsigned long long desc = wgmma_desc(ring + st * kStageFloats);
                switch (nbr) {
                  case 1: wide_kstep<1>(c, d, ab, as, desc); break;
                  case 2: wide_kstep<2>(c, d, ab, as, desc); break;
                  case 3: wide_kstep<3>(c, d, ab, as, desc); break;
                  default: wide_kstep<4>(c, d, ab, as, desc); break;
                }
              }
              __syncwarp();
              if (lane == 0) mbar_arrive(empty + st);  // this warp's products of the stage are done
              if (threadIdx.x == 0 && it + kWideStages - 1 - it0 < (unsigned)stages)
                issue((int)(it + kWideStages - 1 - it0));
              __syncwarp();  // warp 0 whole again before its next wgmma
            }
            if (!active) continue;
            // the round's bias, then its outputs
            const float* bias = wk + s.bias + 64 * kRoundBlocks * r + 2 * t;
#pragma unroll
            for (int b = 0; b < kRoundBlocks; ++b) {
              if (b < nbr) {
#pragma unroll
                for (int q = 0; q < 8; ++q) {
                  const float2 bv = __ldg(reinterpret_cast<const float2*>(bias + 64 * b + 8 * q));
                  c[b][4 * q] = __fadd_rn(c[b][4 * q], bv.x);
                  c[b][4 * q + 1] = __fadd_rn(c[b][4 * q + 1], bv.y);
                  c[b][4 * q + 2] = __fadd_rn(c[b][4 * q + 2], bv.x);
                  c[b][4 * q + 3] = __fadd_rn(c[b][4 * q + 3], bv.y);
                }
              }
            }
            if (l == heads) {  // sigma in column 0 (lane t = 0), geo in 1..15
              sig[0] = expf(fminf(fmaxf(c[0][0], -88.f), 88.f));  // trunc_exp
              sig[1] = expf(fminf(fmaxf(c[0][2], -88.f), 88.f));
              if (density) continue;
              if (t == 0) c[0][0] = c[0][2] = 0.f;  // the colour layer's zero row
              outs[0] = make_float4(c[0][0], c[0][2], c[0][1], c[0][3]);
              outs[32] = make_float4(c[0][4], c[0][6], c[0][5], c[0][7]);
              // the direction encoding from column 16 of the colour input:
              // lanes 0-15 encode the warp's 16 rows (zeros to ES)
              if (lane < 16) {
                const int r = tile * 64 + w4 * 16 + lane;
                float* row = enc_rows + lane * ES;
                if (r < n_k) {
                  const float* dd = net.dirs + (base + list[r]) * net.dir_stride;
                  encode_dir(__ldg(dd), __ldg(dd + 1), __ldg(dd + 2), net.dir_kind,
                             net.dir_param, row);
                }
                for (int x = r < n_k ? net.enc_dim : 0; x < ES; ++x) row[x] = 0.f;
              }
              __syncwarp();
              const float* x0 = enc_rows + g * ES - 16 + 2 * t;
              const float* x1 = x0 + 8 * ES;
              for (int kt = 2; kt < shp[l + 1].kt; ++kt) {
                const float2 v0 = *reinterpret_cast<const float2*>(x0 + kt * 8);
                const float2 v1 = *reinterpret_cast<const float2*>(x1 + kt * 8);
                outs[kt * 32] = make_float4(v0.x, v1.x, v0.y, v1.y);
              }
            } else if (!density && l == last) {  // rgb: 3 of 64 columns
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                o[h][0] = c[0][2 * h];
                o[h][1] = c[0][2 * h + 1];
                o[h][2] = __shfl_sync(0xffffffffu, c[0][2 * h], (lane & ~3) | 1);
#pragma unroll
                for (int x = 0; x < 3; ++x)
                  if (net.sigmoid) o[h][x] = 1.f / (1.f + expf(-o[h][x]));
              }
            } else {  // a hidden layer, through ReLU, as the next one's input tiles
#pragma unroll
              for (int b = 0; b < kRoundBlocks; ++b)
                if (b < nbr)
#pragma unroll
                  for (int q = 0; q < 8; ++q)
                    outs[(8 * (kRoundBlocks * r + b) + q) * 32] =
                        make_float4(fmaxf(c[b][4 * q], 0.f), fmaxf(c[b][4 * q + 2], 0.f),
                                    fmaxf(c[b][4 * q + 1], 0.f), fmaxf(c[b][4 * q + 3], 0.f));
            }
          }
          float4* const x = in;
          in = out;
          out = x;
        }
        // the expert's share into the points' accumulators (lane t = 0)
        if (t != 0) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (!valid[h]) continue;
          const int p = slot[h];
          const float wk_p = net.w != nullptr ? __ldg(net.w + (base + p) * net.K + k) : 1.f;
          const float sg = sig[h];
          float4 A = acc[p];
          if (mode == kSingle) {
            A = make_float4(o[h][0], o[h][1], o[h][2], sg);
          } else if (mode == kSigmaBlend) {
            const float ws = __fmul_rn(wk_p, sg);
            A.x = __fadd_rn(A.x, __fmul_rn(ws, o[h][0]));
            A.y = __fadd_rn(A.y, __fmul_rn(ws, o[h][1]));
            A.z = __fadd_rn(A.z, __fmul_rn(ws, o[h][2]));
            A.w = __fadd_rn(A.w, ws);
          } else if (mode == kLinearBlend) {
            A.x = __fadd_rn(A.x, __fmul_rn(wk_p, o[h][0]));
            A.y = __fadd_rn(A.y, __fmul_rn(wk_p, o[h][1]));
            A.z = __fadd_rn(A.z, __fmul_rn(wk_p, o[h][2]));
            A.w = __fadd_rn(A.w, __fmul_rn(wk_p, sg));
          } else {
            A.w = net.w != nullptr ? __fadd_rn(A.w, __fmul_rn(wk_p, sg)) : sg;
          }
          acc[p] = A;
        }
      }
    }
    __syncthreads();  // every expert's adds are in
    write_slab(net, mode, base, n_here, acc);
  }
}

// ------------------------------------------------------------------ launch

struct DeviceLimits {
  int sms = 0, smem = 0;
};

DeviceLimits device_limits() {
  static DeviceLimits cache[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return {};
  DeviceLimits& d = cache[dev];
  if (d.sms == 0) {
    cudaDeviceGetAttribute(&d.smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return d;
}

// A block's shared memory for a slab of S points.
size_t slab_bytes(const Net& net, long long S) {
  if (net.W == 0)  // the wide path keeps a tile's encodings, not a slab's
    return 4 * ((size_t)net.enc_off + (size_t)kWideWGs * 64 * net.ES) + 16 * (size_t)S +
           4 * (size_t)(S / 32) + 2 * (size_t)S;
  return 4 * (shape_floats(net.nl) + 4 * (size_t)net.nslots + net.land + net.split) +
         4 * (size_t)S * (net.ES + 4) + 4 * (size_t)(S / 32) + 2 * (size_t)S;
}

// Fewer points a slab where a call has fewer than a full slab for each of
// the sms (at least kSlabMin); on the wide path, whole rounds of slabs over
// the blocks (one an SM), so that no round is a tail.
long long fit_slab(const Net& net, long long S, int sms) {
  if (net.W == 0) {
    const long long rounds = (net.P + S * sms - 1) / (S * sms);
    const long long even = ((net.P + rounds * sms - 1) / (rounds * sms) + 31) / 32 * 32;
    if (even < S) S = even;
  }
  long long fill = ((net.P + sms - 1) / sms + 31) / 32 * 32;
  if (fill < kSlabMin) fill = kSlabMin;
  return fill < S ? fill : S;
}

// The wide path's shared memory: its layers' shapes and the ring's
// barriers, the ring, the two warpgroups' activations where they stay on
// chip (every layer at most kRoundBlocks blocks wide, and a slab of at least
// kWideSlabMin beside them), and the slab. Sets the offsets, the scratch a
// block needs where the activations spill, and the slab; returns the bytes
// of a full slab, or 0.
size_t wide_plan(Net& net, int smem_max, int sms) {
  std::vector<WShape> shapes(net.nl);
  net.wexpert = wide_shapes(net, shapes.data());
  int kw = 0, fits = 1;
  for (const WShape& s : shapes) {
    kw = s.kt > kw ? s.kt : kw;
    kw = 8 * s.nb > kw ? 8 * s.nb : kw;
    if (s.nb > kRoundBlocks) fits = 0;
  }
  net.KW = kw;
  net.ES = net.mode == kDensity ? 0 : 8 * tiles8(1 + kGeo + net.enc_dim) - 16 + 2;
  const size_t per_point = 4 * 4 + 2 + 1;  // acc, list, ballot
  net.ring_off = (4 * net.nl + 4 * kWideStages + 31) / 32 * 32;  // floats, 128-byte aligned
  const size_t act = (size_t)kWideWGs * 4 * kw * 32 * 4;  // floats
  const size_t enc = (size_t)kWideWGs * 64 * net.ES;      // floats: a tile's encodings
  auto slab_beside = [&](size_t front) -> long long {
    if (4 * front + 32 * per_point > (size_t)smem_max) return 0;
    const long long S = (long long)((smem_max - 4 * front) / per_point) / 32 * 32;
    return S < kWideSlabMax ? S : kWideSlabMax;
  };
  net.act_off = net.ring_off + kWideStages * kStageFloats;
  net.onchip = fits && slab_beside(net.act_off + act + enc) >= kWideSlabMin;
  net.enc_off = net.act_off + (net.onchip ? (int)act : 0);
  net.scratch_block = net.onchip ? 0 : 2 * (long long)act;
  const long long S = slab_beside(net.enc_off + enc);
  if (S == 0) return 0;
  const size_t full = slab_bytes(net, S);
  net.S = (int)fit_slab(net, S, sms);
  net.slabs = (net.P + net.S - 1) / net.S;
  return full;
}

// The weight buffers and the slab of a width class: what fits in the
// block's shared memory, or less (fit_slab). The classes keep an expert's
// whole split image, or, streamed, one layer at a time. Returns the bytes
// of shared memory of a full slab (the most a launch of this net takes), or
// 0.
size_t plan(Net& net, int smem_max, int sms) {
  if (net.W == 0) return wide_plan(net, smem_max, sms);
  std::vector<Shape> shapes(net.nl);
  layer_shapes(net, shapes.data());
  int limage = 0, fimage = 0, lslot = 0, fslot = 0;
  for (const Shape& s : shapes) {
    const int lf = 8 * s.kt * s.ds + 8 * s.nt, ff = 128 * s.kt * s.nt + 8 * s.nt;
    limage += lf;
    fimage += ff;
    lslot = lf > lslot ? lf : lslot;
    fslot = ff > fslot ? ff : fslot;
  }
  const int density = net.mode == kDensity;
  net.ES = density ? 0 : 8 * tiles8(1 + kGeo + net.enc_dim) - 16 + 2;
  const size_t per_point = 4 * (size_t)(net.ES + 4) + 2 + 1;  // enc, acc, list, ballot
  auto slab_beside = [&](int wfloats) -> long long {
    const size_t wbytes = 4 * (size_t)(wfloats + shape_floats(net.nl) + 4 * net.nslots);
    if (wbytes + 32 * per_point > (size_t)smem_max) return 0;
    long long S = (long long)(((size_t)smem_max - wbytes) / per_point) / 32 * 32;
    return S < kSlabMax ? S : kSlabMax;
  };
  net.streamed = 0;
  net.land = limage;
  net.split = fimage;
  long long S = slab_beside(limage + fimage);
  if (S < kSlabMin && slab_beside(lslot + fslot) > S) {  // too small a slab beside an expert
    net.streamed = 1;
    net.land = lslot;
    net.split = fslot;
    S = slab_beside(lslot + fslot);
  }
  if (S == 0) return 0;
  const size_t full = slab_bytes(net, S);
  net.S = (int)fit_slab(net, S, sms);
  net.slabs = (net.P + net.S - 1) / net.S;
  return full;
}

// Plan the net for `kernel` (threads a block), set its shared memory
// attribute for the full slab and read its occupancy (once a size a
// device; a smaller slab takes less, so as many blocks an SM at least):
// the blocks of its grid.
template <typename Kernel>
int grid_of(Net& net, Kernel kernel, int threads, size_t* set_for, int* blocks_for,
            long long& grid) {
  const DeviceLimits d = device_limits();
  if (d.sms == 0) return (int)cudaErrorInvalidDevice;
  const size_t smem = plan(net, d.smem, d.sms);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (set_for[dev] != smem) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks_for[dev], kernel, threads, smem);
    if (err != cudaSuccess) return (int)err;
    set_for[dev] = smem;
  }
  const int per_sm = blocks_for[dev];
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  grid = net.slabs < (long long)per_sm * d.sms ? net.slabs : (long long)per_sm * d.sms;
  return 0;
}

template <int MODE, int W>
int launch(Net& net, cudaStream_t stream) {
  static size_t set_for[64];
  static int blocks_for[64];
  long long grid = 0;
  const int err = grid_of(net, ngp_net_kernel<MODE, W>, threads_for(W), set_for, blocks_for, grid);
  if (err) return err;
  ngp_net_kernel<MODE, W><<<(unsigned)grid, threads_for(W), slab_bytes(net, net.S), stream>>>(net);
  return (int)cudaGetLastError();
}

// The wide path's grid (one block an SM).
int wide_grid(Net& net, long long& grid) {
  static size_t set_for[64];
  static int blocks_for[64];
  return grid_of(net, ngp_net_wide_kernel, threads_for(0), set_for, blocks_for, grid);
}

// The bytes of the wide path's device buffer: every expert's split image,
// then the spilled activations' scratch (0 where they stay on chip).
long long wide_buffer_bytes(const Net& net, long long grid) {
  return 4 * (net.K * net.wexpert + grid * net.scratch_block);
}

// The split launch: every expert's image into net.wsplit.
int launch_split(const Net& net, cudaStream_t stream) {
  const DeviceLimits d = device_limits();
  if (d.sms == 0) return (int)cudaErrorInvalidDevice;
  if (net.K > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(2 * d.sms + net.K - 1) / (unsigned)net.K, (unsigned)net.K);
  ngp_net_split_kernel<<<grid, 256, sizeof(WShape) * net.nl, stream>>>(net);
  return (int)cudaGetLastError();
}

// The width class: 64 or 128 where every width the network carries fits
// it, else 0 (the wide path).
int width_class(const Net& net) {
  int widest = net.hidden > net.in_dim ? net.hidden : net.in_dim;
  if (net.mode != kDensity) {
    widest = net.color_hidden > widest ? net.color_hidden : widest;
    widest = 1 + kGeo + net.enc_dim > widest ? 1 + kGeo + net.enc_dim : widest;
  }
  return widest <= 64 ? 64 : widest <= kClassWidth ? kClassWidth : 0;
}

template <int MODE>
int launch_class(Net& net, cudaStream_t stream) {
  if (net.W == 64) return launch<MODE, 64>(net, stream);
  return launch<MODE, kClassWidth>(net, stream);
}

// The net from the entry points' arguments; 0, or an error for what no
// parser flag reaches (a width or depth below 1, SH levels outside 1-5).
int make_net(Net& net, int mode, const void* h, long long h_stride, const void* layers,
             const int* dims, int K, long long P) {
  if (mode < kSingle || mode > kDensity || K < 1 || P < 0) return (int)cudaErrorInvalidValue;
  net = Net{};
  net.mode = mode;
  net.K = K;
  net.in_dim = dims[0];
  net.hidden = dims[1];
  net.sigma_depth = dims[2];
  net.color_hidden = dims[3];
  net.color_depth = dims[4];
  net.dir_kind = dims[5];
  net.dir_param = dims[6];
  net.sigmoid = dims[7];
  if (net.in_dim < 1 || net.hidden < 1 || net.color_hidden < 1 || net.sigma_depth < 1 ||
      net.color_depth < 1 || net.dir_param < 0 ||
      (net.dir_kind == 0 && (net.dir_param < 1 || net.dir_param > kMaxShLevels)))
    return (int)cudaErrorInvalidValue;
  net.enc_dim = net.dir_kind == 0 ? net.dir_param * net.dir_param : 3 * (2 * net.dir_param + 1);
  net.nl = net.sigma_depth + 1 + (mode == kDensity ? 0 : net.color_depth + 1);
  net.nslots = net.sigma_depth + net.color_depth + 3;
  net.h = static_cast<const float*>(h);
  net.h_stride = h_stride;
  net.layers = static_cast<const Layer*>(layers);
  net.P = P;
  net.W = width_class(net);
  return 0;
}

}  // namespace

extern "C" {

// The constants the Python wrapper checks against its own.
void ngp_net_limits(int* out) {
  out[0] = kGeo;
  out[1] = kMaxShLevels;
  out[2] = kClassWidth;
}

// The bytes of the device buffer a launch of ngp_net_fwd with these
// arguments takes (0 where the network takes a class; on the wide path the
// experts' split weights, and the spilled activations of networks whose
// activations do not fit on chip), or -1 (a CUDA error code's negation
// below).
long long ngp_net_wide_bytes(int mode, const int* dims, int K, long long P) {
  Net net;
  int err = make_net(net, mode, nullptr, 0, nullptr, dims, K, P);
  if (err) return -(long long)err;
  if (net.W != 0 || P == 0) return 0;
  long long grid = 0;
  err = wide_grid(net, grid);
  if (err) return -(long long)err;
  return wide_buffer_bytes(net, grid);
}

// The wide path's split launch alone, into out (K x the image's floats,
// ngp_net_wide_image_floats): what ngp_net_fwd launches before the network,
// for its tests and timing. Returns a CUDA error code.
int ngp_net_wide_split(int mode, const void* layers, const int* dims, int K, void* out,
                       void* stream) {
  Net net;
  int err = make_net(net, mode, nullptr, 0, layers, dims, K, 1);
  if (err) return err;
  std::vector<WShape> shapes(net.nl);
  net.wexpert = wide_shapes(net, shapes.data());
  net.wsplit = static_cast<const float*>(out);
  return launch_split(net, static_cast<cudaStream_t>(stream));
}

// The floats of one expert's split image on the wide path.
long long ngp_net_wide_image_floats(int mode, const int* dims) {
  Net net;
  int err = make_net(net, mode, nullptr, 0, nullptr, dims, 1, 1);
  if (err) return -(long long)err;
  std::vector<WShape> shapes(net.nl);
  return wide_shapes(net, shapes.data());
}

// mode: 0 single, 1 sigma_blend, 2 linear_blend, 3 density. h: the K
// experts' features, expert k's (P, L*F) rows at h + k * h_stride floats;
// layers: a device array of K * (sigma_depth + color_depth + 3) (w, b)
// pointer pairs, each expert's trunk, sigma, geo and colour layers (the
// last one included) in turn; dims: L*F, hidden, sigma_depth, color_hidden,
// color_depth, dir kind (0 SH, 1 frequency), SH levels or bands, sigmoid;
// buf: ngp_net_wide_bytes' bytes (the wide path: the split launch writes
// the weights there, then the network reads them). Returns a CUDA error
// code (0: launched).
int ngp_net_fwd(int mode, const void* h, long long h_stride, const void* layers, const int* dims,
                int K, long long P, const void* dirs, long long dir_stride, const void* w,
                void* rgb, long long rgb_stride, void* sigma, long long sigma_stride,
                void* buf, long long buf_bytes, void* stream) {
  Net net;
  int err = make_net(net, mode, h, h_stride, layers, dims, K, P);
  if (err) return err;
  net.dirs = static_cast<const float*>(dirs);
  net.w = mode == kSingle ? nullptr : static_cast<const float*>(w);
  net.rgb = mode == kDensity ? nullptr : static_cast<float*>(rgb);
  net.sigma = static_cast<float*>(sigma);
  net.dir_stride = dir_stride;
  net.rgb_stride = rgb_stride;
  net.sigma_stride = sigma_stride;
  if (P == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (net.W == 0) {
    long long grid = 0;
    err = wide_grid(net, grid);
    if (err) return err;
    if (buf == nullptr || buf_bytes < wide_buffer_bytes(net, grid))
      return (int)cudaErrorInvalidValue;
    net.wsplit = static_cast<const float*>(buf);
    net.scratch = static_cast<float*>(buf) + K * net.wexpert;
    err = launch_split(net, s);
    if (err) return err;
    ngp_net_wide_kernel<<<(unsigned)grid, threads_for(0), slab_bytes(net, net.S), s>>>(net);
    return (int)cudaGetLastError();
  }
  switch (mode) {
    case kSingle: return launch_class<kSingle>(net, s);
    case kSigmaBlend: return launch_class<kSigmaBlend>(net, s);
    case kLinearBlend: return launch_class<kLinearBlend>(net, s);
    case kDensity: return launch_class<kDensity>(net, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
