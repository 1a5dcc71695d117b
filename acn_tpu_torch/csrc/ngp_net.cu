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
// "3xTF32" on mma.sync.m16n8k8 (below): three TF32 products a multiply-add.
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
// * Anything wider takes the wide path (ngp_net_wide_kernel, one launch a
//   chunk too, mode a runtime argument): a warp cannot carry 16 points x W
//   columns in registers there, nor a block a layer's split image in shared
//   memory (at width 256, 512 KB). The slabs, the point lists, the direction
//   encodings and the accumulators are the classes'; a pass takes 16 tiles
//   of the list (one a warp), and its activations live in a global scratch
//   buffer of the block's own, in the mma's fragment layout: a lane reads
//   back only what it wrote, so the buffer needs no barrier. Each layer is
//   computed in column blocks of 64, each summed over slices of 64 input
//   rows; a slice of the split weights (32 KB) is the block's shared image,
//   the next slice landing by cp.async while the current one computes. A
//   warp loads a slice's 8 input fragments before its first mma (from L2
//   or device memory: one latency a slice, not one an input tile). Each
//   input tile's products still sum into a partial from 0, added with one
//   rounded add in input order, so a layer's outputs are the classes' bits.
//   A pass stages every weight of the expert, so the slab is as large as
//   shared memory holds (lists that fill passes), evened over whole rounds
//   of the grid. At the wide expert of chip_smoke.py (trunk 256 x 8, colour
//   128 x 5: 541,696 multiply-adds a pair) a dense chunk of random points
//   (1.02 M pairs) is bound at 6.7 ms by 3xTF32 operations.
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

#include <vector>

namespace {

constexpr int kGeo = 15;
constexpr int kMaxShLevels = 5;  // spherical harmonics levels sh_encode takes
constexpr int kClassWidth = 128;  // the widest class; wider networks take the wide path
constexpr int kSlabMax = 1024;  // points a slab, at most (the list indices are 16-bit)
constexpr int kSlabMin = 256;   // one 16-point tile a warp of a 16-warp block
// the wide path
constexpr int kWideWarps = 16;
constexpr int kWideTiles = 1;  // 16-point tiles a warp carries through a pass
constexpr int kPassTiles = kWideWarps * kWideTiles;
constexpr int kSliceK = 8;  // input tiles of a weight slice
constexpr int kSliceN = 8;  // output tiles of a weight slice (a column block)
constexpr int kSliceDs = 8 * kSliceN + 4;
constexpr int kSliceLand = 8 * kSliceK * kSliceDs + 8 * kSliceN;    // floats, as it lands
constexpr int kSliceSplit = 128 * kSliceK * kSliceN + 8 * kSliceN;  // floats, split
// points a slab on the wide path, at most: a pass stages every weight of the
// expert for its 16 tiles, so the slab is as large as shared memory holds
// (1,920 points at the smoke's direction encoding), for lists that fill
// whole passes
constexpr int kWideSlabMax = 4096;

enum Mode { kSingle = 0, kSigmaBlend = 1, kLinearBlend = 2, kDensity = 3 };

// warps a block (above 64 wide, a thread's activations and accumulators
// take twice the registers; 0: the wide path)
__host__ __device__ constexpr int threads_for(int W) {
  return W == 0 ? kWideWarps * 32 : W > 64 ? 8 * 32 : 16 * 32;
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
  float* scratch;       // wide path: scratch_block floats a block
  long long P, h_stride, dir_stride, rgb_stride, sigma_stride, slabs, scratch_block;
  int mode, K, in_dim, hidden, sigma_depth, color_hidden, color_depth;
  int dir_kind, dir_param, sigmoid, enc_dim;
  int W;               // width class: 64, 128, or 0 (the wide path)
  int nl, nslots;      // layers an expert (density: the trunk and the heads); weight slots
  int streamed;        // 0: whole experts; 1: one layer at a time
  int land, split;     // floats of the landing and split buffers
  int S, ES;           // points a slab; floats a point's encoding row (even)
  int KW;              // wide path: tiles of a scratch row (the widest layer)
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

// The wide path's slice (cb, ks) of layer l: input tiles [kSliceK ks, +
// kSliceK) by output tiles [kSliceN cb, + kSliceN), zeros past the layer.
__device__ __forceinline__ void stage_slice(float* dst, const Net& net, const Layer* tab, int l,
                                            int cb, int ks) {
  Part a, b;
  parts_of(net, tab, l, a, b);
  stage_layer(dst, a, b, Shape{kSliceK, kSliceN, kSliceDs, 0, 0}, 8 * kSliceK * ks,
              8 * kSliceN * cb);
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

// c[u][j] (the warp's T tiles, the slice's output tiles j < nb) += the
// products of input tiles [kt0, kt0 + kSliceK) below kt_n, in order: each
// input tile's 24 products into a partial from 0 (three mma's in turn across
// 4 output tiles, as dense issues them), added with one rounded add. in:
// the pass's activations, tile u of the warp at (warp T + u) KW 32 float4s.
template <int T>
__device__ __forceinline__ void slice_products(float (&c)[T][kSliceN][4], const float4* in,
                                               int KW, int kt0, int kt_n, int nb,
                                               const float* frags, const bool (&act)[T]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint4* b = reinterpret_cast<const uint4*>(frags) + lane;
  float4 af[T][kSliceK];  // the slice's input fragments, loaded together
#pragma unroll
  for (int kk = 0; kk < kSliceK; ++kk)
#pragma unroll
    for (int u = 0; u < T; ++u)
      if (kt0 + kk < kt_n && act[u]) af[u][kk] = in[((warp * T + u) * KW + kt0 + kk) * 32 + lane];
#pragma unroll
  for (int kk = 0; kk < kSliceK; ++kk) {
    if (kt0 + kk < kt_n) {
#pragma unroll
      for (int u = 0; u < T; ++u) {
        if (!act[u]) continue;
        const float4 a = af[u][kk];
        unsigned ab[4], as[4];
        split(a.x, ab[0], as[0]);
        split(a.y, ab[1], as[1]);
        split(a.z, ab[2], as[2]);
        split(a.w, ab[3], as[3]);
#pragma unroll
        for (int n0 = 0; n0 < kSliceN; n0 += 4) {
          if (n0 < nb) {
            uint4 f[4];
            float d[4][4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              f[j] = b[(kk * kSliceN + n0 + j) * 32];
#pragma unroll
              for (int i = 0; i < 4; ++i) d[j][i] = 0.f;
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) mma(d[j], as, f[j].x, f[j].y);
#pragma unroll
            for (int j = 0; j < 4; ++j) mma(d[j], ab, f[j].z, f[j].w);
#pragma unroll
            for (int j = 0; j < 4; ++j) mma(d[j], ab, f[j].x, f[j].y);
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int i = 0; i < 4; ++i) c[u][n0 + j][i] = __fadd_rn(c[u][n0 + j][i], d[j][i]);
          }
        }
      }
    }
  }
}

// Networks wider than 128 (the module note). One block an SM; every thread
// of the block takes every slice's barriers.
__global__ void __launch_bounds__(kWideWarps * 32, 1)
ngp_net_wide_kernel(const __grid_constant__ Net net) {
  constexpr int NW = kWideWarps, T = kWideTiles;
  extern __shared__ __align__(16) float smem[];
  const int mode = net.mode, S = net.S, ES = net.ES, nch = S / 32, KW = net.KW;
  const bool density = mode == kDensity;
  Shape* shp = reinterpret_cast<Shape*>(smem);
  Layer* tab = reinterpret_cast<Layer*>(smem + shape_floats(net.nl));  // the expert's pointers
  float* frags = smem + shape_floats(net.nl) + 4 * net.nslots;  // the slice the mma's read
  float* landing = frags + kSliceSplit;        // the next slice, landing
  float* enc = landing + kSliceLand;
  float4* acc = reinterpret_cast<float4*>(enc + (density ? 0 : S * ES));
  unsigned* masks = reinterpret_cast<unsigned*>(acc + S);
  unsigned short* list = reinterpret_cast<unsigned short*>(masks + nch);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int nl = net.nl, heads = net.sigma_depth, last = nl - 1;
  // the block's two activation buffers; tile u of the warp at row w T + u
  float4* const buf0 = reinterpret_cast<float4*>(net.scratch + blockIdx.x * net.scratch_block);
  float4* const buf1 = buf0 + (long long)kPassTiles * KW * 32;
  const Shape slice = {kSliceK, kSliceN, kSliceDs, 0, 0};

  if (threadIdx.x == 0) layer_shapes(net, shp);
  __syncthreads();

  for (long long slab = blockIdx.x; slab < net.slabs; slab += gridDim.x) {
    const long long base = slab * S;
    const int n_here = (int)min((long long)S, net.P - base);
    encode_slab(net, mode, base, n_here, enc, acc);
    for (int k = 0; k < net.K; ++k) {
      ballots<NW>(net, k, base, n_here, masks);
      __syncthreads();  // also: every warp is done with the previous expert
      load_table(net, k, tab);
      const int n_k = compact<NW>(nch, masks, list);
      __syncthreads();
      const int tiles = (n_k + 15) / 16;
      if (tiles == 0) continue;
      const int passes = (tiles + kPassTiles - 1) / kPassTiles;
      stage_slice(landing, net, tab, 0, 0, 0);
      cp_commit();
      const float* hk = net.h + k * net.h_stride;
      for (int pass = 0; pass < passes; ++pass) {
        bool act[T], valid[T][2];
        int slot[T][2];
#pragma unroll
        for (int u = 0; u < T; ++u) {
          const int tile = pass * kPassTiles + warp * T + u;
          act[u] = tile < tiles;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = tile * 16 + 8 * h + g;
            valid[u][h] = act[u] && r < n_k;
            slot[u][h] = valid[u][h] ? list[r] : 0;
          }
        }
        // layer 0's input: the feature rows, as A fragments
#pragma unroll
        for (int u = 0; u < T; ++u) {
          if (!act[u]) continue;
          const float* r0 = hk + (base + slot[u][0]) * net.in_dim;
          const float* r1 = hk + (base + slot[u][1]) * net.in_dim;
          for (int kt = 0; kt < shp[0].kt; ++kt) {
            const int j = kt * 8 + 2 * t;
            float4 a;
            a.x = valid[u][0] && j < net.in_dim ? __ldg(r0 + j) : 0.f;
            a.y = valid[u][1] && j < net.in_dim ? __ldg(r1 + j) : 0.f;
            a.z = valid[u][0] && j + 1 < net.in_dim ? __ldg(r0 + j + 1) : 0.f;
            a.w = valid[u][1] && j + 1 < net.in_dim ? __ldg(r1 + j + 1) : 0.f;
            buf0[((warp * T + u) * KW + kt) * 32 + lane] = a;
          }
        }
        float sig[T][2], o[T][2][3];
        for (int l = 0; l < nl; ++l) {
          const Shape s = shp[l];
          const float4* in = (l & 1) ? buf1 : buf0;
          float4* out = (l & 1) ? buf0 : buf1;
          const int ncb = (s.nt + kSliceN - 1) / kSliceN, nks = (s.kt + kSliceK - 1) / kSliceK;
          for (int cb = 0; cb < ncb; ++cb) {
            const int nb = min(kSliceN, s.nt - cb * kSliceN);
            float c[T][kSliceN][4];
#pragma unroll
            for (int u = 0; u < T; ++u)
#pragma unroll
              for (int j = 0; j < kSliceN; ++j)
#pragma unroll
                for (int i = 0; i < 4; ++i) c[u][j][i] = 0.f;
            for (int ks = 0; ks < nks; ++ks) {
              cp_wait_all();
              __syncthreads();  // the slice landed; every warp left the one before
              split_layer(frags, landing, slice);
              __syncthreads();  // the slice split; the landing buffer is free
              // the next slice lands while this one computes: the layer's
              // next, the next layer's first, or the next pass's first
              int l2 = l, cb2 = cb, ks2 = ks + 1;
              if (ks2 == nks) {
                ks2 = 0;
                if (++cb2 == ncb) {
                  cb2 = 0;
                  ++l2;
                }
              }
              if (l2 < nl) stage_slice(landing, net, tab, l2, cb2, ks2);
              else if (pass + 1 < passes) stage_slice(landing, net, tab, 0, 0, 0);
              cp_commit();
              slice_products<T>(c, in, KW, ks * kSliceK, s.kt, nb, frags, act);
            }
            // the column block's bias (the same in every slice of it)
            const float* bias = frags + 128 * kSliceK * kSliceN + 2 * t;
#pragma unroll
            for (int j = 0; j < kSliceN; ++j) {
              if (j < nb) {
                const float2 bv = *reinterpret_cast<const float2*>(bias + j * 8);
#pragma unroll
                for (int u = 0; u < T; ++u) {
                  c[u][j][0] = __fadd_rn(c[u][j][0], bv.x);
                  c[u][j][1] = __fadd_rn(c[u][j][1], bv.y);
                  c[u][j][2] = __fadd_rn(c[u][j][2], bv.x);
                  c[u][j][3] = __fadd_rn(c[u][j][3], bv.y);
                }
              }
            }
#pragma unroll
            for (int u = 0; u < T; ++u) {
              if (!act[u]) continue;
              float4* ou = out + (warp * T + u) * KW * 32 + lane;
              if (l == heads) {  // sigma in column 0 (lane t = 0), geo in 1..15
                sig[u][0] = expf(fminf(fmaxf(c[u][0][0], -88.f), 88.f));  // trunc_exp
                sig[u][1] = expf(fminf(fmaxf(c[u][0][2], -88.f), 88.f));
                if (density) continue;
                if (t == 0) c[u][0][0] = c[u][0][2] = 0.f;  // the colour layer's zero row
                ou[0] = make_float4(c[u][0][0], c[u][0][2], c[u][0][1], c[u][0][3]);
                ou[32] = make_float4(c[u][1][0], c[u][1][2], c[u][1][1], c[u][1][3]);
                // the direction encoding from column 16 of the colour input
                const float* x0 = enc + slot[u][0] * ES - 16 + 2 * t;
                const float* x1 = enc + slot[u][1] * ES - 16 + 2 * t;
                for (int kt = 2; kt < shp[l + 1].kt; ++kt) {
                  const float2 v0 = *reinterpret_cast<const float2*>(x0 + kt * 8);
                  const float2 v1 = *reinterpret_cast<const float2*>(x1 + kt * 8);
                  ou[kt * 32] = make_float4(v0.x, v1.x, v0.y, v1.y);
                }
              } else if (!density && l == last) {  // rgb: 3 of 8 columns
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  o[u][h][0] = c[u][0][2 * h];
                  o[u][h][1] = c[u][0][2 * h + 1];
                  o[u][h][2] = __shfl_sync(0xffffffffu, c[u][0][2 * h], (lane & ~3) | 1);
#pragma unroll
                  for (int j = 0; j < 3; ++j)
                    if (net.sigmoid) o[u][h][j] = 1.f / (1.f + expf(-o[u][h][j]));
                }
              } else {  // a hidden layer, through ReLU, as the next one's input tiles
#pragma unroll
                for (int j = 0; j < kSliceN; ++j)
                  if (j < nb)
                    ou[(cb * kSliceN + j) * 32] =
                        make_float4(fmaxf(c[u][j][0], 0.f), fmaxf(c[u][j][2], 0.f),
                                    fmaxf(c[u][j][1], 0.f), fmaxf(c[u][j][3], 0.f));
              }
            }
          }
        }
        // the expert's share into the points' accumulators (lane t = 0)
        if (t == 0) {
#pragma unroll
          for (int u = 0; u < T; ++u) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              if (!valid[u][h]) continue;
              const int p = slot[u][h];
              const float wk = net.w != nullptr ? __ldg(net.w + (base + p) * net.K + k) : 1.f;
              const float sg = sig[u][h];
              float4 A = acc[p];
              if (mode == kSingle) {
                A = make_float4(o[u][h][0], o[u][h][1], o[u][h][2], sg);
              } else if (mode == kSigmaBlend) {
                const float ws = __fmul_rn(wk, sg);
                A.x = __fadd_rn(A.x, __fmul_rn(ws, o[u][h][0]));
                A.y = __fadd_rn(A.y, __fmul_rn(ws, o[u][h][1]));
                A.z = __fadd_rn(A.z, __fmul_rn(ws, o[u][h][2]));
                A.w = __fadd_rn(A.w, ws);
              } else if (mode == kLinearBlend) {
                A.x = __fadd_rn(A.x, __fmul_rn(wk, o[u][h][0]));
                A.y = __fadd_rn(A.y, __fmul_rn(wk, o[u][h][1]));
                A.z = __fadd_rn(A.z, __fmul_rn(wk, o[u][h][2]));
                A.w = __fadd_rn(A.w, __fmul_rn(wk, sg));
              } else {
                A.w = net.w != nullptr ? __fadd_rn(A.w, __fmul_rn(wk, sg)) : sg;
              }
              acc[p] = A;
            }
          }
        }
      }
    }
    __syncthreads();  // every expert's adds are in
    write_slab(net, mode, base, n_here, acc);
  }
  cp_wait_all();
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
  return 4 * (size_t)(shape_floats(net.nl) + 4 * net.nslots + net.land + net.split) +
         4 * (size_t)S * (net.ES + 4) + 4 * (size_t)(S / 32) + 2 * (size_t)S;
}

// The weight buffers and the slab: what fits in the block's shared memory,
// or less where a call has fewer points than a full slab for each of the
// sms. The classes keep an expert's whole split image (or, streamed, one
// layer at a time); the wide path one slice, and sizes its scratch row.
// Returns the bytes of shared memory of a full slab (the most a launch of
// this net takes), or 0.
size_t plan(Net& net, int smem_max, int sms) {
  std::vector<Shape> shapes(net.nl);
  layer_shapes(net, shapes.data());
  int limage = 0, fimage = 0, lslot = 0, fslot = 0, kw = 0;
  for (const Shape& s : shapes) {
    const int lf = 8 * s.kt * s.ds + 8 * s.nt, ff = 128 * s.kt * s.nt + 8 * s.nt;
    limage += lf;
    fimage += ff;
    lslot = lf > lslot ? lf : lslot;
    fslot = ff > fslot ? ff : fslot;
    kw = s.kt > kw ? s.kt : kw;
    kw = s.nt > kw ? s.nt : kw;
  }
  const int density = net.mode == kDensity;
  net.ES = density ? 0 : 8 * tiles8(1 + kGeo + net.enc_dim) - 16 + 2;
  const size_t per_point = 4 * (size_t)(net.ES + 4) + 2 + 1;  // enc, acc, list, ballot
  const long long cap = net.W == 0 ? kWideSlabMax : kSlabMax;
  auto slab_beside = [&](int wfloats) -> long long {
    const size_t wbytes = 4 * (size_t)(wfloats + shape_floats(net.nl) + 4 * net.nslots);
    if (wbytes + 32 * per_point > (size_t)smem_max) return 0;
    long long S = (long long)(((size_t)smem_max - wbytes) / per_point) / 32 * 32;
    return S < cap ? S : cap;
  };
  net.streamed = 0;
  long long S;
  if (net.W == 0) {
    net.land = kSliceLand;
    net.split = kSliceSplit;
    net.KW = kw;
    net.scratch_block = 2LL * kPassTiles * kw * 128;
    S = slab_beside(kSliceLand + kSliceSplit);
  } else {
    net.land = limage;
    net.split = fimage;
    S = slab_beside(limage + fimage);
    if (S < kSlabMin && slab_beside(lslot + fslot) > S) {  // too small a slab beside an expert
      net.streamed = 1;
      net.land = lslot;
      net.split = fslot;
      S = slab_beside(lslot + fslot);
    }
  }
  if (S == 0) return 0;
  const size_t full = slab_bytes(net, S);
  if (net.W == 0) {  // whole rounds of slabs over the blocks (one an SM): no tail round
    const long long rounds = (net.P + S * sms - 1) / (S * sms);
    const long long even = ((net.P + rounds * sms - 1) / (rounds * sms) + 31) / 32 * 32;
    if (even < S) S = even;
  }
  long long fill = ((net.P + sms - 1) / sms + 31) / 32 * 32;
  if (fill < kSlabMin) fill = kSlabMin;
  if (fill < S) S = fill;
  net.S = (int)S;
  net.slabs = (net.P + S - 1) / S;
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

// The wide path's grid: its scratch takes net.scratch_block floats a block.
int wide_grid(Net& net, long long& grid) {
  static size_t set_for[64];
  static int blocks_for[64];
  return grid_of(net, ngp_net_wide_kernel, threads_for(0), set_for, blocks_for, grid);
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

// The scratch bytes a launch of ngp_net_fwd with these arguments needs
// (0 where the network takes a class; the wide path's block count times
// its two activation buffers), or -1 (a CUDA error code's negation below).
long long ngp_net_scratch_bytes(int mode, const int* dims, int K, long long P) {
  Net net;
  int err = make_net(net, mode, nullptr, 0, nullptr, dims, K, P);
  if (err) return -(long long)err;
  if (net.W != 0 || P == 0) return 0;
  long long grid = 0;
  err = wide_grid(net, grid);
  if (err) return -(long long)err;
  return 4 * grid * net.scratch_block;
}

// mode: 0 single, 1 sigma_blend, 2 linear_blend, 3 density. h: the K
// experts' features, expert k's (P, L*F) rows at h + k * h_stride floats;
// layers: a device array of K * (sigma_depth + color_depth + 3) (w, b)
// pointer pairs, each expert's trunk, sigma, geo and colour layers (the
// last one included) in turn; dims: L*F, hidden, sigma_depth, color_hidden,
// color_depth, dir kind (0 SH, 1 frequency), SH levels or bands, sigmoid;
// scratch: ngp_net_scratch_bytes' bytes (the wide path). Returns a CUDA
// error code (0: launched).
int ngp_net_fwd(int mode, const void* h, long long h_stride, const void* layers, const int* dims,
                int K, long long P, const void* dirs, long long dir_stride, const void* w,
                void* rgb, long long rgb_stride, void* sigma, long long sigma_stride,
                void* scratch, long long scratch_bytes, void* stream) {
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
    if (scratch == nullptr || scratch_bytes < 4 * grid * net.scratch_block)
      return (int)cudaErrorInvalidValue;
    net.scratch = static_cast<float*>(scratch);
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
