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
// Bound: operations. At the smoke's widths (L*F 32, hidden 64, depth 2,
// colour 64 deep 2, SH 4 levels) a point costs 13,440 multiply-adds per
// expert; the bytes per point (K * 32 features, d, w, 4 outputs) are a few
// hundred. At 67 TFLOP/s f32 a serving chunk of 983,040 points and 4 experts
// takes at least 1.58 ms, its bytes 0.15 ms at 3.35 TB/s.
//
// Design, all f32 on the FMA pipes (tensor cores are a later redesign). A
// block of kThreads threads takes kThreads * PTS points, PTS points a
// thread (2 at widths up to 64, 1 at 128). For each expert it stages one
// layer at a time into shared memory, its weights as rows of the layer's
// padded width (W, the widths' class 32, 64 or 128, zeros past the layer's
// own width: a zero unit stays zero through ReLU and feeds nothing), and the
// thread multiplies its points' activations into W accumulators in
// registers: for each input i, one read of each point's activation and W / 4
// float4 reads of the weight row, which every lane of the warp reads at one
// address (a broadcast), so a float4 read feeds 4 * PTS FMAs. The points'
// activations live in shared memory as one row per point (a row stride
// that is odd, so a warp's reads fall in 32 banks), which lets every input
// count be a runtime loop: only the outputs are unrolled. The hash features
// come in with one coalesced copy of the block's contiguous rows; the
// concatenation [g, e] is a place in the row, not a copy. The sigma and geo
// heads are one staged layer of 16 columns, the last colour layer one of 4.
//
// Blends loop over the experts inside the block, adding into each point's
// accumulators in registers. An expert whose routing weight is 0 at every
// point of the block is skipped (its layers are neither staged nor run), and
// a warp whose 32 * PTS points all have weight 0 skips the arithmetic: the
// plain version adds 0 * y for them, and 0 * y is 0 for every finite y
// (trunc_exp caps s at exp(88), the sigmoid's c lies in [0, 1]). With the
// hard one-hot routing of boundary margin 1 this runs one expert a point
// where the plain version runs K.
//
// Bits. The matrix products sum in their own order (as cuBLAS does against
// the CPU) with fused multiply-adds, and the bias is added after the sum,
// as (x @ w) + b adds it. The direction's normalisation and its encoding
// round every step as PyTorch's eager ops do (__fmul_rn / __fadd_rn /
// __fdiv_rn, no contraction), normalising twice on the SH path as
// enc_dir and sh_encode do; the blends take w * s and (w * s) * c as two
// rounded products, as the plain version does.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxExperts = 16;
constexpr int kMaxDepth = 4;
constexpr int kMaxWidth = 128;
constexpr int kMaxIn = 64;  // L*F, and geo + direction encoding
constexpr int kGeo = 15;
constexpr int kHeads = 16;  // sigma + geo, staged as one layer
constexpr int kOut = 4;     // the last colour layer's 3, padded
constexpr int kThreads = 128;
constexpr int kSlots = kMaxDepth + 2 + kMaxDepth + 1;  // layers per expert

enum Mode { kSingle = 0, kSigmaBlend = 1, kLinearBlend = 2, kDensity = 3 };

struct Layer {
  const float* w;  // (in, out) row-major, as the port stores it
  const float* b;  // (out,)
};

struct Expert {
  const float* h;  // (P, L*F)
  Layer trunk[kMaxDepth];
  Layer sigma, geo;
  Layer color[kMaxDepth + 1];
};

// Passed by value in the kernel's parameter space (under 4 KB), read in
// place (__grid_constant__: a runtime index into it makes no local copy).
struct Net {
  Expert e[kMaxExperts];
  const float* dirs;  // (P, >= 3) rows dir_stride apart
  const float* w;     // (P, K) routing weights, or null
  float* rgb;         // rows rgb_stride apart, or null
  float* sigma;       // rows sigma_stride apart
  long long P, dir_stride, rgb_stride, sigma_stride;
  int K, in_dim, hidden, sigma_depth, color_hidden, color_depth;
  int dir_kind, dir_param, sigmoid, enc_dim;
  int wrows;       // rows of the weight buffer
  int act_stride;  // floats per point row of activations (odd)
};

// ------------------------------------------------------------------ staging

// Rows [0, in) of a layer of OUTP padded columns into sw (row stride OUTP)
// and its bias into sb: the columns of part a, then those of part b (the
// heads), zeros after.
template <int OUTP>
__device__ __forceinline__ void stage(float* sw, float* sb, int in, Layer a, int na,
                                      Layer b, int nb) {
  for (int e = threadIdx.x; e < in * OUTP; e += kThreads) {
    const int i = e / OUTP, j = e - i * OUTP;
    float v = 0.f;
    if (j < na) v = __ldg(a.w + (long long)i * na + j);
    else if (j - na < nb) v = __ldg(b.w + (long long)i * nb + (j - na));
    sw[e] = v;
  }
  for (int j = threadIdx.x; j < OUTP; j += kThreads) {
    float v = 0.f;
    if (j < na) v = __ldg(a.b + j);
    else if (j - na < nb) v = __ldg(b.b + (j - na));
    sb[j] = v;
  }
}

template <int OUTP>
__device__ __forceinline__ void stage(float* sw, float* sb, int in, Layer a, int na) {
  stage<OUTP>(sw, sb, in, a, na, Layer{nullptr, nullptr}, 0);
}

// ------------------------------------------------------------------ layers

// y[q][j] = sum_i act_q[i] * W[i][j] + b[j] for the thread's PTS points,
// act_q the point's row (q * kThreads * S floats past the thread's first).
template <int OUT, int PTS>
__device__ __forceinline__ void dense(const float* a, int S, int in, const float* sw,
                                      const float* sb, float (&y)[PTS][OUT]) {
#pragma unroll
  for (int q = 0; q < PTS; ++q)
#pragma unroll
    for (int j = 0; j < OUT; ++j) y[q][j] = 0.f;
#pragma unroll 2
  for (int i = 0; i < in; ++i) {
    float x[PTS];
#pragma unroll
    for (int q = 0; q < PTS; ++q) x[q] = a[q * kThreads * S + i];
    const float4* r = reinterpret_cast<const float4*>(sw + i * OUT);
#pragma unroll
    for (int j = 0; j < OUT / 4; ++j) {
      const float4 v = r[j];
#pragma unroll
      for (int q = 0; q < PTS; ++q) {
        y[q][4 * j + 0] = fmaf(x[q], v.x, y[q][4 * j + 0]);
        y[q][4 * j + 1] = fmaf(x[q], v.y, y[q][4 * j + 1]);
        y[q][4 * j + 2] = fmaf(x[q], v.z, y[q][4 * j + 2]);
        y[q][4 * j + 3] = fmaf(x[q], v.w, y[q][4 * j + 3]);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < PTS; ++q)
#pragma unroll
    for (int j = 0; j < OUT; ++j) y[q][j] = __fadd_rn(y[q][j], sb[j]);
}

// relu(y) into the point rows
template <int OUT, int PTS>
__device__ __forceinline__ void store_relu(float* a, int S, const float (&y)[PTS][OUT]) {
#pragma unroll
  for (int q = 0; q < PTS; ++q)
#pragma unroll
    for (int j = 0; j < OUT; ++j) a[q * kThreads * S + j] = fmaxf(y[q][j], 0.f);
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

// ------------------------------------------------------------------ kernel

template <int MODE, int W, int PTS>
__global__ void __launch_bounds__(kThreads) ngp_net_kernel(const __grid_constant__ Net net) {
  extern __shared__ __align__(16) float smem[];
  float* sw = smem;                    // weights: wrows x W
  float* sb = smem + net.wrows * W;    // bias: W
  float* act = sb + W;                 // point rows: kThreads * PTS x S
  const int S = net.act_stride;
  const int t = threadIdx.x;
  constexpr int NP = kThreads * PTS;
  const long long base = (long long)blockIdx.x * NP;
  const int n_here = (int)min((long long)NP, net.P - base);
  float* a = act + t * S;
  constexpr bool kBlend = MODE == kSigmaBlend || MODE == kLinearBlend || MODE == kDensity;
  const bool weighted = kBlend && net.w != nullptr;

  bool valid[PTS];
  long long p[PTS];
#pragma unroll
  for (int q = 0; q < PTS; ++q) {
    p[q] = base + q * kThreads + t;
    valid[q] = p[q] < net.P;
  }
  float dir[PTS][3];
  if (MODE != kDensity) {
#pragma unroll
    for (int q = 0; q < PTS; ++q)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        dir[q][c] = valid[q] ? __ldg(net.dirs + p[q] * net.dir_stride + c) : 0.f;
  }
  // per point: [c, s] (single), accumulators of the blends
  float acc[PTS][4];
#pragma unroll
  for (int q = 0; q < PTS; ++q)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[q][c] = 0.f;

  for (int k = 0; k < net.K; ++k) {
    float wk[PTS];
    bool mine = false;
#pragma unroll
    for (int q = 0; q < PTS; ++q) {
      wk[q] = !valid[q] ? 0.f : weighted ? __ldg(net.w + p[q] * net.K + k) : 1.f;
      mine |= wk[q] != 0.f;
    }
    // also the barrier after the previous expert's last reads
    if (!__syncthreads_or(mine)) continue;
    const bool on = __any_sync(0xffffffffu, mine);
    const Expert& e = net.e[k];

    // the block's feature rows (contiguous in h) into the point rows
    {
      const int in = net.in_dim;
      const float* src = e.h + base * in;
      for (int i = t; i < NP * in; i += kThreads) {
        const int r = i / in, c = i - r * in;
        act[r * S + c] = r < n_here ? __ldg(src + i) : 0.f;
      }
      stage<W>(sw, sb, in, e.trunk[0], net.hidden);
    }
    __syncthreads();

    float y[PTS][W];
    for (int l = 0; l < net.sigma_depth; ++l) {
      if (on) dense<W, PTS>(a, S, l == 0 ? net.in_dim : net.hidden, sw, sb, y);
      __syncthreads();
      if (l + 1 < net.sigma_depth) stage<W>(sw, sb, net.hidden, e.trunk[l + 1], net.hidden);
      else stage<kHeads>(sw, sb, net.hidden, e.sigma, 1, e.geo, kGeo);
      if (on) store_relu<W, PTS>(a, S, y);
      __syncthreads();
    }

    float sig[PTS];
    {
      float hd[PTS][kHeads];
      if (on) {
        dense<kHeads, PTS>(a, S, net.hidden, sw, sb, hd);
#pragma unroll
        for (int q = 0; q < PTS; ++q) {
          sig[q] = expf(fminf(fmaxf(hd[q][0], -88.f), 88.f));  // trunc_exp
          if (MODE == kDensity) {
            acc[q][3] = weighted ? __fadd_rn(acc[q][3], __fmul_rn(wk[q], sig[q])) : sig[q];
          } else {
            float* row = a + q * kThreads * S;
#pragma unroll
            for (int j = 0; j < kGeo; ++j) row[j] = hd[q][1 + j];
            encode_dir(dir[q][0], dir[q][1], dir[q][2], net.dir_kind, net.dir_param,
                       row + kGeo);
          }
        }
      }
    }
    if (MODE == kDensity) continue;

    __syncthreads();
    stage<W>(sw, sb, kGeo + net.enc_dim, e.color[0], net.color_hidden);
    __syncthreads();
    for (int c = 0; c < net.color_depth; ++c) {
      if (on) dense<W, PTS>(a, S, c == 0 ? kGeo + net.enc_dim : net.color_hidden, sw, sb, y);
      __syncthreads();
      if (c + 1 < net.color_depth)
        stage<W>(sw, sb, net.color_hidden, e.color[c + 1], net.color_hidden);
      else stage<kOut>(sw, sb, net.color_hidden, e.color[net.color_depth], 3);
      if (on) store_relu<W, PTS>(a, S, y);
      __syncthreads();
    }
    if (on) {
      float o[PTS][kOut];
      dense<kOut, PTS>(a, S, net.color_hidden, sw, sb, o);
#pragma unroll
      for (int q = 0; q < PTS; ++q) {
        float rgb[3];
#pragma unroll
        for (int c = 0; c < 3; ++c)
          rgb[c] = net.sigmoid ? 1.f / (1.f + expf(-o[q][c])) : o[q][c];
        if (MODE == kSingle) {
#pragma unroll
          for (int c = 0; c < 3; ++c) acc[q][c] = rgb[c];
          acc[q][3] = sig[q];
        } else if (MODE == kSigmaBlend) {
          const float ws = __fmul_rn(wk[q], sig[q]);
#pragma unroll
          for (int c = 0; c < 3; ++c) acc[q][c] = __fadd_rn(acc[q][c], __fmul_rn(ws, rgb[c]));
          acc[q][3] = __fadd_rn(acc[q][3], ws);
        } else {  // kLinearBlend
#pragma unroll
          for (int c = 0; c < 3; ++c) acc[q][c] = __fadd_rn(acc[q][c], __fmul_rn(wk[q], rgb[c]));
          acc[q][3] = __fadd_rn(acc[q][3], __fmul_rn(wk[q], sig[q]));
        }
      }
    }
  }

#pragma unroll
  for (int q = 0; q < PTS; ++q) {
    if (!valid[q]) continue;
    if (MODE == kSigmaBlend) {
      const float s = fmaxf(acc[q][3], 1e-12f);
#pragma unroll
      for (int c = 0; c < 3; ++c) net.rgb[p[q] * net.rgb_stride + c] = __fdiv_rn(acc[q][c], s);
      net.sigma[p[q] * net.sigma_stride] = s;
    } else {
      if (MODE != kDensity) {
#pragma unroll
        for (int c = 0; c < 3; ++c) net.rgb[p[q] * net.rgb_stride + c] = acc[q][c];
      }
      net.sigma[p[q] * net.sigma_stride] = acc[q][3];
    }
  }
}

template <int MODE, int W>
int launch(const Net& net, cudaStream_t stream) {
  constexpr int PTS = W <= 64 ? 2 : 1;
  const size_t smem =
      sizeof(float) * ((size_t)net.wrows * W + W + (size_t)kThreads * PTS * net.act_stride);
  cudaError_t err = cudaFuncSetAttribute(ngp_net_kernel<MODE, W, PTS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (net.P + kThreads * PTS - 1) / (kThreads * PTS);
  ngp_net_kernel<MODE, W, PTS><<<(unsigned)blocks, kThreads, smem, stream>>>(net);
  return (int)cudaGetLastError();
}

template <int MODE>
int launch_width(const Net& net, int width, cudaStream_t stream) {
  if (width <= 32) return launch<MODE, 32>(net, stream);
  if (width <= 64) return launch<MODE, 64>(net, stream);
  return launch<MODE, 128>(net, stream);
}

}  // namespace

extern "C" {

// The limits the Python wrapper checks against its own.
void ngp_net_limits(int* out) {
  out[0] = kMaxExperts;
  out[1] = kMaxDepth;
  out[2] = kMaxWidth;
  out[3] = kMaxIn;
  out[4] = kGeo;
}

// mode: 0 single, 1 sigma_blend, 2 linear_blend, 3 density. h: K feature
// pointers; layers: K * kSlots (w, b) pairs in the order trunk[kMaxDepth],
// sigma, geo, color[kMaxDepth + 1], unused slots null; dims: L*F, hidden,
// sigma_depth, color_hidden, color_depth, dir kind (0 SH, 1 frequency), SH
// levels or bands, sigmoid. Returns a CUDA error code (0: launched).
int ngp_net_fwd(int mode, const void* const* h, const void* const* layers, const int* dims,
                int K, long long P, const void* dirs, long long dir_stride, const void* w,
                void* rgb, long long rgb_stride, void* sigma, long long sigma_stride,
                void* stream) {
  if (K < 1 || K > kMaxExperts || P < 0) return (int)cudaErrorInvalidValue;
  Net net = {};
  net.K = K;
  net.in_dim = dims[0];
  net.hidden = dims[1];
  net.sigma_depth = dims[2];
  net.color_hidden = dims[3];
  net.color_depth = dims[4];
  net.dir_kind = dims[5];
  net.dir_param = dims[6];
  net.sigmoid = dims[7];
  net.enc_dim = net.dir_kind == 0 ? net.dir_param * net.dir_param : 3 * (2 * net.dir_param + 1);
  if (net.in_dim < 1 || net.in_dim > kMaxIn || net.hidden < 1 || net.hidden > kMaxWidth ||
      net.color_hidden < 1 || net.color_hidden > kMaxWidth || net.sigma_depth < 1 ||
      net.sigma_depth > kMaxDepth || net.color_depth < 1 || net.color_depth > kMaxDepth ||
      kGeo + net.enc_dim > kMaxIn || (net.dir_kind == 0 && net.dir_param > 5))
    return (int)cudaErrorInvalidValue;
  const void* const* L = layers;
  for (int k = 0; k < K; ++k, L += 2 * kSlots) {
    Expert& e = net.e[k];
    e.h = static_cast<const float*>(h[k]);
    auto at = [&](int slot) {
      return Layer{static_cast<const float*>(L[2 * slot]),
                   static_cast<const float*>(L[2 * slot + 1])};
    };
    for (int l = 0; l < kMaxDepth; ++l) e.trunk[l] = at(l);
    e.sigma = at(kMaxDepth);
    e.geo = at(kMaxDepth + 1);
    for (int c = 0; c <= kMaxDepth; ++c) e.color[c] = at(kMaxDepth + 2 + c);
  }
  net.dirs = static_cast<const float*>(dirs);
  net.w = static_cast<const float*>(w);
  net.rgb = static_cast<float*>(rgb);
  net.sigma = static_cast<float*>(sigma);
  net.P = P;
  net.dir_stride = dir_stride;
  net.rgb_stride = rgb_stride;
  net.sigma_stride = sigma_stride;
  const int width = net.hidden > net.color_hidden ? net.hidden : net.color_hidden;
  const int W = width <= 32 ? 32 : width <= 64 ? 64 : 128;
  int rows = net.in_dim;
  if (W > rows) rows = W;
  if (kGeo + net.enc_dim > rows) rows = kGeo + net.enc_dim;
  net.wrows = rows;
  net.act_stride = rows | 1;
  if (P == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kSingle: return launch_width<kSingle>(net, width, s);
    case kSigmaBlend: return launch_width<kSigmaBlend>(net, width, s);
    case kLinearBlend: return launch_width<kLinearBlend>(net, width, s);
    case kDensity: return launch_width<kDensity>(net, width, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
