// Segmented exclusive prefix sum over a packed float32 buffer, for sm_90a:
// one pass, chained tiles with decoupled look-back, forward and reverse.
//
//   forward: out[i] = sum of x[j] for j < i in the same segment
//   reverse: out[i] = sum of x[j] for j > i in the same segment
//
// A segment starts wherever flag[i] != 0 (flag[0] must be set). The reverse
// mode is the forward scan's transpose, so it is the backward pass: it reads
// the cotangent and the same flags as they lie and writes the gradient as it
// lies (no flipped or shifted copies).
//
// Replaces the TPU kernel `_seg_excl_sum_pallas` / `_seg_scan_kernel` in
// acn_tpu/ops/segscan.py (pallas_call at segscan.py:180; its backward,
// `_bwd` at :251, is the same kernel on the reversed cotangent). Bound to
// PyTorch through a plain C interface (ctypes) in
// acn_tpu_torch/ops/segscan.py. No library scan is called.
//
// Bound. Pure memory traffic: at least 9 bytes per element (4 B read of x,
// 1 B read of the flag, 4 B write of out) and one add. At the serving shape
// B = 983,040 that is 8.8 MB, 2.64 us at the H100's 3.35 TB/s. This kernel
// moves those 9 bytes and little else: x and the flags are read once.
//
// Design. The TPU kernel carries the open segment's running sum from one
// grid step to the next in SMEM, which is legal only because that grid runs
// in order. Hopper's blocks run in parallel and in no order, so here every
// block
//   1. takes a tile by an atomic ticket;
//   2. loads kItems neighbouring elements per thread (16-byte loads of x,
//      one vector load of the flag bytes) and scans them in registers,
//      then across the warp by shuffles and across warps through shared
//      memory;
//   3. publishes the tile's state in one 64-bit word (below);
//   4. looks back, with one warp, 32 predecessors at a time, for the carry
//      that enters the tile, and publishes the tile's inclusive prefix;
//   5. writes inclusive - x from the registers it already holds. The carry
//      reaches only the elements before the tile's first boundary, so a
//      warp that holds none of them stores without waiting for step 4.
// The tile is 512 threads x 8 elements, chosen on the card among 128..1024
// threads x 4..16 elements (scripts/bench_segscan.py): the serving chunk is
// then 240 blocks of 36 registers a thread, one wave of the 132 SMs. With 4
// elements a thread the scan is 0.2 us faster on short segments, but only
// while it compiles to at most 32 registers (above that the chunk no
// longer fits one wave), and it is slower on a chunk with a pad tail and
// at large sizes; with 16 the loads of neighbouring threads lie 64 bytes
// apart and the serving chunk takes a microsecond longer.
// Segmented combine (associative, not commutative):
//   (va, fa) . (vb, fb) = (fb ? vb : va + vb, fa | fb)
// Sums never cross a boundary, so the error of an element stays at the
// scale of its own segment's sum (never a global prefix minus a base).
//
// Tile state: one 8-byte word, low half the f32 value, high half
//   (epoch << 3) | (has_boundary << 2) | status,  status = invalid(0),
//   aggregate(1) or prefix(2).
// Value, boundary bit and status travel in one aligned 64-bit store and one
// 64-bit load, so a reader never sees a value without its status. Nothing
// else is communicated through a state, so the accesses need no ordering
// against other memory: they are gpu-scope relaxed (served by L2, never by
// a stale L1 line). Compile with -DSEGSCAN_ACQ_REL=1 for st.release /
// ld.acquire instead: it computes the same and was measured 1.0 to 1.3 us
// slower at the serving shape (the release is a fence on every tile's
// critical path).
//
// The segmented look-back stops early. A tile that holds a boundary has its
// own aggregate as its inclusive prefix whatever came before, so it
// publishes `prefix` at once; and a predecessor whose aggregate has the
// boundary bit ends the look-back. Rays hold at most 256 samples and a tile
// 4,096 elements, so among a serving chunk's rays every tile holds a
// boundary and the look-back reads one word. The pad slots that end a
// chunk are one segment of many tiles, and one segment over the whole
// buffer is the extreme: there the look-back sums aggregates back to the
// nearest published prefix, 32 states per step, and every warp waits for
// it. (As in every chained float scan,
// the grouping of that sum depends on which predecessors had published a
// prefix by then, so results in segments that span many tiles may differ
// by rounding from launch to launch; segments shorter than a tile are
// deterministic.)
//
// Tickets, not blockIdx.x. A block that spins on a predecessor's state
// deadlocks if that predecessor has not been scheduled and cannot be until
// the spinning block retires. The hardware does not promise to start blocks
// in blockIdx order, so tiles are handed out in order of arrival by
// atomicAdd on a counter: the holder of ticket t waits only for tickets
// below t, whose holders are running. A grid larger than the card holds at
// once is therefore safe. In reverse mode ticket t takes the t-th tile from
// the end.
//
// Reset between launches: none is launched. The scratch (a 16-byte header
// and the state words) is allocated and zeroed once per device and stream
// by the wrapper and then kept. The header's first 64-bit word holds the
// launch's epoch in its high half and the next ticket in its low half, so
// the one atomicAdd that hands a block its tile also tells it the epoch.
// Every state carries the epoch of the launch that wrote it, and a state of
// another epoch reads as invalid. The block that draws the last ticket
// knows that no other block will touch that word in this launch, and
// stores (epoch + 1, ticket 0) for the next launch on that stream, which
// starts after this one ends. So the reset costs one store by one thread,
// off every block's critical path. The epoch lives on the device and not
// in the wrapper so that a failed launch changes nothing and a launch
// replayed from a CUDA graph still finds the right epoch.
// Only the launch whose epoch is the last before the 29-bit epoch wraps
// (one in 2^29) counts its finished blocks in the header's `done` word; the
// last to finish zeroes every state word and stores epoch 0, so a state
// left from 2^29 launches ago cannot be taken for a new one. Two scans in
// flight on two streams use two scratch buffers and share nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef SEGSCAN_THREADS
#define SEGSCAN_THREADS 512
#endif
#ifndef SEGSCAN_ITEMS
#define SEGSCAN_ITEMS 8
#endif
#ifndef SEGSCAN_ACQ_REL
#define SEGSCAN_ACQ_REL 0
#endif

namespace {

constexpr int kThreads = SEGSCAN_THREADS;
constexpr int kItems = SEGSCAN_ITEMS;  // neighbouring elements per thread
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kItems == 4 || kItems == 8 || kItems == 16,
              "the flag bytes of a thread are one 4-, 8- or 16-byte load");
static_assert(kThreads % 32 == 0 && kWarps <= 32, "a warp scans the warp totals");

// the scratch buffer: a 64-bit word (epoch << 32 | next ticket), the 32-bit
// count of finished blocks, a pad; the state words follow at byte 16
constexpr int kHeaderBytes = 16;
constexpr uint32_t kInvalid = 0, kAggregate = 1, kPrefix = 2;
constexpr uint32_t kStatusMask = 3, kBoundaryBit = 4, kEpochShift = 3;
constexpr uint32_t kEpochMax = (1u << (32 - kEpochShift)) - 1;

// (va, fa) . (vb, fb), written into (vb, fb).
__device__ __forceinline__ void combine(float va, int fa, float& vb, int& fb) {
  vb = fb ? vb : va + vb;
  fb = fa | fb;
}

__device__ __forceinline__ uint64_t pack_state(uint32_t epoch, uint32_t status,
                                               int boundary, float v) {
  const uint32_t meta = (epoch << kEpochShift) | (boundary ? kBoundaryBit : 0u) | status;
  return ((uint64_t)meta << 32) | __float_as_uint(v);
}

__device__ __forceinline__ void store_state(uint64_t* p, uint64_t w) {
#if SEGSCAN_ACQ_REL
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(w) : "memory");
#else
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(w) : "memory");
#endif
}

__device__ __forceinline__ uint64_t load_state(const uint64_t* p) {
  uint64_t w;
#if SEGSCAN_ACQ_REL
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(w) : "l"(p) : "memory");
#else
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(w) : "l"(p) : "memory");
#endif
  return w;
}

// The carry entering `tile` (> 0): the segmented sum of its predecessors'
// states, nearest first, 32 at a time, by one whole warp. Lane l reads the
// state of tile hi - l and spins while it is invalid. The window ends at
// the nearest state that is terminal: a prefix, an aggregate with the
// boundary bit, or the place before tile 0 (an empty prefix). The states
// nearer than that are aggregates without a boundary, so the segmented
// reduction of the window is the plain sum of its values. (Four states per
// lane and step were measured too: more registers, and no faster even on
// one segment over the whole buffer.)
__device__ float look_back(const uint64_t* states, uint32_t tile,
                           uint32_t epoch, int lane) {
  float carry = 0.f;  // sum of the windows folded in so far (the nearer ones)
  for (int64_t hi = (int64_t)tile - 1;; hi -= 32) {
    const int64_t idx = hi - lane;
    bool valid = idx < 0, terminal = idx < 0;
    float val = 0.f;
    unsigned tmask, need;
    while (true) {
      if (!valid) {
        const uint64_t w = load_state(states + idx);
        const uint32_t meta = (uint32_t)(w >> 32);
        const uint32_t status = meta & kStatusMask;
        valid = (meta >> kEpochShift) == epoch && status != kInvalid;
        terminal = valid && (status == kPrefix || (meta & kBoundaryBit));
        val = __uint_as_float((uint32_t)w);
      }
      tmask = __ballot_sync(kFull, terminal);
      const unsigned vmask = __ballot_sync(kFull, valid);
      // lanes up to the nearest terminal one (all 32 when there is none)
      need = tmask ? (2u << (__ffs(tmask) - 1)) - 1u : kFull;
      if ((vmask & need) == need) break;
    }
    float s = ((need >> lane) & 1u) ? val : 0.f;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) s += __shfl_xor_sync(kFull, s, d);
    carry = s + carry;
    if (tmask) return carry;
  }
}

// The flag bytes of kN neighbouring elements as a bit mask (bit j: the
// byte of element j is non-zero), by one aligned vector load.
template <int kN>
__device__ __forceinline__ uint32_t load_flag_mask(const uint8_t* p) {
  uint32_t w[kN / 4];
  if constexpr (kN == 16) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    w[0] = q.x, w[1] = q.y, w[2] = q.z, w[3] = q.w;
  } else if constexpr (kN == 8) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    w[0] = q.x, w[1] = q.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
  uint32_t m = 0;
#pragma unroll
  for (int j = 0; j < kN; ++j)
    m |= (uint32_t)(((w[j / 4] >> (8 * (j % 4))) & 0xffu) != 0u) << j;
  return m;
}

// One tile per block. Thread t holds kItems neighbouring elements, xs[j] at
// index base + j. The scan runs over a logical order (thread, item): in
// forward mode that is the order in memory; in reverse mode thread t holds
// the t-th chunk from the tile's end and walks its items downwards, so the
// same block scan, state words and look-back serve both directions.
// Bit j of `fm` says that a segment starts, in scan order, at element
// base + j: flag[base + j] forward; flag[base + j + 1] (or the buffer's
// end) in reverse. Elements past n are segments of their own of value 0.
template <bool kReverse>
__global__ void __launch_bounds__(kThreads)
seg_scan_kernel(const float* __restrict__ x, const uint8_t* __restrict__ flag,
                float* __restrict__ out, int64_t n, uint32_t tiles,
                unsigned long long* ticket_word, uint32_t* done,
                uint64_t* states, int64_t capacity) {
  __shared__ uint32_t s_tile, s_epoch;
  __shared__ float s_v[kWarps];
  __shared__ int s_f[kWarps];
  __shared__ float s_carry;
  __shared__ volatile int s_ready;  // s_carry is written
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (tid == 0) {
    s_ready = 0;
    const unsigned long long t = atomicAdd(ticket_word, 1ull);
    s_tile = (uint32_t)t;
    s_epoch = (uint32_t)(t >> 32);
    // the last ticket: every other block has drawn, the word is ours
    if ((uint32_t)t == tiles - 1 && (uint32_t)(t >> 32) != kEpochMax)
      *ticket_word = ((t >> 32) + 1) << 32;
  }
  __syncthreads();
  const uint32_t tile = s_tile, epoch = s_epoch;
  const int64_t tile_base = (int64_t)(kReverse ? tiles - 1 - tile : tile) * kTile;
  const int64_t base = tile_base + (int64_t)(kReverse ? kThreads - 1 - tid : tid) * kItems;

  // A full tile of aligned buffers takes 16-byte loads and stores; the tail
  // tile, and every tile of a buffer that is not aligned (a view at an
  // offset), takes the scalar path.
  const bool vec = tile_base + kTile <= n &&
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) & 15u) == 0 &&
      (reinterpret_cast<uintptr_t>(flag) & (kItems - 1)) == 0;
  float xs[kItems];
  uint32_t fm = 0;
  if (vec) {
#pragma unroll
    for (int q = 0; q < kItems / 4; ++q) {
      const float4 t = reinterpret_cast<const float4*>(x + base)[q];
      xs[4 * q] = t.x, xs[4 * q + 1] = t.y, xs[4 * q + 2] = t.z, xs[4 * q + 3] = t.w;
    }
    fm = load_flag_mask<kItems>(flag + base);
    if (kReverse) {
      const uint32_t next = base + kItems < n ? flag[base + kItems] != 0 : 1u;
      fm = (fm >> 1) | (next << (kItems - 1));
    }
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int64_t i = base + j, fi = kReverse ? i + 1 : i;
      xs[j] = i < n ? x[i] : 0.f;
      fm |= (fi < n ? (uint32_t)(flag[fi] != 0) : 1u) << j;
    }
  }

  // inclusive scan of this thread's items in scan order
  float v[kItems];
  float tv = 0.f;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int j = kReverse ? kItems - 1 - k : k;
    tv = ((fm >> j) & 1u) ? xs[j] : tv + xs[j];
    v[j] = tv;
  }
  int tf = fm != 0;

  // inclusive warp scan of the per-thread aggregates
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float ov = __shfl_up_sync(kFull, tv, d);
    const int of = __shfl_up_sync(kFull, tf, d);
    if (lane >= d) combine(ov, of, tv, tf);
  }
  if (lane == 31) {
    s_v[warp] = tv;
    s_f[warp] = tf;
  }
  __syncthreads();

  // Every warp scans the warp totals for itself (a few shuffles, and no
  // second barrier): the entry before its own is what precedes the warp in
  // the tile, the last entry is the tile's aggregate.
  float wv = lane < kWarps ? s_v[lane] : 0.f;
  int wf = lane < kWarps ? s_f[lane] : 0;
#pragma unroll
  for (int d = 1; d < kWarps; d <<= 1) {
    const float ov = __shfl_up_sync(kFull, wv, d);
    const int of = __shfl_up_sync(kFull, wf, d);
    if (lane >= d) combine(ov, of, wv, wf);
  }
  // what precedes this thread in the tile: (earlier warps) . (earlier lanes);
  // (0, 0) is the identity of the combine
  float pv = __shfl_up_sync(kFull, tv, 1);
  int pf = __shfl_up_sync(kFull, tf, 1);
  if (lane == 0) {
    pv = 0.f;
    pf = 0;
  }
  const float ev = __shfl_sync(kFull, wv, warp > 0 ? warp - 1 : 0);
  const int ef = __shfl_sync(kFull, wf, warp > 0 ? warp - 1 : 0);
  if (warp > 0) combine(ev, ef, pv, pf);
  const int first = fm == 0 ? kItems
      : (kReverse ? __clz(fm) - (32 - kItems) : __ffs(fm) - 1);
  // The carry reaches only the items before the tile's first boundary. A
  // warp that holds none of them (on the serving path every warp but the
  // first) does not wait for the look-back and stores at once.
  const bool reached = !pf && first > 0;

  float carry = 0.f;
  if (warp == 0) {
    const float agg_v = __shfl_sync(kFull, wv, kWarps - 1);
    const int agg_f = __shfl_sync(kFull, wf, kWarps - 1);
    // with a boundary inside (or nothing before it) the tile's aggregate is
    // its inclusive prefix already
    const bool closed = tile == 0 || agg_f;
    if (lane == 0)
      store_state(states + tile,
                  pack_state(epoch, closed ? kPrefix : kAggregate, agg_f, agg_v));
    if (tile > 0) {
      carry = look_back(states, tile, epoch, lane);
      if (!closed && lane == 0)
        store_state(states + tile, pack_state(epoch, kPrefix, 0, carry + agg_v));
    }
    if (lane == 0) {
      s_carry = carry;
      __threadfence_block();
      s_ready = 1;
    }
  } else if (__any_sync(kFull, reached)) {
    while (s_ready == 0) __nanosleep(20);
    __threadfence_block();
    carry = s_carry;
  }

  // added to the items before this thread's first boundary
  const float add = pf ? pv : carry + pv;
  float o[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int j = kReverse ? kItems - 1 - k : k;
    o[j] = (k < first ? add + v[j] : v[j]) - xs[j];
  }
  if (vec) {
#pragma unroll
    for (int q = 0; q < kItems / 4; ++q)
      reinterpret_cast<float4*>(out + base)[q] =
          make_float4(o[4 * q], o[4 * q + 1], o[4 * q + 2], o[4 * q + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j)
      if (base + j < n) out[base + j] = o[j];
  }

  // The launch before the epoch wraps: the block's accesses to the states
  // (this thread's warp made them) are over; the last block to arrive here
  // zeroes them and starts the epochs again.
  if (epoch == kEpochMax && tid == 0) {
    __threadfence();
    if (atomicAdd(done, 1u) == tiles - 1) {
      __threadfence();
      for (int64_t i = 0; i < capacity; ++i) states[i] = 0;
      *done = 0;
      *ticket_word = 0;
    }
  }
}

}  // namespace

extern "C" {

// Elements per tile and per thread: the wrapper sizes its scratch as
// ceil(n / tile) states, and the checks place boundaries on these edges.
int seg_excl_sum_tile() { return kTile; }
int seg_excl_sum_items() { return kItems; }
// Bytes of the scratch's header, and the largest epoch before it wraps.
int seg_excl_sum_header_bytes() { return kHeaderBytes; }
unsigned seg_excl_sum_epoch_max() { return kEpochMax; }

// One launch on `stream`: the forward scan, or with reverse != 0 the reverse
// scan. `scratch` is the header followed by `capacity` >= ceil(n / tile)
// state words, zeroed once when it was allocated and used by one stream.
// Returns the launch's CUDA error (0 = ok).
int seg_excl_scan_f32(const float* x, const uint8_t* flag, float* out,
                      void* scratch, long long capacity, long long n,
                      int reverse, void* stream) {
  if (n <= 0) return 0;
  const int64_t tiles = (n + kTile - 1) / kTile;
  if (tiles > capacity || tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  char* bytes = static_cast<char*>(scratch);
  auto* ticket_word = reinterpret_cast<unsigned long long*>(bytes);
  auto* done = reinterpret_cast<uint32_t*>(bytes + 8);
  auto* states = reinterpret_cast<uint64_t*>(bytes + kHeaderBytes);
  if (reverse)
    seg_scan_kernel<true><<<(unsigned)tiles, kThreads, 0, s>>>(
        x, flag, out, n, (uint32_t)tiles, ticket_word, done, states, capacity);
  else
    seg_scan_kernel<false><<<(unsigned)tiles, kThreads, 0, s>>>(
        x, flag, out, n, (uint32_t)tiles, ticket_word, done, states, capacity);
  return (int)cudaGetLastError();
}

}  // extern "C"
