// Select -> slot compaction (K5) and its Q_r-code flavour (K6) for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernels in src/repro/kernels/select_slots.py:
//   K5  compact_slots (_compact_kernel): the survivors of a TopK threshold
//       t (|x| bits >= t and bits != 0) as `cap` static (index, value)
//       slots in index order; empty slots hold the sentinel index n and
//       value 0; tie overflow beyond cap keeps the lowest-index cap.
//   K6  compact_code_slots (_compact_code_kernel): the same slots, each
//       carrying the survivor's (1+r)-bit Q_r code instead of its value
//       (the topk_qr wire codec); empty slots hold code 0.
//
// Input is row-batched: x (rows, n) float32, one threshold per row (K1's
// bit pattern, int64 holding uint32) and one static cap for all rows.
// Outputs, in one int32 block: idx (rows, cap), the payload words (rows,
// cap) -- K5's float32 value bits, K6's uint32 code -- and the row's whole
// survivor count nnz (rows,), which the bit accounting reads (ties beyond
// cap included).
//
// The hazard is order.  The TPU kernel walked its grid in sequence and
// carried the running survivor count from block to block.  Blocks here run
// in parallel and in no order, and a slot claimed with atomicAdd would
// break index order and with it the bit-exact contract.  Counts are
// integers only (deterministic, and exact at any n, where the TPU kernel's
// float32 counts are exact below 2^24).
//
// K5 and K6 are two instances of one kernel (slots_lookback, templated on
// the payload), each one launch: a single pass with a decoupled look-back
// over tiles of 4096 elements, 256 threads a block:
//   * a block takes its tiles by ticket (one atomic on a word in the
//     caller's workspace), so every tile it may wait for is held by a
//     block that is running;
//   * it reads its tiles' x once, 16 bytes a load where the row allows
//     (round j: thread t holds elements 4 (256 j + t) + 0..3), and marks
//     the survivors; K6 then loads u only for float4s that hold one;
//   * a byte-packed warp scan gives every thread its place in its (round,
//     warp) and one warp scans the 32 (round, warp) counts, so places follow
//     index order; each tile's count is published in its descriptor;
//   * one warp looks back over the row's earlier tiles' descriptors, 32 a
//     step, until one holds an inclusive prefix, and publishes its own,
//     while the other warps stage the survivors' (index, payload) pairs in
//     shared memory at their places;
//   * the survivors below cap leave as one contiguous run; the row's last
//     tile writes nnz and the sentinels (index n, payload 0) up to cap.
// Descriptors hold epoch | flag | count in one 64-bit word and are tagged
// with the launch's epoch (carried in the ticket word, which the launch's
// last ticket resets and advances), so nothing is cleared between calls,
// and K5 and K6 launches on one stream can share one workspace.
//
// K6's payload is the survivor's code from x, the uniform u at the
// survivor's own index (the n-sized stream the account path's K4 reads,
// not a compacted one), the masked vector's norm (K3's, an input) and
// levels = 2^r, in the reference's order: y = |x| / norm (IEEE division),
// scaled = levels * y, lo = floor(scaled), code = lo + [u < scaled - lo],
// saturated at levels - 1, plus levels when x < 0.  A survivor's masked
// value is x itself.  This file is compiled with --fmad=false so that
// scaled - lo is not contracted into an FMA; no fast math.  K5's payload
// is x's bits: it loads no u and no norm, and does no float arithmetic.
//
// Bound on an H100 SXM (3.35 TB/s): K5 reads 4n bytes per row (x) and
// writes 8 * cap; K6 reads 4n (x) plus 4 * cap (u at the survivors) and
// writes 8 * cap.  At the main path's size (5 clients x 50176 floats) that
// is 0.0005 ms, and one launch is shorter than the wrapper's host time.  At
// (4, 2^24) each block's chain (ticket, loads, look-back, stores) bounds
// them, not bytes.  K5 holds no u in registers, so it runs six blocks an
// SM to K6's four.  PERF.md has the times, on an NVIDIA H100 80GB HBM3 at
// 700 W, with and without each part (tools/k2_k6_ablation.py,
// tools/k4_k5_ablation.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kLbThreads = 256;
constexpr int kLbWarps = kLbThreads / 32;
constexpr int kLbRounds = 4;                                   // float4s a thread
constexpr long long kLbTile = (long long)kLbThreads * 4 * kLbRounds;   // 4096
static_assert(kLbRounds * kLbWarps == 32, "one warp scans the (round, warp) counts");
constexpr unsigned kFlagAggregate = 1u;   // the tile's own count is published
constexpr unsigned kFlagPrefix = 2u;      // its inclusive prefix in the row is
constexpr int kPerLane = 1;               // descriptors a lane reads a step
constexpr int kLookBack = 32 * kPerLane;  // descriptors a look-back step reads
constexpr unsigned kEpochMask = 0x7FFFFFFFu;
constexpr unsigned kValueMask = 0x7FFFFFFFu;

// The two instances differ in payload and in blocks an SM (the register
// cap: 256 threads x 4 blocks is 64 registers a thread, x 6 is 40; six
// blocks' 32 KiB of staging fit in an SM's shared memory).
constexpr int kCodeBlocksPerSm = 4;       // K6: u's registers
constexpr int kValueBlocksPerSm = 6;      // K5

// A tile's descriptor: epoch (31 bits) | flag (2) | value (31).  Flag 0, or
// an epoch other than the launch's, means "not published yet", so the
// descriptors are never cleared: each launch tags its own.
__device__ __forceinline__ unsigned long long make_desc(unsigned epoch, unsigned flag,
                                                        unsigned value) {
  return ((unsigned long long)(epoch & kEpochMask) << 33) |
         ((unsigned long long)flag << 31) | (unsigned long long)value;
}

__device__ __forceinline__ unsigned long long load_desc(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_desc(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// The Q_r code of a survivor, in the reference's operation order (this file
// is built with --fmad=false).
__device__ __forceinline__ int qr_code(float xv, float uv, float safe, float levels,
                                       uint32_t top) {
  const float y = fabsf(xv) / safe;
  const float scaled = levels * y;
  const float lo = floorf(scaled);
  const float frac = scaled - lo;
  uint32_t code = (uint32_t)(lo + (uv < frac ? 1.0f : 0.0f));
  code = code < top ? code : top;
  if (xv < 0.0f) code += (uint32_t)levels;
  return (int)code;
}

// grid: rows * tiles_per_row blocks (any order); block: kLbThreads.
// `ticket` is {epoch (high 32 bits), tickets taken (low 32)}: 0 taken
// before and after every launch.  `desc` holds a descriptor a tile.
// kCodes: K6's codes (u, norm and levels read); else K5's values (u and
// norm unused).
template <bool kCodes, int kBlocksPerSm>
__global__ void __launch_bounds__(kLbThreads, kBlocksPerSm)
slots_lookback(const float* __restrict__ x, const float* __restrict__ u, long long n,
               const long long* __restrict__ thr, const float* __restrict__ norm,
               float levels, int cap, long long tiles_per_row, unsigned total_tiles,
               int vec, unsigned long long* __restrict__ ticket,
               unsigned long long* __restrict__ desc, int* __restrict__ nnz,
               int* __restrict__ idx, int* __restrict__ words) {
  __shared__ unsigned s_tile, s_epoch, s_prefix, s_total;
  __shared__ unsigned s_off[kLbRounds * kLbWarps];   // (round, warp) -> offset
  // the tile's survivors in index order, written out as one run
  __shared__ int s_idx[kLbTile];
  __shared__ int s_word[kLbTile];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;
  // Tiles go by ticket, not blockIdx: every tile a tile waits for has
  // taken its ticket, so is running and publishes its count unconditionally.
  if (tid == 0) {
    const unsigned long long old = atomicAdd(ticket, 1ull);
    const unsigned taken = (unsigned)old;
    const unsigned epoch = (unsigned)(old >> 32);
    if (taken == total_tiles - 1)   // the last ticket: every block has its own
      atomicExch(ticket, (unsigned long long)((epoch + 1u) & kEpochMask) << 32);
    s_tile = taken;
    s_epoch = epoch;
  }
  __syncthreads();
  const long long tile = s_tile;
  const unsigned epoch = s_epoch;
  const long long row = tile / tiles_per_row;
  const long long tr = tile - row * tiles_per_row;
  const float* xr = x + row * n;
  const uint32_t t = (uint32_t)thr[row];
  const long long base = tr * kLbTile;

  // Round j: thread tid holds elements base + 4 (j kLbThreads + tid) + 0..3,
  // so index order is (round, warp, lane, element).
  float xv[kLbRounds][4];
  unsigned keep = 0u;   // bit 4 j + e
#pragma unroll
  for (int j = 0; j < kLbRounds; ++j) {
    const long long e0 = base + 4LL * (j * kLbThreads + tid);
    if (vec) {
      const float4 v = e0 < n ? __ldg(reinterpret_cast<const float4*>(xr + e0))
                              : make_float4(0.f, 0.f, 0.f, 0.f);
      xv[j][0] = v.x; xv[j][1] = v.y; xv[j][2] = v.z; xv[j][3] = v.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) xv[j][e] = e0 + e < n ? __ldg(xr + e0 + e) : 0.0f;
    }
  }
#pragma unroll
  for (int j = 0; j < kLbRounds; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t b = __float_as_uint(xv[j][e]) & 0x7FFFFFFFu;
      if (b >= t && b != 0u) keep |= 1u << (4 * j + e);   // padding is 0: never
    }
  // K6: the uniforms of the survivors' float4s, in flight during the scan
  float uv[kCodes ? kLbRounds : 1][4];
  if constexpr (kCodes) {
    const float* ur = u + row * n;
#pragma unroll
    for (int j = 0; j < kLbRounds; ++j) {
      const long long e0 = base + 4LL * (j * kLbThreads + tid);
      const unsigned nib = (keep >> (4 * j)) & 0xFu;
      if (vec) {
        const float4 v = nib ? __ldg(reinterpret_cast<const float4*>(ur + e0))
                             : make_float4(0.f, 0.f, 0.f, 0.f);
        uv[j][0] = v.x; uv[j][1] = v.y; uv[j][2] = v.z; uv[j][3] = v.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) uv[j][e] = (nib >> e) & 1u ? __ldg(ur + e0 + e) : 0.0f;
      }
    }
  }

  // lane offsets for the four rounds at once, a byte each (a warp's round
  // holds at most 128 survivors)
  unsigned packed = 0u;
#pragma unroll
  for (int j = 0; j < kLbRounds; ++j) packed |= (unsigned)__popc((keep >> (4 * j)) & 0xFu) << (8 * j);
  unsigned incl = packed;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned v = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += v;
  }
  const unsigned lane_off = incl - packed;
  if (lane == 31) {
#pragma unroll
    for (int j = 0; j < kLbRounds; ++j) s_off[j * kLbWarps + w] = (incl >> (8 * j)) & 0xFFu;
  }
  __syncthreads();
  if (w == 0) {
    // (round, warp) counts -> exclusive offsets in index order
    const unsigned c = s_off[lane];
    unsigned run = c;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned v = __shfl_up_sync(kFull, run, d);
      if (lane >= d) run += v;
    }
    s_off[lane] = run - c;
    const unsigned total = __shfl_sync(kFull, run, 31);
    if (lane == 0) {
      store_desc(desc + tile, make_desc(epoch, tr == 0 ? kFlagPrefix : kFlagAggregate, total));
      s_total = total;
    }
  }
  __syncthreads();
  const unsigned total = s_total;
  if (w == 0) {
    unsigned prefix = 0u;
    if (tr > 0) {
      // look back over the row's earlier tiles, kLookBack at a time
      // (kPerLane a lane, nearest first), until one has published its
      // inclusive prefix; the row's start counts as one of 0
      const long long first = tile - tr;
      long long look = tile - 1;
      while (true) {
        unsigned flag[kPerLane], value[kPerLane];
        while (true) {
          bool ready = true;
#pragma unroll
          for (int q = 0; q < kPerLane; ++q) {
            const long long p = look - kPerLane * lane - q;
            if (p >= first) {
              const unsigned long long d = load_desc(desc + p);
              const bool mine = (unsigned)(d >> 33) == (epoch & kEpochMask);
              flag[q] = mine ? (unsigned)(d >> 31) & 3u : 0u;
              value[q] = (unsigned)d & kValueMask;
            } else {
              flag[q] = kFlagPrefix;
              value[q] = 0u;
            }
            ready = ready && flag[q] != 0u;
          }
          if (__all_sync(kFull, ready)) break;
        }
        // the nearest prefix: lane `stop`'s q_stop-th descriptor
        int q_stop = kPerLane;
#pragma unroll
        for (int q = kPerLane - 1; q >= 0; --q) q_stop = flag[q] == kFlagPrefix ? q : q_stop;
        const unsigned at = __ballot_sync(kFull, q_stop < kPerLane);
        unsigned mine = 0u;
        if (at) {
          const int stop = __ffs(at) - 1;
#pragma unroll
          for (int q = 0; q < kPerLane; ++q)
            mine += (lane < stop || (lane == stop && q <= q_stop)) ? value[q] : 0u;
          prefix += __reduce_add_sync(kFull, mine);
          break;
        }
#pragma unroll
        for (int q = 0; q < kPerLane; ++q) mine += value[q];
        prefix += __reduce_add_sync(kFull, mine);
        look -= kLookBack;
      }
      if (lane == 0)
        store_desc(desc + tile, make_desc(epoch, kFlagPrefix, prefix + total));
    }
    if (lane == 0) s_prefix = prefix;
  }

  // every warp stages its survivors and their payloads in shared memory at
  // their places in the tile (warps 1.. while warp 0 looks back)
  float safe = 1.0f;
  uint32_t top = 0u;
  if constexpr (kCodes) {
    const float nr = norm[row];
    safe = nr > 0.0f ? nr : 1.0f;
    top = (uint32_t)levels - 1u;
  }
#pragma unroll
  for (int j = 0; j < kLbRounds; ++j) {
    unsigned pos = s_off[j * kLbWarps + w] + ((lane_off >> (8 * j)) & 0xFFu);
    const long long e0 = base + 4LL * (j * kLbThreads + tid);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if ((keep >> (4 * j + e)) & 1u) {
        s_idx[pos] = (int)(e0 + e);
        if constexpr (kCodes)
          s_word[pos] = qr_code(xv[j][e], uv[j][e], safe, levels, top);
        else
          s_word[pos] = __float_as_int(xv[j][e]);
        ++pos;
      }
    }
  }
  __syncthreads();

  // the tile's slots below cap, one contiguous run of coalesced 4-byte stores
  const unsigned prefix = s_prefix;
  int* ir = idx + row * cap;
  int* wr = words + row * cap;
  const unsigned room = (unsigned)cap > prefix ? (unsigned)cap - prefix : 0u;
  const unsigned m = total < room ? total : room;
  for (unsigned i = tid; i < m; i += kLbThreads) {
    ir[prefix + i] = s_idx[i];
    wr[prefix + i] = s_word[i];
  }
  if (tr == tiles_per_row - 1) {   // the row's last tile knows its count
    const unsigned count = prefix + total;
    if (tid == 0) nnz[row] = (int)count;
    for (long long p = min((long long)count, (long long)cap) + tid; p < cap; p += kLbThreads) {
      ir[p] = (int)n;
      wr[p] = 0;
    }
  }
}

// Tiles a row: a workspace holds a descriptor a tile.
long long tiles_per_row_of(long long n) {
  const long long tiles = (n + kLbTile - 1) / kLbTile;
  return tiles < 1 ? 1 : tiles;
}

template <bool kCodes, int kBlocksPerSm>
int launch_slots(const float* x, const float* u, const float* norm, const long long* thr,
                 int rows, long long n, float levels, int cap, unsigned long long* ws,
                 int* out, cudaStream_t stream) {
  const long long tiles = tiles_per_row_of(n);
  const long long total = tiles * rows;
  if (total >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const int vec = (n % 4 == 0) && ((uintptr_t)x % 16 == 0) &&
                  (!kCodes || (uintptr_t)u % 16 == 0);
  int* idx = out;
  int* words = out + (long long)rows * cap;
  int* nnz = words + (long long)rows * cap;
  slots_lookback<kCodes, kBlocksPerSm><<<(unsigned)total, kLbThreads, 0, stream>>>(
      x, u, n, thr, norm, levels, cap, tiles, (unsigned)total, vec, ws, ws + 1, nnz, idx,
      words);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* slots_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Tiles a row: the caller's workspace holds a descriptor a tile.
long long slots_tiles(long long n) { return tiles_per_row_of(n); }

// K5 in one launch: from x (rows, n) and thr (rows,), out = [idx (rows,
// cap) int32, vals (rows, cap) float32, nnz (rows,) int32].  ws = [ticket,
// descriptors (rows * slots_tiles(n))], u64, all 0 before the first
// launch, belongs to the stream: launches on it (K5's and K6's) run in
// order and leave ws ready for the next.
int compact_slots(const float* x, const long long* thr, int rows, long long n, int cap,
                  unsigned long long* ws, int* out, void* stream_ptr) {
  return launch_slots<false, kValueBlocksPerSm>(
      x, nullptr, nullptr, thr, rows, n, 0.0f, cap, ws, out, (cudaStream_t)stream_ptr);
}

// K6 in one launch: from x, u (rows, n), the masked vector's norm (rows,),
// thr (rows,) and levels = 2^r, out = [idx (rows, cap), codes (rows, cap),
// nnz (rows,)], int32; ws as for K5.
int compact_code_slots(const float* x, const float* u, const float* norm,
                       const long long* thr, int rows, long long n, float levels,
                       int cap, unsigned long long* ws, int* out, void* stream_ptr) {
  return launch_slots<true, kCodeBlocksPerSm>(
      x, u, norm, thr, rows, n, levels, cap, ws, out, (cudaStream_t)stream_ptr);
}

}  // extern "C"
