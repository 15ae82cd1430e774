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
// Outputs: idx (rows, cap) int32, vals (rows, cap) float32 (K5) or codes
// (rows, cap) int32 holding uint32 (K6), and the row's whole survivor
// count nnz (rows,) int32, which the bit accounting reads (ties beyond
// cap included).
//
// The hazard is order.  The TPU kernel walked its grid in sequence and
// carried the running survivor count from block to block.  Blocks here run
// in parallel and in no order, and a slot claimed with atomicAdd would
// break index order and with it the bit-exact contract.  Counts are
// integers only (deterministic, and exact at any n, where the TPU kernel's
// float32 counts are exact below 2^24).
//
// K5 is count, scan, write, three launches:
//   (a) count_tiles: each block counts its tile's survivors with
//       __ballot_sync + __popc and writes one int32 per tile;
//   (b) scan_tiles: one block per row turns the tile counts into
//       exclusive tile offsets and writes the row total to nnz;
//   (c) write_slots: each block recounts its tile per warp, takes warp
//       offsets from shared memory and in-warp positions from the ballot
//       mask, and writes the survivors whose position is below cap; the
//       same grid fills the sentinels from the row's last survivor on.
// A warp covers 32 consecutive elements at a time and the warps of a tile
// cover consecutive 32 * kChunks stretches, so ranks follow index order.
//
// K6 is one launch (code_slots_lookback), a single pass with a decoupled
// look-back over tiles of 4096 elements, one block of 256 threads a tile,
// four blocks an SM:
//   * a block takes its tile by ticket (one atomic on a word in the
//     caller's workspace), so every tile it may wait for is held by a
//     block that is running;
//   * it reads the tile's x once, 16 bytes a load where the row allows
//     (round j: thread t holds elements 4 (256 j + t) + 0..3), marks the
//     survivors, and loads u only for float4s that hold one;
//   * a byte-packed warp scan gives every thread its place in its (round,
//     warp) and one warp scans the 32 (round, warp) counts, so places follow
//     index order; the tile's count is published in its descriptor;
//   * one warp looks back over the row's earlier tiles' descriptors, 32 a
//     step, until one holds an inclusive prefix, and publishes its own,
//     while the other warps stage the survivors' (index, code) pairs in
//     shared memory at their places;
//   * the survivors below cap leave as one contiguous run; the row's last
//     tile writes nnz and the sentinels (index n, code 0) up to cap.
// Descriptors hold epoch | flag | count in one 64-bit word and are tagged
// with the launch's epoch (carried in the ticket word, which the launch's
// last ticket resets and advances), so nothing is cleared between calls.
// Stores straight from registers scatter over a tile's slots, four bytes
// at a time, and cost most of the time at (4, 2^24); staging makes them
// one run a tile.
//
// Each survivor's code comes from x, the uniform u at the survivor's own
// index (the n-sized stream the account path's K4 reads, not a compacted
// one), the masked vector's norm (K3's, an input) and levels = 2^r, in the
// reference's order: y = |x| / norm (IEEE division), scaled = levels * y,
// lo = floor(scaled), code = lo + [u < scaled - lo], saturated at levels -
// 1, plus levels when x < 0.  A survivor's masked value is x itself.  This
// file is compiled with --fmad=false so that scaled - lo is not contracted
// into an FMA (K5's passes do no float arithmetic, so the flag costs them
// nothing); no fast math.
//
// Bound on an H100 SXM (3.35 TB/s): K5 reads 4n bytes per row (x; pass (c)
// reads it again) and writes 8 * cap; K6 reads 4n (x) plus 4 * cap (u at
// the survivors) and writes 8 * cap.  At the main path's size (5 clients x
// 50176 floats) that is 0.0005 ms: K5's three launches are its floor, and
// K6's one launch is shorter than the wrapper's host time.  At (4, 2^24)
// K6 reads x once, and each block's chain (ticket, loads, look-back,
// stores) bounds it: PERF.md has the times, on an NVIDIA H100 80GB HBM3
// at 700 W, with and without each part (tools/k2_k6_ablation.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunks = 4;                        // 32-wide chunks per warp
constexpr long long kTile = kThreads * kChunks;   // elements per block
constexpr int kScanThreads = 1024;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ bool survives(const float* xr, long long i, long long n,
                                         uint32_t t) {
  if (i >= n) return false;
  const uint32_t bits = __float_as_uint(xr[i]) & 0x7FFFFFFFu;
  return bits >= t && bits != 0u;
}

// First element of warp w's stretch of the tile.
__device__ __forceinline__ long long warp_base(long long tile, int w) {
  return tile * kTile + (long long)w * 32 * kChunks;
}

// grid: (tiles, rows); block: kThreads.
__global__ void count_tiles(const float* __restrict__ x, long long n,
                            const long long* __restrict__ thr, long long tiles,
                            int* __restrict__ counts) {
  __shared__ int warp_count[kWarps];
  const int row = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const float* xr = x + (long long)row * n;
  const uint32_t t = (uint32_t)thr[row];
  const long long base = warp_base(blockIdx.x, w);
  int c = 0;
  for (int k = 0; k < kChunks; ++k)
    c += __popc(__ballot_sync(kFull, survives(xr, base + k * 32 + lane, n, t)));
  if (lane == 0) warp_count[w] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int i = 0; i < kWarps; ++i) total += warp_count[i];
    counts[(long long)row * tiles + blockIdx.x] = total;
  }
}

// grid: rows; block: kScanThreads.  counts -> exclusive offsets in place.
__global__ void scan_tiles(int* __restrict__ counts, long long tiles,
                           int* __restrict__ nnz) {
  __shared__ int warp_sum[kScanThreads / 32];
  int* cr = counts + (long long)blockIdx.x * tiles;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;
  // each thread owns a contiguous run of tiles
  const long long per = (tiles + kScanThreads - 1) / kScanThreads;
  const long long lo = tid * per;
  const long long hi = lo + per < tiles ? lo + per : tiles;
  int own = 0;
  for (long long i = lo; i < hi; ++i) own += cr[i];
  // inclusive scan of the threads' sums: in-warp, then over warps
  int inc = own;
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(kFull, inc, d);
    if (lane >= d) inc += v;
  }
  if (lane == 31) warp_sum[w] = inc;
  __syncthreads();
  if (w == 0) {
    int ws = warp_sum[lane];
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kFull, ws, d);
      if (lane >= d) ws += v;
    }
    warp_sum[lane] = ws;            // inclusive over warps
  }
  __syncthreads();
  int run = inc - own + (w > 0 ? warp_sum[w - 1] : 0);   // exclusive
  for (long long i = lo; i < hi; ++i) {
    const int c = cr[i];
    cr[i] = run;
    run += c;
  }
  if (tid == kScanThreads - 1) nnz[blockIdx.x] = warp_sum[kScanThreads / 32 - 1];
}

// grid: (tiles, rows); block: kThreads.
__global__ void write_slots(const float* __restrict__ x, long long n,
                            const long long* __restrict__ thr, long long tiles,
                            const int* __restrict__ offsets,
                            const int* __restrict__ nnz, int cap,
                            int* __restrict__ idx, float* __restrict__ vals) {
  __shared__ int warp_count[kWarps];
  const int row = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const float* xr = x + (long long)row * n;
  const uint32_t t = (uint32_t)thr[row];
  const long long base = warp_base(blockIdx.x, w);
  int* ir = idx + (long long)row * cap;
  float* vr = vals + (long long)row * cap;

  // sentinels: slots from the row's survivor count up to cap
  const int filled = min(nnz[row], cap);
  for (long long p = filled + (long long)blockIdx.x * kThreads + threadIdx.x; p < cap;
       p += (long long)gridDim.x * kThreads) {
    ir[p] = (int)n;
    vr[p] = 0.0f;
  }

  const int tile_off = offsets[(long long)row * tiles + blockIdx.x];
  if (tile_off >= cap) return;      // block-uniform: every rank is past cap
  unsigned masks[kChunks];
  int c = 0;
  for (int k = 0; k < kChunks; ++k) {
    masks[k] = __ballot_sync(kFull, survives(xr, base + k * 32 + lane, n, t));
    c += __popc(masks[k]);
  }
  if (lane == 0) warp_count[w] = c;
  __syncthreads();
  int pos = tile_off;
  for (int i = 0; i < w; ++i) pos += warp_count[i];
  const unsigned below = (1u << lane) - 1u;
  for (int k = 0; k < kChunks; ++k) {
    if ((masks[k] >> lane) & 1u) {
      const int p = pos + __popc(masks[k] & below);
      if (p < cap) {
        const long long i = base + k * 32 + lane;
        ir[p] = (int)i;
        vr[p] = xr[i];
      }
    }
    pos += __popc(masks[k]);
  }
}

// ---- K6: one launch, a decoupled look-back over tiles ---------------------

constexpr int kLbThreads = 256;
constexpr int kLbWarps = kLbThreads / 32;
constexpr int kLbRounds = 4;                                   // float4s a thread
constexpr long long kLbTile = (long long)kLbThreads * 4 * kLbRounds;   // 4096
static_assert(kLbRounds * kLbWarps == 32, "one warp scans the (round, warp) counts");
constexpr unsigned kFlagAggregate = 1u;   // the tile's own count is published
constexpr unsigned kFlagPrefix = 2u;      // its inclusive prefix in the row is
constexpr int kLbBlocksPerSm = 4;
constexpr int kPerLane = 1;               // descriptors a lane reads a step
constexpr int kLookBack = 32 * kPerLane;  // descriptors a look-back step reads
constexpr unsigned kEpochMask = 0x7FFFFFFFu;
constexpr unsigned kValueMask = 0x7FFFFFFFu;

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

// grid: rows * tiles_per_row blocks (any order); block: kLbThreads, four
// blocks an SM (64 registers a thread: more blocks' chains in flight).
// `ticket` is {epoch (high 32 bits), tickets taken (low 32)}: 0 taken
// before and after every launch.  `desc` holds a descriptor a tile.
__global__ void __launch_bounds__(kLbThreads, kLbBlocksPerSm)
code_slots_lookback(const float* __restrict__ x, const float* __restrict__ u, long long n,
                    const long long* __restrict__ thr, const float* __restrict__ norm,
                    float levels, int cap, long long tiles_per_row, unsigned total_tiles,
                    int vec, unsigned long long* __restrict__ ticket,
                    unsigned long long* __restrict__ desc, int* __restrict__ nnz,
                    int* __restrict__ idx, int* __restrict__ codes) {
  __shared__ unsigned s_tile, s_epoch, s_prefix, s_total;
  __shared__ unsigned s_off[kLbRounds * kLbWarps];   // (round, warp) -> offset
  // the tile's survivors in index order, written out as one run
  __shared__ int s_idx[kLbTile];
  __shared__ int s_code[kLbTile];
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
  const float* ur = u + row * n;
  const uint32_t t = (uint32_t)thr[row];
  const long long base = tr * kLbTile;

  // Round j: thread tid holds elements base + 4 (j kLbThreads + tid) + 0..3,
  // so index order is (round, warp, lane, element).
  float xv[kLbRounds][4];
  float uv[kLbRounds][4];
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
  // the uniforms of the survivors' float4s, in flight during the scan
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

  // every warp stages its survivors and their codes in shared memory at
  // their places in the tile (warps 1.. while warp 0 looks back)
  const float nr = norm[row];
  const float safe = nr > 0.0f ? nr : 1.0f;
  const uint32_t top = (uint32_t)levels - 1u;
#pragma unroll
  for (int j = 0; j < kLbRounds; ++j) {
    unsigned pos = s_off[j * kLbWarps + w] + ((lane_off >> (8 * j)) & 0xFFu);
    const long long e0 = base + 4LL * (j * kLbThreads + tid);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if ((keep >> (4 * j + e)) & 1u) {
        s_idx[pos] = (int)(e0 + e);
        s_code[pos] = qr_code(xv[j][e], uv[j][e], safe, levels, top);
        ++pos;
      }
    }
  }
  __syncthreads();

  // the tile's slots below cap, one contiguous run
  const unsigned prefix = s_prefix;
  int* ir = idx + row * cap;
  int* cr = codes + row * cap;
  const unsigned room = (unsigned)cap > prefix ? (unsigned)cap - prefix : 0u;
  const unsigned m = total < room ? total : room;
  for (unsigned i = tid; i < m; i += kLbThreads) {
    ir[prefix + i] = s_idx[i];
    cr[prefix + i] = s_code[i];
  }
  if (tr == tiles_per_row - 1) {   // the row's last tile knows its count
    const unsigned count = prefix + total;
    if (tid == 0) nnz[row] = (int)count;
    for (long long q = min((long long)count, (long long)cap) + tid; q < cap; q += kLbThreads) {
      ir[q] = (int)n;
      cr[q] = 0;
    }
  }
}

}  // namespace

#define RETURN_IF_ERROR()                          \
  do {                                             \
    cudaError_t err_ = cudaGetLastError();         \
    if (err_ != cudaSuccess) return (int)err_;     \
  } while (0)

extern "C" {

const char* slots_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Tiles per row: the caller allocates the (rows, tiles) int32 scratch.
long long slots_tiles(long long n) {
  const long long tiles = (n + kTile - 1) / kTile;
  return tiles < 1 ? 1 : tiles;
}

// K5: idx, vals (rows, cap) and nnz (rows,) from x (rows, n) and thr (rows,).
int compact_slots(const float* x, const long long* thr, int rows, long long n, int cap,
                  int* scratch, int* nnz, int* idx, float* vals, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const long long tiles = slots_tiles(n);
  const dim3 grid((unsigned int)tiles, (unsigned int)rows);
  count_tiles<<<grid, kThreads, 0, stream>>>(x, n, thr, tiles, scratch);
  RETURN_IF_ERROR();
  scan_tiles<<<rows, kScanThreads, 0, stream>>>(scratch, tiles, nnz);
  RETURN_IF_ERROR();
  write_slots<<<grid, kThreads, 0, stream>>>(x, n, thr, tiles, scratch, nnz, cap, idx,
                                             vals);
  RETURN_IF_ERROR();
  return 0;
}


// K6's tiles a row: the caller's workspace holds a descriptor a tile.
long long code_slots_tiles(long long n) {
  const long long tiles = (n + kLbTile - 1) / kLbTile;
  return tiles < 1 ? 1 : tiles;
}

// K6 in one launch: from x, u (rows, n), the masked vector's norm (rows,),
// thr (rows,) and levels = 2^r, out = [idx (rows, cap), codes (rows, cap),
// nnz (rows,)], int32.  ws = [ticket, descriptors (rows *
// code_slots_tiles(n))], u64, all 0 before the first launch, belongs to
// the stream: launches on it run in order and leave ws ready for the next.
int compact_code_slots(const float* x, const float* u, const float* norm,
                       const long long* thr, int rows, long long n, float levels,
                       int cap, unsigned long long* ws, int* out, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const long long tiles = code_slots_tiles(n);
  const long long total = tiles * rows;
  if (total >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const int vec = (n % 4 == 0) && ((uintptr_t)x % 16 == 0) && ((uintptr_t)u % 16 == 0);
  int* idx = out;
  int* codes = out + (long long)rows * cap;
  int* nnz = codes + (long long)rows * cap;
  code_slots_lookback<<<(unsigned)total, kLbThreads, 0, stream>>>(
      x, u, n, thr, norm, levels, cap, tiles, (unsigned)total, vec, ws, ws + 1, nnz, idx,
      codes);
  RETURN_IF_ERROR();
  return 0;
}

}  // extern "C"
