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
// break index order and with it the bit-exact contract.  So the kernel is
// count, scan, write, with integer counts only (deterministic, and exact
// at any n, where the TPU kernel's float32 counts are exact below 2^24):
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
// K6 shares (a) and (b); its write pass computes each written survivor's
// code from x, the uniform u at the survivor's own index (the n-sized
// stream the account path's K4 reads, not a compacted one), the masked
// vector's norm (K3's, an input) and levels = 2^r, in the reference's
// order: y = |x| / norm (IEEE division), scaled = levels * y, lo =
// floor(scaled), code = lo + [u < scaled - lo], saturated at levels - 1,
// plus levels when x < 0.  A survivor's masked value is x itself.  This
// file is compiled with --fmad=false so that scaled - lo is not contracted
// into an FMA (K5's passes do no float arithmetic, so the flag costs them
// nothing); no fast math.
//
// Bound on an H100 SXM (3.35 TB/s): K5 reads 4n bytes per row (x; pass (c)
// reads it again) and writes 8 * cap; K6 reads 4n (x) plus 4 * cap (u at
// the survivors) and writes 8 * cap.  At the main path's sizes (5 clients
// x 50176 floats) the three launches, not memory, are the floor.

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

// grid: (tiles, rows); block: kThreads.  K6's write pass: write_slots
// with the survivor's Q_r code in place of its value.
__global__ void write_code_slots(const float* __restrict__ x,
                                 const float* __restrict__ u, long long n,
                                 const long long* __restrict__ thr,
                                 const float* __restrict__ norm, float levels,
                                 long long tiles, const int* __restrict__ offsets,
                                 const int* __restrict__ nnz, int cap,
                                 int* __restrict__ idx, int* __restrict__ codes) {
  __shared__ int warp_count[kWarps];
  const int row = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const float* xr = x + (long long)row * n;
  const float* ur = u + (long long)row * n;
  const uint32_t t = (uint32_t)thr[row];
  const long long base = warp_base(blockIdx.x, w);
  int* ir = idx + (long long)row * cap;
  int* cr = codes + (long long)row * cap;

  const int filled = min(nnz[row], cap);
  for (long long p = filled + (long long)blockIdx.x * kThreads + threadIdx.x; p < cap;
       p += (long long)gridDim.x * kThreads) {
    ir[p] = (int)n;
    cr[p] = 0;
  }

  const int tile_off = offsets[(long long)row * tiles + blockIdx.x];
  if (tile_off >= cap) return;      // block-uniform: every rank is past cap
  const float nr = norm[row];
  const float safe = nr > 0.0f ? nr : 1.0f;
  const uint32_t top = (uint32_t)levels - 1u;
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
        const float xv = xr[i];
        const float y = fabsf(xv) / safe;
        const float scaled = levels * y;
        const float lo = floorf(scaled);
        const float frac = scaled - lo;
        uint32_t code = (uint32_t)(lo + (ur[i] < frac ? 1.0f : 0.0f));
        code = code < top ? code : top;
        if (xv < 0.0f) code += (uint32_t)levels;
        ir[p] = (int)i;
        cr[p] = (int)code;
      }
    }
    pos += __popc(masks[k]);
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


// K6: idx, codes (rows, cap) and nnz (rows,) from x, u (rows, n), the
// masked vector's norm (rows,), thr (rows,) and levels = 2^r.
int compact_code_slots(const float* x, const float* u, const float* norm,
                       const long long* thr, int rows, long long n, float levels,
                       int cap, int* scratch, int* nnz, int* idx, int* codes,
                       void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const long long tiles = slots_tiles(n);
  const dim3 grid((unsigned int)tiles, (unsigned int)rows);
  count_tiles<<<grid, kThreads, 0, stream>>>(x, n, thr, tiles, scratch);
  RETURN_IF_ERROR();
  scan_tiles<<<rows, kScanThreads, 0, stream>>>(scratch, tiles, nnz);
  RETURN_IF_ERROR();
  write_code_slots<<<grid, kThreads, 0, stream>>>(x, u, n, thr, norm, levels, tiles,
                                                  scratch, nnz, cap, idx, codes);
  RETURN_IF_ERROR();
  return 0;
}

}  // extern "C"
