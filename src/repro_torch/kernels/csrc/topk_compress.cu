// TopK radix threshold (K1) and mask (K2) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels in src/repro/kernels/topk_compress.py:
//   K1  threshold_bits (_hist_kernel): four MSB-first 256-bin histogram
//       passes over bitcast_u32(|x|), each restricted to the elements whose
//       already-decided high bits match the prefix, walked to the exact bit
//       pattern of the k-th largest |x| (ties included);
//   K2  topk_mask (_mask_kernel): out = where(bits >= t, x, 0), in K1's
//       launch or on its own (below).
//
// Input is row-batched: (rows, n) float32, one row per client's leaf, with
// a per-row k (int32 on the device) or one k for every row.
//
// K1 is one launch a call.  The TPU grid carried one histogram from grid
// step to grid step; here each row is one thread-block cluster of 8 or 16
// CTAs (16 where the card schedules that non-portable size) and all four
// digits are decided inside the launch:
//   * each CTA takes a contiguous slice of the row, reads it from HBM once
//     with 16-byte loads where the row allows, and keeps the magnitudes'
//     bits in shared memory (up to kListCap a CTA);
//   * a pass histograms the slice's matching elements into the CTA's
//     256 bins with shared atomics.  The high digit of Gaussian data falls
//     in two or three bins, so there same-address atomics would
//     serialise: in that pass each thread counts its first two distinct
//     bins in registers (any other bin is one atomic) and a warp adds them
//     at the end of the pass with one atomic per distinct bin (ballot,
//     shuffle, __reduce_add_sync);
//   * after one cluster barrier a pass, every CTA sums the cluster's
//     histograms through distributed shared memory and one warp of it
//     walks them: 8 bins a lane, a suffix scan with __shfl_down_sync, the
//     digit counted by a warp reduction.  Each CTA walks for itself, so
//     no second barrier hands the result round; three histogram buffers
//     keep a fast CTA from zeroing bins a slow one still reads;
//   * a slice too large for shared memory is read from HBM again in each
//     pass until the elements matching the decided prefix fit (after the
//     first or second digit at any realistic size); those are collected
//     into shared memory while that pass reads them, and the later passes
//     read only them.
// Counts are integers, exact at any size, and the walk is the plain
// version's (ref.radix_walk_step), so the result is bit-equal to it.  No
// scratch memory: the wrapper allocates only the (rows,) output.
//
// K2 runs in the same launch where the caller asks for the masked rows
// (topk_threshold_bits with out != null; the wrapper's threshold_mask).
// Every CTA knows the threshold once it has walked the last digit, so
// each writes its own slice of where(bits >= t, x, 0) right after its
// walk, before the barrier that ends the launch, re-reading the slice
// with 16-byte loads and stores where the row allows.  The slice was read
// a moment before: at the main path's size the whole of x (about 1 MB)
// is in L2.  (The element list in shared memory cannot serve: it holds
// magnitudes, without signs and in no index order, and a second copy of
// the slice in index order would not fit beside it at 48 K elements.)  Rows
// whose k >= n or k <= 0 leave at once with threshold 0 or 0xFFFFFFFF and
// still write their slice: x itself, or zeros.  The standalone K2 kernel
// (mask_vec4 / mask_scalar) stays for a threshold computed elsewhere, and
// for rows longer than the clusters' shared memory, where the fused
// launch re-reads x from HBM on 64 SMs at (4, 2^24) and K1 then K2 on
// every SM measured faster (PERF.md).
//
// K1's histogram pass alone (radix_hist, topk_radix_hist): the model-sharded
// wire (DESIGN.md §9) holds each leaf's slice on its own rank, and the exact
// global threshold needs every pass's counts summed over the model ranks
// before the digit is chosen.  So the walk runs in the caller: a launch
// counts one digit of this rank's slice (rows, 256) under each row's
// decided prefix, the caller all-reduces the integer counts, walks them with
// the plain version's radix_walk_step on the card (no host sync) and calls
// the next pass.  A block-strided pass with shared-memory bins, the high
// digit through K1's register slots and warp flush; blocks add their bins
// to the caller's zeroed int32 histogram with global atomics (integers: the
// order does not change the sum).  Bound: 4n bytes read a pass.
//
// Edge conventions (those of the TPU kernel): k >= n gives threshold 0
// (every entry kept), k <= 0 gives 0xFFFFFFFF (empty support).
//
// Bound on an H100 SXM (3.35 TB/s): K1 must read x once (4n bytes a row)
// and does ~16 integer operations an element.  At the main path's size
// (5 clients x 50176 floats, about 1 MB) that is 0.0003 ms, so launch
// latency and the six cluster barriers are the floor; a row that fits the
// cluster's shared memory is read from HBM once.  At (4, 2^24) one
// cluster a row reads x up to three times (the third pass collects the
// candidates); the bound is 0.080 ms.  K1 with K2 reads 4n and writes 4n
// bytes (0.0006 ms at main); the mask adds one pass over the slices from
// L2 to K1's launch, and no launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kBins = 256;
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16; // grid cap: 16 blocks per SM

// K1: threads a CTA; shared-memory element list a CTA (u32 bit patterns,
// 192 KB of dynamic shared memory); rows with at most kSmallRow elements
// take clusters of 8 CTAs.
constexpr int kSelThreads = 1024;
constexpr int kListCap = 48 * 1024;
constexpr long long kSmallRow = 8LL * 4096;
constexpr int kUnroll = 2;   // float4 (or float) loads a thread a block

__device__ __forceinline__ uint32_t mag_bits(float v) {
  return __float_as_uint(v) & 0x7FFFFFFFu;
}

// A thread's two most recent bins and their counts, kept in registers:
// the high digit of Gaussian data falls in two or three bins, so most
// elements cost no shared atomic at all (the first two distinct bins a
// thread meets take the slots; any other bin is added at once).
struct BinSlots {
  unsigned b0, c0, b1, c1;
};

__device__ __forceinline__ void slots_add(BinSlots& s, unsigned* H, unsigned bin) {
  // branch-free but for the one atomic: lanes of a warp take different
  // cases element by element
  const bool m0 = bin == s.b0;
  const bool m1 = !m0 && bin == s.b1;
  const bool t0 = !m0 && !m1 && s.c0 == 0u;
  const bool t1 = !m0 && !m1 && !t0 && s.c1 == 0u;
  s.b0 = t0 ? bin : s.b0;
  s.b1 = t1 ? bin : s.b1;
  s.c0 += (m0 || t0) ? 1u : 0u;
  s.c1 += (m1 || t1) ? 1u : 0u;
  if (!(m0 || m1 || t0 || t1)) atomicAdd(&H[bin], 1u);
}

// The high digit (pass 0) goes through the register slots; later digits
// spread over many bins, where a plain shared atomic is cheaper.
__device__ __forceinline__ void count_bin(BinSlots& s, unsigned* H, unsigned bin, int pass) {
  if (pass == 0) {
    slots_add(s, H, bin);
  } else {
    atomicAdd(&H[bin], 1u);
  }
}

// Adds every lane's (bin, count) to H; every lane of the warp must call
// it.  A bin only one lane holds is one atomic from that lane; lanes that
// share a bin add it once, through a warp sum (ballot, shuffle,
// __reduce_add_sync) a shared bin.
__device__ __forceinline__ void warp_flush(unsigned* H, unsigned bin, unsigned count) {
  const int lane = threadIdx.x & 31;
  const unsigned act = __ballot_sync(0xFFFFFFFFu, count != 0u);
  if (count != 0u && __popc(__match_any_sync(act, bin)) == 1) {
    atomicAdd(&H[bin], count);
    count = 0u;
  }
  unsigned pending = __ballot_sync(0xFFFFFFFFu, count != 0u);
  while (pending) {
    const int leader = __ffs(pending) - 1;
    const unsigned lb = __shfl_sync(0xFFFFFFFFu, bin, leader);
    const bool mine = count != 0u && bin == lb;
    const unsigned total = __reduce_add_sync(0xFFFFFFFFu, mine ? count : 0u);
    if (lane == leader) atomicAdd(&H[lb], total);
    if (mine) count = 0u;
    pending = __ballot_sync(0xFFFFFFFFu, count != 0u);
  }
}

// Appends b to list for every active lane (order within the list is free).
// Every lane of the warp must call it.
__device__ __forceinline__ void list_add(unsigned* list, unsigned* list_n, unsigned b,
                                         bool active) {
  const unsigned act = __ballot_sync(0xFFFFFFFFu, active);
  if (act == 0u) return;
  const int lane = threadIdx.x & 31;
  unsigned base = 0u;
  if (lane == __ffs(act) - 1) base = atomicAdd(list_n, (unsigned)__popc(act));
  base = __shfl_sync(0xFFFFFFFFu, base, __ffs(act) - 1);
  if (active) list[base + __popc(act & ((1u << lane) - 1u))] = b;
}

// grid: rows * C CTAs in clusters of C (one cluster a row); block:
// kSelThreads; dynamic shared memory: the element list.  `slice` is a
// multiple of 4; k == nullptr means every row takes k_scalar.
// Writes this CTA's slice of the masked row, where(bits >= t, x, 0), with
// 16-byte loads and stores where the row allows.  The slice was read a
// moment before, so at the main path's sizes it comes from L2.
__device__ __forceinline__ void write_masked_slice(const float* __restrict__ xr,
                                                   float* __restrict__ outr, int len,
                                                   int vec, unsigned t) {
  const int tid = threadIdx.x;
  if (vec) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    float4* o4 = reinterpret_cast<float4*>(outr);
    const int n4 = len >> 2;
#pragma unroll 4
    for (int i = tid; i < n4; i += kSelThreads) {
      const float4 v = __ldg(x4 + i);
      float4 o;
      o.x = mag_bits(v.x) >= t ? v.x : 0.0f;
      o.y = mag_bits(v.y) >= t ? v.y : 0.0f;
      o.z = mag_bits(v.z) >= t ? v.z : 0.0f;
      o.w = mag_bits(v.w) >= t ? v.w : 0.0f;
      o4[i] = o;
    }
  } else {
#pragma unroll 4
    for (int i = tid; i < len; i += kSelThreads) {
      const float v = __ldg(xr + i);
      outr[i] = mag_bits(v) >= t ? v : 0.0f;
    }
  }
}

__global__ void __launch_bounds__(kSelThreads)
threshold_select(const float* __restrict__ x, const int* __restrict__ k, int k_scalar,
                 long long n, long long slice, int vec, long long* __restrict__ thr,
                 float* __restrict__ out) {
  extern __shared__ unsigned list[];
  // three histogram buffers: pass p fills hist[p % 3] while slower CTAs
  // may still read pass p - 1's, and zeroes pass p + 1's
  __shared__ unsigned hist[3][kBins];
  __shared__ unsigned merged[kBins];
  __shared__ unsigned ctl_prefix;
  __shared__ int ctl_krem;
  __shared__ unsigned list_n;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned C = cluster.num_blocks();
  const unsigned rank = cluster.block_rank();
  const long long row = blockIdx.x / C;
  const int tid = threadIdx.x;
  const int kk = k ? k[row] : k_scalar;
  const long long lo = (long long)rank * slice;
  const long long hi = min(n, lo + slice);
  const int len = hi > lo ? (int)(hi - lo) : 0;
  const float* xr = x + row * n + lo;
  if ((long long)kk >= n || kk <= 0) {   // the same for the whole cluster
    const unsigned t = (long long)kk >= n ? 0u : 0xFFFFFFFFu;
    if (rank == 0 && tid == 0) thr[row] = (long long)t;
    if (out) write_masked_slice(xr, out + row * n + lo, len, vec, t);
    return;
  }
  for (int i = tid; i < kBins; i += kSelThreads) hist[0][i] = 0u;
  if (tid == 0) list_n = 0u;
  cluster.sync();   // every CTA has started and zeroed its first bins

  unsigned prefix = 0u;
  int k_rem = kk;
  int matching = len;     // this CTA's elements that match the prefix
  bool listed = false;    // they are all in `list`
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 24 - 8 * pass;
    const unsigned high = pass == 0 ? 0u : (0xFFFFFFFFu << (shift + 8));
    unsigned* H = hist[pass % 3];
    BinSlots sl = {0u, 0u, 0u, 0u};
    if (listed) {
      const int m = (int)list_n;
      for (int i = tid; i < m; i += kSelThreads) {
        const unsigned b = list[i];
        if ((b & high) == prefix) count_bin(sl, H, (b >> shift) & 0xFFu, pass);
      }
    } else {
      const bool collect = matching <= kListCap;   // the same for the CTA
      if (vec) {
        // the next block's loads are in flight while this one is counted
        const float4* x4 = reinterpret_cast<const float4*>(xr);
        const int n4 = len >> 2;
        const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
        float4 v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int i = u * kSelThreads + tid;
          v[u] = i < n4 ? __ldg(x4 + i) : zero4;
        }
        for (int base = 0; base < n4; base += kUnroll * kSelThreads) {
          float4 nv[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int i = base + (kUnroll + u) * kSelThreads + tid;
            nv[u] = i < n4 ? __ldg(x4 + i) : zero4;
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const bool in = base + u * kSelThreads + tid < n4;
            const unsigned e[4] = {mag_bits(v[u].x), mag_bits(v[u].y), mag_bits(v[u].z),
                                   mag_bits(v[u].w)};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const bool act = in && (e[j] & high) == prefix;
              if (act) count_bin(sl, H, (e[j] >> shift) & 0xFFu, pass);
              if (collect) list_add(list, &list_n, e[j], act);
            }
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) v[u] = nv[u];
        }
      } else {
        for (int base = 0; base < len; base += 4 * kUnroll * kSelThreads) {
          float v[4 * kUnroll];
#pragma unroll
          for (int u = 0; u < 4 * kUnroll; ++u) {
            const int i = base + u * kSelThreads + tid;
            v[u] = i < len ? __ldg(xr + i) : 0.0f;
          }
#pragma unroll
          for (int u = 0; u < 4 * kUnroll; ++u) {
            const unsigned e = mag_bits(v[u]);
            const bool act = base + u * kSelThreads + tid < len && (e & high) == prefix;
            if (act) count_bin(sl, H, (e >> shift) & 0xFFu, pass);
            if (collect) list_add(list, &list_n, e, act);
          }
        }
      }
      listed = collect;
    }
    warp_flush(H, sl.b0, sl.c0);
    warp_flush(H, sl.b1, sl.c1);
    for (int i = tid; i < kBins; i += kSelThreads) hist[(pass + 1) % 3][i] = 0u;
    cluster.sync();   // every CTA's bins for this pass are complete
    // every CTA sums the cluster's bins through distributed shared memory
    // and walks them itself: no second barrier to hand the result round
    if (tid < kBins) {
      unsigned sum = 0u;
#pragma unroll
      for (unsigned r = 0; r < 16; ++r)   // all loads in flight at once
        if (r < C) sum += cluster.map_shared_rank(H, r)[tid];
      merged[tid] = sum;
    }
    __syncthreads();
    if (tid < 32) {
      // ge[d] = count(digit >= d); lane l holds bins 8l .. 8l+7
      const int lane = tid;
      unsigned h[8];
      unsigned tot = 0u;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        h[j] = merged[8 * lane + j];
        tot += h[j];
      }
      unsigned incl = tot;   // sum over lanes >= lane
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned o = __shfl_down_sync(0xFFFFFFFFu, incl, off);
        if (lane + off < 32) incl += o;
      }
      unsigned ge[8];
      unsigned acc = incl - tot;
      int cnt = 0;
#pragma unroll
      for (int j = 7; j >= 0; --j) {
        acc += h[j];
        ge[j] = acc;
        cnt += (long long)acc >= (long long)k_rem ? 1 : 0;
      }
      cnt = __reduce_add_sync(0xFFFFFFFFu, cnt);
      const int digit = min(max(cnt - 1, 0), kBins - 1);
      // ge[digit + 1] lives in lane (digit + 1) / 8 (0 when digit = 255)
      const int nb = digit + 1;
      unsigned mine = 0u;
#pragma unroll
      for (int j = 0; j < 8; ++j) mine = (nb & 7) == j ? ge[j] : mine;
      unsigned above = __shfl_sync(0xFFFFFFFFu, mine, (nb >> 3) & 31);
      if (nb >= kBins) above = 0u;
      if (lane == 0) {
        ctl_prefix = prefix | ((unsigned)digit << shift);
        ctl_krem = k_rem - (int)above;
      }
    }
    __syncthreads();
    prefix = ctl_prefix;
    k_rem = ctl_krem;
    matching = (int)H[(prefix >> shift) & 0xFFu];
  }
  // every CTA knows the threshold: the mask needs no barrier, and writing
  // it here overlaps the slower CTAs' last walk
  if (out) write_masked_slice(xr, out + row * n + lo, len, vec, prefix);
  cluster.sync();   // no CTA leaves while another still reads its bins
  if (rank == 0 && tid == 0) thr[row] = (long long)prefix;
}

// grid: (parts, rows); block: kThreads.  hist (rows, 256) is zeroed by the
// caller; prefix[row] holds the digits decided so far (int64 holding a
// uint32 pattern).  vec: x is 16-byte aligned and n % 4 == 0.
__global__ void __launch_bounds__(kThreads)
radix_hist(const float* __restrict__ x, long long n, const long long* __restrict__ prefix,
           int shift, int vec, int* __restrict__ hist) {
  __shared__ unsigned H[kBins];
  for (int i = threadIdx.x; i < kBins; i += kThreads) H[i] = 0u;
  __syncthreads();
  const long long row = blockIdx.y;
  const unsigned high = shift + 8 < 32 ? (0xFFFFFFFFu << (shift + 8)) : 0u;
  const unsigned want = (unsigned)prefix[row] & high;
  const int pass = shift == 24 ? 0 : 1;   // the high digit: register slots
  const float* xr = x + row * n;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  BinSlots sl = {0u, 0u, 0u, 0u};
  if (vec) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
#pragma unroll 4
    for (long long i = first; i < n / 4; i += stride) {
      const float4 v = __ldg(x4 + i);
      const unsigned e[4] = {mag_bits(v.x), mag_bits(v.y), mag_bits(v.z), mag_bits(v.w)};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if ((e[j] & high) == want) count_bin(sl, H, (e[j] >> shift) & 0xFFu, pass);
    }
  } else {
    for (long long i = first; i < n; i += stride) {
      const unsigned e = mag_bits(__ldg(xr + i));
      if ((e & high) == want) count_bin(sl, H, (e >> shift) & 0xFFu, pass);
    }
  }
  warp_flush(H, sl.b0, sl.c0);
  warp_flush(H, sl.b1, sl.c1);
  __syncthreads();
  int* hr = hist + row * kBins;
  for (int i = threadIdx.x; i < kBins; i += kThreads)
    if (H[i] != 0u) atomicAdd(hr + i, (int)H[i]);
}

__global__ void mask_vec4(const float4* __restrict__ x,
                          const long long* __restrict__ thr,
                          float4* __restrict__ out, long long n4,
                          long long total4) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total4; i += stride) {
    const long long t = thr[i / n4];
    const float4 v = x[i];
    float4 o;
    o.x = (long long)mag_bits(v.x) >= t ? v.x : 0.0f;
    o.y = (long long)mag_bits(v.y) >= t ? v.y : 0.0f;
    o.z = (long long)mag_bits(v.z) >= t ? v.z : 0.0f;
    o.w = (long long)mag_bits(v.w) >= t ? v.w : 0.0f;
    out[i] = o;
  }
}

__global__ void mask_scalar(const float* __restrict__ x,
                            const long long* __restrict__ thr,
                            float* __restrict__ out, long long n,
                            long long total) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const float v = x[i];
    out[i] = (long long)mag_bits(v) >= thr[i / n] ? v : 0.0f;
  }
}

int grid_for(long long work) {
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return blocks < 1 ? 1 : (int)blocks;
}

}  // namespace

#define RETURN_IF_ERROR()                          \
  do {                                             \
    cudaError_t err_ = cudaGetLastError();         \
    if (err_ != cudaSuccess) return (int)err_;     \
  } while (0)

extern "C" {

const char* topk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The largest cluster K1 can use (16 where the card schedules it, else 8),
// found once.
int select_cluster_max() {
  static int cached = 0;
  if (cached) return cached;
  cudaFuncSetAttribute(threshold_select, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kListCap * (int)sizeof(unsigned));
  cudaFuncSetAttribute(threshold_select, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(16);
  cfg.blockDim = dim3(kSelThreads);
  cfg.dynamicSmemBytes = kListCap * sizeof(unsigned);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 16;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(&clusters, threshold_select, &cfg);
  cudaGetLastError();   // a refused query leaves no sticky error
  cached = (err == cudaSuccess && clusters > 0) ? 16 : 8;
  return cached;
}

// K1: thr[row] = bit pattern of the k-th largest |x[row, :]|, with k =
// k[row] or, where k is null, k_scalar; and, where out is not null, K2 in
// the same launch: out[row, i] = |x[row, i]| bits >= thr[row] ? x[row, i]
// : 0.  One launch; n < 2^31.
int topk_threshold_bits(const float* x, const int* k, int k_scalar, int rows, long long n,
                        long long* thr, float* out, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int cmax = select_cluster_max();
  const int C = n <= kSmallRow ? 8 : cmax;
  long long slice = (n + C - 1) / C;
  slice = (slice + 3) & ~3LL;
  const int vec = (n % 4 == 0) && ((uintptr_t)x % 16 == 0) && ((uintptr_t)out % 16 == 0);
  const long long list = slice < kListCap ? slice : kListCap;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)rows * (unsigned)C);
  cfg.blockDim = dim3(kSelThreads);
  cfg.dynamicSmemBytes = (size_t)list * sizeof(unsigned);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, threshold_select, x, k, k_scalar, n, slice,
                                       vec, thr, out);
  if (err != cudaSuccess) return (int)err;
  RETURN_IF_ERROR();
  return 0;
}

// K1's histogram pass: hist[row, d] += #{i : digit at shift of |x[row, i]|
// bits == d, and its bits above the digit equal prefix[row]'s}.  hist is
// (rows, 256) int32, zeroed by the caller; shift is 24, 16, 8 or 0.
int topk_radix_hist(const float* x, int rows, long long n, const long long* prefix,
                    int shift, int* hist, void* stream_ptr) {
  if (shift < 0 || shift > 24 || shift % 8 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int vec = n % 4 == 0 && ((uintptr_t)x % 16 == 0);
  // about 16 elements a thread; within the grid cap over all rows
  long long parts = (n + 16LL * kThreads - 1) / (16LL * kThreads);
  const long long cap = kMaxBlocks / rows > 0 ? kMaxBlocks / rows : 1;
  if (parts > cap) parts = cap;
  if (parts < 1) parts = 1;
  radix_hist<<<dim3((unsigned)parts, (unsigned)rows), kThreads, 0, stream>>>(x, n, prefix,
                                                                           shift, vec, hist);
  RETURN_IF_ERROR();
  return 0;
}

// The largest n whose row slices all fit K1's shared-memory lists at once.
long long topk_resident_max_n() {
  return (long long)select_cluster_max() * kListCap;
}

// K2: out[row, i] = |x[row, i]| bits >= thr[row] ? x[row, i] : 0.
int topk_mask_apply(const float* x, const long long* thr, float* out, int rows,
                    long long n, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const long long total = (long long)rows * n;
  const bool aligned = ((uintptr_t)x % 16 == 0) && ((uintptr_t)out % 16 == 0);
  if (n % 4 == 0 && aligned) {
    const long long total4 = total / 4;
    mask_vec4<<<grid_for(total4), kThreads, 0, stream>>>(
        reinterpret_cast<const float4*>(x), thr, reinterpret_cast<float4*>(out), n / 4,
        total4);
  } else {
    mask_scalar<<<grid_for(total), kThreads, 0, stream>>>(x, thr, out, n, total);
  }
  RETURN_IF_ERROR();
  return 0;
}

}  // extern "C"
