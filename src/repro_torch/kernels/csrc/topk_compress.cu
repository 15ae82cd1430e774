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
// K1's histogram pass alone, grouped (K1h: radix_hist_grouped,
// topk_radix_hist): the model-sharded wire (DESIGN.md §9) holds each leaf's
// slice on its own rank, and the exact global threshold needs every pass's
// counts summed over the model ranks before the digit is chosen.  An encode
// has one slice a sharded leaf (41 of them for qwen2-0.5b at 4 layers, many
// of 32 or 64 floats), so one launch counts one digit for every slice of
// every leaf at once:
//   * a leaf table, made by the wrapper once a call and copied to the card
//     in one copy, lists each slice's pointer and n and the prefix sum of
//     its blocks (ntotal and k for the walk beside them).  Blocks go to
//     the slices in proportion to their size under the grid cap, at least
//     one a slice (the wrapper's hist_block_starts); a block finds its
//     slice by a binary search of the block starts in shared memory (in
//     L2 past kSmemStarts leaves).  A one-leaf
//     call needs no table: its slice comes in the launch's parameters;
//   * the output is (leaves * rows, 256) int32, leaf-major, zeroed by the
//     C entry (one memset); each block counts into shared-memory bins, the
//     high digit through K1's register slots and warp flush, and adds them
//     to the output with global atomics (integers: the order does not
//     change the sum).  A slice is read with 16-byte loads from its first
//     16-byte boundary, its unaligned head and its tail (n % 4) by scalar
//     loads;
//   * the walk runs on the card between the caller's reductions: the next
//     digit's launch is given the reduced counts, and each of its blocks
//     takes its row's digit from them (ref.radix_walk_step, one warp)
//     before counting; the first block of a slice writes the row's new
//     (prefix, k_rem) to the other of two state buffers.  One finishing
//     launch (radix_finish, a warp a row) takes the last digit and applies
//     the edge conventions.
// A call of threshold_bits_sharded is then one table copy, a memset and a
// launch a digit, and the finish: 10 device operations for any number of
// leaves.  Bound: 4 bytes an element of every slice, read once a digit.
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

// The digits above the one at shift (decided before its pass).
__device__ __forceinline__ unsigned shift_high(int shift) {
  return shift + 8 < 32 ? (0xFFFFFFFFu << (shift + 8)) : 0u;
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

// One step of the radix walk (ref.radix_walk_step) over a row's 256
// counts h, by one warp (every lane must call it): the largest digit d
// with count(digit >= d) >= k_rem, and the count strictly above it.  Lane
// l holds bins 8l .. 8l+7; a suffix scan with __shfl_down_sync, the digit
// counted by a warp reduction.
template <typename T>
__device__ __forceinline__ void walk_step(const T* h, long long k_rem, int& digit,
                                          long long& above) {
  const int lane = threadIdx.x & 31;
  unsigned long long c[8];
  unsigned long long tot = 0ull;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    c[j] = (unsigned long long)h[8 * lane + j];
    tot += c[j];
  }
  unsigned long long incl = tot;   // sum over lanes >= lane
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned long long o = __shfl_down_sync(0xFFFFFFFFu, incl, off);
    if (lane + off < 32) incl += o;
  }
  // ge[d] = count(digit >= d)
  unsigned long long ge[8];
  unsigned long long acc = incl - tot;
  unsigned cnt = 0u;
#pragma unroll
  for (int j = 7; j >= 0; --j) {
    acc += c[j];
    ge[j] = acc;
    cnt += (long long)acc >= k_rem ? 1u : 0u;
  }
  cnt = __reduce_add_sync(0xFFFFFFFFu, cnt);
  digit = min(max((int)cnt - 1, 0), kBins - 1);
  // ge[digit + 1] lives in lane (digit + 1) / 8 (0 when digit = 255)
  const int nb = digit + 1;
  unsigned long long mine = 0ull;
#pragma unroll
  for (int j = 0; j < 8; ++j) mine = (nb & 7) == j ? ge[j] : mine;
  const unsigned long long a = __shfl_sync(0xFFFFFFFFu, mine, (nb >> 3) & 31);
  above = nb >= kBins ? 0ll : (long long)a;
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
      int digit;
      long long above;
      walk_step(merged, (long long)k_rem, digit, above);
      if (tid == 0) {
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

// K1h's leaf table (int64 words) for L leaves of R rows:
//   ptr[L] | n[L] | start[L + 1] | ntotal[L] | k[L * R]
// slice i's rows are ptr[i] + r * n[i]; its blocks are start[i] ..
// start[i + 1] - 1; output row j = i * R + r.
struct HistArgs {
  const long long* table;   // null: one leaf (x0, n0), gridDim.x blocks a row
  int leaves;               // L (1 without a table)
  const float* x0;
  long long n0;
  const long long* prefix;  // each output row's decided prefix; null: walk
  const int* prev;          // walk: the previous digit's reduced counts
                            // (L * R, 256); null at the first digit
  const long long* st_in;   // walk: (prefix[L * R], k_rem[L * R]) before
                            // the previous digit
  long long* st_out;        // walk: the same before this digit
  const long long* k;       // walk: each output row's k
  int shift;
  int* hist;                // (L * R, 256), zeroed
};

// Leaves whose block starts a block keeps in shared memory for its search.
constexpr int kSmemStarts = 2048;

// grid: (blocks of every slice, R); block: kThreads.
__global__ void __launch_bounds__(kThreads) radix_hist_grouped(const HistArgs a) {
  __shared__ unsigned H[kBins];
  __shared__ int starts[kSmemStarts];
  __shared__ long long ctl_prefix, ctl_krem;
  const int tid = threadIdx.x;
  const int r = blockIdx.y;
  const int R = gridDim.y;
  const int bx = blockIdx.x;
  for (int i = tid; i < kBins; i += kThreads) H[i] = 0u;
  int leaf = 0, b = bx, nblocks = gridDim.x;
  long long n = a.n0;
  const float* base = a.x0;
  if (a.table) {
    const int L = a.leaves;
    const long long* start = a.table + 2 * L;
    const bool in_smem = L + 1 <= kSmemStarts;
    if (in_smem)
      for (int i = tid; i <= L; i += kThreads) starts[i] = (int)start[i];
    __syncthreads();
    int lo = 0, hi = L - 1;   // the last leaf whose first block is <= bx
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      const int sm = in_smem ? starts[mid] : (int)start[mid];
      if (sm <= bx) lo = mid; else hi = mid - 1;
    }
    leaf = lo;
    const int s0 = in_smem ? starts[leaf] : (int)start[leaf];
    const int s1 = in_smem ? starts[leaf + 1] : (int)start[leaf + 1];
    b = bx - s0;
    nblocks = s1 - s0;
    n = a.table[L + leaf];
    base = reinterpret_cast<const float*>(a.table[leaf]);
  }
  const float* xr = base + (long long)r * n;
  const int LR = a.leaves * R;
  const int j = leaf * R + r;
  const unsigned high = shift_high(a.shift);
  unsigned want;
  if (a.prefix) {
    want = (unsigned)a.prefix[j] & high;
  } else {
    // the walk: this row's prefix and k_rem before this digit
    long long p, kr;
    if (a.prev == nullptr) {
      p = 0;
      kr = a.k[j];
    } else {
      if (tid < 32) {
        int digit;
        long long above;
        walk_step(a.prev + (long long)j * kBins, a.st_in[LR + j], digit, above);
        if (tid == 0) {
          ctl_prefix = a.st_in[j] | ((long long)digit << (a.shift + 8));
          ctl_krem = a.st_in[LR + j] - above;
        }
      }
      __syncthreads();
      p = ctl_prefix;
      kr = ctl_krem;
    }
    if (b == 0 && tid == 0) {   // one block a row hands the state on
      a.st_out[j] = p;
      a.st_out[LR + j] = kr;
    }
    want = (unsigned)p & high;
  }
  __syncthreads();   // the bins are zeroed
  const int pass = a.shift == 24 ? 0 : 1;   // the high digit: register slots
  const int shift = a.shift;
  BinSlots sl = {0u, 0u, 0u, 0u};
  // the scalar head up to the first 16-byte boundary, the float4 body, the
  // scalar tail (n - head) % 4; head and tail by the slice's first block
  const long long head =
      min(n, (long long)((((16u - (unsigned)((uintptr_t)xr & 15u)) & 15u)) >> 2));
  const long long n4 = (n - head) >> 2;
  const long long tail0 = head + 4 * n4;
  if (b == 0) {
    if (tid < head) {
      const unsigned e = mag_bits(__ldg(xr + tid));
      if ((e & high) == want) count_bin(sl, H, (e >> shift) & 0xFFu, pass);
    }
    if (tid < n - tail0) {
      const unsigned e = mag_bits(__ldg(xr + tail0 + tid));
      if ((e & high) == want) count_bin(sl, H, (e >> shift) & 0xFFu, pass);
    }
  }
  const float4* x4 = reinterpret_cast<const float4*>(xr + head);
  const long long stride = (long long)nblocks * kThreads;
#pragma unroll 4
  for (long long i = (long long)b * kThreads + tid; i < n4; i += stride) {
    const float4 v = __ldg(x4 + i);
    const unsigned e[4] = {mag_bits(v.x), mag_bits(v.y), mag_bits(v.z), mag_bits(v.w)};
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if ((e[q] & high) == want) count_bin(sl, H, (e[q] >> shift) & 0xFFu, pass);
  }
  warp_flush(H, sl.b0, sl.c0);
  warp_flush(H, sl.b1, sl.c1);
  __syncthreads();
  int* hr = a.hist + (long long)j * kBins;
  for (int i = tid; i < kBins; i += kThreads)
    if (H[i] != 0u) atomicAdd(hr + i, (int)H[i]);
}

// The walk's last step and the edge conventions, a warp an output row:
// thr[j] = the row's bit pattern, 0 where k >= ntotal, 0xFFFFFFFF where
// k <= 0.  st: (prefix, k_rem) before the last digit; hist: its counts.
__global__ void __launch_bounds__(kThreads)
radix_finish(const long long* __restrict__ table, int L, int R, const int* __restrict__ hist,
             const long long* __restrict__ st, const long long* __restrict__ k,
             long long* __restrict__ thr) {
  const int LR = L * R;
  const int j = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (j >= LR) return;   // the whole warp
  int digit;
  long long above;
  walk_step(hist + (long long)j * kBins, st[LR + j], digit, above);
  if ((threadIdx.x & 31) == 0) {
    const long long kk = k[j];
    const long long ntotal = table[3 * L + 1 + j / R];
    long long t = st[j] | (long long)digit;
    if (kk >= ntotal) t = 0;
    if (kk <= 0) t = 0xFFFFFFFFll;
    thr[j] = t;
  }
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

// K1h, one digit for every slice at once: zeroes hist (leaves * rows,
// 256) int32 and counts into it, hist[j, d] = #{i : digit at shift of
// |x_j[i]| bits == d, and its bits above the digit equal row j's prefix}.
// table: the leaf table (above) on the card, or null for one leaf (x0, n0)
// with `blocks` blocks a row; blocks is then the table's start[L].  The
// prefix is prefix[j], or where prefix is null the walk's: the first digit
// (prev null) starts it from k, a later one takes the digit of prev (the
// previous digit's reduced counts) from st_in and writes st_out.  shift is
// 24, 16, 8 or 0.
int topk_radix_hist(const long long* table, int leaves, int rows, int blocks, const float* x0,
                    long long n0, const long long* prefix, const int* prev,
                    const long long* st_in, long long* st_out, const long long* k, int shift,
                    int* hist, void* stream_ptr) {
  if (shift < 0 || shift > 24 || shift % 8 != 0 || blocks < 1 || leaves < 1 || rows < 1 ||
      (table == nullptr && leaves != 1) ||
      (prefix == nullptr && (table == nullptr || k == nullptr || st_out == nullptr ||
                             (prev != nullptr && st_in == nullptr))))
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  cudaError_t err = cudaMemsetAsync(hist, 0, (size_t)leaves * rows * kBins * sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  HistArgs a;
  a.table = table;
  a.leaves = leaves;
  a.x0 = x0;
  a.n0 = n0;
  a.prefix = prefix;
  a.prev = prev;
  a.st_in = st_in;
  a.st_out = st_out;
  a.k = k;
  a.shift = shift;
  a.hist = hist;
  radix_hist_grouped<<<dim3((unsigned)blocks, (unsigned)rows), kThreads, 0, stream>>>(a);
  RETURN_IF_ERROR();
  return 0;
}

// K1h's finish: thr (leaves * rows) int64 from the last digit's reduced
// counts hist and the walk's state st before it (radix_finish).
int topk_radix_finish(const long long* table, int leaves, int rows, const int* hist,
                      const long long* st, const long long* k, long long* thr,
                      void* stream_ptr) {
  if (table == nullptr || leaves < 1 || rows < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const long long LR = (long long)leaves * rows;
  const int warps = kThreads / 32;
  radix_finish<<<(unsigned)((LR + warps - 1) / warps), kThreads, 0, stream>>>(
      table, leaves, rows, hist, st, k, thr);
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
