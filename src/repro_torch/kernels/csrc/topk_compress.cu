// TopK radix threshold (K1) and mask (K2) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels in src/repro/kernels/topk_compress.py:
//   K1  threshold_bits (_hist_kernel): four MSB-first 256-bin histogram
//       passes over bitcast_u32(|x|), each restricted to the elements whose
//       already-decided high bits match the prefix, walked to the exact bit
//       pattern of the k-th largest |x| (ties included);
//   K2  topk_mask (_mask_kernel): out = where(bits >= t, x, 0).
//
// Input is row-batched: (rows, n) float32, one row per client's leaf, with
// a per-row k (int32 on the device) so one launch serves a whole cohort.
// The TPU grid accumulated one histogram sequentially; here blocks run in
// parallel, so each block builds a shared-memory histogram with shared
// atomics and adds its non-zero bins into a global (rows, 256) histogram.
// A one-block-per-row walk kernel then picks the digit and updates the
// row's prefix and remaining k on the device: no host synchronisation
// between passes.  Counts are integers, exact at any size.
//
// Edge conventions (those of the TPU kernel): k >= n gives threshold 0
// (every entry kept), k <= 0 gives 0xFFFFFFFF (empty support).
//
// Bound on an H100 SXM (3.35 TB/s): K1 reads x four times, ~4 * 4n bytes;
// K2 reads 4n and writes 4n bytes.  At the main path's sizes (5 clients x
// 50176 floats, about 1 MB) every pass takes well under a microsecond of
// bandwidth, so launch latency (9 launches for K1, 1 for K2), not memory,
// is the floor.  A single persistent pass for K1 and K2 is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBins = 256;
constexpr int kThreads = 256;
constexpr long long kChunk = 4096;   // elements per histogram block
constexpr int kMaxBlocks = 132 * 16; // grid cap: 16 blocks per SM

__device__ __forceinline__ uint32_t mag_bits(float v) {
  return __float_as_uint(v) & 0x7FFFFFFFu;
}

__global__ void init_rows(const int* __restrict__ k, uint32_t* __restrict__ prefix,
                          long long* __restrict__ k_rem, int rows) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r < rows) {
    prefix[r] = 0u;
    k_rem[r] = k[r];
  }
}

// grid: (blocks per row, rows); block: kThreads.
__global__ void hist_pass(const float* __restrict__ x, long long n, int shift,
                          const uint32_t* __restrict__ prefix,
                          unsigned int* __restrict__ hist) {
  __shared__ unsigned int sh[kBins];
  const int row = blockIdx.y;
  for (int i = threadIdx.x; i < kBins; i += blockDim.x) sh[i] = 0u;
  __syncthreads();
  const uint32_t high = (shift + 8 < 32) ? (0xFFFFFFFFu << (shift + 8)) : 0u;
  const uint32_t want = prefix[row] & high;
  const float* xr = x + (long long)row * n;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const uint32_t b = mag_bits(xr[i]);
    if ((b & high) == want) atomicAdd(&sh[(b >> shift) & 0xFFu], 1u);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kBins; i += blockDim.x) {
    const unsigned int c = sh[i];
    if (c) atomicAdd(&hist[(long long)row * kBins + i], c);
  }
}

// grid: rows; block: kBins.  Reads and clears the row's histogram.
__global__ void walk_pass(unsigned int* __restrict__ hist, int shift,
                          uint32_t* __restrict__ prefix,
                          long long* __restrict__ k_rem,
                          const int* __restrict__ k, long long n,
                          long long* __restrict__ thr, int last) {
  __shared__ long long ge[kBins];
  const int row = blockIdx.x;
  const int t = threadIdx.x;
  ge[t] = (long long)hist[(long long)row * kBins + t];
  hist[(long long)row * kBins + t] = 0u;
  __syncthreads();
  if (t != 0) return;
  long long acc = 0;
  for (int d = kBins - 1; d >= 0; --d) {  // ge[d] = count(digit >= d)
    acc += ge[d];
    ge[d] = acc;
  }
  const long long kr = k_rem[row];
  int count = 0;  // ge is non-increasing: the digits with ge >= k_rem
  for (int d = 0; d < kBins; ++d) count += (ge[d] >= kr) ? 1 : 0;
  const int digit = min(max(count - 1, 0), kBins - 1);
  const long long above = (digit < kBins - 1) ? ge[digit + 1] : 0;
  k_rem[row] = kr - above;
  const uint32_t p = prefix[row] | ((uint32_t)digit << shift);
  prefix[row] = p;
  if (last) {
    const long long kk = k[row];
    thr[row] = kk >= n ? 0LL : (kk <= 0 ? 0xFFFFFFFFLL : (long long)p);
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

// K1: thr[row] = bit pattern of the k[row]-th largest |x[row, :]|.
// Scratch: hist (rows, 256) u32, prefix (rows,) u32, k_rem (rows,) i64.
int topk_threshold_bits(const float* x, const int* k, int rows, long long n,
                        unsigned int* hist, uint32_t* prefix, long long* k_rem,
                        long long* thr, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  cudaError_t err = cudaMemsetAsync(hist, 0, sizeof(unsigned int) * kBins * (size_t)rows,
                                    stream);
  if (err != cudaSuccess) return (int)err;
  init_rows<<<(rows + kThreads - 1) / kThreads, kThreads, 0, stream>>>(k, prefix, k_rem,
                                                                       rows);
  RETURN_IF_ERROR();
  long long per_row = (n + kChunk - 1) / kChunk;
  long long cap = kMaxBlocks / rows;
  if (per_row > cap) per_row = cap;
  if (per_row < 1) per_row = 1;
  const dim3 grid((unsigned int)per_row, (unsigned int)rows);
  const int shifts[4] = {24, 16, 8, 0};
  for (int p = 0; p < 4; ++p) {
    hist_pass<<<grid, kThreads, 0, stream>>>(x, n, shifts[p], prefix, hist);
    RETURN_IF_ERROR();
    walk_pass<<<rows, kBins, 0, stream>>>(hist, shifts[p], prefix, k_rem, k, n, thr,
                                          p == 3 ? 1 : 0);
    RETURN_IF_ERROR();
  }
  return 0;
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
