// Bit-plane pack (K8) and unpack (K9) of b-bit codes for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels in src/repro/kernels/pack_codes.py:
//   K8  pack_codes (_pack_kernel): n b-bit codes -> ceil(n/32) * b words,
//       word j*b + t holding bit t of group j's 32 codes (code 32j + l at
//       bit l);
//   K9  unpack_codes (_unpack_kernel): the inverse.
//
// Input is row-batched: (rows, n) codes or (rows, ceil(n/32) * b) words,
// one row per client's leaf, uint32 bit patterns in int32 containers.
//
// The TPU kernel shifted, masked and summed (8, 128) blocks on the vector
// unit.  Here one warp owns one group of 32 codes: lane l holds code 32j+l,
// and for each bit plane t, __ballot_sync(full, (c >> t) & 1) is exactly
// word j*b + t.  Lane t keeps plane t, so the b words of a group leave as
// one coalesced store.  Unpacking inverts it: lanes t < b load the group's
// b words once, and each plane is broadcast with __shfl_sync; lane l
// gathers bit l of every plane.  Lanes past n hold code 0, which is the
// reference's zero padding.
//
// Bound on an H100 SXM (3.35 TB/s): K8 reads 4n bytes and writes
// 4 * ceil(n/32) * b; K9 the reverse.  At the main path's sizes (5 clients
// x 50176 codes, 9 bits: 1 MB of codes, 282 KB of words) launch latency is
// the floor.  Fusing the unpack with the decode's value mapping and
// scatter is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr long long kMaxBlocks = 132 * 16;
constexpr unsigned kFull = 0xFFFFFFFFu;

// One warp per group; groups = rows * n32, walked warp-strided.
__global__ void pack_planes(const uint32_t* __restrict__ codes, long long n,
                            long long n32, int b, long long groups,
                            uint32_t* __restrict__ words) {
  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long stride = (long long)gridDim.x * kWarps;
  for (long long g = warp; g < groups; g += stride) {
    const long long row = g / n32;
    const long long j = g - row * n32;
    const long long i = j * 32 + lane;
    const uint32_t c = i < n ? codes[row * n + i] : 0u;
    uint32_t mine = 0u;
    for (int t = 0; t < b; ++t) {
      const uint32_t plane = __ballot_sync(kFull, (c >> t) & 1u);
      if (lane == t) mine = plane;
    }
    if (lane < b) words[g * b + lane] = mine;
  }
}

__global__ void unpack_planes(const uint32_t* __restrict__ words, long long n,
                              long long n32, int b, long long groups,
                              uint32_t* __restrict__ codes) {
  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long stride = (long long)gridDim.x * kWarps;
  for (long long g = warp; g < groups; g += stride) {
    const long long row = g / n32;
    const long long j = g - row * n32;
    const uint32_t mine = lane < b ? words[g * b + lane] : 0u;
    uint32_t c = 0u;
    for (int t = 0; t < b; ++t) {
      const uint32_t plane = __shfl_sync(kFull, mine, t);
      c |= ((plane >> lane) & 1u) << t;
    }
    const long long i = j * 32 + lane;
    if (i < n) codes[row * n + i] = c;
  }
}

int blocks_for(long long groups) {
  long long blocks = (groups + kWarps - 1) / kWarps;
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

const char* pack_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// K8: words (rows, ceil(n/32) * b) from codes (rows, n), 1 <= b <= 32.
int pack_codes(const uint32_t* codes, int rows, long long n, int b, uint32_t* words,
               void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const long long n32 = (n + 31) / 32;
  const long long groups = (long long)rows * n32;
  pack_planes<<<blocks_for(groups), kThreads, 0, stream>>>(codes, n, n32, b, groups,
                                                           words);
  RETURN_IF_ERROR();
  return 0;
}

// K9: codes (rows, n) from words (rows, ceil(n/32) * b), 1 <= b <= 32.
int unpack_codes(const uint32_t* words, int rows, long long n, int b, uint32_t* codes,
                 void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const long long n32 = (n + 31) / 32;
  const long long groups = (long long)rows * n32;
  unpack_planes<<<blocks_for(groups), kThreads, 0, stream>>>(words, n, n32, b, groups,
                                                             codes);
  RETURN_IF_ERROR();
  return 0;
}

}  // extern "C"
