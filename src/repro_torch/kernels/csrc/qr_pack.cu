// Fused Q_r quantize + bit-plane pack (K7) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel in src/repro/kernels/qr_pack.py:
//   K7  quantize_pack_with_uniforms (_qr_pack_kernel): each scalar's
//       (1+r)-bit code sign << r | min(level, 2^r - 1), with the level the
//       Q_r transform's stochastic rounding (floor(L*y) + [u < frac],
//       y = |x| / norm, L = 2^r), packed straight into bit-plane words:
//       word j*b + t holds bit t of group j's 32 codes, b = 1 + r.
//
// Input is row-batched: x and u (rows, n) float32, one norm per row (from
// K3, so the packed round draws the account round's levels), r <= 16.
// The dense codes never reach device memory.
//
// One warp owns one group of 32 scalars: lane l computes the code of
// element 32j + l (code 0 past n, the reference's zero padding), and for
// each bit plane t, __ballot_sync(full, (c >> t) & 1) is exactly word
// j*b + t.  Lane t keeps plane t, so a group's b words leave as one
// coalesced store.
//
// This file is compiled with --fmad=false and without fast math: the code
// must keep the reference's operation order (y = |x| / safe with an IEEE
// division, scaled = L*y, lo = floor(scaled), lo + [u < scaled - lo],
// saturate, OR in the sign), and an FMA in scaled - lo would change the
// rounding's bits.
//
// Bound on an H100 SXM (3.35 TB/s): reads 8n bytes (x and u), writes
// 4 * ceil(n/32) * (1+r).  At the main path's sizes (5 clients x 50176
// floats) launch latency is the floor.  Drawing the uniforms in-kernel
// (saving 4n bytes) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr long long kMaxBlocks = 132 * 16;
constexpr unsigned kFull = 0xFFFFFFFFu;

__global__ void qr_pack(const float* __restrict__ x, const float* __restrict__ u,
                        const float* __restrict__ norm, long long n, long long n32,
                        int r, float levels, long long groups,
                        uint32_t* __restrict__ words) {
  const int b = 1 + r;
  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long stride = (long long)gridDim.x * kWarps;
  for (long long g = warp; g < groups; g += stride) {
    const long long row = g / n32;
    const long long i = (g - row * n32) * 32 + lane;
    uint32_t c = 0u;
    if (i < n) {
      const float xv = x[row * n + i];
      const float nr = norm[row];
      const float safe = nr > 0.0f ? nr : 1.0f;
      const float y = fabsf(xv) / safe;
      const float scaled = levels * y;
      const float lo = floorf(scaled);
      float level = lo + (u[row * n + i] < scaled - lo ? 1.0f : 0.0f);
      level = fminf(level, levels - 1.0f);  // saturate the top level 2^r
      c = (uint32_t)level | (xv < 0.0f ? (1u << r) : 0u);
    }
    uint32_t mine = 0u;
    for (int t = 0; t < b; ++t) {
      const uint32_t plane = __ballot_sync(kFull, (c >> t) & 1u);
      if (lane == t) mine = plane;
    }
    if (lane < b) words[g * b + lane] = mine;
  }
}

}  // namespace

extern "C" {

const char* qr_pack_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// K7: words (rows, ceil(n/32) * (1+r)) from x, u (rows, n) and norm (rows,).
int qr_pack_codes(const float* x, const float* u, const float* norm, int rows,
                  long long n, int r, uint32_t* words, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const long long n32 = (n + 31) / 32;
  const long long groups = (long long)rows * n32;
  long long blocks = (groups + kWarps - 1) / kWarps;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  qr_pack<<<(unsigned int)blocks, kThreads, 0, stream>>>(
      x, u, norm, n, n32, r, (float)(1u << r), groups, words);
  cudaError_t err = cudaGetLastError();
  return err == cudaSuccess ? 0 : (int)err;
}

}  // extern "C"
