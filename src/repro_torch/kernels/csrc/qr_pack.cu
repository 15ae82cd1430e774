// Fused Q_r quantize + bit-plane pack (K7) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel in src/repro/kernels/qr_pack.py:
//   K7  quantize_pack_with_uniforms (_qr_pack_kernel): each scalar's
//       (1+r)-bit code sign << r | min(level, 2^r - 1), with the level the
//       Q_r transform's stochastic rounding (floor(L*y) + [u < frac],
//       y = |x| / norm, L = 2^r), packed straight into bit-plane words:
//       word j*b + t holds bit t of group j's 32 codes, b = 1 + r.
//
// Input is row-batched: x (rows, n) float32, one norm per row (from K3, so
// the packed round draws the account round's levels), r <= 16.  The dense
// codes never reach device memory.  Two entries, one kernel template:
//   * qr_pack_codes reads the uniforms u (rows, n), as the TPU kernel does:
//     bit-equal to the plain version for the same norm and uniforms;
//   * qr_pack_codes_keyed draws them itself, row i's as
//     jax.random.uniform(key_i, (n,)) with threefry2x32 in registers
//     (threefry.cuh), bit for bit the stream repro_torch.prng draws with
//     torch ops.  The main path (ops.quantize_pack, the `qr` codec's
//     encode) calls it, so a packed Q_r leaf is K3 and K7 alone.  Up to 32
//     rows' key words ride in the launch's parameters (no copy).
//
// Layout (K8's and K9's, csrc/pack_codes.cu): a block is a 1024-element
// tile of a row (grid: (tiles, rows), no division); warp w owns the
// 128-element span w of it, and lane l elements 4l..4l+3, loaded as one
// float4 where the row allows (n % 4 == 0, 16-byte aligned).  The lane's
// four codes are packed in registers by bitplane::pack_words
// (csrc/bitplane.cuh, shared with K8: byte permutes, delta swaps and a
// butterfly nibble transpose over the group's 8 lanes), three byte slices
// for b <= 17.  Lanes past n hold code 0, the reference's zero padding.
//
// This file is compiled with --fmad=false and without fast math: the code
// must keep the reference's operation order (y = |x| / safe with an IEEE
// division, scaled = L*y, lo = floor(scaled), lo + [u < scaled - lo],
// saturate, OR in the sign), and an FMA in scaled - lo would change the
// rounding's bits.
//
// Bound on an H100 SXM (3.35 TB/s): reading u, 8n bytes in and 4 *
// ceil(n/32) * (1+r) out (0.18280 ms at (4, 2^24), r = 8); keyed, 4n in,
// the same out (0.10267 ms), and the uniform's 43 operations an element on
// the ALU pipe (threefry.cuh, PERF.md §6) take 0.17252 ms there, so the
// keyed entry is bound by the integer pipe, as the keyed K4 is.  The pack
// adds ~28 integer operations a slice for four codes.  At the main path's
// sizes (5 clients x 50176 floats) launch latency is the floor.  PERF.md
// has the times on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py,
// tools/k7_k9_ablation.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "bitplane.cuh"
#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 4 * kThreads;          // elements a block

// grid: (ceil(n / kTile), rows); block: kThreads.  kKeyed: u is drawn here,
// jax.random.uniform(keys[row], (n,)) bit for bit; else it is read from u.
// kVec: x (and u) are 16-byte aligned and n % 4 == 0, so they move as
// float4.
template <bool kKeyed, bool kVec>
__global__ void __launch_bounds__(kThreads)
qr_pack_tiles(const float* __restrict__ x, const float* __restrict__ u,
              const __grid_constant__ ThreefryKeys keys, const float* __restrict__ norm,
              uint32_t* __restrict__ words, long long n, long long n32, int r,
              float levels) {
  const long long row = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, k = lane & 7;
  const long long span = (long long)blockIdx.x * kTile + 128 * warp;
  if (span >= n) return;                    // the whole warp: no shuffle waits
  const long long e0 = span + 4 * lane;
  const long long at = row * n + e0;
  float xv[4] = {0.0f, 0.0f, 0.0f, 0.0f}, uv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (e0 < n) {
    if (kVec) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(x + at));
      xv[0] = v.x; xv[1] = v.y; xv[2] = v.z; xv[3] = v.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) xv[e] = e0 + e < n ? __ldg(x + at + e) : 0.0f;
    }
    if (kKeyed) {
      const ThreefrySchedule ks = threefry_row_schedule(keys, row);
#pragma unroll
      for (int e = 0; e < 4; ++e) uv[e] = threefry_uniform(ks, (uint32_t)(e0 + e));
    } else if (kVec) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(u + at));
      uv[0] = v.x; uv[1] = v.y; uv[2] = v.z; uv[3] = v.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) uv[e] = e0 + e < n ? __ldg(u + at + e) : 0.0f;
    }
  }
  const float nr = norm[row];
  const float safe = nr > 0.0f ? nr : 1.0f;
  uint32_t c[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    c[e] = 0u;
    if (e0 + e < n) {
      const float y = fabsf(xv[e]) / safe;
      const float scaled = levels * y;
      const float lo = floorf(scaled);
      float level = lo + (uv[e] < scaled - lo ? 1.0f : 0.0f);
      level = fminf(level, levels - 1.0f);  // saturate the top level 2^r
      c[e] = (uint32_t)level | (xv[e] < 0.0f ? (1u << r) : 0u);
    }
  }
  const int b = 1 + r;
  const long long group = (span >> 5) + (lane >> 3);
  uint32_t* wg = words + row * n32 * b + group * b;
  const bool stores = group < n32;
  bitplane::pack_words<3>(c, b, k, stores, wg);   // b <= 17: three byte slices
}

template <bool kKeyed>
int launch_pack(const float* x, const float* u, const ThreefryKeys& keys, const float* norm,
                uint32_t* words, int rows, long long n, int r, cudaStream_t stream) {
  const long long tiles = (n + kTile - 1) / kTile;
  if (tiles > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, (unsigned)rows);
  const long long n32 = (n + 31) / 32;
  const float levels = (float)(1u << r);
  const bool vec = n % 4 == 0 && ((uintptr_t)x & 15) == 0 &&
                   (kKeyed || ((uintptr_t)u & 15) == 0);
  if (vec)
    qr_pack_tiles<kKeyed, true><<<grid, kThreads, 0, stream>>>(x, u, keys, norm, words, n,
                                                               n32, r, levels);
  else
    qr_pack_tiles<kKeyed, false><<<grid, kThreads, 0, stream>>>(x, u, keys, norm, words, n,
                                                                n32, r, levels);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* qr_pack_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// K7 reading its uniforms: words (rows, ceil(n/32) * (1+r)) from x, u
// (rows, n) and norm (rows,), 1 <= r <= 16.
int qr_pack_codes(const float* x, const float* u, const float* norm, int rows,
                  long long n, int r, uint32_t* words, void* stream_ptr) {
  if (r < 1 || r > 16) return (int)cudaErrorInvalidValue;
  const ThreefryKeys none = {};
  return launch_pack<false>(x, u, none, norm, words, rows, n, r, (cudaStream_t)stream_ptr);
}

// K7 drawing its uniforms: row i's are jax.random.uniform(key_i, (n,)), n <
// 2^32, key_i = (keys[2 i], keys[2 i + 1]) (int64 holding uint32).  keys_dev
// is the (rows, 2) key data on the device; when it is null, keys_host holds
// them on the host (rows <= 32) and they travel in the launch's
// parameters.
int qr_pack_codes_keyed(const float* x, const long long* keys_dev, const long long* keys_host,
                        const float* norm, int rows, long long n, int r, uint32_t* words,
                        void* stream_ptr) {
  if (r < 1 || r > 16 || n >= (1LL << 32)) return (int)cudaErrorInvalidValue;
  ThreefryKeys keys;
  if (!threefry_keys(keys_dev, keys_host, rows, keys)) return (int)cudaErrorInvalidValue;
  return launch_pack<true>(x, nullptr, keys, norm, words, rows, n, r, (cudaStream_t)stream_ptr);
}

}  // extern "C"
