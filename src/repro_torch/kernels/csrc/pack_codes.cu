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
// Both kernels take one lane layout (K7's too, csrc/qr_pack.cu): a tile is
// 1024 codes (32 groups); warp w owns the 128-code span w of the tile, and
// lane l codes 4l..4l+3 of it, which are bits 4(l%8)..4(l%8)+3 of each of
// group 4w + l/8's b words.
//
// K8 (pack_tiles) is K7's kernel without the quantisation: a block is a
// tile of a row (grid: (tiles, rows), no division); each lane loads its
// four codes as one 16-byte load where the row allows (n % 4 == 0 and a
// 16-byte aligned input), else as 4-byte loads, and packs them in
// registers with bitplane::pack_words (csrc/bitplane.cuh: byte permutes,
// delta swaps and a butterfly nibble transpose over the group's 8 lanes),
// four byte slices, so b runs to 32; lane k stores word 8j + k of its group
// when 8j + k < b.  Bits of a code at or above b are ignored, as the TPU
// kernel ignores them; lanes past n hold code 0, the reference's zero
// padding.
//
// K9 has two entries built from one kernel template, unpack_tiles:
//   * unpack_codes writes the codes (the JAX function's counterpart);
//   * unpack_qr_values writes, for b = 1 + r, the Q_r values the codes
//     stand for, norm[row] * sgn * (m / 2^r) where norm[row] > 0 and +0
//     elsewhere (m = code & (2^r - 1), sgn = -1 where bit r is set): the
//     `qr` and `topk_qr` codecs' decode in one launch, so the codes never
//     reach device memory.  The product is the plain chain's single
//     rounding (m / 2^r is exact), and a sign bit over level 0 gives -0.0.
// K9's block is persistent over its row's tiles (grid: (tiles a row, at
// most what one wave holds, rows): no division).  A lane reads its group's
// b words straight from global memory: b independent 4-byte loads (a
// warp's load of plane t touches its four groups' word t; L1 serves the
// lanes that share a group), all in flight at once, for 8 blocks x 256
// lanes an SM; a barrier a tile keeps a block's warps on one tile.
// (Staging the tiles into shared memory with cp.async measured no faster
// at (4, 2^24) and slower at the main shape: PERF.md,
// tools/k7_k9_ablation.py.)  A lane turns the nibble of plane t into its
// four codes' bit t with one multiply (nib * (0x204081 << s) &
// (0x01010101 << s) puts nibble bit e at byte e, bit s = t % 8), ORs it
// into the byte-sliced accumulator t / 8, and four byte permutes a code
// make the codes; they leave as one 16-byte store a lane where the row
// allows (n % 4 == 0 and a 16-byte aligned output), else as 4-byte
// stores.
//
// Bound on an H100 SXM (3.35 TB/s): K8 reads 4n bytes and writes
// 4 * ceil(n/32) * b; K9 the reverse (both entries write 4n).  At (4, 2^24),
// b = 9 that is 0.10267 ms (K9's stores, K8's loads 78% of it); K9's decode
// is ~4 integer operations a plane for four codes, 0.036 ms of the ALU
// pipe at b = 9, K8's pack ~28 a byte slice for four codes.  At
// the main path's sizes (5 clients x 50176 codes) launch latency is the
// floor.  PERF.md has the times on an NVIDIA H100 80GB HBM3 at 700 W
// (chip_smoke.py, tools/k7_k9_ablation.py, tools/k8_k11_ablation.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "bitplane.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSms = 132;                         // H100 SXM
constexpr int kTileCodes = 4 * kThreads;          // 8 spans of 128
constexpr int kTileGroups = kTileCodes / 32;
constexpr int kUnpackBlocksPerSm = 8;

// grid: (ceil(n / kTileCodes), rows); block: kThreads.  kVec: n % 4 == 0
// and codes is 16-byte aligned, so each lane's four codes arrive as one
// 16-byte load.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
pack_tiles(const uint32_t* __restrict__ codes, long long n, long long n32, int b,
           uint32_t* __restrict__ words) {
  const long long row = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long span = (long long)blockIdx.x * kTileCodes + 128 * warp;
  if (span >= n) return;                    // the whole warp: no shuffle waits
  const long long e0 = span + 4 * lane;
  const long long at = row * n + e0;
  uint32_t c[4] = {0u, 0u, 0u, 0u};
  if (e0 < n) {
    if (kVec) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(codes + at));
      c[0] = v.x; c[1] = v.y; c[2] = v.z; c[3] = v.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) c[e] = e0 + e < n ? __ldg(codes + at + e) : 0u;
    }
  }
  const long long group = (span >> 5) + (lane >> 3);
  bitplane::pack_words<4>(c, b, lane & 7, group < n32, words + row * n32 * b + group * b);
}

// grid: (blocks a row, rows); block: kThreads.  Block x of row y decodes
// tiles x, x + gridDim.x, ... of the row.  kValues: out is float32 Q_r
// values at r = b - 1 against norm[row]; else uint32 codes.  kVec: n % 4
// == 0 and out is 16-byte aligned, so each lane's four outputs leave as
// one 16-byte store.
template <bool kValues, bool kVec>
__global__ void __launch_bounds__(kThreads, kUnpackBlocksPerSm)
unpack_tiles(const uint32_t* __restrict__ words, long long n, long long n32, int b,
             int tiles, const float* __restrict__ norm, void* __restrict__ out) {
  const long long row = blockIdx.y;
  const uint32_t* wrow = words + row * n32 * b;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gl = 4 * warp + (lane >> 3);          // the lane's group in the tile
  const int shift = 4 * (lane & 7);               // its nibble in each word
  float nr = 0.0f, ns = 0.0f, scale = 0.0f;
  uint32_t mag = 0u;
  if (kValues) {
    const int r = b - 1;
    nr = norm[row];
    ns = -nr;
    scale = __uint_as_float((uint32_t)(127 - r) << 23);   // 2^-r, exact
    mag = (1u << r) - 1u;
  }
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    // Keeps the block's warps on one tile, so its 4 KB of output leave
    // together (measured faster at (4, 2^24): tools/k7_k9_ablation.py).
    __syncthreads();
    const long long e0 = (long long)tile * kTileCodes + 128 * warp + 4 * lane;
    if (e0 < n) {
      const uint32_t* sw = wrow + ((long long)tile * kTileGroups + gl) * b;
      uint32_t acc[4] = {0u, 0u, 0u, 0u};           // byte e: code e's bits 8j..
#pragma unroll
      for (int t = 0; t < 32; ++t) {
        if (t >= b) break;
        const uint32_t nib = (sw[t] >> shift) & 0xFu;
        acc[t >> 3] |= (nib * (0x00204081u << (t & 7))) & (0x01010101u << (t & 7));
      }
      const uint32_t p01 = __byte_perm(acc[0], acc[1], 0x5140);
      const uint32_t q01 = __byte_perm(acc[0], acc[1], 0x7362);
      const uint32_t p23 = __byte_perm(acc[2], acc[3], 0x5140);
      const uint32_t q23 = __byte_perm(acc[2], acc[3], 0x7362);
      const uint32_t c[4] = {__byte_perm(p01, p23, 0x5410), __byte_perm(p01, p23, 0x7632),
                             __byte_perm(q01, q23, 0x5410), __byte_perm(q01, q23, 0x7632)};
      const long long at = row * n + e0;
      if (kValues) {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float q = __fmul_rn((c[e] >> (b - 1)) & 1u ? ns : nr,
                                    __fmul_rn((float)(c[e] & mag), scale));
          v[e] = nr > 0.0f ? q : 0.0f;
        }
        float* o = static_cast<float*>(out);
        if (kVec) {
          *reinterpret_cast<float4*>(o + at) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (e0 + e < n) o[at + e] = v[e];
        }
      } else {
        uint32_t* o = static_cast<uint32_t*>(out);
        if (kVec) {
          *reinterpret_cast<uint4*>(o + at) = make_uint4(c[0], c[1], c[2], c[3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (e0 + e < n) o[at + e] = c[e];
        }
      }
    }
  }
}

template <bool kValues>
int launch_unpack(const uint32_t* words, int rows, long long n, int b, const float* norm,
                  void* out, cudaStream_t stream) {
  const long long n32 = (n + 31) / 32;
  const long long tiles = (n + kTileCodes - 1) / kTileCodes;
  if (tiles > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  // one wave: kUnpackBlocksPerSm blocks an SM over all rows, at least one a row
  long long per_row = (long long)kSms * kUnpackBlocksPerSm / rows;
  if (per_row < 1) per_row = 1;
  if (per_row > tiles) per_row = tiles;
  const dim3 grid((unsigned)per_row, (unsigned)rows);
  const bool vec = n % 4 == 0 && ((uintptr_t)out & 15) == 0;
  if (vec)
    unpack_tiles<kValues, true><<<grid, kThreads, 0, stream>>>(words, n, n32, b, (int)tiles,
                                                               norm, out);
  else
    unpack_tiles<kValues, false><<<grid, kThreads, 0, stream>>>(words, n, n32, b, (int)tiles,
                                                                norm, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* pack_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// K8: words (rows, ceil(n/32) * b) from codes (rows, n), 1 <= b <= 32.
int pack_codes(const uint32_t* codes, int rows, long long n, int b, uint32_t* words,
               void* stream_ptr) {
  if (b < 1 || b > 32) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const long long n32 = (n + 31) / 32;
  const long long tiles = (n + kTileCodes - 1) / kTileCodes;
  if (tiles > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, (unsigned)rows);
  if (n % 4 == 0 && ((uintptr_t)codes & 15) == 0)
    pack_tiles<true><<<grid, kThreads, 0, stream>>>(codes, n, n32, b, words);
  else
    pack_tiles<false><<<grid, kThreads, 0, stream>>>(codes, n, n32, b, words);
  return (int)cudaGetLastError();
}

// K9: codes (rows, n) from words (rows, ceil(n/32) * b), 1 <= b <= 32; words
// 4-byte aligned.
int unpack_codes(const uint32_t* words, int rows, long long n, int b, uint32_t* codes,
                 void* stream_ptr) {
  if (b < 1 || b > 32) return (int)cudaErrorInvalidValue;
  return launch_unpack<false>(words, rows, n, b, nullptr, codes, (cudaStream_t)stream_ptr);
}

// K9 decoding to Q_r values: out (rows, n) float32 from words (rows,
// ceil(n/32) * (1 + r)) and norm (rows,), 1 <= r <= 31.
int unpack_qr_values(const uint32_t* words, int rows, long long n, int r, const float* norm,
                     float* out, void* stream_ptr) {
  if (r < 1 || r > 31) return (int)cudaErrorInvalidValue;
  return launch_unpack<true>(words, rows, n, 1 + r, norm, out, (cudaStream_t)stream_ptr);
}

}  // extern "C"
