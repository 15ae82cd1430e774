// The bit-plane pack in registers, shared by K7 (csrc/qr_pack.cu) and K8
// (csrc/pack_codes.cu).
//
// Wire layout (JAX src/repro/kernels/pack_codes.py): n b-bit codes go into
// ceil(n/32) * b words; word j*b + t holds bit t of group j's 32 codes, code
// 32j + l at bit l.
//
// Lane layout: a warp owns a 128-code span (four groups of 32), lane l codes
// 4l..4l+3 of it, which are bits 4k..4k+3 (k = l % 8) of each of group l/8's
// b words.  For each byte slice j of the codes (planes 8j..8j+7): three
// byte permutes gather the four codes' byte j into one word A (byte e = code
// e's), four delta swaps transpose it so that nibble s holds plane 8j+s's
// four bits, and three butterfly steps over the group's 8 lanes (rotate,
// __shfl_xor_sync, bitwise select) transpose the 8 x 8 nibbles, after which
// lane k holds word 8j + k of its group whole.  Bits of a code at or above
// b only reach words 8j + k >= b, which are not stored: they are ignored,
// as the reference ignores them.  ~28 integer operations a slice for four
// codes.  tests/test_torch_pack.py mirrors it in numpy for every b in 1..32.

#pragma once

#include <stdint.h>

namespace bitplane {

constexpr unsigned kFull = 0xFFFFFFFFu;

template <int kDelta>
__device__ __forceinline__ uint32_t delta_swap(uint32_t x, uint32_t mask) {
  const uint32_t t = (x ^ (x >> kDelta)) & mask;
  return x ^ t ^ (t << kDelta);
}

// Bit 8e + s of a (code e's bit s of the slice) to bit 4s + e: the 5-bit
// index rotated by two, as four swaps of index bits (1,0), (2,1), (3,0),
// (4,1).
__device__ __forceinline__ uint32_t bytes_to_nibbles(uint32_t a) {
  a = delta_swap<1>(a, 0x22222222u);
  a = delta_swap<2>(a, 0x0C0C0C0Cu);
  a = delta_swap<7>(a, 0x00AA00AAu);
  return delta_swap<14>(a, 0x0000CCCCu);
}

// One butterfly step of the 8 x 8 nibble transpose over a group's lanes:
// lanes k and k ^ d swap the nibbles s with bit d of s unlike bit d of k.
template <int kD>
__device__ __forceinline__ uint32_t nibble_step(uint32_t x, int k) {
  constexpr uint32_t kLow = kD == 4 ? 0x0000FFFFu : (kD == 2 ? 0x00FF00FFu : 0x0F0F0F0Fu);
  const bool high = (k & kD) != 0;
  const uint32_t sent = __funnelshift_l(x, x, high ? 4 * kD : 32 - 4 * kD);
  const uint32_t got = __shfl_xor_sync(kFull, sent, kD);
  const uint32_t keep = high ? ~kLow : kLow;
  return (x & keep) | (got & ~keep);
}

// Packs the lane's four codes c (codes 4l..4l+3 of its warp's span, lane l,
// k = l % 8) into its group's words: lane k stores word 8j + k at wg[8j + k]
// for each slice j < kSlices with 8j + k < b, when `stores`.  Every lane of
// the warp must call it (the shuffles); b is the same across the warp.
// kSlices = ceil(the widest b / 8).
template <int kSlices>
__device__ __forceinline__ void pack_words(const uint32_t (&c)[4], int b, int k, bool stores,
                                           uint32_t* __restrict__ wg) {
#pragma unroll
  for (int j = 0; j < kSlices; ++j) {
    if (8 * j >= b) break;
    const unsigned sel = (unsigned)j | ((unsigned)(4 + j) << 4);
    uint32_t a = __byte_perm(__byte_perm(c[0], c[1], sel), __byte_perm(c[2], c[3], sel),
                             0x5410);
    a = bytes_to_nibbles(a);
    a = nibble_step<4>(a, k);
    a = nibble_step<2>(a, k);
    a = nibble_step<1>(a, k);
    if (stores && 8 * j + k < b) wg[8 * j + k] = a;
  }
}

}  // namespace bitplane
