// jax's threefry2x32 counter hash and its uniform draw, in registers, and
// the key words a keyed kernel (K4's and K7's keyed entries) takes.
//
// jax.random.uniform(key, (n,)) in jax's partitionable threefry mode (the
// default since jax 0.5) is, for element i < 2^32:
//   (hi, lo) = threefry2x32(key, (0, i)),  bits = hi ^ lo,
//   u = bit_cast<float>((bits >> 9) | 0x3F800000) - 1.0f,
// which repro_torch/prng.py computes with int64 torch ops.  Here it is
// uint32 arithmetic, exact by construction: adds wrap mod 2^32, rotations
// are funnel shifts (one SHF each), and the key schedule (k2 = k0 ^ k1 ^
// 0x1BD11BDA and the five injections) is taken once a thread, so an element
// costs the 20 rounds (add, rotate, xor) and 5 injections (two adds).
// The float step is one exact subtraction of two floats in [1, 2), so it
// needs no --fmad care.

#pragma once

#include <stdint.h>

// The five key injections of threefry2x32 (20 rounds) for one key:
// after rounds 4 i + 1 .. 4 i + 4, x0 += a[i] and x1 += b[i].
struct ThreefrySchedule {
  uint32_t k0, k1;
  uint32_t a[5], b[5];
};

__device__ __forceinline__ ThreefrySchedule threefry_schedule(uint32_t k0, uint32_t k1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  ThreefrySchedule s;
  s.k0 = k0;
  s.k1 = k1;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    s.a[i] = ks[(i + 1) % 3];
    s.b[i] = ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  return s;
}

__device__ __forceinline__ uint32_t threefry_rotl(uint32_t v, int r) {
  return __funnelshift_l(v, v, r);
}

// Four rounds with rotation constants r0..r3.
template <int r0, int r1, int r2, int r3>
__device__ __forceinline__ void threefry_rounds(uint32_t& x0, uint32_t& x1) {
  x0 += x1; x1 = threefry_rotl(x1, r0) ^ x0;
  x0 += x1; x1 = threefry_rotl(x1, r1) ^ x0;
  x0 += x1; x1 = threefry_rotl(x1, r2) ^ x0;
  x0 += x1; x1 = threefry_rotl(x1, r3) ^ x0;
}

// threefry2x32(key, (c0, c1)) -> (x0, x1).
__device__ __forceinline__ void threefry2x32(const ThreefrySchedule& s, uint32_t c0,
                                             uint32_t c1, uint32_t& x0, uint32_t& x1) {
  x0 = c0 + s.k0;
  x1 = c1 + s.k1;
  threefry_rounds<13, 15, 26, 6>(x0, x1);  x0 += s.a[0]; x1 += s.b[0];
  threefry_rounds<17, 29, 16, 24>(x0, x1); x0 += s.a[1]; x1 += s.b[1];
  threefry_rounds<13, 15, 26, 6>(x0, x1);  x0 += s.a[2]; x1 += s.b[2];
  threefry_rounds<17, 29, 16, 24>(x0, x1); x0 += s.a[3]; x1 += s.b[3];
  threefry_rounds<13, 15, 26, 6>(x0, x1);  x0 += s.a[4]; x1 += s.b[4];
}

// jax.random.uniform(key, (n,))[i], float32 in [0, 1).
__device__ __forceinline__ float threefry_uniform(const ThreefrySchedule& s, uint32_t i) {
  uint32_t hi, lo;
  threefry2x32(s, 0u, i, hi, lo);
  return __uint_as_float(((hi ^ lo) >> 9) | 0x3F800000u) - 1.0f;
}

// Where a keyed kernel's key words come from: a (rows, 2) int64 tensor on
// the device (`dev`), or, when `dev` is null, these words, passed by value
// in the launch's parameters (rows <= kKeysByValue; build.KEYS_BY_VALUE on
// the Python side).  A kernel takes it as a __grid_constant__ parameter.
constexpr int kKeysByValue = 32;
struct ThreefryKeys {
  const long long* dev;
  uint32_t word[2 * kKeysByValue];
};

// The keys of a C entry's arguments: key_i = (keys[2 i], keys[2 i + 1])
// (int64 holding uint32) of keys_dev on the device or, when it is null, of
// keys_host on the host, copied into the launch's parameters.  False where
// neither can serve (host keys of more than kKeysByValue rows, or none).
inline bool threefry_keys(const long long* keys_dev, const long long* keys_host, int rows,
                          ThreefryKeys& keys) {
  keys = {};
  keys.dev = keys_dev;
  if (keys_dev != nullptr) return true;
  if (rows > kKeysByValue || keys_host == nullptr) return false;
  for (int i = 0; i < 2 * rows; ++i) keys.word[i] = (uint32_t)keys_host[i];
  return true;
}

// Row `row`'s key schedule.
__device__ __forceinline__ ThreefrySchedule threefry_row_schedule(const ThreefryKeys& keys,
                                                                  long long row) {
  const uint32_t k0 = keys.dev ? (uint32_t)keys.dev[2 * row] : keys.word[2 * row];
  const uint32_t k1 = keys.dev ? (uint32_t)keys.dev[2 * row + 1] : keys.word[2 * row + 1];
  return threefry_schedule(k0, k1);
}
