// QSGD Q_r: sum of squares (K3) and stochastic rounding (K4) for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernels in src/repro/kernels/quantize.py:
//   K3  l2_norm (_sumsq_kernel): sqrt(sum x^2) over a float32 sum;
//   K4  quantize_qr_with_uniforms (_quant_kernel):
//       out = norm * sgn(x) * (floor(L*y) + [u < frac]) / L,
//       y = |x| / norm, L = 2^r, and 0 where norm == 0.
//
// Input is row-batched: (rows, n) float32, one row per client's leaf, with
// one norm per row.  K4 has two entries, one kernel body:
//   * qr_quantize reads the uniforms u (rows, n), as the TPU kernel does:
//     bit-equal to the plain version for the same norm and uniforms;
//   * qr_quantize_keyed draws them itself, row i's as
//     jax.random.uniform(key_i, (n,)) with threefry2x32 in registers
//     (threefry.cuh), bit for bit the stream repro_torch.prng draws with
//     torch ops.  The main path (ops.quantize_qr) calls it, so a leaf's Q_r
//     is K3 and K4 alone, where the torch draw took ~177 device operations.
//     Up to 32 rows' key words ride in the launch's parameters (no copy).
//     It takes the level count L either as one scalar for every row or as
//     a (rows,) float32 array on the device, one L = 2^r_i a row: a
//     per-client r override gives each client's row its own r, which the
//     JAX package runs as its jnp oracle with levels = float32(2 ** r).
// K4 is a 2-D grid of (row, 1024-element block of the row), four
// consecutive elements a thread, moved as float4 where the row allows.
//
// K3 is one deterministic launch: every block writes its partial sum (fixed
// strided order, float4 loads where the row allows, fixed shared-memory
// tree) to a scratch buffer; the last block of a row to finish, which it
// learns from an atomic counter per row after a __threadfence(), sums that
// row's partials in index order, takes sqrtf and resets the counter to 0.
// The order of every sum depends only on (rows, n) and whether x is 16-byte
// aligned, never on which block finishes last.  Float atomics would make two runs give different norms,
// and so different Q_r trajectories.  K3 has a second entry, qr_sum_squares,
// the same launch without the final sqrtf: the model-sharded wire sums each
// shard's sum of squares over the model ranks and takes the square root of
// the total (the norm of the whole sharded leaf).
//
// This file is compiled with --fmad=false: K4 must keep the reference's
// operation order (y = |x|/safe, scaled = L*y, lo = floor(scaled),
// frac = scaled - lo, (lo + [u<frac]) / L, norm*sgn*xi), and a fused
// multiply-add in scaled - lo would change frac's bits.  No fast math:
// IEEE division and sqrtf are required.
//
// Bound on an H100 SXM (3.35 TB/s): K3 reads 4n bytes; K4 reads 8n (x and
// u) and writes 4n bytes; keyed, it reads 4n and writes 4n, and the
// uniform takes 43 operations an element on the ALU pipe (20 rotates and
// 20 xors over the rounds, then xor, shift and or) and 31 adds that may
// issue there or as IMAD on the FMA pipe (64 lanes an SM each), so at
// (4, 2^24) the integer pipe, not the bytes, may bound it.  At
// the main path's sizes (5 clients x 50176 floats, about 1 MB) launch
// latency, not bandwidth, is the floor.  PERF.md has the times and both
// terms of the keyed bound, on an NVIDIA H100 80GB HBM3 at 700 W
// (chip_smoke.py, tools/k4_k5_ablation.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPartials = 512;    // K3 blocks a row, at most

// grid: (parts, rows); block: kThreads.  vec4: rows are 16-byte aligned
// and n % 4 == 0, so x is read as float4.  partial holds rows * parts
// floats; count holds rows counters, 0 on entry and left at 0.
// take_sqrt: norm[row] is sqrtf of the sum (K3), else the sum itself.
__global__ void sumsq_norm(const float* __restrict__ x, long long n, int vec4,
                           float* __restrict__ partial,
                           unsigned int* __restrict__ count, int take_sqrt,
                           float* __restrict__ norm) {
  __shared__ float sh[kThreads];
  __shared__ float part_sh[kMaxPartials];
  __shared__ bool last;
  const int row = blockIdx.y;
  const int parts = gridDim.x;
  const float* xr = x + (long long)row * n;
  const long long stride = (long long)parts * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float acc = 0.0f;
  if (vec4) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
#pragma unroll 4
    for (long long i = first; i < n / 4; i += stride) {
      const float4 v = x4[i];
      acc += v.x * v.x;
      acc += v.y * v.y;
      acc += v.z * v.z;
      acc += v.w * v.w;
    }
  } else {
    for (long long i = first; i < n; i += stride) {
      const float v = xr[i];
      acc += v * v;
    }
  }
  sh[threadIdx.x] = acc;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) sh[threadIdx.x] += sh[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    partial[(long long)row * parts + blockIdx.x] = sh[0];
    __threadfence();
    last = atomicAdd(&count[row], 1u) == (unsigned int)parts - 1;
  }
  __syncthreads();
  if (last) {                       // gather the row's partials, then sum
    __threadfence();                 // them in index order on one thread
    const volatile float* pr = partial + (long long)row * parts;
    for (int j = threadIdx.x; j < parts; j += kThreads) part_sh[j] = pr[j];
    __syncthreads();
    if (threadIdx.x == 0) {
      float s = 0.0f;
      for (int j = 0; j < parts; ++j) s += part_sh[j];
      norm[row] = take_sqrt ? sqrtf(s) : s;
      count[row] = 0;
    }
  }
}

// grid: (ceil(n / (4 kThreads)), rows); block: kThreads.  Thread t of
// block b holds elements 4 (b kThreads + t) + 0..3 of row blockIdx.y.
// kKeyed: u is drawn here, jax.random.uniform(keys[row], (n,)) bit for
// bit; else it is read from u.  kVec: x, u and out are 16-byte aligned and
// n % 4 == 0, so they move as float4.
template <bool kKeyed, bool kVec>
__global__ void __launch_bounds__(kThreads)
qr_round(const float* __restrict__ x, const float* __restrict__ u,
         const __grid_constant__ ThreefryKeys keys, const float* __restrict__ norm,
         float* __restrict__ out, long long n, float levels,
         const float* __restrict__ row_levels) {
  const long long row = blockIdx.y;
  const long long e0 = 4LL * ((long long)blockIdx.x * kThreads + threadIdx.x);
  if (e0 >= n) return;
  const long long at = row * n + e0;
  float xv[4], uv[4];
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
  const float nr = norm[row];
  if (row_levels != nullptr) levels = row_levels[row];
  const float safe = nr > 0.0f ? nr : 1.0f;
  float o[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float y = fabsf(xv[e]) / safe;
    const float scaled = levels * y;
    const float lo = floorf(scaled);
    const float frac = scaled - lo;
    const float xi = (lo + (uv[e] < frac ? 1.0f : 0.0f)) / levels;
    // jnp.sign: +-1, and x itself at +-0 (and NaN)
    const float sgn = xv[e] > 0.0f ? 1.0f : (xv[e] < 0.0f ? -1.0f : xv[e]);
    const float q = nr * sgn * xi;
    o[e] = nr > 0.0f ? q : 0.0f;
  }
  if (kVec) {
    *reinterpret_cast<float4*>(out + at) = make_float4(o[0], o[1], o[2], o[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e0 + e < n) out[at + e] = o[e];
  }
}

int launch_sumsq(const float* x, int rows, long long n, float* partial,
                 unsigned int* count, int parts, int take_sqrt, float* out,
                 cudaStream_t stream) {
  if (parts < 1 || parts > kMaxPartials) return (int)cudaErrorInvalidValue;
  const int vec4 = n % 4 == 0 && ((uintptr_t)x & 15) == 0;
  const dim3 grid((unsigned int)parts, (unsigned int)rows);
  sumsq_norm<<<grid, kThreads, 0, stream>>>(x, n, vec4, partial, count, take_sqrt,
                                           out);
  return (int)cudaGetLastError();
}

template <bool kKeyed>
int launch_round(const float* x, const float* u, const ThreefryKeys& keys, const float* norm,
                 float* out, int rows, long long n, float levels, const float* row_levels,
                 cudaStream_t stream) {
  const dim3 grid((unsigned)((n + 4LL * kThreads - 1) / (4LL * kThreads)), (unsigned)rows);
  const bool vec = n % 4 == 0 && ((uintptr_t)x & 15) == 0 && ((uintptr_t)out & 15) == 0 &&
                   (kKeyed || ((uintptr_t)u & 15) == 0);
  if (vec)
    qr_round<kKeyed, true><<<grid, kThreads, 0, stream>>>(x, u, keys, norm, out, n, levels,
                                                          row_levels);
  else
    qr_round<kKeyed, false><<<grid, kThreads, 0, stream>>>(x, u, keys, norm, out, n, levels,
                                                           row_levels);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* qr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// K3: norm[row] = sqrtf(sum_i x[row, i]^2), deterministic, one launch of
// (parts, rows) blocks, 1 <= parts <= 512 (the caller's choice: about one
// block a 8192 elements, at most 2112 blocks in all).  partial holds rows *
// parts floats and count rows uint32 counters, zeroed once: every launch
// leaves them at 0.
int qr_l2_norm(const float* x, int rows, long long n, float* partial,
               unsigned int* count, int parts, float* norm,
               void* stream_ptr) {
  return launch_sumsq(x, rows, n, partial, count, parts, 1, norm,
                      (cudaStream_t)stream_ptr);
}

// K3 without its sqrtf: out[row] = sum_i x[row, i]^2, the sum K3 takes the
// square root of, bit for bit (same launch, same order).
int qr_sum_squares(const float* x, int rows, long long n, float* partial,
                   unsigned int* count, int parts, float* out,
                   void* stream_ptr) {
  return launch_sumsq(x, rows, n, partial, count, parts, 0, out,
                      (cudaStream_t)stream_ptr);
}

// K4 reading its uniforms: Q_r of every row against its norm, with u
// (rows, n) and levels = 2^r.
int qr_quantize(const float* x, const float* u, const float* norm, float* out, int rows,
                long long n, float levels, void* stream_ptr) {
  const ThreefryKeys none = {};
  return launch_round<false>(x, u, none, norm, out, rows, n, levels, nullptr,
                             (cudaStream_t)stream_ptr);
}

// K4 drawing its uniforms: row i's are jax.random.uniform(key_i, (n,)), n <
// 2^32, key_i = (keys[2 i], keys[2 i + 1]) (int64 holding uint32).  keys_dev
// is the (rows, 2) key data on the device; when it is null, keys_host holds
// them on the host (rows <= 32) and they travel in the launch's
// parameters.  row_levels, when not null, is the (rows,) float32 level
// count of each row on the device, 2^r_i, and levels is not read.
int qr_quantize_keyed(const float* x, const long long* keys_dev, const long long* keys_host,
                      const float* norm, float* out, int rows, long long n, float levels,
                      const float* row_levels, void* stream_ptr) {
  if (n >= (1LL << 32)) return (int)cudaErrorInvalidValue;
  ThreefryKeys keys;
  if (!threefry_keys(keys_dev, keys_host, rows, keys)) return (int)cudaErrorInvalidValue;
  return launch_round<true>(x, nullptr, keys, norm, out, rows, n, levels, row_levels,
                            (cudaStream_t)stream_ptr);
}

}  // extern "C"
