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
// one norm per row.  The uniforms are drawn outside (jax's threefry
// stream, reproduced bit for bit by repro_torch.prng) and streamed in, as
// the TPU kernel does, so K4 is bit-equal to the plain version for the
// same norm and uniforms.
//
// K3 is one deterministic launch: every block writes its partial sum (fixed
// strided order, float4 loads where the row allows, fixed shared-memory
// tree) to a scratch buffer; the last block of a row to finish, which it
// learns from an atomic counter per row after a __threadfence(), sums that
// row's partials in index order, takes sqrtf and resets the counter to 0.
// The order of every sum depends only on (rows, n) and whether x is 16-byte
// aligned, never on which block finishes last.  Float atomics would make two runs give different norms,
// and so different Q_r trajectories.
//
// This file is compiled with --fmad=false: K4 must keep the reference's
// operation order (y = |x|/safe, scaled = L*y, lo = floor(scaled),
// frac = scaled - lo, (lo + [u<frac]) / L, norm*sgn*xi), and a fused
// multiply-add in scaled - lo would change frac's bits.  No fast math:
// IEEE division and sqrtf are required.
//
// Bound on an H100 SXM (3.35 TB/s): K3 reads 4n bytes; K4 reads 8n (x and
// u) and writes 4n bytes.  At the main path's sizes (5 clients x 50176
// floats, about 1 MB) launch latency, not bandwidth, is the floor.  Drawing
// the uniforms in-kernel with threefry (saving 4n bytes) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPartials = 512;    // K3 blocks a row, at most
constexpr int kMaxBlocks = 132 * 16;

// grid: (parts, rows); block: kThreads.  vec4: rows are 16-byte aligned
// and n % 4 == 0, so x is read as float4.  partial holds rows * parts
// floats; count holds rows counters, 0 on entry and left at 0.
__global__ void sumsq_norm(const float* __restrict__ x, long long n, int vec4,
                           float* __restrict__ partial,
                           unsigned int* __restrict__ count,
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
      norm[row] = sqrtf(s);
      count[row] = 0;
    }
  }
}

__global__ void qr_round(const float* __restrict__ x, const float* __restrict__ u,
                         const float* __restrict__ norm, float* __restrict__ out,
                         long long n, long long total, float levels) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const float nr = norm[i / n];
    const float xv = x[i];
    const float safe = nr > 0.0f ? nr : 1.0f;
    const float y = fabsf(xv) / safe;
    const float scaled = levels * y;
    const float lo = floorf(scaled);
    const float frac = scaled - lo;
    const float xi = (lo + (u[i] < frac ? 1.0f : 0.0f)) / levels;
    // jnp.sign: +-1, and x itself at +-0 (and NaN)
    const float sgn = xv > 0.0f ? 1.0f : (xv < 0.0f ? -1.0f : xv);
    const float o = nr * sgn * xi;
    out[i] = nr > 0.0f ? o : 0.0f;
  }
}

}  // namespace

#define RETURN_IF_ERROR()                          \
  do {                                             \
    cudaError_t err_ = cudaGetLastError();         \
    if (err_ != cudaSuccess) return (int)err_;     \
  } while (0)

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
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (parts < 1 || parts > kMaxPartials) return (int)cudaErrorInvalidValue;
  const int vec4 = n % 4 == 0 && ((uintptr_t)x & 15) == 0;
  const dim3 grid((unsigned int)parts, (unsigned int)rows);
  sumsq_norm<<<grid, kThreads, 0, stream>>>(x, n, vec4, partial, count, norm);
  RETURN_IF_ERROR();
  return 0;
}

// K4: Q_r of every row against its norm, with uniforms u (rows, n) and
// levels = 2^r.
int qr_quantize(const float* x, const float* u, const float* norm, float* out, int rows,
                long long n, float levels, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const long long total = (long long)rows * n;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  qr_round<<<(unsigned int)blocks, kThreads, 0, stream>>>(x, u, norm, out, n, total,
                                                          levels);
  RETURN_IF_ERROR();
  return 0;
}

}  // extern "C"
