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
// K3 is deterministic: every block writes its partial sum (fixed strided
// order, fixed shared-memory tree) to a scratch buffer and a second small
// kernel sums a row's partials in index order and takes sqrtf.  Float
// atomics would make two runs give different norms, and so different Q_r
// trajectories.
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
constexpr long long kChunk = 8192;   // elements per sum-of-squares block
constexpr int kMaxPartials = 512;    // per-row block cap
constexpr int kMaxBlocks = 132 * 16;

// grid: (partials per row, rows); block: kThreads.
__global__ void sumsq_partial(const float* __restrict__ x, long long n,
                              float* __restrict__ partial) {
  __shared__ float sh[kThreads];
  const int row = blockIdx.y;
  const float* xr = x + (long long)row * n;
  const long long stride = (long long)gridDim.x * blockDim.x;
  float acc = 0.0f;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float v = xr[i];
    acc += v * v;
  }
  sh[threadIdx.x] = acc;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) sh[threadIdx.x] += sh[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) partial[(long long)row * gridDim.x + blockIdx.x] = sh[0];
}

// grid: ceil(rows / kThreads); one thread per row, partials in order.
__global__ void sumsq_finish(const float* __restrict__ partial, int parts, int rows,
                             float* __restrict__ norm) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  float s = 0.0f;
  for (int j = 0; j < parts; ++j) s += partial[(long long)row * parts + j];
  norm[row] = sqrtf(s);
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

// Number of per-row partial sums K3 uses for a row of n elements; the
// caller allocates the (rows, parts) float32 scratch.
int qr_norm_parts(int rows, long long n) {
  long long parts = (n + kChunk - 1) / kChunk;
  long long cap = kMaxBlocks / (rows > 0 ? rows : 1);
  if (cap > kMaxPartials) cap = kMaxPartials;
  if (parts > cap) parts = cap;
  return parts < 1 ? 1 : (int)parts;
}

// K3: norm[row] = sqrtf(sum_i x[row, i]^2), deterministic.
int qr_l2_norm(const float* x, int rows, long long n, float* partial, int parts,
               float* norm, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const dim3 grid((unsigned int)parts, (unsigned int)rows);
  sumsq_partial<<<grid, kThreads, 0, stream>>>(x, n, partial);
  RETURN_IF_ERROR();
  sumsq_finish<<<(rows + kThreads - 1) / kThreads, kThreads, 0, stream>>>(partial, parts,
                                                                          rows, norm);
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
