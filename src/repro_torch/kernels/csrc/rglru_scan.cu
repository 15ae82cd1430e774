// RG-LRU recurrence (K11) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru_scan.py:rglru_scan
// (_rglru_kernel), elementwise over the channels:
//
//     h_t = a_t * h_{t-1} + sqrt(max(1 - a_t^2, 0)) * x_t,    h_0 = 0.
//
// The TPU kernel walks a sequential (B, D/bd, T/bt) grid and keeps h in
// VMEM scratch between time blocks.  Here one thread owns one (b, d)
// channel and loops over T with h in a register.  Neighbouring threads
// take neighbouring d, so every load of x_t, a_t and every store of y_t is
// one coalesced 128-byte line per warp.  The loop is unrolled by kUnroll:
// the kUnroll independent (x, a) loads are issued before the dependent
// chain of h updates that consumes them.
//
// This file is compiled with --fmad=false and keeps the reference's
// operation order: gx = sqrtf(fmaxf(1 - a*a, 0)) * x, then h = a*h + gx,
// each product and sum rounded on its own (IEEE sqrtf, no fast math), as
// the plain PyTorch version runs them one op at a time.  So y and h_T are
// bit-equal to the plain version on the card.
//
// Input x, a: (B, T, D) float32, contiguous.  Output y (B, T, D) float32
// and h_T (B, D) float32.
//
// Bound on an H100 SXM (3.35 TB/s): 12 bytes a (b, t, d) element (x, a in,
// y out), 629 MB at the serving shape (8, 2560, 2560), 0.19 ms; 6 flops an
// element (0.039 GFLOP) are far below the float32 peak.  B*D = 20 480
// threads are only 80 blocks of 256, fewer than the 132 SMs, so the
// kernel is bound by the latency of its serial chain, not by bytes.  A
// chunked two-pass scan over T (chunk-local scans in parallel, then the
// carried h applied through the cumulative products of a) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;

// grid: (ceil(D / kThreads), B); block: kThreads.
__global__ void __launch_bounds__(kThreads)
rglru_fwd(const float* __restrict__ x, const float* __restrict__ a, int T,
          int D, float* __restrict__ y, float* __restrict__ h_out) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  if (d >= D) return;
  const long long base = (long long)blockIdx.y * T * D + d;
  float h = 0.0f;
  int t = 0;
  for (; t + kUnroll <= T; t += kUnroll) {
    float xs[kUnroll], as[kUnroll];
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const long long off = base + (long long)(t + i) * D;
      xs[i] = x[off];
      as[i] = a[off];
    }
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const float gx = sqrtf(fmaxf(1.0f - as[i] * as[i], 0.0f)) * xs[i];
      h = as[i] * h + gx;
      y[base + (long long)(t + i) * D] = h;
    }
  }
  for (; t < T; ++t) {
    const long long off = base + (long long)t * D;
    const float at = a[off];
    const float gx = sqrtf(fmaxf(1.0f - at * at, 0.0f)) * x[off];
    h = at * h + gx;
    y[off] = h;
  }
  h_out[(long long)blockIdx.y * D + d] = h;
}

}  // namespace

#define RETURN_IF_ERROR()                          \
  do {                                             \
    cudaError_t err_ = cudaGetLastError();         \
    if (err_ != cudaSuccess) return (int)err_;     \
  } while (0)

extern "C" {

const char* rglru_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// K11.  x, a: (B, T, D) float32 contiguous; writes y (B, T, D) and
// h_T (B, D), float32.  1 <= B <= 65535, T >= 1.
int rglru_scan(const float* x, const float* a, int B, int T, int D, float* y,
               float* h_out, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  dim3 grid((D + kThreads - 1) / kThreads, B);
  rglru_fwd<<<grid, kThreads, 0, stream>>>(x, a, T, D, y, h_out);
  RETURN_IF_ERROR();
  return 0;
}

}  // extern "C"
