// RWKV6 "Finch" WKV recurrence (K12) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/wkv6.py:wkv6_scan
// (_wkv6_kernel).  Per (batch, head), with the state S in R^{64 x 64}:
//
//     y_t = (S_{t-1} + diag(u) k_t v_t^T)^T r_t
//     S_t = diag(w_t) S_{t-1} + k_t v_t^T,          S_0 = 0.
//
// The TPU kernel walks a sequential (B, H, T/bt) grid and keeps S in VMEM
// scratch between time blocks.  Blocks on Hopper run in no order, so the
// time axis is a loop inside the block: one block of 64 threads per
// (b, h), thread j owns the value column S[:, j] (64 floats in
// registers).  Each step stages r_t, k_t, w_t and v_t (64 values each) in
// shared memory; every thread then reads the staged vectors as broadcasts,
// forms y_j = sum_i r_i * (S_ij + u_i * k_i * v_j) in a fixed i order and
// updates S_ij = w_i * S_ij + k_i * v_j.  Step t+1's inputs are loaded
// into registers before step t computes, and the staging is double
// buffered, so one __syncthreads a step suffices.
//
// The state update keeps the reference's operation order with
// __fmul_rn/__fadd_rn (never contracted into an FMA): kv = k*v,
// S + u*kv, w*S + kv.  So S_T has the plain version's bits; y's 64-term
// sum runs in FMAs, in another order than the plain einsum, and is held
// to a tolerance.
//
// r, k, v come in float32 or bfloat16 (the model's dtype; all three
// alike), w and u in float32, as prefill passes them, with no cast pass:
// the kernel converts on load.  r/k/v/w may be strided views (the
// (B, T, H, 64) activations seen as (B, H, T, 64)); the last dimension
// must be dense.  y is written through its own strides at r's dtype, S_T
// (B, H, 64, 64) float32.
//
// Bound on an H100 SXM: the function needs 5 float32 operations per state
// entry per step (y = S^T r + (sum_i r_i u_i k_i) v: one FMA an entry
// plus 5 a column; S <- diag(w) S + k v^T: a multiply, a multiply and an
// add) = 5 * 64 * 65 per (b, h, t); at the serving shape (8, 40, 2560, 64)
// that is 17.0 GFLOP, 0.25 ms at 67 TFLOP/s, against ~0.19 ms for the
// bytes.  This kernel does 7 an entry (kv, u*kv, +S, r*, +y, w*S, +kv),
// as the plain version does.  The design does not reach the bound:
// 320 blocks of two warps leave most of the 132 SMs' issue slots idle, and
// each step waits on a barrier.  Chunked-parallel forms (intra-chunk
// matrix products on the tensor cores, the state passed between chunks)
// are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHead = 64;   // K = V = 64, the only head size the models use

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// grid: B*H blocks (block = b*H + h); block: 64 threads (thread = column j).
// sb/sh/st: strides in elements of the (b, h, t) axes of r, k, v and w
// (shared by the four); yb/yh/yt: those of y.
template <typename T>
__global__ void __launch_bounds__(kHead)
wkv6_fwd(const T* __restrict__ r, const T* __restrict__ k,
         const T* __restrict__ v, const float* __restrict__ w,
         const float* __restrict__ u, int H, int steps, long long sb,
         long long sh, long long st, long long yb, long long yh, long long yt,
         T* __restrict__ y, float* __restrict__ s_out) {
  __shared__ float sr[2][kHead], sk[2][kHead], sw[2][kHead], sv[2][kHead];
  __shared__ float su[kHead];
  const int j = threadIdx.x;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const long long in0 = (long long)b * sb + (long long)h * sh + j;
  const long long out0 = (long long)b * yb + (long long)h * yh + j;

  float S[kHead];
#pragma unroll
  for (int i = 0; i < kHead; ++i) S[i] = 0.0f;

  su[j] = u[h * kHead + j];
  sr[0][j] = load_f32(r + in0);
  sk[0][j] = load_f32(k + in0);
  sv[0][j] = load_f32(v + in0);
  sw[0][j] = w[in0];
  __syncthreads();

  for (int t = 0; t < steps; ++t) {
    const int cur = t & 1;
    float nr = 0.0f, nk = 0.0f, nv = 0.0f, nw = 0.0f;
    if (t + 1 < steps) {                  // prefetch step t+1
      const long long off = in0 + (long long)(t + 1) * st;
      nr = load_f32(r + off);
      nk = load_f32(k + off);
      nv = load_f32(v + off);
      nw = w[off];
    }
    const float vj = sv[cur][j];
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < kHead; ++i) {
      const float kv = __fmul_rn(sk[cur][i], vj);
      const float inner = __fadd_rn(S[i], __fmul_rn(su[i], kv));
      acc = fmaf(sr[cur][i], inner, acc);
      S[i] = __fadd_rn(__fmul_rn(sw[cur][i], S[i]), kv);
    }
    store_out(y + out0 + (long long)t * yt, acc);
    if (t + 1 < steps) {
      const int nxt = cur ^ 1;
      sr[nxt][j] = nr;
      sk[nxt][j] = nk;
      sv[nxt][j] = nv;
      sw[nxt][j] = nw;
    }
    __syncthreads();
  }
  float* so = s_out + (long long)blockIdx.x * kHead * kHead + j;
#pragma unroll
  for (int i = 0; i < kHead; ++i) so[i * kHead] = S[i];
}

}  // namespace

#define RETURN_IF_ERROR()                          \
  do {                                             \
    cudaError_t err_ = cudaGetLastError();         \
    if (err_ != cudaSuccess) return (int)err_;     \
  } while (0)

extern "C" {

const char* wkv6_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// K12.  r, k, v: (B, H, T, 64) at float32 (bf16 == 0) or bfloat16
// (bf16 == 1), read through the (b, h, t) strides sb/sh/st; w the same
// shape and strides in float32; u (H, 64) float32.  Writes y (at r's
// dtype, through yb/yh/yt) and S_T (B, H, 64, 64) float32.  T >= 1.
int wkv6_scan(const void* r, const void* k, const void* v, const float* w,
              const float* u, int B, int H, int T, long long sb, long long sh,
              long long st, int bf16, long long yb, long long yh, long long yt,
              void* y, float* s_out, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int blocks = B * H;
  if (bf16) {
    using T16 = __nv_bfloat16;
    wkv6_fwd<T16><<<blocks, kHead, 0, stream>>>(
        (const T16*)r, (const T16*)k, (const T16*)v, w, u, H, T, sb, sh, st,
        yb, yh, yt, (T16*)y, s_out);
  } else {
    wkv6_fwd<float><<<blocks, kHead, 0, stream>>>(
        (const float*)r, (const float*)k, (const float*)v, w, u, H, T, sb, sh,
        st, yb, yh, yt, (float*)y, s_out);
  }
  RETURN_IF_ERROR();
  return 0;
}

}  // extern "C"
