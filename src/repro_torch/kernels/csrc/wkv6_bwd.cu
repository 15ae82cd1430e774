// The backward of the RWKV6 WKV recurrence (K12's backward) for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package differentiates the two-level scan
// of src/repro/kernels/ref.py:wkv6_scan under jax.vjp, recomputing each
// 64-step chunk's states under remat.  Per (batch, head), with the state
// S_t = diag(w_t) S_{t-1} + k_t v_t^T (S_{-1} = 0) and G_t = dL/dS_t
// (G_{T-1} = 0: S_T carries no gradient), a reverse loop:
//
//     dr_t = S_{t-1} dy_t + u * k_t (v_t . dy_t)
//     dk_t = u * r_t (v_t . dy_t) + G_t v_t
//     dv_t = (r_t . (u * k_t)) dy_t + G_t^T k_t
//     dw_t = rowsum(G_t * S_{t-1})
//     du   = sum over (b, t) of r_t * k_t (v_t . dy_t)
//     G_{t-1} = diag(w_t) G_t + r_t dy_t^T
//
// dw pairs each G_t with S_{t-1}, which runs the other way in time.  S
// cannot be stepped backwards (w = exp(-exp(.)) underflows to 0, and
// dividing by it fails), so it is recomputed: a first pass runs the
// forward recurrence and stores S every kC = 8 steps (ckpt: (B*H, T/8, 64,
// 64) float32, 671 MB at rwkv6-3b's training shape (2, 40, 4096)); the
// second pass walks those 8-step sub-chunks from the last, recomputes each
// one's eight S_{t-1} from its checkpoint into shared memory (128 KB),
// then steps G back through them.  The reference's chunk is 64 steps; 64
// states of 16 KB do not fit in a block's shared memory, 8 do.
//
// One block of 256 threads per (b, h).  Thread (i, q) = (tid / 4, tid % 4)
// owns row i of S and G at the columns j = q + 4 m, m < 16, in registers.
// The row sums (dr, dk, dw) close with two xor shuffles among a row's four
// threads; dv's column sums over i run as a reduce-scatter over the warp's
// eight rows (14 shuffles) and a sum over the eight warps' partials in
// shared memory once a sub-chunk.  States and checkpoints are stored in
// thread order (entry m of thread tid at m * 256 + tid), which only the
// thread that wrote an entry reads back: no bank conflicts, coalesced
// checkpoints.  The scalars r_t . (u * k_t) and v_t . dy_t are one warp's
// shuffle sum a step.  du leaves as (B*H, 64) partials that the wrapper
// sums over B in a fixed order (deterministic).
//
// r, k, v and dy are read as float32 or bfloat16 (the forward's dtype),
// w and u as float32, r/k/v/w through the (b, h, t) strides of strided
// views (the forward's rwkv6._heads views are read in place), dy through
// its own.  The gradients are written in float32 through the strides of
// (B, H, T, 64) views; the wrapper casts dr, dk, dv to the inputs' dtype.
// Sums run in FMAs and in another order than the plain version
// (kernels/ref.py:wkv6_scan_bwd), which it is held to within a tolerance.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s float32): the function
// reads r, k, v, dy, w and u and writes dr, dk, dv, dw, du; its least
// work a (b, h, t) is 64 x 64 x 8 operations (the state's update and
// G's: an FMA each; dw, dk and dv: an FMA an entry each) plus the row and
// column terms.  At (2, 40, 4096, 64) in bf16 that is 42 MB in, 84 MB out
// (0.038 ms) against 2.7 GFLOP (0.040 ms on the float32 units).  What
// bounds this design is the sequential dependence over T: 80 blocks on 80
// of 132 SMs, each step a chain of shuffles and FMAs.  PERF.md has its
// times (chip_smoke.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHead = 64;      // K = V = 64, the only head size the models use
constexpr int kThreads = 256;  // 8 warps: 64 rows x 4 column quarters
constexpr int kCols = 16;      // columns a thread owns
constexpr int kC = 8;          // steps a checkpoint interval (sub-chunk)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

struct BwdSmem {
  float st[kC][kCols][kThreads];  // S_{t-1} of the sub-chunk's steps, thread order
  float r[kC][kHead], k[kC][kHead], v[kC][kHead], w[kC][kHead], dy[kC][kHead];
  float dvp[kC][8][kHead];        // dv's partial sums by warp
  float dr[kC][kHead], dk[kC][kHead], dw[kC][kHead];
  float cs[kC];                   // r_t . (u * k_t)
  float vd[kC];                   // v_t . dy_t
  float u[kHead];
};

// Stage rows [t0, t0 + L) of a (b, h) head (base: its offset) as float32.
template <typename T>
__device__ __forceinline__ void stage(float (*dst)[kHead], const T* src, long long base,
                                      long long st, int t0, int L) {
  for (int e = threadIdx.x; e < L * kHead; e += kThreads) {
    const int s = e >> 6, col = e & 63;
    dst[s][col] = to_f32(src[base + (long long)(t0 + s) * st + col]);
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// grid: B*H blocks (block = b*H + h); block: 256 threads.
// sb/sh/st: (b, h, t) strides in elements of r, k, v and w; gb/gh/gt those
// of dy; ob/oh/ot those of the four (B, H, T, 64) float32 outputs.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
wkv6_back(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
          const float* __restrict__ w, const float* __restrict__ u,
          const T* __restrict__ dy, int H, int steps, long long sb, long long sh,
          long long st, long long gb, long long gh, long long gt, long long ob,
          long long oh, long long ot, float* __restrict__ dr, float* __restrict__ dk,
          float* __restrict__ dv, float* __restrict__ dw, float* __restrict__ du_part,
          float* __restrict__ ckpt) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BwdSmem& sm = *reinterpret_cast<BwdSmem*>(smem_raw);
  const int tid = threadIdx.x;
  const int i = tid >> 2, q = tid & 3;
  const int lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const long long in0 = (long long)b * sb + (long long)h * sh;
  const long long g0 = (long long)b * gb + (long long)h * gh;
  const long long o0 = (long long)b * ob + (long long)h * oh;
  const int nck = (steps + kC - 1) / kC;
  float* my_ckpt = ckpt + (long long)blockIdx.x * nck * (kCols * kThreads) + tid;
  if (tid < kHead) sm.u[tid] = u[h * kHead + tid];

  // ---- pass 1: the forward recurrence, S stored before every sub-chunk --- //
  float S[kCols];
#pragma unroll
  for (int m = 0; m < kCols; ++m) S[m] = 0.0f;
  for (int c = 0; c < nck; ++c) {
    const int t0 = c * kC, L = min(kC, steps - t0);
#pragma unroll
    for (int m = 0; m < kCols; ++m) my_ckpt[(long long)c * (kCols * kThreads) + m * kThreads] = S[m];
    if (c == nck - 1) break;               // the last sub-chunk's states: pass 2
    __syncthreads();                       // the previous sub-chunk's reads are done
    stage(sm.k, k, in0, st, t0, L);
    stage(sm.v, v, in0, st, t0, L);
    stage(sm.w, w, in0, st, t0, L);
    __syncthreads();
    for (int s = 0; s < L; ++s) {
      const float ki = sm.k[s][i], wi = sm.w[s][i];
#pragma unroll
      for (int m = 0; m < kCols; ++m) S[m] = fmaf(wi, S[m], ki * sm.v[s][q + 4 * m]);
    }
  }

  // ---- pass 2: sub-chunks from the last, G stepped back through each ---- //
  float G[kCols];
#pragma unroll
  for (int m = 0; m < kCols; ++m) G[m] = 0.0f;
  float du_acc = 0.0f;
  for (int c = nck - 1; c >= 0; --c) {
    const int t0 = c * kC, L = min(kC, steps - t0);
    __syncthreads();                       // the previous sub-chunk's epilogue is done
    stage(sm.r, r, in0, st, t0, L);
    stage(sm.k, k, in0, st, t0, L);
    stage(sm.v, v, in0, st, t0, L);
    stage(sm.w, w, in0, st, t0, L);
    stage(sm.dy, dy, g0, gt, t0, L);
#pragma unroll
    for (int m = 0; m < kCols; ++m) S[m] = my_ckpt[(long long)c * (kCols * kThreads) + m * kThreads];
    __syncthreads();
    // the sub-chunk's S_{t-1}, and one warp a step its two scalars
    for (int s = 0; s < L; ++s) {
#pragma unroll
      for (int m = 0; m < kCols; ++m) sm.st[s][m][tid] = S[m];
      if (s + 1 < L) {
        const float ki = sm.k[s][i], wi = sm.w[s][i];
#pragma unroll
        for (int m = 0; m < kCols; ++m) S[m] = fmaf(wi, S[m], ki * sm.v[s][q + 4 * m]);
      }
    }
    if (warp < L) {
      const int s = warp;
      float cs = sm.r[s][lane] * sm.u[lane] * sm.k[s][lane] +
                 sm.r[s][lane + 32] * sm.u[lane + 32] * sm.k[s][lane + 32];
      float vd = sm.v[s][lane] * sm.dy[s][lane] + sm.v[s][lane + 32] * sm.dy[s][lane + 32];
      cs = warp_sum(cs);
      vd = warp_sum(vd);
      if (lane == 0) {
        sm.cs[s] = cs;
        sm.vd[s] = vd;
      }
    }
    __syncthreads();
    const float ui = sm.u[i];
    for (int s = L - 1; s >= 0; --s) {
      const float ri = sm.r[s][i], ki = sm.k[s][i], wi = sm.w[s][i];
      const float vdy = sm.vd[s];
      float pw = 0.0f, pk = 0.0f, pr = 0.0f;
      float p[kCols];
#pragma unroll
      for (int m = 0; m < kCols; ++m) {
        const int j = q + 4 * m;
        const float sp = sm.st[s][m][tid];
        const float vj = sm.v[s][j], gj = sm.dy[s][j];
        pw = fmaf(G[m], sp, pw);
        pk = fmaf(G[m], vj, pk);
        pr = fmaf(sp, gj, pr);
        p[m] = G[m] * ki;
        G[m] = fmaf(wi, G[m], ri * gj);
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        pw += __shfl_xor_sync(kFull, pw, o);
        pk += __shfl_xor_sync(kFull, pk, o);
        pr += __shfl_xor_sync(kFull, pr, o);
      }
      if (q == 0) {
        sm.dw[s][i] = pw;
        sm.dk[s][i] = fmaf(ui * ri, vdy, pk);
        sm.dr[s][i] = fmaf(ui * ki, vdy, pr);
        du_acc = fmaf(ri * ki, vdy, du_acc);
      }
      // dv: reduce-scatter over the warp's eight rows (lane bits 2-4); lane
      // (il, q) is left with m = 2 il + n, n < 2, summed over the rows
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const bool up = lane & 16;
        const float send = up ? p[n] : p[n + 8];
        p[n] = (up ? p[n + 8] : p[n]) + __shfl_xor_sync(kFull, send, 16);
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const bool up = lane & 8;
        const float send = up ? p[n] : p[n + 4];
        p[n] = (up ? p[n + 4] : p[n]) + __shfl_xor_sync(kFull, send, 8);
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const bool up = lane & 4;
        const float send = up ? p[n] : p[n + 2];
        p[n] = (up ? p[n + 2] : p[n]) + __shfl_xor_sync(kFull, send, 4);
      }
      const int il = lane >> 2;
      sm.dvp[s][warp][q + 4 * (2 * il)] = p[0];
      sm.dvp[s][warp][q + 4 * (2 * il + 1)] = p[1];
    }
    __syncthreads();
    // epilogue: dv's sum over warps, the sub-chunk's four gradients out
    for (int e = tid; e < L * kHead; e += kThreads) {
      const int s = e >> 6, col = e & 63;
      float acc = sm.cs[s] * sm.dy[s][col];
#pragma unroll
      for (int wp = 0; wp < 8; ++wp) acc += sm.dvp[s][wp][col];
      const long long o = o0 + (long long)(t0 + s) * ot + col;
      dv[o] = acc;
      dr[o] = sm.dr[s][col];
      dk[o] = sm.dk[s][col];
      dw[o] = sm.dw[s][col];
    }
  }
  if (q == 0) du_part[(long long)blockIdx.x * kHead + i] = du_acc;
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const float* w, const float* u,
           const void* dy, int B, int H, int T_, long long sb, long long sh, long long st,
           long long gb, long long gh, long long gt, long long ob, long long oh, long long ot,
           float* dr, float* dk, float* dv, float* dw, float* du_part, float* ckpt,
           cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        wkv6_back<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(BwdSmem));
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  wkv6_back<T><<<B * H, kThreads, sizeof(BwdSmem), stream>>>(
      (const T*)r, (const T*)k, (const T*)v, w, u, (const T*)dy, H, T_, sb, sh, st, gb, gh,
      gt, ob, oh, ot, dr, dk, dv, dw, du_part, ckpt);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* wkv6_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The checkpoint floats a (b, h) head needs: ceil(T / 8) states of 64 x 64.
long long wkv6_bwd_ckpt_floats(int T) { return (long long)((T + kC - 1) / kC) * kHead * kHead; }

// K12's backward.  r, k, v, dy: (B, H, T, 64) at float32 (bf16 == 0) or
// bfloat16 (bf16 == 1); r/k/v and the float32 w read through the strides
// sb/sh/st, dy through gb/gh/gt; u (H, 64) float32.  Writes dr, dk, dv,
// dw (float32, through ob/oh/ot), du_part (B*H, 64) float32; ckpt is
// scratch of B*H * wkv6_bwd_ckpt_floats(T) floats.  T >= 1.
int wkv6_scan_bwd(const void* r, const void* k, const void* v, const float* w,
                  const float* u, const void* dy, int B, int H, int T, long long sb,
                  long long sh, long long st, long long gb, long long gh, long long gt,
                  int bf16, long long ob, long long oh, long long ot, float* dr, float* dk,
                  float* dv, float* dw, float* du_part, float* ckpt, void* stream_ptr) {
  if (B < 1 || H < 1 || T < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (bf16)
    return launch<__nv_bfloat16>(r, k, v, w, u, dy, B, H, T, sb, sh, st, gb, gh, gt, ob, oh,
                                 ot, dr, dk, dv, dw, du_part, ckpt, stream);
  return launch<float>(r, k, v, w, u, dy, B, H, T, sb, sh, st, gb, gh, gt, ob, oh, ot, dr,
                       dk, dv, dw, du_part, ckpt, stream);
}

}  // extern "C"
