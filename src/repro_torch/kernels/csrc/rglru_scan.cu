// RG-LRU recurrence (K11) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru_scan.py:rglru_scan
// (_rglru_kernel), elementwise over the channels:
//
//     h_t = a_t * h_{t-1} + sqrt(max(1 - a_t^2, 0)) * x_t,    h_0 = 0.
//
// The TPU kernel walks a sequential (B, D/bd, T/bt) grid and keeps h in
// VMEM scratch between time blocks.  Here one thread owns one (b, d)
// channel and loops over T with h in a register; each channel's steps run
// in order, so the rounding is the plain version's.
//
// What bounds it is bytes in flight, not the chain: 2560 steps of one
// FMUL and one FADD take ~10 us, the bytes 0.188 ms.  At ~0.85 us of DRAM
// latency, 3.35 TB/s needs ~3 MB in flight chip-wide, ~24 KB an SM.  The
// first design (a thread a channel, 256-thread blocks, 8 steps unrolled)
// put 80 blocks on 80 of the 132 SMs at the serving shape (8, 2560, 2560)
// and had ~1.3 MB in flight.  So:
//   * blocks are two warps, each lane one channel (a warp a 32-channel
//     slab: every load of x_t, a_t and store of y_t is one 128-byte line),
//     640 warps over all 132 SMs at the serving shape;
//   * each thread keeps the next U steps' x and a loading while it runs
//     the current U (registers, double-buffered): at U = 32, 64 loads of
//     128 bytes a warp in flight, 5.2 MB chip-wide;
//   * past 12 warps an SM (the large shape (32, 4096, 2560) has 19.4),
//     depth is not short, and wider lines pay more: each lane takes a
//     channel pair (8-byte loads and stores, 256 bytes a warp access) and
//     8-step batches;
//   * loads and stores stream (evict-first): nothing is read twice.
// tools/k8_k11_ablation.py timed the choices (PERF.md): the batch depth,
// the channels a lane and a block, the cache hints, and a shared-memory
// ring that TMA fills (no faster at main, slower at large, and limited to
// D % 4 == 0).  Any B, T and D run here: odd D or a misaligned view takes
// one channel a lane, a ragged T ends with a plain loop, and the lanes
// past D return before the loop (nothing is shared between lanes).
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
// y out), 629 MB at the serving shape, 0.18783 ms; 7 flops an element are
// far below the float32 peak.  PERF.md has the times on an NVIDIA H100
// 80GB HBM3 at 700 W (chip_smoke.py, tools/k8_k11_ablation.py).
//
// The backward (rglru_back, entry rglru_scan_bwd) replaces no TPU kernel:
// the JAX package differentiates the two-level scan of
// src/repro/kernels/ref.py:rglru_scan under jax.vjp.  It is one reverse
// pass over T, a channel a lane:
//
//     g_t  = dy_t + a_{t+1} g_{t+1}
//     dx_t = beta_t g_t,   beta = sqrt(max(1 - a^2, 0))
//     da_t = g_t h_{t-1} + (-(((g_t x_t) (0.5 / beta_t)) m_t)) (2 a_t)
//
// (m: max's share of the cotangent, 1 above the tie, 0.5 at 1 - a^2 == 0,
// 0 below, as jax.vjp takes it), reading x, a, y (the forward's h) and dy
// and writing dx and da: 24 bytes an element, 503 MB at recurrentgemma-
// 2b's training shape (2, 4096, 2560), 0.15 ms at 3.35 TB/s.  That shape
// has only 5120 channels, and the first design (two-warp blocks, a
// channel a lane, on 80 SMs) took 0.685 ms: not for bytes but for each
// channel's chain of 4096 steps, every step an IEEE sqrt and reciprocal
// (each with its slow-path branch, which stops the compiler overlapping
// steps) and a store branch.  So:
//   * a step splits in two (rglru_back_pre, rglru_back_step): beta,
//     0.5 / beta and max's share depend only on a_t, and for a batch of
//     kBwdU steps all 32 lanes compute them for the warp's C channels (U C
//     / 32 each) into shared memory; then C lanes run their channel's
//     chain over the batch, which has no branch a step: the carry's two
//     operations a step are the only serial ones;
//   * up to 12 warps of 32 channels an SM (the training shape has 1.2) a
//     warp takes C = 8 channels (640 one-warp blocks at the training
//     shape, each lane computing 4 of a batch's pre-values), past it (the
//     large shape (32, 4096, 2560) has 19.4) C = 32, where issue slots are
//     what is short;
//   * each warp keeps a ring of kBwdDepth = 4 batches in shared memory
//     (x, a, h_{t-1} and dy, 16 C bytes a step), filled by cp.async three
//     batches ahead of the one it runs;
//   * with D % 4 == 0 and 16-byte aligned tensors a lane copies 16 bytes,
//     else 4; loads carry an L2 evict-first policy, stores stream (nothing
//     is read twice).
// Any B, T and D run: a ragged T's last batch is zero-filled past T and
// its missing steps skipped, lanes past D copy nothing and store nothing.
// tools/k11_k12_bwd_ablation.py times the choices (PERF.md).
// 0.5 / beta is taken as (1 / beta) * 0.5, as the plain version's torch
// expression computes it (equal for every beta in (0, 1]).  Under
// --fmad=false and in the plain version's (kernels/ref.py:
// rglru_scan_bwd) operation order, one channel's steps in reverse order,
// dx and da are bit-equal to it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSms = 132;                   // H100 SXM
constexpr int kWarps = 2;                   // warps a block
// Up to this many warps an SM at one channel a thread, the lanes run one
// channel and 32-step batches; past it, channel pairs and 8-step batches
constexpr int kFewWarpsPerSm = 12;

template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = __ldcs(p);
  } else {
    const float2 t = __ldcs(reinterpret_cast<const float2*>(p));
    v[0] = t.x;
    v[1] = t.y;
  }
}

// y is not read again by this kernel: streaming (evict-first) stores
template <int V>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[V]) {
  if constexpr (V == 1)
    __stcs(p, v[0]);
  else
    __stcs(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
}

__device__ __forceinline__ float rglru_step(float h, float x, float a) {
  const float gx = sqrtf(fmaxf(1.0f - a * a, 0.0f)) * x;
  return a * h + gx;
}

// grid: (ceil(D / (32 kWarps V)), B); block: 32 kWarps threads, V
// neighbouring channels each (V = 2: D even and x, a, y 8-byte aligned).
// A thread keeps the next U steps' x and a loading while it runs the
// current U.
template <int V, int U>
__global__ void __launch_bounds__(32 * kWarps)
rglru_slabs(const float* __restrict__ x, const float* __restrict__ a, int T, int D,
            float* __restrict__ y, float* __restrict__ h_out) {
  const int d = (blockIdx.x * (32 * kWarps) + threadIdx.x) * V;
  if (d >= D) return;
  const long long base = (long long)blockIdx.y * T * D + d;
  const float* xp = x + base;
  const float* ap = a + base;
  float* yp = y + base;
  const int whole = T - T % U;
  float xn[U][V], an[U][V];                 // the next U steps, loading
  if (whole > 0) {
#pragma unroll
    for (int i = 0; i < U; ++i) {
      load_vec<V>(xp + (long long)i * D, xn[i]);
      load_vec<V>(ap + (long long)i * D, an[i]);
    }
  }
  float h[V];
#pragma unroll
  for (int e = 0; e < V; ++e) h[e] = 0.0f;
  for (int t = 0; t < whole; t += U) {
    float xs[U][V], as[U][V];
#pragma unroll
    for (int i = 0; i < U; ++i)
#pragma unroll
      for (int e = 0; e < V; ++e) {
        xs[i][e] = xn[i][e];
        as[i][e] = an[i][e];
      }
    if (t + U < whole) {
      const long long next = (long long)(t + U) * D;
#pragma unroll
      for (int i = 0; i < U; ++i) {
        load_vec<V>(xp + next + (long long)i * D, xn[i]);
        load_vec<V>(ap + next + (long long)i * D, an[i]);
      }
    }
    float* yq = yp + (long long)t * D;
#pragma unroll
    for (int i = 0; i < U; ++i) {
#pragma unroll
      for (int e = 0; e < V; ++e) h[e] = rglru_step(h[e], xs[i][e], as[i][e]);
      store_vec<V>(yq + (long long)i * D, h);
    }
  }
  for (int t = whole; t < T; ++t) {          // a ragged T's last steps
    const long long off = (long long)t * D;
    float xv[V], av[V];
    load_vec<V>(xp + off, xv);
    load_vec<V>(ap + off, av);
#pragma unroll
    for (int e = 0; e < V; ++e) h[e] = rglru_step(h[e], xv[e], av[e]);
    store_vec<V>(yp + off, h);
  }
#pragma unroll
  for (int e = 0; e < V; ++e) h_out[(long long)blockIdx.y * D + d + e] = h[e];
}

template <int V, int U>
int launch(const float* x, const float* a, int B, int T, int D, float* y, float* h_out,
           cudaStream_t stream) {
  const int per_block = 32 * kWarps * V;
  const dim3 grid((unsigned)((D + per_block - 1) / per_block), (unsigned)B);
  rglru_slabs<V, U><<<grid, 32 * kWarps, 0, stream>>>(x, a, T, D, y, h_out);
  return (int)cudaGetLastError();
}

// One reverse step of the backward, in two parts.  The first depends only
// on a_t: beta, 0.5 / beta (taken as (1 / beta) * 0.5) and max's share;
// the second carries the chain (carry holds a_{t+1} g_{t+1}).  Each
// operation and its order are those of ref.rglru_scan_bwd.
__device__ __forceinline__ void rglru_back_pre(float a, float& beta, float& rb,
                                               float& share) {
  const float m = 1.0f - a * a;
  beta = sqrtf(fmaxf(m, 0.0f));
  share = m > 0.0f ? 1.0f : (m == 0.0f ? 0.5f : 0.0f);
  rb = (1.0f / beta) * 0.5f;
}

__device__ __forceinline__ void rglru_back_step(float dy, float x, float a, float h_prev,
                                                float beta, float rb, float share,
                                                float& carry, float& dx, float& da) {
  const float g = dy + carry;
  dx = beta * g;
  const float dbeta = ((g * x) * rb) * share;
  da = g * h_prev + (-dbeta) * (2.0f * a);
  carry = a * g;
}

constexpr int kBwdU = 16;                   // steps a batch
// Up to kBwdFewWarps warps of 32 channels, kBwdFewC channels a warp; past
// it, kBwdManyC; each warp's ring kBwdDepth batches deep
// (tools/k11_k12_bwd_ablation.py builds the other choices)
constexpr int kBwdFewWarps = kSms * kFewWarpsPerSm;
constexpr int kBwdFewC = 8;
constexpr int kBwdManyC = 32;
constexpr int kBwdDepth = 4;

__device__ __forceinline__ unsigned long long evict_first_policy() {
  unsigned long long policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool ok,
                                         unsigned long long policy) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;\n" ::"r"(d),
                 "l"(src), "r"(ok ? 16 : 0), "l"(policy));
  else
    asm volatile("cp.async.ca.shared.global.L2::cache_hint [%0], [%1], 4, %2, %3;\n" ::"r"(d),
                 "l"(src), "r"(ok ? 4 : 0), "l"(policy));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// grid: (ceil(D / C), B); block: one warp, channels d0 .. d0 + C - 1.
// ring[slot][0..3][i][c]: x, a, h_{t-1} (y one step back, 0 at t = 0) and
// dy of step t0 + i and channel d0 + c of the batch in that slot.  Each
// batch runs in two phases: every lane takes U C / 32 of its (step,
// channel) entries through rglru_back_pre (beta, rb, share into shared
// memory), then lanes 0 .. C - 1 run their channel's chain over its U
// steps from the last.  VEC: 16-byte copies (D % 4 == 0, 16-byte aligned
// tensors), else 4-byte ones.
template <int C, bool VEC>
__global__ void __launch_bounds__(32)
rglru_back(const float* __restrict__ x, const float* __restrict__ a,
           const float* __restrict__ y, const float* __restrict__ dy, int T, int D,
           float* __restrict__ dx, float* __restrict__ da) {
  static_assert(C % 4 == 0 && C <= 32 && kBwdU * C % 32 == 0, "channels a warp");
  __shared__ __align__(16) float ring[kBwdDepth][4][kBwdU][C];
  __shared__ float pre[3][kBwdU][C];        // beta, rb, share
  const int lane = threadIdx.x;
  const int d0 = blockIdx.x * C;
  const long long row0 = (long long)blockIdx.y * T * D;
  const int nb = (T + kBwdU - 1) / kBwdU;
  const unsigned long long policy = evict_first_policy();
  const float* src[4] = {x, a, y, dy};

  // batch jb (steps jb U .. jb U + U - 1) into ring slot `slot`; steps
  // past T, channels past D and batches before the first (jb < 0) are
  // zero-filled
  auto load = [&](int slot, int jb) {
    const int t0 = jb * kBwdU;
    constexpr int kWidth = VEC ? 4 : 1;     // floats a copy
    constexpr int kRow = C / kWidth;        // copies a step row
#pragma unroll
    for (int arr = 0; arr < 4; ++arr)
#pragma unroll
      for (int m = 0; m < kBwdU * kRow / 32; ++m) {
        const int e = lane + 32 * m;
        const int i = e / kRow, c = (e - i * kRow) * kWidth;
        const int t = t0 + i - (arr == 2);  // y: h_{t-1}
        const bool ok = jb >= 0 && t0 + i < T && t >= 0 && d0 + c < D;
        cp_async<4 * kWidth>(&ring[slot][arr][i][c],
                             src[arr] + (ok ? row0 + (long long)t * D + d0 + c : 0), ok,
                             policy);
      }
  };

#pragma unroll
  for (int s = 0; s < kBwdDepth - 1; ++s) {
    load(s, nb - 1 - s);
    cp_async_commit();
  }
  float carry = 0.0f;
  for (int idx = 0; idx < nb; ++idx) {
    const int jb = nb - 1 - idx;
    const int slot = idx % kBwdDepth;
    cp_async_wait<kBwdDepth - 2>();
    __syncwarp();       // batch jb is in; the slot refilled next and pre are read
    load((idx + kBwdDepth - 1) % kBwdDepth, jb - (kBwdDepth - 1));
    cp_async_commit();
#pragma unroll
    for (int m = 0; m < kBwdU * C / 32; ++m) {
      const int e = lane + 32 * m;
      const int i = e / C, c = e - i * C;
      rglru_back_pre(ring[slot][1][i][c], pre[0][i][c], pre[1][i][c], pre[2][i][c]);
    }
    __syncwarp();
    if (lane < C && d0 + lane < D) {
      // a whole batch runs without a branch a step, so the compiler can
      // overlap each step's tail with the next steps' chain; only the
      // first batch walked (the last in time) can be ragged.  Lanes past
      // C or D have no chain to carry.
      const int t0 = jb * kBwdU;
      float* dxp = dx + row0 + (long long)t0 * D + d0 + lane;
      float* dap = da + row0 + (long long)t0 * D + d0 + lane;
      auto step = [&](int i) {
        float dxv, dav;
        rglru_back_step(ring[slot][3][i][lane], ring[slot][0][i][lane],
                        ring[slot][1][i][lane], ring[slot][2][i][lane], pre[0][i][lane],
                        pre[1][i][lane], pre[2][i][lane], carry, dxv, dav);
        __stcs(dxp + (long long)i * D, dxv);
        __stcs(dap + (long long)i * D, dav);
      };
      if (t0 + kBwdU <= T) {
#pragma unroll
        for (int i = kBwdU - 1; i >= 0; --i) step(i);
      } else {
        for (int i = T - t0 - 1; i >= 0; --i) step(i);
      }
    }
  }
  cp_async_wait<0>();
}

template <int C, bool VEC>
int launch_back(const float* x, const float* a, const float* y, const float* dy, int B,
                int T, int D, float* dx, float* da, cudaStream_t stream) {
  const dim3 grid((unsigned)((D + C - 1) / C), (unsigned)B);
  rglru_back<C, VEC><<<grid, 32, 0, stream>>>(x, a, y, dy, T, D, dx, da);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* rglru_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// K11.  x, a: (B, T, D) float32 contiguous; writes y (B, T, D) and
// h_T (B, D), float32.  1 <= B <= 65535, T >= 1, D >= 1.
int rglru_scan(const float* x, const float* a, int B, int T, int D, float* y,
               float* h_out, void* stream_ptr) {
  if (B < 1 || B > 65535 || T < 1 || D < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const bool pairs = D % 2 == 0 && (((uintptr_t)x | (uintptr_t)a | (uintptr_t)y) & 7) == 0;
  const long long warps = (long long)B * ((D + 31) / 32);   // at one channel a thread
  if (pairs && warps > (long long)kSms * kFewWarpsPerSm)
    return launch<2, 8>(x, a, B, T, D, y, h_out, stream);
  return launch<1, 32>(x, a, B, T, D, y, h_out, stream);
}

// K11's backward.  x, a, y (the forward's h), dy: (B, T, D) float32
// contiguous; writes dx and da, (B, T, D) float32.  1 <= B <= 65535,
// T >= 1, D >= 1.
int rglru_scan_bwd(const float* x, const float* a, const float* y, const float* dy, int B,
                   int T, int D, float* dx, float* da, void* stream_ptr) {
  if (B < 1 || B > 65535 || T < 1 || D < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const bool vec = D % 4 == 0 &&
                   (((uintptr_t)x | (uintptr_t)a | (uintptr_t)y | (uintptr_t)dy) & 15) == 0;
  const bool few = (long long)B * ((D + 31) / 32) <= kBwdFewWarps;
  if (vec)
    return few ? launch_back<kBwdFewC, true>(x, a, y, dy, B, T, D, dx, da, stream)
               : launch_back<kBwdManyC, true>(x, a, y, dy, B, T, D, dx, da, stream);
  return few ? launch_back<kBwdFewC, false>(x, a, y, dy, B, T, D, dx, da, stream)
             : launch_back<kBwdManyC, false>(x, a, y, dy, B, T, D, dx, da, stream);
}

}  // extern "C"
