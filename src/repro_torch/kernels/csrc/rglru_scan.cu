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
// pass over T with the same layout (two-warp blocks, a channel a lane):
//
//     g_t  = dy_t + a_{t+1} g_{t+1}
//     dx_t = beta_t g_t,   beta = sqrt(max(1 - a^2, 0))
//     da_t = g_t h_{t-1} + (-(((g_t x_t) (0.5 / beta_t)) m_t)) (2 a_t)
//
// (m: max's share of the cotangent, 1 above the tie, 0.5 at 1 - a^2 == 0,
// 0 below, as jax.vjp takes it), reading x, a, y (the forward's h) and dy
// and writing dx and da: 24 bytes an element, 503 MB at recurrentgemma-
// 2b's training shape (2, 4096, 2560), 0.15 ms at 3.35 TB/s.  Each thread
// loads a batch of kBwdU steps of its four inputs at once, then runs them
// from the last; 0.5 / beta is taken as (1 / beta) * 0.5, as the plain
// version's torch expression computes it (equal for every beta in (0, 1]).
// Under --fmad=false and in the plain version's (kernels/ref.py:
// rglru_scan_bwd) operation order, dx and da are bit-equal to it.

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

// One reverse step of the backward; carry holds a_{t+1} g_{t+1}.
__device__ __forceinline__ void rglru_back_step(float dy, float x, float a, float h_prev,
                                                float& carry, float& dx, float& da) {
  const float g = dy + carry;
  const float m = 1.0f - a * a;
  const float beta = sqrtf(fmaxf(m, 0.0f));
  const float share = m > 0.0f ? 1.0f : (m == 0.0f ? 0.5f : 0.0f);
  dx = beta * g;
  const float dbeta = ((g * x) * ((1.0f / beta) * 0.5f)) * share;
  da = g * h_prev + (-dbeta) * (2.0f * a);
  carry = a * g;
}

constexpr int kBwdU = 16;                   // steps a thread loads at once

// grid: (ceil(D / (32 kWarps)), B); block: 32 kWarps threads, a channel each.
__global__ void __launch_bounds__(32 * kWarps)
rglru_back(const float* __restrict__ x, const float* __restrict__ a,
           const float* __restrict__ y, const float* __restrict__ dy, int T, int D,
           float* __restrict__ dx, float* __restrict__ da) {
  const int d = blockIdx.x * (32 * kWarps) + threadIdx.x;
  if (d >= D) return;
  const long long base = (long long)blockIdx.y * T * D + d;
  x += base;
  a += base;
  y += base;
  dy += base;
  dx += base;
  da += base;
  float carry = 0.0f;
  const int whole = T - T % kBwdU;
  for (int t = T - 1; t >= whole; --t) {     // a ragged T's last steps first
    const long long o = (long long)t * D;
    const float h_prev = t > 0 ? __ldcs(y + o - D) : 0.0f;
    float dxv, dav;
    rglru_back_step(__ldcs(dy + o), __ldcs(x + o), __ldcs(a + o), h_prev, carry, dxv, dav);
    __stcs(dx + o, dxv);
    __stcs(da + o, dav);
  }
  for (int t0 = whole - kBwdU; t0 >= 0; t0 -= kBwdU) {
    float xs[kBwdU], as[kBwdU], gs[kBwdU], hs[kBwdU];
#pragma unroll
    for (int i = 0; i < kBwdU; ++i) {
      const long long o = (long long)(t0 + i) * D;
      xs[i] = __ldcs(x + o);
      as[i] = __ldcs(a + o);
      gs[i] = __ldcs(dy + o);
      hs[i] = t0 + i > 0 ? __ldcs(y + o - D) : 0.0f;
    }
#pragma unroll
    for (int i = kBwdU - 1; i >= 0; --i) {
      const long long o = (long long)(t0 + i) * D;
      float dxv, dav;
      rglru_back_step(gs[i], xs[i], as[i], hs[i], carry, dxv, dav);
      __stcs(dx + o, dxv);
      __stcs(da + o, dav);
    }
  }
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
  const int per_block = 32 * kWarps;
  const dim3 grid((unsigned)((D + per_block - 1) / per_block), (unsigned)B);
  rglru_back<<<grid, per_block, 0, (cudaStream_t)stream_ptr>>>(x, a, y, dy, T, D, dx, da);
  return (int)cudaGetLastError();
}

}  // extern "C"
