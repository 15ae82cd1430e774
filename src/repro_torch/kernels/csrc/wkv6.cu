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
// time axis is a loop inside the block, one block per (b, h).  Two
// routes, chosen by the dtype of r/k/v:
//
// bfloat16 (what prefill launches): a chunked scan on the tensor cores.
// 256 threads walk the head in chunks of L = 16 steps.  With P_t the
// product of w over the chunk's steps before t (per channel i), Q_s the
// product over its steps after s, and D the product over the whole chunk:
//
//     y_t    = (r_t * P_t)^T S_prev + sum_{s<=t} A[t,s] v_s
//     A[t,s] = sum_i r_ti k_si prod_{s<j<t} w_ji   (s < t)
//     A[t,t] = sum_i r_ti u_i k_ti
//     S_next = diag(D) S_prev + sum_s (k_s * Q_s) v_s^T
//
// Every decay factor is a product of w's, all <= 1: nothing is ever
// divided by a decay, so w near 0 (forget: the product underflows to 0
// exactly where its true value is below float32's range) and w near 1 are
// both safe, with no logs or exponentials.  A is the chunk's one (16 x 16)
// diagonal block, built in float32 by running products (thread (s, 4
// channels), a 4-round shuffle reduce-scatter); the three products
// y_inter = R~ S, y_intra = A V and S += K~^T V run as mma.sync.  Warp
// (jw, iw) owns value columns 16 jw .. +15 and state rows 32 iw .. +31:
// it keeps S^T there as mma accumulators, whose layout is the B operand
// of R~ S without a shuffle, and the two row halves' y meet in shared
// memory.  R~ S, where both sides are float32 and S grows large when w
// stays near 1, runs in 3xTF32 (m16n8k8: hi*hi + hi*lo + lo*hi of 11-bit
// parts, about 2^-21 relative a product); A V and K~^T V have v in bf16
// exactly, and split only A and K~ into bf16 hi + lo parts (m16n8k16, two
// products, about 2^-16).  The tensor cores truncate each sum toward zero
// at its largest addend's last bit: S and the large R~ S terms therefore
// never accumulate in them, but in float32 registers (round to nearest).
// Chunks arrive by cp.async in a 4-deep shared-memory ring, three chunks
// ahead; a ragged tail is zero-filled and its w taken as 1.
//
// float32: the sequential kernel.  One block of 64 threads per (b, h),
// thread j owns the value column S[:, j] (64 floats in registers).  Each
// step stages r_t, k_t, w_t and v_t in shared memory; every thread then
// forms y_j = sum_i r_i * (S_ij + u_i * k_i * v_j) in a fixed i order and
// updates S_ij = w_i * S_ij + k_i * v_j, keeping the reference's operation
// order with __fmul_rn/__fadd_rn (never contracted into an FMA): kv = k*v,
// S + u*kv, w*S + kv.  So S_T has the plain version's bits; y's 64-term
// sum runs in FMAs, in another order than the plain einsum, and is held
// to a tolerance.
//
// Both routes read r/k/v/w through the (b, h, t) strides of strided views
// (the (B, T, H, 64) activations seen as (B, H, T, 64); the last
// dimension dense; the bf16 route also wants 16-byte aligned rows), with
// no cast pass: w and u come in float32.  y is written through its own
// strides at r's dtype, S_T (B, H, 64, 64) float32.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense): the function
// needs 5 operations per state entry per step (y = S^T r + (sum_i r_i u_i
// k_i) v: one FMA an entry plus 5 a column; S <- diag(w) S + k v^T: a
// multiply, a multiply and an add) = 5 * 64 * 65 per (b, h, t).  At the
// serving shape (8, 40, 2560, 64) in bf16 that is 17.0 GFLOP: 0.017 ms on
// the bf16 tensor cores (0.25 ms at float32's 67 TFLOP/s), against 0.19
// ms for the bytes (bf16 r, k, v, y; float32 w), so the bf16 route's bound
// is the bytes.  On an NVIDIA H100 80GB HBM3 at 700 W the route is
// instead bound by its SIMT work a chunk (the running products of A, the
// decay scans), not by bytes or the tensor cores: PERF.md has its times
// and `tools/k1_k12_ablation.py` the split.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wkv6_chunk.cuh"

namespace {

using namespace wkv6_chunk;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }

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

// ---- bf16: the chunked scan -------------------------------------------- //

constexpr int kStages = 4;      // cp.async ring depth (chunks)
constexpr int kCThreads = 256;  // 8 warps
constexpr int kRtLd = 72;       // padded row strides (elements) of the tiles
constexpr int kKtLd = 24;
constexpr int kVtLd = 24;
constexpr int kYLd = 20;

struct ChunkSmem {
  __nv_bfloat16 r[kStages][kL][kHead];
  __nv_bfloat16 k[kStages][kL][kHead];
  __nv_bfloat16 v[kStages][kL][kHead];
  float w[kStages][kL][kHead];
  // R~ = r_t * P_t as its TF32 parts (t, i), K~^T = (k_s * Q_s)^T as its
  // bf16 parts (i, s): split once here, not in each warp that reads them
  float rt_hi[kL][kRtLd];
  float rt_lo[kL][kRtLd];
  __nv_bfloat16 kt_hi[kHead][kKtLd];
  __nv_bfloat16 kt_lo[kHead][kKtLd];
  float a[kL][kALd];               // A                        (t, s)
  __nv_bfloat16 vt[kHead][kVtLd];  // v transposed             (j, s)
  float d[kHead];                  // D
  float u[kHead];
  float ypart[4][kL][kYLd];        // y over i in 32..63, by value block
};

// x -> TF32 hi and lo with x ~= hi + lo (22 significant bits).
__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

__device__ __forceinline__ unsigned bf16x2_bits(__nv_bfloat162 h) {
  return *reinterpret_cast<unsigned*>(&h);
}

// (x0, x1) -> packed bf16 pairs hi and lo with x ~= hi + lo (x0 in the low
// half, as the mma fragments want the smaller index there).
__device__ __forceinline__ void split2(float x0, float x1, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

__device__ __forceinline__ void split_pair(const float* p, unsigned& hi, unsigned& lo) {
  const float2 x = *reinterpret_cast<const float2*>(p);
  split2(x.x, x.y, hi, lo);
}

// Stages chunk `c` (steps 16c .. 16c+15) of this (b, h) into ring slot
// `slot` with 16-byte cp.async; steps at or past T are zero-filled (all
// of them for a chunk past the end).
__device__ __forceinline__ void load_chunk(ChunkSmem& sm, int slot, int c, int T,
                                           const __nv_bfloat16* r, const __nv_bfloat16* k,
                                           const __nv_bfloat16* v, const float* w,
                                           long long base, long long st, int tid) {
  const int t0 = c * kL;
  if (tid < kL * 8) {             // r, k, v: 16 rows of 8 segments each
    const int row = tid >> 3, seg = tid & 7;
    const int t = t0 + row;
    const long long off = base + (long long)(t < T ? t : 0) * st + seg * 8;
    const int bytes = t < T ? 16 : 0;
    cp_async16(&sm.r[slot][row][seg * 8], r + off, bytes);
    cp_async16(&sm.k[slot][row][seg * 8], k + off, bytes);
    cp_async16(&sm.v[slot][row][seg * 8], v + off, bytes);
  } else {                        // w: 16 rows of 16 segments
    const int idx = tid - kL * 8;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int row = (idx >> 4) + 8 * m, seg = idx & 15;
      const int t = t0 + row;
      const long long off = base + (long long)(t < T ? t : 0) * st + seg * 4;
      cp_async16(&sm.w[slot][row][seg * 4], w + off, t < T ? 16 : 0);
    }
  }
}

// Chunk c's operands in float32 from its staged r, k, v, w (ring slot
// `slot`, tc valid steps): R~ = r * P, K~^T = (k * Q)^T, D, v^T and A.
__device__ __forceinline__ void prep_chunk(ChunkSmem& sm, int slot, int tc, int tid) {
  if (tid >= 2 * kHead) {
    // warps 4-7, whose share of A below is the smallest: threads 128-191
    // P_t (exclusive prefix) and D of channel i, 192-255 Q_s (exclusive
    // suffix)
    const int i = tid & (kHead - 1);
    if (tid < 3 * kHead) {
      float p = 1.0f;
#pragma unroll
      for (int t = 0; t < kL; ++t) {
        unsigned hi, lo;
        split_tf32(__bfloat162float(sm.r[slot][t][i]) * p, hi, lo);
        sm.rt_hi[t][i] = __uint_as_float(hi);
        sm.rt_lo[t][i] = __uint_as_float(lo);
        p *= t < tc ? sm.w[slot][t][i] : 1.0f;
      }
      sm.d[i] = p;
    } else {
      float q = 1.0f;
#pragma unroll
      for (int s = kL - 1; s >= 0; --s) {
        const float x = __bfloat162float(sm.k[slot][s][i]) * q;
        const __nv_bfloat16 hi = __float2bfloat16_rn(x);
        sm.kt_hi[i][s] = hi;
        sm.kt_lo[i][s] = __float2bfloat16_rn(x - __bfloat162float(hi));
        q *= s < tc ? sm.w[slot][s][i] : 1.0f;
      }
    }
  } else {                        // v^T
#pragma unroll
    for (int m = 0; m < kL * kHead / 128; ++m) {
      const int idx = tid + m * 128;
      const int s = idx / kHead, j = idx - s * kHead;
      sm.vt[j][s] = sm.v[slot][s][j];
    }
  }
  chunk_a<kHead>(sm.r[slot], sm.k[slot], sm.w[slot], sm.u, sm.a, tid);
}

// grid: B*H blocks (block = b*H + h); block: kCThreads; dynamic shared
// memory: ChunkSmem.  Strides as wkv6_fwd's.  Two barriers a chunk: the
// operands (SIMT, all 8 warps), then the products (tensor cores).  Warp
// w = (jw, iw) = (w % 4, w / 4) owns value columns j = 16 jw .. 16 jw + 15
// and state rows i = 32 iw .. 32 iw + 31: S^T[j][i] in its accumulators
// S[nt][0..3] at j = 16 jw + g (+8 for [2], [3]), i = 32 iw + 8 nt + 2 c4
// (+1 for [1], [3]), whose layout is the B operand of R~ S as it stands.
// y sums R~ S over both i halves: the iw = 1 warps leave their half in
// shared memory, and the iw = 0 warps add it and store y during the next
// chunk's operands (after the loop for the last chunk).
__global__ void __launch_bounds__(kCThreads, 3)
wkv6_chunked_bf16(const __nv_bfloat16* __restrict__ r, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const float* __restrict__ w,
                  const float* __restrict__ u, int H, int T, long long sb, long long sh,
                  long long st, long long yb, long long yh, long long yt,
                  __nv_bfloat16* __restrict__ y, float* __restrict__ s_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ChunkSmem& sm = *reinterpret_cast<ChunkSmem*>(smem_raw);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int jw = warp & 3, iw = warp >> 2;
  const int g = lane >> 2, c4 = lane & 3;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const long long base = (long long)b * sb + (long long)h * sh;
  __nv_bfloat16* ybh = y + (long long)b * yb + (long long)h * yh;
  const int nchunks = (T + kL - 1) / kL;
  if (tid < kHead) sm.u[tid] = u[h * kHead + tid];
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    load_chunk(sm, c, c, T, r, k, v, w, base, st, tid);
    cp_async_commit();
  }

  float S[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) S[nt][e] = 0.0f;
  float yacc[2][4];               // iw = 0: chunk c - 1's y, not yet stored

  // y of chunk cy (rows t0 .. t0 + tc - 1): this warp's half plus the
  // other half from shared memory, rounded to bf16 and stored
  auto store_y = [&](int cy) {
    const int t0 = cy * kL;
    const int tc = min(kL, T - t0);
#pragma unroll
    for (int jt = 0; jt < 2; ++jt) {
      const int jl = 8 * jt + 2 * c4;
      const float2 p0 = *reinterpret_cast<const float2*>(&sm.ypart[jw][g][jl]);
      const float2 p1 = *reinterpret_cast<const float2*>(&sm.ypart[jw][g + 8][jl]);
      const int j = 16 * jw + jl;
      if (g < tc)
        *reinterpret_cast<__nv_bfloat162*>(ybh + (long long)(t0 + g) * yt + j) =
            __floats2bfloat162_rn(yacc[jt][0] + p0.x, yacc[jt][1] + p0.y);
      if (g + 8 < tc)
        *reinterpret_cast<__nv_bfloat162*>(ybh + (long long)(t0 + g + 8) * yt + j) =
            __floats2bfloat162_rn(yacc[jt][2] + p1.x, yacc[jt][3] + p1.y);
    }
  };

  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // chunk c is in place; chunk c - 1's products are done
    {
      const int cn = c + kStages - 1;   // zero-filled past the end
      load_chunk(sm, cn % kStages, cn, T, r, k, v, w, base, st, tid);
      cp_async_commit();
    }
    if (iw == 0 && c > 0) store_y(c - 1);
    prep_chunk(sm, c % kStages, min(kL, T - c * kL), tid);
    __syncthreads();   // chunk c's operands are made

    // ---- products on the tensor cores ----
    float ylo[2][4];
#pragma unroll
    for (int jt = 0; jt < 2; ++jt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        yacc[jt][e] = 0.0f;
        ylo[jt][e] = 0.0f;
      }
    // y += R~[:, i half] S[i half, j]: 3xTF32, K = i in 4 steps of 8, the
    // step's k index kappa = c4 (+4) taken as i = 32 iw + 8 m + 2 c4 (+1).
    // The tensor cores truncate each sum toward zero at its largest
    // addend's last bit, and with w near 1 the terms r~_i S_ij grow to
    // hundreds while y may cancel to 1e-3: so each step's high product
    // lands in a fresh accumulator and is added in float32 (round to
    // nearest); the low parts' products (2^-11 smaller) share one
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int i0 = 32 * iw + 8 * m + 2 * c4;
      const float2 h0 = *reinterpret_cast<const float2*>(&sm.rt_hi[g][i0]);
      const float2 h1 = *reinterpret_cast<const float2*>(&sm.rt_hi[g + 8][i0]);
      const float2 l0 = *reinterpret_cast<const float2*>(&sm.rt_lo[g][i0]);
      const float2 l1 = *reinterpret_cast<const float2*>(&sm.rt_lo[g + 8][i0]);
      const unsigned ah[4] = {__float_as_uint(h0.x), __float_as_uint(h1.x),
                              __float_as_uint(h0.y), __float_as_uint(h1.y)};
      const unsigned al[4] = {__float_as_uint(l0.x), __float_as_uint(l1.x),
                              __float_as_uint(l0.y), __float_as_uint(l1.y)};
#pragma unroll
      for (int jt = 0; jt < 2; ++jt) {
        unsigned bh0, bl0, bh1, bl1;
        split_tf32(S[m][2 * jt], bh0, bl0);
        split_tf32(S[m][2 * jt + 1], bh1, bl1);
        float hh[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma1688(hh, ah, bh0, bh1);
#pragma unroll
        for (int e = 0; e < 4; ++e) yacc[jt][e] += hh[e];
        mma1688(ylo[jt], ah, bl0, bl1);
        mma1688(ylo[jt], al, bh0, bh1);
      }
    }
    if (iw == 0) {
      // y += A V: K = s, one step of 16; v is bf16 exactly, A in hi + lo
      unsigned ah[4], al[4];
      split_pair(&sm.a[g][2 * c4], ah[0], al[0]);
      split_pair(&sm.a[g + 8][2 * c4], ah[1], al[1]);
      split_pair(&sm.a[g][8 + 2 * c4], ah[2], al[2]);
      split_pair(&sm.a[g + 8][8 + 2 * c4], ah[3], al[3]);
#pragma unroll
      for (int jt = 0; jt < 2; ++jt) {
        const int j = 16 * jw + 8 * jt + g;
        const unsigned b0 = *reinterpret_cast<const unsigned*>(&sm.vt[j][2 * c4]);
        const unsigned b1 = *reinterpret_cast<const unsigned*>(&sm.vt[j][8 + 2 * c4]);
        mma16816(ylo[jt], ah, b0, b1);
        mma16816(ylo[jt], al, b0, b1);
      }
#pragma unroll
      for (int jt = 0; jt < 2; ++jt)
#pragma unroll
        for (int e = 0; e < 4; ++e) yacc[jt][e] += ylo[jt][e];
    } else {
#pragma unroll
      for (int jt = 0; jt < 2; ++jt) {
        const int jl = 8 * jt + 2 * c4;
        *reinterpret_cast<float2*>(&sm.ypart[jw][g][jl]) =
            make_float2(yacc[jt][0] + ylo[jt][0], yacc[jt][1] + ylo[jt][1]);
        *reinterpret_cast<float2*>(&sm.ypart[jw][g + 8][jl]) =
            make_float2(yacc[jt][2] + ylo[jt][2], yacc[jt][3] + ylo[jt][3]);
      }
    }
    // S^T <- S^T diag(D) + V^T K~ on this warp's (j, i) block: M = j,
    // N = i (4 steps of 8), K = s.  The product lands in a fresh
    // accumulator and S is updated in float32 (one rounding to nearest):
    // accumulating S itself in the tensor cores would truncate it toward
    // zero twice a chunk, a bias that over 160 chunks of w near 1 reaches
    // 1e-4 where |S| has been ~50
    unsigned av[4];
    av[0] = *reinterpret_cast<const unsigned*>(&sm.vt[16 * jw + g][2 * c4]);
    av[1] = *reinterpret_cast<const unsigned*>(&sm.vt[16 * jw + g + 8][2 * c4]);
    av[2] = *reinterpret_cast<const unsigned*>(&sm.vt[16 * jw + g][8 + 2 * c4]);
    av[3] = *reinterpret_cast<const unsigned*>(&sm.vt[16 * jw + g + 8][8 + 2 * c4]);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int i = 32 * iw + 8 * nt;
      const float2 dd = *reinterpret_cast<const float2*>(&sm.d[i + 2 * c4]);
      const unsigned bh0 = *reinterpret_cast<const unsigned*>(&sm.kt_hi[i + g][2 * c4]);
      const unsigned bh1 = *reinterpret_cast<const unsigned*>(&sm.kt_hi[i + g][8 + 2 * c4]);
      const unsigned bl0 = *reinterpret_cast<const unsigned*>(&sm.kt_lo[i + g][2 * c4]);
      const unsigned bl1 = *reinterpret_cast<const unsigned*>(&sm.kt_lo[i + g][8 + 2 * c4]);
      float ds[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      mma16816(ds, av, bl0, bl1);
      mma16816(ds, av, bh0, bh1);
      S[nt][0] = fmaf(dd.x, S[nt][0], ds[0]);
      S[nt][1] = fmaf(dd.y, S[nt][1], ds[1]);
      S[nt][2] = fmaf(dd.x, S[nt][2], ds[2]);
      S[nt][3] = fmaf(dd.y, S[nt][3], ds[3]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();     // the last chunk's other y half is in shared memory
  if (iw == 0) store_y(nchunks - 1);
  float* so = s_out + (long long)blockIdx.x * kHead * kHead;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int i = 32 * iw + 8 * nt + 2 * c4;
    const int j = 16 * jw + g;
    so[i * kHead + j] = S[nt][0];
    so[(i + 1) * kHead + j] = S[nt][1];
    so[i * kHead + j + 8] = S[nt][2];
    so[(i + 1) * kHead + j + 8] = S[nt][3];
  }
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
// dtype, through yb/yh/yt) and S_T (B, H, 64, 64) float32.  T >= 1.  The
// bf16 route needs 16-byte aligned r/k/v/w and strides that are multiples
// of 8 elements.
int wkv6_scan(const void* r, const void* k, const void* v, const float* w,
              const float* u, int B, int H, int T, long long sb, long long sh,
              long long st, int bf16, long long yb, long long yh, long long yt,
              void* y, float* s_out, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int blocks = B * H;
  if (bf16) {
    using T16 = __nv_bfloat16;
    static bool attr_set = false;
    if (!attr_set) {
      const cudaError_t err = cudaFuncSetAttribute(
          wkv6_chunked_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)sizeof(ChunkSmem));
      if (err != cudaSuccess) return (int)err;
      attr_set = true;
    }
    wkv6_chunked_bf16<<<blocks, kCThreads, sizeof(ChunkSmem), stream>>>(
        (const T16*)r, (const T16*)k, (const T16*)v, w, u, H, T, sb, sh, st, yb, yh, yt,
        (T16*)y, s_out);
  } else {
    wkv6_fwd<float><<<blocks, kHead, 0, stream>>>(
        (const float*)r, (const float*)k, (const float*)v, w, u, H, T, sb, sh,
        st, yb, yh, yt, (float*)y, s_out);
  }
  RETURN_IF_ERROR();
  return 0;
}

}  // extern "C"
