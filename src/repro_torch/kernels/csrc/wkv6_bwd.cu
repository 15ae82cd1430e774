// The backward of the RWKV6 WKV recurrence (K12's backward) for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package differentiates the two-level scan
// of src/repro/kernels/ref.py:wkv6_scan under jax.vjp, recomputing each
// 64-step chunk's states under remat.  Per (batch, head), with the state
// S_t = diag(w_t) S_{t-1} + k_t v_t^T (S_{-1} = 0) and G_t = dL/dS_t
// (G_{T-1} = 0: S_T carries no gradient):
//
//     dr_t = S_{t-1} dy_t + u * k_t (v_t . dy_t)
//     dk_t = u * r_t (v_t . dy_t) + G_t v_t
//     dv_t = (r_t . (u * k_t)) dy_t + G_t^T k_t
//     dw_t = rowsum(G_t * S_{t-1})
//     du   = sum over (b, t) of r_t * k_t (v_t . dy_t)
//     G_{t-1} = diag(w_t) G_t + r_t dy_t^T
//
// dw pairs each G_t with S_{t-1}, which runs the other way in time, and S
// cannot be stepped backwards (w = exp(-exp(.)) underflows to 0, and
// dividing by it fails).  Two routes, by the dtype of r/k/v/dy.
//
// bfloat16 (what training launches): a chunked scan on the tensor cores,
// two kernels and the wrapper's sum a call (the pieces it shares with the
// forward's chunked route are in csrc/wkv6_chunk.cuh).  Chunks of L = 16
// steps; per (b, h) and chunk,
// with S the state before it, G the gradient of the state after its last
// step (0 after the last chunk), pi(a, b) the product of w over the steps
// strictly between a and b (per channel), P_t = pi(t0 - 1, t), Q_s =
// pi(s, t0 + L), D the product over the chunk, R~ = r * P, K~ = k * Q,
// M = dY V^T (L x L) and A the forward's intra-chunk matrix (its diagonal
// r_t . (u * k_t), csrc/wkv6.cu):
//
//     S_next = diag(D) S + K~^T V,      G_prev = diag(D) G + R~^T dY
//     dr_t = P_t * (S dy_t) + sum_{s<t} pi(s, t) k_s M[t, s] + u * k_t M[t, t]
//     dk_s = Q_s * (G v_s) + sum_{t>s} pi(s, t) r_t M[t, s] + u * r_s M[s, s]
//     dv   = K~ G + A^T dY                        (rows s)
//     dw_t = P_t Q_t rowsum(G * S)                                    (a)
//          + Q_t sum_{s<t} pi(s, t) k_s (G v_s)                       (b)
//          + P_t sum_{t'>t} pi(t, t') r_t' (S dy_t')                  (c)
//          + sum_{s<t<t'} pi(s, t) pi(t, t') r_t' k_s M[t', s]        (d)
//
// 1. wkv6_bwd_states, grid (B*H x 64 / kPassCols, 2): blockIdx.y = 0 walks
//    the chunks forward and stores S before each, 1 walks them backward
//    and stores G after each (into one (B*H, T/L, 2, 64, 64) float32
//    buffer, as many floats as the float32 route's checkpoints).  A column
//    block of S or G evolves alone, so each head's 64 value columns split
//    over 64 / kPassCols = 2 blocks (320 blocks at (2, 40, 4096)).  Each
//    chunk arrives by cp.async in a kStages-deep ring; thread (i, half)
//    forms channel i's decay products and K~ or R~ for half the chunk's
//    steps; the product runs as mma.sync m16n8k8 in TF32 (K~ and R~ as hi
//    + lo parts, v and dy exact), into a fresh accumulator; S or G is
//    updated in float32 registers (one rounding to nearest), never in the
//    tensor cores' truncating accumulators, and stored as whole 32-byte
//    sectors (16 bytes a lane).
// 2. wkv6_bwd_chunks, one block per (b, h, chunk), all in parallel
//    (20 480 at (2, 40, 4096)): reads its chunk's S and G and inputs, runs
//    S dY^T, G V^T, K~ G (3xTF32: hi*hi + hi*lo + lo*hi), A^T dY (A in hi
//    + lo, dy exact) and M (bf16, exact products) on mma.sync, then on the
//    SIMT units only running products and sums a channel: thread (i, q)
//    takes channel i and the key steps s = 4q .. 4q + 3, runs z[t, s] =
//    sum_{t'>t} pi(t, t') r_t' M[t', s] backwards (z[s, s] is dk's pair
//    sum) and alpha[t, s] = pi(s, t) k_s forwards, which gives dr's pair
//    sum (alpha M) and dw's (b) + (d) (alpha (z + Q_t G v_s)); the four
//    threads of a channel meet in a two-round reduce-scatter.  (c) is a
//    backward running sum; (a) one 64-vector a chunk.  dr, dk and dv are
//    written at bf16 (rounded to nearest from float32, the values .to()
//    gives), dw in float32, du as (B*H*chunks, 64) partials that the
//    wrapper sums in a fixed order (torch's sum; no atomics).
// 3. (the wrapper) du's sum.
// tools/k11_k12_bwd_ablation.py times the choices (PERF.md): the passes'
// columns a block and ring depth, the chunk kernel's key steps a pass and
// blocks an SM, and each part cut out: the chunk kernel (two 256-thread
// blocks an SM, 128 registers) is bound by issuing its instructions, not
// by its loads; the state kernel by its 671 MB of stores.
// Nothing is ever divided by a w or a product of w's: w at 0 (a forgetting
// head) or near 1 is safe.  A ragged tail reads w = 1 and zeros past T.
//
// float32: the sequential kernel (wkv6_back).  It recomputes S: a first
// pass runs the forward recurrence and stores S every kC = 8 steps (ckpt:
// (B*H, T/8, 64, 64) float32); the second walks those 8-step sub-chunks
// from the last, recomputes each one's eight S_{t-1} from its checkpoint
// into shared memory (128 KB), then steps G back through them.  One block
// of 256 threads per (b, h).  Thread (i, q) = (tid / 4, tid % 4) owns row
// i of S and G at the columns j = q + 4 m, m < 16, in registers.  The row
// sums (dr, dk, dw) close with two xor shuffles among a row's four
// threads; dv's column sums over i run as a reduce-scatter over the warp's
// eight rows (14 shuffles) and a sum over the eight warps' partials in
// shared memory once a sub-chunk.  States and checkpoints are stored in
// thread order (entry m of thread tid at m * 256 + tid), which only the
// thread that wrote an entry reads back.  The scalars r_t . (u * k_t) and
// v_t . dy_t are one warp's shuffle sum a step.  It writes float32.
//
// Both routes read r/k/v/w through the (b, h, t) strides of strided views
// (the forward's rwkv6._heads views are read in place; the bf16 route
// wants 16-byte aligned rows, as the forward's does), dy through its own,
// and write the gradients through the strides of (B, H, T, 64) views.
// Sums run in FMAs and in another order than the plain version
// (kernels/ref.py:wkv6_scan_bwd), which they are held to within a
// tolerance.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense): the function
// reads r, k, v, dy, w and u and writes dr, dk, dv, dw, du; its least
// work a (b, h, t) is 64 x 64 x 12 operations (the state's update and
// G's, an FMA each for dr, dk, dv and dw).  At (2, 40, 4096, 64) in bf16
// that is 461 MB (bf16 r, k, v, dy and float32 w in; bf16 dr, dk, dv and
// float32 dw out: 0.13773 ms) against 16.1 GFLOP (0.016 ms on the bf16
// tensor cores, 0.24 ms at float32's 67 TFLOP/s), so the bound is the
// bytes.  The chunked route also moves its S and G buffer (671 MB written
// and read back at that shape).  PERF.md has the times (chip_smoke.py,
// tools/k11_k12_bwd_ablation.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wkv6_chunk.cuh"

namespace {

using namespace wkv6_chunk;

constexpr int kThreads = 256;  // 8 warps: 64 rows x 4 column quarters
constexpr int kCols = 16;      // columns a thread owns
constexpr int kC = 8;          // steps a checkpoint interval (sub-chunk)
constexpr unsigned kFull = 0xffffffffu;

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
__device__ __forceinline__ void stage(float (*dst)[kHead], const float* src, long long base,
                                      long long st, int t0, int L) {
  for (int e = threadIdx.x; e < L * kHead; e += kThreads) {
    const int s = e >> 6, col = e & 63;
    dst[s][col] = (src[base + (long long)(t0 + s) * st + col]);
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
__global__ void __launch_bounds__(kThreads, 1)
wkv6_back(const float* __restrict__ r, const float* __restrict__ k, const float* __restrict__ v,
          const float* __restrict__ w, const float* __restrict__ u,
          const float* __restrict__ dy, int H, int steps, long long sb, long long sh,
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

// ---- bf16: the chunked route --------------------------------------------- //

constexpr int kChunkFloats = 2 * kHead * kHead;   // a chunk's S and G
// The design's choices (tools/k11_k12_bwd_ablation.py builds the others):
constexpr int kPassCols = 32;     // value columns a state-pass block owns
constexpr int kPassNt = kPassCols / 8;   // its n-tiles of 8
constexpr int kStages = 2;        // the passes' cp.async ring depth (chunks)
constexpr int kSPass = 2;         // key steps a chunk-kernel thread runs together
constexpr int kGradBlocks = 2;    // the chunk kernel's blocks an SM (its registers)
constexpr int kPassThreads = 128;      // 4 warps, 16 state rows each
constexpr int kGradThreads = 256;      // 8 warps; 64 channels x 4 quarters
constexpr int kXLd = 72;               // padded row strides (elements)
constexpr int kYLd = kPassCols + 8;
constexpr int kSLd = 68;
constexpr int kBLd = 72;
constexpr int kTLd = 72;
constexpr int kMLd = 20;
static_assert(kHead % kPassCols == 0 && kPassCols % 8 == 0, "pass columns");
static_assert(kStages >= 2, "ring depth");
static_assert(4 % kSPass == 0, "key steps a pass");

// x -> TF32 hi (x truncated to 10 mantissa bits) and lo = x - hi, exact
// in float32; the tensor cores read lo's top 10 mantissa bits, so hi + lo
// holds x to about 2^-20 of |x|.  Two instructions, where cvt.rna.tf32 is
// emulated in several integer ones on sm_90.
__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// A 16-byte store that stays one instruction.
__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  asm volatile("st.global.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"l"(p), "f"(a), "f"(b),
               "f"(c), "f"(d));
}

// A bf16 value as a TF32 operand (exact: 8 significant bits).
__device__ __forceinline__ unsigned tf32_of(__nv_bfloat16 x) {
  return __float_as_uint(__bfloat162float(x));
}

__device__ __forceinline__ unsigned bf16_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

__device__ __forceinline__ float2 float2_of(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

struct PassSmem {
  __nv_bfloat16 x[kStages][kL][kHead];    // k (state pass) or r (gradient pass)
  float w[kStages][kL][kHead];
  __nv_bfloat16 y[kStages][kL][kYLd];     // v or dy at the block's columns
  float xh[kL][kXLd];                     // K~ or R~ (t, i): TF32 hi part
  float xl[kL][kXLd];                     // and lo part
  float d[kHead];                         // D
};

// grid: (B*H * 64 / kPassCols, 2); block: kPassThreads.  blockIdx.x = bh *
// (64 / kPassCols) + the column block; blockIdx.y = 0: S, forward over the
// chunks, S before chunk c stored at states[bh][c][0]; 1: G, backward, G
// after chunk c at states[bh][c][1].  Warp wp owns state rows 16 wp .. +15
// and the block's columns, in accumulator layout: st[nt][e] at row 16 wp
// + g (+8 for e >= 2), column j0 + 8 nt + 2 c4 (+1 for odd e).
__global__ void __launch_bounds__(kPassThreads)
wkv6_bwd_states(const __nv_bfloat16* __restrict__ r, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, const float* __restrict__ w,
                const __nv_bfloat16* __restrict__ dy, int H, int T, long long sb,
                long long sh, long long st, long long gb, long long gh, long long gt,
                float* __restrict__ states) {
  __shared__ __align__(16) PassSmem sm;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c4 = lane & 3;
  constexpr int kBlocks = kHead / kPassCols;
  const int bh = blockIdx.x / kBlocks;
  const int j0 = (blockIdx.x - bh * kBlocks) * kPassCols;
  const bool grad = blockIdx.y == 1;
  const int b = bh / H, h = bh - b * H;
  const long long xbase = (long long)b * sb + (long long)h * sh;
  const long long ybase = grad ? (long long)b * gb + (long long)h * gh : xbase;
  const long long yst = grad ? gt : st;
  const __nv_bfloat16* xsrc = grad ? r : k;
  const __nv_bfloat16* ysrc = grad ? dy : v;
  const int n = (T + kL - 1) / kL;
  float* out = states + (long long)bh * n * kChunkFloats + (grad ? kHead * kHead : 0);

  // the chunk of step idx of this pass's walk into ring slot `slot`; rows
  // at or past T, and walks past the last chunk, are zero-filled
  auto load = [&](int slot, int idx) {
    const int c = grad ? n - 1 - idx : idx;
    const bool live = idx < n;
    const int t0 = c * kL;
    {
      const int row = tid >> 3, seg = tid & 7;       // 16 rows x 8 segments
      const bool ok = live && t0 + row < T;
      const long long off = xbase + (ok ? (long long)(t0 + row) * st : 0) + seg * 8;
      cp_async16(&sm.x[slot][row][seg * 8], xsrc + off, ok ? 16 : 0);
    }
#pragma unroll
    for (int m = 0; m < 2; ++m) {                    // 16 rows x 16 segments
      const int e = tid + kPassThreads * m;
      const int row = e >> 4, seg = e & 15;
      const bool ok = live && t0 + row < T;
      const long long off = xbase + (ok ? (long long)(t0 + row) * st : 0) + seg * 4;
      cp_async16(&sm.w[slot][row][seg * 4], w + off, ok ? 16 : 0);
    }
    constexpr int kSegs = kPassCols / 8;
    if (tid < kL * kSegs) {                          // 16 rows x the block's columns
      const int row = tid / kSegs, seg = tid - row * kSegs;
      const bool ok = live && t0 + row < T;
      const long long off = ybase + (ok ? (long long)(t0 + row) * yst : 0) + j0 + seg * 8;
      cp_async16(&sm.y[slot][row][seg * 8], ysrc + off, ok ? 16 : 0);
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    load(s, s);
    cp_async_commit();
  }
  float acc_state[kPassNt][4];
#pragma unroll
  for (int nt = 0; nt < kPassNt; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_state[nt][e] = 0.0f;
  const int m0 = 16 * warp;

  for (int idx = 0; idx < n; ++idx) {
    const int c = grad ? n - 1 - idx : idx;
    const int slot = idx % kStages;
    const int tc = min(kL, T - c * kL);
    cp_async_wait<kStages - 2>();
    __syncthreads();   // chunk idx is in place; the last chunk's reads are done
    load((idx + kStages - 1) % kStages, idx + kStages - 1);
    cp_async_commit();
    // S before chunk c, or G after it: lanes c4 = 2m and 2m + 1 swap a
    // pair, so each stores four neighbouring columns (16 bytes; rows g
    // and g + 8 in turn), whole 32-byte sectors a row
    float* o = out + (long long)c * kChunkFloats;
#pragma unroll
    for (int nt = 0; nt < kPassNt; ++nt) {
      const bool odd = c4 & 1;
      const float s0 = __shfl_xor_sync(kFull, odd ? acc_state[nt][0] : acc_state[nt][2], 1);
      const float s1 = __shfl_xor_sync(kFull, odd ? acc_state[nt][1] : acc_state[nt][3], 1);
      float* row = o + (m0 + g + (odd ? 8 : 0)) * kHead + j0 + 8 * nt + 4 * (c4 >> 1);
      if (odd)
        store4(row, s0, s1, acc_state[nt][2], acc_state[nt][3]);
      else
        store4(row, acc_state[nt][0], acc_state[nt][1], s0, s1);
    }
    // K~ = k * Q (suffix products) or R~ = r * P (prefix products), and D:
    // thread (i, half) runs channel i's product chain and splits the
    // chunk's half `half` of its walk
    {
      const int i = tid & (kHead - 1), half = tid >> 6;
      float p = 1.0f;
#pragma unroll
      for (int e = 0; e < kL; ++e) {
        const int t = grad ? e : kL - 1 - e;
        if (e / (kL / 2) == half) {
          unsigned hi, lo;
          split_tf32(__bfloat162float(sm.x[slot][t][i]) * p, hi, lo);
          sm.xh[t][i] = __uint_as_float(hi);
          sm.xl[t][i] = __uint_as_float(lo);
        }
        p *= t < tc ? sm.w[slot][t][i] : 1.0f;
      }
      if (half == 0) sm.d[i] = p;
    }
    __syncthreads();
    // X^T Y on the tensor cores: M = i (the warp's 16 rows), N = j, K = t
#pragma unroll
    for (int nt = 0; nt < kPassNt; ++nt) {
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int kk = 0; kk < kL / 8; ++kk) {
        const int t = 8 * kk + c4;
        const unsigned ah[4] = {
            __float_as_uint(sm.xh[t][m0 + g]), __float_as_uint(sm.xh[t][m0 + g + 8]),
            __float_as_uint(sm.xh[t + 4][m0 + g]), __float_as_uint(sm.xh[t + 4][m0 + g + 8])};
        const unsigned al[4] = {
            __float_as_uint(sm.xl[t][m0 + g]), __float_as_uint(sm.xl[t][m0 + g + 8]),
            __float_as_uint(sm.xl[t + 4][m0 + g]), __float_as_uint(sm.xl[t + 4][m0 + g + 8])};
        const unsigned b0 = tf32_of(sm.y[slot][t][8 * nt + g]);
        const unsigned b1 = tf32_of(sm.y[slot][t + 4][8 * nt + g]);
        mma1688(acc, al, b0, b1);
        mma1688(acc, ah, b0, b1);
      }
      const float d0 = sm.d[m0 + g], d1 = sm.d[m0 + g + 8];
      acc_state[nt][0] = fmaf(d0, acc_state[nt][0], acc[0]);
      acc_state[nt][1] = fmaf(d0, acc_state[nt][1], acc[1]);
      acc_state[nt][2] = fmaf(d1, acc_state[nt][2], acc[2]);
      acc_state[nt][3] = fmaf(d1, acc_state[nt][3], acc[3]);
    }
  }
  cp_async_wait<0>();
}

struct GradSmem {
  union {
    struct {
      float s[kHead][kSLd];            // S before the chunk  (i, j)
      float g[kHead][kSLd];            // G after it
    } st;
    struct {                           // the chunk's gradients, staged for the stores
      __nv_bfloat16 dr[kL][kBLd];
      __nv_bfloat16 dk[kL][kBLd];
      __nv_bfloat16 dv[kL][kBLd];
      float dw[kL][kHead];
    } out;
  };
  __nv_bfloat16 r[kL][kBLd];           // r, k, v, dy in this order (one loop stages them)
  __nv_bfloat16 k[kL][kBLd];
  __nv_bfloat16 v[kL][kBLd];
  __nv_bfloat16 dy[kL][kBLd];
  float w[kL][kHead];                  // 0 past T
  float p[kL][kHead];                  // P_t
  float q[kL][kHead];                  // Q_t
  float sd[kL][kTLd];                  // (S dy_t)_i      (t, i)
  float gv[kL][kTLd];                  // (G v_s)_i       (s, i)
  float a[kL][kALd];                   // A               (t, s)
  float m[kL][kMLd];                   // M = dY V^T      (t, s); diagonal v_t . dy_t
  float u[kHead];
};

// grid: B*H*n blocks (block = bh * n + c, n = ceil(T / L)); block:
// kGradThreads; dynamic shared memory: GradSmem.  Strides as
// wkv6_bwd_states'; ob/oh/ot those of the four (B, H, T, 64) outputs.
// Three barriers: inputs in; P, Q, A made; products made.
__global__ void __launch_bounds__(kGradThreads, kGradBlocks)
wkv6_bwd_chunks(const __nv_bfloat16* __restrict__ r, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const __nv_bfloat16* __restrict__ dy, int H,
                int T, long long sb, long long sh, long long st, long long gb, long long gh,
                long long gt, long long ob, long long oh, long long ot,
                const float* __restrict__ states, __nv_bfloat16* __restrict__ dr,
                __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                float* __restrict__ dw, float* __restrict__ du_part) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  GradSmem& sm = *reinterpret_cast<GradSmem*>(smem_raw);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c4 = lane & 3;
  const int n = (T + kL - 1) / kL;
  const int bh = blockIdx.x / n;
  const int c = blockIdx.x - bh * n;
  const int b = bh / H, h = bh - b * H;
  const int t0 = c * kL, tc = min(kL, T - t0);
  const long long in0 = (long long)b * sb + (long long)h * sh + (long long)t0 * st;
  const long long dy0 = (long long)b * gb + (long long)h * gh + (long long)t0 * gt;

  // ---- the chunk's S, G and inputs in (rows past T zero) ---------------- //
  {
    const float* sg = states + (long long)blockIdx.x * kChunkFloats;
    for (int e = tid; e < 2 * kHead * 16; e += kGradThreads) {
      const int row = (e >> 4) & (kHead - 1), seg = e & 15;
      float* dst = e < kHead * 16 ? &sm.st.s[row][seg * 4] : &sm.st.g[row][seg * 4];
      cp_async16(dst, sg + e * 4, 16);
    }
    for (int e = tid; e < 4 * kL * 8; e += kGradThreads) {
      const int which = e >> 7, row = (e >> 3) & (kL - 1), seg = e & 7;
      const bool ok = row < tc;
      const __nv_bfloat16* src =
          which == 0 ? r : which == 1 ? k : which == 2 ? v : dy;
      const long long off = (which == 3 ? dy0 + (ok ? (long long)row * gt : 0)
                                        : in0 + (ok ? (long long)row * st : 0)) + seg * 8;
      cp_async16(&sm.r[0][0] + (which * kL + row) * kBLd + seg * 8, src + off, ok ? 16 : 0);
    }
    {
      const int row = tid >> 4, seg = tid & 15;
      const bool ok = row < tc;
      cp_async16(&sm.w[row][seg * 4], w + in0 + (ok ? (long long)row * st : 0) + seg * 4,
                 ok ? 16 : 0);
    }
    cp_async_commit();
    if (tid < kHead) sm.u[tid] = u[h * kHead + tid];
    cp_async_wait<0>();
    __syncthreads();
  }

  // ---- P, Q (running products, w = 1 past T), rowsum(G * S), A ---------- //
  const int ci = tid >> 2, cq = tid & 3;   // the SIMT layout: channel, quarter
  if (tid < 2 * kHead) {
    const int i = tid & (kHead - 1);
    float x = 1.0f;
    if (tid < kHead) {
#pragma unroll
      for (int t = 0; t < kL; ++t) {
        sm.p[t][i] = x;
        x *= t < tc ? sm.w[t][i] : 1.0f;
      }
    } else {
#pragma unroll
      for (int t = kL - 1; t >= 0; --t) {
        sm.q[t][i] = x;
        x *= t < tc ? sm.w[t][i] : 1.0f;
      }
    }
  }
  float gs = 0.0f;
#pragma unroll
  for (int m = 0; m < kHead / 4; ++m)
    gs = fmaf(sm.st.g[ci][cq + 4 * m], sm.st.s[ci][cq + 4 * m], gs);
  gs += __shfl_xor_sync(kFull, gs, 1);
  gs += __shfl_xor_sync(kFull, gs, 2);
  chunk_a<kBLd>(sm.r, sm.k, sm.w, sm.u, sm.a, tid);
  __syncthreads();

  // ---- products on the tensor cores ---------------------------------- //
  float dvo[4];
  {
    // sd (t, i) = S dy_t and gv (s, i) = G v_s: M = t, N = i in [8 warp,
    // +8), K = j in 8 steps of 8; S and G as TF32 hi + lo, dy and v exact.
    // Each step's high product lands in a fresh accumulator, added in
    // float32; the low products share one.
    const int in = 8 * warp + g;
    float sdh[4] = {0.0f, 0.0f, 0.0f, 0.0f}, sdl[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float gvh[4] = {0.0f, 0.0f, 0.0f, 0.0f}, gvl[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int kk = 0; kk < kHead / 8; ++kk) {
      const int j = 8 * kk + c4;
      const unsigned ady[4] = {tf32_of(sm.dy[g][j]), tf32_of(sm.dy[g + 8][j]),
                               tf32_of(sm.dy[g][j + 4]), tf32_of(sm.dy[g + 8][j + 4])};
      const unsigned av[4] = {tf32_of(sm.v[g][j]), tf32_of(sm.v[g + 8][j]),
                              tf32_of(sm.v[g][j + 4]), tf32_of(sm.v[g + 8][j + 4])};
      unsigned h0, l0, h1, l1;
      split_tf32(sm.st.s[in][j], h0, l0);
      split_tf32(sm.st.s[in][j + 4], h1, l1);
      float f[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      mma1688(f, ady, h0, h1);
#pragma unroll
      for (int e = 0; e < 4; ++e) sdh[e] += f[e];
      mma1688(sdl, ady, l0, l1);
      split_tf32(sm.st.g[in][j], h0, l0);
      split_tf32(sm.st.g[in][j + 4], h1, l1);
      float f2[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      mma1688(f2, av, h0, h1);
#pragma unroll
      for (int e = 0; e < 4; ++e) gvh[e] += f2[e];
      mma1688(gvl, av, l0, l1);
    }
    const int ic = 8 * warp + 2 * c4;
    float2* sd0 = reinterpret_cast<float2*>(&sm.sd[g][ic]);
    float2* sd8 = reinterpret_cast<float2*>(&sm.sd[g + 8][ic]);
    float2* gv0 = reinterpret_cast<float2*>(&sm.gv[g][ic]);
    float2* gv8 = reinterpret_cast<float2*>(&sm.gv[g + 8][ic]);
    *sd0 = make_float2(sdh[0] + sdl[0], sdh[1] + sdl[1]);
    *sd8 = make_float2(sdh[2] + sdl[2], sdh[3] + sdl[3]);
    *gv0 = make_float2(gvh[0] + gvl[0], gvh[1] + gvl[1]);
    *gv8 = make_float2(gvh[2] + gvl[2], gvh[3] + gvl[3]);
  }
  {
    // dv (s, j), j in [8 warp, +8): K~ G with K = i in 8 steps of 8 (the
    // step's k index c4 taken as i = i0 + 2 c4, c4 + 4 as i0 + 2 c4 + 1),
    // 3xTF32; then A^T dY, K = t in 2 steps, A as hi + lo, dy exact
    const int jn = 8 * warp + g;
    float dvh[4] = {0.0f, 0.0f, 0.0f, 0.0f}, dvl[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int kk = 0; kk < kHead / 8; ++kk) {
      const int i0 = 8 * kk + 2 * c4;
      const float2 k0 = float2_of(&sm.k[g][i0]), k1 = float2_of(&sm.k[g + 8][i0]);
      const float2 q0 = *reinterpret_cast<const float2*>(&sm.q[g][i0]);
      const float2 q1 = *reinterpret_cast<const float2*>(&sm.q[g + 8][i0]);
      unsigned ah[4], al[4];
      split_tf32(k0.x * q0.x, ah[0], al[0]);
      split_tf32(k1.x * q1.x, ah[1], al[1]);
      split_tf32(k0.y * q0.y, ah[2], al[2]);
      split_tf32(k1.y * q1.y, ah[3], al[3]);
      unsigned bh0, bl0, bh1, bl1;
      split_tf32(sm.st.g[i0][jn], bh0, bl0);
      split_tf32(sm.st.g[i0 + 1][jn], bh1, bl1);
      float f[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      mma1688(f, ah, bh0, bh1);
#pragma unroll
      for (int e = 0; e < 4; ++e) dvh[e] += f[e];
      mma1688(dvl, ah, bl0, bl1);
      mma1688(dvl, al, bh0, bh1);
    }
#pragma unroll
    for (int kk = 0; kk < kL / 8; ++kk) {
      const int t = 8 * kk + c4;
      unsigned ah[4], al[4];
      split_tf32(sm.a[t][g], ah[0], al[0]);
      split_tf32(sm.a[t][g + 8], ah[1], al[1]);
      split_tf32(sm.a[t + 4][g], ah[2], al[2]);
      split_tf32(sm.a[t + 4][g + 8], ah[3], al[3]);
      const unsigned b0 = tf32_of(sm.dy[t][jn]), b1 = tf32_of(sm.dy[t + 4][jn]);
      mma1688(dvl, al, b0, b1);
      mma1688(dvl, ah, b0, b1);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) dvo[e] = dvh[e] + dvl[e];
  }
  if (warp < kL / 8) {
    // M (t, s), s in [8 warp, +8): K = j in 4 steps of 16, bf16 (exact
    // products)
    const int sn = 8 * warp + g;
    float mm[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int kk = 0; kk < kHead / 16; ++kk) {
      const int j = 16 * kk + 2 * c4;
      const unsigned a[4] = {bf16_pair(&sm.dy[g][j]), bf16_pair(&sm.dy[g + 8][j]),
                             bf16_pair(&sm.dy[g][j + 8]), bf16_pair(&sm.dy[g + 8][j + 8])};
      mma16816(mm, a, bf16_pair(&sm.v[sn][j]), bf16_pair(&sm.v[sn][j + 8]));
    }
    const int sc = 8 * warp + 2 * c4;
    *reinterpret_cast<float2*>(&sm.m[g][sc]) = make_float2(mm[0], mm[1]);
    *reinterpret_cast<float2*>(&sm.m[g + 8][sc]) = make_float2(mm[2], mm[3]);
  }
  __syncthreads();     // products made; S and G are read (their room stages the outputs)
  {
    const int jc = 8 * warp + 2 * c4;
    *reinterpret_cast<__nv_bfloat162*>(&sm.out.dv[g][jc]) =
        __floats2bfloat162_rn(dvo[0], dvo[1]);
    *reinterpret_cast<__nv_bfloat162*>(&sm.out.dv[g + 8][jc]) =
        __floats2bfloat162_rn(dvo[2], dvo[3]);
  }

  // ---- the per-channel sums: thread (i, q), key steps s = 4q .. 4q + 3 -- //
  const int i = ci, q = cq;
  float adr[kL], adw[kL], dk_in[4];
#pragma unroll
  for (int t = 0; t < kL; ++t) {
    adr[t] = 0.0f;
    adw[t] = 0.0f;
  }
#pragma unroll
  for (int part = 0; part < 4 / kSPass; ++part) {
    const int s0 = 4 * q + kSPass * part;
    // z[t, s] = sum_{t'>t} pi(t, t') r_t' M[t', s], from the chunk's end;
    // z[s, s] is dk's pair sum
    float z[kSPass], zs[kSPass][kL];
#pragma unroll
    for (int j = 0; j < kSPass; ++j) {
      z[j] = 0.0f;
      dk_in[kSPass * part + j] = 0.0f;
    }
#pragma unroll
    for (int t = kL - 1; t >= 0; --t) {
      const float wt = sm.w[t][i], rt = __bfloat162float(sm.r[t][i]);
#pragma unroll
      for (int j = 0; j < kSPass; ++j) {
        zs[j][t] = z[j];
        if (t == s0 + j) dk_in[kSPass * part + j] = z[j];
        z[j] = fmaf(wt, z[j], rt * sm.m[t][s0 + j]);
      }
    }
    // alpha[t, s] = pi(s, t) k_s (0 up to t = s): dr's pair sum alpha M,
    // dw's (b) + (d) alpha (z + Q_t (G v_s))
    float ks[kSPass], gvs[kSPass], al[kSPass];
#pragma unroll
    for (int j = 0; j < kSPass; ++j) {
      ks[j] = __bfloat162float(sm.k[s0 + j][i]);
      gvs[j] = sm.gv[s0 + j][i];
      al[j] = 0.0f;
    }
#pragma unroll
    for (int t = 0; t < kL; ++t) {
      const float wt = sm.w[t][i], qt = sm.q[t][i];
#pragma unroll
      for (int j = 0; j < kSPass; ++j) {
        const float mt = sm.m[t][s0 + j];
        adr[t] = fmaf(al[j], mt, adr[t]);
        adw[t] = fmaf(al[j], fmaf(qt, gvs[j], zs[j][t]), adw[t]);
        al[j] = t == s0 + j ? ks[j] : al[j] * wt;
      }
    }
  }
  {
    // dw's (c): P_t sum_{t'>t} pi(t, t') r_t' (S dy_t'), in quarter 0 only
    float e = 0.0f;
#pragma unroll
    for (int t = kL - 1; t >= 0; --t) {
      if (q == 0) adw[t] = fmaf(sm.p[t][i], e, adw[t]);
      e = fmaf(sm.w[t][i], e, __bfloat162float(sm.r[t][i]) * sm.sd[t][i]);
    }
  }
  // the channel's four quarters summed; quarter q keeps t = 4q .. 4q + 3
  reduce_scatter_half<8, 2>(adr, lane);
  reduce_scatter_half<4, 1>(adr, lane);
  reduce_scatter_half<8, 2>(adw, lane);
  reduce_scatter_half<4, 1>(adw, lane);
  const float ui = sm.u[i];
  float du = 0.0f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int t = 4 * q + e;
    const float pt = sm.p[t][i], qt = sm.q[t][i];
    const float rt = __bfloat162float(sm.r[t][i]), kt = __bfloat162float(sm.k[t][i]);
    const float vd = sm.m[t][t];
    sm.out.dr[t][i] = __float2bfloat16_rn(fmaf(pt, sm.sd[t][i], adr[e]) + ui * kt * vd);
    sm.out.dk[t][i] = __float2bfloat16_rn(fmaf(qt, sm.gv[t][i], dk_in[e]) + ui * rt * vd);
    sm.out.dw[t][i] = fmaf(pt * qt, gs, adw[e]);
    du = fmaf(rt * kt, vd, du);
  }
  du += __shfl_xor_sync(kFull, du, 1);
  du += __shfl_xor_sync(kFull, du, 2);
  if (q == 0) du_part[(long long)blockIdx.x * kHead + i] = du;
  __syncthreads();

  // ---- the chunk's rows out, 16 bytes a store ------------------------- //
  const long long o0 = (long long)b * ob + (long long)h * oh + (long long)t0 * ot;
  for (int e = tid; e < 3 * kL * 8; e += kGradThreads) {
    const int which = e / (kL * 8), row = (e >> 3) & (kL - 1), seg = e & 7;
    if (row < tc) {
      __nv_bfloat16* dst = which == 0 ? dr : which == 1 ? dk : dv;
      *reinterpret_cast<uint4*>(dst + o0 + (long long)row * ot + seg * 8) =
          *reinterpret_cast<const uint4*>(&sm.out.dr[0][0] + (which * kL + row) * kBLd +
                                          seg * 8);
    }
  }
  {
    const int row = tid >> 4, seg = tid & 15;
    if (row < tc)
      *reinterpret_cast<float4*>(dw + o0 + (long long)row * ot + seg * 4) =
          *reinterpret_cast<const float4*>(&sm.out.dw[row][seg * 4]);
  }
}

}  // namespace

extern "C" {

const char* wkv6_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The checkpoint floats a (b, h) head needs: ceil(T / 8) states of 64 x 64.
long long wkv6_bwd_ckpt_floats(int T) { return (long long)((T + kC - 1) / kC) * kHead * kHead; }

// The chunked route's S and G floats a (b, h) head needs: ceil(T / 16)
// chunks of two 64 x 64 states.
long long wkv6_bwd_state_floats(int T) { return (long long)((T + kL - 1) / kL) * kChunkFloats; }

// K12's backward, float32: r, k, v, dy (B, H, T, 64) float32; r/k/v and w
// read through the strides sb/sh/st, dy through gb/gh/gt; u (H, 64).
// Writes dr, dk, dv, dw (float32, through ob/oh/ot), du_part (B*H, 64);
// ckpt is scratch of B*H * wkv6_bwd_ckpt_floats(T) floats.  T >= 1.
int wkv6_scan_bwd(const float* r, const float* k, const float* v, const float* w,
                  const float* u, const float* dy, int B, int H, int T, long long sb,
                  long long sh, long long st, long long gb, long long gh, long long gt,
                  long long ob, long long oh, long long ot, float* dr, float* dk, float* dv,
                  float* dw, float* du_part, float* ckpt, void* stream_ptr) {
  if (B < 1 || H < 1 || T < 1) return (int)cudaErrorInvalidValue;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        wkv6_back, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(BwdSmem));
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  wkv6_back<<<B * H, kThreads, sizeof(BwdSmem), (cudaStream_t)stream_ptr>>>(
      r, k, v, w, u, dy, H, T, sb, sh, st, gb, gh, gt, ob, oh, ot, dr, dk, dv, dw, du_part,
      ckpt);
  return (int)cudaGetLastError();
}

// K12's backward, bf16: r, k, v, dy (B, H, T, 64) bfloat16 with 16-byte
// aligned rows (data pointers and (b, h, t) strides in multiples of 8
// elements); w float32 through r's strides; u (H, 64) float32.  Writes
// dr, dk, dv (bf16) and dw (float32) through ob/oh/ot (16-byte aligned
// rows), du_part (B*H * ceil(T / 16), 64) float32; states is scratch of
// B*H * wkv6_bwd_state_floats(T) floats.  Two kernels.  T >= 1.
int wkv6_scan_bwd_chunked(const void* r, const void* k, const void* v, const float* w,
                          const float* u, const void* dy, int B, int H, int T,
                          long long sb, long long sh, long long st, long long gb,
                          long long gh, long long gt, long long ob, long long oh,
                          long long ot, void* dr, void* dk, void* dv, float* dw,
                          float* du_part, float* states, void* stream_ptr) {
  if (B < 1 || H < 1 || T < 1) return (int)cudaErrorInvalidValue;
  using T16 = __nv_bfloat16;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        wkv6_bwd_chunks, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(GradSmem));
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const long long heads = (long long)B * H;
  const long long n = (T + kL - 1) / kL;
  if (heads * (kHead / kPassCols) > 0x7fffffffLL || heads * n > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  wkv6_bwd_states<<<dim3((unsigned)(heads * (kHead / kPassCols)), 2), kPassThreads, 0,
                    stream>>>((const T16*)r, (const T16*)k, (const T16*)v, w,
                              (const T16*)dy, H, T, sb, sh, st, gb, gh, gt, states);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wkv6_bwd_chunks<<<(unsigned)(heads * n), kGradThreads, sizeof(GradSmem), stream>>>(
      (const T16*)r, (const T16*)k, (const T16*)v, w, u, (const T16*)dy, H, T, sb, sh, st,
      gb, gh, gt, ob, oh, ot, states, (T16*)dr, (T16*)dk, (T16*)dv, dw, du_part);
  return (int)cudaGetLastError();
}

}  // extern "C"
