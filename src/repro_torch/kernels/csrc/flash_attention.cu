// Forward flash attention (K10) for float32 inputs on Hopper (sm_90a): the
// SIMT route.  bf16 inputs take the wgmma kernel in flash_attention_sm90.cu.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention (_flash_kernel): online-softmax attention with GQA,
// a causal mask, a sliding window, a query offset and a logit softcap,
//
//     s_ij = softcap * tanh((q_i . k_j) * scale / softcap)    (softcap set)
//     visible(i, j) = j < Tk  and  j <= q_offset + i           (causal)
//                             and  j >  q_offset + i - window  (window)
//     o_i = sum_j softmax_j(s_ij over visible j) v_j,  0 if no j is visible
//
// with scale = 1/sqrt(Dh) applied after the dot product, as the Pallas
// kernel does.  Query head h reads KV head h / group (the BlockSpec index
// map of the TPU kernel), so the KV heads are never repeated in memory.
//
// The TPU kernel walks a sequential (B, Hq, Tq/bq, Tk/bk) grid and keeps
// the running max m, the denominator l and the output accumulator in VMEM
// scratch across key blocks.  Blocks on Hopper run in no order, so the key
// axis is a loop inside the block: one block of 256 threads per
// (b, hq, tile of 64 queries) walks the key tiles of 64 keys that hold a
// visible key.  Tiles wholly above the causal diagonal or wholly behind
// the window are skipped.  Each tile is staged in shared memory as float32
// (K transposed, V as it is; the block's Q tile, transposed, is staged
// once).  Thread (ty, tx) = (t / 16, t % 16) owns query rows 4ty..4ty+3:
//
//   * S = Q K^T: the thread's 4 x 4 logits (keys 4tx..4tx+3), float32
//     FMAs over Dh, one float4 of Q and one of K a step;
//   * scale, softcap, mask, then the online-softmax update in the order of
//     the Pallas kernel (flash_attention.py:66-74): m_new = max(m, rowmax),
//     p = exp(s - m_new), corr = exp(m - m_new), l = l * corr + rowsum(p),
//     acc = acc * corr + P V.  Row max and row sum are butterfly
//     reductions over the 16 lanes that share a row, so every lane holds
//     the same m and l;
//   * P goes through shared memory, and O += P V accumulates the thread's
//     4 rows x Dh/16 columns in float32 registers.
//
// Masked logits are -inf, not the Pallas kernel's -1e30: while a row has
// seen no visible key its max stays -inf, and p and corr are computed
// against 0 instead, so they are 0 and not 1.  A row with no visible key
// at all ends with l = 0 and is written as 0, as the oracle
// (ref.mha_attention) has it; the Pallas kernel gives the mean of v there.
//
// The products are SIMT float32 FMAs and P stays float32: the float32
// tolerance against the plain version (2e-5) rules out bf16 or TF32
// tensor-core operands, which round q, k and P to 8 or 10 mantissa bits.
//
// Bound on an H100 SXM for float32 inputs: 4 * Dh operations per visible
// (q, k) pair (QK^T and PV, a multiply and an add each) over the float32
// SIMT peak of 67 TFLOP/s.  The kernel runs at one block an SM for Dh >= 128
// (its shared memory), with three barriers a tile and no overlap of staging
// with compute.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;           // queries a block
constexpr int kBK = 64;           // keys a tile
constexpr int kThreads = 256;     // 16 row groups x 16 lanes
constexpr int kQS = kBQ + 4;      // row stride of Qt (padded, float4-aligned)
constexpr int kKS = kBK + 4;      // row stride of Kt and P

// Output columns of thread tx: Dh/16 of them, in runs of kVec adjacent
// columns (a float4, or a float2 at Dh = 32), run g at g * 16 * kVec.
template <int DH>
struct Cols {
  static constexpr int kPer = DH / 16;
  static constexpr int kVec = kPer < 4 ? kPer : 4;
  static constexpr int kRuns = kPer / kVec;
};

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t)(DH * kQS + DH * kKS + kBK * DH + kBQ * kKS);
}

// grid: (ceil(Tq / 64), Hq, B); block: 256 threads.  q/k/v strides are in
// elements, for the (b, h, t) axes; the last axis is dense.  out is a
// dense (B, Hq, Tq, DH) tensor.  window <= 0: no window; softcap <= 0: no
// softcap.
template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, int Hq, int group, int Tq, int Tk,
          long long qsb, long long qsh, long long qst, long long ksb,
          long long ksh, long long kst, long long vsb, long long vsh,
          long long vst, float scale, int causal, int window, int q_offset,
          float softcap, float* __restrict__ out) {
  using C = Cols<DH>;
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);  // [DH][kQS]: Qt[d][r]
  float* Kt = Qt + DH * kQS;                    // [DH][kKS]: Kt[d][c]
  float* Vs = Kt + DH * kKS;                    // [kBK][DH]
  float* Ps = Vs + kBK * DH;                    // [kBQ][kKS]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int r0 = (tid >> 4) * 4;                // the thread's first row
  const int q0 = blockIdx.x * kBQ;
  const int hq = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = hq / group;
  const float* qb = q + b * qsb + hq * qsh;
  const float* kb = k + b * ksb + hk * ksh;
  const float* vb = v + b * vsb + hk * vsh;

  for (int i = tid; i < kBQ * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    const int row = q0 + r;
    Qt[d * kQS + r] = row < Tq ? qb[row * qst + d] : 0.0f;
  }

  // keys [k_begin, k_end) hold every key visible to some row of the block
  const int q_last = min(q0 + kBQ, Tq) - 1;
  int k_end = Tk;
  if (causal) k_end = min(k_end, q_offset + q_last + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q_offset + q0 - window + 1);

  float acc[4][C::kPer];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < C::kPer; ++j) acc[i][j] = 0.0f;
  }

  for (int kt = (k_begin / kBK) * kBK; kt < k_end; kt += kBK) {
    __syncthreads();            // the last tile's P and V are read (and Qt
                                // is staged before the first tile)
    for (int i = tid; i < kBK * DH; i += kThreads) {
      const int c = i / DH, d = i % DH;
      const int key = kt + c;
      float kx = 0.0f, vx = 0.0f;
      if (key < Tk) {
        kx = kb[key * kst + d];
        vx = vb[key * vst + d];
      }
      Kt[d * kKS + c] = kx;
      Vs[c * DH + d] = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(&Qt[d * kQS + r0]);
      const float4 kv = *reinterpret_cast<const float4*>(&Kt[d * kKS + 4 * tx]);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_offset + q0 + r0 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = kt + 4 * tx + j;
        float x = s[i][j] * scale;
        if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
        bool ok = kpos < Tk;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        s[i][j] = ok ? x : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float m_use = m_new == -INFINITY ? 0.0f : m_new;
      const float corr = expf(m[i] - m_use);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_use);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < C::kPer; ++j) acc[i][j] *= corr;
      *reinterpret_cast<float4*>(&Ps[(r0 + i) * kKS + 4 * tx]) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    }
    __syncthreads();

    for (int c = 0; c < kBK; c += 4) {
      float pa[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 pv =
            *reinterpret_cast<const float4*>(&Ps[(r0 + i) * kKS + c]);
        pa[i][0] = pv.x;
        pa[i][1] = pv.y;
        pa[i][2] = pv.z;
        pa[i][3] = pv.w;
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float* vrow = Vs + (c + cc) * DH + tx * C::kVec;
        float vv[C::kPer];
#pragma unroll
        for (int g = 0; g < C::kRuns; ++g) {
          if constexpr (C::kVec == 4) {
            const float4 x = *reinterpret_cast<const float4*>(vrow + g * 64);
            vv[4 * g] = x.x;
            vv[4 * g + 1] = x.y;
            vv[4 * g + 2] = x.z;
            vv[4 * g + 3] = x.w;
          } else {
            const float2 x = *reinterpret_cast<const float2*>(vrow + g * 32);
            vv[2 * g] = x.x;
            vv[2 * g + 1] = x.y;
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < C::kPer; ++j)
            acc[i][j] = fmaf(pa[i][cc], vv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + r0 + i;
    if (row >= Tq) continue;
    float* orow =
        out + (((long long)b * Hq + hq) * Tq + row) * DH + tx * C::kVec;
#pragma unroll
    for (int j = 0; j < C::kPer; ++j) {
      const int col = (j / C::kVec) * 16 * C::kVec + j % C::kVec;
      orow[col] = l[i] > 0.0f ? acc[i][j] / l[i] : 0.0f;
    }
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, int B, int Hq,
           int group, int Tq, int Tk, const long long* st, float scale,
           int causal, int window, int q_offset, float softcap, void* out,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tq + kBQ - 1) / kBQ, Hq, B);
  flash_fwd<DH><<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, Hq, group, Tq, Tk, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale, causal, window,
      q_offset, softcap, (float*)out);
  return (int)cudaGetLastError();
}

int dispatch(int Dh, const void* q, const void* k, const void* v, int B,
             int Hq, int group, int Tq, int Tk, const long long* st,
             float scale, int causal, int window, int q_offset,
             float softcap, void* out, cudaStream_t stream) {
  switch (Dh) {
    case 32:
      return launch<32>(q, k, v, B, Hq, group, Tq, Tk, st, scale, causal,
                           window, q_offset, softcap, out, stream);
    case 64:
      return launch<64>(q, k, v, B, Hq, group, Tq, Tk, st, scale, causal,
                           window, q_offset, softcap, out, stream);
    case 128:
      return launch<128>(q, k, v, B, Hq, group, Tq, Tk, st, scale, causal,
                            window, q_offset, softcap, out, stream);
    case 256:
      return launch<256>(q, k, v, B, Hq, group, Tq, Tk, st, scale, causal,
                            window, q_offset, softcap, out, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// K10 for float32.  q (B, Hq, Tq, Dh), k and v (B, Hq / group, Tk, Dh), all
// float32, read through their (b, h, t) strides in elements, nine in all:
// q's, then k's, then v's.  Writes out, a dense (B, Hq, Tq, Dh) float32
// tensor.  Dh is 32, 64, 128 or 256; window <= 0 means none, softcap <= 0
// none.  Tq >= 1.
int flash_attention_fwd(const void* q, const void* k, const void* v, int B,
                        int Hq, int group, int Tq, int Tk, int Dh,
                        long long qsb, long long qsh, long long qst,
                        long long ksb, long long ksh, long long kst,
                        long long vsb, long long vsh, long long vst,
                        float scale, int causal, int window, int q_offset,
                        float softcap, void* out, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const long long st[9] = {qsb, qsh, qst, ksb, ksh, kst, vsb, vsh, vst};
  return dispatch(Dh, q, k, v, B, Hq, group, Tq, Tk, st, scale, causal,
                  window, q_offset, softcap, out, stream);
}

}  // extern "C"
