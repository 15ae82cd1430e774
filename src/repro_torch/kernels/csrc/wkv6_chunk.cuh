// Pieces shared by K12's chunked routes on the tensor cores, the forward
// (csrc/wkv6.cu) and the backward (csrc/wkv6_bwd.cu): cp.async, the two
// mma.sync forms, a reduce-scatter over lanes, and a chunk's intra-chunk
// matrix A:
//
//     A[t][s] = sum_i r_ti k_si prod_{s<j<t} w_ji   (s < t)
//     A[t][t] = sum_i r_ti u_i k_ti,   A[t][s] = 0   (s > t)
//
// built in float32 by running products, never by dividing by a w.

#pragma once

#include <cuda_bf16.h>

namespace wkv6_chunk {

constexpr int kL = 16;        // steps a chunk
constexpr int kHead = 64;     // K = V = 64, the only head size the models use
constexpr int kALd = 24;      // A's padded row stride (floats)

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// d += a * b, m16n8k16, bf16 operands, float32 accumulators.
__device__ __forceinline__ void mma16816(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b, m16n8k8, TF32 operands, float32 accumulators.
__device__ __forceinline__ void mma1688(float (&d)[4], const unsigned (&a)[4],
                                        unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One round of a reduce-scatter over the lanes that differ in bit M: the
// lane with that bit clear keeps the sums of part[0 .. HALF), the other
// those of part[HALF .. 2 HALF), both moved to part[0 .. HALF).
template <int HALF, int M>
__device__ __forceinline__ void reduce_scatter_half(float* part, int lane) {
  const bool upper = (lane & M) != 0;
#pragma unroll
  for (int j = 0; j < HALF; ++j) {
    const float send = upper ? part[j] : part[j + HALF];
    const float keep = upper ? part[j + HALF] : part[j];
    part[j] = keep + __shfl_xor_sync(0xFFFFFFFFu, send, M);
  }
}

// A of the chunk staged in r, k (bf16 rows of LD elements, 8-byte aligned)
// and w (float32; a ragged tail's zero-filled w only reaches rows whose r
// is 0) into a (t, s), by a block of 256 threads.
template <int LD>
__device__ __forceinline__ void chunk_a(const __nv_bfloat16 (*r)[LD],
                                        const __nv_bfloat16 (*k)[LD],
                                        const float (*w)[kHead], const float* u,
                                        float (*a)[kALd], int tid) {
  const int warp = tid >> 5, lane = tid & 31;
  // A: thread (s, channels 4*ig .. 4*ig+3) carries k_s decayed to step t
  // (mk) and forms its 4-channel part of A[t][s] for every t; warp w holds
  // s = 2w, 2w + 1, so its t starts at 2w.  The parts are summed over the
  // 16 lanes of an s by a reduce-scatter (15 shuffles), after which lane
  // ig holds A[ig][s].
  const int s = tid >> 4, ig = tid & 15;
  float ks[4], uk[4], mk[4], part[kL];
  {
    const uint2 kraw = *reinterpret_cast<const uint2*>(&k[s][4 * ig]);
    const __nv_bfloat162* kp = reinterpret_cast<const __nv_bfloat162*>(&kraw);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float2 f = __bfloat1622float2(kp[e]);
      ks[2 * e] = f.x;
      ks[2 * e + 1] = f.y;
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    uk[e] = u[4 * ig + e] * ks[e];
    mk[e] = 0.0f;
  }
#pragma unroll
  for (int t = 0; t < kL; ++t) {
    part[t] = 0.0f;
    if (t >= 2 * warp) {          // the same for the warp
      float rr[4];
      const uint2 rraw = *reinterpret_cast<const uint2*>(&r[t][4 * ig]);
      const __nv_bfloat162* rp = reinterpret_cast<const __nv_bfloat162*>(&rraw);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float2 f = __bfloat1622float2(rp[e]);
        rr[2 * e] = f.x;
        rr[2 * e + 1] = f.y;
      }
      const float4 w4 = *reinterpret_cast<const float4*>(&w[t][4 * ig]);
      const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
      float acc = 0.0f;
      if (t < 2 * warp + 2) {     // t meets the warp's own s: the diagonal
        const bool diag = t == s;
#pragma unroll
        for (int e = 0; e < 4; ++e) acc = fmaf(rr[e], diag ? uk[e] : mk[e], acc);
        // k_s enters at t = s; w_t decays it for t + 1 (a ragged tail's
        // zero-filled w only reaches rows whose r is 0)
#pragma unroll
        for (int e = 0; e < 4; ++e) mk[e] = diag ? ks[e] : mk[e] * wv[e];
      } else {                    // t > s for every lane of the warp
#pragma unroll
        for (int e = 0; e < 4; ++e) acc = fmaf(rr[e], mk[e], acc);
#pragma unroll
        for (int e = 0; e < 4; ++e) mk[e] *= wv[e];
      }
      part[t] = acc;
    }
  }
  reduce_scatter_half<8, 8>(part, lane);
  reduce_scatter_half<4, 4>(part, lane);
  reduce_scatter_half<2, 2>(part, lane);
  reduce_scatter_half<1, 1>(part, lane);
  a[ig][s] = part[0];
}

}  // namespace wkv6_chunk
