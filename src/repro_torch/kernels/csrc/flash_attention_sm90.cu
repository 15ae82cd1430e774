// Forward flash attention (K10) for bf16 inputs on Hopper (sm_90a):
// wgmma on bf16 tiles fed by TMA, warp-specialised.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention (_flash_kernel) for bfloat16 q, k, v: online-softmax
// attention with GQA, a causal mask, a sliding window, a query offset and a
// logit softcap,
//
//     s_ij = softcap * tanh((q_i . k_j) * scale / softcap)    (softcap set)
//     visible(i, j) = j < Tk  and  j <= q_offset + i           (causal)
//                             and  j >  q_offset + i - window  (window)
//     o_i = sum_j softmax_j(s_ij over visible j) v_j,  0 if no j is visible
//
// Query head h reads KV head h / group.  float32 inputs take the SIMT
// kernel in flash_attention.cu instead: bf16 or TF32 tensor-core operands
// would round q, k and P to 8 or 10 mantissa bits and could not hold the
// float32 tolerance (2e-5) against the plain version.
//
// Bound on an H100 SXM: 4 * Dh operations per visible (q, k) pair (QK^T and
// PV, a multiply and an add each) on the bf16 tensor cores, 989.4 TFLOP/s;
// at the served gemma2-9b shape (4, 16, 4608, 256) with 8 KV heads, causal,
// that is 695.9 GFLOP, 0.70 ms, against 0.14 ms for the bytes.
//
// Design (numbers for every Dh unless named):
//
//   * Work unit.  One block of 384 threads per (b, hq, tile of 128
//     queries): warpgroups 0 and 1 are consumers, each owning 64 query
//     rows; warpgroup 2 is the producer, one thread of which issues every
//     TMA copy.  The grid is 1-D with the query tile as its slowest index,
//     walked from the last tile down, so under a causal mask the tiles with
//     the most visible key tiles (T/64 for the last, one for the first) are
//     dispatched first and the short ones fill the tail.
//   * Staging.  TMA (cp.async.bulk.tensor.4d) over 4-D tensor maps
//     (Dh, T, H, B) with the caller's strides, so _split_heads views are
//     read in place.  Q is loaded once (128 x Dh); K and V tiles of kBN
//     keys (128 at Dh <= 128, 64 at Dh 256) go through a ring of kStages
//     stages (4 at Dh 32 and 64, 3 at 128, 2 at 256).  Each
//     stage has four mbarriers: K landed and V landed (transaction bytes),
//     K free and V free (the 8 consumer warps arrive): K is freed as soon as
//     S is computed, V only after P V, so the producer refills K early.
//     Tiles are stored as Dh/64 column chunks of 128-byte rows with the
//     128-byte swizzle (at Dh 32: one chunk of 64-byte rows, 64-byte
//     swizzle), the layout the wgmma descriptors name.  Out-of-range rows
//     come in as zeros; keys at or past Tk are masked explicitly (a zero key
//     would give logit 0, not -inf).
//   * S = Q K^T.  wgmma.mma_async m64n{kBN}k16, bf16 x bf16 -> f32, both
//     operands from shared memory, both K-major: Dh/16 instructions a tile;
//     the first overwrites S (scale-d 0), so S is never zeroed.
//   * Online softmax in registers, in the Pallas kernel's order
//     (flash_attention.py:66-74): scale, softcap (tanhf, not tanh.approx),
//     mask, m_new, p = exp(s - m_new), the correction; the row max is taken
//     before the (positive) scale, log2(e) is folded into it, and p is one
//     FFMA and ex2.approx.  A row lives on the 4 lanes of
//     a quad in the accumulator layout: its max and sum are two
//     __shfl_xor_sync steps (the sum only once, at the end).  Masked logits
//     are -inf; a row that has seen no visible key uses 0 as its max in
//     exp, so p and the correction are 0; a row with no visible key at all
//     is written as 0 (the oracle's convention).  The mask is evaluated only
//     on tiles that cross the diagonal, the window's edge or the ragged end
//     of Tk, as two integer compares against each row's visible interval;
//     tiles wholly masked for a warpgroup are skipped by it (it still waits
//     for them and frees them, to stay in step with the ring).  The softcap
//     and the mask are compile-time choices of four straight-line bodies,
//     picked once a tile: as runtime tests inside the unrolled loop they
//     became per-element branches and doubled the kernel's time.
//   * O += P V.  P is packed to bf16 in registers and is wgmma's A operand
//     (the RS form: the S accumulator layout is the A fragment after
//     packing pairs); V is the B operand from shared memory, MN-major (the
//     transpose bit).  One m64n{Dh}k16 instruction per 16 keys.  O is
//     64 x Dh float32 per warpgroup, Dh/2 registers a thread; its rescale
//     by the correction is skipped where neither of a lane's two rows
//     moved its max.
//   * Pipeline.  A warpgroup issues tile i's S together with tile i-1's
//     P V and runs tile i's softmax while that P V is on the tensor cores;
//     only the rescale of O waits for it.  The first tile is peeled and the
//     last P V drained after the loop, so no wgmma sits under a branch
//     ptxas cannot prove uniform (it serialises them: warning C7520).
//   * Registers.  __launch_bounds__(384, 1) gives 168 a thread; setmaxnreg
//     moves the producer to 24 and the consumers to 240 (128 * 24 + 256 *
//     240 = 64512 of 65536): at Dh 256, O (128), S (32) and P (16) fit; at
//     Dh 128, O (64), S (64) and P (32); no spills.
//   * Shared memory.  Q 128 * Dh * 2 B, K and V kBN * Dh * 2 B a stage
//     each: at Dh 256, 64 KB + 2 * 64 KB = 192 KB (plus 1 KB of alignment
//     and the barriers), at Dh 128, 32 + 3 * 64 = 224 KB; one block an SM
//     (registers bound it too: 384 threads at 168).
//   * Epilogue.  O / l, rounded to bf16, plain 4-byte stores with a bounds
//     check on ragged Tq, into a dense (B, Hq, Tq, Dh) output.
//
// What this does about the limits of the SIMT kernel it replaces for bf16
// (PERF.md section 6): the products run on the tensor cores (wgmma) and not
// the float32 FMA pipes; operands stay bf16 in shared memory, half the bytes
// (Dh 256: 192 KB, Q included, against 222 KB for 64 query rows); staging is
// asynchronous (TMA, a 2- to 4-stage ring, a producer warp) and overlaps the
// consumers' products, which synchronise on mbarriers, not block barriers.
// What bounds it now (PERF.md section 6): the softmax's SIMT work that the
// pipeline does not hide (tanhf above all), and at Dh 256 S's SS wgmma at
// n = 64, which reads 4 KB of shared memory for every 32 clocks of tensor
// work (wider key tiles do not fit beside a 64 KB Q).  Ping-pong turns of
// the two warpgroups at the tensor cores (named barriers) were tried and
// measured no faster on an H100, so they are not here.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>

#include <climits>
#include <type_traits>

namespace {

constexpr int kBM = 128;          // queries a block (two warpgroups of 64)
constexpr int kThreads = 384;     // consumers: warpgroups 0, 1; producer: 2
constexpr float kLog2e = 1.4426950408889634f;

template <int DH>
struct Cfg {
  static constexpr int kBN = DH <= 128 ? 128 : 64;        // keys a tile
  static constexpr int kSw = DH * 2 < 128 ? DH * 2 : 128;  // row pitch, B
  static constexpr int kChunk = kSw / 2;        // elements a chunk row
  static constexpr int kChunks = DH / kChunk;
  static constexpr int kStages = DH == 32 || DH == 64 ? 4 : DH == 128 ? 3 : 2;
  static constexpr uint32_t kQBytes = kBM * DH * 2;
  static constexpr uint32_t kKVBytes = kBN * DH * 2;
  static constexpr int kLayout = kSw == 128 ? 1 : 2;  // desc: B128 or B64
  static constexpr uint32_t kBarBytes = 8 * (1 + 4 * kStages);
  static constexpr size_t kSmem =
      1024 + kQBytes + 2 * kStages * kKVBytes + kBarBytes;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Returns once the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), layout type (1: 128-byte swizzle, 2: 64).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Tells the compiler that wgmma may have changed these registers, so no
// read of them moves above the wait or write below the issue.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D (m64 x n64, f32) += A (m64 x k16, bf16, smem) * B (k16 x n64, bf16,
// smem), both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// D (m64 x n64, f32) = A (m64 x k16, bf16, smem) * B (k16 x n64, bf16,
// smem), both K-major: a first k-step, which overwrites D (scale-d 0), so
// D needs no zeroing.
__device__ __forceinline__ void wgmma_ss_n64_first(float (&d)[32],
                                                    uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "l"(da), "l"(db));
}

// D (m64 x n128, f32) += A (m64 x k16, bf16, smem) * B (k16 x n128, bf16,
// smem), both K-major.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// D (m64 x n128, f32) = A (m64 x k16, bf16, smem) * B (k16 x n128, bf16,
// smem), both K-major: a first k-step, which overwrites D (scale-d 0), so
// D needs no zeroing.
__device__ __forceinline__ void wgmma_ss_n128_first(float (&d)[64],
                                                    uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]),
        "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]),
        "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]),
        "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]),
        "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "l"(da), "l"(db));
}


// D (m64 x n32, f32) += A (m64 x k16, bf16, registers) * B (k16 x n32,
// bf16, smem, MN-major).
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (m64 x n64, f32) += A (m64 x k16, bf16, registers) * B (k16 x n64,
// bf16, smem, MN-major).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (m64 x n128, f32) += A (m64 x k16, bf16, registers) * B (k16 x n128,
// bf16, smem, MN-major).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (m64 x n256, f32) += A (m64 x k16, bf16, registers) * B (k16 x n256,
// bf16, smem, MN-major).
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int DH>
__device__ __forceinline__ void wgmma_rs(float (&d)[DH / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (DH == 32) wgmma_rs_n32(d, a, db);
  if constexpr (DH == 64) wgmma_rs_n64(d, a, db);
  if constexpr (DH == 128) wgmma_rs_n128(d, a, db);
  if constexpr (DH == 256) wgmma_rs_n256(d, a, db);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Key tiles [lo, hi) of kBN keys holding a key visible to some of the
// query rows [r0, r0 + 64) below Tq; lo == hi when there is none.  The plain
// function repro_torch.kernels.flash_attention.key_tile_range is this one.
template <int kBN>
__device__ __forceinline__ void key_tile_range(int r0, int Tq, int Tk,
                                               int causal, int window,
                                               int q_offset, int& lo,
                                               int& hi) {
  lo = hi = 0;
  if (r0 >= Tq) return;
  const int r1 = min(r0 + 63, Tq - 1);
  int kend = Tk;
  if (causal) kend = min(kend, q_offset + r1 + 1);
  int kbeg = 0;
  if (window > 0) kbeg = max(0, q_offset + r0 - window + 1);
  if (kend <= kbeg) return;
  lo = kbeg / kBN;
  hi = (int)(((long long)kend + kBN - 1) / kBN);
}

// grid: n_qtiles * B * Hq blocks, the query tile slowest and walked from the
// last; block: 384 threads.  out is a dense (B, Hq, Tq, DH) bf16 tensor.
// window <= 0: no window; softcap <= 0: no softcap.
template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_sm90(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap, int B, int Hq,
                   int group, int Tq, int Tk, int n_qtiles, float scale,
                   int causal, int window, int q_offset, float softcap,
                   __nv_bfloat16* __restrict__ out) {
  using C = Cfg<DH>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base;
  const uint32_t sk = sq + C::kQBytes;
  const uint32_t sv = sk + C::kStages * C::kKVBytes;
  const uint32_t q_full = sv + C::kStages * C::kKVBytes;
  // one barrier each a stage, 8 bytes apart: K landed, V landed, K free, V
  // free
  const uint32_t k_full = q_full + 8;
  const uint32_t v_full = k_full + 8 * C::kStages;
  const uint32_t k_free = v_full + 8 * C::kStages;
  const uint32_t v_free = k_free + 8 * C::kStages;

  const int bh = blockIdx.x % (B * Hq);
  const int q0 = (n_qtiles - 1 - blockIdx.x / (B * Hq)) * kBM;
  const int b = bh / Hq;
  const int hq = bh % Hq;

  int lo0, hi0, lo1, hi1;
  constexpr int kBN = C::kBN;
  key_tile_range<kBN>(q0, Tq, Tk, causal, window, q_offset, lo0, hi0);
  key_tile_range<kBN>(q0 + 64, Tq, Tk, causal, window, q_offset, lo1, hi1);
  int t_begin = 0, t_end = 0;
  if (hi0 > lo0 && hi1 > lo1) {
    t_begin = min(lo0, lo1);
    t_end = max(hi0, hi1);
  } else if (hi0 > lo0) {
    t_begin = lo0;
    t_end = hi0;
  } else if (hi1 > lo1) {
    t_begin = lo1;
    t_end = hi1;
  }
  const int n_tiles = t_end - t_begin;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_free + 8 * s, 8);   // lane 0 of each consumer warp
      mbar_init(v_free + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread issues every copy ------------------------ //
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) {
      const int hk = hq / group;
      mbar_expect_tx(q_full, C::kQBytes);
      for (int c = 0; c < C::kChunks; ++c)
        tma_load(sq + c * kBM * C::kSw, &qmap, q_full, c * C::kChunk, q0, hq,
                 b);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % C::kStages;
        const uint32_t free_ph = ((it / C::kStages) & 1) ^ 1;
        const int kt = (t_begin + it) * kBN;
        const uint32_t ks = sk + st * C::kKVBytes;
        const uint32_t vs = sv + st * C::kKVBytes;
        mbar_wait(k_free + 8 * st, free_ph);
        mbar_expect_tx(k_full + 8 * st, C::kKVBytes);
        for (int c = 0; c < C::kChunks; ++c)
          tma_load(ks + c * kBN * C::kSw, &kmap, k_full + 8 * st,
                   c * C::kChunk, kt, hk, b);
        mbar_wait(v_free + 8 * st, free_ph);
        mbar_expect_tx(v_full + 8 * st, C::kKVBytes);
        for (int c = 0; c < C::kChunks; ++c)
          tma_load(vs + c * kBN * C::kSw, &vmap, v_full + 8 * st,
                   c * C::kChunk, kt, hk, b);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows q0 + 64 wg + [0, 64) --- //
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int t = threadIdx.x % 128;
    const int warp = t / 32;
    const int lane = t % 32;
    const int my_lo = wg == 0 ? lo0 : lo1;
    const int my_hi = wg == 0 ? hi0 : hi1;
    const int r0 = q0 + 64 * wg;                 // the warpgroup's first row
    const int r_last = min(r0 + 63, Tq - 1);
    const int row = r0 + 16 * warp + lane / 4;   // and row + 8
    // each row's visible keys are (lo_key, hi_key]; rows at or past Tq are
    // clamped to the last row (they are never stored)
    int lo_key[2], hi_key[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int pos = q_offset + min(row + 8 * i, Tq - 1);
      hi_key[i] = causal ? min(Tk - 1, pos) : Tk - 1;
      lo_key[i] = window > 0 ? pos - window : INT_MIN;
    }
    const bool softcapped = softcap > 0.0f;
    const float s_log2 = scale * kLog2e;
    const float inv_cap = softcapped ? 1.0f / softcap : 0.0f;
    const float cap_log2 = softcap * kLog2e;

    float o[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] = 0.0f;
    float m[2] = {-INFINITY, -INFINITY};   // running max, log2 units
    float l[2] = {0.0f, 0.0f};             // this lane's share of the sum

    const uint32_t q_desc_base = sq + 64 * wg * C::kSw;
    // Tiles [first, last) of the block's are this warpgroup's; it waits for
    // the others and frees them, to stay in step with the ring.
    const int first = my_hi > my_lo ? my_lo - t_begin : 0;
    const int last = my_hi > my_lo ? my_hi - t_begin : 0;
    auto pass = [&](int it) {
      const int st = it % C::kStages;
      const uint32_t ph = (it / C::kStages) & 1;
      mbar_wait(k_full + 8 * st, ph);
      mbar_wait(v_full + 8 * st, ph);
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(k_free + 8 * st);
        mbar_arrive(v_free + 8 * st);
      }
    };
    for (int it = 0; it < first; ++it) pass(it);

    // Software pipeline: tile it's S = Q K^T is issued together with the
    // previous tile's O += P V, and its softmax runs while that PV is on the
    // tensor cores; only the rescale of O waits for it.  The first tile is
    // peeled and the last PV drained after the loop, so no wgmma sits under
    // a branch that ptxas cannot prove uniform (it would serialise them).
    uint32_t pa[kBN / 16][4];       // P of the previous tile, bf16 pairs
    float s[kBN / 2];

    // S = Q K^T of the tile at ring slot st (issued, not waited for)
    auto issue_s = [&](int st) {
      const uint32_t ks = sk + st * C::kKVBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const uint32_t chunk = kk * 16 / C::kChunk;   // Dh column chunk
        const uint32_t off = (kk * 16 % C::kChunk) * 2; // bytes into it
        const uint64_t da = make_desc(q_desc_base + chunk * kBM * C::kSw + off,
                                      16, 8 * C::kSw, C::kLayout);
        const uint64_t db = make_desc(ks + chunk * kBN * C::kSw + off, 16,
                                      8 * C::kSw, C::kLayout);
        if constexpr (kBN == 64) {
          if (kk == 0)
            wgmma_ss_n64_first(s, da, db);
          else
            wgmma_ss_n64(s, da, db);
        } else {
          if (kk == 0)
            wgmma_ss_n128_first(s, da, db);
          else
            wgmma_ss_n128(s, da, db);
        }
      }
      wgmma_commit();
    };
    // O += P V with the V at ring slot st (issued, not waited for)
    auto issue_pv = [&](int st) {
      const uint32_t vs = sv + st * C::kKVBytes;
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
        const uint64_t db = make_desc(vs + kk * 16 * C::kSw, kBN * C::kSw,
                                      8 * C::kSw, C::kLayout);
        wgmma_rs<DH>(o, pa[kk], db);
      }
      wgmma_commit();
    };
    // scale, softcap, mask, then the online-softmax update of m and l;
    // s[4j + 2i + e] is row (row + 8i), key kt + 8j + 2 (lane % 4) + e.
    // Leaves p in s and returns the corrections in corr.  kCap and kMask
    // are compile-time, so each of the four bodies is straight-line code;
    // a visible key is one in (lo_key[i], hi_key[i]].
    auto softmax = [&](int tile, float (&corr)[2], auto cap_tag,
                       auto mask_tag) {
      constexpr bool kCap = decltype(cap_tag)::value;
      constexpr bool kMask = decltype(mask_tag)::value;
      // x: the raw logit, or tanh(logit * scale / softcap); the logit in
      // log2 units is x * k, and k > 0, so the row max is taken on x
      const float k = kCap ? cap_log2 : s_log2;
      const int key0 = tile * kBN + 2 * (lane & 3);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float x = s[4 * j + 2 * i + e];
            if constexpr (kCap) x = tanhf((x * scale) * inv_cap);
            if constexpr (kMask) {
              const int key = key0 + 8 * j + e;
              x = (key <= hi_key[i] && key > lo_key[i]) ? x : -INFINITY;
            }
            s[4 * j + 2 * i + e] = x;
            mx[i] = fmaxf(mx[i], x);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i] * k);
        const float m_use = m_new == -INFINITY ? 0.0f : m_new;
        corr[i] = ex2(m[i] - m_use);
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = ex2(fmaf(s[4 * j + 2 * i + e], k, -m_use));
            s[4 * j + 2 * i + e] = p;
            sum += p;
          }
        }
        l[i] = l[i] * corr[i] + sum;
        m[i] = m_new;
      }
    };
    // The mask is needed only on tiles that cross the diagonal, the
    // window's edge or the ragged end of Tk.
    auto softmax_tile = [&](int tile, float (&corr)[2]) {
      using Y = std::true_type;
      using N = std::false_type;
      const int kt = tile * kBN;
      const bool need_mask =
          kt > Tk - kBN || (causal && kt > q_offset + r0 - kBN + 1) ||
          (window > 0 && kt <= q_offset + r_last - window);
      if (softcapped) {
        if (need_mask) softmax(tile, corr, Y{}, Y{});
        else softmax(tile, corr, Y{}, N{});
      } else {
        if (need_mask) softmax(tile, corr, N{}, Y{});
        else softmax(tile, corr, N{}, N{});
      }
    };
    // O *= corr (skipped where neither of the lane's rows moved its max,
    // as after the first few tiles it mostly does not), then P (in s)
    // packed to bf16 pairs: the m64n64
    // accumulator layout is wgmma's A fragment, key pairs adjacent.
    auto rescale_pack = [&](const float (&corr)[2]) {
      if (corr[0] != 1.0f || corr[1] != 1.0f) {   // a row's max moved
#pragma unroll
        for (int j = 0; j < DH / 8; ++j) {
          o[4 * j + 0] *= corr[0];
          o[4 * j + 1] *= corr[0];
          o[4 * j + 2] *= corr[1];
          o[4 * j + 3] *= corr[1];
        }
      }
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
    };
    auto free_slot = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };

    mbar_wait(q_full, 0);
    if (first < last) {
      {                                   // the first tile: S alone
        const int st = first % C::kStages;
        mbar_wait(k_full + 8 * st, (first / C::kStages) & 1);
        issue_s(st);
        wgmma_wait<0>();
        fence_regs(s);
        free_slot(k_free + 8 * st);
        float corr[2];
        softmax_tile(t_begin + first, corr);
        rescale_pack(corr);
      }
      for (int it = first + 1; it < last; ++it) {
        const int st = it % C::kStages;
        const int pst = (it - 1) % C::kStages;   // the previous tile's slot
        mbar_wait(k_full + 8 * st, (it / C::kStages) & 1);
        mbar_wait(v_full + 8 * pst, ((it - 1) / C::kStages) & 1);
        issue_s(st);
        issue_pv(pst);
        wgmma_wait<1>();                  // S is done; PV may still run
        fence_regs(s);
        free_slot(k_free + 8 * st);
        float corr[2];
        softmax_tile(t_begin + it, corr);
        wgmma_wait<0>();                  // the previous PV: done
        fence_regs(o);
        free_slot(v_free + 8 * pst);
        rescale_pack(corr);
      }
      {                                   // the last tile's PV
        const int pst = (last - 1) % C::kStages;
        mbar_wait(v_full + 8 * pst, ((last - 1) / C::kStages) & 1);
        fence_regs(o);
        wgmma_fence();
        issue_pv(pst);
        wgmma_wait<0>();
        fence_regs(o);
        free_slot(v_free + 8 * pst);
      }
    }
    for (int it = last; it < n_tiles; ++it) pass(it);

    // ---- epilogue: O / l at bf16 ---------------------------------------- //
    float inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float tot = l[i];
      tot += __shfl_xor_sync(0xffffffffu, tot, 1);
      tot += __shfl_xor_sync(0xffffffffu, tot, 2);
      inv[i] = tot > 0.0f ? 1.0f / tot : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row + 8 * i;
      if (r >= Tq) continue;
      __nv_bfloat16* orow =
          out + (((long long)b * Hq + hq) * Tq + r) * DH + 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < DH / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j) =
            pack_bf16(o[4 * j + 2 * i] * inv[i], o[4 * j + 2 * i + 1] * inv[i]);
    }
  }
}

// cuTensorMapEncodeTiled, fetched from the driver once.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

constexpr int kErrEntryPoint = 100000;   // the driver lacks the function
constexpr int kErrEncode = 100001;       // + CUresult: encoding refused
constexpr int kErrGrid = 200000;         // grid larger than 2^31 - 1 blocks

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult got;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &got);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &got);
#endif
    if (err != cudaSuccess || got != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map over (Dh, T, H, B) of bf16 with byte strides (st, sh, sb) for
// the T, H and B axes; boxes of (chunk, rows, 1, 1).
int make_map(CUtensorMap* map, const void* ptr, int dh, long long T,
             long long H, long long Bn, long long st, long long sh,
             long long sb, int chunk, int rows, int swizzle_bytes) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kErrEntryPoint;
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)T, (cuuint64_t)H,
                              (cuuint64_t)Bn};
  const cuuint64_t strides[3] = {(cuuint64_t)st, (cuuint64_t)sh,
                                 (cuuint64_t)sb};
  const cuuint32_t box[4] = {(cuuint32_t)chunk, (cuuint32_t)rows, 1, 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                  const_cast<void*>(ptr), dims, strides, box, estride,
                  CU_TENSOR_MAP_INTERLEAVE_NONE,
                  swizzle_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                       : CU_TENSOR_MAP_SWIZZLE_64B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode + (int)r;
}

template <int DH>
int launch(const void* q, const void* k, const void* v, int B, int Hq,
           int group, int Tq, int Tk, const long long* st, float scale,
           int causal, int window, int q_offset, float softcap, void* out,
           cudaStream_t stream) {
  using C = Cfg<DH>;
  CUtensorMap qmap, kmap, vmap;
  const int tk_dim = Tk > 0 ? Tk : 1;   // Tk = 0: no key tile is loaded
  int err = make_map(&qmap, q, DH, Tq, Hq, B, st[2], st[1], st[0], C::kChunk,
                     kBM, C::kSw);
  if (err == 0)
    err = make_map(&kmap, k, DH, tk_dim, Hq / group, B, st[5], st[4], st[3],
                   C::kChunk, C::kBN, C::kSw);
  if (err == 0)
    err = make_map(&vmap, v, DH, tk_dim, Hq / group, B, st[8], st[7], st[6],
                   C::kChunk, C::kBN, C::kSw);
  if (err != 0) return err;
  const int n_qtiles = (Tq + kBM - 1) / kBM;
  const long long blocks = (long long)n_qtiles * B * Hq;
  if (blocks > 2147483647LL) return kErrGrid;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_sm90<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::kSmem);
  if (e != cudaSuccess) return (int)e;
  flash_fwd_sm90<DH><<<(unsigned)blocks, kThreads, C::kSmem, stream>>>(
      qmap, kmap, vmap, B, Hq, group, Tq, Tk, n_qtiles, scale, causal, window,
      q_offset, softcap, (__nv_bfloat16*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* flash_attention_sm90_error_string(int code) {
  static thread_local char buf[96];
  if (code == kErrEntryPoint) return "cuTensorMapEncodeTiled not found";
  if (code == kErrGrid) return "grid above 2^31 - 1 blocks";
  if (code >= kErrEncode && code < kErrGrid) {
    snprintf(buf, sizeof buf, "cuTensorMapEncodeTiled failed (CUresult %d)",
             code - kErrEncode);
    return buf;
  }
  return cudaGetErrorString((cudaError_t)code);
}

// Dynamic shared memory a block of the Dh kernel takes, in bytes (0 for an
// unknown Dh).
long long flash_attention_sm90_smem_bytes(int Dh) {
  switch (Dh) {
    case 32: return (long long)Cfg<32>::kSmem;
    case 64: return (long long)Cfg<64>::kSmem;
    case 128: return (long long)Cfg<128>::kSmem;
    case 256: return (long long)Cfg<256>::kSmem;
    default: return 0;
  }
}

// K10 for bf16.  q (B, Hq, Tq, Dh), k and v (B, Hq / group, Tk, Dh), all
// bfloat16, read through their (b, h, t) strides in bytes, nine in all:
// q's, then k's, then v's; each a multiple of 16, and q, k, v 16-byte
// aligned (the caller checks both).  Writes out, a dense (B, Hq, Tq, Dh)
// bf16 tensor.  Dh is 32, 64, 128 or 256; window <= 0 means none, softcap
// <= 0 none.  Tq >= 1.
int flash_attention_bf16_fwd(const void* q, const void* k, const void* v,
                             int B, int Hq, int group, int Tq, int Tk, int Dh,
                             long long qsb, long long qsh, long long qst,
                             long long ksb, long long ksh, long long kst,
                             long long vsb, long long vsh, long long vst,
                             float scale, int causal, int window,
                             int q_offset, float softcap, void* out,
                             void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const long long st[9] = {qsb, qsh, qst, ksb, ksh, kst, vsb, vsh, vst};
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

}  // extern "C"
