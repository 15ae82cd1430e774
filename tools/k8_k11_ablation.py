#!/usr/bin/env python3
"""What the redesigns of K8 (code pack) and K11 (RG-LRU scan) are worth on
the card: each beside the kernel it replaced and beside the other designs
that were candidates, with one choice changed at a time.

    python3 tools/k8_k11_ablation.py [--parent DIR] [--recheck N]

Needs one CUDA card and ``nvcc``.  ``--parent`` is the root of another
checkout (the parent commit unpacked with ``git archive``, say); its
``pack_codes.cu`` (K8 as ``pack_planes``, one group of 32 a warp, a ballot
a plane, the group index split by a 64-bit division), ``qr_pack.cu`` (K7
before its pack moved into ``bitplane.cuh``) and ``rglru_scan.cu`` (K11
as one thread a channel in 256-thread blocks, 8-step unroll) are built and
timed in turns with this checkout's.  Without it only this checkout's
variants run.  Builds into ``src/repro_torch/kernels/_build/ablation/``:

* K8: ``as built`` (1024-code tiles on a 2-D grid, 16-byte loads, the
  register pack of ``csrc/bitplane.cuh``, four byte slices) and ``4-byte
  loads``; the parent's; at (5, 50176) and (4, 2^24), b = 9.
* K7: this checkout's keyed and reading-u entries against the parent's, at
  (4, 2^24), r = 8 (one pack, moved into the shared header: the same
  instructions expected).
* K11, candidate (a), registers, as built in ``csrc/rglru_scan.cu``:
  two-warp blocks, each lane one channel (32 steps a batch) or, past 12
  warps an SM, a channel pair (8 steps), the next batch's loads in flight
  while the current one runs, streaming loads and stores; ``as built``;
  one instance forced at every shape (a channel a lane at U = 32 and 16,
  channel pairs at U = 8 and 16); one- and eight-warp blocks; plain
  stores; ``__ldg`` loads.
* K11, candidate (b), shared memory: a ring of (bt x 32 or 64 channels)
  tiles of x and a, staged by TMA (2-D tensor maps over the (B*T, D) view)
  by one producer thread under mbarriers, one consumer warp a 32-channel
  slab running the recurrence out of shared memory and storing y as
  coalesced rows, streaming (``RING_SOURCE`` below; D % 4 == 0 only); ring
  depths 4 and 8 tiles of 16 steps, 32- and 64-channel blocks.
* K11's parent (its first design); all at (8, 2560, 2560) and (32, 4096,
  2560).  Every variant of K8, K7 and K11 is held bit-equal to its plain
  version first.
* recurrentgemma-2b's prefill at full width and depth (bf16, batch 8,
  prompt 2560, seeded weights), with the parent's K11 and with this
  checkout's, in turns (parent, this, this, parent, three prefills each;
  18 K11 launches a prefill; the logits must be equal).

``--recheck N`` runs only the first check, K8 at (5, 50176), b = 9,
against ``ref.pack_codes``, on N fresh ``torch.randint`` code arrays (the
first the seed-0 draw the full run starts with) with the main build's
library alone, then N more with each K8 variant once every library of the
ablation has loaded; it prints each mismatch (positions, words, whether a
second call agrees) and the counts, and exits non-zero on any mismatch.

Times each kernel with CUDA events, in turns (each variant twice, in order
and then in reverse; the minimum is printed), and by its device time and
device events a call under ``torch.profiler`` (the fullest of three
windows: the profiler can drop a record, never add one).  Prints each
variant's registers and spills (``-Xptxas -v``) and the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

K8_HOOKS = [
    ("  if (n % 4 == 0 && ((uintptr_t)codes & 15) == 0)\n    pack_tiles<true>",
     "  if (!ABL_NARROW && n % 4 == 0 && ((uintptr_t)codes & 15) == 0)\n"
     "    pack_tiles<true>", "ABL_NARROW", 0),
]
K8_VARIANTS = {"as built": [], "4-byte loads": ["-DABL_NARROW=1"]}
K11_HOOKS = [
    ("constexpr int kWarps = 2;", "constexpr int kWarps = ABL_WARPS;",
     "ABL_WARPS", 2),
    ("  if (pairs && warps > (long long)kSms * kFewWarpsPerSm)",
     "  if (ABL_PICK ? ABL_PICK == 2 : pairs && warps > (long long)kSms * "
     "kFewWarpsPerSm)", "ABL_PICK", 0),
    ("return launch<2, 8>(", "return launch<2, ABL_U2>(", "ABL_U2", 8),
    ("return launch<1, 32>(", "return launch<1, ABL_U1>(", "ABL_U1", 32),
    ("    v[0] = __ldcs(p);", "    v[0] = ABL_LD ? __ldg(p) : __ldcs(p);",
     "ABL_LD", 0),
    ("    const float2 t = __ldcs(reinterpret_cast<const float2*>(p));",
     "    const float2 t = ABL_LD ? __ldg(reinterpret_cast<const float2*>(p))"
     "\n                            : __ldcs(reinterpret_cast<const float2*>"
     "(p));", "", 0),
    ("    __stcs(p, v[0]);",
     "    if (ABL_PLAIN_ST) *p = v[0]; else __stcs(p, v[0]);",
     "ABL_PLAIN_ST", 0),
    ("    __stcs(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));",
     "    if (ABL_PLAIN_ST) *reinterpret_cast<float2*>(p) = make_float2(v[0], "
     "v[1]);\n    else __stcs(reinterpret_cast<float2*>(p), make_float2(v[0],"
     " v[1]));", "", 0),
]
K11_VARIANTS = {
    "(a) as built": [],
    "(a) a channel a lane, U=32": ["-DABL_PICK=1"],
    "(a) a channel a lane, U=16": ["-DABL_PICK=1", "-DABL_U1=16"],
    "(a) channel pairs, U=8": ["-DABL_PICK=2"],
    "(a) channel pairs, U=16": ["-DABL_PICK=2", "-DABL_U2=16"],
    "(a) one-warp blocks": ["-DABL_WARPS=1"],
    "(a) eight-warp blocks": ["-DABL_WARPS=8"],
    "(a) plain stores": ["-DABL_PLAIN_ST=1"],
    "(a) __ldg loads": ["-DABL_LD=1"]}

# Candidate (b): the recurrence fed from a shared-memory ring that TMA
# fills.  Block: kCons consumer warps (one 32-channel slab each) and one
# producer warp, whose lane 0 issues the copies of x's and a's (kBt x 32
# kCons) tiles at (d0, b T + t0) of the (B T, D) view; a tile that runs
# past row b's T holds the next row's steps, which are not read.
RING_SOURCE = r"""
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#ifndef ABL_STAGES
#define ABL_STAGES 4
#endif
#ifndef ABL_BT
#define ABL_BT 16
#endif
#ifndef ABL_CONS
#define ABL_CONS 1
#endif
namespace {
constexpr int kStages = ABL_STAGES, kBt = ABL_BT, kCons = ABL_CONS;
constexpr int kCols = 32 * kCons;
constexpr unsigned kTileBytes = kBt * kCols * 4;
constexpr int kThreads = 32 * (kCons + 1);
constexpr size_t kSmem = 128 + 2 * kStages * (size_t)kTileBytes + 16 * kStages;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ float rglru_step(float h, float x, float a) {
  const float gx = sqrtf(fmaxf(1.0f - a * a, 0.0f)) * x;
  return a * h + gx;
}

__global__ void __launch_bounds__(kThreads)
rglru_ring(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap amap,
           int T, int D, float* __restrict__ y, float* __restrict__ h_out) {
  extern __shared__ uint8_t smem_raw[];
  float* ring = reinterpret_cast<float*>(((uintptr_t)smem_raw + 127) & ~(uintptr_t)127);
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + 2 * kStages * kBt * kCols);
  const int b = blockIdx.y, d0 = blockIdx.x * kCols;
  const int tiles = (T + kBt - 1) / kBt;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(bars + s), 1);                 // full: the copies landed
      mbar_init(smem_u32(bars + kStages + s), kCons);   // free: consumers done
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == kCons) {
    if (lane == 0) {
      for (int it = 0; it < tiles; ++it) {
        const int s = it % kStages;
        mbar_wait(smem_u32(bars + kStages + s), ((it / kStages) & 1) ^ 1);
        const uint32_t full = smem_u32(bars + s);
        mbar_expect_tx(full, 2 * kTileBytes);
        float* sx = ring + (2 * s) * kBt * kCols;
        tma_load_2d(smem_u32(sx), &xmap, full, d0, b * T + it * kBt);
        tma_load_2d(smem_u32(sx + kBt * kCols), &amap, full, d0, b * T + it * kBt);
      }
    }
    return;
  }
  const int col = 32 * warp + lane;
  const int d = d0 + col;
  float* yp = y + (long long)b * T * D + d;
  float h = 0.0f;
  for (int it = 0; it < tiles; ++it) {
    const int s = it % kStages;
    mbar_wait(smem_u32(bars + s), (it / kStages) & 1);
    const float* tx = ring + (2 * s) * kBt * kCols + col;
    const float* ta = tx + kBt * kCols;
    float* yq = yp + (long long)it * kBt * D;
    if (d < D) {
      const int steps = T - it * kBt < kBt ? T - it * kBt : kBt;
      if (steps == kBt) {
#pragma unroll
        for (int i = 0; i < kBt; ++i) {
          h = rglru_step(h, tx[i * kCols], ta[i * kCols]);
          __stcs(yq + (long long)i * D, h);
        }
      } else {
        for (int i = 0; i < steps; ++i) {
          h = rglru_step(h, tx[i * kCols], ta[i * kCols]);
          __stcs(yq + (long long)i * D, h);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_u32(bars + kStages + s));
  }
  if (d < D) h_out[(long long)b * D + d] = h;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

int make_map(CUtensorMap* map, const float* p, int B, int T, int D) {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* q = nullptr;
    cudaDriverEntryPointQueryResult got;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &q, 12000, cudaEnableDefault, &got);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &q,
                                                    cudaEnableDefault, &got);
#endif
    if (err != cudaSuccess || got != cudaDriverEntryPointSuccess) return 100000;
    fn = reinterpret_cast<EncodeTiled>(q);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)B * T};
  const cuuint64_t strides[1] = {(cuuint64_t)D * 4};
  const cuuint32_t box[2] = {(cuuint32_t)kCols, (cuuint32_t)kBt};
  const cuuint32_t estride[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(p),
                        dims, strides, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 100001 + (int)r;
}
}  // namespace

extern "C" {
// candidate (b): x, a (B, T, D) float32 contiguous, D % 4 == 0, 16-byte
// aligned; the C signature of csrc/rglru_scan.cu's entry
int rglru_scan(const float* x, const float* a, int B, int T, int D, float* y,
               float* h_out, void* stream) {
  if (D % 4 != 0 || ((uintptr_t)x & 15) || ((uintptr_t)a & 15)) return 1;
  CUtensorMap xmap, amap;
  int err = make_map(&xmap, x, B, T, D);
  if (err == 0) err = make_map(&amap, a, B, T, D);
  if (err != 0) return err;
  cudaError_t e = cudaFuncSetAttribute(rglru_ring, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)kSmem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((D + kCols - 1) / kCols), (unsigned)B);
  rglru_ring<<<grid, kThreads, kSmem, (cudaStream_t)stream>>>(xmap, amap, T, D, y, h_out);
  return (int)cudaGetLastError();
}
const char* rglru_error_string(int code) {
  return code >= 100000 ? "tensor map" : cudaGetErrorString((cudaError_t)code);
}
}
"""
RING_VARIANTS = {
    "(b) 32-ch ring 4x16": ["-DABL_STAGES=4"],
    "(b) 32-ch ring 8x16": ["-DABL_STAGES=8"],
    "(b) 64-ch ring 4x16": ["-DABL_STAGES=4", "-DABL_CONS=2"],
    "(b) 64-ch ring 8x16": ["-DABL_STAGES=8", "-DABL_CONS=2"]}
K11_MAIN, K11_LARGE = (8, 2560, 2560), (32, 4096, 2560)


def compile_variants(build, name: str, src: str, hooks, variants, flags_of: str,
                     include: Path, runs=lambda variant, kernel: True) -> dict:
    """Builds each variant of ``src`` (its hooks turned into macros that
    default to the built values), with ``csrc/<flags_of>.cu``'s flags, the
    headers of ``include`` and the variant's -D flags, all in parallel;
    prints what -Xptxas -v said of each kernel the variant ``runs``;
    returns {variant: library}."""
    prelude = ""
    for old, new, macro, default in hooks:
        if old not in src:
            raise RuntimeError(f"hook not found in {name}: {old!r}")
        src = src.replace(old, new, 1)
        if macro:
            prelude += f"#ifndef {macro}\n#define {macro} {default}\n#endif\n"
    src = src.replace("namespace {\n", prelude + "namespace {\n", 1)
    out = build.build_dir() / "ablation"
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{name}_k8_k11.cu"
    path.write_text(src)
    procs = {v: subprocess.Popen(
        [build.nvcc_path(), *build._flags(flags_of), f"-I{include}", *flags,
         "-o", str(out / f"lib{name}_k8_k11_{i}.so"), str(path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i, (v, flags) in enumerate(variants.items())}
    libs = {}
    for i, (v, proc) in enumerate(procs.items()):
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode:
            raise build.BuildError(f"{name} {v}: {log}")
        libs[v] = ctypes.CDLL(str(out / f"lib{name}_k8_k11_{i}.so"))
        kernel = None
        for line in log.splitlines():
            if "Function properties for" in line:
                kernel = line.split("for", 1)[1].strip()
            elif kernel and ("Used" in line or "spill" in line) and runs(
                    v, kernel):
                print(f"[ablation] ptxas {name} {v} {kernel[-48:]}: "
                      f"{line.split(':', 1)[-1].strip()}", flush=True)
    return libs


def k8_recheck(torch, pk, ref, libs: dict, n: int, when: str) -> int:
    """``n`` fresh (5, 50176) code arrays below 2^9 through K8 (b = 9) from
    each of ``libs``, held bit-equal to the plain version; returns the
    number of mismatches."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bad = 0
    saved = pk._lib
    try:
        for i in range(n):
            codes = torch.randint(0, 1 << 9, (5, 50176), generator=gen,
                                  device=dev, dtype=torch.int32)
            want = ref.pack_codes(codes, 9)
            for v, lib in libs.items():
                pk._lib = lambda lib=lib: lib
                got = pk.pack_codes(codes, 9)
                if torch.equal(got, want):
                    continue
                bad += 1
                pos = (got != want).nonzero()
                print(f"[recheck] K8 {v} ({when}) draw {i}: {pos.shape[0]} "
                      f"words differ, first {pos[:4].tolist()}: "
                      f"{got[tuple(pos[0])].item()} != "
                      f"{want[tuple(pos[0])].item()}; a second call agrees "
                      f"{torch.equal(pk.pack_codes(codes, 9), want)}",
                      flush=True)
    finally:
        pk._lib = saved
    torch.cuda.synchronize()
    print(f"[recheck] K8 (5, 50176) b=9 {when}: {n} draws x {len(libs)} "
          f"libraries ({', '.join(libs)}), {bad} mismatches", flush=True)
    return bad


def device_ms(torch, fn, calls: int, windows: int = 3):
    """(device ms, device events) a call of ``fn`` under ``torch.profiler``,
    from the window with the most device events; (None, None) where none
    was recorded."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best = (None, None)
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if evs and (best[1] is None or len(evs) / calls > best[1]):
            best = (sum(e.time_range.elapsed_us() for e in evs) / 1e3 / calls,
                    len(evs) / calls)
    return best


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None,
                    help="root of the checkout whose kernels are compared")
    ap.add_argument("--recheck", type=int, default=0, metavar="N",
                    help="only hold K8 to its plain version on N fresh "
                         "draws before and N after the libraries load")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("k8_k11_ablation: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import prng
    from repro_torch.configs import get_spec
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import pack_codes as pk
    from repro_torch.kernels import qr_pack as qp
    from repro_torch.kernels import quantize as qk
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tfm

    def source(name):
        return (build.CSRC / f"{name}.cu").read_text()

    bad = 0
    if args.recheck:
        bad += k8_recheck(torch, pk, ref, {"main build": pk._lib()},
                          args.recheck, "before the ablation's libraries")

    k8 = compile_variants(build, "pack_codes", source("pack_codes"), K8_HOOKS,
                          K8_VARIANTS, "pack_codes", build.CSRC)
    k11 = compile_variants(
        build, "rglru_scan", source("rglru_scan"), K11_HOOKS, K11_VARIANTS,
        "rglru_scan", build.CSRC, lambda v, kernel: v == "(a) as built" or (
            "U=" in v and "rglru_slabsILi{}ELi{}E".format(
                2 if "pairs" in v else 1, v.split("U=")[1]) in kernel))
    k11.update(compile_variants(build, "ring", RING_SOURCE, [], RING_VARIANTS,
                                "rglru_scan", build.CSRC))
    k7 = {"as built": qp._lib()}
    if args.parent:
        csrc = Path(args.parent).resolve() / "src/repro_torch/kernels/csrc"
        for name, libs in (("pack_codes", k8), ("qr_pack", k7),
                           ("rglru_scan", k11)):
            libs.update(compile_variants(
                build, f"parent_{name}", (csrc / f"{name}.cu").read_text(), [],
                {"parent": []}, name, csrc))
    for lib in k8.values():
        pk._bind(lib)
    for lib in k7.values():
        qp._bind(lib)
    for lib in k11.values():
        rg._bind(lib)
    if args.recheck:
        bad += k8_recheck(torch, pk, ref, {"main build": pk._lib(), **k8},
                          args.recheck, "with every library loaded")
        return 1 if bad else 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def time_ms(fn, iters):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / iters

    def report(label, plans, iters):
        row = {name: [] for name in plans}
        for name in list(plans) + list(plans)[::-1]:
            row[name].append(time_ms(plans[name], iters))
        print(f"[ablation] {label}: ms (min of 2, in turns) " + "; ".join(
            f"{n_} {min(ms)!r}" for n_, ms in row.items()), flush=True)
        print(f"[ablation] {label}: (device ms, device events) a call "
              f"(torch.profiler) " + "; ".join(
                  f"{n_} {device_ms(torch, fn, 10)!r}"
                  for n_, fn in plans.items()), flush=True)

    def with_lib(module, lib, fn):
        """``fn`` with ``module``'s kernels taken from ``lib``."""
        def run():
            saved = module._lib
            module._lib = lambda: lib
            try:
                return fn()
            finally:
                module._lib = saved
        return run

    # ---- K8 and K7 ---------------------------------------------------- #
    for rows, n, iters in ((5, 50176, 500), (4, 1 << 24, 20)):
        codes = torch.randint(0, 1 << 9, (rows, n), generator=gen, device=dev,
                              dtype=torch.int32)
        want = ref.pack_codes(codes, 9)
        plans = {v: with_lib(pk, lib, lambda: pk.pack_codes(codes, 9))
                 for v, lib in k8.items()}
        for v, fn in plans.items():
            got = fn()
            if not torch.equal(got, want):
                bad = (got != want).nonzero()
                raise AssertionError(
                    f"K8 {v}: differs from the plain version at "
                    f"{bad.shape[0]} words, first {bad[:4].tolist()}: "
                    f"{got[tuple(bad[0])].item()} != "
                    f"{want[tuple(bad[0])].item()}; again: "
                    f"{torch.equal(fn(), want)}")
        report(f"K8 {(rows, n)} b=9", plans, iters)
        if n == 1 << 24:
            x = torch.randn((rows, n), generator=gen, device=dev)
            keys = prng.split(prng.PRNGKey(5), rows)
            norm = qk.l2_norm(x)
            u = prng.uniform(keys, n, device=dev)
            plans = {}
            for v, lib in k7.items():
                plans[f"keyed {v}"] = with_lib(
                    qp, lib, lambda: qp.quantize_pack_keyed(x, 8, keys, norm))
                plans[f"reading u {v}"] = with_lib(
                    qp, lib,
                    lambda: qp.quantize_pack_with_uniforms(x, 8, u, norm))
            words = ref.quantize_pack_with_uniforms(x, 8, u, norm)
            for v, fn in plans.items():
                if not torch.equal(fn(), words):
                    raise AssertionError(f"K7 {v}: differs from the plain "
                                         f"version")
            report(f"K7 {(rows, n)} r=8", plans, iters)
            del x, u, words
        del codes, want
        torch.cuda.empty_cache()

    # ---- K11 ---------------------------------------------------------- #
    for (b, t, d), iters in ((K11_MAIN, 50), (K11_LARGE, 10)):
        x = torch.randn((b, t, d), generator=gen, device=dev)
        a = torch.rand((b, t, d), generator=gen, device=dev)
        y_w, h_w = ref.rglru_scan(x, a)
        plans = {v: with_lib(rg, lib, lambda: rg.rglru_scan(x, a))
                 for v, lib in k11.items()}
        for v, fn in plans.items():
            y, h = fn()
            torch.cuda.synchronize()
            if not (torch.equal(y.view(torch.int32), y_w.view(torch.int32))
                    and torch.equal(h.view(torch.int32),
                                    h_w.view(torch.int32))):
                raise AssertionError(f"K11 {v}: differs from the plain "
                                     f"version")
        del y, h, y_w, h_w
        torch.cuda.empty_cache()
        print(f"[ablation] K11 {(b, t, d)}: bound {12 * b * t * d / 3.35e9!r} ms "
              f"(bytes)", flush=True)
        report(f"K11 {(b, t, d)}", plans, iters)
        del x, a
        torch.cuda.empty_cache()

    # ---- recurrentgemma-2b's prefill, the parent's K11 against this --- #
    if "parent" in k11:
        m = get_spec("recurrentgemma-2b").model
        params = tfm.init_params(m, torch.Generator(device=dev).manual_seed(0))
        prompts = serve.prompts_for(m, 8, 2560, dev)
        runs = {"parent": k11["parent"], "this": rg._lib()}
        ms, logits = {v: [] for v in runs}, {}
        for v in ("parent", "this", "this", "parent"):
            fn = with_lib(rg, runs[v], lambda: tfm.prefill(
                params, m, prompts, max_len=2560 + 33)[0])
            fn()
            for _ in range(3):
                torch.cuda.synchronize()
                before = rg.LAUNCHES["rglru_scan"]
                t0 = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                ms[v].append((time.perf_counter() - t0) * 1e3)
                if rg.LAUNCHES["rglru_scan"] - before != 18:
                    raise AssertionError("a prefill launched K11 "
                                         f"{rg.LAUNCHES['rglru_scan'] - before}"
                                         " times, not 18")
            logits[v] = out
        if not torch.equal(logits["parent"], logits["this"]):
            raise AssertionError("prefill logits differ between the two K11s")
        print(f"[ablation] recurrentgemma-2b prefill (bf16, batch 8, prompt "
              f"2560; parent, this, this, parent): ms " + "; ".join(
                  f"{v} {ms_!r} (median {statistics.median(ms_)!r})"
                  for v, ms_ in ms.items()) + "; logits equal", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
