#!/usr/bin/env python3
"""What each design choice of K9 (code unpack, and its decode to Q_r
values) and K7 (fused Q_r pack, reading or drawing its uniforms) is worth
on the card: timings with one choice changed or one part taken out at a
time, beside the one-group-a-warp kernels they replaced.

    python3 tools/k7_k9_ablation.py

Needs one CUDA card and ``nvcc``.  Builds variants of
``src/repro_torch/kernels/csrc/pack_codes.cu`` and ``qr_pack.cu`` into
``src/repro_torch/kernels/_build/ablation/`` (the outputs of a variant
marked "wrong" are wrong by design; only its time means something):

* K9: ``as built`` (a persistent block a row slot, one wave of 8 blocks
  an SM, 1024-code tiles, each lane reading its group's b words straight
  from global memory, a block barrier a tile, 16-byte stores); six blocks
  an SM; ``4-byte stores``; ``no barrier a tile`` (the block's warps
  drift over its tiles); ``cp.async staging`` (the codes entry with the tiles' words
  staged into shared memory by cp.async three stages deep, 16-byte copies
  from the 16-byte boundary and partial chunks word by word: text below);
* K7: keyed and reading u as built; ``4-byte loads``; ``keyed, no
  threefry`` (wrong: u is a constant, so what is left is the loads, the
  rounding, the pack and the stores); ``keyed, no pack`` (wrong: a lane
  stores one word, the XOR of its codes, so what is left is the draw, the
  rounding and a quarter of the stores);
* the kernels these replaced, one group of 32 a warp: K9's and K7's
  loops of ``pack_codes.cu`` / ``qr_pack.cu`` before this redesign (text
  below), with the 64-bit division of the group index (``one group a
  warp``) and with a 2-D grid instead (``one group a warp, no division``).

Prints each variant's registers and spills (``-Xptxas -v``) and the SASS
integer instructions an element of the keyed K7 and of K9's values entry
(``build.sass_counts``).  Times each with CUDA events through the wrapper
(the old kernels through their own C entry), in turns (each variant twice,
in order and then in reverse; the minimum is printed), and by its device
time and device events a call under ``torch.profiler`` (a call is one
event; fewer means the profiler dropped records): at (5, 50176) and (4,
2^24), b = 9 (r = 8), host keys.  Prints the card's name and power
limit.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

# (text in the source, its replacement, the macro and its default)
K9_HOOKS = [
    ("constexpr int kUnpackBlocksPerSm = 8;",
     "constexpr int kUnpackBlocksPerSm = ABL_BLOCKS;", "ABL_BLOCKS", 8),
    ("const bool vec = n % 4 == 0 && ((uintptr_t)out & 15) == 0;",
     "const bool vec = !ABL_NARROW && n % 4 == 0 && ((uintptr_t)out & 15) == 0;",
     "ABL_NARROW", 0),
    ("    __syncthreads();\n    const long long e0",
     "    if (!ABL_NO_BARRIER) __syncthreads();\n    const long long e0",
     "ABL_NO_BARRIER", 0),
]
K9_VARIANTS = {"as built": [], "six blocks an SM": ["-DABL_BLOCKS=6"],
               "4-byte stores": ["-DABL_NARROW=1"],
               "no barrier a tile": ["-DABL_NO_BARRIER=1"]}
K7_HOOKS = [
    ("  const bool vec = n % 4 == 0 && ((uintptr_t)x & 15) == 0 &&",
     "  const bool vec = !ABL_NARROW && n % 4 == 0 && ((uintptr_t)x & 15) == 0 &&",
     "ABL_NARROW", 0),
    ("uv[e] = threefry_uniform(ks, (uint32_t)(e0 + e));",
     "uv[e] = ABL_NO_THREEFRY ? 0.5f : threefry_uniform(ks, (uint32_t)(e0 + e));",
     "ABL_NO_THREEFRY", 0),
    ("  const bool stores = group < n32;\n",
     "  const bool stores = group < n32;\n"
     "  if (ABL_NO_PACK) {\n"
     "    if (stores && k < b) wg[k] = c[0] ^ c[1] ^ c[2] ^ c[3];\n"
     "    return;\n"
     "  }\n", "ABL_NO_PACK", 0),
]
K7_VARIANTS = {"as built": [], "4-byte loads": ["-DABL_NARROW=1"],
               "no threefry": ["-DABL_NO_THREEFRY=1"],
               "no pack": ["-DABL_NO_PACK=1"]}

# K9's and K7's kernels before this redesign: one warp a group of 32, the
# group index split into (row, group) by a 64-bit division, unless
# ABL_NO_DIV, where a 2-D grid gives the row.
OLD_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
#ifndef ABL_NO_DIV
#define ABL_NO_DIV 0
#endif
namespace {
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr long long kMaxBlocks = 132 * 16;
constexpr unsigned kFull = 0xFFFFFFFFu;

__global__ void unpack_planes(const uint32_t* __restrict__ words, long long n,
                              long long n32, int b, long long groups,
                              uint32_t* __restrict__ codes) {
  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long stride = (long long)gridDim.x * kWarps;
  for (long long g = warp; g < groups; g += stride) {
    long long row, j;
    if (ABL_NO_DIV) { row = blockIdx.y; j = g; }
    else { row = g / n32; j = g - row * n32; }
    const uint32_t mine = lane < b ? words[(row * n32 + j) * b + lane] : 0u;
    uint32_t c = 0u;
    for (int t = 0; t < b; ++t) {
      const uint32_t plane = __shfl_sync(kFull, mine, t);
      c |= ((plane >> lane) & 1u) << t;
    }
    const long long i = j * 32 + lane;
    if (i < n) codes[row * n + i] = c;
  }
}

__global__ void qr_pack(const float* __restrict__ x, const float* __restrict__ u,
                        const float* __restrict__ norm, long long n, long long n32,
                        int r, float levels, long long groups,
                        uint32_t* __restrict__ words) {
  const int b = 1 + r;
  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long stride = (long long)gridDim.x * kWarps;
  for (long long g = warp; g < groups; g += stride) {
    long long row, j;
    if (ABL_NO_DIV) { row = blockIdx.y; j = g; }
    else { row = g / n32; j = g - row * n32; }
    const long long i = j * 32 + lane;
    uint32_t c = 0u;
    if (i < n) {
      const float xv = x[row * n + i];
      const float nr = norm[row];
      const float safe = nr > 0.0f ? nr : 1.0f;
      const float y = fabsf(xv) / safe;
      const float scaled = levels * y;
      const float lo = floorf(scaled);
      float level = lo + (u[row * n + i] < scaled - lo ? 1.0f : 0.0f);
      level = fminf(level, levels - 1.0f);
      c = (uint32_t)level | (xv < 0.0f ? (1u << r) : 0u);
    }
    uint32_t mine = 0u;
    for (int t = 0; t < b; ++t) {
      const uint32_t plane = __ballot_sync(kFull, (c >> t) & 1u);
      if (lane == t) mine = plane;
    }
    if (lane < b) words[(row * n32 + j) * b + lane] = mine;
  }
}

dim3 grid_for(int rows, long long n32) {
  long long groups = ABL_NO_DIV ? n32 : rows * n32;
  long long blocks = (groups + kWarps - 1) / kWarps;
  long long cap = ABL_NO_DIV ? (kMaxBlocks + rows - 1) / rows : kMaxBlocks;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  return dim3((unsigned)blocks, ABL_NO_DIV ? (unsigned)rows : 1u);
}
}  // namespace

extern "C" {
int old_unpack_codes(const uint32_t* words, int rows, long long n, int b,
                     uint32_t* codes, void* stream) {
  const long long n32 = (n + 31) / 32;
  const long long groups = ABL_NO_DIV ? n32 : rows * n32;
  unpack_planes<<<grid_for(rows, n32), kThreads, 0, (cudaStream_t)stream>>>(
      words, n, n32, b, groups, codes);
  return (int)cudaGetLastError();
}
int old_qr_pack_codes(const float* x, const float* u, const float* norm, int rows,
                      long long n, int r, uint32_t* words, void* stream) {
  const long long n32 = (n + 31) / 32;
  const long long groups = ABL_NO_DIV ? n32 : rows * n32;
  qr_pack<<<grid_for(rows, n32), kThreads, 0, (cudaStream_t)stream>>>(
      x, u, norm, n, n32, r, (float)(1u << r), groups, words);
  return (int)cudaGetLastError();
}
}
"""
OLD_VARIANTS = {"one group a warp": [], "one group a warp, no division":
                ["-DABL_NO_DIV=1"]}

# K9's codes entry with its tiles' words staged into shared memory by
# cp.async, ABL_STAGES deep, instead of read by each lane: the layout, the
# grid and the decode are the built kernel's.
STAGED_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
#ifndef ABL_STAGES
#define ABL_STAGES 3
#endif
namespace {
constexpr int kThreads = 256;
constexpr int kSms = 132;
constexpr int kTileCodes = 1024;
constexpr int kTileGroups = kTileCodes / 32;
constexpr int kStages = ABL_STAGES;
constexpr int kStageWords = kTileGroups * 32 + 4;   // b <= 32, plus the pad
constexpr int kBlocksPerSm = 8;

__device__ __forceinline__ void cp_async16(uint32_t* dst, const uint32_t* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// words of the row before the tile's first one in its 16-byte chunk
__device__ __forceinline__ int tile_pad(const uint32_t* wrow, int tile, int b) {
  return (int)(((uintptr_t)(wrow + (long long)tile * kTileGroups * b) >> 2) & 3);
}

// queue the copy of tile `tile`'s words into sh: whole 16-byte chunks as
// such, the words of a partial chunk one by one
__device__ __forceinline__ void stage_tile(uint32_t* sh, const uint32_t* wrow,
                                           long long n32, int b, int tile) {
  const long long g0 = (long long)tile * kTileGroups;
  const long long g1 = g0 + kTileGroups < n32 ? g0 + kTileGroups : n32;
  const int pad = tile_pad(wrow, tile, b);
  const uint32_t* base = wrow + g0 * b - pad;
  const int total = pad + (int)((g1 - g0) * b);
  const int chunks = (total + 3) >> 2;
  for (int c = threadIdx.x; c < chunks; c += kThreads) {
    if ((c > 0 || pad == 0) && 4 * c + 4 <= total) {
      cp_async16(sh + 4 * c, base + 4 * c);
    } else {
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * c + e;
        if (i >= pad && i < total) cp_async4(sh + i, base + i);
      }
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
staged_tiles(const uint32_t* __restrict__ words, long long n, long long n32, int b,
             int tiles, uint32_t* __restrict__ out) {
  __shared__ __align__(16) uint32_t sh[kStages][kStageWords];
  const long long row = blockIdx.y;
  const uint32_t* wrow = words + row * n32 * b;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gl = 4 * warp + (lane >> 3);
  const int shift = 4 * (lane & 7);
  int fetch = blockIdx.x;
  for (int s = 0; s < kStages - 1; ++s) {
    if (fetch < tiles) stage_tile(sh[s], wrow, n32, b, fetch);
    cp_async_commit();
    fetch += gridDim.x;
  }
  int stage = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (fetch < tiles) stage_tile(sh[(stage + kStages - 1) % kStages], wrow, n32, b, fetch);
    cp_async_commit();
    fetch += gridDim.x;
    const long long e0 = (long long)tile * kTileCodes + 128 * warp + 4 * lane;
    if (e0 < n) {
      const uint32_t* sw = sh[stage] + tile_pad(wrow, tile, b) + gl * b;
      uint32_t acc[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int t = 0; t < 32; ++t) {
        if (t >= b) break;
        const uint32_t nib = (sw[t] >> shift) & 0xFu;
        acc[t >> 3] |= (nib * (0x00204081u << (t & 7))) & (0x01010101u << (t & 7));
      }
      const uint32_t p01 = __byte_perm(acc[0], acc[1], 0x5140);
      const uint32_t q01 = __byte_perm(acc[0], acc[1], 0x7362);
      const uint32_t p23 = __byte_perm(acc[2], acc[3], 0x5140);
      const uint32_t q23 = __byte_perm(acc[2], acc[3], 0x7362);
      const uint32_t c[4] = {__byte_perm(p01, p23, 0x5410), __byte_perm(p01, p23, 0x7632),
                             __byte_perm(q01, q23, 0x5410), __byte_perm(q01, q23, 0x7632)};
      const long long at = row * n + e0;
      if (kVec) {
        *reinterpret_cast<uint4*>(out + at) = make_uint4(c[0], c[1], c[2], c[3]);
      } else {
        for (int e = 0; e < 4; ++e)
          if (e0 + e < n) out[at + e] = c[e];
      }
    }
    stage = (stage + 1) % kStages;
  }
}
}  // namespace

extern "C" {
int staged_unpack_codes(const uint32_t* words, int rows, long long n, int b,
                        uint32_t* codes, void* stream) {
  const long long n32 = (n + 31) / 32;
  const long long tiles = (n + kTileCodes - 1) / kTileCodes;
  long long per_row = (long long)kSms * kBlocksPerSm / rows;
  if (per_row < 1) per_row = 1;
  if (per_row > tiles) per_row = tiles;
  const dim3 grid((unsigned)per_row, (unsigned)rows);
  if (n % 4 == 0 && ((uintptr_t)codes & 15) == 0)
    staged_tiles<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        words, n, n32, b, (int)tiles, codes);
  else
    staged_tiles<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        words, n, n32, b, (int)tiles, codes);
  return (int)cudaGetLastError();
}
}
"""
STAGED_VARIANTS = {"cp.async staging": []}


def build_variants(build, name: str, src: str, hooks, variants,
                   flags_of: str) -> dict:
    """Each variant of ``src`` (hooked into macros defaulting to the built
    values), compiled with ``csrc/<flags_of>.cu``'s flags and its -D flags;
    prints what -Xptxas -v said of its kernels."""
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
    path = out / f"{name}_k7_k9.cu"
    path.write_text(src)
    nvcc = build.nvcc_path()
    procs = {v: subprocess.Popen(
        [nvcc, *build._flags(flags_of), f"-I{build.CSRC}", *flags, "-o",
         str(out / f"lib{name}_k7_k9_{i}.so"), str(path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i, (v, flags) in enumerate(variants.items())}
    libs = {}
    for i, (v, proc) in enumerate(procs.items()):
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode:
            raise build.BuildError(f"{name} {v}: {log}")
        libs[v] = ctypes.CDLL(str(out / f"lib{name}_k7_k9_{i}.so"))
        kernel = None
        for line in log.splitlines():
            if "Function properties for" in line:
                kernel = line.split("for", 1)[1].strip()
            elif kernel and ("Used" in line or "spill" in line):
                print(f"[ablation] ptxas {name} {v} {kernel[-40:]}: "
                      f"{line.split(':', 1)[-1].strip()}", flush=True)
    return libs


def device_ms(torch, fn, calls: int, windows: int = 3):
    """Device ms a call of ``fn`` (its kernels, copies and memsets) under
    ``torch.profiler``, and the device events a call; (None, None) where
    it recorded no device event.  The profiler can drop a device record,
    never add one, so of ``windows`` windows the one with the most events
    is kept."""
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
    import torch

    if not torch.cuda.is_available():
        print("k7_k9_ablation: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import prng
    from repro_torch.kernels import build
    from repro_torch.kernels import pack_codes as pk
    from repro_torch.kernels import qr_pack as qp
    from repro_torch.kernels import quantize as qk

    k9_libs = build_variants(build, "pack_codes",
                             (build.CSRC / "pack_codes.cu").read_text(),
                             K9_HOOKS, K9_VARIANTS, "pack_codes")
    k7_libs = build_variants(build, "qr_pack",
                             (build.CSRC / "qr_pack.cu").read_text(),
                             K7_HOOKS, K7_VARIANTS, "qr_pack")
    old_libs = build_variants(build, "old", OLD_SOURCE, [], OLD_VARIANTS,
                              "qr_pack")
    staged_libs = build_variants(build, "staged", STAGED_SOURCE, [],
                                 STAGED_VARIANTS, "pack_codes")
    for lib in k9_libs.values():
        pk._bind(lib)
    for lib in k7_libs.values():
        qp._bind(lib)
    P = ctypes.c_void_p
    for lib in staged_libs.values():
        lib.staged_unpack_codes.argtypes = [P, ctypes.c_int,
                                            ctypes.c_longlong, ctypes.c_int,
                                            P, P]
    for lib in old_libs.values():
        lib.old_unpack_codes.argtypes = [P, ctypes.c_int, ctypes.c_longlong,
                                         ctypes.c_int, P, P]
        lib.old_qr_pack_codes.argtypes = [P, P, P, ctypes.c_int,
                                          ctypes.c_longlong, ctypes.c_int, P, P]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    for name, match, per in (("qr_pack", ("qr_pack_tiles", "ILb1ELb1E"), 4),
                             ("pack_codes", ("unpack_tiles", "ILb1ELb1E"), 4)):
        ints = build.sass_counts(name, build.INT_OPCODES, match=match)
        print(f"[ablation] {name} {match[0]} {match[1]} SASS integer "
              f"instructions {ints!r}: {sum(ints.values()) / per!r} an "
              f"element (static count over the 4 elements a thread; K9's "
              f"unrolls all 32 planes, of which b run)", flush=True)
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
                  f"{n_} {device_ms(torch, fn, 20)!r}"
                  for n_, fn in plans.items()), flush=True)

    def with_lib(module, lib, fn):
        """``fn`` with ``module``'s kernels taken from ``lib`` for the
        call."""
        def run():
            saved = module._lib
            module._lib = lambda: lib
            try:
                return fn()
            finally:
                module._lib = saved
        return run

    stream = build.stream_ptr
    for rows, n, iters in ((5, 50176, 500), (4, 1 << 24, 20)):
        x = torch.randn((rows, n), generator=gen, device=dev)
        keys = prng.split(prng.PRNGKey(5), rows)
        norm = qk.l2_norm(x)
        u = prng.uniform(keys, n, device=dev)
        words = qp.quantize_pack_keyed(x, 8, keys, norm)
        codes = torch.empty((rows, n), dtype=torch.int32, device=dev)
        k9 = {}
        for v, lib in k9_libs.items():
            k9[f"codes {v}"] = with_lib(pk, lib,
                                        lambda: pk.unpack_codes(words, 9, n))
        k9["values as built"] = with_lib(
            pk, k9_libs["as built"],
            lambda: pk.unpack_qr_values(words, 8, n, norm))
        k9["values 4-byte stores"] = with_lib(
            pk, k9_libs["4-byte stores"],
            lambda: pk.unpack_qr_values(words, 8, n, norm))
        for v, lib in staged_libs.items():
            k9[f"codes {v}"] = (lambda lib=lib: lib.staged_unpack_codes(
                words.data_ptr(), rows, n, 9, codes.data_ptr(), stream()))
        for v, lib in old_libs.items():
            k9[f"codes {v}"] = (lambda lib=lib: lib.old_unpack_codes(
                words.data_ptr(), rows, n, 9, codes.data_ptr(), stream()))
        report(f"K9 {(rows, n)} b=9", k9, iters)
        out = torch.empty((rows, -(-n // 32) * 9), dtype=torch.int32,
                          device=dev)
        k7 = {}
        for v, lib in k7_libs.items():
            k7[f"keyed {v}"] = with_lib(
                qp, lib, lambda: qp.quantize_pack_keyed(x, 8, keys, norm))
            if v in ("as built", "4-byte loads", "no pack"):
                k7[f"reading u {v}"] = with_lib(
                    qp, lib,
                    lambda: qp.quantize_pack_with_uniforms(x, 8, u, norm))
        for v, lib in old_libs.items():
            k7[f"reading u {v}"] = (lambda lib=lib: lib.old_qr_pack_codes(
                x.data_ptr(), u.data_ptr(), norm.data_ptr(), rows, n, 8,
                out.data_ptr(), stream()))
        report(f"K7 {(rows, n)} r=8", k7, iters)
        # the old kernels and the variants that are not marked wrong give
        # the plain version's bits
        torch.cuda.synchronize()
        for v, lib in staged_libs.items():
            lib.staged_unpack_codes(words.data_ptr(), rows, n, 9,
                                    codes.data_ptr(), stream())
            torch.cuda.synchronize()
            if not torch.equal(codes, pk.unpack_codes(words, 9, n)):
                raise AssertionError(f"{v}: differs from the built kernel")
        for v, lib in old_libs.items():
            lib.old_unpack_codes(words.data_ptr(), rows, n, 9,
                                 codes.data_ptr(), stream())
            lib.old_qr_pack_codes(x.data_ptr(), u.data_ptr(), norm.data_ptr(),
                                  rows, n, 8, out.data_ptr(), stream())
            torch.cuda.synchronize()
            if not (torch.equal(codes, pk.unpack_codes(words, 9, n))
                    and torch.equal(out, words)):
                raise AssertionError(f"{v}: differs from the built kernels")
        del x, u, words, codes, out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
