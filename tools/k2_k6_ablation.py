#!/usr/bin/env python3
"""What bounds K6 (coded slot compaction, one launch) on the card, and
where K2's fused route stops paying: timings with one part of K6 taken out
at a time, and the fused K1 + K2 launch against K1 then K2 by row length.

    python3 tools/k2_k6_ablation.py

Needs one CUDA card and ``nvcc``.  Builds variants of
``src/repro_torch/kernels/csrc/select_slots.cu`` into
``src/repro_torch/kernels/_build/ablation/`` (the outputs of a variant
marked "wrong" are wrong by design; only its time means something):

* ``window 128``: a look-back step reads 128 descriptors (four a lane),
  not 32;
* ``backoff``: a warp whose window is not ready sleeps 100 ns before it
  polls again;
* ``no look-back`` (wrong): every tile takes prefix 0, so no tile waits for
  another;
* ``no writes`` (wrong): the staged slots are not copied out;
* ``no u`` (wrong): the uniforms are not loaded;
* ``any occupancy``: no floor of four blocks an SM on the registers (the
  compiler then takes more and the card holds three).

Times each, and the kernel as built, with CUDA events through the wrapper
at (5, 50176) (r = 4) and (4, 2^24) (r = 8), cap = n / 4, in turns; then
``threshold_mask``'s one launch against ``threshold_bits`` then
``mask_by_threshold`` at 2 and 5 rows of ``resident_max_n()`` and four
times that, k = 0.3 n; prints the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# variant -> -D flags; the hooks put the macros into the source
VARIANTS = {"as built": [], "window 128": ["-DABL_PER_LANE=4"],
            "backoff": ["-DABL_BACKOFF_NS=100"],
            "no look-back": ["-DABL_NO_LOOKBACK=1"],
            "no writes": ["-DABL_NO_WRITES=1"], "no u": ["-DABL_NO_U=1"],
            "any occupancy": ["-DABL_BLOCKS_PER_SM=1"]}
HOOKS = [
    ("constexpr int kCodeBlocksPerSm = 4;",
     "constexpr int kCodeBlocksPerSm = ABL_BLOCKS_PER_SM;"),
    ("constexpr int kPerLane = 1;", "constexpr int kPerLane = ABL_PER_LANE;"),
    ("          if (__all_sync(kFull, ready)) break;\n",
     "          if (__all_sync(kFull, ready)) break;\n"
     "          if (ABL_BACKOFF_NS) __nanosleep(ABL_BACKOFF_NS);\n"),
    ("    if (tr > 0) {\n      // look back",
     "    if (!ABL_NO_LOOKBACK && tr > 0) {\n      // look back"),
    ("  const unsigned m = total < room ? total : room;",
     "  const unsigned m = ABL_NO_WRITES ? 0u : (total < room ? total : room);"),
    ("        const float4 v = nib ? __ldg(reinterpret_cast<const float4*>(ur + e0))",
     "        const float4 v = (ABL_NO_U ? 0u : nib)\n"
     "                             ? __ldg(reinterpret_cast<const float4*>(ur + e0))"),
]
PRELUDE = ("#ifndef ABL_BLOCKS_PER_SM\n#define ABL_BLOCKS_PER_SM 4\n#endif\n"
           "#ifndef ABL_PER_LANE\n#define ABL_PER_LANE 1\n#endif\n"
           "#ifndef ABL_BACKOFF_NS\n#define ABL_BACKOFF_NS 0\n#endif\n"
           "#ifndef ABL_NO_LOOKBACK\n#define ABL_NO_LOOKBACK 0\n#endif\n"
           "#ifndef ABL_NO_WRITES\n#define ABL_NO_WRITES 0\n#endif\n"
           "#ifndef ABL_NO_U\n#define ABL_NO_U 0\n#endif\n")


def build_variants(build):
    src = (build.CSRC / "select_slots.cu").read_text()
    for old, new in HOOKS:
        if old not in src:
            raise RuntimeError(f"hook not found in select_slots.cu: {old!r}")
        src = src.replace(old, new)
    src = src.replace("namespace {\n", PRELUDE + "namespace {\n", 1)
    out = build.build_dir() / "ablation"
    out.mkdir(parents=True, exist_ok=True)
    (out / "select_slots_ablation.cu").write_text(src)
    nvcc = build.nvcc_path()
    procs = {name: subprocess.Popen(
        [nvcc, *build._flags("select_slots"), *flags, "-o",
         str(out / f"libselect_slots_{i}.so"),
         str(out / "select_slots_ablation.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i, (name, flags) in enumerate(VARIANTS.items())}
    libs = {}
    for i, (name, proc) in enumerate(procs.items()):
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode:
            raise build.BuildError(f"select_slots {name}: {log}")
        libs[name] = ctypes.CDLL(str(out / f"libselect_slots_{i}.so"))
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k2_k6_ablation: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import quantize as qk
    from repro_torch.kernels import select_slots as sk
    from repro_torch.kernels import topk_compress as tk

    libs = build_variants(build)
    for lib in libs.values():
        sk._bind(lib)
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

    for rows, n, r, iters in ((5, 50176, 4, 500), (4, 1 << 24, 8, 20)):
        x = torch.randn((rows, n), generator=gen, device=dev)
        u = torch.rand((rows, n), generator=gen, device=dev)
        cap = n // 4
        t = tk.threshold_bits(x, cap)
        norm = qk.l2_norm(ref.mask_by_threshold(x, t))
        row = {name: [] for name in libs}
        for name in list(libs) + list(libs)[::-1]:
            sk._lib = lambda lib=libs[name]: lib
            row[name].append(time_ms(
                lambda: sk.compact_code_slots(x, u, norm, t, r, cap), iters))
        print(f"[ablation] K6 {(rows, n)} r={r}: ms (min of 2) " + "; ".join(
            f"{n_} {min(ms)!r}" for n_, ms in row.items()), flush=True)
        del x, u
    resident = tk.resident_max_n()
    for rows in (2, 5):
        for n in (resident, 4 * resident):
            x = torch.randn((rows, n), generator=gen, device=dev)
            k = int(0.3 * n)
            thr = torch.empty(rows, dtype=torch.int64, device=dev)
            out = torch.empty_like(x)
            plans = {"fused": lambda: tk._select(x, k, thr, out),
                     "K1 then K2": lambda: tk.mask_by_threshold(
                         x, tk.threshold_bits(x, k))}
            row = {name: [] for name in plans}
            for name in list(plans) * 2:
                row[name].append(time_ms(plans[name], 20))
            print(f"[ablation] K1 + K2 {(rows, n)}: ms (min of 2) " + "; ".join(
                f"{n_} {min(ms)!r}" for n_, ms in row.items()), flush=True)
            del x, out
    return 0


if __name__ == "__main__":
    sys.exit(main())
