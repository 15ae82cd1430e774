#!/usr/bin/env python3
"""What bounds K1 (TopK threshold) and K12's bf16 route (WKV6) on the
card: timings of each kernel with one part taken out at a time.

    python3 tools/k1_k12_ablation.py

Needs one CUDA card and ``nvcc``.  Builds variants of
``src/repro_torch/kernels/csrc/{topk_compress,wkv6}.cu`` into
``src/repro_torch/kernels/_build/ablation/`` (the outputs of a variant are
wrong by design; only its time means something):

* K12 ``no_a``: the diagonal block A's running products;
* K12 ``no_scans``: the decay scans (R~, K~ and D);
* K12 ``no_inter``: the R~ S products (3xTF32);
* K12 ``mma_only``: neither A nor the scans;
* K1 ``load_only``: no counting (the passes still stream x from HBM and
  the third collects its candidates, as at (4, 2^24)).

Times each, and the kernels as built, with CUDA events: K12 on bf16
``rwkv6._heads`` views at (8, 40, 2560, 64) and (32, 40, 4096, 64), K1 at
(5, 50176) and (4, 2^24) with k = n / 10; prints the card's name and
power limit.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# (source stem, variant -> -D flags, hooks: (text, replacement))
PLANS = {
    "wkv6": ({"as built": [], "no_a": ["-DABL_A=0"],
              "no_scans": ["-DABL_SCANS=0"],
              "no_inter": ["-DABL_INTER_STEPS=0"],
              "mma_only": ["-DABL_A=0", "-DABL_SCANS=0"]},
             [("    if (t >= 2 * warp) {          // the same for the warp",
               "    if (ABL_A && t >= 2 * warp) {"),
              ("      for (int t = 0; t < kL; ++t) {\n"
               "        unsigned hi, lo;",
               "      for (int t = 0; t < (ABL_SCANS ? kL : 0); ++t) {\n"
               "        unsigned hi, lo;"),
              ("      for (int s = kL - 1; s >= 0; --s) {\n"
               "        const float x =",
               "      for (int s = kL - 1; s >= (ABL_SCANS ? 0 : kL); --s) {\n"
               "        const float x ="),
              ("    for (int m = 0; m < 4; ++m) {\n      const int i0",
               "    for (int m = 0; m < ABL_INTER_STEPS; ++m) {\n"
               "      const int i0")],
             "#ifndef ABL_A\n#define ABL_A 1\n#endif\n"
             "#ifndef ABL_SCANS\n#define ABL_SCANS 1\n#endif\n"
             "#ifndef ABL_INTER_STEPS\n#define ABL_INTER_STEPS 4\n#endif\n"),
    "topk_compress": ({"as built": [], "load_only": ["-DABL_LOAD_ONLY"]},
                      [("if (act) count_bin(sl, H, (e[j] >> shift) & 0xFFu, "
                        "pass);",
                        "if (act) ABL_COUNT(count_bin(sl, H, (e[j] >> shift) "
                        "& 0xFFu, pass));"),
                       ("if (act) count_bin(sl, H, (e >> shift) & 0xFFu, "
                        "pass);",
                        "if (act) ABL_COUNT(count_bin(sl, H, (e >> shift) & "
                        "0xFFu, pass));"),
                       ("const bool collect = matching <= kListCap;",
                        "const bool collect = ABL_COLLECT;")],
                      "#ifdef ABL_LOAD_ONLY\n#define ABL_COUNT(call)\n"
                      "#define ABL_COLLECT (pass >= 2)\n#else\n"
                      "#define ABL_COUNT(call) call\n"
                      "#define ABL_COLLECT (matching <= kListCap)\n#endif\n"),
}


def build_variants(build, stem, variants, hooks, prelude):
    src = (build.CSRC / f"{stem}.cu").read_text()
    for old, new in hooks:
        if old not in src:
            raise RuntimeError(f"hook not found in {stem}.cu: {old!r}")
        src = src.replace(old, new)
    src = src.replace("namespace {\n", prelude + "namespace {\n", 1)
    out = build.build_dir() / "ablation"
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{stem}_ablation.cu").write_text(src)
    nvcc = build.nvcc_path()
    procs = {name: subprocess.Popen(
        [nvcc, *build._flags(stem), *flags, "-o",
         str(out / f"lib{stem}_{i}.so"), str(out / f"{stem}_ablation.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i, (name, flags) in enumerate(variants.items())}
    libs = {}
    for i, (name, proc) in enumerate(procs.items()):
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode:
            raise build.BuildError(f"{stem} {name}: {log}")
        libs[name] = ctypes.CDLL(str(out / f"lib{stem}_{i}.so"))
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k1_k12_ablation: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels import topk_compress as tk
    from repro_torch.kernels import wkv6
    from repro_torch.models import rwkv6

    libs = {stem: build_variants(build, stem, *plan)
            for stem, plan in PLANS.items()}
    for lib in libs["wkv6"].values():
        wkv6._bind(lib)
    for lib in libs["topk_compress"].values():
        tk._bind(lib)
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

    for b, h, t, iters in ((8, 40, 2560, 20), (32, 40, 4096, 5)):
        shape = (b, t, h * 64)
        r, k, v = (0.5 * torch.randn(shape, generator=gen, device=dev)
                   .bfloat16() for _ in range(3))
        w = torch.rand(shape, generator=gen, device=dev)
        u = 0.1 * torch.randn((h, 64), generator=gen, device=dev)
        r, k, v, w = (rwkv6._heads(z, 64) for z in (r, k, v, w))
        row = {}
        for name, lib in libs["wkv6"].items():
            wkv6._lib = lambda lib=lib: lib
            row[name] = time_ms(lambda: wkv6.wkv6_scan(r, k, v, w, u), iters)
        print(f"[ablation] K12 bf16 route {(b, h, t, 64)}: ms " + "; ".join(
            f"{n} {ms!r}" for n, ms in row.items()), flush=True)
        del r, k, v, w
    for rows, n, iters in ((5, 50176, 500), (4, 1 << 24, 20)):
        x = torch.randn((rows, n), generator=gen, device=dev)
        row = {}
        for name, lib in libs["topk_compress"].items():
            tk._lib = lambda lib=lib: lib
            row[name] = time_ms(lambda: tk.threshold_bits(x, n // 10), iters)
        print(f"[ablation] K1 {(rows, n)}: ms " + "; ".join(
            f"{n_} {ms!r}" for n_, ms in row.items()), flush=True)
        del x
    return 0


if __name__ == "__main__":
    sys.exit(main())
