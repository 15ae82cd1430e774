#!/usr/bin/env python3
"""What bounds K10's bf16 (wgmma) kernel on the card: timings of the kernel
with one part taken out at a time.

    python3 tools/k10_ablation.py

Needs one CUDA card and ``nvcc``.  Builds variants of
``src/repro_torch/kernels/csrc/flash_attention_sm90.cu`` into
``src/repro_torch/kernels/_build/ablation/``, each with one of these
removed (the outputs of a variant are wrong by design; only its time
means something):

* ``no_s``: the S = Q K^T wgmmas;
* ``no_pv``: the O += P V wgmmas;
* ``no_softmax``: scale, softcap, mask and the online softmax;
* ``no_load``: the K and V TMA loads (the ring still turns);
* ``fast_tanh``: tanhf replaced by an ex2-based tanh (not taken: it moves
  the softcap's rounding);
* ``gemms_only``: no softmax and no loads.

Times each, and the kernel as built, with CUDA events at gemma2-9b's attn
layer with and without its softcap and at qwen2-7b's layer shape (bf16,
batch 4, T 4608), and prints the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SHAPES = [("gemma2-9b attn, softcap 50", (4, 16, 8, 4608, 4608, 256),
           dict(causal=True, softcap=50.0)),
          ("gemma2-9b attn, no softcap", (4, 16, 8, 4608, 4608, 256),
           dict(causal=True)),
          ("qwen2-7b layer", (4, 28, 4, 4608, 4608, 128),
           dict(causal=True))]
VARIANTS = {"as built": [], "no_s": ["-DABL_NO_S"],
            "no_pv": ["-DABL_NO_PV"], "no_softmax": ["-DABL_NO_SOFTMAX"],
            "no_load": ["-DABL_NO_LOAD"], "fast_tanh": ["-DABL_FAST_TANH"],
            "gemms_only": ["-DABL_NO_SOFTMAX", "-DABL_NO_LOAD"]}
# (text of the kernel source, its replacement with an ablation switch)
HOOKS = [
    ("wgmma_ss_n64_first(s, da, db);", "ABL_S(wgmma_ss_n64_first(s, da, db));"),
    ("wgmma_ss_n64(s, da, db);", "ABL_S(wgmma_ss_n64(s, da, db));"),
    ("wgmma_ss_n128_first(s, da, db);",
     "ABL_S(wgmma_ss_n128_first(s, da, db));"),
    ("wgmma_ss_n128(s, da, db);", "ABL_S(wgmma_ss_n128(s, da, db));"),
    ("wgmma_rs<DH>(o, pa[kk], db);", "ABL_PV(wgmma_rs<DH>(o, pa[kk], db));"),
    ("    auto softmax_tile = [&](int tile, float (&corr)[2]) {\n",
     "    auto softmax_tile = [&](int tile, float (&corr)[2]) {\n"
     "#ifdef ABL_NO_SOFTMAX\n"
     "      corr[0] = corr[1] = 1.0f; l[0] = l[1] = 1.0f; return;\n"
     "#endif\n"),
    ("        mbar_expect_tx(k_full + 8 * st, C::kKVBytes);\n",
     "#ifdef ABL_NO_LOAD\n"
     "        mbar_expect_tx(k_full + 8 * st, 0);\n"
     "        mbar_wait(v_free + 8 * st, free_ph);\n"
     "        mbar_expect_tx(v_full + 8 * st, 0);\n"
     "        continue;\n"
     "#endif\n"
     "        mbar_expect_tx(k_full + 8 * st, C::kKVBytes);\n"),
    ("if constexpr (kCap) x = tanhf((x * scale) * inv_cap);",
     "if constexpr (kCap) x = ABL_TANH((x * scale) * inv_cap);"),
]
PRELUDE = """
#ifdef ABL_NO_S
#define ABL_S(call)
#else
#define ABL_S(call) call
#endif
#ifdef ABL_NO_PV
#define ABL_PV(call)
#else
#define ABL_PV(call) call
#endif
#ifdef ABL_FAST_TANH
#define ABL_TANH(y) copysignf(1.0f - __fdividef(2.0f, \\
    ex2(2.8853900817779268f * fabsf(y)) + 1.0f), (y))
#else
#define ABL_TANH(y) tanhf(y)
#endif
"""


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k10_ablation: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa

    src = (build.CSRC / "flash_attention_sm90.cu").read_text()
    for old, new in HOOKS:
        if old not in src:
            raise RuntimeError(f"hook not found in the kernel source: {old!r}")
        src = src.replace(old, new)
    anchor = "namespace {\n"
    src = src.replace(anchor, PRELUDE + anchor, 1)
    out = build.build_dir() / "ablation"
    out.mkdir(parents=True, exist_ok=True)
    (out / "fa_ablation.cu").write_text(src)
    nvcc = build.nvcc_path()
    procs = {name: subprocess.Popen(
        [nvcc, *build.COMMON_FLAGS, *flags, "-o", str(out / f"lib_{i}.so"),
         str(out / "fa_ablation.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for i, (name, flags) in
        enumerate(VARIANTS.items())}
    libs = {}
    for i, (name, proc) in enumerate(procs.items()):
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode:
            raise build.BuildError(f"{name}: {log}")
        lib = ctypes.CDLL(str(out / f"lib_{i}.so"))
        fa._bind_sm90(lib)
        libs[name] = lib

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def time_ms(fn, iters=5):
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

    for label, (b, hq, hkv, tq, tk, dh), kw in SHAPES:
        q = torch.randn((b, hq, tq, dh), generator=gen, device=dev)
        k, v = (torch.randn((b, hkv, tk, dh), generator=gen, device=dev)
                for _ in range(2))
        q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
        row = {}
        for name, lib in libs.items():
            fa._lib_sm90 = lambda lib=lib: lib
            row[name] = time_ms(lambda: fa.flash_attention(q, k, v, **kw))
        print(f"[ablation] {label} {(b, hq, hkv, tq, tk, dh)} {kw}: ms "
              + "; ".join(f"{n} {t!r}" for n, t in row.items()), flush=True)
        del q, k, v
    return 0


if __name__ == "__main__":
    sys.exit(main())
