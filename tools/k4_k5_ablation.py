#!/usr/bin/env python3
"""What each design choice of K5 (slot compaction, the value instance of
the look-back kernel) and K4 (Q_r rounding, drawing its uniforms with
threefry) is worth on the card: timings with one choice changed or one
part taken out at a time.

    python3 tools/k4_k5_ablation.py

Needs one CUDA card and ``nvcc``.  Builds variants of
``src/repro_torch/kernels/csrc/select_slots.cu`` and ``quantize.cu`` into
``src/repro_torch/kernels/_build/ablation/`` (the outputs of a variant
marked "wrong" are wrong by design; only its time means something):

* K5: ``as built`` (one 4096-element tile a block, six blocks an SM,
  4-byte stores of the staged run); ``16-byte copy-out`` (int4 stores
  between a scalar head and tail); four blocks an SM (K6's occupancy, so
  K6's scheme with a value payload), with either copy-out; five blocks an
  SM;
* K4: the keyed entry as built, the memory entry (reads u), and ``keyed,
  no threefry`` (wrong: u is a constant, so what is left is the loads, the
  rounding and the stores).

Prints each variant's registers and spills (``-Xptxas -v``).  Times each
with CUDA events through the wrapper, in turns (each variant twice, in
order and then in reverse; the minimum is printed), and K5 also by its
device time a call under ``torch.profiler``: K5 at (5,
50176) and (4, 2^24) with k = cap = 0.3 n (the packed ``topk`` codec's
cap), K4 at the same shapes with r = 8 and host keys.  Prints the keyed
kernel's integer instructions an element from its SASS, the card's max SM
clock and the INT32 peak it gives (132 SMs x 64 lanes x clock), and the
card's name and power limit.  The keyed K4's bound counts the uniform's
own operations (43 an element that only the ALU pipe runs, 31 adds that
either integer pipe runs); the SASS's count is printed beside it as a
diagnostic.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# variant -> -D flags for select_slots.cu (K5)
K5_VARIANTS = {"as built": [], "16-byte copy-out": ["-DABL_WIDE=1"],
               "four blocks an SM": ["-DABL_BLOCKS=4"],
               "four blocks, 16-byte copy-out": ["-DABL_BLOCKS=4",
                                                 "-DABL_WIDE=1"],
               "five blocks an SM": ["-DABL_BLOCKS=5"]}
# the 16-byte copy-out: for each array, a scalar head up to its 16-byte
# boundary, int4 stores, a scalar tail
WIDE_COPY = """  if (ABL_WIDE) {
    auto wide = [&](int* dst, const int* src) {
      unsigned head = (unsigned)((16u - ((uintptr_t)dst & 15u)) & 15u) >> 2;
      head = head < m ? head : m;
      const unsigned body = (m - head) >> 2;
      if ((unsigned)tid < head) dst[tid] = src[tid];
      int4* d4 = reinterpret_cast<int4*>(dst + head);
      for (unsigned j = tid; j < body; j += kLbThreads) {
        const int* s = src + head + 4 * j;
        d4[j] = make_int4(s[0], s[1], s[2], s[3]);
      }
      for (unsigned i = head + 4 * body + tid; i < m; i += kLbThreads)
        dst[i] = src[i];
    };
    wide(ir + prefix, s_idx);
    wide(wr + prefix, s_word);
  } else
"""
K5_HOOKS = [(r"constexpr int kValueBlocksPerSm = (\d+);", "ABL_BLOCKS",
             "constexpr int kValueBlocksPerSm = ABL_BLOCKS;"),
            (r"()(?=  for \(unsigned i = tid; i < m; i \+= kLbThreads\) \{\n"
             r"    ir\[prefix \+ i\])", "ABL_WIDE", WIDE_COPY)]
# variant -> -D flags for quantize.cu (K4)
K4_VARIANTS = {"as built": [], "keyed, no threefry": ["-DABL_NO_THREEFRY=1"]}
K4_HOOKS = [(r"uv\[e\] = threefry_uniform\(ks, \(uint32_t\)\(e0 \+ e\)\);()",
             "ABL_NO_THREEFRY",
             "uv[e] = ABL_NO_THREEFRY ? 0.5f : threefry_uniform(ks, (uint32_t)(e0 + e));")]


def build_variants(build, name: str, hooks, variants) -> dict:
    """Each variant of csrc/<name>.cu, built with its -D flags; the hooks
    turn the source's constants into macros defaulting to their values."""
    src = (build.CSRC / f"{name}.cu").read_text()
    prelude = ""
    for pattern, macro, repl in hooks:
        m = re.search(pattern, src)
        if m is None:
            raise RuntimeError(f"hook not found in {name}.cu: {pattern!r}")
        prelude += f"#ifndef {macro}\n#define {macro} {m.group(1) or 0}\n#endif\n"
        src = src[:m.start()] + repl + src[m.end():]
    src = src.replace("namespace {\n", prelude + "namespace {\n", 1)
    out = build.build_dir() / "ablation"
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{name}_k4_k5.cu"
    path.write_text(src)
    nvcc = build.nvcc_path()
    procs = {v: subprocess.Popen(
        [nvcc, *build._flags(name), f"-I{build.CSRC}", *flags, "-o",
         str(out / f"lib{name}_k4_k5_{i}.so"), str(path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i, (v, flags) in enumerate(variants.items())}
    libs = {}
    for i, (v, proc) in enumerate(procs.items()):
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode:
            raise build.BuildError(f"{name} {v}: {log}")
        libs[v] = ctypes.CDLL(str(out / f"lib{name}_k4_k5_{i}.so"))
        kernel = None
        for line in log.splitlines():      # -Xptxas=-v: registers, spills
            if "Function properties for" in line:
                kernel = line.split("for", 1)[1].strip()
            elif kernel and ("slots_lookbackILb0" in kernel
                             or "qr_roundILb1ELb1" in kernel) and (
                                 "Used" in line or "spill" in line):
                print(f"[ablation] ptxas {name} {v} {kernel[-48:]}: "
                      f"{line.split(':', 1)[-1].strip()}", flush=True)
    return libs


def device_ms(torch, fn, calls: int):
    """Device ms a call of ``fn`` (its kernels, copies and memsets) under
    ``torch.profiler``; None where it recorded no device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return (sum(e.time_range.elapsed_us() for e in evs) / 1e3 / calls
            if evs else None)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k4_k5_ablation: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import prng
    from repro_torch.kernels import build
    from repro_torch.kernels import quantize as qk
    from repro_torch.kernels import select_slots as sk
    from repro_torch.kernels import topk_compress as tk

    k5_libs = build_variants(build, "select_slots", K5_HOOKS, K5_VARIANTS)
    k4_libs = build_variants(build, "quantize", K4_HOOKS, K4_VARIANTS)
    for lib in k5_libs.values():
        sk._bind(lib)
    for lib in k4_libs.values():
        qk._bind(lib)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    print(f"card: {card}; max SM clock {clock_mhz!r} MHz", flush=True)
    ints = build.sass_counts("quantize", build.INT_OPCODES,
                             match=("qr_round", "ILb1ELb1E"))
    sass_elem = sum(ints.values()) / 4
    # the uniform's own work: rotates and xors (and the bits' xor, shift,
    # or) only on the ALU pipe, adds on it or as IMAD on the FMA pipe
    alu_ops, adds = 20 + 20 + 3, 20 + 2 * 5 + 1
    pipe_ops = max(alu_ops, (alu_ops + adds) / 2)
    int_peak = 132 * 64 * clock_mhz * 1e6
    print(f"[ablation] K4 keyed: {pipe_ops!r} operations an element on the "
          f"busier integer pipe (the function's count); diagnostic: float4 "
          f"instance SASS integer instructions {ints!r}, {sass_elem!r} an "
          f"element; INT32 peak {int_peak!r} operations/s a pipe", flush=True)
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

    def in_turns(plans, iters):
        row = {name: [] for name in plans}
        for name in list(plans) + list(plans)[::-1]:
            row[name].append(plans[name](iters))
        return "; ".join(f"{n_} {min(ms)!r}" for n_, ms in row.items())

    for rows, n, iters in ((5, 50176, 500), (4, 1 << 24, 20)):
        x = torch.randn((rows, n), generator=gen, device=dev)
        k = int(0.3 * n)
        t = tk.threshold_bits(x, k)

        def k5(lib):
            def run(iters_):
                sk._lib = lambda: lib
                return time_ms(lambda: sk.compact_slots(x, t, k), iters_)
            return run

        print(f"[ablation] K5 {(rows, n)} cap={k}: ms (min of 2) "
              + in_turns({v: k5(lib) for v, lib in k5_libs.items()}, iters),
              flush=True)
        dev_ms = {}
        for v, lib in k5_libs.items():
            sk._lib = lambda lib=lib: lib
            dev_ms[v] = device_ms(torch, lambda: sk.compact_slots(x, t, k), 20)
        print(f"[ablation] K5 {(rows, n)}: device ms a call (torch.profiler) "
              + "; ".join(f"{v} {ms!r}" for v, ms in dev_ms.items()),
              flush=True)
        keys = prng.split(prng.PRNGKey(5), rows)
        norm = qk.l2_norm(x)
        u = prng.uniform(keys, n, device=dev)

        def k4(lib, keyed):
            def run(iters_):
                qk._lib = lambda: lib
                fn = ((lambda: qk.quantize_qr_keyed(x, 8, keys, norm)) if keyed
                      else (lambda: qk.quantize_qr_with_uniforms(x, 8, u, norm)))
                return time_ms(fn, iters_)
            return run

        print(f"[ablation] K4 {(rows, n)} r=8: ms (min of 2) " + in_turns({
            "keyed": k4(k4_libs["as built"], True),
            "memory u": k4(k4_libs["as built"], False),
            "keyed, no threefry": k4(k4_libs["keyed, no threefry"], True)},
            iters), flush=True)
        nx = rows * n
        t_bytes = 8 * nx / 3.35e12 * 1e3
        t_ops = pipe_ops * nx / int_peak * 1e3
        t_sass = sass_elem * nx / int_peak * 1e3
        print(f"[ablation] K4 keyed {(rows, n)} bound: bytes {t_bytes!r} ms "
              f"(8n), integer operations {t_ops!r} ms (busier pipe; "
              f"diagnostic: the SASS's all on one pipe {t_sass!r})",
              flush=True)
        del x, u
    return 0


if __name__ == "__main__":
    sys.exit(main())
