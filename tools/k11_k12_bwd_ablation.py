#!/usr/bin/env python3
"""What the redesigns of K11's and K12's backward kernels are worth on the
card: each beside the kernel it replaced and beside the design choices
tried, with one choice changed at a time, then both models' train steps
with the parent's kernels and this checkout's, in turns.

    python3 tools/k11_k12_bwd_ablation.py [--parent DIR] [--no-steps]

Needs one CUDA card and ``nvcc``.  ``--parent`` is the root of another
checkout (the parent commit unpacked with ``git archive``, say): its
``wkv6_bwd.cu`` (K12's backward as one 256-thread block a head, SIMT
float32, checkpoints every 8 steps, float32 gradients cast by the
wrapper) and ``rglru_scan.cu`` (K11's backward as two-warp blocks, 16-step
register batches) are built and timed in turns with this checkout's.
Builds into ``src/repro_torch/kernels/_build/ablation/``:

* K12's backward, bf16 route (``csrc/wkv6_bwd.cu``): ``as built`` (the
  state passes with 32 value columns a block and a 2-deep cp.async ring,
  the chunk-gradient kernel; L = 16 steps a chunk), the passes at 8 or 16
  columns a block, the ring 3 or 4 deep, the state stores evict-first,
  the chunk kernel's per-channel sums one key step a pass or at 3 blocks
  an SM (80 registers), and with parts cut out (the state stores, the
  passes' decay chains, the chunk kernel's S and G loads, its products,
  its per-channel sums, its A, its P, Q and rowsum, its gradient stores,
  all of it but the loads: timed, and each kernel's device time printed);
  at (2, 40, 4096, 64) and (32, 40, 4096, 64).  Every variant but the cut ones is held to the plain version
  run in float64 at the main shape (``K12_BWD_TOL``).  The chunk length
  is fixed at 16 (the chunk kernel's thread layout is built for it).
* K11's backward (``csrc/rglru_scan.cu``): ``as built`` (one-warp blocks,
  8 channels a warp up to 12 warps of 32 channels an SM, 32 channels past
  it, a 4-deep ring), with the few-warps choice at 16 or 32 channels a
  warp, the many-warps choice at 8 or 16, and the ring 2 or 3 deep; at (2, 4096, 2560), (1, 4096,
  2560) and (32, 4096, 2560).  Every variant is held bit-equal to the
  plain version at each shape.
* rwkv6-3b's and recurrentgemma-2b's Adam step at full width and depth
  (bf16, batch 2, seq 4096), with the parent's backward kernel and with
  this checkout's, in turns (parent, this, this, parent; a warm-up step
  and two timed steps each): ms a step, peak memory, the losses (equal
  within the K12 tolerance's effect: printed, not held).

Times each kernel with CUDA events, in turns (each variant twice, in order
and then in reverse; the minimum is printed), with the wrapper.  Prints
each variant's registers and spills (``-Xptxas -v``) and the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

# Each hook is (text as built, text with a macro); the macros default to
# the built values.  csrc/wkv6_bwd.cu: ABL_PASS_COLS, ABL_STAGES, ABL_S_PASS
# and ABL_GRAD_BLOCKS its design's choices; ABL_CS the state stores
# evict-first; ABL_CUT parts cut out (the gradients are then wrong, so
# those variants are timed only): bit 1 the state stores, 2 the passes'
# decay chains, 4 the chunk kernel's S and G loads, 8 its tensor-core
# products, 16 its per-channel sums, 32 its A, 64 its P, Q and rowsum(G *
# S), 128 its gradient stores.
K12_HOOKS = [
    ("constexpr int kPassCols = 32;", "constexpr int kPassCols = ABL_PASS_COLS;"),
    ("constexpr int kStages = 2;", "constexpr int kStages = ABL_STAGES;"),
    ("constexpr int kSPass = 2;", "constexpr int kSPass = ABL_S_PASS;"),
    ("constexpr int kGradBlocks = 2;",
     "constexpr int kGradBlocks = ABL_GRAD_BLOCKS;"),
    ("    for (int nt = 0; nt < kPassNt; ++nt) {\n      const bool odd",
     "    for (int nt = 0; nt < (ABL_CUT & 1 ? 0 : kPassNt); ++nt) {\n"
     "      const bool odd"),
    ("        if (e / (kL / 2) == half) {",
     "        if (e / (kL / 2) == half && !(ABL_CUT & 2)) {"),
    ("        p *= t < tc ? sm.w[slot][t][i] : 1.0f;",
     "        if (!(ABL_CUT & 2)) p *= t < tc ? sm.w[slot][t][i] : 1.0f;"),
    ("e < 2 * kHead * 16; e += kGradThreads",
     "e < (ABL_CUT & 4 ? 0 : 2 * kHead * 16); e += kGradThreads"),
    ("  float dvo[4];\n  {",
     "  float dvo[4] = {0.0f, 0.0f, 0.0f, 0.0f};\n  if (!(ABL_CUT & 8)) {"),
    ("  if (warp < kL / 8) {", "  if (warp < kL / 8 && !(ABL_CUT & 8)) {"),
    ("float adr[kL], adw[kL], dk_in[4];",
     "float adr[kL], adw[kL], dk_in[4] = {0.0f, 0.0f, 0.0f, 0.0f};"),
    ("part < 4 / kSPass;", "part < (ABL_CUT & 16 ? 0 : 4 / kSPass);"),
    ("  chunk_a<kBLd>(", "  if (!(ABL_CUT & 32)) chunk_a<kBLd>("),
    ("  if (tid < 2 * kHead) {", "  if (tid < 2 * kHead && !(ABL_CUT & 64)) {"),
    ("m < kHead / 4; ++m)\n    gs = fmaf(",
     "m < (ABL_CUT & 64 ? 0 : kHead / 4); ++m)\n    gs = fmaf("),
    ("e < 3 * kL * 8; e += kGradThreads",
     "e < (ABL_CUT & 128 ? 0 : 3 * kL * 8); e += kGradThreads"),
    ("    if (row < tc)\n      *reinterpret_cast<float4*>(dw",
     "    if (row < tc && !(ABL_CUT & 128))\n      *reinterpret_cast<float4*>(dw"),
    ('  asm volatile("st.global.v4.f32 [%0]',
     '  if (ABL_CS) asm volatile("st.global.cs.v4.f32 [%0], {%1, %2, %3, %4};\\n" '
     '::"l"(p), "f"(a), "f"(b), "f"(c), "f"(d));\n  else asm volatile('
     '"st.global.v4.f32 [%0]'),
]
K12_MACROS = {"ABL_PASS_COLS": 32, "ABL_STAGES": 2, "ABL_S_PASS": 2,
              "ABL_GRAD_BLOCKS": 2, "ABL_CUT": 0, "ABL_CS": 0}
K12_VARIANTS = {
    "as built": [],
    "chunks: 1 key step a pass": ["-DABL_S_PASS=1"],
    "chunks: 3 blocks an SM": ["-DABL_GRAD_BLOCKS=3"],
    "pass 8 columns": ["-DABL_PASS_COLS=8"],
    "pass 16 columns": ["-DABL_PASS_COLS=16"],
    "ring 3 deep": ["-DABL_STAGES=3"],
    "ring 4 deep": ["-DABL_STAGES=4"],
    "state stores evict-first": ["-DABL_CS=1"],
    "cut: state stores": ["-DABL_CUT=1"],
    "cut: pass decay chains": ["-DABL_CUT=2"],
    "cut: chunk S, G loads": ["-DABL_CUT=4"],
    "cut: chunk products": ["-DABL_CUT=8"],
    "cut: chunk channel sums": ["-DABL_CUT=16"],
    "cut: chunk A": ["-DABL_CUT=32"],
    "cut: chunk P, Q, rowsum": ["-DABL_CUT=64"],
    "cut: chunk gradient stores": ["-DABL_CUT=128"],
    "cut: chunk all but loads": ["-DABL_CUT=248"]}
# csrc/rglru_scan.cu: K11's backward's channels a warp up to 12 warps of
# 32 channels an SM and past it, and its ring depth
K11_HOOKS = [
    ("constexpr int kBwdFewC = 8;", "constexpr int kBwdFewC = ABL_FEW_C;"),
    ("constexpr int kBwdManyC = 32;", "constexpr int kBwdManyC = ABL_MANY_C;"),
    ("constexpr int kBwdDepth = 4;", "constexpr int kBwdDepth = ABL_DEPTH;"),
]
K11_MACROS = {"ABL_FEW_C": 8, "ABL_MANY_C": 32, "ABL_DEPTH": 4}
K11_VARIANTS = {
    "as built": [],
    "few: 16 channels a warp": ["-DABL_FEW_C=16"],
    "few: 32 channels a warp": ["-DABL_FEW_C=32"],
    "many: 8 channels a warp": ["-DABL_MANY_C=8"],
    "many: 16 channels a warp": ["-DABL_MANY_C=16"],
    "ring 2 deep": ["-DABL_DEPTH=2"],
    "ring 3 deep": ["-DABL_DEPTH=3"]}
K12_MAIN, K12_LARGE = (2, 40, 4096), (32, 40, 4096)
K11_SHAPES = ((2, 4096, 2560), (1, 4096, 2560), (32, 4096, 2560))
K12_BWD_TOL = 1e-4


def compile_variants(build, name: str, csrc: Path, variants: dict,
                     tag: str, hooks=(), macros=None) -> dict:
    """Builds ``csrc/<name>.cu`` once a variant (its -D flags, the source's
    own nvcc flags), all in parallel, after replacing each hook's text
    (``macros``: their defaults); prints what -Xptxas -v said of each
    backward kernel; returns {variant: library}."""
    out = build.build_dir() / "ablation"
    out.mkdir(parents=True, exist_ok=True)
    src = (csrc / f"{name}.cu").read_text()
    for old, new in hooks:
        if src.count(old) != 1:
            raise RuntimeError(f"hook not found once in {name}.cu: {old!r}")
        src = src.replace(old, new)
    prelude = "".join(f"#ifndef {m}\n#define {m} {d}\n#endif\n"
                      for m, d in (macros or {}).items())
    path = out / f"{name}_{tag}.cu"
    path.write_text(prelude + src)
    procs = {v: subprocess.Popen(
        [build.nvcc_path(), *build._flags(name), f"-I{csrc}", *flags, "-o",
         str(out / f"lib{name}_{tag}_{i}.so"), str(path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i, (v, flags) in enumerate(variants.items())}
    libs = {}
    for i, (v, proc) in enumerate(procs.items()):
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode:
            raise build.BuildError(f"{name} {v}: {log}")
        libs[v] = ctypes.CDLL(str(out / f"lib{name}_{tag}_{i}.so"))
        kernel = None
        for line in log.splitlines():
            if "Function properties for" in line:
                kernel = line.split("for", 1)[1].strip()
            elif kernel and ("Used" in line or "spill" in line) and (
                    "back" in kernel or "bwd" in kernel):
                print(f"[ablation] ptxas {name} {tag} {v} {kernel[-60:]}: "
                      f"{line.split(':', 1)[-1].strip()}", flush=True)
    return libs


def parent_wkv6_bwd(torch, lib, r, k, v, w, u, dy):
    """The parent's K12 backward wrapper over its C entry (one kernel,
    float32 gradients cast to r's dtype)."""
    P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.wkv6_scan_bwd.argtypes = ([P] * 6 + [I] * 3 + [LL] * 6 + [I]
                                  + [LL] * 3 + [P] * 7)
    lib.wkv6_scan_bwd.restype = I
    lib.wkv6_bwd_ckpt_floats.argtypes = [I]
    lib.wkv6_bwd_ckpt_floats.restype = LL
    b, h, t, _ = r.shape
    f32 = dict(dtype=torch.float32, device=r.device)
    grads = [torch.empty((b, t, h, 64), **f32).transpose(1, 2)
             for _ in range(4)]
    du_part = torch.empty((b, h, 64), **f32)
    ckpt = torch.empty((b * h, lib.wkv6_bwd_ckpt_floats(t)), **f32)
    ptr = [P(z.data_ptr()) for z in (r, k, v, w, u, dy)]
    code = lib.wkv6_scan_bwd(
        *ptr, b, h, t, *r.stride()[:3], *dy.stride()[:3],
        int(r.dtype == torch.bfloat16), *grads[0].stride()[:3],
        *(P(g.data_ptr()) for g in grads), P(du_part.data_ptr()),
        P(ckpt.data_ptr()),
        P(torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())))
    if code:
        raise RuntimeError(f"parent wkv6_scan_bwd: CUDA error {code}")
    dr, dk, dv, dw = grads
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw,
            du_part.sum(0))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None,
                    help="root of the checkout whose kernels are compared")
    ap.add_argument("--no-steps", action="store_true",
                    help="skip the train steps")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("k11_k12_bwd_ablation: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import wkv6
    from repro_torch.models import rwkv6

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    k12 = compile_variants(build, "wkv6_bwd", build.CSRC, K12_VARIANTS,
                           "this", K12_HOOKS, K12_MACROS)
    k11 = compile_variants(build, "rglru_scan", build.CSRC, K11_VARIANTS,
                           "this", K11_HOOKS, K11_MACROS)
    parent = {}
    if args.parent:
        csrc = Path(args.parent).resolve() / "src/repro_torch/kernels/csrc"
        parent["wkv6_bwd"] = compile_variants(
            build, "wkv6_bwd", csrc, {"parent": []}, "parent")["parent"]
        parent["rglru_scan"] = compile_variants(
            build, "rglru_scan", csrc, {"parent": []}, "parent")["parent"]
    for lib in k12.values():
        wkv6._bind_bwd(lib)
    for lib in [*k11.values()] + ([parent["rglru_scan"]] if parent else []):
        rg._bind(lib)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def time_ms(fn, iters):
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

    def by_kernel(label, fn, calls=5):
        """Device ms a call of ``fn`` by kernel name (torch.profiler)."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        ms = {}
        for ev in prof.events():
            if ev.device_type == DeviceType.CUDA:
                name = ev.name[:60]
                ms[name] = ms.get(name, 0.0) + ev.time_range.elapsed_us() / 1e3
        print(f"[ablation] {label}: device ms a call by kernel " + "; ".join(
            f"{n_} {t / calls!r}" for n_, t in sorted(
                ms.items(), key=lambda kv: -kv[1])), flush=True)

    def with_lib(module, attr, lib, fn):
        """``fn`` with ``module.<attr>`` (its library getter) giving
        ``lib``."""
        def run():
            saved = getattr(module, attr)
            setattr(module, attr, lambda: lib)
            try:
                return fn()
            finally:
                setattr(module, attr, saved)
        return run

    # ---- K12's backward ------------------------------------------------ #
    def wkv6_inputs(b, h, t):
        shape = (b, t, h * 64)
        r, k, v = (0.5 * torch.randn(shape, generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        w = torch.rand(shape, generator=gen, device=dev)
        u = 0.1 * torch.randn((h, 64), generator=gen, device=dev)
        dy = torch.randn((b, t, h, 64), generator=gen,
                         device=dev).to(torch.bfloat16)
        r, k, v, w = (rwkv6._heads(z, 64) for z in (r, k, v, w))
        return r, k, v, w, u, dy.transpose(1, 2)

    for shape, iters in ((K12_MAIN, 10), (K12_LARGE, 3)):
        ins = wkv6_inputs(*shape)
        plans = {v: with_lib(wkv6, "_lib_bwd", lib,
                             lambda: wkv6.wkv6_scan_bwd(*ins))
                 for v, lib in k12.items()}
        if parent:
            plans["parent"] = lambda: parent_wkv6_bwd(
                torch, parent["wkv6_bwd"], *ins)
        if shape == K12_MAIN:
            want = ref.wkv6_scan_bwd(*(z.double() for z in ins),
                                     dtype=torch.float64)
            for v, fn in plans.items():
                if v.startswith("cut"):
                    continue
                worst = 0.0
                for g, w_ in zip(fn(), want):
                    tol = K12_BWD_TOL * float(w_.abs().max())
                    if g.dtype == torch.bfloat16:
                        _, e = torch.frexp(w_.float())
                        tol = tol + torch.ldexp(torch.ones_like(w_), e - 8)
                    worst = max(worst, float(((g.double() - w_).abs()
                                              / tol).max()))
                if worst > 1.0:
                    raise AssertionError(f"K12 backward {v}: |d| / tol "
                                         f"{worst!r}")
                print(f"[ablation] K12 backward {v} {shape}: within "
                      f"{K12_BWD_TOL} max |plain in float64| (worst |d| / "
                      f"tol {worst!r})", flush=True)
            del want
        n = shape[0] * shape[1] * shape[2] * 64
        print(f"[ablation] K12 backward {shape}: bound "
              f"{22 * n / 3.35e9!r} ms (bytes: bf16 r, k, v, dy and f32 w "
              f"in, bf16 dr, dk, dv and f32 dw out)", flush=True)
        report(f"K12 backward {shape}", plans, iters)
        for v in ("as built", *(v for v in plans if v.startswith("cut"))):
            by_kernel(f"K12 backward {v} {shape}", plans[v])
        del ins, plans
        torch.cuda.empty_cache()

    # ---- K11's backward ------------------------------------------------ #
    libs11 = dict(k11)
    if parent:
        libs11["parent"] = parent["rglru_scan"]
    for (b, t, d) in K11_SHAPES:
        x = torch.randn((b, t, d), generator=gen, device=dev)
        a = torch.rand((b, t, d), generator=gen, device=dev)
        y, _ = rg.rglru_scan(x, a)
        dy = torch.randn((b, t, d), generator=gen, device=dev)
        want = ref.rglru_scan_bwd(x, a, y, dy)
        plans = {v: with_lib(rg, "_lib", lib,
                             lambda: rg.rglru_scan_bwd(x, a, y, dy))
                 for v, lib in libs11.items()}
        for v, fn in plans.items():
            got = fn()
            torch.cuda.synchronize()
            if not all(torch.equal(g.view(torch.int32), w_.view(torch.int32))
                       for g, w_ in zip(got, want)):
                raise AssertionError(f"K11 backward {v} {(b, t, d)}: "
                                     f"differs from the plain version")
        del got, want
        print(f"[ablation] K11 backward {(b, t, d)}: every variant "
              f"bit-equal; bound {24 * b * t * d / 3.35e9!r} ms (bytes)",
              flush=True)
        report(f"K11 backward {(b, t, d)}", plans, 20 if b < 32 else 5)
        by_kernel(f"K11 backward as built {(b, t, d)}", plans["as built"])
        del x, a, y, dy, plans
        torch.cuda.empty_cache()

    if parent and not args.no_steps:
        train_steps(torch, rg, wkv6, parent, with_lib)
    return 0


def train_steps(torch, rg, wkv6, parent, with_lib) -> None:
    """Both models' Adam step with the parent's backward kernel and this
    checkout's, in turns."""
    from repro_torch.configs import get_spec
    from repro_torch.configs.base import InputShape
    from repro_torch.data import synthetic
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import optimizers

    dev = torch.device("cuda")
    mine = wkv6.wkv6_scan_bwd
    kernels = {
        "rwkv6-3b": {
            "parent": lambda: setattr(wkv6, "wkv6_scan_bwd",
                                      lambda *a: parent_wkv6_bwd(
                                          torch, parent["wkv6_bwd"], *a)),
            "this": lambda: setattr(wkv6, "wkv6_scan_bwd", mine)},
        "recurrentgemma-2b": {
            "parent": lambda: setattr(rg, "_lib",
                                      lambda: parent["rglru_scan"]),
            "this": lambda: setattr(rg, "_lib", saved_rg)}}
    saved_rg = rg._lib
    for arch, use in kernels.items():
        spec = get_spec(arch)
        m = spec.model
        bundle = steps.build_train_step(spec, InputShape("t", 4096, 2,
                                                         "train"))
        toks = torch.from_numpy(synthetic.make_lm_tokens(
            min(m.vocab, 4096), 2, 4096, seed=0)).to(dev, torch.int64)
        for who in ("parent", "this", "this", "parent"):
            use[who]()
            params = tfm.init_params(m, torch.Generator(device=dev)
                                     .manual_seed(0))
            opt_state = optimizers.make(*steps._optimizer_for(spec))[0](
                params)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            losses, ms = [], []
            for _ in range(3):
                t0 = time.perf_counter()
                params, opt_state, loss = bundle.fn(params, opt_state,
                                                    {"tokens": toks})
                losses.append(float(loss))
                ms.append((time.perf_counter() - t0) * 1e3)
            print(f"[ablation] train step {arch} with {who}'s backward: ms "
                  f"a step {ms!r} (the first warms up), losses {losses!r}, "
                  f"peak {torch.cuda.max_memory_allocated()} B", flush=True)
            del params, opt_state
            torch.cuda.empty_cache()
        kernels[arch]["this"]()
        del bundle


if __name__ == "__main__":
    sys.exit(main())
