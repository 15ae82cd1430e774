#!/usr/bin/env python3
"""Where a training step's time goes on the card: one steady Adam step of
each recurrent model at full width and depth, under ``torch.profiler``.

    python3 tools/train_step_profile.py [--arch rwkv6-3b] [--seq 4096]

For each model (bf16, ``steps.build_train_step``, batch 2, ``train_4k``'s
seq 4096 unless given): two warm-up steps, then one profiled step.
Prints the step's wall ms, the device's busy ms (the device events' time,
one stream) and idle share, and device ms by group (:func:`group`), the
top ``--top`` of them.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
ARCHS = ("rwkv6-3b", "recurrentgemma-2b")
SCAN_KERNELS = ("rglru_slabs", "rglru_back", "wkv6_fwd", "wkv6_chunked_bf16",
                "wkv6_back", "wkv6_bwd_states", "wkv6_bwd_chunks")


def group(name: str) -> str:
    """The scans' kernels by name; cuBLAS's bf16 GEMMs (``nvjet``), its
    other GEMMs (the float32 ones: the chunked loss's unembed), PyTorch's
    elementwise and copy kernels, its reductions; the rest by name."""
    for k in SCAN_KERNELS:
        if k in name:
            return k
    low = name.lower()
    if low.startswith("nvjet"):
        return "GEMM, cuBLAS nvjet (bf16)"
    if "gemm" in low or "cutlass" in low or "xmma" in low:
        return "GEMM, cuBLAS other (float32)"
    if "elementwise_kernel" in low or "copy_kernel" in low:
        return "elementwise and copies (PyTorch)"
    if "reduce_kernel" in low or "softmax" in low:
        return "reductions and softmax (PyTorch)"
    return name[:90]


def profile_step(torch, arch: str, seq: int, top: int) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_spec
    from repro_torch.configs.base import InputShape
    from repro_torch.data import synthetic
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import optimizers

    dev = torch.device("cuda")
    spec = get_spec(arch)
    m = spec.model
    bundle = steps.build_train_step(spec, InputShape("t", seq, 2, "train"))
    params = tfm.init_params(m, torch.Generator(device=dev).manual_seed(0))
    opt_state = optimizers.make(*steps._optimizer_for(spec))[0](params)
    toks = torch.from_numpy(synthetic.make_lm_tokens(
        min(m.vocab, 4096), 2, seq, seed=0)).to(dev, torch.int64)
    for _ in range(2):
        params, opt_state, loss = bundle.fn(params, opt_state,
                                            {"tokens": toks})
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt_state, loss = bundle.fn(params, opt_state,
                                            {"tokens": toks})
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_group, busy, n = {}, 0.0, 0
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            ms = ev.time_range.elapsed_us() / 1e3
            g = group(ev.name)
            by_group[g] = by_group.get(g, 0.0) + ms
            busy += ms
            n += 1
    print(f"{arch} (bf16, batch 2, seq {seq}): loss {float(loss)!r}; step "
          f"{wall!r} ms wall under the profiler, device busy {busy!r} ms "
          f"({n} device operations), idle share {1 - busy / wall!r}",
          flush=True)
    for g, ms in sorted(by_group.items(), key=lambda kv: -kv[1])[:top]:
        print(f"  {ms:10.3f} ms  {ms / busy:7.2%}  {g}", flush=True)
    del params, opt_state, bundle
    torch.cuda.empty_cache()


def main() -> int:
    import subprocess

    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, action="append")
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--top", type=int, default=14)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_step_profile: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    for arch in args.arch or ARCHS:
        profile_step(torch, arch, args.seq, args.top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
