#!/usr/bin/env python3
"""Device operations and ``cudaLaunchKernel`` calls in a steady quickstart
round, and the time of the two uplink entry points that the rounds call,
for a checkout of the port.

    python3 tools/round_ops.py [--src DIR]

Needs one CUDA card and ``nvcc``.  Builds the quickstart configuration of
``chip_smoke.py``'s phase 3 (MLP 784-64-64-10, 20 Dirichlet(0.7) clients,
5 a round, batch 32, gamma = p = 0.1) and runs FedComLoc-Com with
``TopK(0.3)`` on the account and on the packed wire, ``QuantQr(8)`` on
both wires, ``QuantQr(8)`` with geometric local phases on the packed wire
and ``Compose(TopK(0.5), QuantQr(16))`` (k50_q16) on the packed wire: 3
warm-up rounds, then 5 under ``torch.profiler``.  Prints, a round: the
device operations (kernels, copies, memsets), the host's
``cudaLaunchKernel*`` calls and the device's busy ms.  Then times, with
CUDA events, the whole calls ``ops.quantize_qr(x, 8, keys)`` (the account
Q_r leaf: uniforms, K3 and K4), ``ops.quantize_pack(x, 8, keys)`` (the
packed ``qr`` leaf's encode: uniforms, K3 and K7), ``wire.decode`` of a
one-leaf ``QuantQr(8)`` payload (the ``qr`` decode: K9 and the values)
and ``ops.topk_slots(x, k, k)`` (the packed ``topk`` leaf: K1 and K5, k =
0.3 n), and the wrappers of K5 (cap k), K4 reading its uniforms (r = 8)
and K6 (cap n / 4; r = 4, at 2^24 r = 8), at (5, 50176) and (4, 2^24),
with keys made on the host as the compressors make them; and prints the
card's name and power limit.  ``--src`` imports the port from another checkout's
``src/`` (a parent commit unpacked with ``git archive``, say), so two trees
can be compared in one call on one card.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
WARMUP, PROFILED = 3, 5


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src/ directory of the checkout to measure")
    args = ap.parse_args()
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("round_ops: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch import prng
    from repro_torch.compress import Compose, QuantQr, TopK, wire
    from repro_torch.core import fed_data
    from repro_torch.core.fedcomloc import FedComLoc, FedComLocConfig
    from repro_torch.data import dirichlet, synthetic
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import quantize as quant
    from repro_torch.kernels import select_slots as sel
    from repro_torch.kernels import topk_compress as topk
    from repro_torch.models import small

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}; port from {args.src}", flush=True)
    dev = torch.device("cuda")
    ds = synthetic.make_mnist_like(n_train=8000, n_test=1000)
    parts = dirichlet.dirichlet_partition(ds.y_train, n_clients=20,
                                          alpha=0.7, seed=0)
    model = small.MLP(784, 64, 10)
    loss_fn = small.cross_entropy_loss(model.apply)
    data = fed_data.from_numpy_partition(ds.x_train, ds.y_train, parts,
                                         device="cuda")
    cfg = FedComLocConfig(gamma=0.1, p=0.1, n_clients=20, clients_per_round=5,
                          batch_size=32, variant="com")
    params0 = model.init(prng.PRNGKey(0), device=dev)
    geometric = FedComLocConfig(gamma=0.1, p=0.1, n_clients=20,
                                clients_per_round=5, batch_size=32,
                                variant="com", local_steps="geometric")
    for label, comp, mode, cfg_ in (
            ("TopK account", TopK(0.3), "account", cfg),
            ("TopK packed", TopK(0.3), "packed", cfg),
            ("QuantQr account", QuantQr(8), "account", cfg),
            ("QuantQr packed", QuantQr(8), "packed", cfg),
            ("QuantQr geometric packed", QuantQr(8), "packed", geometric),
            ("k50_q16 packed", Compose(TopK(0.5), QuantQr(16)), "packed",
             cfg)):
        alg = FedComLoc(loss_fn, data, cfg_, comp, wire=mode)
        state, key = alg.init(params0), prng.PRNGKey(2)
        for _ in range(WARMUP):
            key, sub = prng.split(key, 2)
            state, _ = alg.round(state, sub)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(PROFILED):           # unprofiled, then profiled
            key, sub = prng.split(key, 2)
            state, _ = alg.round(state, sub)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / PROFILED * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILED):
                key, sub = prng.split(key, 2)
                state, _ = alg.round(state, sub)
            torch.cuda.synchronize()
        dev_ops = launches = 0
        busy_us = 0.0
        for ev in prof.events():
            if ev.device_type == DeviceType.CUDA:
                dev_ops += 1
                busy_us += ev.time_range.elapsed_us()
            elif ev.name.startswith("cudaLaunchKernel"):
                launches += 1
        print(f"[round_ops] {label}: {dev_ops / PROFILED!r} device operations, "
              f"{launches / PROFILED!r} cudaLaunchKernel calls, device busy "
              f"{busy_us / 1e3 / PROFILED!r} ms a round; wall {wall_ms!r} ms a "
              f"round unprofiled", flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    for rows, n, iters in ((5, 50176, 200), (4, 1 << 24, 10)):
        x = torch.randn((rows, n), generator=gen, device=dev)
        keys = prng.split(prng.PRNGKey(3), rows)      # (rows, 2) on the host
        k = int(0.3 * n)
        t = topk.threshold_bits(x, k)
        u = prng.uniform(keys, n, device=dev)
        norm = quant.l2_norm(x)
        cap6, r6 = n // 4, (4 if n == 50176 else 8)
        t6 = topk.threshold_bits(x, cap6)
        norm6 = quant.l2_norm(ref.mask_by_threshold(x, t6))
        payload, _ = wire.encode(QuantQr(8), {"w": x}, keys)
        for label, fn in (
                ("ops.quantize_qr", lambda: ops.quantize_qr(x, 8, keys)),
                ("ops.quantize_pack", lambda: ops.quantize_pack(x, 8, keys)),
                ("wire.decode qr", lambda: wire.decode(payload)),
                ("ops.topk_slots", lambda: ops.topk_slots(x, k, k)),
                ("K5 compact_slots", lambda: sel.compact_slots(x, t, k)),
                ("K4 quantize_qr_with_uniforms",
                 lambda: quant.quantize_qr_with_uniforms(x, 8, u, norm)),
                ("K6 compact_code_slots", lambda: sel.compact_code_slots(
                    x, u, norm6, t6, r6, cap6))):
            print(f"[round_ops] {label} {(rows, n)}: {time_ms(torch, fn, iters)!r} "
                  f"ms a call", flush=True)
        del x, u, payload
    return 0


def time_ms(torch, fn, iters: int) -> float:
    """CUDA-event ms a call of ``fn``, after 3 warm-up calls."""
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


if __name__ == "__main__":
    sys.exit(main())
