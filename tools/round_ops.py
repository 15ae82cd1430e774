#!/usr/bin/env python3
"""Device operations and ``cudaLaunchKernel`` calls in a steady quickstart
round, for a checkout of the port.

    python3 tools/round_ops.py [--src DIR]

Needs one CUDA card and ``nvcc``.  Builds the quickstart configuration of
``chip_smoke.py``'s phase 3 (MLP 784-64-64-10, 20 Dirichlet(0.7) clients,
5 a round, batch 32, gamma = p = 0.1) and runs FedComLoc-Com with
``TopK(0.3)`` on the account wire and ``Compose(TopK(0.5), QuantQr(16))``
(k50_q16) on the packed wire: 3 warm-up rounds, then 5 under
``torch.profiler``.  Prints, a round: the device operations (kernels,
copies, memsets), the host's ``cudaLaunchKernel*`` calls and the device's
busy ms; and the card's name and power limit.  ``--src`` imports the port
from another checkout's ``src/`` (a parent commit unpacked with ``git
archive``, say), so two trees can be compared in one call on one card.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
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
    from repro_torch.compress import Compose, QuantQr, TopK
    from repro_torch.core import fed_data
    from repro_torch.core.fedcomloc import FedComLoc, FedComLocConfig
    from repro_torch.data import dirichlet, synthetic
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
    for label, comp, wire in (
            ("TopK account", TopK(0.3), "account"),
            ("k50_q16 packed", Compose(TopK(0.5), QuantQr(16)), "packed")):
        alg = FedComLoc(loss_fn, data, cfg, comp, wire=wire)
        state, key = alg.init(params0), prng.PRNGKey(2)
        for _ in range(WARMUP):
            key, sub = prng.split(key, 2)
            state, _ = alg.round(state, sub)
        torch.cuda.synchronize()
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
              f"{busy_us / 1e3 / PROFILED!r} ms a round", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
