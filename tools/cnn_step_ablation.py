#!/usr/bin/env python3
"""What one local step of the Figure 9 CNN costs on the card, and what
cuDNN's deterministic algorithms cost it.

    python3 tools/cnn_step_ablation.py

Needs one CUDA card; builds nothing.  One step is the forward and backward
of ``small.CNN(3, 10, 32)`` over 5 stacked clients of 32 images
(``core.engine.value_and_grad``: one grouped convolution a conv layer, one
bmm a dense layer), at Figure 9's shape.  Variants, timed in turns (each
in order, then in reverse; the minimum of the two is printed), with CUDA
events over 50 steps after a warm-up:

* ``grouped, deterministic`` — as the port runs it
  (``torch.backends.cudnn.deterministic = True``, set by
  ``repro_torch.models.small``);
* ``grouped, any algorithm`` — the flag off (cuDNN may pick algorithms
  whose weight gradients sum in a run-dependent order);
* ``per client, deterministic`` — the 5 clients one after another, each an
  ordinary convolution.

Each variant's device time a step under ``torch.profiler`` and its three
largest device operations follow, then the card's name and power limit.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CLIENTS, BATCH, STEPS = 5, 32, 50


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("cnn_step_ablation: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import prng
    from repro_torch import tree as tree_util
    from repro_torch.core.engine import value_and_grad
    from repro_torch.data import synthetic
    from repro_torch.models import small

    dev = torch.device("cuda")
    ds = synthetic.make_cifar_like(n_train=CLIENTS * BATCH, n_test=10)
    model = small.CNN(3, 10, 32)
    loss_fn = small.cross_entropy_loss(model.apply)
    keys = prng.split(prng.PRNGKey(0), CLIENTS)
    clients = [model.init(k, device=dev) for k in keys]
    stacked = tree_util.map(lambda *ls: torch.stack(ls), *clients)
    xb = torch.from_numpy(ds.x_train.reshape(CLIENTS, BATCH, 32, 32, 3)).to(dev)
    yb = torch.from_numpy(
        ds.y_train.reshape(CLIENTS, BATCH).astype(np.int64)).to(dev)

    def grouped():
        value_and_grad(loss_fn, stacked, xb, yb)

    def per_client():
        for i, p in enumerate(clients):
            value_and_grad(loss_fn, p, xb[i], yb[i])

    plans = {"grouped, deterministic": (grouped, True),
             "grouped, any algorithm": (grouped, False),
             "per client, deterministic": (per_client, True)}

    def timed(fn, deterministic):
        torch.backends.cudnn.deterministic = deterministic
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(STEPS):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / STEPS

    times = {name: [] for name in plans}
    for name in list(plans) + list(plans)[::-1]:
        times[name].append(timed(*plans[name]))
    for name, (fn, deterministic) in plans.items():
        torch.backends.cudnn.deterministic = deterministic
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        by_name = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by_name[e.name] = (by_name.get(e.name, 0.0)
                                   + e.time_range.elapsed_us() / 1e3 / 10)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
        print(f"[cnn step] {name}: ms a step (min of 2, in turns) "
              f"{min(times[name])!r}; device ms a step "
              f"{sum(by_name.values())!r}; top: " + "; ".join(
                  f"{k[:60]} {v!r}" for k, v in top), flush=True)
    torch.backends.cudnn.deterministic = True
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
