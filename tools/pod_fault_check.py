#!/usr/bin/env python3
"""What chip_smoke's ``pod_round`` bound reads on a wrong round: the pod
round with TopK(quantile, 0.1) on the (2, 2, 1) mesh, qwen2-0.5b at the
phase's size, with a fault planted in the data axis's mean
(``PodCtx.data_mean``), held to the stacked round of the same 2 clients
as the phase holds it.

    python3 tools/pod_fault_check.py

Needs one CUDA card and ``nvcc``; spawns 4 gloo ranks on it as the phase
does.  The faults (each round's outputs are wrong by design; only how far
past the bound they land means something):

* ``sum``: the data ranks' loss and gradient summed, not averaged;
* ``drop``: data rank 1's gradient zeroed before the mean.

For each, prints the loss and bits of both rounds against the stacked
round, the x and h coordinates past the phase's bound (x: 2^-23 (4 max |x|
+ 128 max |x - x0|) of the leaf; h: p / gamma x 2 x rounds times that),
the largest gap over its bound and its leaf; then the card's name and
power limit.
"""

from __future__ import annotations

import os
import pickle
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

FAULTS = ("sum", "drop")
MESH = (2, 2, 1)
WORLD = 4


def _rank(rank: int, world: int, tmp: str, fault: str) -> None:
    """One rank of the phase's pod round (:func:`chip_smoke._pr_rank`),
    TopK on MESH only, with ``fault`` in its data axis's mean."""
    import torch

    from repro_torch.launch import fed_train

    mean = fed_train.PodCtx.data_mean

    def summed(self, flat):
        return self._all_reduce(flat, self.data_group, "data")

    def dropped(self, flat):
        if self.data_rank == 1:
            flat = torch.cat([flat[:1], torch.zeros_like(flat[1:])])
        return mean(self, flat)

    fed_train.PodCtx.data_mean = {"sum": summed, "drop": dropped}[fault]
    cs.POD_RUNS = {k: v for k, v in cs.POD_RUNS.items()
                   if v["compressor"] == "topk"}
    cs.POD_MESHES = {MESH: tuple(range(world))}
    cs._pr_rank(rank, world, tmp, "cuda", False)


def main() -> int:
    import torch
    import torch.multiprocessing as mp

    from repro_torch.kernels import build

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    build.build_all()
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    for fault in FAULTS:
        tmp = tempfile.mkdtemp()
        try:
            open(f"{tmp}/go", "w").close()
            t0 = time.time()
            mp.start_processes(_rank, args=(WORLD, tmp, fault), nprocs=WORLD,
                               join=True, start_method="spawn")
            with open(f"{tmp}/rank0.pkl", "rb") as f:
                res = pickle.load(f)    # written by rank 0 just above
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        paths, runs = res["paths"], res["runs"]
        (label, _), = [k for k in runs if k[1] == "stacked"]
        ref, run = runs[(label, "stacked")], runs[(label, MESH)]
        x, h = run["x_gap"], run["h_gap"]
        print(f"[pod_fault] {fault}: {label} {MESH} (loss, bits) a round "
              f"{run['outs']} against the stacked round's {ref['outs']}; "
              f"past the bound x {x[0]} of {x[1]} (worst {x[2]!r} x the "
              f"bound, leaf {paths[x[3] or 0]}), h {h[0]} of {h[1]} (worst "
              f"{h[2]!r}, leaf {paths[(h[3] or 0) % len(paths)]}); the "
              f"phase allows {cs.POD_FLIP_SHARE * x[1]:.0f} and "
              f"{cs.POD_FLIP_SHARE * h[1]:.0f}; {time.time() - t0:.1f} s",
              flush=True)
    print(f"card: {cs.card_line()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
