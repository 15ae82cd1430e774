"""Single-program LM trainer (the plain, non-federated baseline), the port
of ``repro.launch.train``.

Runs real steps through :func:`repro_torch.launch.steps.build_train_step`
on one device: the card by default (full configs, bf16), the CPU with
``--device cpu`` (reduced configs).

  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-3b \\
      --steps 4 --batch 2 --seq 4096
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --reduced --steps 20 --batch 4 --seq 128 --device cpu

The flags, the token draws and the log line are the reference's;
``--device`` takes the place of ``--production-mesh``.  Weights come from
the port's own init (seed 0), not the reference's bits.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_spec
from repro_torch.configs.base import InputShape, reduced as make_reduced
from repro_torch.data import synthetic
from repro_torch.launch import steps as steps_mod
from repro_torch.models import transformer as tfm
from repro_torch.optim import optimizers


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--optimizer", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--log-every", type=int, default=1)
    args = ap.parse_args(argv)

    spec = get_spec(args.arch)
    if args.reduced:
        spec = make_reduced(spec)
    m = spec.model
    device = torch.device(args.device)
    shape = InputShape("custom", args.seq, args.batch, "train")
    bundle = steps_mod.build_train_step(spec, shape,
                                        optimizer=args.optimizer)

    params = tfm.init_params(m, torch.Generator(device=device).manual_seed(0))
    opt_name, lr = steps_mod._optimizer_for(spec)
    if args.optimizer:
        opt_name = args.optimizer
    opt_init, _ = optimizers.make(opt_name, lr)
    opt_state = opt_init(params)

    toks = synthetic.make_lm_tokens(min(m.vocab, 4096),
                                    args.batch * 2, args.seq, seed=0)
    t0 = time.time()
    for i in range(args.steps):
        sl = np.random.default_rng(i).integers(0, toks.shape[0], args.batch)
        batch = {"tokens": torch.from_numpy(toks[sl]).to(device=device,
                                                          dtype=torch.int64)}
        params, opt_state, loss = bundle.fn(params, opt_state, batch)
        if i % args.log_every == 0:
            print(f"step {i:4d}  loss {float(loss):.4f}  "
                  f"({time.time() - t0:.1f}s)")
    print("done")


if __name__ == "__main__":
    main()
