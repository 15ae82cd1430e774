"""Single-program LM trainer (the plain, non-federated baseline), the port
of ``repro.launch.train``.

Runs real steps through :func:`repro_torch.launch.steps.build_train_step`
on one device: the card by default (full configs, bf16), the CPU with
``--device cpu`` (reduced configs).

  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-3b \\
      --steps 4 --batch 2 --seq 4096
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --reduced --steps 20 --batch 4 --seq 128 --device cpu

The flags, the batches and the log line are the reference's: the
encoder-decoder family trains on ``--seq // 2`` source frames
(``default_rng(step).normal``, bf16) and the rest target tokens; qwen2-vl
on ``n_prefix_tokens`` zero bf16 prefix embeddings before ``--seq -
n_prefix_tokens`` tokens.  ``--device`` takes the place of
``--production-mesh``.  Weights come from the port's own init (seed 0),
not the reference's bits.
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
from repro_torch.optim import optimizers


def batch_for(spec, toks: np.ndarray, step: int, device) -> dict:
    """Step ``step``'s batch from its (B, seq) token rows, as the
    reference's ``train.py`` makes it."""
    m = spec.model
    b, seq = toks.shape
    if spec.is_encdec:
        t_src = seq // 2
        src = np.random.default_rng(step).normal(size=(b, t_src, m.d_model))
        return {"src_embeds": torch.from_numpy(src).to(device=device,
                                                       dtype=torch.bfloat16),
                "tgt_tokens": torch.from_numpy(toks[:, :seq - t_src]).to(
                    device=device, dtype=torch.int64)}
    npre = spec.n_prefix_tokens
    batch = {"tokens": torch.from_numpy(toks[:, :seq - npre]).to(
        device=device, dtype=torch.int64)}
    if npre:
        batch["prefix_embeds"] = torch.zeros((b, npre, m.d_model),
                                             dtype=torch.bfloat16,
                                             device=device)
    return batch


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

    params = steps_mod.init_params(
        spec, torch.Generator(device=device).manual_seed(0))
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
        batch = batch_for(spec, toks[sl], i, device)
        params, opt_state, loss = bundle.fn(params, opt_state, batch)
        if i % args.log_every == 0:
            print(f"step {i:4d}  loss {float(loss):.4f}  "
                  f"({time.time() - t0:.1f}s)")
    print("done")


if __name__ == "__main__":
    main()
