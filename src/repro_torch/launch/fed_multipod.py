"""FedComLoc as a multi-pod LM training feature (DESIGN.md §2), the port
of ``examples/fed_multipod.py``.

Runs real federated rounds of a reduced qwen2-family LM on a ``("pod",
"data", "model")`` mesh of ``--pods`` ranks: each rank is one federated
client, and the only traffic between them is the round's compressed
parameter sync (``launch/fed_train.py``'s pod round).

  PYTHONPATH=src python -m repro_torch.launch.fed_multipod --pods 2 \\
      --rounds 6 --compressor topk|quant|none
  PYTHONPATH=src python -m repro_torch.launch.fed_multipod --pods 2 \\
      --backend gloo --device cpu

``--backend nccl`` (the default) needs one card a rank.  ``--backend
gloo`` runs every rank's tensors on card 0 (``--device cuda``, the
default) or on the CPU (``--device cpu``); its collectives go through the
host.  Nothing falls back: a backend or device that cannot run raises.
The ranks meet through a ``FileStore`` in a temporary directory.  The
model, shape, gamma, p, density and keys are the example's; the weights
come from the port's own init (seed 0), not the reference's bits.
"""

from __future__ import annotations

import argparse
import dataclasses
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import prng
from repro_torch import tree as tree_util
from repro_torch.compress.report import dense_bits
from repro_torch.configs import get_spec, reduced
from repro_torch.configs.base import InputShape
from repro_torch.data import synthetic
from repro_torch.launch import fed_train, steps
from repro_torch.launch.mesh import make_pod_mesh

#: the example's reduced qwen2-0.5b, its shape and its round
MODEL = dict(n_layers=2, d_model=128, d_ff=256, vocab=256, n_heads=4,
             n_kv_heads=2, head_dim=32)
SEQ = 128
ROWS = 2                # a client's batch rows
GAMMA = 0.2
DENSITY = 0.2
QUANT_BITS = 8


def config(pods: int, local_steps: int, compressor: str):
    """``(spec, shape, FedTrainConfig)`` of the example."""
    spec = reduced(get_spec("qwen2-0.5b"))
    spec = dataclasses.replace(spec, model=dataclasses.replace(
        spec.model, dtype=torch.float32, **MODEL))
    shape = InputShape("fed_multipod", SEQ, ROWS * pods, "train")
    fed = fed_train.FedTrainConfig(
        gamma=GAMMA, p=1.0 / local_steps, local_steps=local_steps,
        compressor=compressor, density=DENSITY, quant_bits=QUANT_BITS)
    return spec, shape, fed


def _rank(rank: int, args, store_path: str) -> None:
    if args.device == "cpu":
        dev = torch.device("cpu")
        torch.set_num_threads(1)
    else:
        dev = torch.device("cuda", rank if args.backend == "nccl" else 0)
        torch.cuda.set_device(dev)
    dist.init_process_group(args.backend,
                            store=dist.FileStore(store_path, args.pods),
                            rank=rank, world_size=args.pods)
    try:
        mesh = make_pod_mesh(args.pods, device="cuda"
                             if args.backend == "nccl" else "cpu")
        spec, shape, fed = config(args.pods, args.local_steps,
                                  args.compressor)
        bundle = fed_train.build_fed_round(spec, shape, fed, mesh)
        ctx = bundle.fn.ctx
        one = steps.init_params(spec,
                                torch.Generator(device=dev).manual_seed(0))
        params = tree_util.map(lambda t: t.unsqueeze(0).clone(), one)
        h = tree_util.map(torch.zeros_like, params)
        toks = torch.from_numpy(synthetic.make_lm_tokens(
            spec.model.vocab, ROWS * args.pods, SEQ, seed=0)).long()
        batch = ctx.local_batch(
            {"tokens": toks.reshape(args.pods, ROWS, SEQ).to(dev)})
        key, total_bits = prng.PRNGKey(1), 0.0
        for r in range(args.rounds):
            key, sub = prng.split(key, 2)
            params, h, loss, bits = bundle.fn(params, h, batch, sub)
            total_bits += float(bits)
            if rank == 0:
                print(f"round {r + 1}: loss {float(loss):.4f}  cross-pod "
                      f"Mbits so far {total_bits / 1e6:.1f} "
                      f"({fed.compressor}; comm_bits {float(bits)!r})",
                      flush=True)
        if rank == 0:
            per_round = total_bits / max(args.rounds, 1)
            dense = args.pods * dense_bits(one)
            print(f"\nper-round cross-pod traffic (measured): "
                  f"{per_round / 1e6:.1f} Mb vs {dense / 1e6:.1f} Mb dense "
                  f"({dense / max(per_round, 1):.1f}x reduction)", flush=True)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pods", type=int, default=2)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--local-steps", type=int, default=4)
    ap.add_argument("--compressor", default="topk",
                    choices=["topk", "quant", "none"])
    ap.add_argument("--backend", default="nccl", choices=["nccl", "gloo"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.backend == "nccl" and args.device != "cuda":
        raise ValueError("--backend nccl runs on the cards: use --backend "
                         "gloo for --device cpu")
    if args.device == "cuda":
        cards = torch.cuda.device_count()
        need, which = ((args.pods, "one a rank") if args.backend == "nccl"
                       else (1, "card 0"))
        if cards < need:
            raise RuntimeError(
                f"--backend {args.backend} --device cuda needs {need} "
                f"card(s) ({which}), found {cards}; --backend gloo --device "
                f"cpu runs on the CPU")
    where = {"nccl": f"cards 0-{args.pods - 1}, one a rank",
             "gloo": "card 0, collectives through the host"
             if args.device == "cuda" else "the CPU"}[args.backend]
    print(f"{args.pods} ranks, backend {args.backend}, tensors on {where}",
          flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank, args=(args, f"{tmp}/store"),
                           nprocs=args.pods, join=True, start_method="spawn")


if __name__ == "__main__":
    main()
