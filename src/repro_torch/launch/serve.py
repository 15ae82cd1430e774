"""Batched serving, the port of ``repro.launch.serve``: prefill a
batch of prompts, then decode tokens against the carried state.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b \\
      --reduced --batch 4 --prompt-len 64 --gen 16 --device cpu

Without ``--reduced`` it serves the published width and depth (bfloat16)
and wants the card (``--device cuda``, the default); ``--layers N`` keeps
the first N layers of a decoder stack, so that a model whose weights
outgrow one card (mixtral-8x7b: ~93 GB in bf16) serves at full width:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \\
      --layers 16 --batch 4 --prompt-len 4608 --gen 32

:func:`serve` is the body, for callers that bring their own weights and
prompts.  For the encoder-decoder family (``seamless-m4t-large-v2``) the
CLI encodes ``--prompt-len`` seeded source frames and decodes after a
target prefix of the prompt's first 4 tokens, as the reference does;
qwen2-vl is served text-only (no prefix embeddings), as in the
reference's CLI.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import prng
from repro_torch.configs import ARCH_IDS, get_spec
from repro_torch.configs.base import reduced as make_reduced
from repro_torch.data import synthetic
from repro_torch.launch.steps import init_params
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import transformer as tfm


@dataclasses.dataclass
class ServeResult:
    tokens: torch.Tensor          # (B, gen) int64: the generated tokens
    prefill_logits: torch.Tensor  # (B, vocab) float32, the prompt's last
    logits: list                  # gen x (B, vocab) float32, one per decode
    prefill_s: float              # host clock, synchronised on the card
    decode_s: float               # all gen decode steps


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(params: dict, cfg, prompts: torch.Tensor, gen: int,
          temperature: float = 0.0, key=None, *, src_embeds=None,
          max_len=None) -> ServeResult:
    """Prefill ``prompts`` (B, T) and decode ``gen`` tokens, on the
    prompts' device.  ``cfg`` is a ``transformer.ModelConfig`` or an
    ``encdec.EncDecConfig``, whose ``src_embeds`` (B, T_src, D) are
    encoded and ``prompts`` are the target prefix.

    As the reference's ``serve.py`` does: the caches are sized for
    ``T + gen + 1`` unless ``max_len`` is given (its encoder-decoder CLI
    sizes them for the source's length instead: ``T_src + gen + 1``);
    the first token is the argmax of the prefill logits;
    each decode step then feeds the last token and picks the next by
    argmax or, at
    ``temperature > 0``, by ``jax.random.categorical(sub, logits /
    temperature)`` with ``key, sub = split(key)`` from ``key`` (default
    ``PRNGKey(3)``), through :mod:`repro_torch.prng`.  The decode after the
    last kept token runs too, as in the reference.
    """
    device = prompts.device
    if max_len is None:
        max_len = prompts.shape[1] + gen + 1
    if temperature > 0 and key is None:
        key = prng.PRNGKey(3)
    encdec = isinstance(cfg, encdec_mod.EncDecConfig)
    decode = encdec_mod.decode_step if encdec else tfm.decode_step
    _sync(device)
    t0 = time.perf_counter()
    if encdec:
        logits, state = encdec_mod.prefill(params, cfg, src_embeds, prompts,
                                           max_len=max_len)
    else:
        logits, state = tfm.prefill(params, cfg, prompts, max_len=max_len)
    _sync(device)
    prefill_s = time.perf_counter() - t0
    prefill_logits = logits
    tok = torch.argmax(logits, dim=-1)
    out, seen = [], []
    t0 = time.perf_counter()
    for _ in range(gen):
        out.append(tok)
        logits, state = decode(params, cfg, tok, state)
        seen.append(logits)
        if temperature > 0:
            key, sub = prng.split(key, 2)
            tok = prng.categorical(sub, logits / temperature)
        else:
            tok = torch.argmax(logits, dim=-1)
    _sync(device)
    decode_s = time.perf_counter() - t0
    tokens = (torch.stack(out, dim=1) if out else
              torch.zeros((prompts.shape[0], 0), dtype=torch.int64,
                          device=device))
    return ServeResult(tokens=tokens, prefill_logits=prefill_logits,
                       logits=seen, prefill_s=prefill_s, decode_s=decode_s)


def prompts_for(cfg, batch: int, prompt_len: int, device) -> torch.Tensor:
    """The reference's serve prompts: ``make_lm_tokens(min(vocab, 4096),
    batch, prompt_len, seed=1)``."""
    toks = synthetic.make_lm_tokens(min(cfg.vocab, 4096), batch, prompt_len,
                                    seed=1)
    return torch.from_numpy(toks).to(device=device, dtype=torch.int64)


def source_frames(cfg, batch: int, frames: int, device) -> torch.Tensor:
    """The reference's encoder-decoder serve input:
    ``jax.random.normal(PRNGKey(2), (batch, frames, d_model))``, float32,
    through :mod:`repro_torch.prng`."""
    return prng.normal(prng.PRNGKey(2), (batch, frames, cfg.d_model),
                       device=device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layers", type=int, default=None,
                    help="keep the first N layers of a decoder stack")
    args = ap.parse_args(argv)

    spec = get_spec(args.arch)
    if args.reduced:
        spec = make_reduced(spec)
    if args.layers is not None:
        if spec.is_encdec:
            raise ValueError("--layers cuts a decoder stack; "
                             f"{args.arch} is an encoder-decoder")
        spec = dataclasses.replace(spec, model=dataclasses.replace(
            spec.model, n_layers=args.layers))
    m = spec.model
    device = torch.device(args.device)
    params = init_params(spec, torch.Generator(device=device).manual_seed(0))
    prompts = prompts_for(m, args.batch, args.prompt_len, device)
    if spec.is_encdec:
        res = serve(params, m, prompts[:, :4], args.gen, args.temperature,
                    src_embeds=source_frames(m, args.batch, args.prompt_len,
                                             device),
                    max_len=args.prompt_len + args.gen + 1)
    else:
        res = serve(params, m, prompts, args.gen, args.temperature)
    print(f"prefill done in {res.prefill_s:.2f}s")
    n = args.gen * args.batch
    print(f"generated {args.gen} tokens x {args.batch} seqs in "
          f"{res.decode_s:.2f}s ({n / max(res.decode_s, 1e-9):.1f} tok/s)")
    print("sample token ids:", res.tokens[0][:16].tolist())


if __name__ == "__main__":
    main()
