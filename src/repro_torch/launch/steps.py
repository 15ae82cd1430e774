"""Step functions and input descriptions per (arch x input shape), the port
of ``repro.launch.steps``.

For every ported architecture and input shape this builds

* the step function (``train_step`` / ``prefill_step`` / ``serve_step``),
* :class:`TensorSpec` stand-ins for every input (shapes and dtypes; the
  parameter trees are traced under ``FakeTensorMode``, nothing is
  allocated).

There are no shardings: the port runs on one card.  The train step
updates its parameters and optimizer state in place, as the reference's
step donates them.  The decoder stacks take ``{"tokens"}`` batches, with
``"prefix_embeds"`` (B, n_prefix_tokens, d_model) bf16 where the spec has
prefix tokens (qwen2-vl: the tokens then fill ``seq_len - npre``); the
encoder-decoder family takes ``{"src_embeds", "tgt_tokens"}``, its
sequence split into ``t_src = seq_len // 2`` source frames and the rest
target tokens, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import tree as tree_util
from repro_torch.configs.base import SHAPES, ArchSpec, InputShape
from repro_torch.models import attention as attn
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import transformer as tfm
from repro_torch.optim import optimizers

PyTree = Any


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """The shape and dtype of one input (``jax.ShapeDtypeStruct``)."""
    shape: tuple
    dtype: torch.dtype


@dataclasses.dataclass
class StepBundle:
    """Everything the launchers need for one (arch, shape) combination."""
    fn: Callable                 # the step function
    args: tuple                  # a TensorSpec tree per argument


# --------------------------------------------------------------------------- #
# helpers
# --------------------------------------------------------------------------- #

def _optimizer_for(spec: ArchSpec) -> tuple:
    # the 400B MoE cannot afford fp32 adam state on 16 GB chips
    if spec.arch_id.startswith("llama4"):
        return "sgd", 1e-3
    return "adam", 1e-4


def adjust_for_shape(spec: ArchSpec, shape_name: str) -> ArchSpec:
    """``long_context_cap`` (global layers capped to a sliding window) only
    applies in long-context mode; every other shape gets true full attention
    on the global layers."""
    if spec.is_encdec or shape_name == "long_500k":
        return spec
    m = spec.model
    if m.long_context_cap is None:
        return spec
    return dataclasses.replace(
        spec, model=dataclasses.replace(m, long_context_cap=None))


def describe(tree: PyTree) -> PyTree:
    """``tree`` with every tensor replaced by its :class:`TensorSpec`
    (dicts, tuples and NamedTuples kept; other leaves as they are)."""
    if isinstance(tree, torch.Tensor):
        return TensorSpec(tuple(tree.shape), tree.dtype)
    if isinstance(tree, dict):
        return {k: describe(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        parts = [describe(v) for v in tree]
        return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(parts)
    return tree


def _traced(fn: Callable, *args) -> PyTree:
    """What ``fn(*args)`` returns, as :class:`TensorSpec` stand-ins, traced
    with fake tensors (no memory is allocated)."""
    with FakeTensorMode():
        return describe(fn(*args))


def init_params(spec: ArchSpec, gen: torch.Generator) -> PyTree:
    """The family's seeded init: ``encdec.init_params`` for the
    encoder-decoder family, ``transformer.init_params`` otherwise."""
    if spec.is_encdec:
        return encdec_mod.init_params(spec.model, gen)
    return tfm.init_params(spec.model, gen)


def _params_struct(spec: ArchSpec) -> PyTree:
    return _traced(init_params, spec, torch.Generator())


def batch_struct(spec: ArchSpec, b: int, t: int) -> dict:
    """The batch of one (B, T) step: ``{"src_embeds", "tgt_tokens"}`` for
    the encoder-decoder family (T // 2 frames, T - T // 2 tokens), else
    ``{"tokens"}`` of T - npre and, where the spec has prefix tokens,
    ``{"prefix_embeds"}``."""
    d = spec.model.d_model
    if spec.is_encdec:
        t_src = t // 2
        return {"src_embeds": TensorSpec((b, t_src, d), torch.bfloat16),
                "tgt_tokens": TensorSpec((b, t - t_src), torch.int64)}
    npre = spec.n_prefix_tokens
    batch = {"tokens": TensorSpec((b, t - npre), torch.int64)}
    if npre:
        batch["prefix_embeds"] = TensorSpec((b, npre, d), torch.bfloat16)
    return batch


def loss_fn(spec: ArchSpec, loss_chunk: int) -> Callable:
    """``fn(params, batch) -> loss``: the family's chunked loss on one
    batch of :func:`batch_struct`'s layout."""
    m = spec.model
    if spec.is_encdec:
        return lambda p, b_: encdec_mod.loss(
            p, m, b_["src_embeds"], b_["tgt_tokens"], loss_chunk=loss_chunk)
    return lambda p, b_: tfm.loss(p, m, b_["tokens"],
                                  prefix_embeds=b_.get("prefix_embeds"),
                                  loss_chunk=loss_chunk)


# --------------------------------------------------------------------------- #
# step builders
# --------------------------------------------------------------------------- #

def build_train_step(spec: ArchSpec, shape: InputShape,
                     optimizer: Optional[str] = None,
                     loss_chunk: int = 256) -> StepBundle:
    """``fn(params, opt_state, batch) -> (params, opt_state, loss)``: the
    chunked next-token loss and its gradient, then one optimizer update
    (the spec's, ``_optimizer_for``, unless ``optimizer`` names one),
    written into ``params`` and ``opt_state`` in place.  ``batch`` is
    :func:`batch_struct`'s (the text decoders' ``{"tokens": (B, T)
    int}``); the loss comes back as a detached float32 scalar on the
    parameters' device."""
    opt_name, lr = _optimizer_for(spec)
    if optimizer is not None:
        opt_name = optimizer
    opt_init, opt_update = optimizers.make(opt_name, lr)
    b, t = shape.global_batch, shape.seq_len
    with FakeTensorMode():
        fake = init_params(spec, torch.Generator())
        params_struct, opt_struct = describe(fake), describe(opt_init(fake))
    batch = batch_struct(spec, b, t)
    loss_of = loss_fn(spec, loss_chunk)

    def train_step(params, opt_state, batch_):
        live = [leaf.detach().requires_grad_()
                for leaf in tree_util.leaves(params)]
        loss = loss_of(tree_util.unflatten(params, live), batch_)
        grads = torch.autograd.grad(loss, live, allow_unused=True,
                                    materialize_grads=True)
        del live
        with torch.no_grad():
            params, opt_state = opt_update(
                tree_util.unflatten(params, list(grads)), opt_state, params)
        return params, opt_state, loss.detach()

    return StepBundle(fn=train_step, args=(params_struct, opt_struct, batch))


def build_prefill_step(spec: ArchSpec, shape: InputShape) -> StepBundle:
    """``fn(params, batch) -> (last-position logits, decode state)`` under
    ``torch.no_grad()``: ``tfm.prefill`` with caches sized for the
    shape's sequence (prefix positions included), or ``encdec.prefill``
    of the source frames and target prefix with self caches sized for the
    target's ``t - t // 2``."""
    m = spec.model
    b, t = shape.global_batch, shape.seq_len
    batch = batch_struct(spec, b, t)
    if spec.is_encdec:
        t_tgt = t - t // 2

        @torch.no_grad()
        def prefill_step(params, batch_):
            return encdec_mod.prefill(params, m, batch_["src_embeds"],
                                      batch_["tgt_tokens"], max_len=t_tgt)
    else:
        @torch.no_grad()
        def prefill_step(params, batch_):
            return tfm.prefill(params, m, batch_["tokens"], max_len=t,
                               prefix_embeds=batch_.get("prefix_embeds"))

    return StepBundle(fn=prefill_step, args=(_params_struct(spec), batch))


def build_serve_step(spec: ArchSpec, shape: InputShape) -> StepBundle:
    """Decode: ONE new token against a cache of ``shape.seq_len``;
    ``fn(params, token, state) -> (logits, new state)`` under
    ``torch.no_grad()``.  The encoder-decoder's state: bf16 self caches
    of ``seq_len`` holding ``seq_len - 1`` tokens and the cross K/V of
    ``max(1, seq_len // 8)`` encoder frames, as in the reference."""
    m = spec.model
    b, t = shape.global_batch, shape.seq_len
    if spec.is_encdec:
        enc_len = max(1, t // 8)

        def make_state():
            kv = (b, m.n_kv_heads, enc_len, m.hd)
            return encdec_mod.EncDecState(
                self_caches={
                    f"layer_{i}": attn.KVCache(
                        k=torch.zeros((b, m.n_kv_heads, t, m.hd),
                                      dtype=torch.bfloat16),
                        v=torch.zeros((b, m.n_kv_heads, t, m.hd),
                                      dtype=torch.bfloat16),
                        length=t - 1)
                    for i in range(m.n_dec_layers)},
                cross_kv={f"layer_{i}": (torch.zeros(kv, dtype=torch.bfloat16),
                                         torch.zeros(kv, dtype=torch.bfloat16))
                          for i in range(m.n_dec_layers)},
                enc_len=enc_len)

        state_struct = _traced(make_state)
        decode = encdec_mod.decode_step
    else:
        state_struct = _traced(tfm.init_decode_state, m, b, t,
                               torch.bfloat16, "cpu")
        decode = tfm.decode_step

    @torch.no_grad()
    def serve_step(params, token, state):
        return decode(params, m, token, state)

    return StepBundle(fn=serve_step,
                      args=(_params_struct(spec),
                            TensorSpec((b,), torch.int64), state_struct))


def build_step(spec: ArchSpec, shape_name: str, **kw) -> StepBundle:
    shape = SHAPES[shape_name]
    spec = adjust_for_shape(spec, shape_name)
    if shape.kind == "train":
        return build_train_step(spec, shape, **kw)
    if shape.kind == "prefill":
        return build_prefill_step(spec, shape)
    return build_serve_step(spec, shape)
