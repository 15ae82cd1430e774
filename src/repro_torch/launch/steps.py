"""Step functions and input descriptions per (arch x input shape), the port
of ``repro.launch.steps``.

For every ported architecture and input shape this builds

* the step function (``train_step`` / ``prefill_step`` / ``serve_step``),
* :class:`TensorSpec` stand-ins for every input (shapes and dtypes; the
  parameter trees are traced under ``FakeTensorMode``, nothing is
  allocated).

There are no shardings: the port runs on one card.  The train step
updates its parameters and optimizer state in place, as the reference's
step donates them.  The encoder-decoder family is not ported and raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import not_ported
from repro_torch import tree as tree_util
from repro_torch.configs.base import SHAPES, ArchSpec, InputShape
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
    if shape_name == "long_500k":
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


def _params_struct(spec: ArchSpec) -> PyTree:
    return _traced(tfm.init_params, spec.model, torch.Generator())


def _check_decoder(spec: ArchSpec) -> None:
    if not isinstance(spec.model, tfm.ModelConfig):
        raise not_ported("the encoder-decoder family")


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
    ``{"tokens": (B, T) int}``; the loss comes back as a detached float32
    scalar on the parameters' device."""
    _check_decoder(spec)
    m = spec.model
    opt_name, lr = _optimizer_for(spec)
    if optimizer is not None:
        opt_name = optimizer
    opt_init, opt_update = optimizers.make(opt_name, lr)
    b, t = shape.global_batch, shape.seq_len
    with FakeTensorMode():
        fake = tfm.init_params(m, torch.Generator())
        params_struct, opt_struct = describe(fake), describe(opt_init(fake))
    batch = {"tokens": TensorSpec((b, t), torch.int64)}

    def train_step(params, opt_state, batch_):
        live = [leaf.detach().requires_grad_()
                for leaf in tree_util.leaves(params)]
        loss = tfm.loss(tree_util.unflatten(params, live), m,
                        batch_["tokens"], loss_chunk=loss_chunk)
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
    shape's sequence."""
    _check_decoder(spec)
    m = spec.model
    b, t = shape.global_batch, shape.seq_len
    batch = {"tokens": TensorSpec((b, t), torch.int64)}

    @torch.no_grad()
    def prefill_step(params, batch_):
        return tfm.prefill(params, m, batch_["tokens"], max_len=t)

    return StepBundle(fn=prefill_step, args=(_params_struct(spec), batch))


def build_serve_step(spec: ArchSpec, shape: InputShape) -> StepBundle:
    """Decode: ONE new token against a cache of ``shape.seq_len``;
    ``fn(params, token, state) -> (logits, new state)`` under
    ``torch.no_grad()``."""
    _check_decoder(spec)
    m = spec.model
    b, t = shape.global_batch, shape.seq_len
    state_struct = _traced(tfm.init_decode_state, m, b, t, torch.bfloat16,
                           "cpu")

    @torch.no_grad()
    def serve_step(params, token, state):
        return tfm.decode_step(params, m, token, state)

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
