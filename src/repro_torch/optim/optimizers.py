"""Minimal optimizers on parameter trees, the port of
``repro.optim.optimizers``.

``make(name, lr, **kw) -> (init_fn, update_fn)`` with
``update_fn(grads, opt_state, params) -> (new_params, new_opt_state)``.
Trees are the port's nested dicts (:mod:`repro_torch.tree`); the state
keeps the reference's dtypes:

* ``sgd``      — stateless;
* ``momentum`` — its buffer ``m`` at the parameter's dtype;
* ``adam``     — float32 ``m`` and ``v``, an int32 step count ``t``.

The parameter updates run in float32 and are cast back to the
parameter's dtype; momentum's buffer update runs at its own dtype, with
``beta`` rounded to it first, as JAX's weak typing rounds a Python scalar
(:func:`weak`).
``update_fn`` writes the new values into ``params`` and ``opt_state`` in
place and returns them (the reference's train step donates both, so a
step holds one copy of each, not two); call it under ``torch.no_grad()``
when the parameters are autograd leaves.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

import torch

from repro_torch import tree as tree_util

PyTree = Any
OptPair = Tuple[Callable, Callable]

_F32 = torch.float32


def weak(value: float, like: torch.Tensor) -> torch.Tensor:
    """A Python scalar as JAX's weak typing applies it to ``like``: rounded
    to ``like``'s dtype (``0.9 * bf16_array`` multiplies by bf16(0.9) =
    0.8984375 in JAX, by float32(0.9) in torch)."""
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def _zip(*trees):
    return zip(*(tree_util.leaves(t) for t in trees))


def sgd(lr: float) -> OptPair:
    def init(params):
        return ()

    def update(grads, state, params):
        for p, g in _zip(params, grads):
            p.copy_((p.to(_F32) - lr * g.to(_F32)).to(p.dtype))
        return params, state

    return init, update


def momentum(lr: float, beta: float = 0.9) -> OptPair:
    def init(params):
        return {"m": tree_util.map(torch.zeros_like, params)}

    def update(grads, state, params):
        for p, m, g in _zip(params, state["m"], grads):
            m.mul_(weak(beta, m)).add_(g.to(m.dtype))
            p.copy_((p.to(_F32) - lr * m.to(_F32)).to(p.dtype))
        return params, state

    return init, update


def adam(lr: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> OptPair:
    def init(params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=_F32, device=p.device)
        leaf = tree_util.leaves(params)[0]
        return {"m": tree_util.map(zeros, params),
                "v": tree_util.map(zeros, params),
                "t": torch.zeros((), dtype=torch.int32, device=leaf.device)}

    def update(grads, state, params):
        t = state["t"].add_(1)
        tf = t.to(_F32)
        # 1 - b^t in float32, as the reference takes the bias corrections
        bc1 = 1 - torch.tensor(b1, dtype=_F32, device=t.device) ** tf
        bc2 = 1 - torch.tensor(b2, dtype=_F32, device=t.device) ** tf
        for p, m, v, g in _zip(params, state["m"], state["v"], grads):
            gf = g.to(_F32)
            m.mul_(b1).add_((1 - b1) * gf)
            v.mul_(b2).add_((1 - b2) * torch.square(gf))
            p.copy_((p.to(_F32) - lr * (m / bc1)
                     / (torch.sqrt(v / bc2) + eps)).to(p.dtype))
        return params, state

    return init, update


_REGISTRY = {"sgd": sgd, "momentum": momentum, "adam": adam}


def make(name: str, lr: float, **kw) -> OptPair:
    return _REGISTRY[name](lr, **kw)
