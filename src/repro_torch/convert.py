"""Carry the reference package's parameters and training state into the
port, and back.

The tests start both packages from the same state: the JAX side's trees,
passed as numpy arrays, become the port's tensors with the same dict
layout.  Any tree of the two packages' shared layouts crosses: model
parameters, the optimizers' states (Adam's float32 ``m``/``v`` and int32
step ``t``, momentum's ``m``; SGD's empty tuple) and the fed round's
stacked parameters and control variates ``h`` (a leading client axis on
every leaf), so multi-step runs start both packages from one state.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import tree as tree_util


def _from_numpy(a) -> torch.Tensor:
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16 has no torch counterpart in from_numpy: it
        # crosses as its uint16 bits
        return torch.from_numpy(a.view(np.uint16).view(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(a)


def to_host(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host numpy array.  numpy has no bfloat16 of its own
    (``ml_dtypes`` adds one, and the port never imports it), so a bfloat16
    tensor always comes back as its uint16 bits; a caller that has
    ``ml_dtypes`` views them as ``ml_dtypes.bfloat16``."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def params_from_jax(tree_of_numpy: Any, device="cuda") -> Any:
    """numpy leaves (e.g. ``jax.tree.map(np.asarray, params)``) -> tensors
    on ``device``, same nesting and dtypes (bfloat16 bit for bit).  Also
    an optimizer state or a stacked tree (the module docstring)."""
    return tree_util.map(lambda a: _from_numpy(a).to(device), tree_of_numpy)


def params_to_numpy(tree: Any) -> Any:
    """The inverse: tensors -> numpy leaves (bfloat16 leaves as their
    uint16 bits, see :func:`to_host`)."""
    return tree_util.map(to_host, tree)
