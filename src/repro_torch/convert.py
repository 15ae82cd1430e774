"""Carry the reference package's parameters into the port.

The tests start both packages from the same weights: the JAX side's
params, passed as a tree of numpy arrays, become the port's tensors with
the same dict layout.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import tree as tree_util


def params_from_jax(tree_of_numpy: Any, device="cuda") -> Any:
    """numpy leaves (e.g. ``jax.tree.map(np.asarray, params)``) -> tensors
    on ``device``, same nesting and dtypes."""
    return tree_util.map(
        lambda a: torch.from_numpy(np.array(a, copy=True)).to(device),
        tree_of_numpy)


def params_to_numpy(tree: Any) -> Any:
    """The inverse: tensors -> numpy leaves (host copies)."""
    return tree_util.map(lambda t: t.detach().cpu().numpy(), tree)
