"""Kernel dispatch for the port: by tensor device, not by a global backend.

Each op takes row-batched ``(rows, n)`` input, one row per client's leaf.
A CPU tensor runs the plain PyTorch version; a CUDA tensor runs the
hand-written kernel or raises (the wrappers in
:mod:`repro_torch.kernels.topk_compress` and
:mod:`repro_torch.kernels.quantize` decide, per call).  There is no
switch that sends a CUDA tensor down the plain path.
"""

from __future__ import annotations

import torch

from repro_torch import prng
from repro_torch.kernels import quantize as _quant
from repro_torch.kernels import topk_compress as _topk

_COUNTERS = (_topk.LAUNCHES, _quant.LAUNCHES)


def topk_mask(x: torch.Tensor, k: int) -> torch.Tensor:
    """Keep each row's ``k`` largest-magnitude entries (K1 + K2); at
    ``k >= n`` the rows are returned as they are, with no launch."""
    if int(k) >= x.shape[-1]:
        return x
    return _topk.topk_mask(x, int(k))


def quantize_qr(x: torch.Tensor, r: int, keys: torch.Tensor) -> torch.Tensor:
    """Q_r of each row (K3 norm + K4 rounding) with row ``i``'s uniforms
    drawn as ``jax.random.uniform(keys[i], (n,))`` on x's device."""
    u = prng.uniform(keys, x.shape[-1], device=x.device)
    return _quant.quantize_qr_with_uniforms(x, r, u, _quant.l2_norm(x))


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset (CUDA path only)."""
    out = {}
    for c in _COUNTERS:
        out.update(c)
    return out


def reset_launch_counts() -> None:
    for c in _COUNTERS:
        for name in c:
            c[name] = 0
