"""RecurrentGemma / Griffin recurrent block (arXiv:2402.19427), the port of
``repro.models.rglru``.

Two parallel linear branches: a GeLU gate branch and a conv1d (width 4,
causal, depthwise) -> RG-LRU branch, multiplied and projected back.  The
RG-LRU recurrence::

    r_t = sigmoid(W_a x_t + b_a)          (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)          (input gate)
    a_t = exp(-c * softplus(Lambda) * r_t),  c = 8
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The time scan is :func:`repro_torch.kernels.ops.rglru_scan` (K11).  Decode
carries ``(conv buffer (B, 3, D_rnn), h (B, D_rnn))``, O(1) in context
length.  The GeLU is ``jax.nn.gelu``'s default, the tanh approximation.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models import layers

_C = 8.0
_CONV_W = 4


class RGLRUState(NamedTuple):
    conv: torch.Tensor   # (B, CONV_W-1, D_rnn) last inputs
    h: torch.Tensor      # (B, D_rnn) float32


def rglru_init(gen: torch.Generator, d: int, d_rnn: int,
               dtype=torch.float32) -> dict:
    dev = gen.device
    # Lambda init so that a in (0.9, 0.999) at r = 1 (Griffin appendix)
    lo = math.log(math.expm1(-math.log(0.999) / _C))
    hi = math.log(math.expm1(-math.log(0.9) / _C))
    lam = torch.rand((d_rnn,), generator=gen, device=dev) * (hi - lo) + lo
    conv = torch.randn((_CONV_W, d_rnn), generator=gen, device=dev) \
        * (1.0 / _CONV_W) ** 0.5
    return {
        "wx": layers.dense_init(gen, d, d_rnn, dtype),       # rnn branch in
        "wy": layers.dense_init(gen, d, d_rnn, dtype),       # gate branch in
        "conv": {"kernel": conv.to(dtype)},
        "gate_a": layers.dense_init(gen, d_rnn, d_rnn, dtype, bias=True),
        "gate_x": layers.dense_init(gen, d_rnn, d_rnn, dtype, bias=True),
        "lam": lam,                                          # float32
        "wo": layers.dense_init(gen, d_rnn, d, dtype),
    }


def _causal_depthwise_conv(kernel: torch.Tensor, x: torch.Tensor,
                           state=None):
    """x: (B, T, D); kernel (W, D); causal depthwise conv as the reference's
    shifted slices summed in tap order (not a ``conv1d``, whose sum order
    differs).  state: (B, W-1, D) previous inputs for decode; returns
    ``(y, new_state)``."""
    w = kernel.shape[0]
    if state is None:
        hist = F.pad(x, (0, 0, w - 1, 0))
    else:
        hist = torch.cat([state.to(x.dtype), x], dim=1)
    t = x.shape[1]
    y = sum(hist[:, i:i + t] * kernel[i] for i in range(w))
    return y, hist[:, -(w - 1):]


def _rglru_gates(params: dict, xc: torch.Tensor):
    r = torch.sigmoid(layers.dense(params["gate_a"], xc).to(torch.float32))
    i = torch.sigmoid(layers.dense(params["gate_x"], xc).to(torch.float32))
    # jax.nn.softplus is logaddexp(x, 0); torch's goes linear above 20, and
    # the init range of Lambda, [-9.0, -4.3], stays far below that
    log_a = -_C * F.softplus(params["lam"]) * r
    return torch.exp(log_a), i


def rglru_block(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Prefill forward.  x: (B, T, D) -> (B, T, D)."""
    gate = layers.gelu(layers.dense(params["wy"], x))
    xr = layers.dense(params["wx"], x)
    xc, _ = _causal_depthwise_conv(params["conv"]["kernel"], xr)
    a, i = _rglru_gates(params, xc)
    ys, _ = kops.rglru_scan(i * xc.to(torch.float32), a)
    return layers.dense(params["wo"], ys.to(x.dtype) * gate)


def rglru_block_decode(params: dict, x: torch.Tensor, state: RGLRUState):
    """One-token step.  x: (B, 1, D) -> ((B, 1, D), new state)."""
    gate = layers.gelu(layers.dense(params["wy"], x))
    xr = layers.dense(params["wx"], x)
    xc, conv_state = _causal_depthwise_conv(
        params["conv"]["kernel"], xr, state.conv)
    a, i = _rglru_gates(params, xc)                          # (B, 1, D_rnn)
    gx = torch.sqrt(torch.clamp(1.0 - a * a, min=0.0)) * (
        i * xc.to(torch.float32))
    h = a[:, 0] * state.h + gx[:, 0]                         # (B, D_rnn)
    out = h[:, None].to(x.dtype) * gate
    return layers.dense(params["wo"], out), RGLRUState(conv=conv_state, h=h)


def rglru_init_state(batch: int, d_rnn: int, dtype=torch.bfloat16,
                     device="cuda") -> RGLRUState:
    return RGLRUState(
        conv=torch.zeros((batch, _CONV_W - 1, d_rnn), dtype=dtype,
                         device=device),
        h=torch.zeros((batch, d_rnn), dtype=torch.float32, device=device))
