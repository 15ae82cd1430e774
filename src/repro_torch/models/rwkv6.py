"""RWKV6 "Finch" block (arXiv:2404.05892), the port of
``repro.models.rwkv6``: an attention-free layer with data-dependent decay.

Time-mix::

    xx_t   = x_{t-1} - x_t                       (token shift)
    z_q    = x_t + xx_t * mu_q,   q in {r, k, v, w, g}
    w_t    = exp(-exp(w0 + tanh(z_w A_w) B_w))   (low-rank data-dep decay)
    y_t    = WKV6(r, k, v, w, u)                 (kernels.ops.wkv6_scan, K12)
    out    = W_o (groupnorm(y) * silu(g))

Channel-mix (in place of the FFN)::

    r = sigmoid(W_r z_r);  k = relu(W_k z_k)^2;  out = r * (W_v k)

Decode state per block: ``(shift_tm, shift_cm (B, D), S (B, H, K, V))``,
O(1) in context length.  The shift states are carried at the model's
dtype, S in float32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models import layers


class RWKVState(NamedTuple):
    shift_tm: torch.Tensor   # (B, D)  last input to time-mix
    shift_cm: torch.Tensor   # (B, D)  last input to channel-mix
    s: torch.Tensor          # (B, H, K, V) wkv state


def rwkv6_init(gen: torch.Generator, d: int, d_ff: int, head_dim: int = 64,
               decay_rank: int = 64, dtype=torch.float32) -> dict:
    h = d // head_dim
    dev = gen.device

    def mu(rows):
        return (torch.rand((rows, d), generator=gen, device=dev) * 0.5).to(dtype)

    def normal(shape, scale, shift=0.0):
        return torch.randn(shape, generator=gen, device=dev) * scale + shift

    return {
        "mu": mu(5),                                      # r,k,v,w,g shifts
        "wr": layers.dense_init(gen, d, d, dtype),
        "wk": layers.dense_init(gen, d, d, dtype),
        "wv": layers.dense_init(gen, d, d, dtype),
        "wg": layers.dense_init(gen, d, d, dtype),
        "w0": normal((d,), 0.5, -6.0),                    # float32
        "wa": layers.dense_init(gen, d, decay_rank, dtype),
        "wb": layers.dense_init(gen, decay_rank, d, dtype),
        "u": normal((h, head_dim), 0.1),                  # float32
        "gn": layers.layernorm_init(d, dtype, dev),       # per-head groupnorm
        "wo": layers.dense_init(gen, d, d, dtype),
        # channel mix
        "cm_mu": mu(2),
        "cm_r": layers.dense_init(gen, d, d, dtype),
        "cm_k": layers.dense_init(gen, d, d_ff, dtype),
        "cm_v": layers.dense_init(gen, d_ff, d, dtype),
    }


def _shift(x: torch.Tensor, prev=None) -> torch.Tensor:
    """x_{t-1} with a zero (or carried) first token.  x: (B, T, D)."""
    if prev is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    return torch.cat([prev[:, None].to(x.dtype), x[:, :-1]], dim=1)


def _tm_inputs(params: dict, x: torch.Tensor, prev=None):
    xx = _shift(x, prev) - x
    mu = params["mu"]
    zr, zk, zv, zw, zg = (x + xx * mu[i] for i in range(5))
    r = layers.dense(params["wr"], zr)
    k = layers.dense(params["wk"], zk)
    v = layers.dense(params["wv"], zv)
    g = layers.dense(params["wg"], zg)
    dd = layers.dense(params["wb"], torch.tanh(layers.dense(params["wa"], zw)))
    w = torch.exp(-torch.exp(params["w0"] + dd.to(torch.float32)))  # in (0,1)
    return r, k, v, g, w


def _heads(x: torch.Tensor, head_dim: int) -> torch.Tensor:
    """(B, T, D) -> (B, H, T, head_dim), a view (no copy)."""
    b, t, d = x.shape
    return x.reshape(b, t, d // head_dim, head_dim).transpose(1, 2)


def _unheads(x: torch.Tensor) -> torch.Tensor:
    b, h, t, k = x.shape
    return x.transpose(1, 2).reshape(b, t, h * k)


def _gn_gate(params: dict, y: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    y = layers.layernorm(params["gn"], y)
    return layers.dense(params["wo"], y * F.silu(g))


def time_mix(params: dict, x: torch.Tensor, head_dim: int = 64) -> torch.Tensor:
    """x: (B, T, D) -> (B, T, D)."""
    r, k, v, g, w = _tm_inputs(params, x)
    rh, kh, vh, wh = (_heads(z, head_dim) for z in (r, k, v, w))
    y, _ = kops.wkv6_scan(rh, kh, vh, wh, params["u"])
    return _gn_gate(params, _unheads(y).to(x.dtype), g)


def time_mix_decode(params: dict, x: torch.Tensor, shift_prev: torch.Tensor,
                    s_prev: torch.Tensor, head_dim: int = 64):
    """One recurrence step, x: (B, 1, D).  Returns ``(out, shift, S)``."""
    r, k, v, g, w = _tm_inputs(params, x, prev=shift_prev)
    b, _, d = x.shape
    h = d // head_dim
    rh = r.reshape(b, h, head_dim).to(torch.float32)
    kh = k.reshape(b, h, head_dim).to(torch.float32)
    vh = v.reshape(b, h, head_dim).to(torch.float32)
    wh = w.reshape(b, h, head_dim)
    u = params["u"]
    kv = kh[..., :, None] * vh[..., None, :]                  # (B,H,K,V)
    y = torch.einsum("bhk,bhkv->bhv", rh, s_prev + u[None, :, :, None] * kv)
    s_new = wh[..., :, None] * s_prev + kv
    out = _gn_gate(params, y.reshape(b, 1, d).to(x.dtype), g)
    return out, x[:, -1], s_new


def channel_mix(params: dict, x: torch.Tensor, prev=None) -> torch.Tensor:
    xx = _shift(x, prev) - x
    mu = params["cm_mu"]
    zr, zk = x + xx * mu[0], x + xx * mu[1]
    r = torch.sigmoid(layers.dense(params["cm_r"], zr))
    k = torch.square(F.relu(layers.dense(params["cm_k"], zk)))
    return r * layers.dense(params["cm_v"], k)


def rwkv_init_state(batch: int, d: int, head_dim: int = 64,
                    dtype=torch.bfloat16, device="cuda") -> RWKVState:
    h = d // head_dim
    return RWKVState(
        shift_tm=torch.zeros((batch, d), dtype=dtype, device=device),
        shift_cm=torch.zeros((batch, d), dtype=dtype, device=device),
        s=torch.zeros((batch, h, head_dim, head_dim), dtype=torch.float32,
                      device=device))
