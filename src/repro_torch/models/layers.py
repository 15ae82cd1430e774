"""Shared building blocks of the model zoo, the port of
``repro.models.layers``.

Parameters are nested dicts of tensors with the reference's names and
layouts (a dense kernel is ``(n_in, n_out)`` applied as ``x @ kernel``),
so the reference's weights carry across unchanged
(:func:`repro_torch.convert.params_from_jax`).  Initialisers draw from an
explicit ``torch.Generator`` on the generator's device; they follow the
reference's distributions, not its bits.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# float32 matrix products stay in full float32 (no TF32), as on the reference
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _normal(gen: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, device=gen.device)
            * scale).to(dtype)


# --------------------------------------------------------------------------- #
# initialisers
# --------------------------------------------------------------------------- #

def dense_init(gen: torch.Generator, n_in: int, n_out: int,
               dtype=torch.float32, bias: bool = False, scale=None) -> dict:
    if scale is None:
        scale = (1.0 / n_in) ** 0.5
    p = {"kernel": _normal(gen, (n_in, n_out), scale, dtype)}
    if bias:
        p["bias"] = torch.zeros((n_out,), dtype=dtype, device=gen.device)
    return p


def dense(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["kernel"]
    if "bias" in p:
        y = y + p["bias"]
    return y


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype=torch.float32) -> dict:
    return {"embedding": _normal(gen, (vocab, d), 0.02, dtype)}


def embed(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    return p["embedding"][tokens]


def rmsnorm_init(d: int, dtype=torch.float32, device="cuda") -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm computed in float32, returned at x's dtype."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * p["scale"].to(torch.float32)
    return y.to(x.dtype)


def layernorm_init(d: int, dtype=torch.float32, device="cuda") -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm computed in float32, returned at x's dtype."""
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)
    return y.to(x.dtype)


# --------------------------------------------------------------------------- #
# RoPE (standard + multimodal M-RoPE)
# --------------------------------------------------------------------------- #

def rope_freqs(dh: int, theta: float = 10_000.0,
               device="cuda") -> torch.Tensor:
    exps = torch.arange(0, dh, 2, dtype=torch.float32, device=device) / dh
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """x: (B, H, T, Dh); positions: (B, T) absolute positions."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                  # (dh/2,)
    ang = positions[:, None, :, None].to(torch.float32) * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor,
                sections=(16, 24, 24), theta: float = 10_000.0) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE (arXiv:2409.12191).

    x: (B, H, T, Dh); positions3: (B, 3, T), the temporal / height / width
    position ids.  ``sections`` splits the dh/2 rotary frequencies among
    the three axes in that order; tokens whose t/h/w ids are equal (text)
    get exactly :func:`apply_rope`'s rotation.
    """
    dh = x.shape[-1]
    half = dh // 2
    if sum(sections) != half:
        raise ValueError(f"sections {tuple(sections)} must sum to {half}")
    freqs = rope_freqs(dh, theta, x.device)                  # (half,)
    sec_id = torch.repeat_interleave(
        torch.arange(3, device=x.device),
        torch.tensor(tuple(sections), device=x.device))       # (half,)
    pos = positions3.to(torch.float32)[:, sec_id, :]          # (B, half, T)
    ang = pos.transpose(1, 2)[:, None] * freqs                # (B,1,T,half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------- #
# feed-forward blocks
# --------------------------------------------------------------------------- #

def mlp_init(gen: torch.Generator, d: int, d_ff: int, dtype=torch.float32,
             gated: bool = True) -> dict:
    p = {"wi": dense_init(gen, d, d_ff, dtype),
         "wo": dense_init(gen, d_ff, d, dtype)}
    if gated:
        p["wg"] = dense_init(gen, d, d_ff, dtype)
    return p


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation (not torch's
    default erf form)."""
    return F.gelu(x, approximate="tanh")


_ACTS = {"silu": F.silu, "gelu": gelu, "relu": F.relu, "gelu_tanh": gelu,
         "sqrelu": lambda x: torch.square(F.relu(x))}


def mlp(p: dict, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    a = _ACTS[act]
    h = dense(p["wi"], x)
    if "wg" in p:
        h = a(dense(p["wg"], x)) * h
    else:
        h = a(h)
    return dense(p["wo"], h)


def softcap(x: torch.Tensor, cap) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)
