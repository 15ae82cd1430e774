"""Plain PyTorch versions of the kernels on the port's uplink path.

These are the oracles the CUDA kernels are held against on the card, and
the path a wrapper takes when its tensor lies on the CPU.  They mirror
``repro.kernels.ref`` and the Pallas kernels' semantics, batched over
rows: every function takes ``(rows, n)`` and treats each row as one
vector (one client's leaf), with a per-row ``k`` or norm.

uint32 bit patterns are held in int64 (torch's uint32 coverage is thin):
magnitudes have a clear sign bit, so their patterns are exact non-negative
int64 values and the integer order is the float order.
"""

from __future__ import annotations

import torch

#: MSB-first 8-bit digit positions of the radix threshold walk.
RADIX_SHIFTS = (24, 16, 8, 0)
ALL_ONES = 0xFFFFFFFF


def _rows(x: torch.Tensor) -> torch.Tensor:
    if x.dim() != 2:
        raise ValueError(f"expects (rows, n) input, got shape {tuple(x.shape)}")
    return x


def _per_row(v, rows: int, device) -> torch.Tensor:
    t = torch.as_tensor(v, dtype=torch.int64, device=device)
    return t.expand(rows) if t.dim() == 0 else t


def mag_bits(x: torch.Tensor) -> torch.Tensor:
    """|x| as uint32 bit patterns (after an f32 cast), in int64.

    The f32 cast is an exact order-embedding for bf16 inputs, so masks on
    the cast bits equal masks on the original dtype."""
    return x.to(torch.float32).abs().view(torch.int32).to(torch.int64)


def radix_digit_hist(bits: torch.Tensor, prefix: torch.Tensor,
                     shift: int) -> torch.Tensor:
    """Per-row 256-bin integer histogram of the 8-bit digit at ``shift``,
    counting only elements whose decided high bits match ``prefix[row]``.
    Integer counts are exact at any size (the TPU kernel's float32 counts
    are exact only below 2**24)."""
    high = (ALL_ONES << (shift + 8)) & ALL_ONES if shift + 8 < 32 else 0
    match = (bits & high) == (prefix[:, None] & high)
    digit = (bits >> shift) & 0xFF
    hist = torch.zeros((bits.shape[0], 256), dtype=torch.int64,
                       device=bits.device)
    return hist.scatter_add_(1, digit, match.to(torch.int64))


def radix_walk_step(hist: torch.Tensor, k_rem: torch.Tensor):
    """Fix one digit per row: the largest ``d`` with ``count(digit >= d)
    >= k_rem``; ``k_rem`` loses the strictly-greater bucket."""
    ge = torch.flip(torch.cumsum(torch.flip(hist, (1,)), 1), (1,))
    digit = torch.clamp((ge >= k_rem[:, None]).sum(1) - 1, 0, 255)
    above = torch.where(
        digit < 255,
        ge.gather(1, torch.clamp(digit + 1, max=255)[:, None])[:, 0],
        torch.zeros_like(k_rem))
    return digit, k_rem - above


def topk_threshold_bits(x: torch.Tensor, k) -> torch.Tensor:
    """Per-row uint32 bit pattern (int64) of the k-th largest ``|x|``.

    Four radix-histogram passes, MSB first, exactly as the TPU kernel
    walks them (``repro.kernels.topk_compress.threshold_bits``), with its
    edge conventions: ``k >= n`` gives 0 (every entry kept) and ``k <= 0``
    gives ``0xFFFFFFFF`` (empty support).  For ``1 <= k < n`` this is the
    value ``repro.kernels.ref.topk_threshold_bits`` returns: the largest
    ``t`` with ``count(bits >= t) >= k``, ties included.
    """
    x = _rows(x)
    rows, n = x.shape
    kk = _per_row(k, rows, x.device)
    bits = mag_bits(x)
    prefix = torch.zeros(rows, dtype=torch.int64, device=x.device)
    k_rem = kk.clone()
    for shift in RADIX_SHIFTS:
        hist = radix_digit_hist(bits, prefix, shift)
        digit, k_rem = radix_walk_step(hist, k_rem)
        prefix = prefix | (digit << shift)
    prefix = torch.where(kk >= n, torch.zeros_like(prefix), prefix)
    return torch.where(kk <= 0, torch.full_like(prefix, ALL_ONES), prefix)


def mask_by_threshold(x: torch.Tensor, thr: torch.Tensor) -> torch.Tensor:
    """``where(bits >= t[row], x, 0)`` — the TopK mask pass, in x's dtype."""
    x = _rows(x)
    keep = mag_bits(x) >= thr[:, None]
    return torch.where(keep, x, torch.zeros_like(x))


def topk_mask(x: torch.Tensor, k) -> torch.Tensor:
    """Zero all but each row's k largest-magnitude entries (ties at the
    threshold kept; ``k >= n`` returns the row unchanged)."""
    return mask_by_threshold(x, topk_threshold_bits(x, k))


def l2_norm(x: torch.Tensor) -> torch.Tensor:
    """Per-row ``sqrt(sum(x**2))`` over float32 values."""
    xf = _rows(x).to(torch.float32)
    return torch.sqrt(torch.sum(xf * xf, dim=1))


def _jax_sign(x: torch.Tensor) -> torch.Tensor:
    """``jnp.sign``: +-1, and x itself at +-0 and NaN (``torch.sign``
    returns +0 for -0.0 and 0 for NaN)."""
    one = torch.ones_like(x)
    return torch.where(x > 0, one, torch.where(x < 0, -one, x))


def quantize_qr_with_uniforms(x: torch.Tensor, r: int, u: torch.Tensor,
                              norm: torch.Tensor) -> torch.Tensor:
    """Q_r of each row with the row's ``norm`` and uniforms ``u`` given.

    Same operation order as ``repro.kernels.ref.quantize_qr_with_uniforms``
    (and the TPU kernel), so equal inputs give bit-equal outputs.
    """
    x = _rows(x)
    levels = float(2 ** int(r))
    xf = x.to(torch.float32)
    nrm = norm.to(torch.float32)[:, None]
    pos = nrm > 0
    y = xf.abs() / torch.where(pos, nrm, torch.ones_like(nrm))
    scaled = levels * y
    lo = torch.floor(scaled)
    frac = scaled - lo
    xi = (lo + (u < frac).to(torch.float32)) / levels
    out = nrm * _jax_sign(xf) * xi
    return torch.where(pos, out, torch.zeros_like(out)).to(x.dtype)
