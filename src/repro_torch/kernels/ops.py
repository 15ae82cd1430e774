"""Kernel dispatch for the port: by tensor device, not by a global backend.

The uplink's ops take row-batched ``(rows, n)`` input, one row per
client's leaf; the model zoo's scans and attention take the recurrences'
and heads' own layouts.
A CPU tensor runs the plain PyTorch version; a CUDA tensor runs the
hand-written kernel or raises (the wrapper modules beside this one decide,
per call).  There is no switch that sends a CUDA tensor down the plain
path.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch import prng
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import pack_codes as _pack
from repro_torch.kernels import qr_pack as _qr_pack
from repro_torch.kernels import quantize as _quant
from repro_torch.kernels import rglru_scan as _rg
from repro_torch.kernels import select_slots as _sel
from repro_torch.kernels import topk_compress as _topk
from repro_torch.kernels import wkv6 as _wkv

_COUNTERS = (_topk.LAUNCHES, _quant.LAUNCHES, _sel.LAUNCHES,
             _qr_pack.LAUNCHES, _pack.LAUNCHES, _rg.LAUNCHES, _wkv.LAUNCHES,
             _fa.LAUNCHES)


def topk_mask(x: torch.Tensor, k) -> torch.Tensor:
    """Keep each row's ``k`` largest-magnitude entries (K1 and K2 in one
    launch).  ``k`` is an int, or a ``(rows,)`` integer tensor of per-row
    counts (per-client densities), clipped to ``[1, n]`` as the reference's
    ``topk_mask_dynamic`` clips them; a row whose k reaches n is kept as it
    is.  At an int ``k >= n`` the rows are returned as they are, with no
    launch."""
    n = x.shape[-1]
    if isinstance(k, torch.Tensor):
        return _topk.topk_mask(x, torch.clamp(k.to(torch.int64), 1, n))
    if int(k) >= n:
        return x
    return _topk.topk_mask(x, int(k))


def quantize_qr(x: torch.Tensor, r, keys: torch.Tensor) -> torch.Tensor:
    """Q_r of each row (K3 norm + K4 rounding) with row ``i``'s uniforms
    ``jax.random.uniform(keys[i], (n,))``, which K4 draws in the kernel (on
    the CPU, :func:`prng.uniform` draws them for the plain version).  ``r``
    is an int or a ``(rows,)`` integer tensor, one r a row."""
    return _quant.quantize_qr_keyed(x, r, keys, _quant.l2_norm(x))


def topk_slots(x: torch.Tensor, k: int, cap: int):
    """TopK select + slot extraction, the ``topk`` codec's encode (K1
    threshold + K5 compaction).  Returns ``(idx, vals, nnz)``: ``cap``
    int32 slot indices per row (sentinel ``n``), the survivors' values at
    x's dtype, and each row's survivor count, which the bit accounting
    reads."""
    return _sel.compact_slots(x, _topk.threshold_bits(x, int(k)), int(cap))


def topk_slots_masked(x: torch.Tensor, k: int, cap: int):
    """:func:`topk_slots` that also returns the masked rows (K1 and K2 in
    one launch, then K5 at that threshold): ``(idx, vals, masked)``, the
    float32 ``where(bits >= t, x, 0)`` rows beside the slots.  The
    ``topk`` codec's global unit counts each leaf's survivors from them."""
    t, masked = _topk.threshold_mask(x, int(k))
    idx, vals, _ = _sel.compact_slots(x, t, int(cap))
    return idx, vals, masked


def quantize_pack(x: torch.Tensor, r: int, keys: torch.Tensor):
    """Q_r quantize + bit-plane pack, the ``qr`` codec's encode (K3 norm +
    K7 codes).  Returns ``(words, norm)``: each row's (1+r)-bit codes in
    ``ceil(n/32) * (1+r)`` words and its l2 norm.  Uniforms and norm are
    those :func:`quantize_qr` uses (K7 draws the uniforms in the kernel; on
    the CPU, :func:`prng.uniform` draws them for the plain version), so the
    decode equals the transform except where a code saturates at
    ``2**r - 1``."""
    norm = _quant.l2_norm(x)
    return _qr_pack.quantize_pack_keyed(x, r, keys, norm), norm


def topk_slots_sharded(xs, ks, caps, n_totals, reduce) -> list:
    """Shard-local slots of the exact whole-row TopK, the model-sharded
    ``topk`` codec's encode (``repro.kernels.ops.topk_slots_sharded``),
    for several leaves at once: each row of ``xs[i]`` is this rank's slice
    of a row of ``n_totals[i]`` elements, ``reduce`` sums an ``(R, 256)``
    int32 histogram over the model ranks.  K1's histogram pass a digit and
    leaf, each digit's counts of every leaf reduced together and walked on
    the device, then K5 a leaf at the whole row's threshold and the
    per-shard ``caps[i]``.  Returns each leaf's ``(idx, vals, nnz)`` as
    :func:`topk_slots` does, the slots indexing the slice and ``nnz`` the
    slice's survivor count."""
    thrs = _topk.threshold_bits_sharded(xs, ks, n_totals, reduce)
    return [_sel.compact_slots(x, t, int(cap))
            for x, t, cap in zip(xs, thrs, caps)]


def sum_squares(x: torch.Tensor) -> torch.Tensor:
    """Each row's float32 sum of squares (K3's launch without its sqrt):
    the model-sharded ``qr`` codec sums it over the model ranks and takes
    the square root for the whole leaf's norm."""
    return _quant.sum_squares(x)


def quantize_pack_global_norm(x: torch.Tensor, r: int, keys: torch.Tensor,
                              norm: torch.Tensor) -> torch.Tensor:
    """:func:`quantize_pack` with the norm given (the whole leaf's, from
    the model ranks' summed squares) and each row's own keys (the client
    key folded with the model rank): K7's keyed entry alone.  Returns the
    ``(rows, ceil(n/32) * (1+r))`` words."""
    return _qr_pack.quantize_pack_keyed(x, r, keys, norm)


def topk_qr_slots(x: torch.Tensor, k: int, cap: int, r: int,
                  keys: torch.Tensor):
    """TopK -> Q_r -> packed slots, the ``topk_qr`` codec's encode (K1
    threshold and K2 masked rows in one launch, K3 norm of the masked rows,
    K6 coded slots, K8 pack).

    Row ``i`` draws its uniforms over the full n as
    ``jax.random.uniform(keys[i], (n,))``; the masked rows are the float32
    ``where(bits >= t, x, 0)`` the reference takes, so the norm has the
    bits the account path's K3 gives over the TopK mask.  Returns ``(idx,
    words, norm, nnz)``: ``cap`` int32 slot indices per row (sentinel
    ``n``), the survivors' (1+r)-bit codes in ``ceil(cap/32) * (1+r)``
    words, the masked rows' norms and each row's survivor count."""
    k, cap, r = int(k), int(cap), int(r)
    u = prng.uniform(keys, x.shape[-1], device=x.device)
    t, masked = _topk.threshold_mask(x, k)
    norm = _quant.l2_norm(masked)
    idx, codes, nnz = _sel.compact_code_slots(x, u, norm, t, r, cap)
    return idx, _pack.pack_codes(codes, 1 + r), norm, nnz


def pack_codes(codes: torch.Tensor, b: int) -> torch.Tensor:
    """Bit-plane pack each row's b-bit codes (K8)."""
    return _pack.pack_codes(codes, b)


def unpack_codes(words: torch.Tensor, b: int, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_codes`: each row's ``n`` b-bit codes (K9)."""
    return _pack.unpack_codes(words, b, n)


def unpack_qr_values(words: torch.Tensor, r: int, n: int,
                     norm: torch.Tensor) -> torch.Tensor:
    """Each row's ``n`` (1+r)-bit codes decoded to float32 Q_r values
    against ``norm[row]`` (K9's values entry, one launch), the ``qr`` and
    ``topk_qr`` codecs' decode."""
    return _pack.unpack_qr_values(words, r, n, norm)


class _RGLRUScan(torch.autograd.Function):
    """K11 forward, K11's backward kernel (``ref.rglru_scan_bwd`` on the
    CPU) for the gradient; saves x, a and the float32 y."""

    @staticmethod
    def forward(ctx, x, a):
        y, h = _rg.rglru_scan(x, a)
        ctx.save_for_backward(x, a, y)
        ctx.mark_non_differentiable(h)
        return y, h

    @staticmethod
    def backward(ctx, dy, _dh):
        x, a, y = ctx.saved_tensors
        return _rg.rglru_scan_bwd(x, a, y, dy)


class _WKV6Scan(torch.autograd.Function):
    """K12 forward (either route), K12's backward kernel
    (``ref.wkv6_scan_bwd`` on the CPU) for the gradient; saves only the
    inputs (the backward recomputes the states)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u):
        y, s = _wkv.wkv6_scan(r, k, v, w, u)
        ctx.save_for_backward(r, k, v, w, u)
        ctx.mark_non_differentiable(s)
        return y, s

    @staticmethod
    def backward(ctx, dy, _ds):
        return _wkv.wkv6_scan_bwd(*ctx.saved_tensors, dy)


def _differentiable(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def rglru_scan(x: torch.Tensor, a: torch.Tensor):
    """The RG-LRU scan (K11): x, a (B, T, D) -> (y at x's dtype, h_T
    float32).

    Differentiable in x and a (h_T carries no gradient: the training loss
    never reads it): the backward is K11's backward kernel on the card and
    ``ref.rglru_scan_bwd`` on the CPU, with no fallback from one to the
    other.  Where no input needs a gradient (serving, under
    ``torch.no_grad()``), K11 launches as it is and nothing is saved."""
    if _differentiable(x, a):
        return _RGLRUScan.apply(x, a)
    return _rg.rglru_scan(x, a)


def wkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor):
    """The RWKV6 WKV scan (K12): r, k, v, w (B, H, T, 64), u (H, 64) ->
    (y at r's dtype, S_T float32).

    Differentiable in r, k, v, w and u (S_T carries no gradient): the
    backward is K12's backward kernel on the card and
    ``ref.wkv6_scan_bwd`` on the CPU, no fallback.  The gradient is that of
    the float32 recurrence whatever the forward's route: K12's bf16 route
    is within 3e-4 of it, the relation the JAX package has between its
    Pallas forward and the ``ref.py`` scan it differentiates.  ``dy`` may
    arrive as a non-contiguous view (on the card y is a (B, H, T, 64) view
    of a (B, T, H, 64) tensor).  Where no input needs a gradient, K12
    launches as it is and nothing is saved."""
    if _differentiable(r, k, v, w, u):
        return _WKV6Scan.apply(r, k, v, w, u)
    return _wkv.wkv6_scan(r, k, v, w, u)


def mha_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  q_offset: int = 0,
                  softcap: Optional[float] = None) -> torch.Tensor:
    """Softmax attention with GQA, causal mask, sliding window, query
    offset and logit softcap (K10): q (B, Hq, Tq, Dh), k, v (B, Hkv, Tk,
    Dh) -> (B, Hq, Tq, Dh) at q's dtype.  The counterpart of the JAX
    package's ``ops.mha_attention``; no model calls it (they call
    ``models.attention.chunked_attention``, as the JAX package's do)."""
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               q_offset=q_offset, softcap=softcap)


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
