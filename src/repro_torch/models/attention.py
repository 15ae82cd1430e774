"""Attention for training, prefill and decode, the port of
``repro.models.attention``.

* :func:`chunked_attention` — blockwise online softmax over KV chunks; it
  never forms the (Tq, Tk) matrix.  It keeps both of the reference's
  routes: the flash route (``_flash_fwd_impl``: the scale folded into q at
  q's dtype, products accumulated in float32) when ``kv_length`` is None,
  and the explicit-length route (q cast to float32 first, keys past
  ``kv_length`` masked) otherwise.  The flash route is the reference's
  custom-VJP ``_flash`` as a ``torch.autograd.Function``: it saves (q, k,
  v, out, lse) and its backward recomputes each chunk.
* :func:`decode_attention` — one query token against a linear KV cache.
* :func:`ring_decode_attention` — one query token against a ring cache of
  ``window`` slots (sliding-window layers).

GQA folds the queries to (B, Hkv, G*T, Dh) and contracts against the
shared KV heads.  This is plain PyTorch: the reference computes it outside
any Pallas kernel too.  ``preferred_element_type=float32`` products of
bf16 operands become float32 products of the operands cast to float32
(exact products, float32 sums).

A cache's ``length`` is a Python int (the reference's int32 scalar); cache
updates return new tensors and leave the old cache as it was, as the
reference's functional updates do.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

_NEG_INF = -1e30


class KVCache(NamedTuple):
    k: torch.Tensor       # (B, Hkv, S, Dh)
    v: torch.Tensor       # (B, Hkv, S, Dh)
    length: int           # tokens currently valid


def init_cache(batch: int, n_kv: int, max_len: int, dh: int,
               dtype=torch.bfloat16, device="cuda") -> KVCache:
    return KVCache(
        k=torch.zeros((batch, n_kv, max_len, dh), dtype=dtype, device=device),
        v=torch.zeros((batch, n_kv, max_len, dh), dtype=dtype, device=device),
        length=0)


def _fold_gqa(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """(B, Hq, T, Dh) -> (B, Hkv, G*T, Dh): each KV head's G query heads
    stacked as rows, so one batched product per KV head serves them."""
    b, hq, t, dh = q.shape
    return q.reshape(b, n_kv, hq // n_kv * t, dh)


def _f32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a.to(torch.float32) @ b.to(torch.float32)


def _chunk_mask(kpos, qpos, limit, causal, window):
    """The (Tq, ck) visibility of one key chunk, or None (all visible)."""
    mask = None
    if limit is not None:
        mask = (kpos[None, :] < limit).expand(qpos.shape[0], kpos.shape[0])
    if causal:
        cm = kpos[None, :] <= qpos[:, None]
        mask = cm if mask is None else mask & cm
    if window is not None:
        wm = kpos[None, :] > qpos[:, None] - window
        mask = wm if mask is None else mask & wm
    return mask


def _online_softmax(qf, k, v, qpos, g, *, causal, window, limit, softcap,
                    chunk):
    """The forward scan over KV chunks: ``(acc, m, l)`` of the folded
    float32 queries ``qf`` (B, Hkv, G*Tq, Dh) against k, v (B, Hkv, Tk,
    Dh), Tk a multiple of ``chunk``."""
    b, hkv, rows, dh = qf.shape
    m = torch.full((b, hkv, rows, 1), _NEG_INF, dtype=torch.float32,
                   device=qf.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, rows, dh), dtype=torch.float32,
                      device=qf.device)
    for ci in range(k.shape[2] // chunk):
        kb = k[:, :, ci * chunk:(ci + 1) * chunk]          # (B,Hkv,ck,Dh)
        vb = v[:, :, ci * chunk:(ci + 1) * chunk]
        kpos = ci * chunk + torch.arange(chunk, device=qf.device)
        s = qf @ kb.transpose(-1, -2).to(torch.float32)     # (B,Hkv,G*Tq,ck)
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        mask = _chunk_mask(kpos, qpos, limit, causal, window)
        if mask is not None:                                # (Tq, ck) per head
            s = torch.where(mask.repeat(g, 1), s, torch.full_like(s, _NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + _f32_matmul(p.to(v.dtype), vb)
        m = m_new
    return acc, m, l


class _Flash(torch.autograd.Function):
    """The reference's custom-VJP ``_flash`` (``repro.models.attention``):
    the forward saves only (q, k, v, out, lse); the backward recomputes
    each chunk's probabilities from lse (``_flash_bwd``: ``delta``, the
    softcap's ``1 - th^2``, the mask).  k, v arrive padded to a multiple
    of ``chunk``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, softcap, chunk):
        b, hq, tq, dh = q.shape
        hkv = k.shape[1]
        g = hq // hkv
        # the reference's _flash_fwd_impl: scale cast to q's dtype and
        # folded into q before the products; causal masking hides the
        # end padding (kpos > max qpos)
        scale = torch.tensor(1.0 / (dh ** 0.5), dtype=q.dtype, device=q.device)
        qf = (_fold_gqa(q, hkv) * scale).to(torch.float32)
        qpos = q_offset + torch.arange(tq, device=q.device)
        acc, m, l = _online_softmax(qf, k, v, qpos, g, causal=causal,
                                    window=window, limit=None,
                                    softcap=softcap, chunk=chunk)
        seen = l > 0
        one = torch.ones_like(l)
        # +1e30 for rows with no visible key, so the backward's p is 0
        lse = torch.where(seen, m + torch.log(torch.where(seen, l, one)),
                          torch.full_like(l, 1e30))
        out = (acc / torch.where(seen, l, one)).reshape(b, hq, tq, dh).to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = (causal, window, q_offset, softcap, chunk)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, q_offset, softcap, chunk = ctx.opts
        b, hq, tq, dh = q.shape
        hkv, tk = k.shape[1], k.shape[2]
        g = hq // hkv
        scale = 1.0 / (dh ** 0.5)
        f32 = torch.float32
        qf = _fold_gqa(q, hkv).to(f32)
        of = _fold_gqa(out, hkv).to(f32)
        dof = _fold_gqa(dout, hkv).to(f32)
        qpos = q_offset + torch.arange(tq, device=q.device)
        delta = torch.sum(of * dof, dim=-1, keepdim=True)  # (B,Hkv,G*Tq,1)
        dq = torch.zeros_like(qf)
        dk = torch.empty((b, hkv, tk, dh), dtype=f32, device=q.device)
        dv = torch.empty_like(dk)
        for ci in range(tk // chunk):
            sl = slice(ci * chunk, (ci + 1) * chunk)
            kb, vb = k[:, :, sl].to(f32), v[:, :, sl].to(f32)
            kpos = ci * chunk + torch.arange(chunk, device=q.device)
            s_raw = (qf @ kb.transpose(-1, -2)) * scale
            if softcap is not None:
                th = torch.tanh(s_raw / softcap)
                s = softcap * th
            else:
                s = s_raw
            mask = _chunk_mask(kpos, qpos, None, causal, window)
            if mask is not None:
                mask = mask.repeat(g, 1)
                s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
            p = torch.exp(s - lse)                          # (B,Hkv,G*Tq,ck)
            dv[:, :, sl] = p.transpose(-1, -2) @ dof
            dp = dof @ vb.transpose(-1, -2)
            ds = p * (dp - delta)
            if softcap is not None:
                ds = ds * (1.0 - th * th)
            if mask is not None:
                ds = torch.where(mask, ds, torch.zeros_like(ds))
            dq = dq + (ds @ kb) * scale
            dk[:, :, sl] = (ds.transpose(-1, -2) @ qf) * scale
        return (dq.reshape(b, hq, tq, dh).to(q.dtype), dk.to(k.dtype),
                dv.to(v.dtype), None, None, None, None, None)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None,
                      q_offset: int = 0, softcap: Optional[float] = None,
                      kv_length: Optional[int] = None,
                      chunk: int = 512) -> torch.Tensor:
    """Blockwise online-softmax attention over KV chunks.

    q: (B, Hq, Tq, Dh); k, v: (B, Hkv, Tk, Dh).  Returns (B, Hq, Tq, Dh) at
    q's dtype.  ``window``: keys within ``window`` positions of the query;
    ``softcap``: ``softcap * tanh(logits / softcap)``; ``kv_length``: the
    valid prefix of k/v.  Where the reference routes to its custom-VJP
    ``_flash`` (``kv_length`` None, and no end padding unless causal), so
    does this (:class:`_Flash`, whose backward recomputes each chunk);
    the explicit-length route is differentiated by autograd, as the
    reference's plain scan is by ``jax.grad``.
    """
    b, hq, tq, dh = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    g = hq // hkv
    chunk = min(chunk, tk)
    pad = (-tk) % chunk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    if kv_length is None and (not pad or causal):
        return _Flash.apply(q, k, v, causal, window, q_offset, softcap, chunk)
    qf = _fold_gqa(q, hkv).to(torch.float32) * (1.0 / (dh ** 0.5))
    qpos = q_offset + torch.arange(tq, device=q.device)
    acc, _, l = _online_softmax(
        qf, k, v, qpos, g, causal=causal, window=window,
        limit=tk if kv_length is None else int(kv_length), softcap=softcap,
        chunk=chunk)
    out = acc / torch.where(l > 0, l, torch.ones_like(l))
    return out.reshape(b, hq, tq, dh).to(q.dtype)


def decode_attention(q: torch.Tensor, cache: KVCache, *,
                     window: Optional[int] = None,
                     softcap: Optional[float] = None) -> torch.Tensor:
    """One query token (B, Hq, 1, Dh) against the (already updated) cache."""
    b, hq, _, dh = q.shape
    hkv, s_len = cache.k.shape[1], cache.k.shape[2]
    qf = _fold_gqa(q, hkv).to(torch.float32) / (dh ** 0.5)   # (B,Hkv,G,Dh)
    qpos = cache.length - 1
    kpos = torch.arange(s_len, device=q.device)
    mask = kpos <= qpos
    if window is not None:
        mask = mask & (kpos > qpos - window)
    s = _f32_matmul(qf, cache.k.transpose(-1, -2))          # (B,Hkv,G,S)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = _f32_matmul(p, cache.v)
    return out.reshape(b, hq, 1, dh).to(q.dtype)


def _write(buf: torch.Tensor, new: torch.Tensor, start: int) -> torch.Tensor:
    """``lax.dynamic_update_slice_in_dim(buf, new, start, axis=2)``: the
    start is clamped so that the update fits, as XLA clamps it."""
    t_new = new.shape[2]
    start = max(0, min(int(start), buf.shape[2] - t_new))
    out = buf.clone()
    out[:, :, start:start + t_new] = new.to(buf.dtype)
    return out


def update_cache(cache: KVCache, k_new: torch.Tensor,
                 v_new: torch.Tensor) -> KVCache:
    """Append k/v (B, Hkv, T_new, Dh) at the current length."""
    return KVCache(k=_write(cache.k, k_new, cache.length),
                   v=_write(cache.v, v_new, cache.length),
                   length=cache.length + k_new.shape[2])


def init_ring_cache(batch: int, n_kv: int, window: int, dh: int,
                    dtype=torch.bfloat16, device="cuda") -> KVCache:
    return init_cache(batch, n_kv, window, dh, dtype, device)


def update_ring_cache(cache: KVCache, k_new: torch.Tensor,
                      v_new: torch.Tensor) -> KVCache:
    """One-token ring-buffer append (decode): slot ``length % window``."""
    if k_new.shape[2] != 1:
        raise ValueError("ring cache append is one token at a time")
    slot = cache.length % cache.k.shape[2]
    return KVCache(k=_write(cache.k, k_new, slot),
                   v=_write(cache.v, v_new, slot),
                   length=cache.length + 1)


def ring_decode_attention(q: torch.Tensor, cache: KVCache, *,
                          softcap: Optional[float] = None) -> torch.Tensor:
    """Decode against a ring cache: every stored entry within the window is
    valid; slots at or beyond ``length`` (cold start) are masked."""
    b, hq, _, dh = q.shape
    hkv, window = cache.k.shape[1], cache.k.shape[2]
    qf = _fold_gqa(q, hkv).to(torch.float32) / (dh ** 0.5)
    valid = torch.arange(window, device=q.device) < min(cache.length, window)
    s = _f32_matmul(qf, cache.k.transpose(-1, -2))          # (B,Hkv,G,S)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    s = torch.where(valid, s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = _f32_matmul(p, cache.v)
    return out.reshape(b, hq, 1, dh).to(q.dtype)
