"""Mixture-of-Experts feed-forward (Mixtral 8x7B top-2, Llama-4 128e
top-1), the port of ``repro.models.moe``.

GShard-style capacity-based token-choice routing with static shapes:
tokens are processed in groups of ``group_size`` (the last group padded
with zero rows); in each group every expert has capacity C =
``MoEConfig.capacity()``, tokens queue for their experts in (token,
choice) order, and a route past C is dropped (its weight set to 0).  The
router carries the Switch-style load-balance auxiliary loss.  The
reference's sharding pins are no-ops without a mesh; the one-card port
has none.

Where torch's defaults differ from the reference's, the port follows the
reference:

* top-k picks the lowest expert index first among equal probabilities,
  as ``jax.lax.top_k`` does (padded rows tie on every expert), by a
  stable descending sort;
* a dropped route's queue position (>= C) one-hots to a zero row, as
  ``jax.nn.one_hot`` gives;
* the casts sit where the reference's are: the router product in the
  model dtype, then float32 for the softmax, top-k and the queue; the
  dispatch and combine one-hots cast to the activations' dtype before
  their products; the expert products in the activations' dtype.

The expert products are batched matrix products over the expert axis
(``torch.bmm``): the reference computes them outside any Pallas kernel.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    topk: int = 2
    group_size: int = 256
    capacity_factor: float = 1.25

    def capacity(self) -> int:
        c = self.group_size * self.topk * self.capacity_factor / self.n_experts
        return max(4, int(-(-c // 1)))  # ceil, floor of 4


def _normal_experts(gen: torch.Generator, shape, scale: float,
                    dtype) -> torch.Tensor:
    """``layers._normal``'s distribution, drawn one expert at a time into a
    leaf of ``dtype``: a float32 temporary of a whole leaf would be 21.5 GB
    for one llama4 expert weight."""
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    for j in range(shape[0]):
        out[j] = layers._normal(gen, shape[1:], scale, dtype)
    return out


def moe_init(gen: torch.Generator, d: int, d_ff: int, cfg: MoEConfig,
             dtype=torch.float32) -> dict:
    """The reference's layout and distributions: a float32 ``router``
    (d, E) and expert kernels ``wi``/``wg`` (E, d, d_ff), ``wo`` (E, d_ff,
    d) of ``dtype``."""
    e = cfg.n_experts
    return {
        "router": layers.dense_init(gen, d, e, torch.float32),
        "wi": {"kernel": _normal_experts(gen, (e, d, d_ff), (1.0 / d) ** 0.5,
                                         dtype)},
        "wg": {"kernel": _normal_experts(gen, (e, d, d_ff), (1.0 / d) ** 0.5,
                                         dtype)},
        "wo": {"kernel": _normal_experts(gen, (e, d_ff, d),
                                         (1.0 / d_ff) ** 0.5, dtype)},
    }


def group_tokens(x: torch.Tensor, cfg: MoEConfig):
    """(B, T, D) -> ((G, S, D) groups of S = min(group_size, B T) tokens,
    the last padded with zero rows; the number of real tokens B T)."""
    d = x.shape[-1]
    tokens = x.reshape(-1, d)
    n_tok = tokens.shape[0]
    gs = min(cfg.group_size, n_tok)
    pad = (-n_tok) % gs
    if pad:
        tokens = F.pad(tokens, (0, 0, 0, pad))
    return tokens.reshape(-1, gs, d), n_tok


class Routing(NamedTuple):
    """One MoE layer's routing decisions for its (G, S) grouped tokens."""
    probs: torch.Tensor     # (G, S, E) float32 router softmax
    topi: torch.Tensor      # (G, S, k) int64 chosen experts, best first
    topw: torch.Tensor      # (G, S, k) float32 renormalised weights, 0 if dropped
    keep: torch.Tensor      # (G, S, k) bool: the route fits its expert's queue
    pos: torch.Tensor       # (G, S, k) float32 place in the expert's queue


def route(params: dict, xt: torch.Tensor, cfg: MoEConfig) -> Routing:
    """The router, top-k and capacity assignment of grouped tokens
    ``xt`` (G, S, D)."""
    g, gs, _ = xt.shape
    e, k = cfg.n_experts, cfg.topk
    logits = (xt @ params["router"]["kernel"].to(xt.dtype)).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    # jax.lax.top_k's order: descending, the lower index first on ties
    topi = torch.sort(probs, dim=-1, descending=True, stable=True)[1][..., :k]
    topw = torch.gather(probs, -1, topi)
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    # the place of each route in its expert's queue: earlier tokens first,
    # ranked over the (S, k) routes, s-major (exact float32 counts)
    sel = F.one_hot(topi, e).to(torch.float32).reshape(g, gs * k, e)
    before = torch.cumsum(sel, dim=1) - sel
    pos = (before * sel).sum(-1).reshape(g, gs, k)
    keep = pos < cfg.capacity()
    return Routing(probs=probs, topi=topi, topw=topw * keep, keep=keep,
                   pos=pos)


def moe_apply(params: dict, x: torch.Tensor, cfg: MoEConfig,
              act: str = "silu"):
    """x: (B, T, D) -> (out (B, T, D), the load-balance loss, a float32
    scalar)."""
    b, t, d = x.shape
    xt, n_tok = group_tokens(x, cfg)
    g, gs, _ = xt.shape
    e, cap = cfg.n_experts, cfg.capacity()
    r = route(params, xt, cfg)

    # dispatch / combine (G, S, E, C): each route's one-hot expert times
    # the one-hot of its queue place (a zero row past C, as
    # jax.nn.one_hot gives), times its weight or 1 where kept
    sel = F.one_hot(r.topi, e).to(torch.float32)                 # (G,S,k,E)
    slots = torch.arange(cap, device=x.device, dtype=torch.float32)
    pos_oh = (r.pos[..., None] == slots).to(torch.float32)       # (G,S,k,C)
    combine = torch.einsum("gske,gskc->gsec", sel * r.topw[..., None],
                           pos_oh)
    dispatch = torch.einsum("gske,gskc->gsec",
                            sel * r.keep[..., None].to(torch.float32), pos_oh)

    # expert compute: (E, G C, D) rows through each expert's weights
    xe = torch.einsum("gsec,gsd->egcd", dispatch.to(x.dtype), xt)
    xe = xe.reshape(e, g * cap, d)
    a = layers._ACTS[act]
    hi = torch.bmm(xe, params["wi"]["kernel"])
    hg = torch.bmm(xe, params["wg"]["kernel"])
    ye = torch.bmm(a(hg) * hi, params["wo"]["kernel"]).reshape(e, g, cap, d)
    yt = torch.einsum("gsec,egcd->gsd", combine.to(x.dtype), ye)
    out = yt.reshape(-1, d)[:n_tok].reshape(b, t, d)

    # Switch-style load-balance loss
    frac_tokens = sel.sum(2).mean(dim=1)                         # (G,E)
    frac_probs = r.probs.mean(dim=1)                             # (G,E)
    aux = e * torch.mean(torch.sum(frac_tokens * frac_probs, dim=-1))
    return out, aux
