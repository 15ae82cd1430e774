"""The encoder-decoder backbone (SeamlessM4T-v2's text/speech backbone,
arXiv:2308.11596), the port of ``repro.models.encdec``.

The modality frontend (mel spectrogram + conv feature extractor) is a
stub, as in the reference: the encoder takes precomputed frame embeddings
(B, T_src, d_model).  The backbone is a pre-norm transformer encoder
(bidirectional) and decoder (causal self-attention with RoPE, then
cross-attention to the encoder output without RoPE), GQA per config
(seamless-large is MHA, kv = heads), with a tied float32 unembed.

A plain loop over the layers takes the place of the reference's
``lax.scan`` over stacked layers (the numerics are the same; its
``scan_layers`` option changes compile time only, and the port's config
has none).  Under ``remat`` each layer runs under
``torch.utils.checkpoint``, as under the reference's per-layer
``jax.checkpoint``.  Attention is ``attention.chunked_attention``: the
flash route and its hand-written backward where the keys fill whole
chunks of 512 (or fewer than 512), the explicit-length route, which
autograd differentiates, for a ragged cross-attention source.

Decode state: per decoder layer a self-attention ``KVCache`` and the
encoder output's cross-attention K/V, both leaving prefill in ``dtype``
(bfloat16 by default, even in a float32 model).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn
from repro_torch.models import layers


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    name: str = "encdec"
    n_enc_layers: int = 12
    n_dec_layers: int = 12
    d_model: int = 1024
    n_heads: int = 16
    n_kv_heads: int = 16
    head_dim: Optional[int] = None
    d_ff: int = 8192
    vocab: int = 256206
    act: str = "relu"
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    dtype: Any = torch.float32

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads


# --------------------------------------------------------------------------- #
# init
# --------------------------------------------------------------------------- #

def _attn_init(gen: torch.Generator, cfg: EncDecConfig) -> dict:
    d, hd, dt = cfg.d_model, cfg.hd, cfg.dtype
    return {"q": layers.dense_init(gen, d, cfg.n_heads * hd, dt),
            "k": layers.dense_init(gen, d, cfg.n_kv_heads * hd, dt),
            "v": layers.dense_init(gen, d, cfg.n_kv_heads * hd, dt),
            "o": layers.dense_init(gen, cfg.n_heads * hd, d, dt)}


def init_params(cfg: EncDecConfig, gen: torch.Generator) -> dict:
    """Random weights with the reference's distributions and layout, drawn
    from ``gen`` on its device (not the reference's bits: tests carry the
    reference's weights across instead)."""
    d, dt, dev = cfg.d_model, cfg.dtype, gen.device
    params: dict = {
        "embed": layers.embed_init(gen, cfg.vocab, d, dt),
        "enc_final_norm": layers.rmsnorm_init(d, dt, dev),
        "dec_final_norm": layers.rmsnorm_init(d, dt, dev),
        "encoder": {}, "decoder": {},
    }
    for i in range(cfg.n_enc_layers):
        params["encoder"][f"layer_{i}"] = {
            "ln_attn": layers.rmsnorm_init(d, dt, dev),
            "attn": _attn_init(gen, cfg),
            "ln_mlp": layers.rmsnorm_init(d, dt, dev),
            "mlp": layers.mlp_init(gen, d, cfg.d_ff, dt, gated=False),
        }
    for i in range(cfg.n_dec_layers):
        params["decoder"][f"layer_{i}"] = {
            "ln_self": layers.rmsnorm_init(d, dt, dev),
            "self_attn": _attn_init(gen, cfg),
            "ln_cross": layers.rmsnorm_init(d, dt, dev),
            "cross_attn": _attn_init(gen, cfg),
            "ln_mlp": layers.rmsnorm_init(d, dt, dev),
            "mlp": layers.mlp_init(gen, d, cfg.d_ff, dt, gated=False),
        }
    return params


# --------------------------------------------------------------------------- #
# training forward
# --------------------------------------------------------------------------- #

def _heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    b, t, _ = x.shape
    return x.reshape(b, t, n, hd).transpose(1, 2)


def _mha(p: dict, cfg: EncDecConfig, xq: torch.Tensor, xkv: torch.Tensor, *,
         causal: bool, positions_q, positions_kv, rope: bool = True):
    """Attention of ``xq`` (B, Tq, D) over ``xkv`` (B, Tk, D); returns the
    output projection (B, Tq, D) and the layer's (k, v) (B, Hkv, Tk, Dh)."""
    hd = cfg.hd
    q = _heads(xq @ p["q"]["kernel"], cfg.n_heads, hd)
    k = _heads(xkv @ p["k"]["kernel"], cfg.n_kv_heads, hd)
    v = _heads(xkv @ p["v"]["kernel"], cfg.n_kv_heads, hd)
    if rope:
        q = layers.apply_rope(q, positions_q, cfg.rope_theta)
        k = layers.apply_rope(k, positions_kv, cfg.rope_theta)
    y = attn.chunked_attention(q, k, v, causal=causal)
    b, h, t, _ = y.shape
    y = y.transpose(1, 2).reshape(b, t, h * hd)
    return y @ p["o"]["kernel"], (k, v)


def _positions(b: int, t: int, device) -> torch.Tensor:
    return torch.arange(t, device=device).expand(b, t)


def _run_layers(layer_fn, layer_dict: dict, n: int, x: torch.Tensor,
                remat: bool) -> torch.Tensor:
    for i in range(n):
        p = layer_dict[f"layer_{i}"]
        if remat:
            x = checkpoint(layer_fn, p, x, use_reentrant=False)
        else:
            x = layer_fn(p, x)
    return x


def encode(params: dict, cfg: EncDecConfig, src_embeds: torch.Tensor,
           remat: bool = True) -> torch.Tensor:
    """src_embeds (B, T_src, D) from the (stubbed) modality frontend ->
    the encoder output (B, T_src, D), bidirectional."""
    x = src_embeds.to(cfg.dtype)
    b, t, _ = x.shape
    pos = _positions(b, t, x.device)

    def layer(p, x_):
        h = layers.rmsnorm(p["ln_attn"], x_)
        y, _ = _mha(p["attn"], cfg, h, h, causal=False, positions_q=pos,
                    positions_kv=pos)
        x_ = x_ + y
        h = layers.rmsnorm(p["ln_mlp"], x_)
        return x_ + layers.mlp(p["mlp"], h, cfg.act)

    x = _run_layers(layer, params["encoder"], cfg.n_enc_layers, x, remat)
    return layers.rmsnorm(params["enc_final_norm"], x)


def decode_train(params: dict, cfg: EncDecConfig, enc_out: torch.Tensor,
                 tgt_tokens: torch.Tensor, remat: bool = True) -> torch.Tensor:
    """Target tokens (B, T) against the encoder output -> the decoder's
    final hidden states (B, T, D): causal self-attention with RoPE, then
    cross-attention without it."""
    x = layers.embed(params["embed"], tgt_tokens).to(cfg.dtype)
    b, t, _ = x.shape
    pos = _positions(b, t, x.device)

    def layer(p, x_):
        h = layers.rmsnorm(p["ln_self"], x_)
        y, _ = _mha(p["self_attn"], cfg, h, h, causal=True, positions_q=pos,
                    positions_kv=pos)
        x_ = x_ + y
        h = layers.rmsnorm(p["ln_cross"], x_)
        y, _ = _mha(p["cross_attn"], cfg, h, enc_out, causal=False,
                    positions_q=None, positions_kv=None, rope=False)
        x_ = x_ + y
        h = layers.rmsnorm(p["ln_mlp"], x_)
        return x_ + layers.mlp(p["mlp"], h, cfg.act)

    x = _run_layers(layer, params["decoder"], cfg.n_dec_layers, x, remat)
    return layers.rmsnorm(params["dec_final_norm"], x)


def _chunk_nll(emb: torch.Tensor, hs: torch.Tensor, ys: torch.Tensor,
               ws: torch.Tensor) -> torch.Tensor:
    logits = hs.to(torch.float32) @ emb.T.to(torch.float32)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, ys[..., None])[..., 0]
    return (nll * ws).sum()


def loss(params: dict, cfg: EncDecConfig, src_embeds: torch.Tensor,
         tgt_tokens: torch.Tensor, *, loss_chunk: int = 1024,
         remat: bool = True) -> torch.Tensor:
    """Next-token cross-entropy of the target under the source, chunked
    as ``transformer.loss`` chunks it: the (B, T - 1) positions padded to
    whole chunks with a zero weight mask, each chunk's float32 logits
    (the tied embedding's) recomputed in the backward.  A float32
    scalar."""
    enc_out = encode(params, cfg, src_embeds, remat)
    h = decode_train(params, cfg, enc_out, tgt_tokens, remat)
    b, t, _ = h.shape
    inputs = h[:, :-1]
    targets = tgt_tokens[:, 1:].to(torch.int64)
    tm1 = t - 1
    chunk = min(loss_chunk, tm1)
    nchunk = -(-tm1 // chunk)
    pad = nchunk * chunk - tm1
    inputs = torch.nn.functional.pad(inputs, (0, 0, 0, pad))
    targets = torch.nn.functional.pad(targets, (0, pad))
    wmask = torch.nn.functional.pad(
        torch.ones((b, tm1), dtype=torch.float32, device=h.device), (0, pad))
    emb = params["embed"]["embedding"]
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(nchunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        total = total + checkpoint(_chunk_nll, emb, inputs[:, sl],
                                   targets[:, sl], wmask[:, sl],
                                   use_reentrant=False)
    return total / (b * tm1)


# --------------------------------------------------------------------------- #
# serving
# --------------------------------------------------------------------------- #

class EncDecState(NamedTuple):
    self_caches: dict          # layer -> KVCache
    cross_kv: dict             # layer -> (k, v) of the encoder output
    enc_len: int               # the encoder output's length


def _unembed_f32(params: dict, h: torch.Tensor) -> torch.Tensor:
    return h.to(torch.float32) @ params["embed"]["embedding"].T.to(
        torch.float32)


def prefill(params: dict, cfg: EncDecConfig, src_embeds: torch.Tensor,
            tgt_tokens: torch.Tensor, max_len: int, dtype=torch.bfloat16):
    """Encode the source and consume the target prefix (B, T); returns
    ``(last-position logits (B, vocab) float32, EncDecState)`` with self
    caches sized for ``max_len``."""
    enc_out = encode(params, cfg, src_embeds, remat=False)
    x = layers.embed(params["embed"], tgt_tokens).to(cfg.dtype)
    b, t, _ = x.shape
    pos = _positions(b, t, x.device)
    self_caches, cross_kv = {}, {}
    for i in range(cfg.n_dec_layers):
        p = params["decoder"][f"layer_{i}"]
        h = layers.rmsnorm(p["ln_self"], x)
        y, (k, v) = _mha(p["self_attn"], cfg, h, h, causal=True,
                         positions_q=pos, positions_kv=pos)
        cache = attn.init_cache(b, cfg.n_kv_heads, max_len, cfg.hd, dtype,
                                x.device)
        self_caches[f"layer_{i}"] = attn.update_cache(cache, k, v)
        x = x + y
        h = layers.rmsnorm(p["ln_cross"], x)
        y, (ck, cv) = _mha(p["cross_attn"], cfg, h, enc_out, causal=False,
                           positions_q=None, positions_kv=None, rope=False)
        cross_kv[f"layer_{i}"] = (ck.to(dtype), cv.to(dtype))
        x = x + y
        h = layers.rmsnorm(p["ln_mlp"], x)
        x = x + layers.mlp(p["mlp"], h, cfg.act)
    h = layers.rmsnorm(params["dec_final_norm"], x)
    logits = _unembed_f32(params, h[:, -1])
    return logits, EncDecState(self_caches=self_caches, cross_kv=cross_kv,
                               enc_len=enc_out.shape[1])


def _q_one(p: dict, cfg: EncDecConfig, h: torch.Tensor,
           name: str) -> torch.Tensor:
    b = h.shape[0]
    return (h @ p[name]["kernel"]).reshape(b, 1, -1, cfg.hd).transpose(1, 2)


def decode_step(params: dict, cfg: EncDecConfig, token: torch.Tensor,
                state: EncDecState):
    """One target token for each sequence.  token: (B,) int.  Returns
    ``(logits (B, vocab) float32, new state)``; the cross K/V carry over
    unchanged."""
    b = token.shape[0]
    hd = cfg.hd
    x = layers.embed(params["embed"], token[:, None]).to(cfg.dtype)
    pos = torch.full((b, 1), state.self_caches["layer_0"].length,
                     dtype=torch.int64, device=x.device)
    new_caches = {}
    for i in range(cfg.n_dec_layers):
        p = params["decoder"][f"layer_{i}"]
        h = layers.rmsnorm(p["ln_self"], x)
        q = layers.apply_rope(_q_one(p["self_attn"], cfg, h, "q"), pos,
                              cfg.rope_theta)
        k = layers.apply_rope(_q_one(p["self_attn"], cfg, h, "k"), pos,
                              cfg.rope_theta)
        v = _q_one(p["self_attn"], cfg, h, "v")
        cache = attn.update_cache(state.self_caches[f"layer_{i}"], k, v)
        new_caches[f"layer_{i}"] = cache
        y = attn.decode_attention(q, cache)
        y = y.transpose(1, 2).reshape(b, 1, cfg.n_heads * hd)
        x = x + y @ p["self_attn"]["o"]["kernel"]
        # cross-attention against the encoder's K/V
        h = layers.rmsnorm(p["ln_cross"], x)
        ck, cv = state.cross_kv[f"layer_{i}"]
        q = _q_one(p["cross_attn"], cfg, h, "q")
        y = attn.decode_attention(q, attn.KVCache(k=ck, v=cv,
                                                  length=state.enc_len))
        y = y.transpose(1, 2).reshape(b, 1, cfg.n_heads * hd)
        x = x + y @ p["cross_attn"]["o"]["kernel"]
        h = layers.rmsnorm(p["ln_mlp"], x)
        x = x + layers.mlp(p["mlp"], h, cfg.act)
    h = layers.rmsnorm(params["dec_final_norm"], x)
    logits = _unembed_f32(params, h[:, 0])
    return logits, EncDecState(self_caches=new_caches,
                               cross_kv=state.cross_kv, enc_len=state.enc_len)
