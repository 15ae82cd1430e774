"""The model zoo's decoder stack, the port of ``repro.models.transformer``
(training: forward_hidden + the chunked loss; serving: prefill + decode).

Per-layer block types (``ModelConfig.block_pattern``, cycled over layers):

  "attn"   — full-attention transformer layer
  "swa"    — sliding-window attention layer (window = cfg.window)
  "rglru"  — RecurrentGemma recurrent layer (K11 in prefill)
  "rwkv"   — RWKV6 layer (time-mix + channel-mix; K12 in prefill)

``loss(params, cfg, tokens)`` is the next-token cross-entropy over
``forward_hidden`` (per-layer remat); ``prefill(params, cfg, tokens,
max_len)`` returns the last position's logits and the decode state;
``decode_step(params, cfg, token, state)`` runs one token against it.
Parameters are the reference's nested dicts (same names and layouts).
The dense GQA family's options are here: q/k/v biases (qwen2), q/k
RMSNorms before RoPE (gemma3), post-norms on the branch outputs and the
final logit softcap (gemma2), the long-context window cap on "attn"
layers (gemma2, gemma3), and qwen2-vl's multimodal inputs: precomputed
prefix embeddings placed before the tokens (``prefix_embeds``) and M-RoPE
over (t, h, w) position ids (``positions3``; text-only by default, every
axis the linear position), and the MoE feed-forward (mixtral, llama4:
``models/moe.py`` on every ``moe_period``-th layer, plus a shared expert
where ``n_shared_experts`` is set), whose load-balance loss ``loss`` adds
at ``aux_weight``.  The encoder-decoder family is ``models/encdec.py``.

The reference's dtype conventions are kept: KV caches and the rglru conv
state leave prefill in ``dtype`` (bfloat16 by default, even in a float32
model); a decode step carries the conv state at the activations' dtype
and the rwkv shift states at the model's dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops as kops
from repro_torch.models import attention as attn
from repro_torch.models import layers, moe, rglru, rwkv6

RWKV_HEAD = 64      # the rwkv blocks' head size, as in the reference


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 2
    head_dim: Optional[int] = None
    d_ff: int = 512
    vocab: int = 1024
    block_pattern: tuple = ("attn",)
    window: Optional[int] = None           # for "swa" blocks
    softcap_attn: Optional[float] = None   # gemma2 attn logit cap
    softcap_final: Optional[float] = None  # gemma2 final logit cap
    qkv_bias: bool = False                 # qwen2
    qk_norm: bool = False                  # gemma3
    post_norm: bool = False                # gemma2 extra post-norms
    act: str = "silu"
    rope_theta: float = 10_000.0
    mrope_sections: Optional[tuple] = None  # qwen2-vl (t, h, w) split
    moe: Optional[moe.MoEConfig] = None
    moe_period: int = 1                    # every k-th layer is MoE
    n_shared_experts: int = 0              # llama4 shared expert
    embed_scale: bool = False              # gemma: x *= sqrt(d)
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    dtype: torch.dtype = torch.float32
    # caps "attn" layers to a sliding window (the reference's long-context
    # mode; its serve path leaves the published configs' caps set)
    long_context_cap: Optional[int] = None

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def block_type(self, i: int) -> str:
        return self.block_pattern[i % len(self.block_pattern)]

    def is_moe_layer(self, i: int) -> bool:
        return self.moe is not None and (i % self.moe_period
                                         == self.moe_period - 1)

    def layer_window(self, i: int) -> Optional[int]:
        bt = self.block_type(i)
        if bt == "swa":
            return self.window
        if bt == "attn":
            return self.long_context_cap
        return None

    def num_params(self) -> int:
        """The reference's analytic parameter count (its rglru and rwkv
        terms approximate; norms and biases left out)."""
        d, f, v, hd = self.d_model, self.d_ff, self.vocab, self.hd
        total = v * d  # embed
        if not self.tie_embeddings:
            total += v * d
        for i in range(self.n_layers):
            bt = self.block_type(i)
            if bt in ("attn", "swa"):
                total += d * hd * (self.n_heads + 2 * self.n_kv_heads)
                total += self.n_heads * hd * d
            elif bt == "rglru":
                total += 2 * d * d + 3 * d * d + d  # in/gates/out approx
            elif bt == "rwkv":
                total += 4 * d * d + d * 64 * 2 + d * d  # time-mix
                total += d * d + 2 * d * f               # channel-mix
            if bt != "rwkv":
                if self.is_moe_layer(i):
                    total += (self.moe.n_experts * 3 * d * f
                              + d * self.moe.n_experts)
                    total += self.n_shared_experts * 3 * d * f
                else:
                    total += 3 * d * f
        return total

    def active_params(self) -> int:
        """Parameters a token uses: an MoE layer counts its top-k
        experts."""
        if self.moe is None:
            return self.num_params()
        d, f = self.d_model, self.d_ff
        inactive = (self.moe.n_experts - self.moe.topk) * 3 * d * f
        n_moe = sum(self.is_moe_layer(i) for i in range(self.n_layers))
        return self.num_params() - n_moe * inactive


# --------------------------------------------------------------------------- #
# init
# --------------------------------------------------------------------------- #

def init_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """Random weights with the reference's distributions and layout, drawn
    from ``gen`` on its device (not the reference's bits: tests carry the
    reference's weights across instead)."""
    params: dict = {
        "embed": layers.embed_init(gen, cfg.vocab, cfg.d_model, cfg.dtype),
        "final_norm": layers.rmsnorm_init(cfg.d_model, cfg.dtype, gen.device),
        "layers": {},
    }
    if not cfg.tie_embeddings:
        params["unembed"] = layers.dense_init(gen, cfg.d_model, cfg.vocab,
                                              cfg.dtype)
    for i in range(cfg.n_layers):
        params["layers"][f"layer_{i}"] = _layer_init(gen, cfg, i)
    return params


def _layer_init(gen: torch.Generator, cfg: ModelConfig, i: int) -> dict:
    bt = cfg.block_type(i)
    d, hd, dt, dev = cfg.d_model, cfg.hd, cfg.dtype, gen.device
    p: dict = {}
    if bt in ("attn", "swa"):
        p["ln_attn"] = layers.rmsnorm_init(d, dt, dev)
        p["q"] = layers.dense_init(gen, d, cfg.n_heads * hd, dt,
                                   bias=cfg.qkv_bias)
        p["k"] = layers.dense_init(gen, d, cfg.n_kv_heads * hd, dt,
                                   bias=cfg.qkv_bias)
        p["v"] = layers.dense_init(gen, d, cfg.n_kv_heads * hd, dt,
                                   bias=cfg.qkv_bias)
        p["o"] = layers.dense_init(gen, cfg.n_heads * hd, d, dt)
        if cfg.qk_norm:
            p["q_norm"] = layers.rmsnorm_init(hd, dt, dev)
            p["k_norm"] = layers.rmsnorm_init(hd, dt, dev)
        if cfg.post_norm:
            p["ln_attn_post"] = layers.rmsnorm_init(d, dt, dev)
    elif bt == "rglru":
        p["ln_attn"] = layers.rmsnorm_init(d, dt, dev)
        p["rglru"] = rglru.rglru_init(gen, d, d, dt)
    elif bt == "rwkv":
        p["ln_tm"] = layers.layernorm_init(d, dt, dev)
        p["ln_cm"] = layers.layernorm_init(d, dt, dev)
        p["rwkv"] = rwkv6.rwkv6_init(gen, d, cfg.d_ff, dtype=dt)
        return p
    else:
        raise ValueError(f"unknown block type {bt!r}")
    p["ln_mlp"] = layers.rmsnorm_init(d, dt, dev)
    if cfg.is_moe_layer(i):
        p["moe"] = moe.moe_init(gen, d, cfg.d_ff, cfg.moe, dt)
        if cfg.n_shared_experts:
            p["shared_mlp"] = layers.mlp_init(
                gen, d, cfg.n_shared_experts * cfg.d_ff, dt)
    else:
        p["mlp"] = layers.mlp_init(gen, d, cfg.d_ff, dt)
    if cfg.post_norm:
        p["ln_mlp_post"] = layers.rmsnorm_init(d, dt, dev)
    return p


# --------------------------------------------------------------------------- #
# pieces of the forward
# --------------------------------------------------------------------------- #

def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    b, t, _ = x.shape
    return x.reshape(b, t, n, hd).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, t, hd = x.shape
    return x.transpose(1, 2).reshape(b, t, h * hd)


def _qkv(p: dict, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
         positions3=None):
    hd = cfg.hd
    q = _split_heads(layers.dense(p["q"], x), cfg.n_heads, hd)
    k = _split_heads(layers.dense(p["k"], x), cfg.n_kv_heads, hd)
    v = _split_heads(layers.dense(p["v"], x), cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = layers.rmsnorm(p["q_norm"], q)
        k = layers.rmsnorm(p["k_norm"], k)
    if cfg.mrope_sections is not None and positions3 is not None:
        q = layers.apply_mrope(q, positions3, cfg.mrope_sections,
                               cfg.rope_theta)
        k = layers.apply_mrope(k, positions3, cfg.mrope_sections,
                               cfg.rope_theta)
    else:
        q = layers.apply_rope(q, positions, cfg.rope_theta)
        k = layers.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _default_positions3(cfg: ModelConfig, positions: torch.Tensor,
                        positions3):
    """Text-only M-RoPE ids: the t/h/w ids all equal the linear position
    (B, T) -> (B, 3, T); None where the config has no M-RoPE."""
    if positions3 is None and cfg.mrope_sections is not None:
        b, t = positions.shape
        positions3 = positions[:, None].expand(b, 3, t)
    return positions3


def _ffn(p: dict, cfg: ModelConfig, i: int, x: torch.Tensor):
    """Layer ``i``'s feed-forward, dense or MoE (plus the shared expert);
    returns ``(out, aux)``, aux the MoE balance loss or a float32 0."""
    if cfg.is_moe_layer(i):
        out, aux = moe.moe_apply(p["moe"], x, cfg.moe, cfg.act)
        if cfg.n_shared_experts:
            out = out + layers.mlp(p["shared_mlp"], x, cfg.act)
        return out, aux
    return (layers.mlp(p["mlp"], x, cfg.act),
            torch.zeros((), dtype=torch.float32, device=x.device))


def _embed_in(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
              prefix_embeds=None) -> torch.Tensor:
    """Token embeddings (B, T, D), after the prefix embeddings (B, P, D)
    where given; the embed scale applies to both, as in the reference."""
    x = layers.embed(params["embed"], tokens).to(cfg.dtype)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(cfg.dtype), x], dim=1)
    if cfg.embed_scale:
        # sqrt(d) rounded to the model's dtype first, as the reference does:
        # bf16(sqrt(2560)) = 50.5, not 50.596
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.dtype).item()
    return x


def _unembed(params: dict, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = h.to(torch.float32) @ params["embed"]["embedding"].T.to(
            torch.float32)
    else:
        logits = layers.dense(params["unembed"], h).to(torch.float32)
    return layers.softcap(logits, cfg.softcap_final)


def _post_norm(p: dict, cfg: ModelConfig, name: str,
               y: torch.Tensor) -> torch.Tensor:
    """gemma2's post-norm of a branch output (``ln_attn_post`` or
    ``ln_mlp_post``).  As in the reference, an rglru layer has no
    ``ln_attn_post`` and raises ``KeyError`` under ``post_norm``."""
    return layers.rmsnorm(p[name], y) if cfg.post_norm else y


def _layer_fwd(p: dict, cfg: ModelConfig, i: int, x: torch.Tensor,
               positions: torch.Tensor, positions3=None, causal: bool = True):
    """Full-sequence layer forward (training).  Returns ``(x, aux)``; aux
    is the layer's MoE balance loss (a float32 0 on other layers)."""
    bt = cfg.block_type(i)
    if bt == "rwkv":
        x = x + rwkv6.time_mix(p["rwkv"], layers.layernorm(p["ln_tm"], x))
        x = x + rwkv6.channel_mix(p["rwkv"], layers.layernorm(p["ln_cm"], x))
        return x, torch.zeros((), dtype=torch.float32, device=x.device)
    h = layers.rmsnorm(p["ln_attn"], x)
    if bt == "rglru":
        y = rglru.rglru_block(p["rglru"], h)
    else:
        q, k, v = _qkv(p, cfg, h, positions, positions3)
        y = attn.chunked_attention(q, k, v, causal=causal,
                                   window=cfg.layer_window(i),
                                   softcap=cfg.softcap_attn)
        y = layers.dense(p["o"], _merge_heads(y))
    x = x + _post_norm(p, cfg, "ln_attn_post", y)
    h = layers.rmsnorm(p["ln_mlp"], x)
    y, aux = _ffn(p, cfg, i, h)
    return x + _post_norm(p, cfg, "ln_mlp_post", y), aux


def forward_hidden(params: dict, cfg: ModelConfig, tokens: torch.Tensor, *,
                   prefix_embeds=None, positions3=None, causal: bool = True,
                   remat: bool = True):
    """Token ids (B, T), after ``prefix_embeds`` (B, P, D) where given ->
    ``(final hidden states (B, P + T, D), aux)``.  ``positions3`` (B, 3,
    P + T): M-RoPE's t/h/w ids (text-only by default).

    A plain loop over the layers, which the reference's scan over stacked
    layer cycles equals (its ``scan_layers`` changes compile time, not
    numerics).  ``remat``: each layer runs under
    ``torch.utils.checkpoint`` (non-reentrant), so its backward recomputes
    it from the layer's input, as the reference's per-layer
    ``jax.checkpoint`` does: K11 and K12 then launch twice a step, once
    in the forward and once in the recompute."""
    x = _embed_in(params, cfg, tokens, prefix_embeds)
    b, t = x.shape[:2]
    positions = torch.arange(t, device=x.device).expand(b, t)
    positions3 = _default_positions3(cfg, positions, positions3)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layers):
        p = params["layers"][f"layer_{i}"]

        def fwd(p_, x_, i_=i):
            return _layer_fwd(p_, cfg, i_, x_, positions, positions3,
                              causal)

        if remat:
            x, aux = checkpoint(fwd, p, x, use_reentrant=False)
        else:
            x, aux = fwd(p, x)
        aux_total = aux_total + aux
    return layers.rmsnorm(params["final_norm"], x), aux_total


def _chunk_nll(params: dict, cfg: ModelConfig, hs: torch.Tensor,
               ys: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    logits = _unembed(params, cfg, hs)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, ys[..., None])[..., 0]
    return (nll * ws).sum()


def loss(params: dict, cfg: ModelConfig, tokens: torch.Tensor, *,
         prefix_embeds=None, positions3=None, loss_chunk: int = 1024,
         aux_weight: float = 0.01, remat: bool = True) -> torch.Tensor:
    """Next-token cross-entropy, chunked over the sequence as the
    reference chunks it: the (B, T - 1) positions padded to whole chunks
    of ``loss_chunk`` with a zero weight mask, each chunk's (B, chunk,
    vocab) logits recomputed in the backward (``torch.utils.checkpoint``)
    and never held at once; ``total / (B (T - 1)) + aux_weight * aux``.
    The prefix positions carry no target and are dropped first.  A
    float32 scalar."""
    h, aux = forward_hidden(params, cfg, tokens, prefix_embeds=prefix_embeds,
                            positions3=positions3, remat=remat)
    npre = 0 if prefix_embeds is None else prefix_embeds.shape[1]
    h = h[:, npre:]
    b, t, _ = h.shape
    inputs = h[:, :-1]
    targets = tokens[:, 1:].to(torch.int64)
    tm1 = t - 1
    chunk = min(loss_chunk, tm1)
    nchunk = -(-tm1 // chunk)
    pad = nchunk * chunk - tm1
    inputs = torch.nn.functional.pad(inputs, (0, 0, 0, pad))
    targets = torch.nn.functional.pad(targets, (0, pad))
    wmask = torch.nn.functional.pad(
        torch.ones((b, tm1), dtype=torch.float32, device=h.device), (0, pad))
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(nchunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        total = total + checkpoint(_chunk_nll, params, cfg, inputs[:, sl],
                                   targets[:, sl], wmask[:, sl],
                                   use_reentrant=False)
    return total / (b * tm1) + aux_weight * aux


# --------------------------------------------------------------------------- #
# inference: prefill + decode
# --------------------------------------------------------------------------- #

def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      dtype=torch.bfloat16, device="cuda") -> dict:
    """Per-layer cache dict sized for ``max_len`` context."""
    state = {}
    for i in range(cfg.n_layers):
        bt = cfg.block_type(i)
        if bt in ("attn", "swa"):
            w = cfg.layer_window(i)
            size = min(max_len, w) if w is not None else max_len
            state[f"layer_{i}"] = attn.init_cache(
                batch, cfg.n_kv_heads, size, cfg.hd, dtype, device)
        elif bt == "rglru":
            state[f"layer_{i}"] = rglru.rglru_init_state(
                batch, cfg.d_model, dtype, device)
        elif bt == "rwkv":
            state[f"layer_{i}"] = rwkv6.rwkv_init_state(
                batch, cfg.d_model, dtype=dtype, device=device)
    return state


def _first_attn_layer(cfg: ModelConfig):
    for i in range(cfg.n_layers):
        if cfg.block_type(i) in ("attn", "swa"):
            return i
    return None


def decode_step(params: dict, cfg: ModelConfig, token: torch.Tensor,
                state: dict, positions3=None):
    """One token for each sequence.  token: (B,) int.  Returns ``(logits
    (B, vocab) float32, new_state)``.  Its position is the caches' length
    (prefix positions included); ``positions3`` (B, 3, 1) overrides it
    for M-RoPE."""
    b = token.shape[0]
    x = _embed_in(params, cfg, token[:, None])
    # absolute position: every layer tracks the same length; the first
    # attention layer's counter gives it (0 in an rwkv-only stack)
    first = _first_attn_layer(cfg)
    pos = state[f"layer_{first}"].length if first is not None else 0
    positions = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
    positions3 = _default_positions3(cfg, positions, positions3)
    new_state = {}
    for i in range(cfg.n_layers):
        p = params["layers"][f"layer_{i}"]
        bt = cfg.block_type(i)
        st = state[f"layer_{i}"]
        if bt == "rwkv":
            h = layers.layernorm(p["ln_tm"], x)
            y, shift_tm, s_new = rwkv6.time_mix_decode(
                p["rwkv"], h, st.shift_tm, st.s)
            x = x + y
            h = layers.layernorm(p["ln_cm"], x)
            x = x + rwkv6.channel_mix(p["rwkv"], h, prev=st.shift_cm)
            new_state[f"layer_{i}"] = rwkv6.RWKVState(
                shift_tm=shift_tm, shift_cm=h[:, -1], s=s_new)
            continue
        h = layers.rmsnorm(p["ln_attn"], x)
        if bt == "rglru":
            y, st_new = rglru.rglru_block_decode(p["rglru"], h, st)
        else:
            q, k, v = _qkv(p, cfg, h, positions, positions3)
            w = cfg.layer_window(i)
            if w is not None and st.k.shape[2] == w:       # ring cache
                st_new = attn.update_ring_cache(st, k, v)
                y = attn.ring_decode_attention(q, st_new,
                                               softcap=cfg.softcap_attn)
            else:
                st_new = attn.update_cache(st, k, v)
                y = attn.decode_attention(q, st_new, window=w,
                                          softcap=cfg.softcap_attn)
            y = layers.dense(p["o"], _merge_heads(y))
        x = x + _post_norm(p, cfg, "ln_attn_post", y)
        h = layers.rmsnorm(p["ln_mlp"], x)
        x = x + _post_norm(p, cfg, "ln_mlp_post", _ffn(p, cfg, i, h)[0])
        new_state[f"layer_{i}"] = st_new
    h = layers.rmsnorm(params["final_norm"], x)
    return _unembed(params, cfg, h)[:, 0], new_state


def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            max_len: int, *, prefix_embeds=None, positions3=None,
            dtype=torch.bfloat16):
    """Process a prompt batch (B, T), after ``prefix_embeds`` (B, P, D)
    where given; returns ``(last-position logits (B, vocab) float32,
    decode state sized for max_len)``, which must hold P + T and the
    tokens to decode.  ``positions3`` (B, 3, P + T): M-RoPE's ids.

    rwkv layers run K12 and rglru layers K11 over the whole prompt; caches
    are produced by the full-sequence forward; an MoE layer's balance
    loss is dropped, as in the reference.
    """
    b, t = tokens.shape
    x = _embed_in(params, cfg, tokens, prefix_embeds)
    ttot = x.shape[1]
    positions = torch.arange(ttot, device=x.device).expand(b, ttot)
    positions3 = _default_positions3(cfg, positions, positions3)
    state = init_decode_state(cfg, b, max_len, dtype, x.device)
    new_state = {}
    for i in range(cfg.n_layers):
        p = params["layers"][f"layer_{i}"]
        bt = cfg.block_type(i)
        if bt == "rwkv":
            h = layers.layernorm(p["ln_tm"], x)
            r, k, v, g, w = rwkv6._tm_inputs(p["rwkv"], h)
            y, s_fin = kops.wkv6_scan(
                rwkv6._heads(r, RWKV_HEAD), rwkv6._heads(k, RWKV_HEAD),
                rwkv6._heads(v, RWKV_HEAD), rwkv6._heads(w, RWKV_HEAD),
                p["rwkv"]["u"])
            x = x + rwkv6._gn_gate(p["rwkv"], rwkv6._unheads(y).to(x.dtype), g)
            hcm = layers.layernorm(p["ln_cm"], x)
            x = x + rwkv6.channel_mix(p["rwkv"], hcm)
            new_state[f"layer_{i}"] = rwkv6.RWKVState(
                shift_tm=h[:, -1], shift_cm=hcm[:, -1], s=s_fin)
            continue
        h = layers.rmsnorm(p["ln_attn"], x)
        if bt == "rglru":
            pr = p["rglru"]
            gate = layers.gelu(layers.dense(pr["wy"], h))
            xr = layers.dense(pr["wx"], h)
            xc, conv_st = rglru._causal_depthwise_conv(pr["conv"]["kernel"], xr)
            a, gi = rglru._rglru_gates(pr, xc)
            ys, h_fin = kops.rglru_scan(gi * xc.to(torch.float32), a)
            y = layers.dense(pr["wo"], ys.to(x.dtype) * gate)
            new_state[f"layer_{i}"] = rglru.RGLRUState(
                conv=conv_st.to(dtype), h=h_fin)
        else:
            q, k, v = _qkv(p, cfg, h, positions, positions3)
            y = attn.chunked_attention(q, k, v, causal=True,
                                       window=cfg.layer_window(i),
                                       softcap=cfg.softcap_attn)
            y = layers.dense(p["o"], _merge_heads(y))
            st = state[f"layer_{i}"]
            size = st.k.shape[2]
            if size < ttot:
                # ring cache: keep the last `size` positions, rotated so
                # that slot s holds the token whose position p has
                # p % size == s (update_ring_cache's slot = length % window)
                shift = ttot % size
                st_new = attn.KVCache(
                    k=torch.roll(k[:, :, -size:], shift, dims=2).to(st.k.dtype),
                    v=torch.roll(v[:, :, -size:], shift, dims=2).to(st.v.dtype),
                    length=ttot)
            else:
                st_new = attn.update_cache(st, k, v)
            new_state[f"layer_{i}"] = st_new
        x = x + _post_norm(p, cfg, "ln_attn_post", y)
        h = layers.rmsnorm(p["ln_mlp"], x)
        x = x + _post_norm(p, cfg, "ln_mlp_post", _ffn(p, cfg, i, h)[0])
    h = layers.rmsnorm(params["final_norm"], x)
    logits = _unembed(params, cfg, h[:, -1:])[:, 0]
    return logits, new_state
