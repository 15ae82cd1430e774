"""The port's model zoo (serving: rwkv6 and recurrentgemma) against the JAX
package, on the CPU.

Inputs come from numpy seeds and the JAX package's own initialisers; the
weights cross to the port through ``convert.params_from_jax`` and every
function runs in both packages.  Tolerances, float32:

* modules (layers, attention, rwkv6, rglru): rtol = atol = 1e-5
  (measured gaps below 3e-6: float32 sums in other orders);
* the reduced models' prefill and decode logits and every state leaf:
  rtol = atol = 1e-4 (measured below 3e-5 on logits of magnitude 1-3 and
  on wkv states of magnitude ~50); bfloat16 leaves (KV caches, the rglru
  conv state) within atol 1e-4 plus one bf16 rounding (rtol 2^-7), since
  a float32 difference in the last bits can round to a neighbouring bf16
  value;
* the bf16 models: max |port - JAX| <= 0.03 * max |JAX| for logits and
  states (measured up to 0.014: XLA keeps excess precision between bf16
  ops, torch rounds after each);
* self-consistency (prefill(T) + one decode against prefill(T+1)):
  the port's gap within 1e-5 + 0.5 * JAX's gap of JAX's (measured:
  rwkv 1.0e-6 vs 3.0e-6, recurrentgemma 1.0898e-3 vs 1.0914e-3, the
  latter from the bf16 KV cache).
"""

import dataclasses
import re
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # xdist workers share the cores: no spinning OpenMP pools

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_spec as jget_spec  # noqa: E402
from repro.configs.base import SHAPES as JSHAPES  # noqa: E402
from repro.configs.base import reduced as jreduced  # noqa: E402
from repro.data import synthetic as jsynthetic  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro.models import rwkv6 as jrwkv6  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_spec, reduced  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import layers, rglru, rwkv6  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402


@pytest.fixture(autouse=True)
def _partitionable_threefry():
    """The port reproduces jax's partitionable threefry stream (the
    default since jax 0.5); pin it whatever the ambient config says."""
    with jax.threefry_partitionable(True):
        yield


MOD_TOL = 1e-5
MODEL_TOL = 1e-4
BF16_ROUND = 2 ** -7
BF16_REL = 0.03
ARCHS = ("rwkv6-3b", "recurrentgemma-2b")
BATCH, PROMPT, GEN = 2, 48, 4


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol=MOD_TOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _carry(tree):
    return convert.params_from_jax(jax.tree.map(np.asarray, tree), "cpu")


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _both(x):
    return jnp.asarray(x), torch.from_numpy(x)


# --------------------------------------------------------------------------- #
# layers
# --------------------------------------------------------------------------- #

def test_dense_embed_norms_rope_softcap_match():
    key = jax.random.PRNGKey(0)
    jx, tx = _both(_randn(1, 2, 5, 32))
    jd = jlayers.dense_init(key, 32, 24, bias=True)
    jd["bias"] = jnp.asarray(_randn(2, 24))
    _close(layers.dense(_carry(jd), tx), jlayers.dense(jd, jx))
    je = jlayers.embed_init(key, 50, 16)
    toks = np.random.default_rng(3).integers(0, 50, (2, 7))
    _close(layers.embed(_carry(je), torch.from_numpy(toks)),
           jlayers.embed(je, jnp.asarray(toks)))
    scale = {"scale": _randn(4, 32)}
    ln = {"scale": _randn(5, 32), "bias": _randn(6, 32)}
    _close(layers.rmsnorm(_carry(scale), tx), jlayers.rmsnorm(scale, jx))
    _close(layers.layernorm(_carry(ln), tx), jlayers.layernorm(ln, jx))
    jq, tq = _both(_randn(7, 2, 3, 5, 16))
    pos = np.array([[0, 1, 2, 3, 4], [7, 8, 9, 10, 11]])
    _close(layers.apply_rope(tq, torch.from_numpy(pos), 500.0),
           jlayers.apply_rope(jq, jnp.asarray(pos), 500.0))
    _close(layers.softcap(tx * 40, 30.0), jlayers.softcap(jx * 40, 30.0))
    assert layers.softcap(tx, None) is tx


@pytest.mark.parametrize("act", sorted(layers._ACTS))
def test_mlp_matches_for_every_activation(act):
    """``gelu`` is jax's tanh approximation, as ``gelu_tanh``."""
    jp = jlayers.mlp_init(jax.random.PRNGKey(1), 32, 48)
    jx, tx = _both(_randn(8, 2, 5, 32) * 2)
    _close(layers.mlp(_carry(jp), tx, act), jlayers.mlp(jp, jx, act))


# --------------------------------------------------------------------------- #
# attention
# --------------------------------------------------------------------------- #

def _qkv(seed, tq, tk, hq=4, hkv=2, dh=32):
    return (_randn(seed, 2, hq, tq, dh), _randn(seed + 1, 2, hkv, tk, dh),
            _randn(seed + 2, 2, hkv, tk, dh))


_FLASH_CASES = [dict(causal=True), dict(causal=True, window=8),
                dict(causal=True, softcap=30.0),
                dict(causal=True, window=8, softcap=5.0),
                dict(causal=True, q_offset=3)]


@pytest.mark.parametrize("kw,tk", [(kw, tk) for tk in (40, 32)
                                   for kw in _FLASH_CASES]
                         + [(dict(causal=False), 32)])
def test_chunked_attention_flash_route(kw, tk):
    """kv_length None: the reference's custom-VJP flash route (Tk = 40 pads
    the last chunk of 16, which causal masking hides)."""
    q, k, v = _qkv(10, tk - kw.get("q_offset", 0), tk)
    got = attn.chunked_attention(*map(torch.from_numpy, (q, k, v)), chunk=16,
                                 **kw)
    want = jattn.chunked_attention(*map(jnp.asarray, (q, k, v)), chunk=16,
                                   **kw)
    _close(got, want)


@pytest.mark.parametrize("kw", [
    dict(causal=False, kv_length=27), dict(causal=True, kv_length=27),
    dict(causal=True, kv_length=40, window=8, softcap=20.0),
    dict(causal=False)])
def test_chunked_attention_explicit_length_route(kw):
    q, k, v = _qkv(20, 40, 40)
    got = attn.chunked_attention(*map(torch.from_numpy, (q, k, v)), chunk=16,
                                 **kw)
    jkw = dict(kw)
    if "kv_length" in jkw:
        jkw["kv_length"] = jnp.asarray(jkw["kv_length"], jnp.int32)
    want = jattn.chunked_attention(*map(jnp.asarray, (q, k, v)), chunk=16,
                                   **jkw)
    _close(got, want)


def _caches(seed, size, length):
    k = _randn(seed, 2, 2, size, 32).astype(jnp.bfloat16)
    v = _randn(seed + 1, 2, 2, size, 32).astype(jnp.bfloat16)
    jc = jattn.KVCache(k=jnp.asarray(k), v=jnp.asarray(v),
                       length=jnp.asarray(length, jnp.int32))
    tc = attn.KVCache(k=_carry(jc.k), v=_carry(jc.v), length=length)
    return jc, tc


@pytest.mark.parametrize("kw", [{}, dict(window=8), dict(softcap=10.0)])
def test_linear_cache_decode_matches(kw):
    jc, tc = _caches(30, 40, 30)
    q, kn, vn = (_randn(33 + i, 2, h, 1, 32) for i, h in enumerate((4, 2, 2)))
    jc2 = jattn.update_cache(jc, jnp.asarray(kn), jnp.asarray(vn))
    tc2 = attn.update_cache(tc, torch.from_numpy(kn), torch.from_numpy(vn))
    assert tc2.length == int(jc2.length) == 31
    np.testing.assert_array_equal(_np(tc2.k), _np(jc2.k))
    np.testing.assert_array_equal(_np(tc2.v), _np(jc2.v))
    assert torch.equal(tc.k, _carry(jc.k))          # the old cache is kept
    _close(attn.decode_attention(torch.from_numpy(q), tc2, **kw),
           jattn.decode_attention(jnp.asarray(q), jc2, **kw))


@pytest.mark.parametrize("length", [3, 16, 37])
def test_ring_cache_decode_matches(length):
    """Cold start (length < window), full, and wrapped rings of 16 slots."""
    jc, tc = _caches(40, 16, length)
    ring = attn.init_ring_cache(2, 2, 16, 32, device="cpu")
    assert ring.k.shape == (2, 2, 16, 32)
    for step in range(3):
        q, kn, vn = (_randn(50 + 3 * step + i, 2, h, 1, 32)
                     for i, h in enumerate((4, 2, 2)))
        jc = jattn.update_ring_cache(jc, jnp.asarray(kn), jnp.asarray(vn))
        tc = attn.update_ring_cache(tc, torch.from_numpy(kn),
                                    torch.from_numpy(vn))
        assert tc.length == int(jc.length)
        np.testing.assert_array_equal(_np(tc.k), _np(jc.k))
        np.testing.assert_array_equal(_np(tc.v), _np(jc.v))
        _close(attn.ring_decode_attention(torch.from_numpy(q), tc,
                                          softcap=7.0),
               jattn.ring_decode_attention(jnp.asarray(q), jc, softcap=7.0))


# --------------------------------------------------------------------------- #
# rwkv6 and rglru blocks
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def rwkv_params():
    jp = jrwkv6.rwkv6_init(jax.random.PRNGKey(2), 128, 256)
    return jp, _carry(jp)


def test_rwkv6_time_mix_and_channel_mix_match(rwkv_params):
    jp, tp = rwkv_params
    jx, tx = _both(_randn(60, 2, 24, 128))
    _close(rwkv6.time_mix(tp, tx), jrwkv6.time_mix(jp, jx))
    _close(rwkv6.channel_mix(tp, tx), jrwkv6.channel_mix(jp, jx))
    jprev, tprev = _both(_randn(61, 2, 128))
    _close(rwkv6.channel_mix(tp, tx, prev=tprev),
           jrwkv6.channel_mix(jp, jx, prev=jprev))


def test_rwkv6_time_mix_decode_matches(rwkv_params):
    jp, tp = rwkv_params
    jx, tx = _both(_randn(62, 2, 1, 128))
    jsh, tsh = _both(_randn(63, 2, 128))
    js, ts = _both(_randn(64, 2, 2, 64, 64))
    got = rwkv6.time_mix_decode(tp, tx, tsh, ts)
    want = jrwkv6.time_mix_decode(jp, jx, jsh, js)
    for g, w in zip(got, want):
        _close(g, w)
    st = rwkv6.rwkv_init_state(2, 128, device="cpu")
    assert st.s.shape == (2, 2, 64, 64) and st.shift_tm.dtype == torch.bfloat16


@pytest.fixture(scope="module")
def rglru_params():
    jp = jrglru.rglru_init(jax.random.PRNGKey(3), 128, 128)
    return jp, _carry(jp)


def test_rglru_block_matches(rglru_params):
    jp, tp = rglru_params
    jx, tx = _both(_randn(70, 2, 24, 128))
    _close(rglru.rglru_block(tp, tx), jrglru.rglru_block(jp, jx))


def test_rglru_block_decode_matches(rglru_params):
    jp, tp = rglru_params
    jx, tx = _both(_randn(71, 2, 1, 128))
    conv, h = _randn(72, 2, 3, 128), _randn(73, 2, 128)
    js = jrglru.RGLRUState(conv=jnp.asarray(conv), h=jnp.asarray(h))
    ts = rglru.RGLRUState(conv=torch.from_numpy(conv), h=torch.from_numpy(h))
    got, gst = rglru.rglru_block_decode(tp, tx, ts)
    want, wst = jrglru.rglru_block_decode(jp, jx, js)
    _close(got, want)
    _close(gst.conv, wst.conv)
    _close(gst.h, wst.h)


# --------------------------------------------------------------------------- #
# the slice as a whole: reduced prefill + decode
# --------------------------------------------------------------------------- #

def _configs(arch, bf16=False):
    jm = jreduced(jget_spec(arch)).model
    m = reduced(get_spec(arch)).model
    if bf16:
        jm = dataclasses.replace(jm, dtype=jnp.bfloat16)
        m = dataclasses.replace(m, dtype=torch.bfloat16)
    return jm, m


def _leaf_close(got, want, what, bf16_model):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, what
    if bf16_model:
        scale = max(float(np.abs(w).max()), 1e-6)
        assert float(np.abs(g - w).max()) <= BF16_REL * scale, what
    elif np.asarray(want).dtype == jnp.bfloat16:
        np.testing.assert_allclose(g, w, rtol=BF16_ROUND, atol=MODEL_TOL,
                                   err_msg=what)
    else:
        np.testing.assert_allclose(g, w, rtol=MODEL_TOL, atol=MODEL_TOL,
                                   err_msg=what)


def _states_close(ts, js, bf16_model=False):
    assert sorted(ts) == sorted(js)
    for name in js:
        assert type(ts[name]).__name__ == type(js[name]).__name__
        for f in js[name]._fields:
            got, want = getattr(ts[name], f), getattr(js[name], f)
            if f == "length":
                assert got == int(want), name
                continue
            assert got.dtype == {jnp.float32: torch.float32,
                                 jnp.bfloat16: torch.bfloat16}[
                                     np.asarray(want).dtype.type], (name, f)
            _leaf_close(got, want, f"{name}.{f}", bf16_model)


def _run_both(arch, backend="ref", bf16=False):
    _run_configs(*_configs(arch, bf16), backend, bf16)


OPTION_LEAVES = ("q_norm", "k_norm", "ln_attn_post", "ln_mlp_post")


def _init_with_options(jm):
    """The JAX package's weights for ``jm``, with the option leaves that
    init leaves at zeros or ones (the q/k/v biases, the q/k norms and the
    post-norms) drawn from a seed instead, so that each option shows in
    the outputs."""
    jp = jtfm.init_params(jax.random.PRNGKey(0), jm)
    rng = np.random.default_rng(11)
    for lp in jp["layers"].values():
        for name in ("q", "k", "v"):
            if "bias" in lp.get(name, {}):
                b = lp[name]["bias"]
                lp[name]["bias"] = jnp.asarray(
                    0.5 * rng.standard_normal(b.shape), b.dtype)
        for name in OPTION_LEAVES:
            if name in lp:
                sc = lp[name]["scale"]
                lp[name]["scale"] = jnp.asarray(
                    1.0 + 0.2 * rng.standard_normal(sc.shape), sc.dtype)
    return jp


def _run_configs(jm, m, backend="ref", bf16=False, cache_dtype="bfloat16"):
    """Prefill and GEN greedy decode steps in both packages from the same
    weights; ``cache_dtype`` is the KV caches' dtype (the reference's
    default, bfloat16, unless given)."""
    jp = _init_with_options(jm)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    toks = jsynthetic.make_lm_tokens(m.vocab, BATCH, PROMPT, seed=1)
    max_len = PROMPT + GEN + 1
    prev = jops.get_backend()
    jops.set_backend(backend)
    try:
        jl, js = jtfm.prefill(jp, jm, jnp.asarray(toks), max_len=max_len,
                              dtype=getattr(jnp, cache_dtype))
    finally:
        jops.set_backend(prev)
    tl, ts = tfm.prefill(tp, m, torch.from_numpy(toks).long(),
                         max_len=max_len, dtype=getattr(torch, cache_dtype))
    _leaf_close(tl, jl, "prefill logits", bf16)
    _states_close(ts, js, bf16)
    jtok = jnp.argmax(jl, axis=-1).astype(jnp.int32)
    ttok = torch.argmax(tl, dim=-1)
    for step in range(GEN):
        if bf16:     # near-ties may flip in bf16: feed both JAX's tokens
            ttok = torch.from_numpy(np.array(jtok)).long()
        assert ttok.tolist() == np.asarray(jtok).tolist(), step
        jl, js = jtfm.decode_step(jp, jm, jtok, js)
        tl, ts = tfm.decode_step(tp, m, ttok, ts)
        _leaf_close(tl, jl, f"decode {step} logits", bf16)
        _states_close(ts, js, bf16)
        jtok = jnp.argmax(jl, axis=-1).astype(jnp.int32)
        ttok = torch.argmax(tl, dim=-1)


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_prefill_and_decode_match_jax(arch):
    """Batch 2, prompt 48 (> recurrentgemma's window of 16: the ring branch
    of prefill and the ring decode run), 4 greedy decode steps: logits,
    every state leaf and the greedy tokens."""
    _run_both(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_prefill_matches_jax_pallas_kernels_interpret(arch):
    """The JAX side runs its Pallas K11/K12 in interpret mode."""
    _run_both(arch, backend="interpret")


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_bf16_model_matches_jax(arch):
    """bf16 weights cross through the repaired ``convert``."""
    _run_both(arch, bf16=True)


def test_global_attention_layers_and_attention_softcap_match_jax():
    """The "attn" block type (linear cache) beside a "swa" layer (ring
    cache), with the attention logit softcap on: the options the two
    served configs leave unset but the port's stack still takes."""
    kw = dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
              d_ff=256, vocab=512, block_pattern=("attn", "swa"), window=16,
              softcap_attn=30.0, act="gelu")
    _run_configs(jtfm.ModelConfig(**kw, dtype=jnp.float32),
                 tfm.ModelConfig(**kw, dtype=torch.float32))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_plus_decode_equals_longer_prefill_as_in_jax(arch):
    _gap_matches(*_configs(arch))


def _gap_matches(jm, m):
    """prefill(T) + one decode step against prefill(T + 1): the port's gap
    equals JAX's within 1e-5 + 0.5 * JAX's."""
    jp = _init_with_options(jm)
    tp = _carry(jp)
    toks = jsynthetic.make_lm_tokens(m.vocab, 2, 41, seed=1)
    jl, js = jtfm.prefill(jp, jm, jnp.asarray(toks[:, :40]), max_len=48)
    jstep, _ = jtfm.decode_step(jp, jm, jnp.asarray(toks[:, 40]), js)
    jlong, _ = jtfm.prefill(jp, jm, jnp.asarray(toks), max_len=48)
    tt = torch.from_numpy(toks).long()
    _, ts = tfm.prefill(tp, m, tt[:, :40], max_len=48)
    tstep, _ = tfm.decode_step(tp, m, tt[:, 40], ts)
    tlong, _ = tfm.prefill(tp, m, tt, max_len=48)
    jgap = float(np.abs(_np(jstep) - _np(jlong)).max())
    tgap = float((tstep - tlong).abs().max())
    assert abs(tgap - jgap) <= 1e-5 + 0.5 * jgap, (tgap, jgap)


# --------------------------------------------------------------------------- #
# configs, data, convert, the serve entry
# --------------------------------------------------------------------------- #

DENSE_ARCHS = ("qwen2-0.5b", "qwen2-7b", "gemma2-9b", "gemma3-4b")
MULTIMODAL_ARCHS = ("qwen2-vl-7b", "seamless-m4t-large-v2")
MOE_ARCHS = ("mixtral-8x7b", "llama4-maverick-400b-a17b")
_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _same_fields(t, j):
    """Every dataclass field of the port's ``t`` equals the reference's
    ``j`` (dtypes mapped; the reference's decoder config also has
    ``scan_layers``, a compile-time option the port's loop has no use
    for)."""
    for f in dataclasses.fields(t):
        got, want = getattr(t, f.name), getattr(j, f.name)
        if f.name == "dtype":
            assert got == _DTYPES[want], f.name
        elif dataclasses.is_dataclass(want):     # the MoE config
            assert type(got).__name__ == type(want).__name__, f.name
            assert dataclasses.asdict(got) == dataclasses.asdict(want), f.name
            assert got.capacity() == want.capacity(), f.name
        else:
            assert got == want, f.name


def test_registry_and_published_dims():
    """Every spec (the ArchSpec's fields, ``is_encdec`` and ``runs``), its
    model config and its ``reduced()`` equal the reference's, the MoE
    configs (and their capacities) included, and so do the analytic
    parameter counts; an unknown id raises."""
    assert set(ARCH_IDS) == set(ARCHS) | set(DENSE_ARCHS) | set(
        MULTIMODAL_ARCHS) | set(MOE_ARCHS)
    for arch in ARCHS + DENSE_ARCHS + MULTIMODAL_ARCHS + MOE_ARCHS:
        j, t = jget_spec(arch), get_spec(arch)
        for f in ("arch_id", "family", "citation", "modality", "skip_shapes",
                  "skip_reason", "n_prefix_tokens", "is_encdec"):
            assert getattr(t, f) == getattr(j, f), (arch, f)
        assert [t.runs(s) for s in JSHAPES] == [j.runs(s) for s in JSHAPES]
        assert t.model.dtype == torch.bfloat16
        _same_fields(t.model, j.model)
        rj, rt = jreduced(j), reduced(t)
        assert rt.n_prefix_tokens == rj.n_prefix_tokens
        _same_fields(rt.model, rj.model)
        if not t.is_encdec:
            for mt, mj in ((t.model, j.model), (rt.model, rj.model)):
                assert mt.num_params() == mj.num_params(), arch
                assert mt.active_params() == mj.active_params(), arch
                assert [mt.is_moe_layer(i) for i in range(mt.n_layers)] == [
                    mj.is_moe_layer(i) for i in range(mj.n_layers)], arch
    assert get_spec("qwen2-vl-7b").n_prefix_tokens == 256
    assert reduced(get_spec("qwen2-vl-7b")).model.mrope_sections == (16, 8, 8)
    assert get_spec("seamless-m4t-large-v2").is_encdec
    assert reduced(get_spec("mixtral-8x7b")).model.moe.capacity() == 64
    assert get_spec("mixtral-8x7b").model.moe.capacity() == 80
    assert get_spec("llama4-maverick-400b-a17b").model.moe.capacity() == 4
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_spec("no-such-arch")


def test_make_lm_tokens_byte_equal():
    for args in ((4096, 3, 50, 1), (512, 2, 7, 0)):
        a = synthetic.make_lm_tokens(*args[:3], seed=args[3])
        b = jsynthetic.make_lm_tokens(*args[:3], seed=args[3])
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_convert_bf16_round_trips_bit_for_bit():
    bits = np.array([0x0000, 0x8000, 0x3F80, 0xBF80, 0x7F80, 0xFF80, 0x7FC1,
                     0x0001, 0x8001, 0x4049, 0x1234, 0xFEDC], np.uint16)
    bf = jnp.bfloat16
    tree = {"a": {"w": bits.view(bf)}, "b": np.arange(6, dtype=np.float32),
            "c": bits[::-1].copy().view(bf).reshape(3, 4)}
    t = convert.params_from_jax(tree, "cpu")
    assert t["a"]["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        t["a"]["w"].view(torch.int16).numpy().view(np.uint16), bits)
    back = convert.params_to_numpy(t)
    for path in (("a", "w"), ("c",)):
        got, want = back, tree
        for p in path:
            got, want = got[p], want[p]
        assert got.dtype == np.uint16       # bfloat16 comes back as its bits
        np.testing.assert_array_equal(got, want.view(np.uint16))
    np.testing.assert_array_equal(back["b"], tree["b"])
    finite = bits[[0, 1, 2, 3, 9, 10]].view(bf)
    np.testing.assert_array_equal(
        convert.params_from_jax(finite, "cpu").float().numpy(),
        finite.astype(np.float32))


def _jax_serve_ids(arch, capsys, monkeypatch, temperature):
    argv = ["serve", "--arch", arch, "--reduced", "--batch", "2",
            "--prompt-len", str(PROMPT), "--gen", "8", "--temperature",
            str(temperature)]
    monkeypatch.setattr(sys, "argv", argv)
    capsys.readouterr()
    jserve.main()
    out = capsys.readouterr().out
    return [int(s) for s in re.search(r"sample token ids: \[([^\]]*)\]",
                                      out).group(1).split(",")]


@pytest.mark.parametrize("temperature", [0.0, 1.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_returns_the_jax_serve_tokens(arch, temperature, capsys,
                                            monkeypatch):
    """The body of the JAX package's ``launch/serve.py`` (weights from
    ``PRNGKey(0)``, prompts ``make_lm_tokens(min(vocab, 4096), ...,
    seed=1)``, sampling keys from ``PRNGKey(3)``) against :func:`serve.serve`
    given the same weights; the JAX entry point prints sequence 0's tokens."""
    want = _jax_serve_ids(arch, capsys, monkeypatch, temperature)
    jm, m = _configs(arch)
    tp = _carry(jtfm.init_params(jax.random.PRNGKey(0), jm))
    res = serve.serve(tp, m, serve.prompts_for(m, 2, PROMPT, "cpu"), 8,
                      temperature)
    assert res.tokens.shape == (2, 8) and len(res.logits) == 8
    assert res.tokens[0].tolist() == want


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_reduced_on_the_cpu(arch, capsys):
    serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--batch",
                "2", "--prompt-len", "20", "--gen", "3"])
    out = capsys.readouterr().out
    assert "prefill done" in out and "generated 3 tokens x 2 seqs" in out


@pytest.mark.parametrize("option,value", [
    ("softcap_final", 30.0), ("qkv_bias", True), ("qk_norm", True),
    ("post_norm", True), ("long_context_cap", 16)])
def test_other_families_options_are_not_ported(option, value):
    """The dense family's options, once unported here, each on reduced
    recurrentgemma against JAX: prefill and decode as in
    :func:`test_reduced_prefill_and_decode_match_jax`.  ``post_norm`` on
    an rglru layer raises ``KeyError('ln_attn_post')`` in both packages
    (the reference gives rglru layers no ``ln_attn_post``), and
    ``long_context_cap`` changes nothing where no layer is "attn"."""
    jm, m = (dataclasses.replace(c, **{option: value})
             for c in _configs("recurrentgemma-2b"))
    if option != "post_norm":
        _run_configs(jm, m)
        return
    toks = np.zeros((1, 8), np.int32)
    with pytest.raises(KeyError, match="ln_attn_post"):
        jtfm.prefill(jtfm.init_params(jax.random.PRNGKey(0), jm), jm,
                     jnp.asarray(toks), max_len=12)
    tp = tfm.init_params(m, torch.Generator().manual_seed(0))
    assert "ln_mlp_post" in tp["layers"]["layer_0"]
    with pytest.raises(KeyError, match="ln_attn_post"):
        tfm.prefill(tp, m, torch.from_numpy(toks).long(), max_len=12)


def test_training_and_other_families_are_not_ported():
    """Training, prefix embeddings, M-RoPE, the encoder-decoder and the MoE
    family are ported, and so is ``CommMeter``'s device-resident mode (the
    reference's ``"jnp"``); what still raises outside the model zoo is
    ``prng.choice(replace=True)``, which no part of the reference calls."""
    from repro_torch import prng
    from repro_torch.core import comm

    for mode in ("jnp", "device"):
        assert comm.CommMeter(mode=mode).mode == "device"
    assert comm.CommMeter().mode == "host"
    with pytest.raises(ValueError, match="mode"):
        comm.CommMeter(mode="bogus")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        prng.choice(prng.PRNGKey(0), 5, 2, replace=True)
    for arch in MOE_ARCHS:
        m = reduced(get_spec(arch)).model
        tp = tfm.init_params(m, torch.Generator().manual_seed(0))
        moe_layers = [i for i in range(m.n_layers) if m.is_moe_layer(i)]
        assert moe_layers and all("moe" in tp["layers"][f"layer_{i}"]
                                  for i in moe_layers)
        tfm.loss(tp, m, torch.zeros((1, 4), dtype=torch.int64))
        tfm.prefill(tp, m, torch.zeros((1, 2), dtype=torch.int64), 4)