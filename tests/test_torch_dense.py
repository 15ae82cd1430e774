"""The dense GQA family served by the port (qwen2-7b, gemma2-9b, gemma3-4b,
reduced) against the JAX package, on the CPU.

The reduced configs keep each family's options: q/k/v biases (qwen2),
post-norms, the final logit softcap and the attention softcap (gemma2),
q/k norms (gemma3), and sliding windows with the long-context cap of 16
on the "attn" layers (gemma2, gemma3).  The reduced gemma3 has 4 layers,
all "swa"; a 6-layer variant on both sides also runs its capped global
layer.  Weights are the JAX package's, with the biases and norm scales
drawn from a seed (``test_torch_zoo._init_with_options``), carried by
``convert.params_from_jax``.  Batch 2, prompt 48 (above the window of
16: the ring branch of prefill and the ring decode run), 4 greedy decode
steps.  Tolerances are those of ``test_torch_zoo.py``: rtol = atol = 1e-4
in float32 for logits, every cache leaf and the greedy tokens; 3% of max
|JAX| in bfloat16; the prefill(T) + decode against prefill(T + 1) gap
within 1e-5 + half of JAX's own gap.

The float32 runs carry float32 KV caches.  With the reference's default
bfloat16 caches, 18-20 of the ~50 000 cache entries that prefill writes
round to the neighbouring bf16 value (their float32 k/v differ in the last
bits), and the carried decode logits then part by up to 2.1e-4 (measured,
qwen2-7b).  So the bf16-cache decode is held step by step instead: each
decode step starts from JAX's caches and token, and its logits and caches
must match within the same 1e-4 (measured below 1.2e-5).
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # xdist workers share the cores: no spinning OpenMP pools

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_spec as jget_spec  # noqa: E402
from repro.configs.base import reduced as jreduced  # noqa: E402
from repro.data import synthetic as jsynthetic  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_spec, reduced  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from tests.test_torch_zoo import (  # noqa: E402
    BATCH, GEN, OPTION_LEAVES, PROMPT, _gap_matches, _init_with_options,
    _leaf_close, _run_configs, _states_close)

ARCHS = ("qwen2-7b", "gemma2-9b", "gemma3-4b")
OPTIONS = ("qkv_bias", "qk_norm", "post_norm", "softcap_final",
           "long_context_cap")


def _configs(arch, bf16=False, **over):
    jm = dataclasses.replace(jreduced(jget_spec(arch)).model, **over)
    m = dataclasses.replace(reduced(get_spec(arch)).model, **over)
    if bf16:
        jm = dataclasses.replace(jm, dtype=jnp.bfloat16)
        m = dataclasses.replace(m, dtype=torch.bfloat16)
    return jm, m


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_prefill_and_decode_match_jax(arch):
    _run_configs(*_configs(arch), cache_dtype="float32")


def test_gemma3_six_layers_run_the_capped_global_layer():
    jm, m = _configs("gemma3-4b", n_layers=6)
    assert [m.layer_window(i) for i in range(6)] == [16] * 6
    assert m.block_type(5) == "attn" and jm.layer_window(5) == 16
    _run_configs(jm, m, cache_dtype="float32")


def _state_from_jax(js):
    return {name: attn.KVCache(k=convert.params_from_jax(np.asarray(c.k),
                                                         "cpu"),
                               v=convert.params_from_jax(np.asarray(c.v),
                                                         "cpu"),
                               length=int(c.length))
            for name, c in js.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_cache_decode_steps_match_jax_from_its_caches(arch):
    """Float32 model, the reference's bf16 KV caches: prefill as in the
    carried runs, then each decode step from JAX's caches and token."""
    jm, m = _configs(arch)
    jp = _init_with_options(jm)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    toks = jsynthetic.make_lm_tokens(m.vocab, BATCH, PROMPT, seed=1)
    max_len = PROMPT + GEN + 1
    jl, js = jtfm.prefill(jp, jm, jnp.asarray(toks), max_len=max_len)
    tl, ts = tfm.prefill(tp, m, torch.from_numpy(toks).long(),
                         max_len=max_len)
    _leaf_close(tl, jl, "prefill logits", False)
    _states_close(ts, js)
    for step in range(GEN):
        jtok = jnp.argmax(jl, axis=-1).astype(jnp.int32)
        ttok = torch.from_numpy(np.array(jtok)).long()
        tl, ts = tfm.decode_step(tp, m, ttok, _state_from_jax(js))
        jl, js = jtfm.decode_step(jp, jm, jtok, js)
        _leaf_close(tl, jl, f"decode {step} logits", False)
        _states_close(ts, js)
        assert torch.argmax(tl, -1).tolist() == np.asarray(
            jnp.argmax(jl, -1)).tolist(), step


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_bf16_model_matches_jax(arch):
    _run_configs(*_configs(arch, bf16=True), bf16=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_plus_decode_equals_longer_prefill_as_in_jax(arch):
    _gap_matches(*_configs(arch))


def test_every_dense_option_is_exercised():
    seen = {o for arch in ARCHS for o in OPTIONS
            if getattr(_configs(arch)[1], o) not in (None, False)}
    assert seen == set(OPTIONS)
    assert _configs("gemma2-9b")[1].layer_window(1) == 16


@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_convert_carries_the_option_leaves(arch, bf16):
    """Every leaf, the biases, q/k norms and post-norms among them, crosses
    with its shape, dtype and bits."""
    jm, m = _configs(arch, bf16)
    jp = _init_with_options(jm)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    jleaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    names = set()
    for path, want in jleaves:
        keys = [p.key for p in path]
        got = tp
        for key in keys:
            got = got[key]
        names.update(keys)
        want = np.asarray(want)
        back = convert.params_to_numpy(got)
        if want.dtype.name == "bfloat16":   # the port hands over the bits
            assert back.dtype == np.uint16, keys
            back = back.view(want.dtype)
        assert back.dtype == want.dtype and back.shape == want.shape, keys
        view = np.uint16 if want.dtype.itemsize == 2 else np.uint32
        np.testing.assert_array_equal(back.view(view), want.view(view))
    want_names = {"bias"} if m.qkv_bias else set()
    want_names |= {n for n in OPTION_LEAVES
                   if (n in ("q_norm", "k_norm") and m.qk_norm)
                   or (n.endswith("_post") and m.post_norm)}
    assert want_names <= names
    assert ("bias" in names) == m.qkv_bias


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_reduced_on_the_cpu(arch, capsys):
    serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--batch",
                "2", "--prompt-len", "20", "--gen", "3"])
    out = capsys.readouterr().out
    assert "prefill done" in out and "generated 3 tokens x 2 seqs" in out
