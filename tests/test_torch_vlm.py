"""The VLM backbone (qwen2-vl-7b) in the port against the JAX package, on
the CPU: M-RoPE, prefix embeddings, the reduced model's prefill, decode,
loss and gradients, and its launchers.  (Its text-only loss is also in
``tests/test_torch_train_loss.py``.)

The reduced config keeps qwen2-vl's options (q/k/v biases, untied
unembed, RoPE theta 1e6, M-RoPE sections (16, 8, 8) at head_dim 64) and
its 16 prefix tokens.  Weights come from the port's seeded init with the
q/k/v biases drawn from a numpy seed (init leaves them at zero), handed
to JAX as arrays; prefix embeddings, tokens and position ids come from
numpy.  The vision-grid ids place the 16 prefix embeddings on two
temporal frames of a 2 x 4 (h, w) grid, then the text at one id past the
grid's largest on all three axes, as Qwen2-VL numbers them, so that the
t, h and w sections each rotate by their own ids.  Every JAX function is
jitted once a module.  Tolerances, float32, stated before the runs:

* ``apply_mrope`` against JAX's: rtol = atol = 1e-6 (the same float32
  operations; cos and sin of another library); with equal t/h/w ids
  ``apply_mrope`` equals ``apply_rope`` bit for bit;
* prefill and 4 greedy decode steps with float32 KV caches: logits and
  every cache leaf rtol = atol = 1e-4, the greedy tokens equal
  (``tests/test_torch_zoo.py``'s model tolerance);
* the loss rtol 1e-5, each gradient leaf within 1e-4 of max |JAX leaf|
  (``tests/test_torch_train_loss.py``'s).
"""

import functools
import re

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # xdist workers share the cores: no spinning OpenMP pools

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_spec as jget_spec  # noqa: E402
from repro.configs.base import reduced as jreduced  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import tree as tree_util  # noqa: E402
from repro_torch.configs import get_spec, reduced  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.launch import steps, train  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402

ARCH = "qwen2-vl-7b"
ROPE_TOL = 1e-6
MODEL_TOL = 1e-4
LOSS_RTOL, GRAD_REL = 1e-5, 1e-4
B, T, GEN, NPRE = 2, 24, 4, 16
MAX_LEN = NPRE + T + GEN + 1


@pytest.fixture(autouse=True)
def _partitionable_threefry():
    with jax.threefry_partitionable(True):
        yield


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol,
                               err_msg=what)


def grid_positions3(b, npre, t_text, frames=2, width=4):
    """(B, 3, npre + t_text) ids: ``npre`` prefix tokens on ``frames``
    temporal frames of an (npre / frames / width, width) grid, then the
    text at one past the grid's largest id on all three axes."""
    per = npre // frames
    tt = np.repeat(np.arange(frames), per)
    hh = np.tile(np.repeat(np.arange(per // width), width), frames)
    ww = np.tile(np.arange(width), frames * (per // width))
    text = max(tt.max(), hh.max(), ww.max()) + 1 + np.arange(t_text)
    pos = np.stack([np.concatenate([a, text]) for a in (tt, hh, ww)])
    return np.ascontiguousarray(np.broadcast_to(pos, (b,) + pos.shape))


# --------------------------------------------------------------------------- #
# M-RoPE
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("sections,dh", [((16, 8, 8), 64),
                                         ((16, 24, 24), 128)])
def test_apply_mrope_matches_jax(sections, dh):
    x = _randn(1, 2, 3, 40, dh) * 3
    pos = grid_positions3(2, 32, 8)
    pos[1] += 5                                    # batch rows differ
    want = jlayers.apply_mrope(jnp.asarray(x), jnp.asarray(pos), sections,
                               1e6)
    got = layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos),
                             sections, 1e6)
    assert got.dtype == torch.float32 and got.shape == x.shape
    _close(got, want, ROPE_TOL)
    assert not np.allclose(_np(got), _np(layers.apply_rope(
        torch.from_numpy(x), torch.from_numpy(pos[:, 0]), 1e6)), atol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_apply_mrope_with_equal_ids_is_apply_rope(dtype):
    x = torch.from_numpy(_randn(2, 2, 4, 33, 128)).to(dtype)
    pos = torch.from_numpy(np.random.default_rng(3).integers(0, 9000, (2, 33)))
    got = layers.apply_mrope(x, pos[:, None].expand(2, 3, 33), (16, 24, 24),
                             1e6)
    want = layers.apply_rope(x, pos, 1e6)
    assert got.dtype == dtype and torch.equal(got, want)
    with pytest.raises(ValueError, match="sum to 64"):
        layers.apply_mrope(x, pos[:, None].expand(2, 3, 33), (16, 24, 16))


# --------------------------------------------------------------------------- #
# the reduced model
# --------------------------------------------------------------------------- #

@functools.lru_cache(maxsize=None)
def _model():
    """The reduced configs and weights of both packages (the port's seeded
    init, q/k/v biases drawn from a numpy seed)."""
    jm = jreduced(jget_spec(ARCH)).model
    m = reduced(get_spec(ARCH)).model
    tp = tfm.init_params(m, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(11)
    for lp in tp["layers"].values():
        for name in ("q", "k", "v"):
            lp[name]["bias"] = torch.from_numpy(
                0.5 * rng.standard_normal(lp[name]["bias"].shape).astype(
                    np.float32))
    jp = jax.tree.map(jnp.asarray, convert.params_to_numpy(tp))
    return jm, jp, m, tp


@functools.lru_cache(maxsize=None)
def _jitted(jm):
    prefill = jax.jit(lambda p, t, pre, p3: jtfm.prefill(
        p, jm, t, MAX_LEN, prefix_embeds=pre, positions3=p3,
        dtype=jnp.float32))
    decode = jax.jit(lambda p, t, s, p3: jtfm.decode_step(p, jm, t, s, p3))
    grad = jax.jit(jax.value_and_grad(lambda p, t, pre, p3: jtfm.loss(
        p, jm, t, prefix_embeds=pre, positions3=p3, loss_chunk=8)))
    return prefill, decode, grad


def _inputs(grid):
    toks = np.random.default_rng(5).integers(0, 512, (B, T)).astype(np.int32)
    pre = _randn(6, B, NPRE, 256)
    pos3 = grid_positions3(B, NPRE, T) if grid else None
    return toks, pre, pos3


def _t(x):
    if x is None:
        return None
    t = torch.from_numpy(np.asarray(x))
    return t.long() if t.dtype == torch.int32 else t


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("grid", [True, False], ids=["vision-grid", "default"])
def test_reduced_prefill_and_decode_match_jax(grid):
    """16 prefix embeddings and 24 tokens, then 4 greedy decode steps,
    float32 caches; with the vision-grid ids the decode steps continue the
    text ids (explicit ``positions3``), by default every id is the cache
    length."""
    jm, jp, m, tp = _model()
    jprefill, jdecode, _ = _jitted(jm)
    toks, pre, pos3 = _inputs(grid)
    jl, js = jprefill(jp, _j(toks), _j(pre), _j(pos3))
    tl, ts = tfm.prefill(tp, m, _t(toks), MAX_LEN, prefix_embeds=_t(pre),
                         positions3=_t(pos3), dtype=torch.float32)
    for step in range(GEN + 1):
        _close(tl, jl, MODEL_TOL, f"logits {step}")
        for name in js:
            assert ts[name].length == int(js[name].length) == NPRE + T + step
            _close(ts[name].k, js[name].k, MODEL_TOL, f"{name}.k {step}")
            _close(ts[name].v, js[name].v, MODEL_TOL, f"{name}.v {step}")
        tok = torch.argmax(tl, -1)
        assert tok.tolist() == np.asarray(jnp.argmax(jl, -1)).tolist(), step
        if step == GEN:
            break
        p3 = None
        if grid:
            p3 = np.full((B, 3, 1), pos3[0, 0, -1] + 1 + step, np.int64)
        jl, js = jdecode(jp, jnp.asarray(tok.numpy(), jnp.int32), js, _j(p3))
        tl, ts = tfm.decode_step(tp, m, tok, ts, positions3=_t(p3))


def test_loss_and_gradients_with_prefix_match_jax():
    """The prefix positions carry no target: the loss is over the 24
    tokens' 23 next-token targets, in chunks of 8; vision-grid ids."""
    jm, jp, m, tp = _model()
    toks, pre, pos3 = _inputs(True)
    jl, jg = _jitted(jm)[2](jp, _j(toks), _j(pre), _j(pos3))
    live = [leaf.detach().requires_grad_() for leaf in tree_util.leaves(tp)]
    loss = tfm.loss(tree_util.unflatten(tp, live), m, _t(toks),
                    prefix_embeds=_t(pre), positions3=_t(pos3), loss_chunk=8)
    grads = torch.autograd.grad(loss, live)
    np.testing.assert_allclose(float(loss.detach()), float(jl),
                               rtol=LOSS_RTOL)
    want = jax.tree_util.tree_leaves(jg)
    assert len(grads) == len(want)
    for got, w in zip(grads, want):
        w = np.asarray(w)
        np.testing.assert_allclose(got.numpy(), w, rtol=0,
                                   atol=GRAD_REL * float(np.abs(w).max()))


def test_prefill_step_places_the_prefix_and_sizes_the_cache():
    """``steps.build_prefill_step``: tokens of ``t - npre`` after
    ``n_prefix_tokens`` bf16 prefix embeddings, caches of ``t``."""
    spec = reduced(get_spec(ARCH))
    _, _, m, tp = _model()
    t = NPRE + T
    bundle = steps.build_prefill_step(spec, InputShape("p", t, B, "prefill"))
    assert bundle.args[1] == {
        "tokens": steps.TensorSpec((B, T), torch.int64),
        "prefix_embeds": steps.TensorSpec((B, NPRE, 256), torch.bfloat16)}
    toks, pre, _ = _inputs(False)
    batch = {"tokens": _t(toks), "prefix_embeds": _t(pre).to(torch.bfloat16)}
    logits, state = bundle.fn(tp, batch)
    want, _ = tfm.prefill(tp, m, _t(toks), t,
                          prefix_embeds=batch["prefix_embeds"])
    assert torch.equal(logits, want)
    assert state["layer_0"].k.shape == (B, m.n_kv_heads, t, m.hd)
    assert state["layer_0"].length == t


# --------------------------------------------------------------------------- #
# the launchers
# --------------------------------------------------------------------------- #

def test_train_cli_runs_reduced_on_the_cpu(capsys):
    """Zero bf16 prefix embeddings before ``--seq - 16`` tokens, as the
    reference's trainer feeds qwen2-vl; the loss falls."""
    train.main(["--arch", ARCH, "--reduced", "--steps", "3", "--batch", "2",
                "--seq", "40", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == "done"
    losses = [float(re.match(r"step +\d+  loss (\S+)  \(\S+s\)$", ln)
                    .group(1)) for ln in out[:-1]]
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    spec = reduced(get_spec(ARCH))
    batch = train.batch_for(spec, np.zeros((2, 40), np.int32), 0, "cpu")
    assert batch["tokens"].shape == (2, 24)
    assert batch["prefix_embeds"].dtype == torch.bfloat16
    assert not batch["prefix_embeds"].any()
