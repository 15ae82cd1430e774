"""The encoder-decoder backbone (``models/encdec.py``, seamless-m4t-large-v2)
in the port against the JAX package, on the CPU: the encoder, the loss and
its gradients, prefill and decode, the launchers and the fed round, and
``chunked_attention``'s gradients at cross-attention's shapes.

The reduced config is the reference's (one encoder and one decoder layer,
d_model 128, 4 heads of 32, d_ff 256, vocab 512, float32).  Weights come
from the port's seeded init handed to JAX as arrays (the serve test takes
JAX's own init, as its CLI does); source frames and tokens come from
numpy seeds, at a ragged T_src = 20 and T_tgt = 12.  Every JAX function
is jitted once a module.  Tolerances, float32, stated before the runs:

* ``encode``: rtol = atol = 1e-5 (float32 sums in other orders);
* the loss rtol 1e-5, each gradient leaf within 1e-4 of max |JAX leaf|;
  attention gradients rtol = atol = 2e-5 (``tests/test_torch_train.py``'s);
* prefill and 4 greedy decode steps with float32 caches: logits and every
  cache leaf rtol = atol = 1e-4, the greedy tokens equal.  With the
  reference's default bf16 caches a float32 difference in the last bits
  can round a cache entry to the neighbouring bf16 value (ROADMAP Queue
  C), so those decode steps are held step by step: each starts from
  JAX's state, carried through a JAX checkpoint file into the port, and
  must match within 1e-4 (bf16 cache leaves: plus one bf16 rounding,
  rtol 2^-7);
* the fed round (one client, Q_r(8), two local steps, two rounds): the
  loss rtol 1e-5, params and h within 1e-6, ``comm_bits`` equal to JAX's
  and to the closed form (9 bits a scalar, 32 a tensor).
"""

import dataclasses
import functools
import re
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # xdist workers share the cores: no spinning OpenMP pools

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro.checkpoint import checkpoint as jcheckpoint  # noqa: E402
from repro.configs import get_spec as jget_spec  # noqa: E402
from repro.configs.base import SHAPES as JSHAPES  # noqa: E402
from repro.configs.base import reduced as jreduced  # noqa: E402
from repro.launch import fed_train as jfed  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro_torch import convert, prng  # noqa: E402
from repro_torch import tree as tree_util  # noqa: E402
from repro_torch.checkpoint import checkpoint  # noqa: E402
from repro_torch.configs import get_spec, reduced  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.launch import fed_train, serve, steps, train  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import encdec  # noqa: E402

ARCH = "seamless-m4t-large-v2"
MOD_TOL, MODEL_TOL, ATTN_TOL = 1e-5, 1e-4, 2e-5
LOSS_RTOL, GRAD_REL = 1e-5, 1e-4
BF16_ROUND = 2 ** -7
STATE_ATOL = 1e-6
B, T_SRC, T_TGT, GEN, PREFIX = 2, 20, 12, 4, 5
MAX_LEN = PREFIX + GEN + 1


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


def _close(got, want, tol, what="", rtol=None):
    np.testing.assert_allclose(_np(got), _np(want),
                               rtol=tol if rtol is None else rtol, atol=tol,
                               err_msg=what)


@functools.lru_cache(maxsize=None)
def _model():
    jm = jreduced(jget_spec(ARCH)).model
    m = reduced(get_spec(ARCH)).model
    tp = encdec.init_params(m, torch.Generator().manual_seed(0))
    jp = jax.tree.map(jnp.asarray, convert.params_to_numpy(tp))
    return jm, jp, m, tp


def _data(t_src=T_SRC, t_tgt=T_TGT):
    src = _randn(3, B, t_src, 128)
    tgt = np.random.default_rng(4).integers(0, 512, (B, t_tgt)).astype(
        np.int32)
    return src, tgt


@functools.lru_cache(maxsize=None)
def _jitted(jm, cache_dtype):
    dt = getattr(jnp, cache_dtype)
    return {
        "encode": jax.jit(lambda p, s: jencdec.encode(p, jm, s)),
        "grad": jax.jit(jax.value_and_grad(lambda p, s, t: jencdec.loss(
            p, jm, s, t, loss_chunk=8))),
        "prefill": jax.jit(lambda p, s, t: jencdec.prefill(
            p, jm, s, t, MAX_LEN, dtype=dt)),
        "decode": jax.jit(lambda p, t, st: jencdec.decode_step(p, jm, t, st)),
    }


def test_encode_matches_jax():
    jm, jp, m, tp = _model()
    src, _ = _data()
    got = encdec.encode(tp, m, torch.from_numpy(src))
    assert got.shape == (B, T_SRC, 128)
    _close(got, _jitted(jm, "float32")["encode"](jp, jnp.asarray(src)),
           MOD_TOL)


def test_loss_and_gradients_match_jax():
    jm, jp, m, tp = _model()
    src, tgt = _data()
    jl, jg = _jitted(jm, "float32")["grad"](jp, jnp.asarray(src),
                                            jnp.asarray(tgt))
    live = [leaf.detach().requires_grad_() for leaf in tree_util.leaves(tp)]
    loss = encdec.loss(tree_util.unflatten(tp, live), m,
                       torch.from_numpy(src), torch.from_numpy(tgt).long(),
                       loss_chunk=8)
    grads = torch.autograd.grad(loss, live)
    np.testing.assert_allclose(float(loss.detach()), float(jl),
                               rtol=LOSS_RTOL)
    want = jax.tree_util.tree_leaves(jg)
    assert len(grads) == len(want) == 24
    for got, w in zip(grads, want):
        w = np.asarray(w)
        np.testing.assert_allclose(got.numpy(), w, rtol=0,
                                   atol=GRAD_REL * float(np.abs(w).max()))


def test_remat_off_equals_remat_on():
    _, _, m, tp = _model()
    src, tgt = _data()
    out = []
    for remat in (True, False):
        live = [x.detach().requires_grad_() for x in tree_util.leaves(tp)]
        loss = encdec.loss(tree_util.unflatten(tp, live), m,
                           torch.from_numpy(src),
                           torch.from_numpy(tgt).long(), loss_chunk=8,
                           remat=remat)
        out.append((loss.detach(), torch.autograd.grad(loss, live)))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def _state_close(ts, js, bf16=False):
    assert ts.enc_len == int(js.enc_len) == T_SRC
    for name, jc in js.self_caches.items():
        tc = ts.self_caches[name]
        assert tc.length == int(jc.length), name
        for f in ("k", "v"):
            _close(getattr(tc, f), getattr(jc, f), MODEL_TOL, f"{name}.{f}",
                   rtol=BF16_ROUND if bf16 else None)
    for name, (jk, jv) in js.cross_kv.items():
        tk, tv = ts.cross_kv[name]
        assert tk.dtype == (torch.bfloat16 if bf16 else torch.float32)
        _close(tk, jk, MODEL_TOL, name, rtol=BF16_ROUND if bf16 else None)
        _close(tv, jv, MODEL_TOL, name, rtol=BF16_ROUND if bf16 else None)


def test_prefill_and_decode_match_jax_with_float32_caches():
    """Source of 20 frames, target prefix of 5, 4 greedy decode steps."""
    jm, jp, m, tp = _model()
    fns = _jitted(jm, "float32")
    src, tgt = _data()
    jl, js = fns["prefill"](jp, jnp.asarray(src), jnp.asarray(tgt[:, :PREFIX]))
    tl, ts = encdec.prefill(tp, m, torch.from_numpy(src),
                            torch.from_numpy(tgt[:, :PREFIX]).long(),
                            MAX_LEN, dtype=torch.float32)
    for step in range(GEN + 1):
        _close(tl, jl, MODEL_TOL, f"logits {step}")
        _state_close(ts, js)
        tok = torch.argmax(tl, -1)
        assert tok.tolist() == np.asarray(jnp.argmax(jl, -1)).tolist(), step
        if step == GEN:
            break
        jl, js = fns["decode"](jp, jnp.asarray(tok.numpy(), jnp.int32), js)
        tl, ts = encdec.decode_step(tp, m, tok, ts)


def test_bf16_cache_decode_steps_match_jax_from_its_state(tmp_path):
    """The reference's default bf16 self caches and cross K/V (a float32
    model): prefill as above, then each decode step from JAX's state,
    written by the JAX package's checkpoint and read by the port's."""
    jm, jp, m, tp = _model()
    fns = _jitted(jm, "bfloat16")
    src, tgt = _data()
    jl, js = fns["prefill"](jp, jnp.asarray(src), jnp.asarray(tgt[:, :PREFIX]))
    tl, ts = encdec.prefill(tp, m, torch.from_numpy(src),
                            torch.from_numpy(tgt[:, :PREFIX]).long(), MAX_LEN)
    _close(tl, jl, MODEL_TOL, "prefill logits")
    _state_close(ts, js, bf16=True)
    like = ts
    for step in range(GEN):
        jcheckpoint.save(tmp_path / f"s{step}.npz", js)
        carried, _ = checkpoint.load(tmp_path / f"s{step}.npz", like=like)
        assert isinstance(carried, encdec.EncDecState)
        assert carried.self_caches["layer_0"].k.dtype == torch.bfloat16
        jtok = jnp.argmax(jl, -1).astype(jnp.int32)
        tl, ts = encdec.decode_step(tp, m, torch.from_numpy(
            np.array(jtok)).long(), carried)
        jl, js = fns["decode"](jp, jtok, js)
        _close(tl, jl, MODEL_TOL, f"decode {step} logits")
        _state_close(ts, js, bf16=True)


# --------------------------------------------------------------------------- #
# cross-attention's shapes in chunked_attention
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("tk", [20, 32], ids=["ragged", "whole-chunks"])
def test_chunked_attention_gradients_at_cross_attention_shapes(tk):
    """Tq = 12 queries over Tk keys, non-causal, chunks of 8 or 16: a
    ragged Tk (20) takes the explicit-length route (autograd), whole
    chunks (32 of 16) the flash route's hand-written backward."""
    chunk = 8 if tk == 20 else 16
    q = _randn(10, 2, 4, 12, 16)
    k, v = _randn(11, 2, 2, tk, 16), _randn(12, 2, 2, tk, 16)
    dout = _randn(13, 2, 4, 12, 16)
    out, vjp = jax.vjp(
        lambda *z: jattn.chunked_attention(*z, causal=False, chunk=chunk),
        *(jnp.asarray(z) for z in (q, k, v)))
    want = vjp(jnp.asarray(dout))
    ins = [torch.from_numpy(z).requires_grad_() for z in (q, k, v)]
    got = attn.chunked_attention(*ins, causal=False, chunk=chunk)
    assert (got.grad_fn.name() == "_FlashBackward") == (tk == 32)
    _close(got, out, ATTN_TOL)
    for g_, w_ in zip(torch.autograd.grad(got, ins, torch.from_numpy(dout)),
                      want):
        _close(g_, w_, ATTN_TOL)


# --------------------------------------------------------------------------- #
# the launchers
# --------------------------------------------------------------------------- #

def test_serve_returns_the_jax_serve_tokens(capsys, monkeypatch):
    """JAX's ``serve.py`` body (weights from ``PRNGKey(0)``, source frames
    ``normal(PRNGKey(2))``, the target prefix ``toks[:, :4]``, caches of
    ``prompt_len + gen + 1``) against :func:`serve.serve` on the same
    weights."""
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", ARCH, "--reduced", "--batch", "2", "--prompt-len",
        "20", "--gen", "6"])
    capsys.readouterr()
    jserve.main()
    want = [int(s) for s in re.search(r"sample token ids: \[([^\]]*)\]",
                                      capsys.readouterr().out).group(1)
            .split(",")]
    jm = jreduced(jget_spec(ARCH)).model
    tp = convert.params_from_jax(jax.tree.map(
        np.asarray, jencdec.init_params(jax.random.PRNGKey(0), jm)), "cpu")
    m = reduced(get_spec(ARCH)).model
    res = serve.serve(tp, m, serve.prompts_for(m, 2, 20, "cpu")[:, :4], 6,
                      src_embeds=serve.source_frames(m, 2, 20, "cpu"),
                      max_len=27)
    assert res.tokens.shape == (2, 6) and len(res.logits) == 6
    assert res.tokens[0].tolist() == want


def test_serve_cli_runs_reduced_on_the_cpu(capsys):
    serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--batch",
                "2", "--prompt-len", "20", "--gen", "3"])
    out = capsys.readouterr().out
    assert "prefill done" in out and "generated 3 tokens x 2 seqs" in out


def test_train_cli_runs_reduced_on_the_cpu(capsys):
    """``--seq // 2`` bf16 source frames from ``default_rng(step)`` and
    the rest target tokens, as the reference's trainer feeds the family;
    finite losses."""
    train.main(["--arch", ARCH, "--reduced", "--steps", "3", "--batch", "2",
                "--seq", "32", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == "done"
    losses = [float(re.match(r"step +\d+  loss (\S+)  \(\S+s\)$", ln)
                    .group(1)) for ln in out[:-1]]
    assert len(losses) == 3 and np.isfinite(losses).all()
    spec = reduced(get_spec(ARCH))
    batch = train.batch_for(spec, np.zeros((2, 32), np.int32), 1, "cpu")
    src = np.random.default_rng(1).normal(size=(2, 16, 128))
    assert batch["tgt_tokens"].shape == (2, 16)
    assert torch.equal(batch["src_embeds"],
                       torch.from_numpy(src).to(torch.bfloat16))


def test_prefill_and_serve_steps_run_on_their_structs():
    """``build_prefill_step`` splits the sequence into ``t // 2`` frames
    and ``t - t // 2`` target tokens; ``build_serve_step``'s state holds
    ``t - 1`` tokens against ``t // 8`` encoder frames."""
    spec = reduced(get_spec(ARCH))
    _, _, m, tp = _model()
    shape = InputShape("s", 32, B, "prefill")
    pre = steps.build_prefill_step(spec, shape)
    assert pre.args[1] == {
        "src_embeds": steps.TensorSpec((B, 16, 128), torch.bfloat16),
        "tgt_tokens": steps.TensorSpec((B, 16), torch.int64)}
    src, tgt = _data(16, 16)
    logits, state = pre.fn(tp, {"src_embeds": torch.from_numpy(src),
                                "tgt_tokens": torch.from_numpy(tgt).long()})
    assert logits.shape == (B, 512) and state.enc_len == 16
    assert state.self_caches["layer_0"].k.shape == (B, 4, 16, 32)
    srv = steps.build_serve_step(spec, shape)
    st = srv.args[2]
    assert st.enc_len == 4 and st.self_caches["layer_0"].length == 31
    real = encdec.EncDecState(
        self_caches={n: attn.KVCache(
            k=torch.zeros(c.k.shape, dtype=c.k.dtype),
            v=torch.zeros(c.v.shape, dtype=c.v.dtype), length=c.length)
            for n, c in st.self_caches.items()},
        cross_kv={n: tuple(torch.zeros(s.shape, dtype=s.dtype) for s in kv)
                  for n, kv in st.cross_kv.items()},
        enc_len=st.enc_len)
    logits, new = srv.fn(tp, torch.zeros(B, dtype=torch.int64), real)
    assert logits.shape == (B, 512) and torch.isfinite(logits).all()
    assert new.self_caches["layer_0"].length == 32


# --------------------------------------------------------------------------- #
# the fed round
# --------------------------------------------------------------------------- #

FED_T, FED_ROUNDS = 24, 2


def test_fed_round_matches_jax_on_one_client():
    """``build_fed_round`` with Q_r(8) on the reduced seamless (gamma 0.3,
    two local steps) against the JAX round on the (1, 1, 1) mesh."""
    jm, jp, m, tp = _model()
    jspec, spec = jreduced(jget_spec(ARCH)), reduced(get_spec(ARCH))
    kw = dict(gamma=0.3, local_steps=2, compressor="quant")
    src = _randn(7, 1, 2, FED_T // 2, 128)
    tgt = np.random.default_rng(8).integers(0, 512, (1, 2, FED_T // 2))
    tgt = tgt.astype(np.int32)

    b = fed_train.build_fed_round(spec, InputShape("t", FED_T, 2, "train"),
                                  fed_train.FedTrainConfig(**kw))
    assert b.args[2] == {
        "src_embeds": steps.TensorSpec((None, None, 12, 128), torch.bfloat16),
        "tgt_tokens": steps.TensorSpec((None, None, 12), torch.int64)}
    params = tree_util.map(lambda x: x[None].clone(), tp)
    h = tree_util.map(torch.zeros_like, params)
    batch = {"src_embeds": torch.from_numpy(src).to(torch.bfloat16),
             "tgt_tokens": torch.from_numpy(tgt).long()}
    key, port = prng.PRNGKey(1), []
    for _ in range(FED_ROUNDS):
        key, sub = prng.split(key, 2)
        params, h, loss, bits = b.fn(params, h, batch, sub)
        port.append((float(loss), float(bits)))

    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1),
                ("pod", "data", "model"))
    shape = dataclasses.replace(JSHAPES["train_4k"], seq_len=FED_T,
                                global_batch=2)
    jb = jfed.build_fed_round(jspec, shape, mesh, jfed.FedTrainConfig(**kw))
    stack = lambda t: jax.tree_util.tree_map(lambda x: x[None], t)  # noqa
    ps = stack(jp)
    hs = jax.tree_util.tree_map(jnp.zeros_like, ps)
    jbatch = {"src_embeds": jnp.asarray(src, jnp.bfloat16),
              "tgt_tokens": jnp.asarray(tgt)}
    key, ref = jax.random.PRNGKey(1), []
    with mesh:
        step = jax.jit(jb.fn, in_shardings=jb.in_shardings,
                       out_shardings=jb.out_shardings)
        for _ in range(FED_ROUNDS):
            key, sub = jax.random.split(key)
            ps, hs, jl, jbits = step(ps, hs, jbatch, sub)
            ref.append((float(jl), float(jbits)))

    n = sum(int(x.numel()) for x in tree_util.leaves(tp))
    closed = n * (1 + 8) + len(tree_util.leaves(tp)) * 32
    for (tl, tb), (jl_, jb_) in zip(port, ref):
        np.testing.assert_allclose(tl, jl_, rtol=LOSS_RTOL)
        assert tb == jb_ == closed
    for got, w in zip(tree_util.leaves(params) + tree_util.leaves(h),
                      jax.tree_util.tree_leaves(ps)
                      + jax.tree_util.tree_leaves(hs)):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=0,
                                   atol=STATE_ATOL)
