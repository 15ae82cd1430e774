"""The port's MoE feed-forward (``models/moe.py``) and the MoE decoder
stacks (reduced mixtral-8x7b and llama4-maverick-400b-a17b) against the
JAX package, on the CPU.

Inputs come from numpy seeds; weights are the JAX package's own init (the
MoE layer) or the port's seeded init carried to JAX (the models, as
``tests/test_torch_train_loss.py`` does: JAX's eager init compiles a
program a shape), crossing through ``convert``.  Each JAX function is
compiled once under ``jax.jit``.  Tolerances, float32, stated before the
runs:

* ``moe_apply``: out within rtol = atol = 1e-5, the balance loss within
  rtol 1e-6, the chosen experts equal and the set of dropped (token,
  choice, expert) routes equal to the one recomputed from JAX's own
  ``top_k``, ``one_hot`` and ``cumsum``; its gradients (of ``sum(out w)
  + aux``) within 1e-4 of the leaf's max |JAX|;
* the reduced models: ``loss`` rtol 1e-5 and its gradients within 1e-4 of
  each leaf's max |JAX|; prefill and 3 decode steps with float32 KV
  caches (the bf16-cache rounding of ROADMAP Queue C) within rtol = atol
  = 1e-4 for the logits and every cache leaf, greedy tokens equal; the
  greedy tokens of the port's ``serve`` equal to those of JAX's
  ``launch/serve.py``.

The reduced configs never drop a route (capacity 64 = the group of 64),
so dropping, padding and ties have cases of their own: capacity factor
0.5 (JAX drops routes), a token count that is not a multiple of the group
(zero rows pad the last group: their router logits tie on every expert),
and a router with two equal columns (every token ties on two experts).
"""

import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # xdist workers share the cores: no spinning OpenMP pools

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_spec as jget_spec  # noqa: E402
from repro.configs.base import reduced as jreduced  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import tree as tree_util  # noqa: E402
from repro_torch.configs import get_spec, reduced  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from tests.test_torch_train_loss import (  # noqa: E402
    _jax_model, _port_loss_and_grads, _tokens)
from tests.test_torch_zoo import (  # noqa: E402
    _jax_serve_ids, _leaf_close, _states_close)

OUT_TOL = 1e-5
AUX_RTOL = 1e-6
GRAD_REL = 1e-4
LOSS_RTOL = 1e-5
MOE_ARCHS = ("mixtral-8x7b", "llama4-maverick-400b-a17b")
BATCH, PROMPT, DECODES = 2, 40, 3
CHUNK = 8


@pytest.fixture(autouse=True)
def _partitionable_threefry():
    with jax.threefry_partitionable(True):
        yield


def _carry(tree):
    return convert.params_from_jax(jax.tree.map(np.asarray, tree), "cpu")


def _moe_cfgs(arch, **over):
    """The reduced config's MoE settings in both packages."""
    jm = jreduced(jget_spec(arch)).model
    jc = dataclasses.replace(jm.moe, **over)
    return jm, jc, moe.MoEConfig(**dataclasses.asdict(jc))


# --------------------------------------------------------------------------- #
# the MoE layer
# --------------------------------------------------------------------------- #

def jax_routes(jp, x, cfg):
    """JAX's chosen experts and kept routes, (G, S, k) each, recomputed
    from ``moe_apply``'s own operations (``jax.lax.top_k``,
    ``jax.nn.one_hot``, ``jnp.cumsum``)."""
    d = x.shape[-1]
    tokens = x.reshape(-1, d)
    gs = min(cfg.group_size, tokens.shape[0])
    pad = (-tokens.shape[0]) % gs
    tokens = jnp.pad(tokens, ((0, pad), (0, 0)))
    xt = tokens.reshape(-1, gs, d)
    g, e = xt.shape[0], cfg.n_experts
    logits = (xt @ jp["router"]["kernel"].astype(x.dtype)).astype(
        jnp.float32)
    _, topi = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), cfg.topk)
    sel = jax.nn.one_hot(topi, e, dtype=jnp.float32).reshape(
        g, gs * cfg.topk, e)
    pos = ((jnp.cumsum(sel, axis=1) - sel) * sel).sum(-1).reshape(
        g, gs, cfg.topk)
    return topi, pos < cfg.capacity()


def _dropped(topi, keep):
    topi, keep = np.asarray(topi), np.asarray(keep)
    return {(int(i), int(c), int(topi.reshape(-1, topi.shape[-1])[i, c]))
            for i, c in zip(*np.nonzero(~keep.reshape(-1, keep.shape[-1])))}


def _moe_case(case):
    """(JAX params, x, JAX config, port config) of one moe_apply case."""
    over = {"drop": dict(capacity_factor=0.5)}.get(case, {})
    jm, jc, tc = _moe_cfgs("mixtral-8x7b", **over)
    jp = jmoe.moe_init(jax.random.PRNGKey(0), jm.d_model, jm.d_ff, jc)
    jp = jax.tree.map(np.asarray, jp)
    shape = (3, 50, jm.d_model) if case in ("padded", "ties") else (
        2, 64, jm.d_model)
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    if case == "ties":
        router = jp["router"]["kernel"].copy()
        router[:, 2] = router[:, 1]
        jp["router"]["kernel"] = router
    return jp, x, jc, tc


MOE_CASES = ("mixtral", "drop", "padded", "ties")


@functools.lru_cache(maxsize=None)
def _jax_moe(jc):
    return jax.jit(lambda p, x: jmoe.moe_apply(p, x, jc))


@pytest.mark.parametrize("case", MOE_CASES)
def test_moe_apply_matches_jax(case):
    """Out, the balance loss, the chosen experts and the dropped routes."""
    jp, x, jc, tc = _moe_case(case)
    jout, jaux = _jax_moe(jc)(jp, jnp.asarray(x))
    tp, tx = _carry(jp), torch.from_numpy(x)
    out, aux = moe.moe_apply(tp, tx, tc)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=OUT_TOL,
                               atol=OUT_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=AUX_RTOL)
    jtopi, jkeep = jax_routes(jp, jnp.asarray(x), jc)
    r = moe.route(tp, moe.group_tokens(tx, tc)[0], tc)
    np.testing.assert_array_equal(r.topi.numpy(), np.asarray(jtopi))
    assert _dropped(r.topi, r.keep) == _dropped(jtopi, jkeep)
    n_tok = x.shape[0] * x.shape[1]
    if case == "drop":
        assert _dropped(jtopi, jkeep), "capacity factor 0.5 dropped nothing"
    if case in ("padded", "ties"):
        pad_rows = np.asarray(jtopi).reshape(-1, tc.topk)[n_tok:]
        assert len(pad_rows) and (pad_rows == [0, 1]).all()
    if case == "ties":
        # every token with expert 1 or 2 among its choices ties on both:
        # the lower index comes first, as jax.lax.top_k orders them
        rows = np.asarray(jtopi).reshape(-1, tc.topk)[:n_tok]
        both = (rows == 1).any(-1) & (rows == 2).any(-1)
        assert both.any() and (rows[both] == [1, 2]).all()


@pytest.mark.parametrize("case", ("mixtral", "drop", "padded"))
def test_moe_apply_gradients_match_jax(case):
    """Gradients of ``sum(out * w) + aux`` for every parameter and x."""
    jp, x, jc, tc = _moe_case(case)
    w = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)

    def jf(p, x_):
        out, aux = jmoe.moe_apply(p, x_, jc)
        return jnp.sum(out * w) + aux

    jg = jax.jit(jax.grad(jf, argnums=(0, 1)))(jp, jnp.asarray(x))
    tp = _carry(jp)
    live = [leaf.requires_grad_() for leaf in tree_util.leaves(tp)]
    tx = torch.from_numpy(x).requires_grad_()
    out, aux = moe.moe_apply(tree_util.unflatten(tp, live), tx, tc)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum() + aux,
                                live + [tx])
    want = jax.tree_util.tree_leaves(jg[0]) + [jg[1]]
    assert len(grads) == len(want)
    for got, wnt in zip(grads, want):
        wnt = np.asarray(wnt)
        np.testing.assert_allclose(got.numpy(), wnt, rtol=0,
                                   atol=GRAD_REL * float(np.abs(wnt).max()))


def test_shared_expert_layer_matches_jax():
    """Reduced llama4's MoE layer (top-1 of 4, plus the shared expert):
    ``_ffn`` of layer 1 and its initialised layout in both packages."""
    jm = jreduced(jget_spec("llama4-maverick-400b-a17b")).model
    m = reduced(get_spec("llama4-maverick-400b-a17b")).model
    assert m.is_moe_layer(1) and not m.is_moe_layer(0) and m.n_shared_experts
    jlayer = jtfm._layer_init(jax.random.PRNGKey(0), jm, 1)
    tlayer = tfm._layer_init(torch.Generator().manual_seed(0), m, 1)
    assert jax.tree.map(lambda a: (a.shape, str(a.dtype)), jlayer) == \
        tree_util.map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]),
                      tlayer)
    x = np.random.default_rng(3).standard_normal((2, 24, jm.d_model)).astype(
        np.float32)
    jout, jaux = jax.jit(lambda p, x_: jtfm._ffn(p, jm, 1, x_))(
        jlayer, jnp.asarray(x))
    out, aux = tfm._ffn(_carry(jlayer), m, 1, torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=OUT_TOL,
                               atol=OUT_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=AUX_RTOL)
    dense, zero = tfm._ffn({"mlp": _carry(jlayer)["shared_mlp"]}, m, 0,
                           torch.from_numpy(x))
    assert float(zero) == 0.0 and dense.shape == out.shape


def test_expert_init_draws_the_reference_distribution():
    """``moe_init``'s expert leaves, drawn one expert at a time straight
    into the model dtype, keep the reference's scales: std 1/sqrt(d) for
    wi and wg, 1/sqrt(d_ff) for wo, within 3% over 2^17 draws."""
    cfg = moe.MoEConfig(n_experts=4, topk=2)
    p = moe.moe_init(torch.Generator().manual_seed(0), 128, 256, cfg,
                     torch.bfloat16)
    assert p["router"]["kernel"].dtype == torch.float32
    for name, shape, std in (("wi", (4, 128, 256), 128 ** -0.5),
                             ("wg", (4, 128, 256), 128 ** -0.5),
                             ("wo", (4, 256, 128), 256 ** -0.5)):
        k = p[name]["kernel"]
        assert tuple(k.shape) == shape and k.dtype == torch.bfloat16
        assert abs(float(k.float().std()) / std - 1) < 0.03, name
    assert not torch.equal(p["wi"]["kernel"][0], p["wi"]["kernel"][1])


# --------------------------------------------------------------------------- #
# the reduced MoE models
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_loss_and_gradients_match_jax(arch):
    """The chunked loss with the balance loss at ``aux_weight`` 0.01, and
    the gradient of every leaf (the router's through the balance loss and
    the combine weights)."""
    jm, jp = _jax_model(arch)
    toks = _tokens(jm.vocab)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, t: jtfm.loss(p, jm, t, loss_chunk=CHUNK)))(
            jp, jnp.asarray(toks))
    loss, grads = _port_loss_and_grads(_carry(jp),
                                       reduced(get_spec(arch)).model, toks)
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    want = jax.tree_util.tree_leaves(jg)
    assert len(grads) == len(want)
    for got, w in zip(grads, want):
        w = np.asarray(w)
        np.testing.assert_allclose(got.numpy(), w, rtol=0,
                                   atol=GRAD_REL * float(np.abs(w).max()))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_and_decode_match_jax(arch):
    """Batch 2, prompt 40 (80 tokens: a full group of 64 and a padded one;
    above the window of 16, so the ring caches run), 3 greedy decode steps
    (a group of 2 tokens each), float32 caches."""
    jm, jp = _jax_model(arch)
    m = reduced(get_spec(arch)).model
    tp = _carry(jp)
    toks = _tokens(jm.vocab, b=BATCH, t=PROMPT, seed=5)
    max_len = PROMPT + DECODES + 1
    jl, js = jax.jit(lambda p, t: jtfm.prefill(
        p, jm, t, max_len=max_len, dtype=jnp.float32))(jp, jnp.asarray(toks))
    tl, ts = tfm.prefill(tp, m, torch.from_numpy(toks).long(),
                         max_len=max_len, dtype=torch.float32)
    _leaf_close(tl, jl, "prefill logits", False)
    _states_close(ts, js)
    jdecode = jax.jit(lambda p, t, s: jtfm.decode_step(p, jm, t, s))
    for step in range(DECODES):
        jtok = jnp.argmax(jl, axis=-1).astype(jnp.int32)
        ttok = torch.argmax(tl, dim=-1)
        assert ttok.tolist() == np.asarray(jtok).tolist(), step
        jl, js = jdecode(jp, jtok, js)
        tl, ts = tfm.decode_step(tp, m, ttok, ts)
        _leaf_close(tl, jl, f"decode {step} logits", False)
        _states_close(ts, js)


def test_serve_returns_the_jax_serve_tokens(capsys, monkeypatch):
    """Reduced mixtral through JAX's ``launch/serve.py`` (weights from
    ``PRNGKey(0)``, its prompts, greedy) and the port's :func:`serve.serve`
    on the same weights: sequence 0's 8 tokens equal."""
    arch = "mixtral-8x7b"
    want = _jax_serve_ids(arch, capsys, monkeypatch, 0.0)
    jm = jreduced(jget_spec(arch)).model
    m = reduced(get_spec(arch)).model
    tp = _carry(jtfm.init_params(jax.random.PRNGKey(0), jm))
    res = serve.serve(tp, m, serve.prompts_for(m, 2, 48, "cpu"), 8)
    assert res.tokens[0].tolist() == want


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serve_cli_runs_reduced_on_the_cpu(arch, capsys):
    serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--batch",
                "2", "--prompt-len", "20", "--gen", "3"])
    out = capsys.readouterr().out
    assert "prefill done" in out and "generated 3 tokens x 2 seqs" in out


def test_convert_carries_moe_trees_bit_for_bit():
    """An MoE layer's tree (the float32 router, bf16 expert kernels of
    (E, d, d_ff) and (E, d_ff, d)) crosses into the port and back with its
    layout and bits."""
    jm, jc, _ = _moe_cfgs("mixtral-8x7b")
    jp = jax.tree.map(np.asarray, jmoe.moe_init(
        jax.random.PRNGKey(0), jm.d_model, jm.d_ff, jc, jnp.bfloat16))
    tp = convert.params_from_jax(jp, "cpu")
    assert tp["router"]["kernel"].dtype == torch.float32
    e, d, f = jc.n_experts, jm.d_model, jm.d_ff
    for name, shape in (("wi", (e, d, f)), ("wg", (e, d, f)),
                        ("wo", (e, f, d))):
        assert tp[name]["kernel"].dtype == torch.bfloat16
        assert tuple(tp[name]["kernel"].shape) == shape
    back = convert.params_to_numpy(tp)
    for got, want in zip(jax.tree_util.tree_leaves(back),
                         jax.tree_util.tree_leaves(jp)):
        want = want.view(np.uint16) if want.dtype == jnp.bfloat16 else want
        np.testing.assert_array_equal(got, want)


def test_serve_cli_cuts_the_depth():
    """``--layers N`` serves the first N layers; an encoder-decoder has no
    decoder stack to cut."""
    serve.main(["--arch", "llama4-maverick-400b-a17b", "--reduced",
                "--layers", "2", "--device", "cpu", "--batch", "1",
                "--prompt-len", "8", "--gen", "2"])
    with pytest.raises(ValueError, match="encoder-decoder"):
        serve.main(["--arch", "seamless-m4t-large-v2", "--reduced",
                    "--layers", "1", "--device", "cpu"])
