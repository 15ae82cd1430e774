"""Training's pieces in the port against the JAX package, on the CPU: the
two scans' backward, the flash route's backward, the optimizers and the
train launcher.

Inputs come from numpy seeds and cross to both packages.  Tolerances,
float32, stated before the runs:

* the scans' gradients against ``jax.vjp`` of the JAX ``ref`` scans:
  rtol = atol = 1e-5 (float32 sums in another order; the rglru backward
  takes jax.vjp's operations one by one, so its inf and NaN at a = 1 fall
  where JAX's do);
* ``torch.autograd.gradcheck`` in float64 at its default tolerances;
* attention gradients against ``jax.vjp`` of the JAX
  ``chunked_attention``: rtol = atol = 2e-5 (chunked float32 products in
  another order);
* optimizers over 3 updates: float32 leaves rtol = atol = 1e-6 (one
  float32 rounding of the update), bfloat16 leaves within one bf16
  rounding (rtol 2^-7).
"""

import re

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # xdist workers share the cores: no spinning OpenMP pools

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.optim import optimizers as joptim  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import tree as tree_util  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.optim import optimizers  # noqa: E402

SCAN_TOL = 1e-5
ATTN_TOL = 2e-5
OPT_TOL = 1e-6
BF16_ROUND = 2 ** -7


def _randn(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _uniform(seed, *shape):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


# --------------------------------------------------------------------------- #
# the scans' backward
# --------------------------------------------------------------------------- #

def test_rglru_scan_bwd_matches_jax_vjp_with_edges():
    """T = 23 (not a multiple of the reference's 64-step chunk); a held at
    1e-7, 1 - 1e-7 and exactly 1 (1 - a^2 on max's tie: -inf and NaN
    where JAX has them); the autograd Function gives the same."""
    x = _randn(1, 2, 23, 16)
    a = _uniform(2, 2, 23, 16)
    a[0, :, 0] = 1e-7
    a[0, :, 1] = 1.0 - 1e-7
    a[1, :, 2] = 1.0
    x[1, :5, 2] = 0.0                              # 0 * inf: NaN
    dy = _randn(3, 2, 23, 16)
    (y, h), vjp = jax.vjp(jref.rglru_scan, jnp.asarray(x), jnp.asarray(a))
    jdx, jda = vjp((jnp.asarray(dy), jnp.zeros_like(h)))
    ty, _ = ref.rglru_scan(_t(x), _t(a))
    dx, da = ref.rglru_scan_bwd(_t(x), _t(a), ty, _t(dy))
    _close(dx, jdx, SCAN_TOL)
    _close(da, jda, SCAN_TOL)
    assert np.isnan(np.asarray(jda)).any() and np.isinf(np.asarray(jda)).any()
    tx, ta = _t(x).requires_grad_(), _t(a).requires_grad_()
    (ty2, _), = [ops.rglru_scan(tx, ta)]
    fx, fa = torch.autograd.grad(ty2, (tx, ta), _t(dy))
    assert torch.equal(fx, dx)
    assert torch.equal(torch.nan_to_num(fa), torch.nan_to_num(da))


def test_wkv6_scan_bwd_matches_jax_vjp_with_edges():
    """T = 21 against chunks of 8 (a ragged last chunk of the recompute);
    w held at 1e-7 and 1 - 1e-7 on whole heads; the autograd Function on
    ``rwkv6._heads``-style strided views gives the same."""
    b, h, t, k = 2, 3, 21, 8
    r, kk, v = (_randn(s, b, h, t, k, scale=0.5) for s in (4, 5, 6))
    w = _uniform(7, b, h, t, k)
    w[0, 0] = 1e-7
    w[0, 1] = 1.0 - 1e-7
    u = _randn(8, h, k, scale=0.1)
    dy = _randn(9, b, h, t, k)
    (y, s), vjp = jax.vjp(jref.wkv6_scan,
                          *(jnp.asarray(z) for z in (r, kk, v, w, u)))
    want = vjp((jnp.asarray(dy), jnp.zeros_like(s)))
    got = ref.wkv6_scan_bwd(*(_t(z) for z in (r, kk, v, w, u, dy)), chunk=8)
    for g_, w_ in zip(got, want):
        _close(g_, w_, SCAN_TOL)

    def heads(z):           # (B, T, H*K) activations seen as (B, H, T, K)
        z = np.ascontiguousarray(z.transpose(0, 2, 1, 3)).reshape(b, t, h * k)
        return _t(z).reshape(b, t, h, k).transpose(1, 2).requires_grad_()

    ins = [heads(z) for z in (r, kk, v, w)] + [_t(u).requires_grad_()]
    yt, _ = ops.wkv6_scan(*ins)
    for g_, w_ in zip(torch.autograd.grad(yt, ins, _t(dy)), want):
        _close(g_, w_, SCAN_TOL)


def test_scan_functions_pass_gradcheck_in_float64():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 9, 5, dtype=torch.float64, generator=gen)
    a = 0.05 + 0.9 * torch.rand(2, 9, 5, dtype=torch.float64, generator=gen)
    assert torch.autograd.gradcheck(
        lambda x_, a_: ops.rglru_scan(x_, a_)[0],
        (x.requires_grad_(), a.requires_grad_()))
    r, k, v = (0.5 * torch.randn(1, 2, 5, 64, dtype=torch.float64,
                                 generator=gen) for _ in range(3))
    w = 0.05 + 0.9 * torch.rand(1, 2, 5, 64, dtype=torch.float64, generator=gen)
    u = 0.1 * torch.randn(2, 64, dtype=torch.float64, generator=gen)
    assert torch.autograd.gradcheck(
        lambda *z: ops.wkv6_scan(*z)[0],
        tuple(z.requires_grad_() for z in (r, k, v, w, u)), fast_mode=True)


def test_scans_save_nothing_without_grad():
    """Serving runs the scans as before: no graph where nothing needs a
    gradient."""
    x, a = torch.randn(1, 4, 8), torch.rand(1, 4, 8)
    y, _ = ops.rglru_scan(x.requires_grad_(), a)
    assert y.grad_fn is not None
    with torch.no_grad():
        y, h = ops.rglru_scan(x, a)
    assert y.grad_fn is None and not h.requires_grad


# --------------------------------------------------------------------------- #
# the flash route's backward
# --------------------------------------------------------------------------- #

_ATTN_CASES = [
    (dict(causal=True), 2, 16),                    # GQA 2:1
    # GQA 4:1, a ragged T (end padding), the window and the softcap
    (dict(causal=True, window=5, softcap=3.0), 1, 20),
    (dict(causal=False), 4, 16),                   # no mask, MHA
]


@pytest.mark.parametrize("kw,hkv,t", _ATTN_CASES)
def test_chunked_attention_gradients_match_jax(kw, hkv, t):
    q = _randn(10, 2, 4, t, 16)
    k, v = _randn(11, 2, hkv, t, 16), _randn(12, 2, hkv, t, 16)
    dout = _randn(13, 2, 4, t, 16)
    out, vjp = jax.vjp(lambda *z: jattn.chunked_attention(*z, chunk=8, **kw),
                       *(jnp.asarray(z) for z in (q, k, v)))
    want = vjp(jnp.asarray(dout))
    ins = [_t(z).requires_grad_() for z in (q, k, v)]
    got_out = attn.chunked_attention(*ins, chunk=8, **kw)
    _close(got_out, out, ATTN_TOL)
    for g_, w_ in zip(torch.autograd.grad(got_out, ins, _t(dout)), want):
        _close(g_, w_, ATTN_TOL)


# --------------------------------------------------------------------------- #
# optimizers
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("name", ["sgd", "momentum", "adam"])
def test_optimizers_match_jax_over_three_updates(name):
    params = {"w": _randn(20, 6, 5), "b": _randn(21, 5),
              "h": {"e": _randn(22, 7, 3)}}
    jparams = jax.tree.map(jnp.asarray, params)
    jparams["h"]["e"] = jparams["h"]["e"].astype(jnp.bfloat16)
    init, update = joptim.make(name, 0.05)
    tinit, tupdate = optimizers.make(name, 0.05)
    state = init(jparams)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    tstate = convert.params_from_jax(jax.tree.map(np.asarray, state), "cpu")
    for step in range(3):
        grads = {"w": _randn(30 + step, 6, 5), "b": _randn(40 + step, 5),
                 "h": {"e": _randn(50 + step, 7, 3)}}
        jg = jax.tree.map(jnp.asarray, grads)
        jg["h"]["e"] = jg["h"]["e"].astype(jnp.bfloat16)
        jparams, state = update(jg, state, jparams)
        tg = convert.params_from_jax(jax.tree.map(np.asarray, jg), "cpu")
        with torch.no_grad():
            tp, tstate = tupdate(tg, tstate, tp)
    for got, want in zip(tree_util.leaves(tp) + tree_util.leaves(tstate),
                         jax.tree_util.tree_leaves((jparams, state))):
        assert str(got.dtype).split(".")[-1] == str(want.dtype), (got, want)
        tol = BF16_ROUND if want.dtype == jnp.bfloat16 else OPT_TOL
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=tol, atol=OPT_TOL)


# --------------------------------------------------------------------------- #
# the launcher
# --------------------------------------------------------------------------- #

def test_train_cli_runs_reduced_on_the_cpu(capsys):
    """The reference's flags and log line; the loss falls."""
    train.main(["--arch", "recurrentgemma-2b", "--reduced", "--steps", "3",
                "--batch", "2", "--seq", "16", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == "done"
    losses = [float(re.match(r"step +(\d+)  loss (\S+)  \(\S+s\)$", ln)
                    .group(2)) for ln in out[:-1]]
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
