"""Training the MoE family on the port against the JAX package, on the
CPU: ``steps.build_train_step`` on the reduced mixtral-8x7b (Adam 1e-4)
and llama4-maverick-400b-a17b (SGD 1e-3, the reference's choice for the
400B model) over 3 steps against the JAX ``build_train_step`` on a
one-device host mesh, and one FedComLoc round of a small mixtral with a
Q_r(8) uplink against the JAX ``build_fed_round``.

Both packages start from the same weights (the port's seeded init for
the train steps, the JAX package's for the round, carried with
``convert``) and the same numpy tokens; each JAX step is compiled once.
Tolerances, float32, stated before the runs, are those of
``tests/test_torch_train_loss.py`` (train steps: the loss rtol 1e-5,
optimizer state and parameters within 1e-5 + rtol 1e-4 but for at most
0.1% of a leaf's entries, all within 3 lr) and
``tests/test_torch_fed_train.py`` (the round: the loss rtol 1e-5, params
and control variates within 1e-6, ``comm_bits`` equal to JAX's and to the
closed form of 9 bits a scalar and 32 a tensor).

The round's model is the fed tests' one-layer width (d_model 64, d_ff 128,
vocab 64) with the reduced MoE settings (4 experts, top-2, groups of 64,
capacity factor 2.0) on its one layer: its MoE leaves (the float32 router
and the three expert kernels) each go through K3's and K4's plain
versions.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # xdist workers share the cores: no spinning OpenMP pools

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro.configs import get_spec as jget_spec  # noqa: E402
from repro.configs.base import SHAPES as JSHAPES  # noqa: E402
from repro.configs.base import reduced as jreduced  # noqa: E402
from repro.launch import fed_train as jfed  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch import convert, prng  # noqa: E402
from repro_torch import tree as tree_util  # noqa: E402
from repro_torch.configs import get_spec, reduced  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.launch import fed_train, steps  # noqa: E402
from tests.test_torch_train_loss import (  # noqa: E402
    CHUNK, LOSS_RTOL, LR, NOISE_SHARE, STEP_ATOL, STEP_RTOL, T, _jax_model,
    _tokens)

STATE_ATOL = 1e-6
SMALL = dict(n_layers=1, d_model=64, d_ff=128, vocab=64, n_heads=2,
             n_kv_heads=1, head_dim=32)
FED_T, ROUNDS = 16, 2


@pytest.fixture(autouse=True)
def _partitionable_threefry():
    with jax.threefry_partitionable(True):
        yield


def _carry(tree):
    return convert.params_from_jax(jax.tree.map(np.asarray, tree), "cpu")


@pytest.mark.parametrize("arch", ["mixtral-8x7b",
                                  "llama4-maverick-400b-a17b"])
def test_train_step_matches_jax_over_three_steps(arch):
    jspec = jreduced(jget_spec(arch))
    tspec = reduced(get_spec(arch))
    opt, lr = jsteps._optimizer_for(jspec)
    assert (opt, lr) == steps._optimizer_for(tspec)
    assert (opt, lr) == (("sgd", 1e-3) if arch.startswith("llama4")
                         else ("adam", LR))
    jm, jp = _jax_model(arch)
    shape = dataclasses.replace(jsteps.SHAPES["train_4k"], seq_len=T,
                                global_batch=2)
    jb = jsteps.build_train_step(jspec, shape, make_host_mesh(),
                                 loss_chunk=CHUNK)
    jstate = jsteps.optimizers.make(opt, lr)[0](jp)
    tb = steps.build_train_step(tspec, InputShape("t", T, 2, "train"),
                                loss_chunk=CHUNK)
    tp, tstate = _carry(jp), _carry(jstate)
    step = jax.jit(jb.fn)
    for i in range(3):
        toks = _tokens(jm.vocab, seed=10 + i)
        jp, jstate, jl = step(jp, jstate, {"tokens": jnp.asarray(toks)})
        tp, tstate, tl = tb.fn(tp, tstate,
                               {"tokens": torch.from_numpy(toks).long()})
        np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    for got, want in zip(tree_util.leaves(tstate),
                         jax.tree_util.tree_leaves(jstate)):
        want = np.asarray(want)
        np.testing.assert_allclose(
            got.numpy(), want, rtol=STEP_RTOL,
            atol=STEP_ATOL * max(1.0, float(np.abs(want).max())))
    for got, want in zip(tree_util.leaves(tp), jax.tree_util.tree_leaves(jp)):
        d = np.abs(got.numpy() - np.asarray(want))
        off = d > STEP_ATOL + STEP_RTOL * np.abs(np.asarray(want))
        assert off.mean() <= NOISE_SHARE and d.max() <= 3 * lr, (
            off.sum(), d.max())


def _fed_specs():
    js = jreduced(jget_spec("mixtral-8x7b"))
    js = dataclasses.replace(js, model=dataclasses.replace(js.model, **SMALL))
    ts = reduced(get_spec("mixtral-8x7b"))
    ts = dataclasses.replace(ts, model=dataclasses.replace(ts.model, **SMALL))
    return js, ts


def test_quant_fed_round_matches_jax():
    """Two rounds of one client, 2 local steps, gamma 0.3, Q_r(8)."""
    js, ts = _fed_specs()
    fed_kw = dict(gamma=0.3, local_steps=2, compressor="quant", quant_bits=8)
    jparams = jtfm.init_params(jax.random.PRNGKey(0), js.model)
    toks = np.random.default_rng(0).integers(0, 64, (1, 2, FED_T)).astype(
        np.int32)

    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1),
                ("pod", "data", "model"))
    jb = jfed.build_fed_round(js, dataclasses.replace(
        JSHAPES["train_4k"], seq_len=FED_T, global_batch=2), mesh,
        jfed.FedTrainConfig(**fed_kw))
    ps = jax.tree_util.tree_map(lambda x: x[None], jparams)
    hs = jax.tree_util.tree_map(jnp.zeros_like, ps)
    key, jout = jax.random.PRNGKey(1), []
    with mesh:
        jstep = jax.jit(jb.fn, in_shardings=jb.in_shardings,
                        out_shardings=jb.out_shardings)
        for _ in range(ROUNDS):
            key, sub = jax.random.split(key)
            ps, hs, loss, bits = jstep(ps, hs, {"tokens": jnp.asarray(toks)},
                                       sub)
            jout.append((float(loss), float(bits)))

    tb = fed_train.build_fed_round(ts, InputShape("t", FED_T, 2, "train"),
                                   fed_train.FedTrainConfig(**fed_kw))
    params = _carry(jax.tree_util.tree_map(lambda x: x[None], jparams))
    assert "moe" in params["layers"]["layer_0"]
    h = tree_util.map(torch.zeros_like, params)
    key, tout = prng.PRNGKey(1), []
    for _ in range(ROUNDS):
        key, sub = prng.split(key, 2)
        params, h, loss, bits = tb.fn(params, h,
                                      {"tokens": torch.from_numpy(toks).long()},
                                      sub)
        tout.append((float(loss), float(bits)))

    leaves = tree_util.leaves(params)
    n = sum(int(x.numel()) for x in leaves)
    for (tl, tbits), (jl, jbits) in zip(tout, jout):
        np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
        assert tbits == jbits == n * (1 + 8) + len(leaves) * 32
    for got, want in zip(leaves + tree_util.leaves(h),
                         jax.tree_util.tree_leaves(ps)
                         + jax.tree_util.tree_leaves(hs)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=STATE_ATOL)
