"""The one-card FedComLoc round (``launch/fed_train.py``) against the JAX
package's ``build_fed_round``, on the CPU.

The model is the 1-layer, d_model 64 qwen2-0.5b variant the JAX package's
own fed tests use; the JAX round runs jitted on the (1, 1, 1) ``("pod",
"data", "model")`` mesh of ``tests/test_sharding.py`` (one client);
``tests/test_torch_fed_clients.py`` adds the global and local variants
and two clients.  Both start from the same weights and
tokens and draw the same keys; two rounds each.  Tolerances, float32,
stated before the runs: the loss rtol 1e-5; params and h within 1e-6
(float32 sums in another order; one TopK flip would show as ~0.1);
``comm_bits`` exactly equal, and equal to the closed forms where one
exists (int8: 8 bits a scalar and one float32 scale a tensor, as
``tests/test_launch.py`` holds it).
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
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch import convert, prng  # noqa: E402
from repro_torch import tree as tree_util  # noqa: E402
from repro_torch.configs import get_spec, reduced  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.launch import fed_train  # noqa: E402

LOSS_RTOL = 1e-5
STATE_ATOL = 1e-6
T, ROUNDS = 16, 2
SMALL = dict(n_layers=1, d_model=64, d_ff=128, vocab=64, n_heads=2,
             n_kv_heads=1, head_dim=32)


@pytest.fixture(autouse=True)
def _partitionable_threefry():
    """The port reproduces jax's partitionable threefry stream (the
    default since jax 0.5); pin it whatever the ambient config says."""
    with jax.threefry_partitionable(True):
        yield


def _specs():
    js = jreduced(jget_spec("qwen2-0.5b"))
    js = dataclasses.replace(js, model=dataclasses.replace(js.model, **SMALL))
    ts = reduced(get_spec("qwen2-0.5b"))
    ts = dataclasses.replace(ts, model=dataclasses.replace(ts.model, **SMALL))
    return js, ts


def _tokens(n_clients):
    return np.random.default_rng(0).integers(0, 64, (n_clients, 2, T)).astype(
        np.int32)


def port_rounds(kw, jparams, n_clients):
    _, ts = _specs()
    b = fed_train.build_fed_round(
        ts, InputShape("t", T, 2 * n_clients, "train"),
        fed_train.FedTrainConfig(gamma=0.3, local_steps=2, **kw))
    params = convert.params_from_jax(jax.tree.map(
        lambda x: np.broadcast_to(np.asarray(x), (n_clients,) + x.shape),
        jparams), "cpu")
    h = tree_util.map(torch.zeros_like, params)
    toks = torch.from_numpy(_tokens(n_clients)).long()
    key, out = prng.PRNGKey(1), []
    for _ in range(ROUNDS):
        key, sub = prng.split(key, 2)
        params, h, loss, bits = b.fn(params, h, {"tokens": toks}, sub)
        out.append((float(loss), float(bits)))
    return params, h, out


def jax_rounds(kw, jparams):
    js, _ = _specs()
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1),
                ("pod", "data", "model"))
    shape = dataclasses.replace(JSHAPES["train_4k"], seq_len=T,
                                global_batch=2)
    b = jfed.build_fed_round(js, shape, mesh, jfed.FedTrainConfig(
        gamma=0.3, local_steps=2, **kw))
    stack = lambda t: jax.tree_util.tree_map(lambda x: x[None], t)  # noqa
    ps, hs = stack(jparams), stack(jax.tree_util.tree_map(jnp.zeros_like,
                                                          jparams))
    key, out = jax.random.PRNGKey(1), []
    with mesh:
        step = jax.jit(b.fn, in_shardings=b.in_shardings,
                       out_shardings=b.out_shardings)
        for _ in range(ROUNDS):
            key, sub = jax.random.split(key)
            ps, hs, loss, bits = step(ps, hs,
                                      {"tokens": jnp.asarray(_tokens(1))}, sub)
            out.append((float(loss), float(bits)))
    return ps, hs, out


def match(port, want):
    (tp, th, tout), (jp, jh, jout) = port, want
    for (tl, tb), (jl, jb) in zip(tout, jout):
        np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
        assert tb == jb
    for got, w in zip(tree_util.leaves(tp) + tree_util.leaves(th),
                      jax.tree_util.tree_leaves(jp)
                      + jax.tree_util.tree_leaves(jh)):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=0,
                                   atol=STATE_ATOL)


def init_jax_params():
    js, _ = _specs()
    return jtfm.init_params(jax.random.PRNGKey(0), js.model)


@pytest.fixture(scope="module")
def jparams():
    return init_jax_params()


#: FedComLoc-Com on each uplink; the global and local variants and two
#: clients are in tests/test_torch_fed_clients.py
_CASES = [dict(compressor="topk", density=0.25), dict(compressor="quant"),
          dict(compressor="none"),
          dict(compressor="quant", quant_bits=7, sync_mode="int8")]


@pytest.mark.parametrize("kw", _CASES, ids=lambda kw: "-".join(
    str(v) for v in kw.values()))
def test_fed_round_matches_jax_on_one_client(kw, jparams):
    port = port_rounds(kw, jparams, 1)
    match(port, jax_rounds(kw, jparams))
    n = sum(int(x.numel()) for x in tree_util.leaves(port[0]))
    leaves = len(tree_util.leaves(port[0]))
    closed = {"quant": n * (1 + 8) + leaves * 32, "none": n * 32}
    if kw.get("sync_mode") == "int8":
        closed["quant"] = n * 8 + leaves * 32
    if kw.get("variant", "com") == "com" and kw["compressor"] in closed:
        assert all(bits == closed[kw["compressor"]] for _, bits in port[2])
