"""The baselines in the port (FedAvg, sparseFedAvg, Scaffold, FedDyn)
against the reference, on the MLP (784-16-10, 6 clients, 3 a round) and on
a small CNN (``CNN(3, 10, 16)`` on 16 x 16 crops of FedCIFAR10-like
images), for 3 rounds on both wires, from the same carried weights and
keys.

Bits must be equal; the train loss within rtol 1e-4; the parameters
within rtol 1e-5 / atol 1e-6.  Scaffold's control variates are model
differences divided by K * gamma (option II), so their atol is the
parameters' times 1 / (K * gamma); FedDyn's state is the parameters' own
scale or below.  Also ``tests/test_baselines.py``'s
properties: sparseFedAvg costs fewer uplink bits than FedAvg and Scaffold
twice FedAvg's (model and control variate).
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro import compress as jcomp  # noqa: E402
from repro.core import baselines as jbase  # noqa: E402
from repro.core import fed_data as jfed  # noqa: E402
from repro.models import small as jsmall  # noqa: E402
from repro_torch import compress, convert, prng  # noqa: E402
from repro_torch import tree as tree_util  # noqa: E402
from repro_torch.core import baselines, fed_data  # noqa: E402
from repro_torch.data import dirichlet, synthetic  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import small  # noqa: E402

LOSS_RTOL, PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-5, 1e-6
N_CLIENTS, S, ROUNDS, LOCAL_STEPS, GAMMA = 6, 3, 3, 3, 0.1
COUNTED = ("uplink_bits", "downlink_bits", "client_steps",
           "client_uplink_bits", "client_finish", "sim_time",
           "client_staleness", "clients_aggregated")
ALGORITHMS = {
    "fedavg": (lambda *a, **k: jbase.FedAvg(*a, **k),
               lambda *a, **k: baselines.FedAvg(*a, **k)),
    "fedavg_topk": (
        lambda *a, **k: jbase.FedAvg(*a, compressor=jcomp.TopK(0.3), **k),
        lambda *a, **k: baselines.FedAvg(*a, compressor=compress.TopK(0.3),
                                         **k)),
    "sparse_fedavg": (
        lambda *a, **k: jbase.SparseFedAvg(*a, density=0.1, **k),
        lambda *a, **k: baselines.SparseFedAvg(*a, density=0.1, **k)),
    "scaffold": (jbase.Scaffold, baselines.Scaffold),
    "feddyn": (jbase.FedDyn, baselines.FedDyn),
}


@pytest.fixture(autouse=True)
def _partitionable_threefry():
    with jax.threefry_partitionable(True):
        yield


def _setup(model):
    if model == "mlp":
        ds = synthetic.make_mnist_like(n_train=600, n_test=10)
        jm, tm = jsmall.MLP(784, 16, 10), small.MLP(784, 16, 10)
    else:
        # a small CNN: the 16 x 16 top-left crops of the 32 x 32 images
        ds = synthetic.make_cifar_like(n_train=240, n_test=10)
        ds = dataclasses.replace(
            ds, x_train=np.ascontiguousarray(ds.x_train[:, :16, :16]))
        jm, tm = jsmall.CNN(3, 10, 16), small.CNN(3, 10, 16)
    parts = dirichlet.dirichlet_partition(ds.y_train, n_clients=N_CLIENTS,
                                          alpha=0.7, seed=0)
    with jax.threefry_partitionable(True):
        p0 = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    return {
        "jdata": jfed.from_numpy_partition(ds.x_train, ds.y_train, parts),
        "tdata": fed_data.from_numpy_partition(ds.x_train, ds.y_train, parts,
                                               device="cpu"),
        "jm": jm, "tm": tm, "p0": p0,
    }


SETUPS = {}


def setup_of(model):
    if model not in SETUPS:
        SETUPS[model] = _setup(model)
    return SETUPS[model]


def _config(cls):
    return cls(gamma=GAMMA, local_steps=LOCAL_STEPS, n_clients=N_CLIENTS,
               clients_per_round=S, batch_size=8)


def _run_pair(model, name, wire):
    st = setup_of(model)
    jmake, tmake = ALGORITHMS[name]
    ja = jmake(jsmall.cross_entropy_loss(st["jm"].apply), st["jdata"],
               _config(jbase.FedConfig), wire=wire)
    ta = tmake(small.cross_entropy_loss(st["tm"].apply), st["tdata"],
               _config(baselines.FedConfig), wire=wire)
    js, jm = ja.run_rounds(ja.init(jax.tree.map(jax.numpy.asarray, st["p0"])),
                           jax.random.PRNGKey(1), ROUNDS)
    ts, tm = ta.run_rounds(ta.init(convert.params_from_jax(st["p0"], "cpu")),
                           prng.PRNGKey(1), ROUNDS)
    return ja, js, jm, ta, ts, tm


@pytest.mark.parametrize("wire", ["account", "packed"])
@pytest.mark.parametrize("name", list(ALGORITHMS))
@pytest.mark.parametrize("model", ["mlp", "cnn"])
def test_rounds_match_reference(model, name, wire):
    ja, js, jm, ta, ts, tm = _run_pair(model, name, wire)
    assert sorted(tm) == sorted(jm)
    for key in COUNTED + (("uplink_payload_bytes", "client_payload_bytes")
                          if wire == "packed" else ()):
        np.testing.assert_array_equal(np.asarray(tm[key], np.float64),
                                      np.asarray(jm[key], np.float64),
                                      err_msg=key)
    np.testing.assert_allclose(tm["train_loss"], jm["train_loss"],
                               rtol=LOSS_RTOL)
    assert jm["train_loss"][-1] < jm["train_loss"][0]     # it trains
    assert ta.meter.snapshot() == ja.meter.snapshot()
    trees = [(js.x, ts.x, PARAM_ATOL)]
    if name == "scaffold":
        cv_atol = PARAM_ATOL / (LOCAL_STEPS * GAMMA)
        trees += [(js.c, ts.c, cv_atol), (js.ci, ts.ci, cv_atol)]
    if name == "feddyn":
        trees += [(js.h, ts.h, PARAM_ATOL), (js.grads, ts.grads, PARAM_ATOL)]
    for jtree, ttree, atol in trees:
        for a, b in zip(jax.tree.leaves(jtree),
                        tree_util.leaves(convert.params_to_numpy(ttree))):
            np.testing.assert_allclose(b, np.asarray(a), rtol=PARAM_RTOL,
                                       atol=atol)


def test_bits_properties():
    """sparseFedAvg's TopK uplink costs fewer bits than FedAvg's dense one;
    Scaffold ships model and control variate, twice FedAvg's."""
    bits = {}
    for name in ("fedavg", "sparse_fedavg", "scaffold", "feddyn"):
        st = setup_of("mlp")
        alg = ALGORITHMS[name][1](small.cross_entropy_loss(st["tm"].apply),
                                  st["tdata"], _config(baselines.FedConfig))
        alg.run_rounds(alg.init(convert.params_from_jax(st["p0"], "cpu")),
                       prng.PRNGKey(1), 2)
        bits[name] = alg.meter.uplink_bits
    assert bits["sparse_fedavg"] < bits["fedavg"]
    assert bits["scaffold"] == 2 * bits["fedavg"]
    assert bits["feddyn"] == bits["fedavg"]


def test_cpu_baselines_launch_nothing():
    st = setup_of("mlp")
    ops.reset_launch_counts()
    alg = baselines.SparseFedAvg(small.cross_entropy_loss(st["tm"].apply),
                                 st["tdata"], _config(baselines.FedConfig),
                                 wire="packed")
    alg.run_rounds(alg.init(convert.params_from_jax(st["p0"], "cpu")),
                   prng.PRNGKey(0), 1)
    assert all(v == 0 for v in ops.launch_counts().values())


@pytest.mark.parametrize("make", [
    lambda d: baselines.FedAvg(None, d, _config(baselines.FedConfig),
                               downlink="account"),
    lambda d: baselines.Scaffold(None, d, _config(baselines.FedConfig),
                                 store=object())],
    ids=["compressed_downlink", "client_store"])
def test_unported_options_raise(make):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        make(setup_of("mlp")["tdata"])


def test_config_validation():
    with pytest.raises(ValueError):
        baselines.FedConfig(local_steps=0)
    with pytest.raises(ValueError):
        baselines.FedConfig(n_clients=4, clients_per_round=5)
