"""LoCoDL in the port: ``TestLoCoDL`` of ``tests/test_downlink.py`` on the
port alone, and a small MLP whose loss falls, held to the JAX package's
first rounds.

* Identity links, ``lam = 1``, full participation: every client lands on
  the shared model, which is Scaffnew's cohort mean of the local iterates.
* One 5-way key split in every downlink mode: cohorts, steps and uplink
  bits do not move when the downlink codec does.
* ``downlink="account"`` with ``Identity()`` equals the dense downlink,
  values and bits.
* ``run_rounds`` equals ``round`` called R times, under each policy.
* A policy-excluded straggler keeps its iterate and control variate.
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # xdist workers share the cores: no spinning OpenMP pools

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro import compress as jcomp  # noqa: E402
from repro.core import fed_data as jfed  # noqa: E402
from repro.core.locodl import LoCoDL as JLoCoDL  # noqa: E402
from repro.core.locodl import LoCoDLConfig as JConfig  # noqa: E402
from repro.models import small as jsmall  # noqa: E402
from repro_torch import compress, convert, prng  # noqa: E402
from repro_torch import tree as tree_util  # noqa: E402
from repro_torch.core import fed_data  # noqa: E402
from repro_torch.core.aggregation import AggregationPolicy  # noqa: E402
from repro_torch.core.clients import ClientProfile, ClientSchedule  # noqa: E402
from repro_torch.core.locodl import LoCoDL, LoCoDLConfig  # noqa: E402
from repro_torch.data import dirichlet, synthetic  # noqa: E402
from repro_torch.models import small  # noqa: E402
from tests import test_torch_downlink as tdl  # noqa: E402


@pytest.fixture(autouse=True)
def _partitionable_threefry():
    """The port reproduces jax's partitionable threefry stream (the
    default since jax 0.5); pin it whatever the ambient config says."""
    with jax.threefry_partitionable(True):
        yield


N, D, S, R = tdl.N, tdl.D, tdl.S, tdl.R
DROP_SCHED = ClientSchedule(
    profile=ClientProfile.lognormal(N, speed_sigma=1.0, seed=3),
    deadline=3.0, drop_stragglers=True)


def test_collapses_to_scaffnew_mean():
    cfg = LoCoDLConfig(gamma=0.05, p=0.25, lam=1.0, n_clients=N,
                       clients_per_round=N, batch_size=4)
    alg = LoCoDL(tdl.tp.sq_loss, tdl.DATA, cfg, compress.Identity())
    st, _ = alg.round(alg.init({"w": torch.zeros(D)}), prng.PRNGKey(3))
    np.testing.assert_allclose(st.xs["w"].numpy(),
                               st.x["w"].numpy()[None].repeat(N, 0),
                               rtol=1e-6, atol=1e-7)


def test_uplink_chain_invariant_across_downlink_modes():
    runs = {dl: tdl.run(tdl.build("locodl", downlink=dl,
                                  down_comp=None if dl == "dense"
                                  else compress.QuantQr(4)))
            for dl in ("dense", "account", "packed")}
    for dl in ("account", "packed"):
        for k in ("client_uplink_bits", "client_steps", "uplink_bits"):
            np.testing.assert_array_equal(runs["dense"][1][k], runs[dl][1][k],
                                          err_msg=k)


def test_dense_equals_identity_account():
    wd, md = tdl.run(tdl.build("locodl"))
    wi, mi = tdl.run(tdl.build("locodl", downlink="account",
                               down_comp=compress.Identity()))
    np.testing.assert_array_equal(wd, wi)
    np.testing.assert_array_equal(md["downlink_bits"], mi["downlink_bits"])


@pytest.mark.parametrize("policy,sched", [
    (None, None), (AggregationPolicy.semi_sync(2), DROP_SCHED),
    (AggregationPolicy.async_buffered(2, 0.5), DROP_SCHED)],
    ids=["sync", "semi_sync", "async_buffered"])
def test_run_rounds_matches_per_round(policy, sched):
    alg = tdl.build("locodl", downlink="packed",
                    down_comp=compress.QuantQr(4), policy=policy,
                    schedule=sched)
    st_f, _ = alg.run_rounds(alg.init({"w": torch.zeros(D)}),
                             prng.PRNGKey(7), R)
    st_l, key = alg.init({"w": torch.zeros(D)}), prng.PRNGKey(7)
    for _ in range(R):
        key, sub = prng.split(key, 2)
        st_l, _ = alg.round(st_l, sub)
    np.testing.assert_array_equal(st_f.x["w"].numpy(), st_l.x["w"].numpy())


def test_excluded_clients_keep_state():
    alg = tdl.build("locodl", policy=AggregationPolicy.semi_sync(1),
                    schedule=DROP_SCHED)
    st0 = alg.init({"w": torch.zeros(D)})
    st1, m = alg.round(st0, prng.PRNGKey(11))
    agg = float(m["clients_aggregated"])
    assert agg <= S
    changed_x = (st1.xs["w"] != st0.xs["w"]).any(1)
    changed_h = (st1.h["w"] != st0.h["w"]).any(1)
    assert int(changed_x.sum()) <= agg
    assert int(changed_h.sum()) <= agg


N_MLP, S_MLP, HIDDEN = 6, 3, 16


@pytest.fixture(scope="module")
def mlp():
    ds = synthetic.make_mnist_like(n_train=600, n_test=100)
    parts = dirichlet.dirichlet_partition(ds.y_train, n_clients=N_MLP,
                                          alpha=0.7, seed=0)
    jm, tm = jsmall.MLP(784, HIDDEN, 10), small.MLP(784, HIDDEN, 10)
    return {"jdata": jfed.from_numpy_partition(ds.x_train, ds.y_train, parts),
            "tdata": fed_data.from_numpy_partition(ds.x_train, ds.y_train,
                                                   parts, device="cpu"),
            "jm": jm, "tm": tm,
            "p0": jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))}


def test_loss_decreases_on_a_small_mlp(mlp):
    """Bidirectional Q_r(8) on a 784-16-10 MLP: the first rounds equal the
    JAX package's (bits exact, loss within rtol 1e-4, params within atol
    1e-5, as ``tests/test_torch_fedcomloc.py`` holds FedComLoc), and the
    loss of the last rounds is below half that of the first."""
    cfg = dict(gamma=0.1, p=0.25, lam=0.9, n_clients=N_MLP,
               clients_per_round=S_MLP, batch_size=8)
    ja = JLoCoDL(jsmall.cross_entropy_loss(mlp["jm"].apply), mlp["jdata"],
                 JConfig(**cfg), jcomp.QuantQr(8), downlink="account",
                 downlink_compressor=jcomp.QuantQr(8))
    ta = LoCoDL(small.cross_entropy_loss(mlp["tm"].apply), mlp["tdata"],
                LoCoDLConfig(**cfg), compress.QuantQr(8), downlink="account",
                downlink_compressor=compress.QuantQr(8))
    js, jm = ja.run_rounds(ja.init(jax.tree.map(jax.numpy.asarray, mlp["p0"])),
                           jax.random.PRNGKey(1), 2)
    ts = ta.init(convert.params_from_jax(mlp["p0"], "cpu"))
    ts, tm = ta.run_rounds(ts, prng.PRNGKey(1), 2)
    for name in ("uplink_bits", "downlink_bits", "client_steps"):
        np.testing.assert_array_equal(tm[name], np.asarray(jm[name]),
                                      err_msg=name)
    np.testing.assert_allclose(tm["train_loss"], np.asarray(jm["train_loss"]),
                               rtol=1e-4, atol=1e-6)
    for a, b in zip(jax.tree.leaves(js.x), tree_util.leaves(ts.x)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-5)
    key, losses = prng.PRNGKey(2), []
    for _ in range(20):
        key, sub = prng.split(key, 2)
        ts, m = ta.round(ts, sub)
        losses.append(m["train_loss"])
    assert np.mean(losses[-5:]) < 0.5 * np.mean(tm["train_loss"])
