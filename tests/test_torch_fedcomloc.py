"""The port's slice as a whole: FedComLoc rounds and ``run_federated``
against the reference, from the same carried weights and keys.

Counting metrics (cohorts, steps, bits) must be equal; the train loss
agrees within rtol 1e-4 and the parameters within atol 1e-5 (float32
matmuls and sums run in other orders in XLA and torch).  At these sizes no
Q_r coordinate rounds to a neighbouring level under an ulp-different norm,
so the parameter tolerance needs no allowance for one.
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # xdist workers share the cores: no spinning OpenMP pools

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro import compress as jcomp  # noqa: E402
from repro.core import fed_data as jfed  # noqa: E402
from repro.core import server as jserver  # noqa: E402
from repro.core.fedcomloc import FedComLoc as JFedComLoc  # noqa: E402
from repro.core.fedcomloc import FedComLocConfig as JConfig  # noqa: E402
from repro.models import small as jsmall  # noqa: E402
from repro_torch import compress, convert, prng  # noqa: E402
from repro_torch import tree as tree_util  # noqa: E402
from repro_torch.core import aggregation, clients, fed_data, server  # noqa: E402
from repro_torch.core.fedcomloc import FedComLoc, FedComLocConfig  # noqa: E402
from repro_torch.data import dirichlet, synthetic  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import small  # noqa: E402


@pytest.fixture(autouse=True)
def _partitionable_threefry():
    """The port reproduces jax's partitionable threefry stream (the
    default since jax 0.5); pin it whatever the ambient config says."""
    with jax.threefry_partitionable(True):
        yield


LOSS_RTOL, LOSS_ATOL, PARAM_ATOL = 1e-4, 1e-6, 1e-5
HIDDEN, N_CLIENTS, S, BATCH, P, ROUNDS = 16, 6, 3, 8, 0.25, 3
COUNTED = ("num_local_steps", "uplink_bits", "downlink_bits", "client_steps",
           "client_uplink_bits", "client_finish", "sim_time",
           "client_staleness", "clients_aggregated")

COMPRESSORS = {
    "topk": (lambda: jcomp.TopK(0.3), lambda: compress.TopK(0.3)),
    "qr": (lambda: jcomp.QuantQr(8), lambda: compress.QuantQr(8)),
    "qr4": (lambda: jcomp.QuantQr(4), lambda: compress.QuantQr(4)),
    "id": (jcomp.Identity, compress.Identity),
}


@pytest.fixture(scope="module")
def setup():
    ds = synthetic.make_mnist_like(n_train=600, n_test=600)
    parts = dirichlet.dirichlet_partition(ds.y_train, n_clients=N_CLIENTS,
                                          alpha=0.7, seed=0)
    jm, tm = jsmall.MLP(784, HIDDEN, 10), small.MLP(784, HIDDEN, 10)
    return {
        "ds": ds,
        "jdata": jfed.from_numpy_partition(ds.x_train, ds.y_train, parts),
        "tdata": fed_data.from_numpy_partition(ds.x_train, ds.y_train, parts,
                                               device="cpu"),
        "jm": jm, "tm": tm,
        "p0": jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0))),
    }


def _config(cls, variant):
    return cls(gamma=0.1, p=P, n_clients=N_CLIENTS, clients_per_round=S,
               batch_size=BATCH, variant=variant)


def _pair(setup, variant, comp):
    jc, tc = COMPRESSORS[comp]
    ja = JFedComLoc(jsmall.cross_entropy_loss(setup["jm"].apply),
                    setup["jdata"], _config(JConfig, variant), jc())
    ta = FedComLoc(small.cross_entropy_loss(setup["tm"].apply), setup["tdata"],
                   _config(FedComLocConfig, variant), tc())
    return ja, ta


def _assert_tree_close(jtree, ttree):
    for a, b in zip(jax.tree.leaves(jtree),
                    tree_util.leaves(convert.params_to_numpy(ttree))):
        np.testing.assert_allclose(b, np.asarray(a), rtol=0, atol=PARAM_ATOL)


def _assert_metrics(jm, tm):
    assert set(jm) == set(tm)
    for name in COUNTED:
        np.testing.assert_array_equal(np.asarray(tm[name]),
                                      np.asarray(jm[name]), err_msg=name)
    np.testing.assert_allclose(tm["train_loss"], jm["train_loss"],
                               rtol=LOSS_RTOL, atol=LOSS_ATOL)


@pytest.mark.parametrize("variant,comp", [
    ("com", "topk"), ("com", "qr"), ("none", "id"), ("local", "topk"),
    ("local", "qr4"), ("global", "qr"), ("global", "topk")])
def test_rounds_match_reference(setup, variant, comp):
    ja, ta = _pair(setup, variant, comp)
    js = ja.init(jax.tree.map(jax.numpy.asarray, setup["p0"]))
    ts = ta.init(convert.params_from_jax(setup["p0"], "cpu"))
    jkey, tkey = jax.random.PRNGKey(1), prng.PRNGKey(1)
    for _ in range(ROUNDS):
        jkey, jsub = jax.random.split(jkey)
        tkey, tsub = prng.split(tkey, 2)
        # the round's cohort, drawn by both packages from the round key
        jc, _ = ja.sched.sample_cohort(jax.random.split(jsub, 5)[0], S)
        tc, _ = ta.sched.sample_cohort(prng.split(tsub, 5)[0], S)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        js, jmet = ja.round(js, jsub)
        ts, tmet = ta.round(ts, tsub)
        _assert_metrics(jmet, tmet)
        _assert_tree_close(js.x, ts.x)
        _assert_tree_close(js.h, ts.h)
    assert ja.meter.snapshot() == ta.meter.snapshot()


@pytest.mark.parametrize("comp", ["topk", "qr"])
def test_run_federated_matches_reference(setup, comp):
    """Evaluation after rounds 1, 3 and 4, on whole batches only (600
    test samples: one batch of 512, the remainder dropped)."""
    ja, ta = _pair(setup, "com", comp)
    ds = setup["ds"]
    jeval = jserver.make_eval_fn(setup["jm"].apply, jax.numpy.asarray(ds.x_test),
                                 jax.numpy.asarray(ds.y_test))
    teval = server.make_eval_fn(setup["tm"].apply, torch.from_numpy(ds.x_test),
                                torch.from_numpy(ds.y_test))
    jh = jserver.run_federated(ja, jax.tree.map(jax.numpy.asarray, setup["p0"]),
                               4, jax.random.PRNGKey(1), jeval, eval_every=2)
    th = server.run_federated(ta, convert.params_from_jax(setup["p0"], "cpu"),
                              4, prng.PRNGKey(1), teval, eval_every=2)
    assert th.rounds == jh.rounds == [1, 3, 4]
    for name in ("uplink_bits", "downlink_bits", "total_bits", "sim_time"):
        assert getattr(th, name) == getattr(jh, name), name
    np.testing.assert_allclose(th.train_loss, jh.train_loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(th.test_loss, jh.test_loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(th.test_acc, jh.test_acc, atol=2 / 512)
    _assert_tree_close(jh.final_params, th.final_params)


def test_run_rounds_equals_round_loop(setup):
    _, ta = _pair(setup, "com", "qr")
    _, tb = _pair(setup, "com", "qr")
    p0 = convert.params_from_jax(setup["p0"], "cpu")
    sa, chunk = ta.run_rounds(ta.init(p0), prng.PRNGKey(3), ROUNDS)
    sb, key, rows = tb.init(p0), prng.PRNGKey(3), []
    for _ in range(ROUNDS):
        key, sub = prng.split(key, 2)
        sb, m = tb.round(sb, sub)
        rows.append(m)
    for name, stacked in chunk.items():
        assert stacked.shape[0] == ROUNDS
        np.testing.assert_array_equal(
            stacked, np.stack([np.asarray(m[name]) for m in rows]), err_msg=name)
    for a, b in zip(tree_util.leaves(sa.x) + tree_util.leaves(sa.h),
                    tree_util.leaves(sb.x) + tree_util.leaves(sb.h)):
        assert torch.equal(a, b)
    assert ta.meter.snapshot() == tb.meter.snapshot()


def test_cpu_run_leaves_every_launch_counter_at_zero(setup):
    ops.reset_launch_counts()
    for comp in ("topk", "qr"):
        _, ta = _pair(setup, "com", comp)
        ta.run_rounds(ta.init(convert.params_from_jax(setup["p0"], "cpu")),
                      prng.PRNGKey(0), 2)
    counts = ops.launch_counts()
    assert len(counts) == 19 and all(v == 0 for v in counts.values()), counts


def _quantile_topk():
    """A TopK with ``impl="quantile"``, which has no wire codec."""
    return compress.TopK(0.3, impl="quantile")


# error feedback, server momentum, geometric local phases, the packed
# wire, straggler deadlines, the semi_sync policy, the compressed downlink,
# per-client overrides, client stores, availability, hierarchical policies
# and the tree sampler are ported; each case is the reference's own
# refusal, which the port raises as the reference does: a store that is
# not a ClientStore (beside the EF memory, and alone), an availability
# trace that is not one, an unknown downlink mode beside momentum, the
# packed wire for a quantile TopK, a compressed downlink without its
# compressor, a hierarchical policy whose edges do not divide the cohort
# (a semi_sync edge tier), the tree sampler of a schedule without
# availability (beside a deadline), and overrides of the wrong shape
@pytest.mark.parametrize("make,error,match", [
    (lambda s: FedComLoc(None, s["tdata"], FedComLocConfig(
        n_clients=N_CLIENTS, clients_per_round=S, error_feedback=True),
        compress.TopK(0.1), store=object()),
     TypeError, "ClientStore"),
    (lambda s: FedComLoc(None, s["tdata"], FedComLocConfig(
        n_clients=N_CLIENTS, clients_per_round=S, server_momentum=0.5),
        compress.TopK(0.1), downlink="delta"),
     ValueError, "downlink must be one of"),
    (lambda s: FedComLoc(None, s["tdata"], FedComLocConfig(
        n_clients=N_CLIENTS, clients_per_round=S, local_steps="geometric"),
        schedule=clients.ClientSchedule(
            clients.ClientProfile.homogeneous(N_CLIENTS), deadline=4.0,
            availability=object())),
     TypeError, "ClientAvailability"),
    (lambda s: FedComLoc(None, s["tdata"], _config(FedComLocConfig, "com"),
                         _quantile_topk(), wire="packed"),
     ValueError, "exact-k"),
    (lambda s: FedComLoc(None, s["tdata"], _config(FedComLocConfig, "com"),
                         compress.TopK(0.3), downlink="account"),
     ValueError, "needs a downlink compressor"),
    (lambda s: FedComLoc(None, s["tdata"], _config(FedComLocConfig, "com"),
                         compress.TopK(0.3), store=object()),
     TypeError, "ClientStore"),
    (lambda s: aggregation.validate_policy(aggregation.HierarchicalPolicy(
        edge=aggregation.AggregationPolicy.semi_sync(2), n_edges=2), S),
     ValueError, "must divide"),
    (lambda s: clients.ClientSchedule(
        clients.ClientProfile.homogeneous(N_CLIENTS), deadline=1.0,
        sampler="tree").tree_sampler,
     ValueError, "does not use the tree sampler"),
    (lambda s: clients.ClientProfile(torch.ones(3), torch.ones(3),
                                     {"density": torch.ones(2)}),
     ValueError, "must have shape"),
], ids=["error_feedback", "server_momentum", "geometric_steps", "packed_wire",
        "compressed_downlink", "client_store", "semi_sync", "deadline",
        "comp_overrides"])
def test_unported_options_raise(setup, make, error, match):
    with pytest.raises(error, match=match):
        make(setup)


def test_variant_none_requires_identity(setup):
    with pytest.raises(ValueError, match="Identity"):
        FedComLoc(None, setup["tdata"], _config(FedComLocConfig, "none"),
                  compress.TopK(0.3))
