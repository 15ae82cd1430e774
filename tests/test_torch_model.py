"""The port's MLP, loss, data and federated-data containers against the
reference, from the same weights and seeds."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # xdist workers share the cores: no spinning OpenMP pools

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import comm as jcomm  # noqa: E402
from repro.core import fed_data as jfed  # noqa: E402
from repro.data import dirichlet as jdirichlet  # noqa: E402
from repro.data import synthetic as jsynthetic  # noqa: E402
from repro.models import small as jsmall  # noqa: E402
from repro_torch import convert, prng  # noqa: E402
from repro_torch import tree as tree_util  # noqa: E402
from repro_torch.core import comm, fed_data  # noqa: E402
from repro_torch.data import dirichlet, synthetic  # noqa: E402
from repro_torch.models import small  # noqa: E402


@pytest.fixture(autouse=True)
def _partitionable_threefry():
    """The port reproduces jax's partitionable threefry stream (the
    default since jax 0.5); pin it whatever the ambient config says."""
    with jax.threefry_partitionable(True):
        yield


ATOL = 1e-5
S, B, HIDDEN = 3, 8, 16


def _stacked_params(seed: int):
    keys = jax.random.split(jax.random.PRNGKey(seed), S)
    model = jsmall.MLP(784, HIDDEN, 10)
    return jax.tree.map(lambda *a: np.stack([np.asarray(x) for x in a]),
                        *[model.init(k) for k in keys])


def _batch(seed: int):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((S, B, 784)).astype(np.float32)
    y = rng.integers(0, 10, (S, B)).astype(np.int32)
    return x, y


def test_stacked_logits_match():
    params = _stacked_params(0)
    x, _ = _batch(0)
    jm, tm = jsmall.MLP(784, HIDDEN, 10), small.MLP(784, HIDDEN, 10)
    want = np.asarray(jax.vmap(jm.apply)(jax.tree.map(jnp.asarray, params),
                                         jnp.asarray(x)))
    got = tm(convert.params_from_jax(params, "cpu"), torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL)


def test_unstacked_logits_match():
    params = jax.tree.map(lambda a: a[0], _stacked_params(1))
    x, _ = _batch(1)
    jm, tm = jsmall.MLP(784, HIDDEN, 10), small.MLP(784, HIDDEN, 10)
    want = np.asarray(jm.apply(jax.tree.map(jnp.asarray, params),
                               jnp.asarray(x[0])))
    got = tm.apply(convert.params_from_jax(params, "cpu"), torch.from_numpy(x[0]))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL)


def test_per_client_losses_and_gradients_match():
    """Backward of the summed stacked loss gives each client its own
    gradient: equal to ``jax.vmap(jax.value_and_grad(loss))``."""
    params = _stacked_params(2)
    x, y = _batch(2)
    jm, tm = jsmall.MLP(784, HIDDEN, 10), small.MLP(784, HIDDEN, 10)
    jloss = jsmall.cross_entropy_loss(jm.apply)
    wl, wg = jax.vmap(jax.value_and_grad(jloss))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x), jnp.asarray(y))
    tparams = convert.params_from_jax(params, "cpu")
    flat = [p.requires_grad_(True) for p in tree_util.leaves(tparams)]
    losses = small.cross_entropy_loss(tm.apply)(
        tree_util.unflatten(tparams, flat), torch.from_numpy(x),
        torch.from_numpy(y).long())
    grads = torch.autograd.grad(losses.sum(), flat)
    np.testing.assert_allclose(losses.detach().numpy(), np.asarray(wl),
                               rtol=1e-5, atol=ATOL)
    for a, b in zip(jax.tree.leaves(wg), grads):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=ATOL)


def test_init_follows_the_reference_scheme():
    jp = jsmall.MLP(784, HIDDEN, 10).init(jax.random.PRNGKey(0))
    tp = small.MLP(784, HIDDEN, 10).init(prng.PRNGKey(0), device="cpu")
    for a, b in zip(jax.tree.leaves(jp), tree_util.leaves(tp)):
        assert tuple(b.shape) == a.shape and b.dtype == torch.float32
        # XLA's erf_inv route: jax's normals bit for bit
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_convert_round_trip():
    params = _stacked_params(3)
    back = convert.params_to_numpy(convert.params_from_jax(params, "cpu"))
    for a, b in zip(jax.tree.leaves(params), tree_util.leaves(back)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_and_dirichlet_are_byte_equal(seed):
    a = jsynthetic.make_mnist_like(n_train=500, n_test=100, seed=seed)
    b = synthetic.make_mnist_like(n_train=500, n_test=100, seed=seed)
    for name in ("x_train", "y_train", "x_test", "y_test"):
        va, vb = getattr(a, name), getattr(b, name)
        assert va.dtype == vb.dtype and va.tobytes() == vb.tobytes()
    pa = jdirichlet.dirichlet_partition(a.y_train, 6, 0.7, seed=seed)
    pb = dirichlet.dirichlet_partition(b.y_train, 6, 0.7, seed=seed)
    assert len(pa) == len(pb)
    for u, v in zip(pa, pb):
        np.testing.assert_array_equal(u, v)


def test_sample_batch_matches_reference():
    """Per-client randint spans: batch positions, hence batches, equal the
    reference's draws for the same key."""
    ds = synthetic.make_mnist_like(n_train=400, n_test=50)
    parts = dirichlet.dirichlet_partition(ds.y_train, 6, 0.3, seed=1)
    jd = jfed.from_numpy_partition(ds.x_train, ds.y_train, parts)
    td = fed_data.from_numpy_partition(ds.x_train, ds.y_train, parts,
                                       device="cpu")
    np.testing.assert_array_equal(td.client_indices.numpy(),
                                  np.asarray(jd.client_indices))
    np.testing.assert_array_equal(td.client_sizes.numpy(),
                                  np.asarray(jd.client_sizes))
    keys = jax.random.split(jax.random.PRNGKey(2), 12).reshape(2, 6, 2)
    clients = np.array([[0, 1, 2, 3, 4, 5], [5, 5, 0, 2, 1, 3]])
    xb, yb = td.sample_batch(prng.key_data(np.asarray(keys)),
                             torch.from_numpy(clients), 16)
    assert tuple(xb.shape) == (2, 6, 16, 784) and tuple(yb.shape) == (2, 6, 16)
    for i in range(2):
        for j in range(6):
            wx, wy = jd.sample_batch(keys[i, j], jnp.asarray(clients[i, j]), 16)
            np.testing.assert_array_equal(xb[i, j].numpy(), np.asarray(wx))
            np.testing.assert_array_equal(yb[i, j].numpy(), np.asarray(wy))


def test_comm_meter_matches_reference():
    a, b = jcomm.CommMeter(), comm.CommMeter()
    for up, down in [(1.5, 2.0), (3.25, 0.0)]:
        a.record_round(uplink_bits=up, downlink_bits=down)
        b.record_round(uplink_bits=up, downlink_bits=down)
    arr = np.array([1.0, 2.0, 4.5], np.float32)
    a.record_rounds(uplink_bits=arr, downlink_bits=None, num_rounds=3)
    b.record_rounds(uplink_bits=arr, downlink_bits=None, num_rounds=3)
    assert a.snapshot() == b.snapshot()
    # the reference's "jnp" meter and the port's device meter, same records
    a, b = jcomm.CommMeter(mode="jnp"), comm.CommMeter(mode="jnp")
    assert b.mode == "device"
    for up, down in [(1.5, 2.0), (3.25, 0.0)]:
        a.record_round(uplink_bits=up, downlink_bits=down)
        b.record_round(uplink_bits=up, downlink_bits=down)
    a.record_rounds(uplink_bits=arr, downlink_bits=None, num_rounds=3)
    b.record_rounds(uplink_bits=arr, downlink_bits=None, num_rounds=3)
    assert a.snapshot() == b.snapshot()
