"""The paper's FedCIFAR10 pair in the port: ``make_cifar_like`` and the CNN,
against the reference from the same seeds.

The data must be equal; the init bit-equal (``prng.normal`` is); logits
and gradients, unstacked and stacked over 3 clients (one grouped
convolution per conv layer), within 1e-5, the MLP's tolerance (float32
convolutions and matmuls summed in other orders in XLA and torch).
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.data import synthetic as jsynthetic  # noqa: E402
from repro.models import small as jsmall  # noqa: E402
from repro_torch import convert, prng  # noqa: E402
from repro_torch import tree as tree_util  # noqa: E402
from repro_torch.core.engine import value_and_grad  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.models import small  # noqa: E402

TOL = 1e-5
S, B = 3, 8


@pytest.fixture(autouse=True)
def _partitionable_threefry():
    with jax.threefry_partitionable(True):
        yield


@pytest.fixture(scope="module")
def setup():
    with jax.threefry_partitionable(True):
        ds = synthetic.make_cifar_like(n_train=96, n_test=8)
        jm, tm = jsmall.CNN(3, 10, 32), small.CNN(3, 10, 32)
        keys = jax.random.split(jax.random.PRNGKey(0), S)
        jparams = [jax.tree.map(np.asarray, jm.init(k)) for k in keys]
    return {"ds": ds, "jm": jm, "tm": tm, "jparams": jparams}


def _stack(trees):
    return tree_util.map(lambda *ls: torch.stack(ls), *trees)


@pytest.mark.parametrize("kw", [{"n_train": 300, "n_test": 40},
                                {"n_train": 120, "n_test": 10, "seed": 5,
                                 "noise": 0.5}])
def test_make_cifar_like_equals_reference(kw):
    got, want = synthetic.make_cifar_like(**kw), jsynthetic.make_cifar_like(**kw)
    assert got.x_train.shape == (kw["n_train"], 32, 32, 3)
    for name in ("x_train", "y_train", "x_test", "y_test"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.n_classes == want.n_classes == 10


@pytest.mark.parametrize("seed", [0, 7])
def test_init_is_bit_equal_in_hwio(seed):
    want = jax.tree.map(np.asarray,
                        jsmall.CNN(3, 10, 32).init(jax.random.PRNGKey(seed)))
    got = convert.params_to_numpy(
        small.CNN(3, 10, 32).init(prng.PRNGKey(seed), device="cpu"))
    assert sorted(got) == ["conv0", "conv1", "fc0", "fc1", "fc2"]
    assert got["conv0"]["w"].shape == (5, 5, 3, 6)      # HWIO
    assert got["conv1"]["w"].shape == (5, 5, 6, 16)
    assert got["fc0"]["w"].shape == (400, 120)
    for a, b in zip(jax.tree.leaves(want), tree_util.leaves(got)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(b, a)


def test_convert_carries_the_cnn_tree(setup):
    jp = setup["jparams"][0]
    tp = convert.params_from_jax(jp, "cpu")
    for a, b in zip(jax.tree.leaves(jp), tree_util.leaves(tp)):
        np.testing.assert_array_equal(b.numpy(), a)


def _jax_loss_grad(setup, params, xb, yb):
    loss_fn = jsmall.cross_entropy_loss(setup["jm"].apply)
    loss, g = jax.value_and_grad(loss_fn)(
        jax.tree.map(jax.numpy.asarray, params), jax.numpy.asarray(xb),
        jax.numpy.asarray(yb))
    return float(loss), jax.tree.map(np.asarray, g)


def test_unstacked_logits_and_gradients(setup):
    ds, jp = setup["ds"], setup["jparams"][0]
    xb, yb = ds.x_train[:B], ds.y_train[:B]
    want = np.asarray(setup["jm"].apply(jax.tree.map(jax.numpy.asarray, jp),
                                        jax.numpy.asarray(xb)))
    tp = convert.params_from_jax(jp, "cpu")
    got = setup["tm"].apply(tp, torch.from_numpy(xb)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)

    jloss, jgrad = _jax_loss_grad(setup, jp, xb, yb)
    loss_fn = small.cross_entropy_loss(setup["tm"].apply)
    flat = [p.requires_grad_(True) for p in tree_util.leaves(tp)]
    loss = loss_fn(tree_util.unflatten(tp, flat), torch.from_numpy(xb),
                   torch.from_numpy(yb.astype(np.int64)))
    grads = torch.autograd.grad(loss, flat)
    np.testing.assert_allclose(float(loss.detach()), jloss, rtol=TOL)
    for a, b in zip(jax.tree.leaves(jgrad), grads):
        np.testing.assert_allclose(b.numpy(), a, rtol=TOL, atol=TOL)


def test_stacked_logits_and_gradients(setup):
    """Three clients with their own weights and batches in one grouped
    forward/backward, each against the reference's own client."""
    ds = setup["ds"]
    xb = ds.x_train[:S * B].reshape(S, B, 32, 32, 3)
    yb = ds.y_train[:S * B].reshape(S, B)
    tp = _stack([convert.params_from_jax(p, "cpu") for p in setup["jparams"]])
    logits = setup["tm"].apply(tp, torch.from_numpy(xb)).numpy()
    losses, grads = value_and_grad(
        small.cross_entropy_loss(setup["tm"].apply), tp,
        torch.from_numpy(xb), torch.from_numpy(yb.astype(np.int64)))
    assert logits.shape == (S, B, 10) and losses.shape == (S,)
    for i, jp in enumerate(setup["jparams"]):
        want = np.asarray(setup["jm"].apply(
            jax.tree.map(jax.numpy.asarray, jp), jax.numpy.asarray(xb[i])))
        np.testing.assert_allclose(logits[i], want, rtol=TOL, atol=TOL)
        jloss, jgrad = _jax_loss_grad(setup, jp, xb[i], yb[i])
        np.testing.assert_allclose(float(losses[i]), jloss, rtol=TOL)
        for a, b in zip(jax.tree.leaves(jgrad), tree_util.leaves(grads)):
            np.testing.assert_allclose(b[i].numpy(), a, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("row", [0, 17, 199, 399])
def test_fc0_rows_follow_the_hwc_flatten(setup, row):
    """A ``fc0`` weight with one non-zero input row reads one (h, w, c)
    feature: the same logits in both packages pin the flatten order."""
    jp = jax.tree.map(np.copy, setup["jparams"][1])
    w = np.zeros_like(jp["fc0"]["w"])
    w[row] = np.linspace(-2.0, 2.0, w.shape[1], dtype=np.float32)
    jp["fc0"]["w"] = w
    jp["fc0"]["b"] = np.zeros_like(jp["fc0"]["b"])
    xb = setup["ds"].x_train[:B]
    want = np.asarray(setup["jm"].apply(jax.tree.map(jax.numpy.asarray, jp),
                                        jax.numpy.asarray(xb)))
    got = setup["tm"].apply(convert.params_from_jax(jp, "cpu"),
                            torch.from_numpy(xb)).numpy()
    assert np.ptp(want) > 0
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
