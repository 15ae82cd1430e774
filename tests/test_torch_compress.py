"""The port's compressors on stacked client trees against
``jax.vmap(comp.compress)`` of the reference, with the same keys."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # xdist workers share the cores: no spinning OpenMP pools

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import compress as jcomp  # noqa: E402
from repro_torch import compress, convert  # noqa: E402
from repro_torch import tree as tree_util  # noqa: E402
from repro_torch.compress import report  # noqa: E402


@pytest.fixture(autouse=True)
def _partitionable_threefry():
    """The port reproduces jax's partitionable threefry stream (the
    default since jax 0.5); pin it whatever the ambient config says."""
    with jax.threefry_partitionable(True):
        yield


S = 3
SHAPES = {"fc0": {"w": (784, 16), "b": (16,)},
          "fc1": {"w": (16, 16), "b": (16,)},
          "fc2": {"w": (16, 10), "b": (10,)}}


def _stacked_tree(seed: int, s: int = S) -> dict:
    rng = np.random.default_rng(seed)
    return {name: {leaf: rng.standard_normal((s,) + shape).astype(np.float32)
                   for leaf, shape in leaves.items()}
            for name, leaves in SHAPES.items()}


def _keys(seed: int, s: int = S):
    keys = jax.random.split(jax.random.PRNGKey(seed), s)
    return keys, torch.from_numpy(np.asarray(keys).astype(np.int64))


def _run_both(jc, tc, tree_np, seed=0):
    jkeys, tkeys = _keys(seed)
    jtree = jax.tree.map(jnp.asarray, tree_np)
    jout, jrep = jax.vmap(jc.compress)(jtree, jkeys)
    tout, trep = tc.compress(convert.params_from_jax(tree_np, "cpu"), tkeys)
    return jout, jrep, tout, trep


def _reports_equal(jrep, trep):
    for name in ("value_bits", "index_bits", "meta_bits", "total_bits"):
        want = np.broadcast_to(np.asarray(getattr(jrep, name), np.float32), (S,))
        got = getattr(trep, name).numpy()
        assert got.dtype == np.float32 and got.shape == (S,)
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("density", [0.01, 0.1, 0.3, 0.5, 0.9, 1.0])
def test_topk_matches_vmapped_reference(density):
    tree_np = _stacked_tree(int(density * 100))
    jout, jrep, tout, trep = _run_both(jcomp.TopK(density), compress.TopK(density),
                                       tree_np)
    for a, b in zip(jax.tree.leaves(jout), tree_util.leaves(tout)):
        np.testing.assert_array_equal(np.asarray(a).view(np.uint32),
                                      b.numpy().view(np.uint32))
    _reports_equal(jrep, trep)


def test_topk_counts_ties_and_zeros_from_the_payload():
    """nnz comes from the actual mask: ties at the threshold are all kept
    and already-zero entries cost nothing."""
    tree_np = _stacked_tree(5)
    tree_np["fc1"]["w"][0] = 1.0                 # every entry tied
    tree_np["fc2"]["w"][1, :8] = 0.0
    tree_np["fc0"]["b"][2] = 0.0                 # all zero
    jout, jrep, tout, trep = _run_both(jcomp.TopK(0.3), compress.TopK(0.3),
                                       tree_np)
    for a, b in zip(jax.tree.leaves(jout), tree_util.leaves(tout)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    _reports_equal(jrep, trep)


def test_identity_matches_vmapped_reference():
    tree_np = _stacked_tree(1)
    jout, jrep, tout, trep = _run_both(jcomp.Identity(), compress.Identity(),
                                       tree_np)
    for a, b in zip(jax.tree.leaves(jout), tree_util.leaves(tout)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    _reports_equal(jrep, trep)


def _assert_qr_close(a: np.ndarray, b: np.ndarray, norm: float, r: int):
    """Q_r outputs from the two packages: bit-equal when the leaf norms
    agree to the bit; when torch's and XLA's float32 sums differ in the
    last place, every entry moves by an ulp and at most a handful of
    entries may round to the neighbouring level (exactly norm/L apart)."""
    if np.array_equal(a.view(np.uint32), b.view(np.uint32)):
        return
    close = np.isclose(a, b, rtol=1e-6, atol=1e-7)
    flips = ~close
    assert flips.sum() <= 3, flips.sum()
    np.testing.assert_allclose(np.abs(a[flips] - b[flips]), norm / 2 ** r,
                               rtol=1e-5)


@pytest.mark.parametrize("r", [1, 4, 8])
def test_quantqr_matches_vmapped_reference(r):
    tree_np = _stacked_tree(10 + r)
    jout, jrep, tout, trep = _run_both(jcomp.QuantQr(r), compress.QuantQr(r),
                                       tree_np, seed=r)
    for a, b, x in zip(jax.tree.leaves(jout), tree_util.leaves(tout),
                       jax.tree.leaves(tree_np)):
        a = np.asarray(a)
        b = b.numpy()
        for c in range(S):
            norm = float(np.sqrt(np.sum(x[c].astype(np.float64) ** 2)))
            _assert_qr_close(a[c], b[c], norm, r)
    _reports_equal(jrep, trep)


def test_quantqr_uses_the_reference_key_chain():
    """Given the reference's norms, the port's per-client, per-leaf keys
    (``split(keys[i], L)[j]``) reproduce the reference bit for bit."""
    from repro.kernels import ref as jref
    from repro_torch.kernels import ref
    from repro_torch import prng
    tree_np = _stacked_tree(3)
    jkeys, tkeys = _keys(7)
    leaf_keys = prng.split(tkeys, 6)

    @jax.jit
    def reference(key, j, flat):
        """Q_r with the reference's leaf key, and the norm it rounds by."""
        return (jref.quantize_qr(flat, 4, jax.random.split(key, 6)[j]),
                jnp.sqrt(jnp.sum(flat * flat)))

    for j, x in enumerate(jax.tree.leaves(tree_np)):
        for c in range(S):
            flat = jnp.asarray(x[c].reshape(-1))
            want, jnorm = reference(jkeys[c], j, flat)
            norm = torch.tensor([float(jnorm)])
            u = prng.uniform(leaf_keys[c, j], flat.size)[None]
            got = ref.quantize_qr_with_uniforms(
                torch.from_numpy(x[c].reshape(1, -1)), 4, u, norm)[0]
            np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                          np.asarray(want).view(np.uint32))


def test_report_helpers_match():
    tree_np = jax.tree.map(lambda a: a[0], _stacked_tree(0))
    t = convert.params_from_jax(tree_np, "cpu")
    assert report.dense_bits(t) == jcomp.dense_bits(tree_np)
    assert report.FLOAT_BITS == jcomp.FLOAT_BITS == 32
    assert report.INDEX_BITS == jcomp.INDEX_BITS == 32
    assert report.leaf_value_bits(torch.zeros(2, dtype=torch.bfloat16)) == 16
    assert report.leaf_value_bits(torch.zeros(2)) == 32


# scope="global" and impl="quantile" are ported; a value outside the
# options raises the reference's ValueError
@pytest.mark.parametrize("make", [
    lambda: compress.TopK(0.1, scope="row"),
    lambda: compress.TopK(0.1, impl="sort"),
    lambda: compress.QuantQr(4, scope="row")])
def test_unported_options_raise(make):
    with pytest.raises(ValueError, match="unknown"):
        make()


def test_quantqr_needs_keys_and_validates():
    with pytest.raises(ValueError):
        compress.QuantQr(4).compress(
            convert.params_from_jax(_stacked_tree(0), "cpu"))
    with pytest.raises(ValueError):
        compress.QuantQr(0)
    with pytest.raises(ValueError):
        compress.TopK(0.0)
