"""``scope="global"`` and ``TopK(impl="quantile")`` in the port, against
the reference.

* Global-scope ``TopK``, ``QuantQr`` and ``Compose`` (the leaves
  concatenated, one unit a client, at their promoted dtype) against
  ``jax.vmap(comp.compress)`` on the same keys: TopK masks and every
  report bit-equal; Q_r bit-equal given the reference's global norm
  (drawn with ``split(key, L)[0]``), within a level of it otherwise.
* The global wire: ``decode(encode(.))`` equals the port's transform,
  reports equal the reference's ``wire.encode`` under ``vmap``, and
  ``payload_nbytes`` equals the reference's, for the ``dense``, ``topk``,
  ``qr`` and ``topk_qr`` codecs, on a float32 and a mixed-dtype tree.
* ``TopK(impl="quantile")``: thresholds equal to ``jnp.quantile``'s bit for
  bit (ties, zeros, NaN rows, q at 0 and 1), masks equal to the
  reference's; ``check_supported`` refuses it, and mismatched Compose
  scopes, with the reference's messages.
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # xdist workers share the cores: no spinning OpenMP pools

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import compress as jcomp  # noqa: E402
from repro.compress import wire as jwire  # noqa: E402
from repro_torch import compress, convert, prng  # noqa: E402
from repro_torch import tree as tree_util  # noqa: E402
from repro_torch.compress import wire  # noqa: E402
from repro_torch.compress.compressors import quantile_threshold  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402


@pytest.fixture(autouse=True)
def _partitionable_threefry():
    """The port reproduces jax's partitionable threefry stream (the
    default since jax 0.5); pin it whatever the ambient config says."""
    with jax.threefry_partitionable(True):
        yield


S = 3
SHAPES = {"fc0": {"w": (64, 16), "b": (16,)},
          "fc1": {"w": (16, 10), "b": (10,)}}


def _tree(seed):
    rng = np.random.default_rng(seed)
    tree = {name: {leaf: rng.standard_normal((S,) + shp).astype(np.float32)
                   for leaf, shp in leaves.items()}
            for name, leaves in SHAPES.items()}
    return tree


def _to_both(tree, mixed=False):
    """The stacked tree for each package; ``mixed`` makes fc1/w bf16."""
    jt = jax.tree.map(jnp.asarray, tree)
    tt = convert.params_from_jax(tree, "cpu")
    if mixed:
        jt["fc1"]["w"] = jt["fc1"]["w"].astype(jnp.bfloat16)
        tt["fc1"]["w"] = tt["fc1"]["w"].to(torch.bfloat16)
    return jt, tt


def _keys(seed):
    keys = jax.random.split(jax.random.PRNGKey(seed), S)
    return keys, torch.from_numpy(np.asarray(keys).astype(np.int64))


def _bits(a):
    a = np.asarray(a.float() if isinstance(a, torch.Tensor) else
                   jnp.asarray(a, jnp.float32))
    return a.view(np.uint32)


def _reports_equal(jrep, trep):
    for name in ("value_bits", "index_bits", "meta_bits", "total_bits"):
        want = np.broadcast_to(np.asarray(getattr(jrep, name), np.float32),
                               (S,))
        np.testing.assert_array_equal(getattr(trep, name).numpy(), want,
                                      err_msg=name)


def _flat(tree):
    return np.concatenate([np.asarray(jnp.asarray(l, jnp.float32)).reshape(S, -1)
                           if not isinstance(l, torch.Tensor)
                           else l.float().numpy().reshape(S, -1)
                           for l in jax.tree.leaves(tree)], 1)


def _assert_qr_close(a, b, norms, r):
    """Q_r of the two packages, rows of the global unit: bit-equal when the
    norms agree to the bit, else within an ulp but for a handful of
    entries a level (norm / 2^r) apart."""
    for c in range(S):
        if np.array_equal(a[c].view(np.uint32), b[c].view(np.uint32)):
            continue
        flips = ~np.isclose(a[c], b[c], rtol=1e-6, atol=1e-7)
        assert flips.sum() <= 3, flips.sum()
        np.testing.assert_allclose(np.abs(a[c] - b[c])[flips],
                                   norms[c] / 2.0 ** r, rtol=1e-5)


@pytest.mark.parametrize("mixed", [False, True], ids=["f32", "mixed"])
@pytest.mark.parametrize("density", [0.05, 0.3, 1.0])
def test_global_topk_matches_reference(density, mixed):
    jt, tt = _to_both(_tree(1), mixed)
    jkeys, tkeys = _keys(0)
    jout, jrep = jax.vmap(jcomp.TopK(density, scope="global").compress)(
        jt, jkeys)
    tout, trep = compress.TopK(density, scope="global").compress(tt, tkeys)
    for a, b in zip(jax.tree.leaves(jout), tree_util.leaves(tout)):
        assert str(b.dtype).split(".")[-1] == a.dtype.name
        np.testing.assert_array_equal(_bits(b), _bits(a))
    _reports_equal(jrep, trep)


@pytest.mark.parametrize("r", [4, 8])
def test_global_quantqr_matches_reference(r):
    tree = _tree(2)
    jt, tt = _to_both(tree)
    jkeys, tkeys = _keys(r)
    jout, jrep = jax.vmap(jcomp.QuantQr(r, scope="global").compress)(jt, jkeys)
    tout, trep = compress.QuantQr(r, scope="global").compress(tt, tkeys)
    _reports_equal(jrep, trep)
    flat = _flat(tree)
    norms = np.sqrt((flat.astype(np.float64) ** 2).sum(1))
    _assert_qr_close(_flat(jout), _flat(tout), norms, r)
    # the global unit draws with split(key, L)[0]: bit-equal given the
    # reference's global norm
    jnorm = np.asarray(jnp.sqrt(jnp.sum(jnp.asarray(flat) ** 2, axis=1)))
    leaf_keys = prng.split(tkeys, len(jax.tree.leaves(tree)))
    got = ref.quantize_qr_with_uniforms(
        torch.from_numpy(flat), r, prng.uniform(leaf_keys[:, 0], flat.shape[1]),
        torch.tensor(jnorm))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  _flat(jout).view(np.uint32))


def test_global_compose_matches_reference():
    tree = _tree(3)
    jt, tt = _to_both(tree)
    jkeys, tkeys = _keys(5)
    jc = jcomp.Compose(jcomp.TopK(0.25, "global"), jcomp.QuantQr(4, "global"))
    tc = compress.Compose(compress.TopK(0.25, "global"),
                          compress.QuantQr(4, "global"))
    jout, jrep = jax.vmap(jc.compress)(jt, jkeys)
    tout, trep = tc.compress(tt, tkeys)
    _reports_equal(jrep, trep)
    a, b = _flat(jout), _flat(tout)
    np.testing.assert_array_equal(a != 0, b != 0)
    masked = np.where(a != 0, _flat(tree), 0.0)
    _assert_qr_close(a, b, np.sqrt((masked.astype(np.float64) ** 2).sum(1)), 4)


WIRE_COMPS = {
    "dense": lambda c: c.TopK(1.0, scope="global"),
    "topk": lambda c: c.TopK(0.2, scope="global"),
    "qr": lambda c: c.QuantQr(4, scope="global"),
    "topk_qr": lambda c: c.Compose(c.TopK(0.25, "global"),
                                   c.QuantQr(8, "global")),
}


@pytest.mark.parametrize("mixed", [False, True], ids=["f32", "mixed"])
@pytest.mark.parametrize("codec", list(WIRE_COMPS))
def test_global_wire_roundtrip_and_sizes(codec, mixed):
    jt, tt = _to_both(_tree(4), mixed)
    jkeys, tkeys = _keys(9)
    jc, tc = WIRE_COMPS[codec](jcomp), WIRE_COMPS[codec](compress)
    assert wire.check_supported(tc) == jwire.check_supported(jc) == codec
    payload, rep = wire.encode(tc, tt, tkeys)
    assert payload.spec.scope == "global" and len(payload.data) == 1
    out, trep = tc.compress(tt, tkeys)
    dec = wire.decode(payload)
    for a, b in zip(tree_util.leaves(out), tree_util.leaves(dec)):
        assert a.dtype == b.dtype
        if codec in ("qr", "topk_qr"):
            # the top level 2^r saturates to 2^r - 1 on the wire; no other
            # entry may differ
            diff = (a.float() - b.float()).abs()
            assert int((diff > 0).sum()) <= 1
        else:
            np.testing.assert_array_equal(_bits(b), _bits(a))
    for name in ("value_bits", "index_bits", "meta_bits"):
        np.testing.assert_array_equal(getattr(rep, name).numpy(),
                                      getattr(trep, name).numpy(),
                                      err_msg=name)
    _, jrep = jax.vmap(lambda t, k: jwire.encode(jc, t, k))(jt, jkeys)
    _reports_equal(jrep, rep)
    one_j = jax.tree.map(lambda a: a[0], jt)
    one_t = tree_util.map(lambda a: a[0], tt)
    assert (payload.nbytes == wire.payload_nbytes(tc, one_t)
            == jwire.payload_nbytes(jc, one_j))


def test_wire_refuses_quantile_and_mismatched_scopes():
    with pytest.raises(ValueError, match="exact-k support"):
        wire.check_supported(compress.TopK(0.3, impl="quantile"))
    with pytest.raises(ValueError, match="matching scopes"):
        wire.check_supported(compress.Compose(compress.TopK(0.3, "global"),
                                              compress.QuantQr(4)))
    with pytest.raises(ValueError, match='impl="select"'):
        wire.check_supported(compress.Compose(
            compress.TopK(0.3, impl="quantile"), compress.QuantQr(4)))


# --------------------------------------------------------------------------- #
# TopK(impl="quantile")
# --------------------------------------------------------------------------- #

def _quantile_rows():
    rng = np.random.default_rng(11)
    rows = [rng.standard_normal(1000), rng.standard_normal(777),
            np.round(rng.standard_normal(1000) * 3) / 3,     # many ties
            np.where(rng.random(1000) < 0.7, 0.0, rng.standard_normal(1000))]
    return [np.abs(r).astype(np.float32) for r in rows]


@pytest.mark.parametrize("q", [0.0, 0.1, 0.5, 0.7, 0.9, 0.999, 1.0,
                               1.0 - 0.3, np.float32(1.0) - np.float32(0.05)])
def test_quantile_threshold_equals_jnp_quantile(q):
    for mag in _quantile_rows():
        want = np.asarray(jnp.quantile(jnp.asarray(mag), q))
        got = quantile_threshold(torch.from_numpy(mag)[None],
                                 torch.tensor(q, dtype=torch.float32))
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      want.reshape(1).view(np.uint32))


def test_quantile_threshold_per_row_q_and_nan():
    mag = np.abs(np.random.default_rng(2).standard_normal((3, 500))
                 ).astype(np.float32)
    mag[1, 17] = np.nan
    q = np.array([0.95, 0.5, 0.875], np.float32)
    got = quantile_threshold(torch.from_numpy(mag), torch.from_numpy(q))
    want = np.asarray(jax.vmap(jnp.quantile)(jnp.asarray(mag),
                                             jnp.asarray(q)))
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
    np.testing.assert_array_equal(got.numpy()[[0, 2]].view(np.uint32),
                                  want[[0, 2]].view(np.uint32))


@pytest.mark.parametrize("scope", ["tensor", "global"])
@pytest.mark.parametrize("density", [0.01, 0.1, 0.3, 0.9])
def test_quantile_topk_matches_reference(density, scope):
    tree = _tree(int(density * 100))
    tree["fc1"]["b"][0] = 0.0                     # zeros and ties
    tree["fc0"]["w"][1, :8] = 1.25
    jt, tt = _to_both(tree)
    jkeys, tkeys = _keys(0)
    jc = jcomp.TopK(density, scope=scope, impl="quantile")
    tc = compress.TopK(density, scope=scope, impl="quantile")
    jout, jrep = jax.vmap(jc.compress)(jt, jkeys)
    tout, trep = tc.compress(tt, tkeys)
    for a, b in zip(jax.tree.leaves(jout), tree_util.leaves(tout)):
        np.testing.assert_array_equal(_bits(b), _bits(a))
    _reports_equal(jrep, trep)
