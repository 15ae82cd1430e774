"""The ``topk_qr`` and ``int8`` wire codecs of the port against the
reference (split from ``tests/test_torch_compose.py``, whose helpers and
fixtures it shares, so that the two run on separate test workers).

``wire.encode`` on stacked trees against ``jax.vmap(wire.encode)`` of the
reference with the same keys: slot indices, packed words and int8 levels
bit for bit; norms and scales within ``NORM_RTOL``; values rebuilt from
them within ``VALUE_RTOL``.
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # xdist workers share the cores: no spinning OpenMP pools

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import compress as jcomp  # noqa: E402
from repro.compress import wire as jwire  # noqa: E402
from repro_torch import compress, convert  # noqa: E402
from repro_torch import tree as tree_util  # noqa: E402
from repro_torch.compress import wire  # noqa: E402
from repro_torch.core import clients  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from tests.test_torch_compose import (  # noqa: E402,F401
    COMPOSES, NORM_RTOL, S, SHAPES, VALUE_RTOL, _bits, _keys,
    _partitionable_threefry, _reports_equal, _stacked_tree, _x,
    interpret_backend)


# --------------------------------------------------------------------------- #
# the topk_qr and int8 wire codecs against jax.vmap(wire.encode)
# --------------------------------------------------------------------------- #

CODECS = {
    "k25_q4": COMPOSES["k25_q4"],
    "k50_q16": COMPOSES["k50_q16"],
    "dense_q4": COMPOSES["dense_q4"],
    "int8": (lambda c: c.Int8Sync()),
}


def _encode_both(name, seed, shapes=SHAPES, s=S):
    jc, tc = CODECS[name](jcomp), CODECS[name](compress)
    tree_np = _stacked_tree(seed, shapes, s)
    jkeys, tkeys = _keys(seed, s)
    jp, jrep = jax.vmap(lambda t, k: jwire.encode(jc, t, k))(
        jax.tree.map(jnp.asarray, tree_np), jkeys)
    tstacked = convert.params_from_jax(tree_np, "cpu")
    tp, trep = wire.encode(tc, tstacked, tkeys)
    return tc, tstacked, tkeys, (jp, jrep), (tp, trep)


@pytest.mark.parametrize("name", sorted(CODECS))
def test_encode_matches_vmapped_reference(interpret_backend, name):
    """Spec, nbytes and report exactly; slot indices, packed words and
    int8 levels bit for bit; norms and scales within ``NORM_RTOL``."""
    tc, tstacked, _, (jp, jrep), (tp, trep) = _encode_both(name, 5)
    assert tp.spec.codec == jp.spec.codec
    assert tp.spec.caps == jp.spec.caps and tp.spec.r == jp.spec.r
    one_client = tree_util.map(lambda a: a[0], tstacked)
    assert tp.nbytes == jp.nbytes == wire.payload_nbytes(tc, one_client)
    _reports_equal(jrep, trep)
    for jbufs, tbufs in zip(jp.data, tp.data):
        assert len(jbufs) == len(tbufs)
        for a, b in zip(jbufs, tbufs):
            assert b.shape == a.shape and b.element_size() == np.asarray(
                a).dtype.itemsize
            if b.dtype == torch.float32:               # norms and scales
                np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                           rtol=NORM_RTOL)
            else:
                np.testing.assert_array_equal(_bits(b), _bits(a))


@pytest.mark.parametrize("name", sorted(CODECS))
def test_decode_equals_the_account_transform(interpret_backend, name):
    """decode(encode(x)) is the transform's output bit for bit (no code
    saturates on this data; the next test covers that one exception), and
    the reference's decode within ``VALUE_RTOL``."""
    tc, tstacked, tkeys, (jp, _), (tp, _) = _encode_both(name, 9)
    want, _ = tc.compress(tstacked, tkeys)
    got = wire.decode(tp)
    jgot = jax.vmap(jwire.decode)(jp)
    for a, b, c in zip(tree_util.leaves(want), tree_util.leaves(got),
                       jax.tree.leaves(jgot)):
        assert b.shape == a.shape and b.dtype == a.dtype
        np.testing.assert_array_equal(_bits(b), _bits(a))
        np.testing.assert_allclose(b.numpy(), np.asarray(c), rtol=VALUE_RTOL,
                                   atol=0)


def test_topk_qr_decode_saturates_the_top_level():
    """A survivor holding all of its leaf's masked energy has level 2**r,
    which the wire sends as 2**r - 1; every other value is bit-equal."""
    ts = {"w": torch.from_numpy(_x(S, 40, 1) * 1e-3)}
    ts["w"][:, 3] = 5.0
    _, keys = _keys(0)
    comp = compress.Compose(compress.TopK(0.05), compress.QuantQr(4))  # k = 2
    p, _ = wire.encode(comp, ts, keys)
    got = wire.decode(p)["w"]
    want, _ = comp.compress(ts, keys)
    assert torch.equal(want["w"][:, 3], p.data[0][2])       # level 2**r: norm
    assert torch.equal(got[:, 3], p.data[0][2] * 15 / 16)
    got[:, 3] = want["w"][:, 3]
    assert torch.equal(got, want["w"])


MLP_SHAPES = {"fc0": {"w": (784, 64), "b": (64,)},
              "fc1": {"w": (64, 64), "b": (64,)},
              "fc2": {"w": (64, 10), "b": (10,)}}


@pytest.mark.parametrize("name,nbytes,padding", [
    ("k25_q4", 63712, 310), ("k50_q16", 168672, 459), ("int8", 55074, 0)])
def test_mlp_payload_sizes(name, nbytes, padding):
    """At the quickstart MLP's width (784-64-64-10) one upload is 63 712
    B (k25_q4), 168 672 B (k50_q16) or 55 074 B (int8), equal to the
    reference's, and pads by ``(32*ceil(cap/32) - cap) * (1+r)`` bits."""
    tc, tstacked, _, (jp, jrep), (tp, trep) = _encode_both(
        name, 1, MLP_SHAPES, 2)
    one_client = tree_util.map(lambda a: a[0], tstacked)
    assert tp.nbytes == jp.nbytes == nbytes
    assert wire.payload_nbytes(tc, one_client) == nbytes
    pad = wire.padding_bits(tp, trep)
    assert pad.tolist() == [float(padding)] * 2
    np.testing.assert_array_equal(
        pad.numpy(), np.asarray(jwire.padding_bits(jp, jrep), np.float32))
    if tp.spec.codec == "topk_qr":
        assert padding == sum((32 * -(-c // 32) - c) * (1 + tp.spec.r)
                              for c in tp.spec.caps)


def test_topk_qr_underfull_payload_pads_empty_slots():
    tree_np = _stacked_tree(3)
    tree_np["fc1"]["w"][0] = 0.0
    tree_np["fc1"]["w"][0, 0, :4] = 1.0           # 4 survivors of cap 64
    comp = COMPOSES["k25_q4"](compress)
    _, tkeys = _keys(3)
    p, rep = wire.encode(comp, convert.params_from_jax(tree_np, "cpu"), tkeys)
    leaf = [i for i, shp in enumerate(p.spec.shapes) if shp == (16, 16)][0]
    idx, words, _ = p.data[leaf]
    cap = p.spec.caps[leaf]
    assert cap == 64 and (idx[0, 4:] == 256).all()
    codes = ops.unpack_codes(words, 5, cap)
    assert (codes[0, 4:] == 0).all()
    pad = wire.padding_bits(p, rep) - wire.padding_bits(
        *wire.encode(comp, convert.params_from_jax(_stacked_tree(3), "cpu"),
                     tkeys))
    assert float(pad[0]) == (cap - 4) * (32 + 5) and float(pad[1]) == 0.0


def _unchecked(cls, **fields):
    """A compressor instance with fields its constructor refuses (what a
    config for the reference would hold)."""
    obj = object.__new__(cls)
    for k, v in fields.items():
        object.__setattr__(obj, k, v)
    return obj


@pytest.mark.parametrize("make,match", [
    (lambda c: c.Compose(c.QuantQr(4), c.TopK(0.3)), "Compose\\(TopK, QuantQr\\)"),
    (lambda c: c.Compose(c.TopK(0.3), c.TopK(0.5)), "Compose\\(TopK, QuantQr\\)"),
    (lambda c: c.Compose(c.TopK(0.3), c.QuantQr(17)), "r <= 16"),
    (lambda c: c.Compose(c.TopK(0.3, impl="quantile"), c.QuantQr(4)),
     "impl=\"select\""),
    (lambda c: c.Compose(c.TopK(0.3, scope="global"), c.QuantQr(4)),
     "matching scopes")],
    ids=["quant_first", "two_topk", "wide_r", "quantile", "scopes"])
def test_check_supported_raises_the_reference_errors(make, match):
    """The port's ``check_supported`` on the same composition (its stages
    built field for field, past the port's own refusal of global scope
    and quantile TopK) raises the reference's ``ValueError``."""
    with pytest.raises(ValueError, match=match):
        jwire.check_supported(make(jcomp))

    def port(stage):
        cls = getattr(compress, type(stage).__name__)
        return _unchecked(cls, **{f: getattr(stage, f)
                                  for f in cls.__dataclass_fields__})

    jc = make(jcomp)
    with pytest.raises(ValueError, match=match):
        wire.check_supported(compress.Compose(port(jc.first), port(jc.second)))


def test_check_supported_names_the_codecs():
    assert wire.check_supported(COMPOSES["k25_q4"](compress)) == "topk_qr"
    assert wire.check_supported(COMPOSES["dense_q4"](compress)) == "qr"
    assert wire.check_supported(compress.Int8Sync()) == "int8"
    glob = compress.Compose(compress.TopK(0.3, scope="global"),
                            compress.QuantQr(4, scope="global"))
    assert wire.check_supported(glob) == "topk_qr"


def test_int8_overrides_stay_unported():
    """Int8Sync takes no per-client override, in the reference as here:
    ``vmap_compress`` hands the override to ``compress``, which refuses the
    keyword (``validate_schedule`` refuses such a profile first)."""
    plan = clients.RoundPlan(
        steps=torch.ones(S, dtype=torch.int64),
        participating=torch.ones(S, dtype=torch.bool),
        speed=torch.ones(S), bandwidth=torch.ones(S),
        comp_overrides={"magnitude_bits": torch.full((S,), 4)})
    ts = convert.params_from_jax(_stacked_tree(0), "cpu")
    with pytest.raises(TypeError, match="magnitude_bits"):
        clients.batched_compress(compress.Int8Sync(), plan, ts, _keys(0)[1])
