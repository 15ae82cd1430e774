"""The port's packed uplink wire against the reference (DESIGN.md §8).

Kernels: the port's plain K5, K7, K8 and K9 are held bit for bit against
the reference's Pallas kernels in interpret mode (uint32 compared as bit
patterns).  Units stay below 2**24, where the reference's float32 slot
counts are exact.  Codecs: ``wire.encode`` on a stacked tree against
``jax.vmap(wire.encode)`` of the reference under the interpret backend.
Rounds: packed against account rounds of the port, and against the
reference's packed rounds, from the same carried weights and keys.
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # xdist workers share the cores: no spinning OpenMP pools

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import compress as jcomp  # noqa: E402
from repro.compress import wire as jwire  # noqa: E402
from repro.core import fed_data as jfed  # noqa: E402
from repro.core import server as jserver  # noqa: E402
from repro.core.fedcomloc import FedComLoc as JFedComLoc  # noqa: E402
from repro.core.fedcomloc import FedComLocConfig as JConfig  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import pack_codes as jpack  # noqa: E402
from repro.kernels import qr_pack as jqr_pack  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import select_slots as jsel  # noqa: E402
from repro.kernels import topk_compress as jtopk  # noqa: E402
from repro.models import small as jsmall  # noqa: E402
from repro_torch import compress, convert, prng  # noqa: E402
from repro_torch import tree as tree_util  # noqa: E402
from repro_torch.compress import wire  # noqa: E402
from repro_torch.core import clients, engine, fed_data, server  # noqa: E402
from repro_torch.core.fedcomloc import FedComLoc, FedComLocConfig  # noqa: E402
from repro_torch.data import dirichlet, synthetic  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import small  # noqa: E402


@pytest.fixture(autouse=True)
def _partitionable_threefry():
    """The port reproduces jax's partitionable threefry stream (the
    default since jax 0.5); pin it whatever the ambient config says."""
    with jax.threefry_partitionable(True):
        yield


@pytest.fixture
def interpret_backend():
    """Route the reference's ops through its Pallas kernels (interpret
    mode), restoring the backend after the test."""
    before = jops.get_backend()
    jops.set_backend("interpret")
    yield
    jops.set_backend(before)


SIZES = [1, 31, 33, 1000, 4096, 50176]
WIDTHS = [1, 5, 9, 17, 32]
ROWS = 2


def _bits(a) -> np.ndarray:
    """uint32 (reference) or int32 (port) buffers as int32 bit patterns."""
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int32)


def _x(rows: int, n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((rows, n)).astype(
        np.float32)


def _u(rows: int, n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).random((rows, n), dtype=np.float32)


# --------------------------------------------------------------------------- #
# kernels: plain versions against the Pallas kernels in interpret mode
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("b", WIDTHS)
@pytest.mark.parametrize("n", SIZES)
def test_pack_unpack_match_pallas(n, b):
    rng = np.random.default_rng(n * 37 + b)
    codes = rng.integers(0, 2 ** b, (ROWS, n), dtype=np.uint64).astype(np.uint32)
    tcodes = torch.from_numpy(codes.view(np.int32))
    words = ref.pack_codes(tcodes, b)
    assert words.dtype == torch.int32 and words.shape == (ROWS, -(-n // 32) * b)
    for row in range(ROWS):
        want = jpack.pack_codes(jnp.asarray(codes[row]), b, interpret=True)
        np.testing.assert_array_equal(_bits(words[row]), _bits(want))
        back = jpack.unpack_codes(want, b, n, interpret=True)
        np.testing.assert_array_equal(
            _bits(ref.unpack_codes(words[row:row + 1], b, n)[0]), _bits(back))
    assert torch.equal(ref.unpack_codes(words, b, n), tcodes)


def test_pack_ignores_bits_above_the_width():
    codes = torch.full((1, 40), -1, dtype=torch.int32)      # all 32 bits set
    words = ref.pack_codes(codes, 3)
    assert torch.equal(ref.unpack_codes(words, 3, 40),
                       torch.full((1, 40), 7, dtype=torch.int32))


def test_pack_validation():
    with pytest.raises(ValueError):
        ref.pack_codes(torch.zeros((1, 4), dtype=torch.int32), 33)
    with pytest.raises(ValueError):
        ref.pack_codes(torch.zeros((1, 4), dtype=torch.int32), 0)
    with pytest.raises(ValueError):
        ref.unpack_codes(torch.zeros((1, 3), dtype=torch.int32), 2, 100)
    with pytest.raises(ValueError):
        ref.pack_codes(torch.zeros(4, dtype=torch.int32), 5)


@pytest.mark.parametrize("r", [1, 4, 8, 16])
@pytest.mark.parametrize("n", SIZES)
def test_quantize_pack_matches_pallas(n, r):
    x, u = _x(ROWS, n, n + r), _u(ROWS, n, n + r + 1)
    norm = np.sqrt((x.astype(np.float64) ** 2).sum(1)).astype(np.float32)
    words = ref.quantize_pack_with_uniforms(
        torch.from_numpy(x), r, torch.from_numpy(u), torch.from_numpy(norm))
    assert words.shape == (ROWS, -(-n // 32) * (1 + r))
    for row in range(ROWS):
        want = jqr_pack.quantize_pack_with_uniforms(
            jnp.asarray(x[row]), r, jnp.asarray(u[row]), jnp.float32(norm[row]),
            interpret=True)
        np.testing.assert_array_equal(_bits(words[row]), _bits(want))


def test_quantize_pack_is_codes_then_pack():
    x, u = _x(ROWS, 1030, 7), _u(ROWS, 1030, 8)
    tx, tu = torch.from_numpy(x), torch.from_numpy(u)
    norm = ref.l2_norm(tx)
    codes = ref.qr_codes_with_uniforms(tx, 4, tu, norm)
    assert torch.equal(ref.quantize_pack_with_uniforms(tx, 4, tu, norm),
                       ref.pack_codes(codes, 5))
    for row in range(ROWS):
        want = jref.qr_codes_with_uniforms(
            jnp.asarray(x[row]), 4, jnp.asarray(u[row]), jnp.float32(norm[row]))
        np.testing.assert_array_equal(_bits(codes[row]), _bits(want))


@pytest.mark.parametrize("r", [1, 4])
def test_quantize_pack_saturates_and_zero_norm(r):
    x = np.zeros((ROWS, 64), np.float32)
    x[0, 5] = -10.0                               # one dominant coordinate
    u = np.zeros((ROWS, 64), np.float32)          # row 1 is all zero: norm 0
    norm = np.sqrt((x ** 2).sum(1)).astype(np.float32)
    words = ref.quantize_pack_with_uniforms(
        torch.from_numpy(x), r, torch.from_numpy(u), torch.from_numpy(norm))
    codes = ref.unpack_codes(words, 1 + r, 64)
    assert int(codes[0, 5]) == (1 << r) | (2 ** r - 1)   # sign + top level
    assert int(codes[0].count_nonzero()) == 1
    assert int(words[1].count_nonzero()) == 0
    for row in range(ROWS):
        want = jqr_pack.quantize_pack_with_uniforms(
            jnp.asarray(x[row]), r, jnp.asarray(u[row]), jnp.float32(norm[row]),
            interpret=True)
        np.testing.assert_array_equal(_bits(words[row]), _bits(want))


def _slots_match_pallas(x: np.ndarray, k: int, cap: int):
    """The port's plain TopK slots against the reference's radix threshold
    + Pallas compaction, row by row; returns the port's slots."""
    idx, vals, nnz = ref.topk_slots(torch.from_numpy(x), k, cap)
    assert idx.dtype == torch.int32 and idx.shape == (x.shape[0], cap)
    for row in range(x.shape[0]):
        xr = jnp.asarray(x[row])
        t = jtopk.threshold_bits(xr, k, interpret=True)
        want_idx, want_vals = jsel.compact_slots(xr, t, cap, interpret=True)
        np.testing.assert_array_equal(_bits(idx[row]), _bits(want_idx))
        np.testing.assert_array_equal(_bits(vals[row]), _bits(want_vals))
        bits = np.abs(x[row]).view(np.int32)
        support = (bits >= np.int64(np.asarray(t))) & (bits != 0)
        assert int(nnz[row]) == int(support.sum())
    return idx, vals, nnz


@pytest.mark.parametrize("n", SIZES)
def test_compact_slots_match_pallas(n):
    x = _x(ROWS, n, n + 2)
    for k in sorted({1, max(1, n // 10), max(1, n // 2), n}):
        _slots_match_pallas(x, k, k)


@pytest.mark.parametrize("cap_delta", [-1, 0, 1])
def test_compact_slots_tie_overflow_keeps_lowest_cap(cap_delta):
    x = np.ones((ROWS, 50), np.float32)           # 50-way tie
    x[1, ::2] = -1.0
    idx, _, nnz = _slots_match_pallas(x, 10, 10 + cap_delta)
    assert torch.equal(idx[0], torch.arange(10 + cap_delta, dtype=torch.int32))
    assert nnz.tolist() == [50, 50]               # accounting sees every tie


def test_compact_slots_underfull_support_sentinels():
    x = np.zeros((ROWS, 100), np.float32)
    x[0, 7], x[0, 42] = 3.0, -1.5
    x[1, 99] = -0.0
    idx, vals, nnz = _slots_match_pallas(x, 10, 10)
    assert idx[0, :2].tolist() == [7, 42] and (idx[0, 2:] == 100).all()
    assert (vals[0, 2:] == 0).all() and (idx[1] == 100).all()
    assert nnz.tolist() == [2, 0]


def test_compact_slots_cap_beyond_block_boundary():
    _slots_match_pallas(_x(ROWS, 4000, 11), 300, 300)
    _slots_match_pallas(_x(ROWS, 4096, 12), 1100, 1100)


def test_compact_slots_keeps_bf16_values():
    x = torch.from_numpy(_x(ROWS, 500, 3)).to(torch.bfloat16)
    idx, vals, nnz = ref.topk_slots(x, 50, 50)
    assert vals.dtype == torch.bfloat16
    assert torch.equal(vals, torch.gather(x, 1, idx.long()))
    masked = ref.topk_mask(x, 50)
    assert torch.equal(nnz, (masked != 0).sum(1).to(torch.int32))


# --------------------------------------------------------------------------- #
# codecs: wire.encode on stacked trees against jax.vmap(wire.encode)
# --------------------------------------------------------------------------- #

S = 3
SHAPES = {"fc0": {"w": (784, 16), "b": (16,)},
          "fc1": {"w": (16, 16), "b": (16,)},
          "fc2": {"w": (16, 10), "b": (10,)}}


def _stacked_tree(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {name: {leaf: rng.standard_normal((S,) + shape).astype(np.float32)
                   for leaf, shape in leaves.items()}
            for name, leaves in SHAPES.items()}


CODECS = {
    "topk": (lambda: jcomp.TopK(0.3), lambda: compress.TopK(0.3)),
    "qr6": (lambda: jcomp.QuantQr(6), lambda: compress.QuantQr(6)),
    "qr8": (lambda: jcomp.QuantQr(8), lambda: compress.QuantQr(8)),
    "id": (jcomp.Identity, compress.Identity),
}


def _encode_both(name, seed):
    jc, tc = CODECS[name]
    tree_np = _stacked_tree(seed)
    jkeys = jax.random.split(jax.random.PRNGKey(seed), S)
    tkeys = torch.from_numpy(np.asarray(jkeys).astype(np.int64))
    jp, jrep = jax.vmap(lambda t, k: jwire.encode(jc(), t, k))(
        jax.tree.map(jnp.asarray, tree_np), jkeys)
    tstacked = convert.params_from_jax(tree_np, "cpu")
    tp, trep = wire.encode(tc(), tstacked, tkeys)
    return tree_np, tstacked, tkeys, (jp, jrep), (tp, trep)


def _assert_reports_equal(jrep, trep):
    for field in ("value_bits", "index_bits", "meta_bits", "total_bits"):
        want = np.broadcast_to(np.asarray(getattr(jrep, field), np.float32), (S,))
        got = getattr(trep, field).numpy()
        assert got.dtype == np.float32 and got.shape == (S,)
        np.testing.assert_array_equal(got, want, err_msg=field)


@pytest.mark.parametrize("name", sorted(CODECS))
def test_encode_matches_vmapped_reference(interpret_backend, name):
    tree_np, tstacked, tkeys, (jp, jrep), (tp, trep) = _encode_both(name, 5)
    assert tp.spec.codec == jp.spec.codec
    assert tp.spec.caps == jp.spec.caps and tp.spec.r == jp.spec.r
    one_client = tree_util.map(lambda a: a[0], tstacked)
    assert tp.nbytes == jp.nbytes == wire.payload_nbytes(CODECS[name][1](),
                                                         one_client)
    _assert_reports_equal(jrep, trep)
    leaf_keys = prng.split(tkeys, len(tp.data))
    for j, (jbufs, tbufs, x) in enumerate(zip(jp.data, tp.data,
                                              jax.tree.leaves(tree_np))):
        assert len(jbufs) == len(tbufs)
        if tp.spec.codec != "qr":
            for a, b in zip(jbufs, tbufs):
                assert b.shape == a.shape
                np.testing.assert_array_equal(_bits(b), _bits(a))
            continue
        # the norms come from XLA's and torch's float32 sums, which may
        # differ in the last place: the words are bit-equal where the norms
        # are, and bit-equal to the reference's given the reference's norm
        (jw, jn), (tw, tn) = jbufs, tbufs
        jn = np.array(jn)
        np.testing.assert_allclose(tn.numpy(), jn, rtol=1e-6)
        for c in range(S):
            if jn[c] == tn[c].numpy():
                np.testing.assert_array_equal(_bits(tw[c]), _bits(jw[c]))
        xr = torch.from_numpy(x.reshape(S, -1))
        u = prng.uniform(leaf_keys[:, j], xr.shape[1])
        words = ref.quantize_pack_with_uniforms(xr, tp.spec.r, u,
                                                torch.from_numpy(jn))
        np.testing.assert_array_equal(_bits(words), _bits(jw))


@pytest.mark.parametrize("name", sorted(CODECS))
def test_decode_equals_the_account_transform(interpret_backend, name):
    """decode(encode(x)) is the transform's output bit for bit, except
    where a Q_r code saturates at the top level."""
    _, tstacked, tkeys, (jp, _), (tp, _) = _encode_both(name, 9)
    comp = CODECS[name][1]()
    want, _ = comp.compress(tstacked, tkeys)
    got = wire.decode(tp)
    jgot = jax.vmap(jwire.decode)(jp)
    for a, b, c in zip(tree_util.leaves(want), tree_util.leaves(got),
                       jax.tree.leaves(jgot)):
        assert b.shape == a.shape and b.dtype == a.dtype
        np.testing.assert_array_equal(_bits(b), _bits(a))
        if name in ("topk", "id"):
            np.testing.assert_array_equal(_bits(b), _bits(c))


def test_decode_saturates_the_top_level():
    tstacked = convert.params_from_jax(
        {"w": np.zeros((S, 40), np.float32)}, "cpu")
    tstacked["w"][:, 3] = 5.0                     # all energy in one entry
    keys = prng.split(prng.PRNGKey(0), S)
    p, _ = wire.encode(compress.QuantQr(4), tstacked, keys)
    got = wire.decode(p)["w"]
    want, _ = compress.QuantQr(4).compress(tstacked, keys)
    assert torch.equal(want["w"][:, 3], torch.full((S,), 5.0))
    assert torch.equal(got[:, 3], torch.full((S,), 5.0 * 15 / 16))
    got[:, 3] = want["w"][:, 3]
    assert torch.equal(got, want["w"])


@pytest.mark.parametrize("name", sorted(CODECS))
def test_padding_bits_closed_forms(interpret_backend, name):
    """measured = accounted + padding: 0 for dense and full-support TopK,
    the word padding ``(32*ceil(n/32) - n) * (1+r)`` per qr leaf."""
    tree_np, _, _, (jp, jrep), (tp, trep) = _encode_both(name, 11)
    pad = wire.padding_bits(tp, trep)
    np.testing.assert_array_equal(
        pad.numpy(), np.broadcast_to(np.asarray(jwire.padding_bits(jp, jrep),
                                                np.float32), (S,)))
    sizes = [int(np.prod(shp)) for shp in tp.spec.shapes]
    expected = (sum((32 * -(-n // 32) - n) * (1 + tp.spec.r) for n in sizes)
                if tp.spec.codec == "qr" else 0.0)
    assert (pad == expected).all()
    assert wire.measured_bits(tp) == tp.nbytes * 8


def test_topk_underfull_payload_pads_empty_slots():
    tree_np = _stacked_tree(3)
    tree_np["fc1"]["w"][0, :, :] = 0.0
    tree_np["fc1"]["w"][0, 0, :4] = 1.0           # 4 survivors of cap 77
    tstacked = convert.params_from_jax(tree_np, "cpu")
    p, rep = wire.encode(compress.TopK(0.3), tstacked)
    leaf = [i for i, shp in enumerate(p.spec.shapes) if shp == (16, 16)][0]
    idx, _ = p.data[leaf]
    cap = p.spec.caps[leaf]
    assert (idx[0, 4:] == 256).all()
    pad = wire.padding_bits(p, rep)
    assert float(pad[0]) == (cap - 4) * (32 + 32) and float(pad[1]) == 0.0


# --------------------------------------------------------------------------- #
# validation
# --------------------------------------------------------------------------- #

def _unchecked(cls, **fields):
    """A compressor instance with fields its constructor refuses (what a
    config for the reference would hold)."""
    obj = object.__new__(cls)
    for k, v in fields.items():
        object.__setattr__(obj, k, v)
    return obj


def test_quantile_topk_has_no_wire_codec():
    comp = _unchecked(compress.TopK, density=0.3, scope="tensor",
                      impl="quantile")
    with pytest.raises(ValueError, match="exact-k"):
        wire.check_supported(comp)
    with pytest.raises(ValueError, match="r <="):
        wire.check_supported(compress.QuantQr(17))
    with pytest.raises(ValueError, match="no wire codec"):
        wire.check_supported(object())


def _plan_with_overrides():
    return clients.RoundPlan(
        steps=torch.ones(S, dtype=torch.int64),
        participating=torch.ones(S, dtype=torch.bool),
        speed=torch.ones(S), bandwidth=torch.ones(S),
        comp_overrides={"magnitude_bits": torch.full((S,), 4)})


# the compose (topk_qr) and int8 codecs and the global scope are ported:
# the global codecs resolve to the reference's codec names, and Int8Sync
# with per-client overrides raises the reference's TypeError (its
# compress takes no override)
@pytest.mark.parametrize("call,want", [
    (lambda: wire.check_supported(compress.Compose(
        compress.TopK(0.3, scope="global"),
        compress.QuantQr(4, scope="global"))), "topk_qr"),
    (lambda: clients.batched_compress(
        compress.Int8Sync(), _plan_with_overrides(),
        convert.params_from_jax(_stacked_tree(0), "cpu"),
        prng.split(prng.PRNGKey(0), S)), TypeError),
    (lambda: wire.check_supported(compress.TopK(0.3, scope="global")),
     "topk"),
    (lambda: wire.check_supported(compress.QuantQr(4, scope="global")),
     "qr")],
    ids=["compose", "int8sync", "topk_global", "qr_global"])
def test_unported_codecs_raise(call, want):
    if isinstance(want, str):
        assert call() == want
    else:
        with pytest.raises(want):
            call()


def test_wire_modes_validate():
    assert engine.validate_wire(None, None) == "account"
    assert engine.validate_wire("packed", compress.TopK(0.3)) == "packed"
    with pytest.raises(ValueError, match="wire must be"):
        engine.validate_wire("bogus", None)
    with pytest.raises(ValueError):
        wire.encode(compress.QuantQr(4), convert.params_from_jax(
            _stacked_tree(0), "cpu"))


# --------------------------------------------------------------------------- #
# rounds
# --------------------------------------------------------------------------- #

LOSS_RTOL, LOSS_ATOL, PARAM_ATOL = 1e-4, 1e-6, 1e-5
HIDDEN, N_CLIENTS, COHORT, BATCH, P, ROUNDS = 16, 6, 3, 8, 0.25, 3
COUNTED = ("num_local_steps", "uplink_bits", "downlink_bits", "client_steps",
           "client_uplink_bits", "client_finish", "sim_time",
           "client_staleness", "clients_aggregated", "uplink_payload_bytes",
           "client_payload_bytes")
ROUND_COMPRESSORS = {
    "topk": (lambda: jcomp.TopK(0.3), lambda: compress.TopK(0.3)),
    "qr6": (lambda: jcomp.QuantQr(6), lambda: compress.QuantQr(6)),
    "qr8": (lambda: jcomp.QuantQr(8), lambda: compress.QuantQr(8)),
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
    return cls(gamma=0.1, p=P, n_clients=N_CLIENTS, clients_per_round=COHORT,
               batch_size=BATCH, variant=variant)


def _port(setup, variant, comp, wire_mode):
    return FedComLoc(small.cross_entropy_loss(setup["tm"].apply),
                     setup["tdata"], _config(FedComLocConfig, variant),
                     ROUND_COMPRESSORS[comp][1](), wire=wire_mode)


@pytest.mark.parametrize("variant,comp", [
    ("com", "topk"), ("com", "qr6"), ("none", "id"), ("local", "topk"),
    ("global", "qr6")])
def test_packed_rounds_equal_account_rounds(setup, variant, comp):
    p0 = convert.params_from_jax(setup["p0"], "cpu")
    out = {}
    for mode in ("account", "packed"):
        alg = _port(setup, variant, comp, mode)
        out[mode] = alg.run_rounds(alg.init(p0), prng.PRNGKey(7), ROUNDS)
    (sa, ma), (sp, mp) = out["account"], out["packed"]
    for a, b in zip(tree_util.leaves(sa.x) + tree_util.leaves(sa.h),
                    tree_util.leaves(sp.x) + tree_util.leaves(sp.h)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6, atol=1e-7)
    for key in ("uplink_bits", "downlink_bits", "client_uplink_bits",
                "sim_time", "clients_aggregated"):
        np.testing.assert_array_equal(mp[key], ma[key], err_msg=key)
    assert set(mp) - set(ma) == {"uplink_payload_bytes", "client_payload_bytes"}
    assert (mp["uplink_payload_bytes"] * 8 >= mp["uplink_bits"]).all()
    np.testing.assert_array_equal(mp["uplink_payload_bytes"],
                                  mp["client_payload_bytes"].sum(1))


@pytest.mark.parametrize("variant,comp", [
    ("com", "topk"), ("com", "qr8"), ("none", "id"), ("local", "qr6")])
def test_packed_rounds_match_reference(setup, variant, comp):
    jc, _ = ROUND_COMPRESSORS[comp]
    ja = JFedComLoc(jsmall.cross_entropy_loss(setup["jm"].apply),
                    setup["jdata"], _config(JConfig, variant), jc(),
                    wire="packed")
    ta = _port(setup, variant, comp, "packed")
    js = ja.init(jax.tree.map(jnp.asarray, setup["p0"]))
    ts = ta.init(convert.params_from_jax(setup["p0"], "cpu"))
    jkey, tkey = jax.random.PRNGKey(1), prng.PRNGKey(1)
    for _ in range(ROUNDS):
        jkey, jsub = jax.random.split(jkey)
        tkey, tsub = prng.split(tkey, 2)
        jc_, _ = ja.sched.sample_cohort(jax.random.split(jsub, 5)[0], COHORT)
        tc_, _ = ta.sched.sample_cohort(prng.split(tsub, 5)[0], COHORT)
        np.testing.assert_array_equal(tc_.numpy(), np.asarray(jc_))
        js, jmet = ja.round(js, jsub)
        ts, tmet = ta.round(ts, tsub)
        assert set(jmet) == set(tmet)
        for name in COUNTED:
            np.testing.assert_array_equal(np.asarray(tmet[name]),
                                          np.asarray(jmet[name]), err_msg=name)
        np.testing.assert_allclose(tmet["train_loss"], jmet["train_loss"],
                                   rtol=LOSS_RTOL, atol=LOSS_ATOL)
        for a, b in zip(jax.tree.leaves(js.x),
                        tree_util.leaves(convert.params_to_numpy(ts.x))):
            np.testing.assert_allclose(b, np.asarray(a), rtol=0, atol=PARAM_ATOL)
    assert ja.meter.snapshot() == ta.meter.snapshot()


@pytest.mark.parametrize("comp", ["topk", "qr8"])
def test_run_federated_packed_matches_reference(setup, comp):
    jc, _ = ROUND_COMPRESSORS[comp]
    ja = JFedComLoc(jsmall.cross_entropy_loss(setup["jm"].apply),
                    setup["jdata"], _config(JConfig, "com"), jc())
    ta = _port(setup, "com", comp, "account")
    ds = setup["ds"]
    jeval = jserver.make_eval_fn(setup["jm"].apply, jnp.asarray(ds.x_test),
                                 jnp.asarray(ds.y_test))
    teval = server.make_eval_fn(setup["tm"].apply, torch.from_numpy(ds.x_test),
                                torch.from_numpy(ds.y_test))
    jh = jserver.run_federated(ja, jax.tree.map(jnp.asarray, setup["p0"]), 4,
                               jax.random.PRNGKey(1), jeval, eval_every=2,
                               wire="packed")
    th = server.run_federated(ta, convert.params_from_jax(setup["p0"], "cpu"),
                              4, prng.PRNGKey(1), teval, eval_every=2,
                              wire="packed")
    assert ta.wire == ja.wire == "packed"
    assert th.rounds == jh.rounds == [1, 3, 4]
    for name in ("uplink_bits", "downlink_bits", "total_bits", "sim_time"):
        assert getattr(th, name) == getattr(jh, name), name
    np.testing.assert_allclose(th.train_loss, jh.train_loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(th.test_acc, jh.test_acc, atol=2 / 512)
    for a, b in zip(jax.tree.leaves(jh.final_params),
                    tree_util.leaves(convert.params_to_numpy(th.final_params))):
        np.testing.assert_allclose(b, np.asarray(a), rtol=0, atol=PARAM_ATOL)


def test_packed_cpu_run_leaves_every_launch_counter_at_zero(setup):
    ops.reset_launch_counts()
    for comp in ("topk", "qr8"):
        alg = _port(setup, "com", comp, "packed")
        alg.run_rounds(alg.init(convert.params_from_jax(setup["p0"], "cpu")),
                       prng.PRNGKey(0), 2)
    counts = ops.launch_counts()
    assert len(counts) == 19 and all(v == 0 for v in counts.values()), counts
