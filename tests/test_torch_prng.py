"""The port's threefry PRNG against ``jax.random``, bit for bit."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # xdist workers share the cores: no spinning OpenMP pools

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro_torch import prng  # noqa: E402


@pytest.fixture(autouse=True)
def _partitionable_threefry():
    """The port reproduces jax's partitionable threefry stream (the
    default since jax 0.5); pin it whatever the ambient config says."""
    with jax.threefry_partitionable(True):
        yield


SEEDS = [0, 1, 7, 42, 123456789, 2 ** 31 - 1, 2 ** 32 - 1, -1]


def _kd(key) -> np.ndarray:
    return np.asarray(jax.random.key_data(key)).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_matches(seed):
    np.testing.assert_array_equal(prng.PRNGKey(seed).numpy(),
                                  _kd(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [2, 3, 5, 17])
def test_split_matches(seed, num):
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(prng.split(prng.PRNGKey(seed), num).numpy(),
                                  _kd(jax.random.split(key, num)))


def test_split_batches_over_leading_key_axes():
    keys = jax.random.split(jax.random.PRNGKey(3), 6).reshape(2, 3, 2)
    got = prng.split(prng.key_data(np.asarray(keys)), 4).numpy()
    assert got.shape == (2, 3, 4, 2)
    for i in range(2):
        for j in range(3):
            np.testing.assert_array_equal(
                got[i, j], _kd(jax.random.split(keys[i, j], 4)))


def test_key_chain_of_many_rounds_matches():
    """The engine's ``key, sub = split(key)`` chain, 50 rounds deep, and
    the round's 5-way split of every ``sub``."""
    jk, tk = jax.random.PRNGKey(1), prng.PRNGKey(1)
    for _ in range(50):
        jk, jsub = jax.random.split(jk)
        tk, tsub = prng.split(tk, 2)
        np.testing.assert_array_equal(prng.split(tsub, 5).numpy(),
                                      _kd(jax.random.split(jsub, 5)))
    np.testing.assert_array_equal(tk.numpy(), _kd(jk))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [1, 5, 1000, 4099])
def test_bits_match(seed, n):
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(prng.bits(prng.PRNGKey(seed), n).numpy(),
                                  np.asarray(jax.random.bits(key, (n,))))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [1, 10, 4096, 50176])
def test_uniform_matches_bitwise(seed, n):
    key = jax.random.PRNGKey(seed)
    got = prng.uniform(prng.PRNGKey(seed), n).numpy()
    want = np.asarray(jax.random.uniform(key, (n,)))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_uniform_batched_keys_match_per_key_draws():
    keys = jax.random.split(jax.random.PRNGKey(9), 5)
    got = prng.uniform(prng.key_data(np.asarray(keys)), 333).numpy()
    for i in range(5):
        want = np.asarray(jax.random.uniform(keys[i], (333,)))
        np.testing.assert_array_equal(got[i].view(np.uint32),
                                      want.view(np.uint32))


@pytest.mark.parametrize("seed", SEEDS[:5])
@pytest.mark.parametrize("span", [1, 2, 7, 100, 65535, 65536, 65537, 70000,
                                  2 ** 20 + 3, 2 ** 31 - 1])
def test_randint_matches_including_uint32_wrap(seed, span):
    """Spans above 2**16 make jax's multiplier square wrap in uint32."""
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax.random.randint(key, (257,), 0, span))
    got = prng.randint(prng.PRNGKey(seed), 257, 0, span).numpy()
    np.testing.assert_array_equal(got, want)


def test_randint_per_key_spans_and_empty_span():
    keys = jax.random.split(jax.random.PRNGKey(5), 4)
    spans = np.array([1, 37, 70000, 0])          # 0: maxval <= minval
    got = prng.randint(prng.key_data(np.asarray(keys)), 64, 0,
                       torch.from_numpy(spans)).numpy()
    for i in range(4):
        want = np.asarray(jax.random.randint(keys[i], (64,), 0,
                                             jnp.maximum(spans[i], 0)))
        np.testing.assert_array_equal(got[i], want)
    assert (got[3] == 0).all()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n,s", [(6, 3), (20, 5), (100, 10), (100, 100),
                                 (2000, 7)])
def test_choice_without_replacement_matches(seed, n, s):
    """n = 2000 needs two rounds of jax's sort-based shuffle."""
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax.random.choice(key, n, (s,), replace=False))
    np.testing.assert_array_equal(prng.choice(prng.PRNGKey(seed), n, s).numpy(),
                                  want)


@pytest.mark.parametrize("n", [1, 8, 1000, 1700])
def test_permutation_matches(n):
    key = jax.random.PRNGKey(11)
    np.testing.assert_array_equal(prng.permutation(prng.PRNGKey(11), n).numpy(),
                                  np.asarray(jax.random.permutation(key, n)))


def test_choice_validates():
    with pytest.raises(ValueError):
        prng.choice(prng.PRNGKey(0), 3, 4)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        prng.choice(prng.PRNGKey(0), 3, 2, replace=True)


@pytest.mark.parametrize("seed,shape", [(0, (64, 32)), (3, (1000,)),
                                        (2 ** 31 - 1, (7, 11, 13))])
def test_normal_matches_jax(seed, shape):
    """Parameter init draws these: jax's erf_inv route, bit for bit."""
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
    got = prng.normal(prng.PRNGKey(seed), shape).numpy()
    assert got.shape == shape and got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_normal_batches_over_leading_key_axes():
    keys = jax.random.split(jax.random.PRNGKey(4), 3)
    got = prng.normal(prng.key_data(np.asarray(keys)), (5, 6)).numpy()
    assert got.shape == (3, 5, 6)
    for i in range(3):
        want = np.asarray(jax.random.normal(keys[i], (5, 6)))
        np.testing.assert_array_equal(got[i].view(np.int32),
                                      want.view(np.int32))


# --------------------------------------------------------------------------- #
# gumbel and categorical (the serve's temperature sampling)
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("seed", [0, 3, 99])
def test_gumbel_matches_jax(seed):
    """Same uniforms bit for bit (jax's "low" mode: u in [tiny, 1)) and
    XLA's own log (``prng.xla_log``): bit for bit."""
    shape = (3, 1000)
    got = prng.gumbel(prng.PRNGKey(seed), shape).numpy()
    want = np.asarray(jax.random.gumbel(jax.random.PRNGKey(seed), shape))
    assert got.shape == shape and got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _mismatches(a, b) -> int:
    return int((np.asarray(a).view(np.int32) != np.asarray(b).view(np.int32))
               .sum())


# normal's mismatches against jax in 2^16 draws, and its largest gap: both
# 0 since normal follows XLA's own erf_inv (before that, with torch.erfinv:
# up to 38897 draws of a seed, max |d| 2.17e-5)
NORMAL_MISMATCH_BOUND = 0
NORMAL_MAX_ABS = 0.0


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_draws_mismatch_counts_against_jax(seed):
    """Counts the draws that differ from ``jax.random`` in 2^16: gumbel's
    and normal's must be none."""
    n = 1 << 16
    key = jax.random.PRNGKey(seed)
    assert _mismatches(prng.gumbel(prng.PRNGKey(seed), (n,)).numpy(),
                       jax.random.gumbel(key, (n,))) == 0
    want = np.asarray(jax.random.normal(key, (n,)))
    got = prng.normal(prng.PRNGKey(seed), (n,)).numpy()
    assert _mismatches(got, want) <= NORMAL_MISMATCH_BOUND
    assert float(np.abs(got - want).max()) <= NORMAL_MAX_ABS


_LO = np.nextafter(np.float32(-1.0), np.float32(0.0))


@jax.jit
def _jax_normal_of_uniform(f):
    """What ``jax.random.normal`` does with its uniforms ``f`` in [0, 1)."""
    u = jnp.maximum(_LO, f * jnp.float32(2.0) + _LO)
    return jnp.float32(np.sqrt(2)) * jax.lax.erf_inv(u)


@pytest.mark.parametrize("part", range(4))
def test_xla_log1p_and_normal_match_jax_on_every_normal_uniform(part):
    """Every float32 uniform normal can draw (2^23 of them, in four parts):
    ``prng.xla_log1p(-u*u)`` equals ``jnp.log1p`` and the normal equals
    jax's bit for bit (``sqrt(2)·torch.erfinv`` differed in 38566 to 38897
    of 2^16 draws a seed)."""
    k = np.arange(part << 21, (part + 1) << 21, dtype=np.uint32)
    f = (k | 0x3F800000).view(np.float32) - np.float32(1.0)
    u = np.maximum(_LO, f * np.float32(2.0) + _LO).astype(np.float32)
    t = (u * -u).astype(np.float32)
    assert _mismatches(prng.xla_log1p(torch.from_numpy(t)).numpy(),
                       jnp.log1p(jnp.asarray(t))) == 0
    assert _mismatches(prng.normal_from_uniform(torch.from_numpy(f)).numpy(),
                       _jax_normal_of_uniform(jnp.asarray(f))) == 0


@pytest.mark.parametrize("seed", [0, 7])
def test_mlp_init_matches_jax_bit_for_bit(seed):
    """The port's MLP init (He-normal weights, zero biases) equals
    ``repro.models.small``'s, leaf by leaf."""
    from repro.models import small as jsmall
    from repro_torch import tree as tree_util
    from repro_torch.models import small

    jp = jsmall.MLP(784, 64, 10).init(jax.random.PRNGKey(seed))
    tp = small.MLP(784, 64, 10).init(prng.PRNGKey(seed), device="cpu")
    for a, b in zip(jax.tree.leaves(jp), tree_util.leaves(tp)):
        assert tuple(b.shape) == a.shape and b.dtype == torch.float32
        assert _mismatches(b.numpy(), a) == 0


@pytest.mark.parametrize("part", range(4))
def test_xla_log_matches_jnp_log_on_every_gumbel_uniform(part):
    """Every float32 uniform gumbel can draw (2^23 of them, in four parts)
    and the log of its log: ``prng.xla_log`` equals ``jnp.log`` bit for
    bit (``torch.log``, correctly rounded, differs in ~14%)."""
    k = np.arange(part << 21, (part + 1) << 21, dtype=np.uint32)
    u = (k | 0x3F800000).view(np.float32) - np.float32(1.0)
    tiny = np.finfo(np.float32).tiny
    u = np.maximum(u + tiny, tiny).astype(np.float32)
    log_u = np.asarray(jnp.log(jnp.asarray(u)))
    assert _mismatches(prng.xla_log(torch.from_numpy(u)).numpy(), log_u) == 0
    w = -log_u
    assert _mismatches(prng.xla_log(torch.from_numpy(w)).numpy(),
                       jnp.log(jnp.asarray(w))) == 0


@pytest.mark.parametrize("seed", [0, 5, 12345])
def test_categorical_matches_jax(seed):
    logits = np.random.default_rng(seed).standard_normal((6, 500)).astype(
        np.float32) * 3
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax.random.categorical(key, jnp.asarray(logits),
                                             axis=-1))
    got = prng.categorical(prng.PRNGKey(seed), torch.from_numpy(logits))
    np.testing.assert_array_equal(got.numpy(), want)


def test_categorical_key_chain_of_the_serve_loop():
    """``key, sub = split(key)`` then ``categorical(sub, logits / 0.7)``,
    ten steps deep."""
    jk, tk = jax.random.PRNGKey(3), prng.PRNGKey(3)
    rng = np.random.default_rng(1)
    for _ in range(10):
        logits = rng.standard_normal((2, 300)).astype(np.float32)
        jk, jsub = jax.random.split(jk)
        tk, tsub = prng.split(tk, 2)
        want = np.asarray(jax.random.categorical(
            jsub, jnp.asarray(logits) / 0.7, axis=-1))
        got = prng.categorical(tsub, torch.from_numpy(logits) / 0.7)
        np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------------------------- #
# csrc/threefry.cuh's formulation, mirrored in numpy uint32
# --------------------------------------------------------------------------- #

_U32 = np.uint32
# key words at and above 2^31 come through the kernel as uint32
CUH_KEYS = [(0, 42), (2 ** 31, 2 ** 31 + 12345), (2 ** 32 - 1, 2 ** 32 - 1),
            (0xDEADBEEF, 0x80000000)]
# counters of the first elements and across 2^24 (n = 2^24 + 4096)
CUH_N = (1 << 24) + 4096
CUH_COUNTERS = np.concatenate([np.arange(4099), np.arange((1 << 24) - 4096,
                                                          CUH_N)]).astype(_U32)


def _funnel_rotl(v: np.ndarray, r: int) -> np.ndarray:
    """``__funnelshift_l(v, v, r)``: v's 64-bit concatenation with itself,
    shifted left by r, high word."""
    return (v << _U32(r)) | (v >> _U32(32 - r))


def _threefry_cuh(k0: int, k1: int, counters: np.ndarray):
    """threefry.cuh's threefry2x32(key, (0, i)) in numpy uint32: the key
    schedule (k2 and the five injections) taken once, then for each
    counter x0 = k0, x1 = i + k1 and four groups of rounds between the
    injections, with funnel-shift rotations; adds wrap mod 2^32."""
    ks = (_U32(k0), _U32(k1), _U32(k0) ^ _U32(k1) ^ _U32(0x1BD11BDA))
    a = [ks[(i + 1) % 3] for i in range(5)]
    rot = ((13, 15, 26, 6), (17, 29, 16, 24))
    with np.errstate(over="ignore"):
        b = [ks[(i + 2) % 3] + _U32(i + 1) for i in range(5)]
        x0 = np.full(counters.shape, ks[0], _U32)
        x1 = counters.astype(_U32) + ks[1]
        for i in range(5):
            for r in rot[i % 2]:
                x0 = x0 + x1
                x1 = _funnel_rotl(x1, r) ^ x0
            x0 = x0 + a[i]
            x1 = x1 + b[i]
    return x0, x1


def _uniform_cuh(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """threefry_uniform: ((hi ^ lo) >> 9) | 0x3F800000 as float, minus 1."""
    return (((hi ^ lo) >> _U32(9)) | _U32(0x3F800000)).view(np.float32) - \
        np.float32(1.0)


@pytest.mark.parametrize("k0,k1", CUH_KEYS)
def test_threefry_cuh_mirror_matches_jax_bits(k0, k1):
    """The kernel header's formulation gives ``jax.random.bits(key,
    (n,))`` bit for bit, key words at and above 2^31, counters across
    2^24."""
    key = jnp.asarray(np.array([k0, k1], np.uint32))
    want = np.asarray(jax.random.bits(key, (CUH_N,)))[CUH_COUNTERS]
    hi, lo = _threefry_cuh(k0, k1, CUH_COUNTERS)
    np.testing.assert_array_equal(hi ^ lo, want)
    torch_hi, torch_lo = prng.threefry2x32(
        torch.tensor(k0), torch.tensor(k1), torch.tensor(0),
        torch.from_numpy(CUH_COUNTERS.astype(np.int64)))
    np.testing.assert_array_equal(hi, torch_hi.numpy().astype(_U32))
    np.testing.assert_array_equal(lo, torch_lo.numpy().astype(_U32))


@pytest.mark.parametrize("k0,k1", CUH_KEYS)
def test_threefry_cuh_mirror_uniform_matches_jax(k0, k1):
    """threefry_uniform is ``jax.random.uniform(key, (n,))`` bit for bit,
    as ``prng.uniform`` is."""
    key = jnp.asarray(np.array([k0, k1], np.uint32))
    want = np.asarray(jax.random.uniform(key, (CUH_N,)))[CUH_COUNTERS]
    got = _uniform_cuh(*_threefry_cuh(k0, k1, CUH_COUNTERS))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(_U32), want.view(_U32))
    np.testing.assert_array_equal(
        got[:4099].view(_U32),
        prng.uniform(torch.tensor([k0, k1]), 4099).numpy().view(_U32))
