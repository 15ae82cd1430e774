"""The port's kernels K1-K4, K11 and K12 (their plain versions, on the
CPU) against the reference's Pallas kernels in interpret mode and its jnp
oracles; the CUDA kernels are held against the plain versions in
``test_torch_cuda.py``.

Threshold, mask and Q_r are compared bit for bit (Q_r given the same norm
and uniforms); the norm within rtol 1e-6, since float32 sums in other
orders may differ in the last bit.  The scans are time loops whose float32
sums run in other orders than XLA's: K11 (RG-LRU) is held within rtol =
atol = 3e-5 and K12 (WKV6) within 3e-4, the JAX package's own tolerances
for its kernels against its oracles (measured gaps: K11 below 1e-6, K12
below 3e-6).  bf16 r/k/v (with float32 w, as prefill passes them) are held
within one bf16 rounding of y (rtol 2^-7).
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # xdist workers share the cores: no spinning OpenMP pools

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import quantize as jquant  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import rglru_scan as jrg  # noqa: E402
from repro.kernels import topk_compress as jtopk  # noqa: E402
from repro.kernels import wkv6 as jwkv  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import quantize as quant  # noqa: E402
from repro_torch.kernels import topk_compress as topk  # noqa: E402


@pytest.fixture(autouse=True)
def _partitionable_threefry():
    """The port reproduces jax's partitionable threefry stream (the
    default since jax 0.5); pin it whatever the ambient config says."""
    with jax.threefry_partitionable(True):
        yield


NORM_RTOL = 1e-6


def _rows(seed, rows, n, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal((rows, n)).astype(dtype)


def _bits_equal(a: np.ndarray, b: np.ndarray):
    assert a.dtype == b.dtype and a.shape == b.shape
    view = np.uint16 if a.dtype.itemsize == 2 else np.uint32
    np.testing.assert_array_equal(a.view(view), b.view(view))


# --------------------------------------------------------------------------- #
# K1 threshold / K2 mask
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("n,k", [
    (128, 1), (1000, 100), (1024, 1023), (4096, 2048), (5000, 13),
    (333, 300), (50176, 15053),
])
def test_threshold_matches_jnp_oracle_and_pallas(n, k):
    x = _rows(n + k, 3, n)
    got = topk.threshold_bits(torch.from_numpy(x), k).numpy()
    for r in range(3):
        want = int(jref.topk_threshold_bits(jnp.asarray(x[r]), k))
        assert got[r] == want
    if n <= 5000:
        for r in range(3):
            assert got[r] == int(jtopk.threshold_bits(jnp.asarray(x[r]), k,
                                                      interpret=True))


@pytest.mark.parametrize("k,want", [(0, 0xFFFFFFFF), (-3, 0xFFFFFFFF),
                                    (333, 0), (1000, 0)])
def test_threshold_edge_conventions_match_pallas(k, want):
    """k <= 0 -> all-ones (empty support); k >= n -> 0 (keep everything),
    the TPU kernel's conventions."""
    x = _rows(3, 2, 333)
    got = topk.threshold_bits(torch.from_numpy(x), k).numpy()
    assert (got == want).all()
    assert int(jtopk.threshold_bits(jnp.asarray(x[0]), k,
                                    interpret=True)) == want


def test_threshold_per_row_k():
    x = _rows(4, 4, 777)
    ks = [1, 77, 776, 500]
    got = topk.threshold_bits(torch.from_numpy(x), torch.tensor(ks)).numpy()
    for r, k in enumerate(ks):
        assert got[r] == int(jref.topk_threshold_bits(jnp.asarray(x[r]), k))


@pytest.mark.parametrize("n,k", [(128, 1), (1000, 100), (1024, 1023),
                                 (333, 300), (777, 77)])
def test_mask_matches_oracle_and_pallas_batched(n, k):
    x = _rows(2 * n + k, 4, n)
    got = ops.topk_mask(torch.from_numpy(x), k).numpy()
    for r in range(4):
        _bits_equal(got[r], np.asarray(jref.topk_mask(jnp.asarray(x[r]), k)))
        _bits_equal(got[r], np.asarray(
            jtopk.topk_mask(jnp.asarray(x[r]), k, interpret=True)))


def test_mask_ties_keep_every_tie():
    x = np.asarray([1.0, -1.0, 1.0, 0.5, 2.0] * 40, np.float32)[None]
    for k, kept in ((3, 40), (50, 160)):     # the 2.0s; then every tied +-1
        got = ops.topk_mask(torch.from_numpy(x), k).numpy()[0]
        _bits_equal(got, np.asarray(jtopk.topk_mask(jnp.asarray(x[0]), k,
                                                    interpret=True)))
        assert (got != 0).sum() == kept


def test_mask_zeros_and_negative_zero():
    x = _rows(5, 2, 64)
    x[0, :10] = 0.0
    x[0, 10:20] = -0.0
    x[1] = 0.0
    for k in (5, 50, 60):
        got = ops.topk_mask(torch.from_numpy(x), k).numpy()
        for r in range(2):
            _bits_equal(got[r], np.asarray(jref.topk_mask(jnp.asarray(x[r]), k)))


def test_mask_k_at_least_n_returns_input():
    x = torch.from_numpy(_rows(6, 2, 50))
    assert ops.topk_mask(x, 50) is x
    assert ops.topk_mask(x, 51) is x


def test_mask_bf16_matches_oracle():
    x32 = _rows(7, 3, 777)
    xb = jnp.asarray(x32).astype(jnp.bfloat16)
    xt = torch.from_numpy(x32).to(torch.bfloat16)
    np.testing.assert_array_equal(xt.float().numpy(),
                                  np.asarray(xb.astype(jnp.float32)))
    got = ops.topk_mask(xt, 77)
    assert got.dtype == torch.bfloat16
    for r in range(3):
        want = np.asarray(jref.topk_mask(xb[r], 77).astype(jnp.float32))
        _bits_equal(got[r].float().numpy(), want)


def _pallas_threshold_and_mask(xr: np.ndarray, k: int):
    """The reference's K1 and K2 (Pallas, interpret mode) on one row; its
    mask cast to float32 (exact from bf16)."""
    xj = jnp.asarray(xr)
    t = int(jtopk.threshold_bits(xj, k, interpret=True))
    m = np.asarray(jtopk.topk_mask(xj, k, interpret=True).astype(jnp.float32))
    return t, m


@pytest.mark.parametrize("n,k", [
    (128, 1), (1000, 100), (777, 77), (4099, 410), (64, 0), (64, -2),
    (64, 64), (64, 90)])
def test_threshold_mask_matches_pallas(n, k):
    """K1 and K2 in one entry: the threshold bit patterns and the float32
    masked rows equal the reference's two Pallas kernels (interpret mode),
    k <= 0 (all zeros) and k >= n (the row itself) included."""
    x = _rows(3 * n + k, 3, n)
    x[0, :5] = 0.0
    x[0, 5:9] = -0.0
    thr, masked = topk.threshold_mask(torch.from_numpy(x), k)
    assert thr.dtype == torch.int64 and masked.dtype == torch.float32
    for r in range(3):
        t, m = _pallas_threshold_and_mask(x[r], k)
        assert int(thr[r]) == t
        _bits_equal(masked[r].numpy(), m)


def test_threshold_mask_per_row_k_matches_pallas():
    """A per-row k of 0, 1, n - 1, n and beyond n in one call."""
    n = 333
    x = _rows(12, 5, n)
    x[2, ::3] = 0.5                              # ties at the threshold
    ks = [0, 1, n - 1, n, n + 40]
    thr, masked = topk.threshold_mask(torch.from_numpy(x), torch.tensor(ks))
    for r, k in enumerate(ks):
        t, m = _pallas_threshold_and_mask(x[r], k)
        assert int(thr[r]) == t
        _bits_equal(masked[r].numpy(), m)


@pytest.mark.parametrize("k", [1, 77, 776, 0, 777])
def test_threshold_mask_bf16_matches_pallas(k):
    """bf16 rows: the masked rows come back in float32, bit for bit the
    reference's bf16 mask cast up; ``topk_mask`` casts them back to bf16."""
    x32 = _rows(13 + k, 3, 777)
    xt = torch.from_numpy(x32).to(torch.bfloat16)
    xb = jnp.asarray(xt.float().numpy()).astype(jnp.bfloat16)
    thr, masked = topk.threshold_mask(xt, k)
    assert masked.dtype == torch.float32
    for r in range(3):
        assert int(thr[r]) == int(jtopk.threshold_bits(xb[r], k,
                                                       interpret=True))
        want = np.asarray(jtopk.topk_mask(xb[r], k, interpret=True).astype(
            jnp.float32))
        _bits_equal(masked[r].numpy(), want)
    back = topk.topk_mask(xt, k)
    assert back.dtype == torch.bfloat16
    assert torch.equal(back.float(), masked)


# --------------------------------------------------------------------------- #
# K3 norm / K4 Q_r
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("n", [1, 10, 1000, 4099, 50176])
def test_norm_matches_within_rtol(n):
    x = _rows(n, 3, n)
    got = quant.l2_norm(torch.from_numpy(x)).numpy()
    for r in range(3):
        xf = jnp.asarray(x[r])
        np.testing.assert_allclose(got[r], float(jnp.sqrt(jnp.sum(xf * xf))),
                                   rtol=NORM_RTOL)
        if n <= 4099:
            np.testing.assert_allclose(
                got[r], float(jquant.l2_norm(xf, interpret=True)),
                rtol=NORM_RTOL)


@pytest.mark.parametrize("rows,n", [(1, 1), (5, 50176), (4, 1 << 24),
                                    (3, 8193), (65535, 10), (1, 1 << 30)])
def test_norm_partition_depends_only_on_shape(rows, n):
    """K3's blocks a row, which fix the order of its sums: one a 8192
    elements, at most 512 a row and 2112 in all (or one a row)."""
    parts = quant.norm_parts(rows, n)
    assert 1 <= parts <= 512
    assert parts == 1 or rows * parts <= 132 * 16
    assert parts <= -(-n // 8192)
    assert parts == quant.norm_parts(rows, n)


@pytest.mark.parametrize("n,r", [(1000, 1), (1000, 4), (4099, 8), (128, 8),
                                 (10, 1)])
def test_qr_bit_exact_given_norm_and_uniforms(n, r):
    x = _rows(n * r, 3, n)
    x[0, :5] = 0.0
    x[0, 5] = -0.0
    u = np.random.default_rng(n + r).random((3, n)).astype(np.float32)
    for row in range(3):
        xj, uj = jnp.asarray(x[row]), jnp.asarray(u[row])
        # the oracle's own norm, computed the oracle's way
        norm = np.array(jnp.sqrt(jnp.sum(xj * xj)), np.float32)
        got = quant.quantize_qr_with_uniforms(
            torch.from_numpy(x[row:row + 1]), r, torch.from_numpy(u[row:row + 1]),
            torch.from_numpy(norm.reshape(1))).numpy()[0]
        _bits_equal(got, np.asarray(jref.quantize_qr_with_uniforms(xj, r, uj)))
        # the Pallas kernel's grid-accumulated norm
        pnorm = np.array(jquant.l2_norm(xj, interpret=True), np.float32)
        got = quant.quantize_qr_with_uniforms(
            torch.from_numpy(x[row:row + 1]), r, torch.from_numpy(u[row:row + 1]),
            torch.from_numpy(pnorm.reshape(1))).numpy()[0]
        _bits_equal(got, np.asarray(jquant.quantize_qr_with_uniforms(
            xj, r, uj, interpret=True)))


def test_qr_zero_vector_is_zero():
    x = np.zeros((2, 100), np.float32)
    x[1, :3] = -0.0
    u = np.random.default_rng(0).random((2, 100)).astype(np.float32)
    xt = torch.from_numpy(x)
    out = quant.quantize_qr_with_uniforms(xt, 4, torch.from_numpy(u),
                                          quant.l2_norm(xt)).numpy()
    _bits_equal(out, np.zeros_like(x))
    _bits_equal(out[0], np.asarray(jref.quantize_qr_with_uniforms(
        jnp.asarray(x[0]), 4, jnp.asarray(u[0]))))


def test_qr_bf16_matches_oracle():
    x32 = _rows(8, 2, 513)
    xb = jnp.asarray(x32).astype(jnp.bfloat16)
    xt = torch.from_numpy(x32).to(torch.bfloat16)
    u = np.random.default_rng(8).random((2, 513)).astype(np.float32)
    for r in range(2):
        xf = xb[r].astype(jnp.float32)
        norm = np.array(jnp.sqrt(jnp.sum(xf * xf)), np.float32).reshape(1)
        got = quant.quantize_qr_with_uniforms(
            xt[r:r + 1], 4, torch.from_numpy(u[r:r + 1]), torch.from_numpy(norm))
        assert got.dtype == torch.bfloat16
        want = jref.quantize_qr_with_uniforms(xb[r], 4, jnp.asarray(u[r]))
        _bits_equal(got[0].float().numpy(),
                    np.asarray(want.astype(jnp.float32)))


def test_ops_quantize_draws_reference_uniforms():
    """ops.quantize_qr draws row i's uniforms from keys[i] exactly as
    ``jax.random.uniform`` does; given equal norms the output is the
    reference's bit for bit."""
    x = _rows(9, 3, 300)
    keys = jax.random.split(jax.random.PRNGKey(4), 3)
    got = ops.quantize_qr(torch.from_numpy(x), 8,
                          torch.from_numpy(np.asarray(keys).astype(np.int64)))
    norms = quant.l2_norm(torch.from_numpy(x)).numpy()
    for r in range(3):
        xj = jnp.asarray(x[r])
        u = jax.random.uniform(keys[r], (300,))
        if norms[r] == np.float32(jnp.sqrt(jnp.sum(xj * xj))):
            _bits_equal(got[r].numpy(),
                        np.asarray(jref.quantize_qr_with_uniforms(xj, 8, u)))
        else:
            np.testing.assert_allclose(got[r].numpy(), np.asarray(
                jref.quantize_qr_with_uniforms(xj, 8, u)), rtol=1e-5, atol=1e-6)


MLP_LEAF_SIZES = (784 * 64, 64, 64 * 64, 64, 64 * 10, 10)


@pytest.mark.parametrize("r", [1, 4, 8])
@pytest.mark.parametrize("n", MLP_LEAF_SIZES,
                         ids=["fc0_w", "fc0_b", "fc1_w", "fc1_b", "fc2_w",
                              "fc2_b"])
def test_ops_quantize_qr_matches_pallas_quantize_qr(n, r):
    """``ops.quantize_qr`` on the CPU against the reference's
    ``quantize_qr(x, r, key)`` (its K3 and K4 in interpret mode, uniforms
    from ``jax.random.uniform(key, (n,))``) at each of the quickstart MLP's
    leaf sizes.  Given the Pallas norm, the keyed K4 entry is bit for bit
    the reference's; ``ops.quantize_qr`` (the port's own norm) is too where
    the two norms are equal, and elsewhere bit for bit the plain chain fed
    its norm and JAX's uniforms; its norm is within ``NORM_RTOL``."""
    x = _rows(n + r, 2, n)
    jkeys = jax.random.split(jax.random.PRNGKey(n * r), 2)
    keys = torch.from_numpy(np.asarray(jkeys).astype(np.int64))
    got = ops.quantize_qr(torch.from_numpy(x), r, keys).numpy()
    norms = quant.l2_norm(torch.from_numpy(x)).numpy()
    for row in range(2):
        xj = jnp.asarray(x[row])
        want = np.asarray(jquant.quantize_qr(xj, r, jkeys[row], interpret=True))
        pnorm = np.float32(jquant.l2_norm(xj, interpret=True))
        np.testing.assert_allclose(norms[row], pnorm, rtol=NORM_RTOL)
        keyed = quant.quantize_qr_keyed(
            torch.from_numpy(x[row:row + 1]), r, keys[row:row + 1],
            torch.from_numpy(np.array([pnorm], np.float32))).numpy()[0]
        _bits_equal(keyed, want)
        if norms[row] == pnorm:
            _bits_equal(got[row], want)
        else:
            # the norms differ in the last bit: the composed entry is held
            # against the plain chain fed its own norm and JAX's uniforms
            u = torch.from_numpy(np.asarray(
                jax.random.uniform(jkeys[row], (n,), dtype=jnp.float32)))
            _bits_equal(got[row], ref.quantize_qr_with_uniforms(
                torch.from_numpy(x[row:row + 1]), r, u[None],
                torch.from_numpy(norms[row:row + 1])).numpy()[0])


# --------------------------------------------------------------------------- #
# dispatch and counters
# --------------------------------------------------------------------------- #

def test_cpu_tensors_take_the_plain_path_and_count_no_launch():
    ops.reset_launch_counts()
    x = torch.from_numpy(_rows(10, 3, 256))
    keys = torch.zeros((3, 2), dtype=torch.int64)
    ops.topk_mask(x, 10)
    ops.quantize_qr(x, 4, keys)
    ops.topk_slots(x, 10, 10)
    words, norm = ops.quantize_pack(x, 4, keys)
    ops.unpack_codes(words, 5, 256)
    ops.unpack_qr_values(words, 4, 256, norm)
    ops.pack_codes(torch.zeros((3, 256), dtype=torch.int32), 5)
    ops.topk_qr_slots(x, 10, 10, 4, keys)
    xs = torch.from_numpy(_rows(11, 2, 3 * 64)).reshape(2, 3, 64)
    ys, _ = ops.rglru_scan(xs.requires_grad_(), torch.sigmoid(xs))
    r4 = xs.reshape(1, 2, 3, 64)
    yw, _ = ops.wkv6_scan(r4, r4, r4, torch.sigmoid(r4), torch.zeros(2, 64))
    (ys.sum() + yw.sum()).backward()            # the two backward wrappers
    ops.mha_attention(r4, r4, r4, window=2, softcap=5.0)
    assert set(ops.launch_counts()) == {
        "topk_threshold_bits", "topk_mask", "topk_threshold_mask",
        "topk_radix_hist", "l2_norm", "sum_squares", "quantize_qr",
        "compact_slots", "compact_code_slots", "quantize_pack_with_uniforms",
        "quantize_pack_keyed", "pack_codes", "unpack_codes",
        "unpack_qr_values", "rglru_scan", "rglru_scan_bwd", "wkv6_scan",
        "wkv6_scan_bwd", "flash_attention"}
    assert all(v == 0 for v in ops.launch_counts().values())


def test_other_devices_raise():
    x = torch.empty((2, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        topk.threshold_bits(x, 2)
    with pytest.raises(ValueError, match="no kernel"):
        quant.l2_norm(x)


def test_rows_layout_is_required():
    with pytest.raises(ValueError):
        ref.topk_threshold_bits(torch.zeros(8), 2)


# --------------------------------------------------------------------------- #
# K11 RG-LRU scan
# --------------------------------------------------------------------------- #

RGLRU_TOL = 3e-5
WKV6_TOL = 3e-4


def _rglru_inputs(seed, b, t, d):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    a = (1.0 / (1.0 + np.exp(-rng.standard_normal((b, t, d))))).astype(
        np.float32)
    return x, a


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("b,t,d,bt,bd", [
    (1, 8, 128, 8, 128), (2, 64, 256, 8, 128), (3, 32, 384, 16, 128),
])
def test_rglru_plain_matches_pallas_and_oracle(b, t, d, bt, bd):
    """The JAX package's kernel-test shapes (tests/test_kernels.py)."""
    x, a = _rglru_inputs(t + d, b, t, d)
    y, h = ops.rglru_scan(torch.from_numpy(x), torch.from_numpy(a))
    yp, hp = jrg.rglru_scan(jnp.asarray(x), jnp.asarray(a), interpret=True,
                            bt=bt, bd=bd)
    yr, hr = jref.rglru_scan(jnp.asarray(x), jnp.asarray(a))
    for want_y, want_h in ((yp, hp), (yr, hr)):
        _close(y.numpy(), want_y, RGLRU_TOL)
        _close(h.numpy(), want_h, RGLRU_TOL)
    assert y.dtype == torch.float32 and h.dtype == torch.float32


@pytest.mark.parametrize("t", [1, 13, 67])
def test_rglru_plain_t1_and_ragged_match_oracle(t):
    """T = 1 and T that no Pallas block divides, against the oracle (its
    ragged T falls back to one chunk); with and without h0."""
    x, a = _rglru_inputs(t, 2, t, 96)
    h0 = np.random.default_rng(t + 1).standard_normal((2, 96)).astype(
        np.float32)
    y, h = ref.rglru_scan(torch.from_numpy(x), torch.from_numpy(a))
    yr, hr = jref.rglru_scan(jnp.asarray(x), jnp.asarray(a))
    _close(y.numpy(), yr, RGLRU_TOL)
    _close(h.numpy(), hr, RGLRU_TOL)
    y, h = ref.rglru_scan(torch.from_numpy(x), torch.from_numpy(a),
                          torch.from_numpy(h0))
    yr, hr = jref.rglru_scan(jnp.asarray(x), jnp.asarray(a), jnp.asarray(h0))
    _close(y.numpy(), yr, RGLRU_TOL)
    _close(h.numpy(), hr, RGLRU_TOL)


def test_rglru_edges_a_near_0_and_1_and_zeros():
    x, a = _rglru_inputs(5, 2, 24, 128)
    a[0, :8] = 1e-7                 # a ~ 0: h follows x
    a[0, 8:16] = 1.0 - 1e-7         # a ~ 1: h holds, sqrt(1 - a^2) ~ 0
    a[1, :4] = 1.0                  # 1 - a^2 = 0 exactly
    x[1, 4:12] = 0.0
    y, h = ops.rglru_scan(torch.from_numpy(x), torch.from_numpy(a))
    yp, hp = jrg.rglru_scan(jnp.asarray(x), jnp.asarray(a), interpret=True,
                            bt=8, bd=128)
    _close(y.numpy(), yp, RGLRU_TOL)
    _close(h.numpy(), hp, RGLRU_TOL)


# --------------------------------------------------------------------------- #
# K12 WKV6 scan
# --------------------------------------------------------------------------- #

def _wkv6_inputs(seed, b, h, t, kd=64):
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.standard_normal((b, h, t, kd)) for _ in range(3))
    w = 1.0 / (1.0 + np.exp(-rng.standard_normal((b, h, t, kd))))
    u = 0.1 * rng.standard_normal((h, kd))
    return tuple(z.astype(np.float32) for z in (r, k, v, w, u))


def _wkv6_torch(args, dtype=torch.float32):
    r, k, v, w, u = (torch.from_numpy(z) for z in args)
    return ops.wkv6_scan(r.to(dtype), k.to(dtype), v.to(dtype), w, u)


@pytest.mark.parametrize("b,h,t", [(1, 1, 16), (2, 3, 64)])
def test_wkv6_plain_matches_pallas_and_oracle(b, h, t):
    """The JAX package's kernel-test shapes (tests/test_kernels.py)."""
    args = _wkv6_inputs(b * h + t, b, h, t)
    y, s = _wkv6_torch(args)
    jargs = [jnp.asarray(z) for z in args]
    yp, sp = jwkv.wkv6_scan(*jargs, interpret=True, bt=min(16, t))
    yr, sr = jref.wkv6_scan(*jargs)
    for want_y, want_s in ((yp, sp), (yr, sr)):
        _close(y.numpy(), want_y, WKV6_TOL)
        _close(s.numpy(), want_s, WKV6_TOL)
    assert s.dtype == torch.float32 and s.shape == (b, h, 64, 64)


@pytest.mark.parametrize("t", [1, 21])
def test_wkv6_plain_t1_and_ragged_match_oracle(t):
    args = _wkv6_inputs(t, 2, 2, t)
    y, s = _wkv6_torch(args)
    yr, sr = jref.wkv6_scan(*[jnp.asarray(z) for z in args])
    _close(y.numpy(), yr, WKV6_TOL)
    _close(s.numpy(), sr, WKV6_TOL)
    s0 = np.random.default_rng(t).standard_normal((2, 2, 64, 64)).astype(
        np.float32)
    y, s = ref.wkv6_scan(*(torch.from_numpy(z) for z in args),
                         torch.from_numpy(s0))
    yr, sr = jref.wkv6_scan(*[jnp.asarray(z) for z in args], jnp.asarray(s0))
    _close(y.numpy(), yr, WKV6_TOL)
    _close(s.numpy(), sr, WKV6_TOL)


def test_wkv6_bf16_rkv_with_f32_w_matches_pallas():
    """r, k, v in bf16 and w, u in float32, as prefill passes them: y comes
    back in bf16, S_T in float32."""
    args = _wkv6_inputs(3, 2, 2, 32)
    y, s = _wkv6_torch(args, torch.bfloat16)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    r, k, v, w, u = (jnp.asarray(z) for z in args)
    bf = jnp.bfloat16
    yp, sp = jwkv.wkv6_scan(r.astype(bf), k.astype(bf), v.astype(bf), w, u,
                            interpret=True, bt=16)
    np.testing.assert_allclose(y.float().numpy(), np.asarray(yp, np.float32),
                               rtol=2 ** -7, atol=1e-6)
    _close(s.numpy(), sp, WKV6_TOL)


def test_wkv6_edges_w_near_0_and_1_and_zeros():
    args = list(_wkv6_inputs(9, 1, 2, 16))
    args[3][0, 0] = 1e-7            # forget everything each step
    args[3][0, 1] = 1.0 - 1e-7      # remember everything
    args[2][0, 0, 4:9] = 0.0        # v = 0: no new state
    y, s = _wkv6_torch(args)
    yp, sp = jwkv.wkv6_scan(*[jnp.asarray(z) for z in args], interpret=True,
                            bt=16)
    _close(y.numpy(), yp, WKV6_TOL)
    _close(s.numpy(), sp, WKV6_TOL)


# --------------------------------------------------------------------------- #
# K12's bf16 route: its chunked scheme, mirrored on the CPU
# --------------------------------------------------------------------------- #

def _bf16_parts(x):
    """x as the kernel's bf16 high and low parts (hi + lo ~= x)."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _tf32_parts(x):
    """x as the kernel's TF32 high and low parts (``cvt.rna.tf32.f32``:
    10 mantissa bits, ties away from zero)."""
    def tf32(z):
        return ((z.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)
    hi = tf32(x)
    return hi, tf32(x - hi)


def _split_mm(a, b, b_is_bf16=False):
    """a @ b as the kernel's mma.sync take it, float32 sums (the parts'
    products are exact in float32): against a bf16 b, a's bf16 parts; else
    both sides' TF32 parts, hi*hi + hi*lo + lo*hi."""
    if b_is_bf16:
        ah, al = _bf16_parts(a)
        return ah @ b + al @ b
    ah, al = _tf32_parts(a)
    bh, bl = _tf32_parts(b)
    return ah @ bh + ah @ bl + al @ bh


def _wkv6_chunked_mirror(r, k, v, w, u):
    """The bf16 route of ``csrc/wkv6.cu`` in float32 torch ops, in its
    order: chunks of ``wkv6.CHUNK`` steps; P (products of w before t), Q
    (after s) and D (the whole chunk) as running products; the diagonal
    block A by running products of the key columns; y = R~ S + A V and
    S <- diag(D) S + K~^T V with the mma's operand splits.  Test-only."""
    from repro_torch.kernels import wkv6

    b, h, t, kd = r.shape
    S = torch.zeros((b, h, kd, kd))
    ys = torch.zeros((b, h, t, kd))
    uf = u[None, :, None, :]
    for t0 in range(0, t, wkv6.CHUNK):
        tc = min(wkv6.CHUNK, t - t0)
        R, K, V, W = (z[:, :, t0:t0 + tc] for z in (r, k, v, w))
        P = torch.ones_like(R)
        for i in range(1, tc):
            P[:, :, i] = P[:, :, i - 1] * W[:, :, i - 1]
        D = P[:, :, tc - 1] * W[:, :, tc - 1]
        Q = torch.ones_like(K)
        for i in range(tc - 2, -1, -1):
            Q[:, :, i] = Q[:, :, i + 1] * W[:, :, i + 1]
        A = torch.zeros((b, h, tc, tc))
        M = torch.zeros_like(K)        # the key columns, decayed to step i
        for i in range(tc):
            A[:, :, i, :i] = torch.einsum("bhk,bhsk->bhs", R[:, :, i],
                                          M[:, :, :i])
            A[:, :, i, i] = (R[:, :, i] * uf[:, :, 0] * K[:, :, i]).sum(-1)
            M[:, :, :i] = M[:, :, :i] * W[:, :, i, None]
            M[:, :, i] = K[:, :, i]
        ys[:, :, t0:t0 + tc] = _split_mm(R * P, S) + _split_mm(A, V, True)
        S = D[..., None] * S + _split_mm((K * Q).transpose(-1, -2), V, True)
    return ys, S


@pytest.mark.parametrize("case", ["w=1e-7 T=80", "w=1-1e-7 T=80", "T=1",
                                  "T=63", "T=65", "T=77 B=2 H=3"])
def test_wkv6_chunked_scheme_matches_oracle(case):
    """The bf16 route's scheme against the JAX oracle at the JAX package's
    tolerance (3e-4), with bf16 r/k/v: decays held at 1e-7 (the products
    underflow to 0) and at 1 - 1e-7 over more than a 64-step chunk, ragged
    tails, several (b, h)."""
    shapes = {"T=1": (1, 2, 1), "T=63": (1, 2, 63), "T=65": (1, 2, 65),
              "T=77 B=2 H=3": (2, 3, 77)}
    b, h, t = shapes.get(case, (1, 2, 80))
    r, k, v, w, u = (torch.from_numpy(z) for z in _wkv6_inputs(t + 5, b, h, t))
    r, k, v = (z.to(torch.bfloat16).float() for z in (r, k, v))
    if case.startswith("w=1e-7"):
        w[:, 0] = 1e-7
    elif case.startswith("w=1-1e-7"):
        w[:, 0] = 1.0 - 1e-7
    y, s = _wkv6_chunked_mirror(r, k, v, w, u)
    yr, sr = jref.wkv6_scan(*[jnp.asarray(z.numpy()) for z in (r, k, v, w, u)])
    _close(y.numpy(), yr, WKV6_TOL)
    _close(s.numpy(), sr, WKV6_TOL)
