"""The packed Q_r wire's redesigned kernels on the CPU: K7's keyed entry,
K9's values entry and the lane layout both kernels share.

* ``ops.quantize_pack`` (K3 + keyed K7; on the CPU ``prng.uniform`` and
  the plain version) against the JAX package's ``ops.quantize_pack(x, r,
  key)`` with its Pallas kernels in interpret mode, bit for bit, given the
  same norm (the two norms are float32 sums in other orders).
* ``ops.unpack_qr_values`` and ``ref.qr_values(ref.unpack_codes(...))``
  against ``repro.compress.wire._qr_values`` of the Pallas
  ``unpack_codes`` in interpret mode, bit for bit (-0.0 included), on
  ``qr`` and ``topk_qr`` payloads.
* A numpy mirror of the CUDA kernels' layout (``csrc/qr_pack.cu`` and
  ``csrc/pack_codes.cu``): 1024-code tiles of 8 warps x 128-code spans, 4
  consecutive codes a lane; the register pack K7 and K8 share
  (``csrc/bitplane.cuh``: byte permutes, delta swaps and butterfly nibble
  transpose over a group's 8 lanes), and K9's per-lane reads of its
  group's words, per-plane multiply into byte-sliced accumulators and byte
  permutes, against ``ref.pack_codes``, ``ref.unpack_codes`` and
  ``ref.qr_values`` for every b in 1..32; and the mirrored pack against
  the Pallas ``pack_codes`` in interpret mode on K6-shaped (rows, cap)
  slot codes with bits set above b.
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # xdist workers share the cores: no spinning OpenMP pools

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.compress import wire as jwire  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import pack_codes as jpack  # noqa: E402
from repro_torch import compress, prng  # noqa: E402
from repro_torch.compress import wire  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import qr_pack  # noqa: E402
from repro_torch.kernels import quantize as quant  # noqa: E402


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


def _bits(a) -> np.ndarray:
    """uint32 (reference) or int32 (port) buffers, float32 values, as int32
    bit patterns."""
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int32)


# --------------------------------------------------------------------------- #
# (a) keyed K7: ops.quantize_pack against the JAX package's
# --------------------------------------------------------------------------- #

def _pack_rows(n: int, seed: int) -> np.ndarray:
    """Three rows: Gaussian with one value past the rest (its level is
    2^r at every r <= 16: saturates), Gaussian, and zeros (norm 0: every
    code 0)."""
    x = np.random.default_rng(seed).standard_normal((3, n)).astype(np.float32)
    x[0, n // 2] = 1e6
    x[2] = 0.0
    return x


@pytest.mark.parametrize("r", [1, 4, 8, 16])
@pytest.mark.parametrize("n", [1, 1000, 4099])
def test_ops_quantize_pack_matches_pallas(interpret_backend, n, r):
    """``ops.quantize_pack`` with host keys (key words at and above 2^31)
    equals the JAX package's ``ops.quantize_pack(x, r, key)`` (Pallas K3
    and K7 in interpret mode, uniforms ``jax.random.uniform(key, (n,))``)
    bit for bit: the words where the two norms are equal, and given the
    Pallas norm always (``qr_pack.quantize_pack_keyed``, the keyed entry's
    CPU path); the norms within rtol 1e-6."""
    x = _pack_rows(n, n * 17 + r)
    keys = prng.split(prng.PRNGKey(n + r), 3)
    keys[0] = torch.tensor([2 ** 31, 2 ** 31 + 12345])
    keys[1] = torch.tensor([2 ** 32 - 1, 2 ** 32 - 1])
    jkeys = jnp.asarray(keys.numpy().astype(np.uint32))
    words, norm = ops.quantize_pack(torch.from_numpy(x), r, keys)
    assert words.shape == (3, -(-n // 32) * (1 + r))
    for row in range(3):
        want, pnorm = jops.quantize_pack(jnp.asarray(x[row]), r, jkeys[row])
        np.testing.assert_allclose(norm[row].item(), float(pnorm), rtol=1e-6)
        keyed = qr_pack.quantize_pack_keyed(
            torch.from_numpy(x[row:row + 1]), r, keys[row:row + 1],
            torch.from_numpy(np.array([pnorm], np.float32)))
        np.testing.assert_array_equal(_bits(keyed[0]), _bits(want))
        if norm[row].item() == float(pnorm):
            np.testing.assert_array_equal(_bits(words[row]), _bits(want))
    # the zero row: norm 0, every code 0; the 1e6 entry saturates
    assert norm[2].item() == 0.0 and not words[2].any()
    codes = ref.unpack_codes(words, 1 + r, n)
    assert int(ref.as_u32(codes[0, n // 2])) & (2 ** r - 1) == 2 ** r - 1


def test_ops_quantize_pack_is_keyed_k7():
    """On the CPU ``ops.quantize_pack`` is the plain chain the card's two
    launches replace: K3's norm, then ``prng.uniform`` + the plain K7."""
    x = torch.from_numpy(_pack_rows(777, 5))
    keys = prng.split(prng.PRNGKey(9), 3)
    words, norm = ops.quantize_pack(x, 8, keys)
    assert torch.equal(norm, quant.l2_norm(x))
    assert torch.equal(words, ref.quantize_pack_with_uniforms(
        x, 8, prng.uniform(keys, 777), norm))


# --------------------------------------------------------------------------- #
# (b) K9's values entry: the decode against the JAX package's
# --------------------------------------------------------------------------- #

def _jax_values(words: torch.Tensor, norm: torch.Tensor, r: int, n: int):
    """``wire._qr_values(unpack_codes(...))`` of the JAX package, a row at
    a time, with its Pallas K9 in interpret mode."""
    w = words.numpy().view(np.uint32)
    return np.stack([np.asarray(jwire._qr_values(
        jpack.unpack_codes(jnp.asarray(w[row]), 1 + r, n, interpret=True),
        jnp.float32(norm[row].item()), r)) for row in range(w.shape[0])])


def _check_values(words, norm, r, n):
    want = _jax_values(words, norm, r, n)
    got = ops.unpack_qr_values(words, r, n, norm)
    plain = ref.qr_values(ref.unpack_codes(words, 1 + r, n), norm, r)
    assert got.dtype == torch.float32 and got.shape == (words.shape[0], n)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(plain), _bits(want))
    return got


@pytest.mark.parametrize("r", [1, 4, 8, 16])
def test_unpack_qr_values_signed_zero_and_norms(r):
    """Every (sign, level) pair at the level's edges, including the sign bit
    over level 0, against a positive, a zero, a NaN and an infinite norm:
    -0.0 where the norm is positive, +0.0 where it is not."""
    n = 1000
    rng = np.random.default_rng(r)
    levels = rng.integers(0, 2 ** r, (4, n), dtype=np.int64)
    levels[:, :8] = [0, 0, 1, 1, 2 ** r - 1, 2 ** r - 1, 0, 2 ** r - 1]
    sign = rng.integers(0, 2, (4, n), dtype=np.int64)
    sign[:, :8] = [0, 1, 0, 1, 0, 1, 1, 1]
    codes = ref.to_i32(torch.from_numpy((sign << r) | levels))
    words = ref.pack_codes(codes, 1 + r)
    norm = torch.tensor([1.7, 0.0, float("nan"), float("inf")])
    got = _check_values(words, norm, r, n)
    neg_zero = torch.signbit(got[0]) & (got[0] == 0)
    assert bool(neg_zero[1]) and bool(neg_zero[6])
    assert not torch.signbit(got[1]).any() and not got[1].any()
    assert not torch.signbit(got[2]).any() and not got[2].any()


@pytest.mark.parametrize("codec,comp", [
    ("qr", compress.QuantQr(8)), ("qr", compress.QuantQr(16)),
    ("topk_qr", compress.Compose(compress.TopK(0.25), compress.QuantQr(4)))])
def test_unpack_qr_values_on_payloads(codec, comp):
    """The ``qr`` and ``topk_qr`` payloads of a stacked tree (3 clients,
    leaves of 1, 33 and 1000 scalars, one a zero leaf): each leaf's words
    decode to the JAX decode's values bit for bit, and ``wire.decode``
    gives them, scattered for ``topk_qr``."""
    rng = np.random.default_rng(3)
    tree = {"a": torch.from_numpy(rng.standard_normal((3, 1000)).astype(
                np.float32)),
            "b": torch.from_numpy(rng.standard_normal((3, 33)).astype(
                np.float32)),
            "c": torch.zeros((3, 1)), "d": -torch.from_numpy(rng.random(
                (3, 4, 5)).astype(np.float32))}
    keys = prng.split(prng.PRNGKey(4), 3)
    payload, _ = wire.encode(comp, tree, keys)
    assert payload.spec.codec == codec
    r = payload.spec.r
    sizes = [1000, 33, 1, 20]
    caps = payload.spec.caps if codec == "topk_qr" else sizes
    decoded = wire.decode(payload)
    for bufs, n, cap, name in zip(payload.data, sizes, caps, "abcd"):
        words, norm = bufs[-2], bufs[-1]
        got = _check_values(words, norm, r, cap)
        if codec == "qr":
            assert torch.equal(decoded[name].reshape(3, -1), got)


# --------------------------------------------------------------------------- #
# (c) the CUDA kernels' lane layout, mirrored in numpy
# --------------------------------------------------------------------------- #

M32 = np.uint64(0xFFFFFFFF)
TILE = 1024                    # codes a tile: 8 warps x 128-code spans


def _u(v) -> np.uint64:
    return np.uint64(v)


def _byte_perm(x, y, s):
    """CUDA's ``__byte_perm(x, y, s)``: byte i of the result is byte
    ``(s >> 4i) & 7`` of the eight bytes ``y:x``."""
    x, y = np.asarray(x, np.uint64), np.asarray(y, np.uint64)
    out = np.zeros(np.broadcast(x, y).shape, np.uint64)
    for i in range(4):
        sel = (s >> (4 * i)) & 7
        out |= (((x if sel < 4 else y) >> _u(8 * (sel & 3))) & _u(0xFF)) \
            << _u(8 * i)
    return out


def _rotl(x, amt):
    amt = np.asarray(amt, np.uint64)
    return ((x << amt) | (x >> ((_u(32) - amt) % _u(32)))) & M32


def _delta_swap(x, delta, mask):
    t = (x ^ (x >> _u(delta))) & _u(mask)
    return (x ^ t ^ (t << _u(delta))) & M32


def _bytes_to_nibbles(a):
    """``qr_pack.cu``'s four delta swaps: bit 8e + s to bit 4s + e."""
    for delta, mask in ((1, 0x22222222), (2, 0x0C0C0C0C), (7, 0x00AA00AA),
                        (14, 0x0000CCCC)):
        a = _delta_swap(a, delta, mask)
    return a


def mirror_k7_pack(codes: np.ndarray, b: int) -> np.ndarray:
    """The bit-plane pack of K7 (``qr_pack_tiles``) and K8
    (``pack_tiles``), ``bitplane::pack_words`` in ``csrc/bitplane.cuh``, on
    (rows, n) uint32 codes (bits at and above b are ignored, as the kernels
    ignore them): the grid's tiles and warps as array axes, lanes as the
    last axis, each ``__shfl_xor_sync`` an index over it."""
    rows, n = codes.shape
    n32, tiles = -(-n // 32), -(-n // TILE)
    c = np.zeros((rows, tiles * TILE), np.uint64)
    c[:, :n] = codes                         # code 0 past n
    c = c.reshape(rows, tiles, 8, 32, 4)     # row, tile, warp, lane, element
    lane = np.arange(32)
    k = lane & 7
    group = (np.arange(tiles)[None, :, None, None] * 32
             + np.arange(8)[None, None, :, None] * 4 + (lane >> 3))
    row = np.broadcast_to(np.arange(rows)[:, None, None, None],
                          (rows, tiles, 8, 32))
    words = np.zeros((rows, n32 * b), np.uint64)
    for j in range(4):
        if 8 * j >= b:
            break
        sel = j | (4 + j) << 4
        a = _byte_perm(_byte_perm(c[..., 0], c[..., 1], sel),
                       _byte_perm(c[..., 2], c[..., 3], sel), 0x5410)
        a = _bytes_to_nibbles(a)
        for d, low in ((4, 0x0000FFFF), (2, 0x00FF00FF), (1, 0x0F0F0F0F)):
            sent = _rotl(a, np.where(k & d, 4 * d, 32 - 4 * d))
            got = sent[..., lane ^ d]
            keep = np.where(k & d, ~_u(low) & M32, _u(low))
            a = (a & keep) | (got & ~keep & M32)
        t = 8 * j + k
        ok = np.broadcast_to((t < b) & (group < n32), a.shape)
        at = np.broadcast_to(group * b + t, a.shape)
        words[row[ok], at[ok]] = a[ok]
    return words


def mirror_k9_unpack(words: np.ndarray, b: int, n: int, norm=None):
    """K9 (``unpack_tiles``) on (rows, ceil(n/32) * b) words: per tile,
    each lane's reads of its group's b words, per-plane multiply and byte
    permutes.  With ``norm``, the values entry (r = b - 1) in float32."""
    rows = words.shape[0]
    n32, tiles = -(-n // 32), -(-n // TILE)
    out = np.zeros((rows, n), np.uint64 if norm is None else np.float32)
    warp, lane = np.arange(8)[:, None], np.arange(32)[None, :]
    gl, shift = 4 * warp + (lane >> 3), (4 * (lane & 7)).astype(np.uint64)
    for r_ in range(rows):
        wrow = words[r_].astype(np.uint64)
        for tile in range(tiles):
            e0 = tile * TILE + 128 * warp + 4 * lane
            live = e0 < n
            acc = [np.zeros((8, 32), np.uint64) for _ in range(4)]
            for t in range(b):
                at = np.where(live, (tile * 32 + gl) * b + t, 0)
                nib = (wrow[at] >> shift) & _u(0xF)
                s = t & 7
                acc[t >> 3] |= (nib * _u(0x00204081 << s)) & M32 \
                    & _u(0x01010101 << s)
            p01, q01 = (_byte_perm(acc[0], acc[1], 0x5140),
                        _byte_perm(acc[0], acc[1], 0x7362))
            p23, q23 = (_byte_perm(acc[2], acc[3], 0x5140),
                        _byte_perm(acc[2], acc[3], 0x7362))
            cs = [_byte_perm(p01, p23, 0x5410), _byte_perm(p01, p23, 0x7632),
                  _byte_perm(q01, q23, 0x5410), _byte_perm(q01, q23, 0x7632)]
            for e, c in enumerate(cs):
                ok = e0 + e < n
                if norm is None:
                    out[r_, (e0 + e)[ok]] = c[ok]
                    continue
                r = b - 1
                nr = np.float32(norm[r_])
                mag = (c & _u(2 ** r - 1)).astype(np.float32) \
                    * np.float32(2.0 ** -r)
                q = np.where((c >> _u(r)) & _u(1), -nr, nr) * mag
                v = np.where(nr > 0, q, np.float32(0.0)).astype(np.float32)
                out[r_, (e0 + e)[ok]] = v[ok]
    return out


@pytest.mark.parametrize("b", range(1, 33))
def test_lane_layout_mirror_matches_plain(b):
    """Ragged n (one code, a partial group, a partial tile, two tiles and a
    bit), three rows: the mirrored K7 pack equals ``ref.pack_codes`` and
    the mirrored K9 equals ``ref.unpack_codes``; at b <= 17 (r <= 16, the
    packed wire's widths) its values entry equals ``ref.qr_values``."""
    rng = np.random.default_rng(b)
    for n in (1, 33, 1000, 2083):
        codes = rng.integers(0, 2 ** b, (3, n), dtype=np.uint64)
        tcodes = ref.to_i32(torch.from_numpy(codes.astype(np.int64)))
        words = ref.pack_codes(tcodes, b)
        wmem = ref.as_u32(words).numpy().astype(np.uint64)
        np.testing.assert_array_equal(mirror_k7_pack(codes, b), wmem)
        np.testing.assert_array_equal(mirror_k9_unpack(wmem, b, n), codes)
        if 2 <= b <= 17:
            norm = np.array([2.5, 0.0, np.nan], np.float32)
            want = ref.qr_values(tcodes, torch.from_numpy(norm), b - 1)
            np.testing.assert_array_equal(
                _bits(mirror_k9_unpack(wmem, b, n, norm)), _bits(want))


# K6's slot-code rows as the topk_qr codec packs them: (clients, cap) with
# cap = TopK(d)._k(n) over the quickstart leaves, k25_q4 (b = 5) and
# k50_q16 (b = 17), plus other widths
K6_SLOT_ROWS = [(12544, 5), (1024, 5), (160, 5), (16, 5), (2, 5),
                (25088, 17), (2048, 17), (320, 17), (32, 17), (5, 17),
                (12544, 1), (1024, 9), (160, 32)]


@pytest.mark.parametrize("cap,b", K6_SLOT_ROWS)
def test_mirrored_pack_matches_pallas_on_slot_codes(cap, b):
    """The mirrored K7/K8 pack of (3, cap) codes with all 32 bits random
    equals the Pallas ``pack_codes`` in interpret mode, row by row (both
    ignore the bits at and above b)."""
    rng = np.random.default_rng(cap * 33 + b)
    codes = rng.integers(0, 2 ** 32, (3, cap), dtype=np.uint64)
    words = mirror_k7_pack(codes, b)
    assert words.shape == (3, -(-cap // 32) * b)
    for row in range(3):
        want = jpack.pack_codes(jnp.asarray(codes[row].astype(np.uint32)), b,
                                interpret=True)
        np.testing.assert_array_equal(words[row].astype(np.uint32),
                                      np.asarray(want))
