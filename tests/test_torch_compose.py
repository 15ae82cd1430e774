"""Double compression in the port against the reference: K6, ``Compose``,
``Int8Sync`` and the registry (the ``topk_qr``/``int8`` wire codecs are
``tests/test_torch_compose_wire.py``, which shares this file's helpers).

Kernels: the port's plain K6 (``ref.compact_code_slots``) and
``ref.topk_qr_slots`` are held bit for bit against the reference's Pallas
K6 in interpret mode and its jnp oracle (uint32 compared as bit patterns).
Units stay below 2**24, where the reference's float32 slot counts are
exact.  Transforms and codecs: the port on stacked trees against
``jax.vmap`` of the reference with the same keys.  Q_r levels, slot
indices, packed words and int8 levels are compared bit for bit; the norms
(torch's and XLA's float32 sums, which may differ in the last place)
within ``NORM_RTOL``, and values rebuilt from them within ``VALUE_RTOL``.
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # xdist workers share the cores: no spinning OpenMP pools

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import compress as jcomp  # noqa: E402
from repro.compress import registry as jregistry  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import select_slots as jsel  # noqa: E402
from repro.kernels import topk_compress as jtopk  # noqa: E402
from repro_torch import compress, convert, prng  # noqa: E402
from repro_torch import tree as tree_util  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402


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


NORM_RTOL = 1e-6
VALUE_RTOL = 1e-6
ROWS = 2


def _bits(a) -> np.ndarray:
    """uint32 (reference) or int32 (port) buffers as int32 bit patterns."""
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int32) if a.dtype.itemsize == 4 else a


def _x(rows: int, n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((rows, n)).astype(
        np.float32)


def _u(rows: int, n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).random((rows, n), dtype=np.float32)


# --------------------------------------------------------------------------- #
# K6: plain version against the Pallas kernel in interpret mode
# --------------------------------------------------------------------------- #

def _code_slots_match_pallas(x: np.ndarray, u: np.ndarray, k: int, cap: int,
                             r: int):
    """The port's plain K6 against the reference's radix threshold, masked
    norm and Pallas K6, row by row, with the reference's norm; returns the
    port's slots."""
    tx, tu = torch.from_numpy(x), torch.from_numpy(u)
    thr = ref.topk_threshold_bits(tx, k)
    norms = []
    for row in range(x.shape[0]):
        xr = jnp.asarray(x[row])
        t = jtopk.threshold_bits(xr, k, interpret=True)
        assert int(t) == int(thr[row])
        keep = jref._mag_bits(xr) >= t
        norms.append(np.float32(jnp.sqrt(jnp.sum(
            jnp.where(keep, xr, 0.0) ** 2))))
    norm = torch.from_numpy(np.asarray(norms, np.float32))
    idx, codes, nnz = ref.compact_code_slots(tx, tu, norm, thr, r, cap)
    assert idx.dtype == codes.dtype == torch.int32
    assert idx.shape == codes.shape == (x.shape[0], cap)
    for row in range(x.shape[0]):
        want_idx, want_codes = jsel.compact_code_slots(
            jnp.asarray(x[row]), jnp.asarray(u[row]), jnp.float32(norms[row]),
            jnp.uint32(int(thr[row])), r, cap, interpret=True)
        np.testing.assert_array_equal(_bits(idx[row]), _bits(want_idx))
        np.testing.assert_array_equal(_bits(codes[row]), _bits(want_codes))
        bits = np.abs(x[row]).view(np.int32)
        support = (bits >= int(thr[row])) & (bits != 0)
        assert int(nnz[row]) == int(support.sum())
    return idx, codes, nnz


MLP_LEAVES = (784 * 64, 64, 64 * 64, 64, 64 * 10, 10)


@pytest.mark.parametrize("r", [4, 8, 16])
@pytest.mark.parametrize("n", sorted(set(MLP_LEAVES[1:])) + [777])
def test_compact_code_slots_match_pallas(n, r):
    k = compress.TopK(0.25)._k(n)
    _code_slots_match_pallas(_x(ROWS, n, n + r), _u(ROWS, n, n + r + 1),
                             k, k, r)


@pytest.mark.parametrize("density,r", [(0.25, 4), (0.5, 16), (0.25, 8)])
def test_compact_code_slots_match_pallas_largest_leaf(density, r):
    n = MLP_LEAVES[0]
    k = compress.TopK(density)._k(n)
    _code_slots_match_pallas(_x(ROWS, n, r), _u(ROWS, n, r + 1), k, k, r)


def test_compact_code_slots_edges():
    """cap > support, all ties (overflow keeps the lowest-index cap), no
    survivor (all zero: norm 0 and every slot empty), a saturating row
    and n = 1."""
    x = _x(4, 1000, 5)
    u = _u(4, 1000, 6)
    x[0, 40:] = 0.0                              # 40 survivors: cap > support
    x[1] = 0.5                                   # all ties
    x[1, ::2] = -0.5
    x[2] = 0.0                                   # no survivor, norm 0
    x[3, 7] = 1e4                                # saturates the top level
    for r in (1, 4, 16):
        idx, codes, nnz = _code_slots_match_pallas(x, u, 100, 250, r)
        assert (idx[0, 40:] == 1000).all() and (codes[0, 40:] == 0).all()
        assert idx[1].tolist() == list(range(250)) and int(nnz[1]) == 1000
        assert (idx[2] == 1000).all() and (codes[2] == 0).all()
        slot = int((idx[3] == 7).nonzero()[0, 0])
        assert int(codes[3, slot]) == 2 ** r - 1          # + sign bit 0
    _code_slots_match_pallas(_x(3, 1, 7), _u(3, 1, 8), 1, 1, 4)


def test_compact_code_slots_reads_u_at_the_survivor_index():
    """The code of the survivor at index i uses u[i], the n-sized stream
    the account path's K4 reads, not a survivor-compacted one."""
    x = np.zeros((1, 64), np.float32)
    x[0, [3, 40]] = [1.0, 1.0]
    u = np.ones((1, 64), np.float32)
    u[0, 40] = 0.0                               # only index 40 rounds up
    norm = torch.tensor([2.0])                   # y = 0.5, scaled = 1.5 at r=1
    thr = ref.topk_threshold_bits(torch.from_numpy(x), 2)
    idx, codes, _ = ref.compact_code_slots(torch.from_numpy(x),
                                           torch.from_numpy(u), norm, thr,
                                           1, 2)
    assert idx[0].tolist() == [3, 40] and codes[0].tolist() == [1, 1]
    x[0, 3] = 1.0
    u[0, 3] = 0.0
    u[0, 40] = 1.0
    _, codes, _ = ref.compact_code_slots(torch.from_numpy(x),
                                         torch.from_numpy(u), norm, thr, 2, 2)
    # r = 2: scaled = 2.0 exactly, lo = 2, frac 0 -> no round-up anywhere
    assert codes[0].tolist() == [2, 2]


# --------------------------------------------------------------------------- #
# K5's and K6's one-launch scheme, mirrored on the CPU
# --------------------------------------------------------------------------- #

LB_ROUNDS = 4          # float4s a thread a tile (csrc/select_slots.cu)
LB_WINDOW = 32         # descriptors a look-back step reads, one a lane
LB_FLAG_AGGREGATE, LB_FLAG_PREFIX = 1, 2
LB_RESOLVE = ["ticket", "reverse", "shuffled"]


def _qr_code32(xv, uv, safe, levels: int):
    """The kernel's ``qr_code`` in float32, operation by operation."""
    f32 = np.float32
    y = f32(abs(xv)) / f32(safe)
    scaled = f32(levels) * y
    lo = np.floor(scaled)
    frac = scaled - lo
    code = int(lo + (f32(1.0) if uv < frac else f32(0.0)))
    code = min(code, levels - 1)
    return code + levels if xv < 0 else code


def _value_payload(x):
    """K5's payload: the survivor's float32 bits, as uint32."""
    return lambda row, i: int(np.float32(x[row, i]).view(np.uint32))


def _code_payload(x, u, norm, r: int):
    """K6's payload: the survivor's (1+r)-bit Q_r code against its row's
    masked norm, with the uniform at its own index."""
    def code(row, i):
        nr = float(norm[row])
        safe = np.float32(nr if nr > 0 else 1.0)
        return _qr_code32(x[row, i], u[row, i], safe, 2 ** r)
    return code


def _lookback_mirror(x, thr, cap: int, payload, warps: int = 8,
                     resolve: str = "ticket"):
    """The one-launch kernel of K5 and K6 (``slots_lookback``) step by step
    on the CPU, for either payload (``payload(row, i)``, the 32-bit word a
    survivor carries): tiles of ``warps`` x 32 threads x 4 rounds x 4
    elements, one a block, numbered over all rows; in round j thread t
    holds elements 4 (j threads + t) + 0..3 of its tile, so index order is
    (round, warp, lane, element); a byte-packed lane scan and a (round,
    warp) scan give each survivor its place in the tile.  Every tile
    publishes its count (its inclusive prefix if it is its row's first),
    then looks back over its row's earlier tiles 32 at a time (nearest
    first) until one has published its prefix, and publishes its own.  A
    tile writes its survivors below cap (staged in index order, so as one
    run); the row's last tile writes nnz and the sentinels (index n,
    payload 0).

    Every tile publishes before any looks back, and the tiles resolve in
    ticket order, in reverse (each must walk back over aggregates only), or
    in a seeded shuffle (``resolve="shuffled"``).  Entries the kernel would
    not write stay at -1."""
    rows, n = x.shape
    threads = 32 * warps
    tile_len = threads * 4 * LB_ROUNDS
    tiles = max(1, -(-n // tile_len))
    idx = np.full((rows, cap), -1, np.int64)
    words = np.full((rows, cap), -1, np.int64)
    nnz = np.full(rows, -1, np.int64)
    desc = {}
    state = {}
    for tile in range(rows * tiles):
        row, tr = divmod(tile, tiles)
        base = tr * tile_len
        bits = np.abs(x[row]).view(np.int32).astype(np.int64)
        t = int(thr[row])
        keep = np.zeros((LB_ROUNDS, threads, 4), bool)
        elem = np.zeros((LB_ROUNDS, threads, 4), np.int64)
        for j in range(LB_ROUNDS):
            for th in range(threads):
                for e in range(4):
                    i = base + 4 * (j * threads + th) + e
                    elem[j, th, e] = i
                    keep[j, th, e] = i < n and bits[i] >= t and bits[i] != 0
        # lane offsets, a byte a round, by an inclusive warp scan
        packed = np.zeros(threads, np.int64)
        for j in range(LB_ROUNDS):
            packed |= keep[j].sum(axis=1).astype(np.int64) << (8 * j)
        lane_off = np.zeros(threads, np.int64)
        warp_count = np.zeros((LB_ROUNDS, warps), np.int64)
        for w in range(warps):
            incl = np.cumsum(packed[32 * w:32 * w + 32])
            assert all(((incl >> (8 * j)) & 0xFF).max() <= 128
                       for j in range(LB_ROUNDS))
            lane_off[32 * w:32 * w + 32] = incl - packed[32 * w:32 * w + 32]
            for j in range(LB_ROUNDS):
                warp_count[j, w] = (incl[-1] >> (8 * j)) & 0xFF
        counts = warp_count.reshape(-1)                  # (round, warp)
        off = (np.cumsum(counts) - counts).reshape(LB_ROUNDS, warps)
        total = int(counts.sum())
        desc[tile] = ((LB_FLAG_PREFIX, total) if tr == 0
                      else (LB_FLAG_AGGREGATE, total))
        state[tile] = (row, tr, keep, elem, lane_off, off, total)
    order = list(range(len(state)))
    if resolve == "reverse":
        order.reverse()
    elif resolve == "shuffled":
        np.random.default_rng(len(order)).shuffle(order)
    for tile in order:
        row, tr, keep, elem, lane_off, off, total = state[tile]
        prefix = 0
        if tr > 0:
            first, look = tile - tr, tile - 1
            while True:
                window = [desc[p] if p >= first else (LB_FLAG_PREFIX, 0)
                          for p in range(look, look - LB_WINDOW, -1)]
                assert all(flag != 0 for flag, _ in window)
                at = [i for i, (flag, _) in enumerate(window)
                      if flag == LB_FLAG_PREFIX]
                if at:
                    prefix += sum(v for _, v in window[:at[0] + 1])
                    break
                prefix += sum(v for _, v in window)
                look -= LB_WINDOW
            desc[tile] = (LB_FLAG_PREFIX, prefix + total)
        for j in range(LB_ROUNDS):
            for th in range(keep.shape[1]):
                pos = (prefix + int(off[j, th // 32])
                       + int((lane_off[th] >> (8 * j)) & 0xFF))
                for e in range(4):
                    if keep[j, th, e]:
                        if pos < cap:
                            i = int(elem[j, th, e])
                            idx[row, pos] = i
                            words[row, pos] = payload(row, i)
                        pos += 1
        if tr == tiles - 1:
            count = prefix + total
            nnz[row] = count
            idx[row, min(count, cap):] = n
            words[row, min(count, cap):] = 0
    return idx, words, nnz


def _k6_mirror_rows(case: str):
    """(x, u, k, cap, r, warps) of the phase-2 cases of the one launch."""
    x = _x(3, 9000, 21)
    u = _u(3, 9000, 22)
    if case == "cap in the second tile":            # tiles of 4096
        return x, u, 4000, 5000, 4, 8
    if case == "cap in the last tile":
        return x, u, 4000, 3900, 16, 8
    if case == "cap 0":
        return x, u, 100, 0, 4, 8
    if case == "cap above nnz, zero row, all ties":
        x = _x(4, 5003, 23)                         # n not a multiple of 4
        u = _u(4, 5003, 24)
        x[0, 40:] = 0.0                              # 40 survivors < cap
        x[1] = 0.0                                   # no survivor
        x[2] = 0.5                                   # all ties: overflow
        x[2, ::2] = -0.5
        x[3, 7] = 1e4                                # saturates the top level
        return x, u, 100, 4500, 8, 8
    if case == "many tiles":                        # 512-element tiles: 137
        n = 70000
        x = _x(2, n, 26)
        x[1, 3000:] = 0.25                           # ties across tiles
        return x, _u(2, n, 25), 17500, 17500, 4, 1
    if case == "n = 1":
        return _x(3, 1, 27), _u(3, 1, 28), 1, 1, 4, 8
    if case == "odd n, cap above k":
        return _x(3, 777, 29), _u(3, 777, 30), 77, 100, 8, 8
    raise ValueError(case)


MIRROR_CASES = ["cap in the second tile", "cap in the last tile", "cap 0",
                "cap above nnz, zero row, all ties", "many tiles"]


@pytest.mark.parametrize("resolve", LB_RESOLVE)
@pytest.mark.parametrize("case", MIRROR_CASES)
def test_k6_lookback_mirror_matches_pallas(case, resolve):
    """The CPU mirror of K6's one-launch scheme (tiles resolved in ticket
    order, in reverse or shuffled, look-back 32 tiles at a time, sentinels from the row's last tile)
    writes every entry, bit for bit the port's plain K6 and the reference's
    Pallas K6 in interpret mode (which takes no cap of 0): an ordering bug
    shows here before the card."""
    x, u, k, cap, r, warps = _k6_mirror_rows(case)
    tx = torch.from_numpy(x)
    thr = ref.topk_threshold_bits(tx, k)
    norm = ref.l2_norm(ref.mask_by_threshold(tx, thr))
    idx, codes, nnz = _lookback_mirror(
        x, thr.numpy(), cap, _code_payload(x, u, norm.numpy(), r), warps,
        resolve)
    assert (idx >= 0).all() and (codes >= 0).all() and (nnz >= 0).all()
    want = ref.compact_code_slots(tx, torch.from_numpy(u), norm, thr, r, cap)
    assert np.array_equal(idx, want[0].numpy())
    assert np.array_equal(codes, ref.as_u32(want[1]).numpy())
    assert np.array_equal(nnz, want[2].numpy())
    for row in range(x.shape[0] if cap else 0):
        widx, wcodes = jsel.compact_code_slots(
            jnp.asarray(x[row]), jnp.asarray(u[row]), jnp.float32(norm[row]),
            jnp.uint32(int(thr[row])), r, cap, interpret=True)
        np.testing.assert_array_equal(idx[row], np.asarray(widx))
        np.testing.assert_array_equal(codes[row], np.asarray(wcodes))


@pytest.mark.parametrize("resolve", LB_RESOLVE)
@pytest.mark.parametrize("case", MIRROR_CASES + ["n = 1", "odd n, cap above k"])
def test_k5_lookback_mirror_matches_pallas(case, resolve):
    """The same mirror with K5's payload (the survivor's float32 bits):
    every entry written, bit for bit the port's plain K5 and the
    reference's Pallas K5 in interpret mode (which takes no cap of 0)."""
    x, _, k, cap, _, warps = _k6_mirror_rows(case)
    tx = torch.from_numpy(x)
    thr = ref.topk_threshold_bits(tx, k)
    idx, words, nnz = _lookback_mirror(x, thr.numpy(), cap, _value_payload(x),
                                       warps, resolve)
    assert (idx >= 0).all() and (words >= 0).all() and (nnz >= 0).all()
    want_idx, want_vals, want_nnz = ref.compact_slots(tx, thr, cap)
    assert np.array_equal(idx, want_idx.numpy())
    assert np.array_equal(words, want_vals.numpy().view(np.uint32))
    assert np.array_equal(nnz, want_nnz.numpy())
    for row in range(x.shape[0] if cap else 0):
        widx, wvals = jsel.compact_slots(jnp.asarray(x[row]),
                                         jnp.uint32(int(thr[row])), cap,
                                         interpret=True)
        np.testing.assert_array_equal(idx[row], np.asarray(widx))
        np.testing.assert_array_equal(words[row],
                                      np.asarray(wvals).view(np.uint32))


@pytest.mark.parametrize("n,density,r", [(4096, 0.25, 4), (640, 0.5, 16),
                                         (10, 0.25, 4), (777, 0.1, 8)])
def test_topk_qr_slots_match_jnp_oracle(n, density, r):
    """``ref.topk_qr_slots`` (threshold, masked norm, K6, K8) against
    ``repro.kernels.ref.topk_qr_slots``: slots and words bit for bit given
    the reference's norm, the norm within ``NORM_RTOL``."""
    x, u = _x(ROWS, n, n), _u(ROWS, n, n + 1)
    k = compress.TopK(density)._k(n)
    idx, words, norm, nnz = ref.topk_qr_slots(torch.from_numpy(x), k, k, r,
                                              torch.from_numpy(u))
    assert words.shape == (ROWS, -(-k // 32) * (1 + r))
    for row in range(ROWS):
        widx, wwords, wnorm, wsup = jref.topk_qr_slots(
            jnp.asarray(x[row]), k, k, r, jnp.asarray(u[row]))
        np.testing.assert_allclose(float(norm[row]), float(wnorm),
                                   rtol=NORM_RTOL)
        np.testing.assert_array_equal(_bits(idx[row]), _bits(widx))
        assert int(nnz[row]) == int(np.asarray(wsup).sum())
        thr = ref.topk_threshold_bits(torch.from_numpy(x[row:row + 1]), k)
        _, codes, _ = ref.compact_code_slots(
            torch.from_numpy(x[row:row + 1]), torch.from_numpy(u[row:row + 1]),
            torch.tensor([float(wnorm)]), thr, r, k)
        np.testing.assert_array_equal(_bits(ref.pack_codes(codes, 1 + r)[0]),
                                      _bits(wwords))
        if float(norm[row]) == float(wnorm):
            np.testing.assert_array_equal(_bits(words[row]), _bits(wwords))


def test_ops_topk_qr_slots_draws_the_reference_uniforms():
    """``ops.topk_qr_slots`` with per-row keys equals the plain chain fed
    ``jax.random.uniform(keys[i], (n,))``, as the reference's op draws."""
    x = _x(3, 1000, 2)
    jkeys = jax.random.split(jax.random.PRNGKey(4), 3)
    keys = torch.from_numpy(np.asarray(jkeys).astype(np.int64))
    got = ops.topk_qr_slots(torch.from_numpy(x), 250, 250, 4, keys)
    u = np.stack([np.asarray(jax.random.uniform(k, (1000,), jnp.float32))
                  for k in jkeys])
    want = ref.topk_qr_slots(torch.from_numpy(x), 250, 250, 4,
                             torch.from_numpy(u))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n,k,r", [(1000, 250, 4), (777, 388, 16),
                                   (50176, 12544, 4), (64, 64, 8), (10, 1, 1)])
def test_ops_topk_qr_slots_equals_the_plain_chain(n, k, r):
    """``ops.topk_qr_slots`` takes the threshold and the masked rows from
    one ``threshold_mask`` call: bit for bit ``ref.topk_qr_slots`` (K1, the
    ``where``, K3, K6, K8) on the same uniforms, k = n included."""
    x = _x(3, n, n + k)
    x[0, :7] = 0.0
    x[0, 7:9] = -0.0
    jkeys = jax.random.split(jax.random.PRNGKey(n + r), 3)
    keys = torch.from_numpy(np.asarray(jkeys).astype(np.int64))
    got = ops.topk_qr_slots(torch.from_numpy(x), k, k, r, keys)
    u = prng.uniform(keys, n)
    want = ref.topk_qr_slots(torch.from_numpy(x), k, k, r, u)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


# --------------------------------------------------------------------------- #
# Compose and Int8Sync on stacked trees against jax.vmap(comp.compress)
# --------------------------------------------------------------------------- #

S = 3
SHAPES = {"fc0": {"w": (784, 16), "b": (16,)},
          "fc1": {"w": (16, 16), "b": (16,)},
          "fc2": {"w": (16, 10), "b": (10,)}}


def _stacked_tree(seed: int, shapes=SHAPES, s: int = S) -> dict:
    rng = np.random.default_rng(seed)
    return {name: {leaf: rng.standard_normal((s,) + shape).astype(np.float32)
                   for leaf, shape in leaves.items()}
            for name, leaves in shapes.items()}


def _keys(seed: int, s: int = S):
    keys = jax.random.split(jax.random.PRNGKey(seed), s)
    return keys, torch.from_numpy(np.asarray(keys).astype(np.int64))


COMPOSES = {
    "k25_q4": (lambda c: c.Compose(c.TopK(0.25), c.QuantQr(4))),
    "k50_q16": (lambda c: c.Compose(c.TopK(0.5), c.QuantQr(16))),
    "k10_q8": (lambda c: c.Compose(c.TopK(0.1), c.QuantQr(8))),
    "dense_q4": (lambda c: c.Compose(c.TopK(1.0), c.QuantQr(4))),
    "default": (lambda c: c.Compose()),
}


def _reports_equal(jrep, trep, s: int = S):
    for name in ("value_bits", "index_bits", "meta_bits", "total_bits"):
        want = np.broadcast_to(np.asarray(getattr(jrep, name), np.float32), (s,))
        got = getattr(trep, name).numpy()
        assert got.dtype == np.float32 and got.shape == (s,)
        np.testing.assert_array_equal(got, want, err_msg=name)


def _qr_levels(out: np.ndarray, norm: np.ndarray, r: int) -> np.ndarray:
    """Signed integer Q_r levels of a transform output ``(s, n)`` against
    float64 norms ``(s,)`` (a norm an ulp off moves ``out/norm * 2**r`` by
    far less than 1/2)."""
    lv = out.astype(np.float64) / np.where(norm > 0, norm, 1.0)[:, None]
    return np.rint(lv * 2 ** r).astype(np.int64)


@pytest.mark.parametrize("name", sorted(COMPOSES))
def test_compose_matches_vmapped_reference(name):
    """Same kept support, same signed Q_r levels and the same report; the
    values within ``VALUE_RTOL`` (the masked norms come from torch's and
    XLA's sums)."""
    jc, tc = COMPOSES[name](jcomp), COMPOSES[name](compress)
    tree_np = _stacked_tree(len(name))
    jkeys, tkeys = _keys(len(name) + 1)
    jout, jrep = jax.vmap(jc.compress)(jax.tree.map(jnp.asarray, tree_np),
                                       jkeys)
    tout, trep = tc.compress(convert.params_from_jax(tree_np, "cpu"), tkeys)
    _reports_equal(jrep, trep)
    r = tc.second.r
    for a, b, x in zip(jax.tree.leaves(jout), tree_util.leaves(tout),
                       jax.tree.leaves(tree_np)):
        a, b = np.asarray(a).reshape(S, -1), b.numpy().reshape(S, -1)
        assert b.dtype == a.dtype
        masked = ref.topk_mask(torch.from_numpy(x.reshape(S, -1)),
                               tc.first._k(a.shape[1])).numpy()
        norm = np.sqrt((masked.astype(np.float64) ** 2).sum(1))
        np.testing.assert_array_equal(_qr_levels(b, norm, r),
                                      _qr_levels(a, norm, r))
        np.testing.assert_array_equal(b != 0, a != 0)
        np.testing.assert_allclose(b, a, rtol=VALUE_RTOL, atol=0)


def test_compose_splits_the_key_as_the_reference():
    """Compose's QuantQr stage draws from ``split(key)[1]``: given a
    pre-masked tree, ``Compose(TopK(1.0), QuantQr)`` equals ``QuantQr``
    with the second half of each client's split key."""
    ts = convert.params_from_jax(_stacked_tree(3), "cpu")
    _, tkeys = _keys(9)
    got, rep = compress.Compose(compress.TopK(1.0), compress.QuantQr(4)
                                ).compress(ts, tkeys)
    want, wrep = compress.QuantQr(4).compress(ts, prng.split(tkeys, 2)[:, 1])
    for a, b in zip(tree_util.leaves(got), tree_util.leaves(want)):
        assert torch.equal(a, b)
    assert torch.equal(rep.total_bits, wrep.total_bits)


def test_compose_counts_the_support_it_keeps():
    """The value bits are nnz * (1 + r) over the kept support: ties kept,
    already-zero entries not sent."""
    tree_np = _stacked_tree(4)
    tree_np["fc1"]["w"][0] = 1.0                 # every entry tied
    tree_np["fc2"]["w"][1, :8] = 0.0
    tree_np["fc0"]["b"][2] = 0.0                 # all zero: norm 0
    jc, tc = COMPOSES["k25_q4"](jcomp), COMPOSES["k25_q4"](compress)
    jkeys, tkeys = _keys(2)
    _, jrep = jax.vmap(jc.compress)(jax.tree.map(jnp.asarray, tree_np), jkeys)
    tout, trep = tc.compress(convert.params_from_jax(tree_np, "cpu"), tkeys)
    _reports_equal(jrep, trep)
    assert (tout["fc0"]["b"][2] == 0).all()


def test_generic_compose_reports_the_conservative_sum():
    """Compositions other than TopK -> QuantQr report the second stage's
    value bits plus both stages' index bits, as the reference does."""
    for make in (lambda c: c.Compose(c.TopK(0.3), c.TopK(0.5)),
                 lambda c: c.Compose(c.QuantQr(4), c.TopK(0.3)),
                 lambda c: c.Compose(c.TopK(0.3), c.Int8Sync())):
        jc, tc = make(jcomp), make(compress)
        tree_np = _stacked_tree(6)
        jkeys, tkeys = _keys(6)
        _, jrep = jax.vmap(jc.compress)(jax.tree.map(jnp.asarray, tree_np),
                                        jkeys)
        _, trep = tc.compress(convert.params_from_jax(tree_np, "cpu"), tkeys)
        _reports_equal(jrep, trep)


@pytest.mark.parametrize("bits", [7, 4, 1])
def test_int8sync_matches_vmapped_reference(bits):
    """int8 levels bit for bit, scales (norm / 2**bits, a plain float32
    sum in both packages) within ``NORM_RTOL``, the dequantized values
    within ``VALUE_RTOL`` and the report exactly."""
    jc, tc = jcomp.Int8Sync(bits), compress.Int8Sync(bits)
    tree_np = _stacked_tree(20 + bits)
    tree_np["fc1"]["b"][1] = 0.0                 # norm 0: all levels 0
    jkeys, tkeys = _keys(bits)
    jt = jax.tree.map(jnp.asarray, tree_np)
    jq, js = jax.vmap(jc.encode)(jt, jkeys)
    ts = convert.params_from_jax(tree_np, "cpu")
    tq, tsc = tc.encode(ts, tkeys)
    for a, b in zip(jax.tree.leaves(jq), tree_util.leaves(tq)):
        assert b.dtype == torch.int8 and b.shape == a.shape
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for a, b in zip(jax.tree.leaves(js), tree_util.leaves(tsc)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=NORM_RTOL)
    jout, jrep = jax.vmap(jc.compress)(jt, jkeys)
    tout, trep = tc.compress(ts, tkeys)
    for a, b in zip(jax.tree.leaves(jout), tree_util.leaves(tout)):
        assert b.dtype == torch.float32
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=VALUE_RTOL,
                                   atol=0)
    _reports_equal(jrep, trep)


def test_int8sync_clips_at_127():
    """A coordinate holding all of its leaf's energy reaches level 128,
    which the int8 payload clips to 127, as the reference does."""
    ts = {"w": torch.zeros((S, 40))}
    ts["w"][:, 3] = -5.0
    _, tkeys = _keys(0)
    q, sc = compress.Int8Sync().encode(ts, tkeys)
    assert (q["w"][:, 3] == -127).all() and int(q["w"].count_nonzero()) == S
    out, _ = compress.Int8Sync().compress(ts, tkeys)
    assert torch.equal(out["w"][:, 3], torch.full((S,), -5.0 / 128 * 127))


def test_int8sync_validates():
    with pytest.raises(ValueError, match="int8"):
        compress.Int8Sync(8)
    with pytest.raises(ValueError, match="rng key"):
        compress.Int8Sync().compress(convert.params_from_jax(
            _stacked_tree(0), "cpu"))


def test_registry_matches_the_reference():
    # the reference's own entries: a test of the JAX package that ran
    # earlier in this process may have registered one of its own
    # (tests/test_compressors.py registers "test-noop")
    reference = [name for name in jregistry.available()
                 if jregistry._REGISTRY[name].__module__.startswith("repro.")]
    assert compress.available() == reference
    for name in reference:
        assert (type(compress.make_compressor(name)).__name__
                == type(jregistry.make_compressor(name)).__name__)
    assert compress.make_compressor("TopK", density=0.3) == compress.TopK(0.3)
    assert compress.make_compressor("double") == compress.Compose(
        compress.TopK(0.25), compress.QuantQr(4))
    with pytest.raises(ValueError, match="unknown compressor"):
        compress.make_compressor("bogus")
    with pytest.raises(ValueError, match="already registered"):
        compress.register("topk", compress.TopK)
    compress.register("topk", compress.TopK, overwrite=True)
