"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``: without a CUDA card every test skips.  Imports torch and
the port only (no JAX), so it runs on a GPU machine as

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

K1, K2 (alone and in K1's launch, ``threshold_mask``), K4 and K7 (reading
their uniforms, and drawing them with threefry against the torch draw),
K5, K6, K8, K9 (codes, and decoded to Q_r values) and K11 must be
bit-equal to the plain versions; K3 within rtol
1e-5 (float32 sums in another order) and bit-equal to itself run to run.  K12's state S_T must be bit-equal (its
update keeps the plain version's operation order) and y within
``WKV6_YTOL`` of max |y| in float32 (64-term sums in another order), plus
one bf16 rounding in bf16.  One reduced prefill on the card launches K11
once per rglru layer and K12 once per rwkv layer.  The stacked CNN's
forward and backward on the card are within 1e-4 of the CPU's, and two
rounds of Figure 9's sparseFedAvg on the card count what the CPU counts.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.configs import get_spec, reduced  # noqa: E402
from repro_torch.kernels import pack_codes as pack  # noqa: E402
from repro_torch.kernels import qr_pack  # noqa: E402
from repro_torch.kernels import quantize as quant  # noqa: E402
from repro_torch.kernels import rglru_scan as rg  # noqa: E402
from repro_torch.kernels import select_slots as sel  # noqa: E402
from repro_torch.kernels import topk_compress as topk  # noqa: E402
from repro_torch.kernels import wkv6  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _full_float32_matmuls():
    """K12's plain version is an einsum: hold the kernel against it in full
    float32, with TF32 off (set and restored here, whatever the imports
    left)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rows(rows, n, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(rows, n, generator=gen, device=device)


def _same_bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("rows,n,k", [
    (5, 50176, 15053), (5, 10, 3), (3, 777, 77), (3, 1000, 1),
    (3, 1000, 999), (2, 1000, 1000), (2, 1000, 0)])
def test_topk_kernels_match_plain(cuda_device, rows, n, k):
    x = _rows(rows, n, cuda_device, n + k)
    x[0, :5] = 0.0
    x[0, 5:9] = -0.0
    t = topk.threshold_bits(x, k)
    assert torch.equal(t, ref.topk_threshold_bits(x, k))
    assert _same_bits(topk.mask_by_threshold(x, t), ref.mask_by_threshold(x, t))


def _topk_edge_rows(n, device):
    """Rows that stress K1: ties, signed zeros, subnormals, inf, Gaussian."""
    x = _rows(5, n, device, n)
    x[0] = 0.5                                   # all-equal magnitudes
    x[0, ::2] = -0.5
    x[1, : n // 2] = 0.0                         # zeros and -0.0
    x[1, n // 2:] = -0.0
    x[1, -1] = 1.0
    x[2, ::3] = 1e-40                            # subnormals
    x[2, 1::7] = -1e-45
    x[3, ::5] = float("inf")                     # inf beside finite values
    x[3, 1::11] = float("-inf")
    return x


@pytest.mark.parametrize("n", [1, 3, 5, 7, 777, 4096, 50177, 50176])
def test_topk_threshold_edge_rows_and_per_row_k(cuda_device, n):
    """n below a cluster's CTAs (1-7), n not a multiple of 4, per-row k of
    0, 1, n-1, n and beyond n, ties, +-0, subnormals and inf: bit-equal."""
    x = _topk_edge_rows(n, cuda_device)
    for k in (1, max(n - 1, 0), n // 2, 0, n, n + 5):
        assert torch.equal(topk.threshold_bits(x, k),
                           ref.topk_threshold_bits(x, k)), k
    ks = torch.tensor([0, 1, max(n - 1, 0), n, n + 3], device=cuda_device)
    assert torch.equal(topk.threshold_bits(x, ks),
                       ref.topk_threshold_bits(x, ks))


def test_topk_threshold_at_and_past_the_shared_memory_capacity(cuda_device):
    """A row whose slices just fit the clusters' shared memory, one 4
    elements past it (read from HBM until its candidates fit), and the
    large shape: bit-equal."""
    cap = topk.resident_max_n()
    for n in (cap, cap + 4):
        x = _rows(2, n, cuda_device, n)
        x[1, ::2] = 2.0                          # half the row ties
        for k in (n // 10, n // 2 + 1):
            assert torch.equal(topk.threshold_bits(x, k),
                               ref.topk_threshold_bits(x, k)), (n, k)
    x = _rows(4, 1 << 24, cuda_device, 24)
    k = (1 << 24) // 10
    assert torch.equal(topk.threshold_bits(x, k),
                       ref.topk_threshold_bits(x, k))


@pytest.mark.parametrize("n", [10, 50176, 1 << 20])
def test_topk_threshold_is_one_kernel_a_call(cuda_device, n):
    """One ``threshold_bits`` call runs one kernel on the card (no memset,
    no walk kernels) and adds one to its count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = _rows(5, n, cuda_device, n)
    k = max(1, n // 3)
    topk.threshold_bits(x, k)
    torch.cuda.synchronize()
    topk.LAUNCHES["topk_threshold_bits"] = 0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        topk.threshold_bits(x, k)
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert topk.LAUNCHES["topk_threshold_bits"] == 1
    assert len(events) == 1, [e.name for e in events]


@pytest.mark.parametrize("rows,n,r", [(5, 50176, 8), (5, 10, 1), (3, 1001, 4),
                                      (2, (1 << 24) + 3, 8), (3, 1, 16)])
def test_qr_kernels_match_plain(cuda_device, rows, n, r):
    x = _rows(rows, n, cuda_device, n + r)
    x[1] = 0.0                                   # norm 0 -> all zero
    u = torch.rand((rows, n), device=cuda_device)
    norm = quant.l2_norm(x)
    assert torch.equal(norm, quant.l2_norm(x))
    torch.testing.assert_close(norm, ref.l2_norm(x), rtol=1e-5, atol=0.0)
    out = quant.quantize_qr_with_uniforms(x, r, u, norm)
    assert _same_bits(out, ref.quantize_qr_with_uniforms(x, r, u, norm))


def _keys(rows, seed, high=True):
    """(rows, 2) int64 key data on the host; with ``high``, row 0's words
    are at and above 2^31 and row 1's at 2^32 - 1."""
    from repro_torch import prng
    keys = prng.split(prng.PRNGKey(seed), rows)
    if high:
        keys[0] = torch.tensor([2 ** 31, 2 ** 31 + 12345])
        if rows > 1:
            keys[1] = torch.tensor([2 ** 32 - 1, 2 ** 32 - 1])
    return keys


def _keyed_plain(x, r, keys, norm):
    """The plain chain the keyed K4 replaces: the torch threefry draw, then
    the plain Q_r."""
    from repro_torch import prng
    u = prng.uniform(keys, x.shape[1], device=x.device)
    return ref.quantize_qr_with_uniforms(x, r, u, norm)


@pytest.mark.parametrize("rows,n,r", [
    (5, 1, 8), (3, 1001, 4), (5, 50176, 8), (2, (1 << 24) + 3, 8),
    (3, 4096, 1), (3, 1002, 16)])
def test_quantize_qr_keyed_matches_plain_chain(cuda_device, rows, n, r):
    """K4 drawing its uniforms: bit-equal to prng.uniform + the plain Q_r,
    with key words at and above 2^31, a zero row (norm 0), n = 1, n not a
    multiple of 4 and past 2^24."""
    x = _rows(rows, n, cuda_device, n + r)
    x[-1] = 0.0                                  # norm 0 -> all zero
    keys = _keys(rows, n + r)
    norm = quant.l2_norm(x)
    out = quant.quantize_qr_keyed(x, r, keys, norm)
    assert _same_bits(out, _keyed_plain(x, r, keys, norm))


def test_quantize_qr_keyed_bf16_device_keys_many_rows_and_offsets(cuda_device):
    """bf16 rows (cast back), keys already on the card, 40 rows (past the
    32 whose keys ride in the launch: one copy), and a row view that is not
    16-byte aligned (the scalar path): bit-equal to the plain chain."""
    x = _rows(5, 4096, cuda_device, 1).to(torch.bfloat16)
    keys = _keys(5, 1)
    norm = quant.l2_norm(x)
    out = quant.quantize_qr_keyed(x, 4, keys, norm)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out.view(torch.int16),
                       _keyed_plain(x, 4, keys, norm).view(torch.int16))
    x = _rows(40, 1000, cuda_device, 2)
    norm = quant.l2_norm(x)
    for k in (_keys(40, 2), _keys(40, 3).to(cuda_device)):
        assert _same_bits(quant.quantize_qr_keyed(x, 8, k, norm),
                          _keyed_plain(x, 8, k.cpu(), norm))
    big = _rows(3, 1001, cuda_device, 3)
    x = big[:, 1:]                               # rows 4 bytes off alignment
    norm = quant.l2_norm(x)
    keys = _keys(3, 4)
    assert _same_bits(quant.quantize_qr_keyed(x, 8, keys, norm),
                      _keyed_plain(x.contiguous(), 8, keys, norm))


@pytest.mark.parametrize("rows,n", [(5, 1001), (3, 4096)])
def test_quantize_qr_entries_agree_and_count(cuda_device, rows, n):
    """The memory entry fed the uniforms the keyed entry draws gives the
    same bits; both add to the one counter ``quantize_qr``."""
    from repro_torch import prng
    x = _rows(rows, n, cuda_device, n)
    keys = _keys(rows, n)
    norm = quant.l2_norm(x)
    u = prng.uniform(keys, n, device=cuda_device)
    quant.LAUNCHES["quantize_qr"] = 0
    a = quant.quantize_qr_keyed(x, 8, keys, norm)
    b = quant.quantize_qr_with_uniforms(x, 8, u, norm)
    torch.cuda.synchronize()
    assert quant.LAUNCHES["quantize_qr"] == 2
    assert _same_bits(a, b)


@pytest.mark.parametrize("n", [10, 50176, 1 << 24])
def test_quantize_qr_keyed_is_one_kernel_a_call(cuda_device, n):
    """One keyed K4 call with host keys of 5 rows runs one kernel on the
    card: the key words ride in the launch, no copy."""
    rows = 5 if n != 1 << 24 else 4
    x = _rows(rows, n, cuda_device, n)
    keys = _keys(rows, n)
    norm = quant.l2_norm(x)
    quant.LAUNCHES["quantize_qr"] = 0
    names = _device_ops(lambda: quant.quantize_qr_keyed(x, 8, keys, norm))
    assert quant.LAUNCHES["quantize_qr"] == 2
    assert len(names) == 1, names


def test_ops_quantize_qr_draws_no_torch_uniforms(cuda_device, monkeypatch):
    """On a CUDA tensor ``ops.quantize_qr`` is K3 and the keyed K4: at most
    those and one key copy on the card, and no ``prng.uniform`` call."""
    from repro_torch import prng

    def refuse(*args, **kwargs):
        raise AssertionError("prng.uniform called on the CUDA path")

    x = _rows(5, 50176, cuda_device, 7)
    keys = _keys(5, 7, high=False)
    want = _keyed_plain(x, 8, keys, quant.l2_norm(x))
    monkeypatch.setattr(prng, "uniform", refuse)
    names = _device_ops(lambda: ops.quantize_qr(x, 8, keys))
    assert len(names) <= 3, names
    assert _same_bits(ops.quantize_qr(x, 8, keys), want)


@pytest.mark.parametrize("n", [1, 255, 50176, (1 << 24) + 3])
def test_l2_norm_one_launch_same_bits_within_rtol(cuda_device, n):
    """K3 is one launch a call, gives the same bits on every call (its sums
    run in an order fixed by (rows, n)) and is within rtol 1e-5 of the
    plain version; n = 2^24 + 3 takes the scalar (not float4) loads."""
    x = _rows(3, n, cuda_device, n)
    quant.LAUNCHES["l2_norm"] = 0
    norms = [quant.l2_norm(x) for _ in range(3)]
    torch.cuda.synchronize()
    assert quant.LAUNCHES["l2_norm"] == 3
    assert all(_same_bits(norms[0], z) for z in norms[1:])
    torch.testing.assert_close(norms[0], ref.l2_norm(x), rtol=1e-5, atol=0.0)


@pytest.mark.parametrize("rows,n,k,cap", [
    (5, 50176, 15053, 15053), (5, 10, 3, 3), (3, 1000, 100, 300),
    (3, 4097, 1, 1), (2, 33, 33, 33), (2, 1, 1, 1), (2, 5000, 2000, 100),
    (3, 8193, 4000, 4000), (4, 1 << 24, 5033164, 5033164)])
def test_compact_slots_matches_plain(cuda_device, rows, n, k, cap):
    x = _rows(rows, n, cuda_device, n + cap)
    x[0, : n // 3] = 0.0                         # underfull support
    if rows > 2:
        x[2] = 0.25                              # all tied: overflow
    t = topk.threshold_bits(x, k)
    idx, vals, nnz = sel.compact_slots(x, t, cap)
    idx_r, vals_r, nnz_r = ref.compact_slots(x, t, cap)
    assert torch.equal(idx, idx_r) and torch.equal(nnz, nnz_r)
    assert _same_bits(vals, vals_r)


@pytest.mark.parametrize("rows,n,r", [(5, 50176, 8), (5, 10, 8), (3, 1001, 1),
                                      (2, 33, 16), (2, 1, 4)])
def test_quantize_pack_matches_plain(cuda_device, rows, n, r):
    x = _rows(rows, n, cuda_device, n + r)
    x[1] = 0.0                                   # norm 0 -> all codes 0
    x[0, 0] = 1e4                                # saturates the top level
    u = torch.rand((rows, n), device=cuda_device)
    norm = quant.l2_norm(x)
    words = qr_pack.quantize_pack_with_uniforms(x, r, u, norm)
    assert torch.equal(words,
                       ref.quantize_pack_with_uniforms(x, r, u, norm))


@pytest.mark.parametrize("rows,n,b,high,off", [
    (5, 50176, 9, False, 0), (3, 1, 1, False, 0), (3, 31, 5, False, 0),
    (3, 33, 17, False, 0), (2, 4096, 32, False, 0), (2, 1000, 9, False, 0),
    (3, 4096, 8, False, 0), (3, 50176, 1, False, 0), (3, 1000, 8, True, 0),
    (3, 4097, 17, True, 0), (2, 50176, 9, True, 0), (3, 12545, 5, False, 1),
    (3, 1003, 17, True, 2), (2, 4099, 32, True, 3), (3, 1001, 1, True, 1)])
def test_pack_unpack_match_plain_and_invert(cuda_device, rows, n, b, high,
                                            off):
    """K8 and K9 bit-equal to the plain versions and K9(K8(c)) == c's bits
    below b: b from 1 to 32; codes with bits set at and above b (high: all
    32 bits random; K8 ignores the upper ones); rows starting ``off`` codes
    past a 16-byte boundary with n % 4 != 0 (a contiguous view at a storage
    offset: K8's 4-byte loads)."""
    gen = torch.Generator(device=cuda_device).manual_seed(n * b + off)
    flat = torch.randint(-2 ** 31, 2 ** 31, (rows * n + off,), generator=gen,
                         device=cuda_device, dtype=torch.int64)
    keep = (1 << 32) - 1 if high else (1 << b) - 1
    codes = ref.to_i32(ref.as_u32(flat) & keep)[off:].view(rows, n)
    assert codes.data_ptr() % 16 == 4 * off
    words = pack.pack_codes(codes, b)
    assert torch.equal(words, ref.pack_codes(codes, b))
    back = pack.unpack_codes(words, b, n)
    assert torch.equal(back, ref.unpack_codes(words, b, n))
    assert torch.equal(back, ref.to_i32(ref.as_u32(codes) & ((1 << b) - 1)))


def _keyed_pack_plain(x, r, keys, norm):
    """The plain chain the keyed K7 replaces: the torch threefry draw, then
    the plain K7."""
    from repro_torch import prng
    u = prng.uniform(keys, x.shape[1], device=x.device)
    return ref.quantize_pack_with_uniforms(x, r, u, norm)


@pytest.mark.parametrize("rows,n,r", [
    (5, 1, 8), (3, 1001, 4), (5, 50176, 8), (2, (1 << 24) + 3, 8),
    (3, 4096, 1), (3, 1002, 16), (4, 130, 16)])
def test_quantize_pack_keyed_matches_plain_chain(cuda_device, rows, n, r):
    """K7 drawing its uniforms: bit-equal to prng.uniform + the plain K7,
    with key words at and above 2^31, a zero row (norm 0), a saturating
    entry, n = 1, n not a multiple of 4 or 32 and past 2^24."""
    x = _rows(rows, n, cuda_device, n + r)
    x[-1] = 0.0                                  # norm 0 -> all codes 0
    x[0, n // 2] = 1e6                           # saturates the top level
    keys = _keys(rows, n + r)
    norm = quant.l2_norm(x)
    words = qr_pack.quantize_pack_keyed(x, r, keys, norm)
    assert torch.equal(words, _keyed_pack_plain(x, r, keys, norm))


def test_quantize_pack_keyed_device_keys_many_rows_and_offsets(cuda_device):
    """Keys already on the card, 40 rows (past the 32 whose keys ride in the
    launch: one copy), bf16 rows, and a row view that is not 16-byte
    aligned (the scalar path): bit-equal to the plain chain; the memory
    entry fed the keyed entry's uniforms gives the same words."""
    from repro_torch import prng
    x = _rows(40, 1000, cuda_device, 2)
    norm = quant.l2_norm(x)
    for k in (_keys(40, 2), _keys(40, 3).to(cuda_device)):
        assert torch.equal(qr_pack.quantize_pack_keyed(x, 8, k, norm),
                           _keyed_pack_plain(x, 8, k.cpu(), norm))
    x = _rows(5, 4096, cuda_device, 1).to(torch.bfloat16)
    keys = _keys(5, 1)
    norm = quant.l2_norm(x)
    assert torch.equal(qr_pack.quantize_pack_keyed(x, 4, keys, norm),
                       _keyed_pack_plain(x, 4, keys, norm))
    big = _rows(3, 1001, cuda_device, 3)
    x = big[:, 1:]                               # rows 4 bytes off alignment
    norm = quant.l2_norm(x)
    keys = _keys(3, 4)
    u = prng.uniform(keys, 1000, device=cuda_device)
    words = qr_pack.quantize_pack_keyed(x, 8, keys, norm)
    assert torch.equal(words, _keyed_pack_plain(x.contiguous(), 8, keys, norm))
    assert torch.equal(words, qr_pack.quantize_pack_with_uniforms(
        x, 8, u, norm))


def _value_rows(rows, n, r, device, seed):
    """(rows, n) (1+r)-bit codes with every sign over level 0 and the top
    level in row 0's head, packed; norms positive, 0 and NaN."""
    gen = torch.Generator(device=device).manual_seed(seed)
    codes = torch.randint(0, 1 << (1 + r), (rows, n), generator=gen,
                          device=device, dtype=torch.int64)
    head = torch.tensor([0, 1 << r, 1, (1 << r) | 1, (1 << r) - 1,
                         (2 << r) - 1], dtype=torch.int64, device=device)
    m = min(n, head.numel())
    codes[0, :m] = head[:m]
    codes = ref.to_i32(codes)
    norm = torch.rand(rows, generator=gen, device=device) + 0.5
    if rows > 1:
        norm[1] = 0.0
    if rows > 2:
        norm[2] = float("nan")
    return pack.pack_codes(codes, 1 + r), norm


@pytest.mark.parametrize("rows,n,r", [
    (5, 50176, 8), (5, 10, 8), (3, 1, 4), (3, 1001, 1), (3, 4096, 16),
    (2, 33, 31), (3, 2083, 4), (4, 1 << 24, 8)])
def test_unpack_qr_values_matches_plain(cuda_device, rows, n, r):
    """K9 decoding to values: bit-equal to the plain chain (K9's plain
    version, then ``ref.qr_values``), -0.0 included, on n = 1, ragged n,
    r = 1 to 31 and a long row; +0.0 where the norm is 0 or NaN."""
    words, norm = _value_rows(rows, n, r, cuda_device, n + r)
    got = pack.unpack_qr_values(words, r, n, norm)
    want = ref.qr_values(ref.unpack_codes(words, 1 + r, n), norm, r)
    assert got.dtype == torch.float32 and _same_bits(got, want)
    if n > 1:
        assert torch.signbit(got[0, 1]) and got[0, 1] == 0
    if rows > 2:
        assert not torch.signbit(got[1:3]).any() and not got[1:3].any()


def test_unpack_entries_take_misaligned_words(cuda_device):
    """Word rows that start off a 16-byte boundary (a view one word in, and
    n32 * b not a multiple of 4): both K9 entries stay bit-equal to their
    plain versions."""
    words, norm = _value_rows(3, 2083, 8, cuda_device, 5)
    assert words.shape[1] % 4 == 2               # rows 8 bytes apart from 16
    want_codes = ref.unpack_codes(words, 9, 2083)
    want = ref.qr_values(want_codes, norm, 8)
    for lead in (1, 2, 3):
        buf = torch.zeros(words.numel() + lead, dtype=torch.int32,
                          device=cuda_device)
        buf[lead:] = words.reshape(-1)
        w = buf[lead:].view(words.shape)         # contiguous, `lead` words in
        assert torch.equal(pack.unpack_codes(w, 9, 2083), want_codes)
        assert _same_bits(pack.unpack_qr_values(w, 8, 2083, norm), want)


@pytest.mark.parametrize("n", [10, 50176, 1 << 24])
def test_k7_k9_entries_are_one_kernel_a_call(cuda_device, n):
    """The keyed K7 (host keys of 5 rows ride in the launch), both K9
    entries and ``ops.unpack_qr_values`` run one kernel on the card a call;
    ``ops.quantize_pack`` two (K3, keyed K7)."""
    rows = 5 if n != 1 << 24 else 4
    x = _rows(rows, n, cuda_device, n)
    keys = _keys(rows, n)
    norm = quant.l2_norm(x)
    words = qr_pack.quantize_pack_keyed(x, 8, keys, norm)
    for fn in (lambda: qr_pack.quantize_pack_keyed(x, 8, keys, norm),
               lambda: pack.unpack_codes(words, 9, n),
               lambda: pack.unpack_qr_values(words, 8, n, norm),
               lambda: ops.unpack_qr_values(words, 8, n, norm)):
        names = _device_ops(fn)
        assert len(names) == 1, names
    assert len(_device_ops(lambda: ops.quantize_pack(x, 8, keys))) == 2


def test_ops_quantize_pack_draws_no_torch_uniforms(cuda_device, monkeypatch):
    """On a CUDA tensor ``ops.quantize_pack`` is K3 and the keyed K7, calls
    no ``prng.uniform``, and gives the plain chain's words and norm."""
    from repro_torch import prng

    def refuse(*args, **kwargs):
        raise AssertionError("prng.uniform called on the CUDA path")

    x = _rows(5, 50176, cuda_device, 7)
    keys = _keys(5, 7, high=False)
    norm = quant.l2_norm(x)
    want = _keyed_pack_plain(x, 8, keys, norm)
    monkeypatch.setattr(prng, "uniform", refuse)
    words, got_norm = ops.quantize_pack(x, 8, keys)
    assert torch.equal(words, want) and torch.equal(got_norm, norm)


@pytest.mark.parametrize("rows,n,k,cap,r", [
    (5, 50176, 12544, 12544, 4), (5, 50176, 25088, 25088, 16),
    (5, 10, 2, 2, 4), (3, 1000, 100, 250, 8), (3, 777, 77, 77, 16),
    (2, 1, 1, 1, 4), (2, 5000, 2000, 100, 1)])
def test_compact_code_slots_matches_plain(cuda_device, rows, n, k, cap, r):
    x = _rows(rows, n, cuda_device, n + cap + r)
    x[0, : n // 3] = 0.0                         # underfull support
    if rows > 2:
        x[2] = 0.25                              # all tied: overflow
        x[1, 0] = 1e4                            # saturates the top level
    u = torch.rand((rows, n), device=cuda_device)
    t = topk.threshold_bits(x, k)
    keep = ref.mag_bits(x) >= t[:, None]
    norm = quant.l2_norm(torch.where(keep, x, torch.zeros_like(x)))
    idx, codes, nnz = sel.compact_code_slots(x, u, norm, t, r, cap)
    idx_r, codes_r, nnz_r = ref.compact_code_slots(x, u, norm, t, r, cap)
    assert torch.equal(idx, idx_r) and torch.equal(nnz, nnz_r)
    assert torch.equal(codes, codes_r)


def test_launch_counters_count_cuda_launches(cuda_device):
    x = _rows(4, 256, cuda_device, 0)
    keys = torch.zeros((4, 2), dtype=torch.int64)
    ops.reset_launch_counts()
    ops.topk_mask(x, 10)
    ops.quantize_qr(x, 4, keys)
    ops.topk_slots(x, 10, 10)
    words, norm = ops.quantize_pack(x, 4, keys)
    ops.unpack_codes(words, 5, 256)
    ops.unpack_qr_values(words, 4, 256, norm)
    ops.pack_codes(torch.zeros((4, 256), dtype=torch.int32,
                               device=cuda_device), 5)
    ops.topk_qr_slots(x, 10, 10, 4, keys)
    quant.quantize_qr_with_uniforms(x, 4, torch.rand_like(x),
                                    quant.l2_norm(x))
    qr_pack.quantize_pack_with_uniforms(x, 4, torch.rand_like(x), norm)
    torch.cuda.synchronize()
    assert ops.launch_counts() == {
        "topk_threshold_bits": 1, "topk_mask": 0, "topk_threshold_mask": 2,
        "l2_norm": 4, "quantize_qr": 2, "compact_slots": 1,
        "compact_code_slots": 1, "quantize_pack_with_uniforms": 1,
        "quantize_pack_keyed": 1, "pack_codes": 2, "unpack_codes": 1,
        "unpack_qr_values": 1, "rglru_scan": 0, "wkv6_scan": 0,
        "flash_attention": 0}


def _device_ops(fn):
    """The device operations (kernels, copies, memsets) of one call of
    ``fn``, after a warm-up call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]


@pytest.mark.parametrize("n", [1, 3, 7, 777, 4096, 50176, 50177])
def test_threshold_mask_matches_plain(cuda_device, n):
    """K1 and K2 in one launch: the threshold and the float32 masked rows
    bit-equal to the plain versions on ties, +-0, subnormals, inf, n not a
    multiple of 4, k of 0, 1, n - 1, n and beyond n, and per-row k."""
    x = _topk_edge_rows(n, cuda_device)
    ks = [1, max(n - 1, 0), n // 2, 0, n, n + 5,
          torch.tensor([0, 1, max(n - 1, 0), n, n + 3], device=cuda_device)]
    for k in ks:
        thr, masked = topk.threshold_mask(x, k)
        want = ref.topk_threshold_bits(x, k)
        assert torch.equal(thr, want)
        assert masked.dtype == torch.float32
        assert _same_bits(masked, ref.mask_by_threshold(x, want))


def test_threshold_mask_bf16_and_past_the_shared_memory_capacity(cuda_device):
    """bf16 rows come back as float32 masked rows (``topk_mask`` casts them
    back); rows past the clusters' shared memory take K1 then K2."""
    x = _rows(3, 4099, cuda_device, 5).to(torch.bfloat16)
    thr, masked = topk.threshold_mask(x, 410)
    assert torch.equal(thr, ref.topk_threshold_bits(x, 410))
    assert _same_bits(masked, ref.mask_by_threshold(x, thr).float())
    assert torch.equal(topk.topk_mask(x, 410).float(), masked)
    n = topk.resident_max_n() + 4
    x = _rows(2, n, cuda_device, 6)
    ops.reset_launch_counts()
    thr, masked = topk.threshold_mask(x, n // 10)
    torch.cuda.synchronize()
    assert torch.equal(thr, ref.topk_threshold_bits(x, n // 10))
    assert _same_bits(masked, ref.mask_by_threshold(x, thr))
    counts = ops.launch_counts()
    assert (counts["topk_threshold_bits"], counts["topk_mask"],
            counts["topk_threshold_mask"]) == (1, 1, 0)


@pytest.mark.parametrize("n", [10, 50176])
def test_threshold_mask_is_one_kernel_a_call(cuda_device, n):
    """One ``threshold_mask`` call runs one kernel on the card and adds one
    to its own count."""
    x = _rows(5, n, cuda_device, n)
    topk.LAUNCHES["topk_threshold_mask"] = 0
    names = _device_ops(lambda: topk.threshold_mask(x, max(1, n // 3)))
    assert topk.LAUNCHES["topk_threshold_mask"] == 2
    assert len(names) == 1, names


def _lookback_case(case, device):
    """(x, k, cap, r) of K5's and K6's one-launch cases: tiles of 4096
    elements (K5 takes two a block)."""
    if case == "cap in the second tile":
        return _rows(3, 50176, device, 11), 12544, 1500, 4
    if case == "cap in the last tile":
        return _rows(3, 50176, device, 12), 12544, 12444, 16
    if case == "cap 0":
        return _rows(3, 50176, device, 13), 12544, 0, 4
    if case == "ties, zero row, cap above nnz, n = 50177":
        x = _rows(4, 50177, device, 14)
        x[1] = 0.25                              # all ties, past cap
        x[2] = 0.0                               # no survivor
        x[3, 100:] = 0.0                         # 100 survivors
        return x, 1000, 7000, 8
    if case == "74 tiles":
        return _rows(3, 300000, device, 15), 75000, 75000, 4
    raise ValueError(case)


@pytest.mark.parametrize("case", [
    "cap in the second tile", "cap in the last tile", "cap 0",
    "ties, zero row, cap above nnz, n = 50177", "74 tiles"])
def test_compact_code_slots_one_launch_cases(cuda_device, case):
    """K6's one launch bit-equal to the plain version where cap falls in
    its second and last tile, at 0 and above nnz, past an all-tie row, on
    a zero row and over 74 tiles a row; twice, the second call on the
    workspace the first tagged."""
    x, k, cap, r = _lookback_case(case, cuda_device)
    u = torch.rand(x.shape, device=cuda_device)
    t = topk.threshold_bits(x, k)
    norm = quant.l2_norm(ref.mask_by_threshold(x, t))
    want = ref.compact_code_slots(x, u, norm, t, r, cap)
    for _ in range(2):
        got = sel.compact_code_slots(x, u, norm, t, r, cap)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.parametrize("case", [
    "cap in the second tile", "cap in the last tile", "cap 0",
    "ties, zero row, cap above nnz, n = 50177", "74 tiles", "bf16"])
def test_compact_slots_one_launch_cases(cuda_device, case):
    """K5's one launch bit-equal to the plain version on K6's look-back
    cases and on bf16 rows (values cast back); twice, with a K6 launch on
    the shared workspace between the two."""
    if case == "bf16":
        x, k, cap = _rows(3, 9000, cuda_device, 16).to(torch.bfloat16), 2700, 2700
    else:
        x, k, cap, _ = _lookback_case(case, cuda_device)
    t = topk.threshold_bits(x, k)
    want = ref.compact_slots(x, t, cap)
    u = torch.rand(x.shape, device=cuda_device)
    norm = quant.l2_norm(ref.mask_by_threshold(x, t).float())
    for _ in range(2):
        got = sel.compact_slots(x, t, cap)
        assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
        assert got[1].dtype == x.dtype
        assert torch.equal(got[1].float().view(torch.int32),
                           want[1].float().view(torch.int32))
        sel.compact_code_slots(x, u, norm, t, 4, cap)


@pytest.mark.parametrize("n", [10, 50176, 1 << 24])
def test_compact_slots_is_one_kernel_a_call(cuda_device, n):
    """One K5 call runs one kernel on the card: no fill, no scratch."""
    rows = 5 if n != 1 << 24 else 4
    x = _rows(rows, n, cuda_device, n)
    cap = max(1, n // 4)
    t = topk.threshold_bits(x, cap)
    sel.LAUNCHES["compact_slots"] = 0
    names = _device_ops(lambda: sel.compact_slots(x, t, cap))
    assert sel.LAUNCHES["compact_slots"] == 2
    assert len(names) == 1, names


@pytest.mark.parametrize("n", [10, 50176])
def test_compact_code_slots_is_one_kernel_a_call(cuda_device, n):
    """One K6 call runs one kernel on the card: no fill, no scratch."""
    x = _rows(5, n, cuda_device, n)
    u = torch.rand(x.shape, device=cuda_device)
    cap = max(1, n // 4)
    t = topk.threshold_bits(x, cap)
    norm = quant.l2_norm(ref.mask_by_threshold(x, t))
    sel.LAUNCHES["compact_code_slots"] = 0
    names = _device_ops(lambda: sel.compact_code_slots(x, u, norm, t, 4, cap))
    assert sel.LAUNCHES["compact_code_slots"] == 2
    assert len(names) == 1, names


def test_packed_k25_q4_round_launch_counts(cuda_device):
    """One FedComLoc-Com round with Compose(TopK(0.25), QuantQr(4)) on the
    packed wire launches, once a leaf: K1 + K2 in one launch, K3, K6, K8
    (encode) and K9's values entry (decode); nothing else."""
    from repro_torch import prng
    from repro_torch.compress import Compose, QuantQr, TopK
    from repro_torch.core import fed_data
    from repro_torch.core.fedcomloc import FedComLoc, FedComLocConfig
    from repro_torch.data import dirichlet, synthetic
    from repro_torch.models import small

    ds = synthetic.make_mnist_like(n_train=800, n_test=100)
    parts = dirichlet.dirichlet_partition(ds.y_train, n_clients=20,
                                          alpha=0.7, seed=0)
    model = small.MLP(784, 64, 10)
    data = fed_data.from_numpy_partition(ds.x_train, ds.y_train, parts,
                                         device="cuda")
    cfg = FedComLocConfig(gamma=0.1, p=0.1, n_clients=20, clients_per_round=5,
                          batch_size=32, variant="com")
    alg = FedComLoc(small.cross_entropy_loss(model.apply), data, cfg,
                    Compose(TopK(0.25), QuantQr(4)), wire="packed")
    state = alg.init(model.init(prng.PRNGKey(0), device=cuda_device))
    ops.reset_launch_counts()
    alg.round(state, prng.PRNGKey(1))
    torch.cuda.synchronize()
    leaves = 6
    want = {name: 0 for name in ops.launch_counts()}
    want.update({"topk_threshold_mask": leaves, "l2_norm": leaves,
                 "compact_code_slots": leaves, "pack_codes": leaves,
                 "unpack_qr_values": leaves})
    assert ops.launch_counts() == want


@pytest.mark.parametrize("comp_name,mode", [("QuantQr(8)", "account"),
                                            ("TopK(0.3)", "packed"),
                                            ("QuantQr(8)", "packed")])
def test_round_launch_counts_and_no_torch_uniforms(cuda_device, monkeypatch,
                                                   comp_name, mode):
    """One round of QuantQr(8) on the account wire launches K3 and the keyed
    K4 once a leaf, on the packed wire K3, the keyed K7 and K9's values
    entry once a leaf, and neither calls ``prng.uniform``; TopK(0.3) on the
    packed wire launches K1 and K5 once a leaf."""
    from repro_torch import prng
    from repro_torch.compress import QuantQr, TopK
    from repro_torch.core import fed_data
    from repro_torch.core.fedcomloc import FedComLoc, FedComLocConfig
    from repro_torch.data import dirichlet, synthetic
    from repro_torch.models import small

    ds = synthetic.make_mnist_like(n_train=800, n_test=100)
    parts = dirichlet.dirichlet_partition(ds.y_train, n_clients=20,
                                          alpha=0.7, seed=0)
    model = small.MLP(784, 64, 10)
    data = fed_data.from_numpy_partition(ds.x_train, ds.y_train, parts,
                                         device="cuda")
    cfg = FedComLocConfig(gamma=0.1, p=0.1, n_clients=20, clients_per_round=5,
                          batch_size=32, variant="com")
    comp = {"QuantQr(8)": QuantQr(8), "TopK(0.3)": TopK(0.3)}[comp_name]
    alg = FedComLoc(small.cross_entropy_loss(model.apply), data, cfg, comp,
                    wire=mode)
    state = alg.init(model.init(prng.PRNGKey(0), device=cuda_device))
    uniform = prng.uniform

    def host_only(key, n, device=None):
        assert n == 1, "a bulk prng.uniform draw in the round"
        return uniform(key, n, device)

    monkeypatch.setattr(prng, "uniform", host_only)
    ops.reset_launch_counts()
    alg.round(state, prng.PRNGKey(1))
    torch.cuda.synchronize()
    leaves = 6
    want = {name: 0 for name in ops.launch_counts()}
    if mode == "account":
        want.update({"l2_norm": leaves, "quantize_qr": leaves})
    elif comp_name == "QuantQr(8)":
        want.update({"l2_norm": leaves, "quantize_pack_keyed": leaves,
                     "unpack_qr_values": leaves})
    else:
        want.update({"topk_threshold_bits": leaves, "compact_slots": leaves})
    assert ops.launch_counts() == want


def test_stacked_cnn_forward_backward_matches_cpu(cuda_device):
    """The CNN over 5 stacked clients (one grouped convolution per conv
    layer, one bmm per dense layer) on the card against the CPU, logits,
    losses and gradients within 1e-4."""
    from repro_torch import prng
    from repro_torch import tree as tree_util
    from repro_torch.core.engine import value_and_grad
    from repro_torch.data import synthetic
    from repro_torch.models import small

    s, b = 5, 32
    ds = synthetic.make_cifar_like(n_train=s * b, n_test=10)
    model = small.CNN(3, 10, 32)
    keys = prng.split(prng.PRNGKey(3), s)
    cpu = tree_util.map(lambda *ls: torch.stack(ls),
                        *[model.init(k, device="cpu") for k in keys])
    xb = torch.from_numpy(ds.x_train.reshape(s, b, 32, 32, 3))
    yb = torch.from_numpy(ds.y_train.reshape(s, b).astype("int64"))
    loss_fn = small.cross_entropy_loss(model.apply)
    out = {}
    for dev in ("cpu", "cuda"):
        params = tree_util.map(lambda p: p.to(dev), cpu)
        logits = model.apply(params, xb.to(dev))
        losses, grads = value_and_grad(loss_fn, params, xb.to(dev),
                                       yb.to(dev))
        out[dev] = [logits, losses] + tree_util.leaves(grads)
    for a, g in zip(out["cpu"], out["cuda"]):
        torch.testing.assert_close(g.cpu(), a, rtol=1e-4, atol=1e-4)


def test_fig9_fedavg_topk_rounds_match_cpu(cuda_device):
    """Two rounds of Figure 9's sparseFedAvg (TopK(0.1)) on the CNN, on the
    card and on the CPU: cohorts, steps and bits equal, train loss within
    1e-4; the card launches K1 + K2 as one launch a leaf a round."""
    from repro_torch import prng
    from repro_torch.core import baselines, fed_data
    from repro_torch.data import dirichlet, synthetic
    from repro_torch.models import small

    ds = synthetic.make_cifar_like(n_train=1200, n_test=10, seed=1)
    parts = dirichlet.dirichlet_partition(ds.y_train, n_clients=10,
                                          alpha=0.7, seed=1)
    model = small.CNN(3, 10, 32)
    cfg = baselines.FedConfig(gamma=0.1, local_steps=10, n_clients=10,
                              clients_per_round=5, batch_size=32)
    runs = {}
    for dev in ("cuda", "cpu"):
        data = fed_data.from_numpy_partition(ds.x_train, ds.y_train, parts,
                                             device=dev)
        alg = baselines.SparseFedAvg(small.cross_entropy_loss(model.apply),
                                     data, cfg, density=0.1)
        ops.reset_launch_counts()
        _, m = alg.run_rounds(alg.init(model.init(prng.PRNGKey(0),
                                                  device=dev)),
                              prng.PRNGKey(1), 2)
        runs[dev] = (m, ops.launch_counts())
    (mg, counts), (mc, _) = runs["cuda"], runs["cpu"]
    for name in ("uplink_bits", "downlink_bits", "client_steps",
                 "client_uplink_bits", "clients_aggregated", "sim_time"):
        assert mg[name].tolist() == mc[name].tolist(), name
    torch.testing.assert_close(torch.from_numpy(mg["train_loss"]),
                               torch.from_numpy(mc["train_loss"]),
                               rtol=1e-4, atol=0)
    want = {name: 0 for name in counts}
    want["topk_threshold_mask"] = 2 * 10       # 10 leaves, 2 rounds
    assert counts == want


WKV6_YTOL = 1e-5


@pytest.mark.parametrize("b,t,d,off", [
    (8, 2560, 2560, 0), (1, 1, 96, 0), (3, 37, 300, 0), (2, 2565, 2579, 0),
    (4, 1, 2562, 0), (3, 47, 40, 0), (1, 2560, 2560, 0), (32, 81, 2560, 0),
    (32, 19, 2562, 0), (32, 9, 2579, 0), (32, 19, 2560, 1)])
def test_rglru_scan_bit_equal_to_plain(cuda_device, b, t, d, off):
    """Bit-equal y and h_T at the serving shape and at the slab kernel's
    edges: D not a multiple of 32 and D % 4 != 0, T = 1 and T not a
    multiple of its 32- or 8-step batches, B = 1 at D = 2560 (80 warps,
    under a wave), B = 32 (past 12 warps an SM: channel pairs), and there
    an odd D or views ``off`` floats past their allocation (not 8-byte
    aligned), which take a channel a lane."""
    gen = torch.Generator(device=cuda_device).manual_seed(t + d)
    n = b * t * d
    x = torch.randn(n + off, generator=gen, device=cuda_device)[off:]
    a = torch.rand(n + off, generator=gen, device=cuda_device)[off:]
    x, a = x.view(b, t, d), a.view(b, t, d)
    a[0, :, :8] = 1e-7                           # a ~ 0
    a[0, :, 8:16] = 1.0 - 1e-7                   # a ~ 1
    x[-1, :, :4] = 0.0
    y, h = rg.rglru_scan(x, a)
    y_r, h_r = ref.rglru_scan(x, a)
    assert _same_bits(y, y_r) and _same_bits(h, h_r)


def _wkv6_inputs(b, h, t, device, seed, dtype=torch.float32):
    gen = torch.Generator(device=device).manual_seed(seed)
    r, k, v = (0.5 * torch.randn((b, h, t, 64), generator=gen, device=device)
               for _ in range(3))
    w = torch.rand((b, h, t, 64), generator=gen, device=device)
    w[0, 0] = 1e-7                               # forget each step
    w[-1, -1] = 1.0 - 1e-7                       # remember everything
    u = 0.1 * torch.randn((h, 64), generator=gen, device=device)
    return r.to(dtype), k.to(dtype), v.to(dtype), w, u


def _wkv6_yardstick(args):
    """The plain version run in float64: (y, S_T)."""
    return ref.wkv6_scan(*(z.double() for z in args), dtype=torch.float64)


# K12's bf16 route, elementwise: |d| <= TOL + TOL * |plain| (y also one
# bf16 ulp of plain, its own rounding), the JAX package's tolerance for
# this kernel (tests/test_kernels.py), as chip_smoke.py states it
WKV6_BF16_TOL = 3e-4


def _assert_bf16_route_close(y, s, args):
    """The bf16 route against the plain version run in float64: over
    thousands of steps with w near 1 the float32 plain version's own
    rounding exceeds 3e-4."""
    y64, s64 = _wkv6_yardstick(args)
    _, e = torch.frexp(y64.float())
    ulp = torch.ldexp(torch.ones_like(y64), e - 8)
    tol_y = WKV6_BF16_TOL * (1.0 + y64.abs()) + ulp
    assert bool(((y.double() - y64).abs() <= tol_y).all())
    tol_s = WKV6_BF16_TOL * (1.0 + s64.abs())
    assert bool(((s.double() - s64).abs() <= tol_s).all())


@pytest.mark.parametrize("b,h,t,dtype", [
    (8, 40, 2560, torch.bfloat16), (1, 2, 1, torch.float32),
    (2, 3, 77, torch.float32)])
def test_wkv6_scan_matches_plain(cuda_device, b, h, t, dtype):
    """float32: S_T bit-equal, y within WKV6_YTOL of max |y|; bf16 (the
    chunked route): within its tolerance of the float64 plain version."""
    args = _wkv6_inputs(b, h, t, cuda_device, t + h, dtype)
    y, s = wkv6.wkv6_scan(*args)
    assert y.dtype == dtype and s.dtype == torch.float32
    if dtype == torch.bfloat16:
        _assert_bf16_route_close(y, s, args)
        return
    y_r, s_r = ref.wkv6_scan(*args)
    assert _same_bits(s, s_r)
    assert float((y - y_r).abs().max()) <= (
        WKV6_YTOL * float(y_r.float().abs().max()))


@pytest.mark.parametrize("t", [1, 15, 16, 17, 63, 64, 65, 77])
def test_wkv6_bf16_route_tails_and_decays(cuda_device, t):
    """The chunked route on ragged tails and at w = 1e-7 and 1 - 1e-7 (in
    ``_wkv6_inputs``), several (b, h)."""
    args = _wkv6_inputs(2, 3, t, cuda_device, 100 + t, torch.bfloat16)
    y, s = wkv6.wkv6_scan(*args)
    _assert_bf16_route_close(y, s, args)


def test_wkv6_bf16_route_holds_decays_over_a_whole_head(cuda_device):
    """w = 1e-7 (forget) and w = 1 - 1e-7 (remember) over 2560 steps."""
    args = _wkv6_inputs(1, 4, 2560, cuda_device, 7, torch.bfloat16)
    args[3][0, 1] = 1e-7
    args[3][0, 2] = 1.0 - 1e-7
    y, s = wkv6.wkv6_scan(*args)
    _assert_bf16_route_close(y, s, args)


def test_wkv6_bf16_route_refuses_unaligned_rows(cuda_device):
    """Rows 8 bytes off a 16-byte boundary (strides of 68 elements)."""
    args = _wkv6_inputs(1, 2, 40, cuda_device, 3, torch.bfloat16)
    views = []
    for z in args[:4]:
        pad = torch.zeros((1, 2, 40, 68), dtype=z.dtype, device=cuda_device)
        pad[..., 4:] = z
        views.append(pad[..., 4:])
    with pytest.raises(ValueError, match="16-byte"):
        wkv6.wkv6_scan(*views, args[4])


def test_wkv6_reads_strided_heads_in_place(cuda_device):
    """r/k/v/w as ``_heads`` views of (B, T, D) activations, as prefill
    passes them; y comes back as a view whose ``_unheads`` is free."""
    b, t, d = 2, 33, 256
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    acts = [torch.randn((b, t, d), generator=gen, device=cuda_device)
            for _ in range(3)]
    w = torch.rand((b, t, d), generator=gen, device=cuda_device)
    u = torch.randn((d // 64, 64), generator=gen, device=cuda_device)
    heads = [z.reshape(b, t, d // 64, 64).transpose(1, 2) for z in acts + [w]]
    y, s = wkv6.wkv6_scan(*heads, u)
    y_r, s_r = ref.wkv6_scan(*[z.contiguous() for z in heads], u)
    assert _same_bits(s, s_r)
    assert float((y - y_r).abs().max()) <= WKV6_YTOL * float(y_r.abs().max())
    assert y.transpose(1, 2).is_contiguous()


def test_served_rwkv6_prefill_launches_k12_per_layer(cuda_device):
    """rwkv6-3b at full width and depth in bf16 (the chunked route): one
    prefill launches K12 32 times, decode none; logits finite."""
    from repro_torch.launch import serve

    m = get_spec("rwkv6-3b").model
    params = tfm.init_params(m, torch.Generator(device=cuda_device)
                             .manual_seed(0))
    prompts = serve.prompts_for(m, 2, 80, cuda_device)
    ops.reset_launch_counts()
    res = serve.serve(params, m, prompts, 2)
    torch.cuda.synchronize()
    assert ops.launch_counts()["wkv6_scan"] == 32
    assert bool(torch.isfinite(res.prefill_logits).all())


@pytest.mark.parametrize("arch", ["rwkv6-3b", "recurrentgemma-2b"])
def test_reduced_prefill_launches_one_scan_per_recurrent_layer(cuda_device,
                                                              arch):
    m = reduced(get_spec(arch)).model
    params = tfm.init_params(m, torch.Generator(device=cuda_device)
                             .manual_seed(0))
    toks = torch.randint(0, m.vocab, (2, 48), device=cuda_device)
    ops.reset_launch_counts()
    logits, _ = tfm.prefill(params, m, toks, max_len=53)
    torch.cuda.synchronize()
    kinds = [m.block_type(i) for i in range(m.n_layers)]
    counts = ops.launch_counts()
    assert counts["rglru_scan"] == kinds.count("rglru")
    assert counts["wkv6_scan"] == kinds.count("rwkv")
    assert bool(torch.isfinite(logits).all())
