"""K1h grouped (K1's histogram pass over many leaves in one launch, the
model axis's) against the JAX package, on the CPU.

* The plain grouped histograms (``ref.radix_digit_hist_grouped``, and the
  wrappers ``radix_hist_grouped`` / ``radix_hist`` on CPU tensors) equal
  JAX's ``ref.radix_digit_hist`` leaf by leaf and row by row, at every
  digit, under the prefixes of each row's true threshold: leaves of 1, 3,
  32, 64, 4097 and 2500 elements, rows 1-3, float32 and bf16, with ties,
  +-0 and subnormals.
* ``threshold_bits_sharded`` over several leaves, each row split into m =
  2 and 4 slices and the counts summed over a row's slices, equals JAX's
  Pallas ``threshold_bits`` (interpret mode) on the whole rows, with k of
  0, -1, n and beyond n and one leaf's k a row.
* ``hist_block_starts``, the kernel's block split, with the kernel's
  stride rule (float4s ``b * T + t + i * B * T`` from the slice's first
  16-byte boundary, the scalar head and tail in its first block) counts
  every element exactly once, for every alignment of the slice.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # xdist workers share the cores: no spinning OpenMP pools

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import topk_compress as jtopk  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import topk_compress as tk  # noqa: E402

SIZES = (1, 3, 32, 64, 4097, 2500)
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}

_jax_hist = jax.jit(jref.radix_digit_hist, static_argnums=2)
_jax_threshold = jax.jit(jref.topk_threshold_bits)


def _leaf(seed: int, rows: int, n: int, dtype: str):
    """Seeded Gaussian rows with ties, +-0 and subnormals (as float32 and
    bf16 survive them), as (torch tensor, the same values for JAX)."""
    x = np.random.default_rng(seed).standard_normal((rows, n)).astype(
        np.float32)
    x[0, ::7] = 0.5                                 # ties
    x[-1, : n // 3] = 0.0                           # zeros ...
    x[-1, 1: n // 3: 5] = -0.0                      # ... and -0.0
    x[0, 1::11] = 1e-40 if dtype == "float32" else 1e-39   # subnormals
    x[rows // 2, 2::13] = -3e-45 if dtype == "float32" else -2e-39
    tdt, jdt = DTYPES[dtype]
    xt = torch.from_numpy(x).to(tdt)
    return xt, jnp.asarray(xt.float().numpy()).astype(jdt)


def _high(shift: int) -> int:
    return (ref.ALL_ONES << (shift + 8)) & ref.ALL_ONES if shift + 8 < 32 \
        else 0


@pytest.mark.parametrize("dtype", ["float32", "bf16"])
@pytest.mark.parametrize("rows", [1, 2, 3])
def test_grouped_hist_matches_jax(rows, dtype):
    leaves = [_leaf(10 * rows + i, rows, n, dtype)
              for i, n in enumerate(SIZES)]
    xs = [t for t, _ in leaves]
    # each row's true threshold at k = n // 10, from JAX
    thr = [[int(_jax_threshold(xj[r], max(1, xj.shape[1] // 10)))
            for r in range(rows)] for _, xj in leaves]
    bits = [ref.mag_bits(x) for x in xs]
    for shift in ref.RADIX_SHIFTS:
        high = _high(shift)
        prefix = torch.tensor([t & high for ts in thr for t in ts],
                              dtype=torch.int64)
        got = tk.radix_hist_grouped(xs, prefix, shift)
        assert got.dtype == torch.int32 and got.shape == (len(xs) * rows,
                                                          256)
        assert torch.equal(got.long(), ref.radix_digit_hist_grouped(
            bits, prefix, shift))
        for i, (x, xj) in enumerate(leaves):
            part = slice(i * rows, (i + 1) * rows)
            assert torch.equal(tk.radix_hist(x, prefix[part], shift),
                               got[part])
            for r in range(rows):
                want = np.asarray(_jax_hist(jref._mag_bits(xj[r]),
                                            jnp.uint32(thr[i][r] & high),
                                            shift))
                np.testing.assert_array_equal(got[i * rows + r].numpy(),
                                              want)


def _summed(m: int):
    """The model ranks' reduction, emulated: each run of m rows (one row's
    slices) summed and given to all of them."""
    def reduce(h):
        s = h.reshape(-1, m, 256).sum(1, keepdim=True)
        return s.expand(-1, m, 256).reshape(h.shape)
    return reduce


@pytest.mark.parametrize("dtype", ["float32", "bf16"])
@pytest.mark.parametrize("m", [2, 4])
def test_sharded_thresholds_match_pallas(m, dtype):
    rows = 2
    ns = (4, 12, 32, 64, 4096, 2500, 8)
    leaves = [_leaf(100 + i, rows, n, dtype) for i, n in enumerate(ns)]
    # k beyond n, below 0, n, one k a row, inside the rows, 0
    ks = [9, -1, 32, [1, 63], 409, 250, 0]
    ks_port = [torch.tensor(k).repeat_interleave(m) if isinstance(k, list)
               else k for k in ks]
    slices = [x.reshape(rows * m, -1) for x, _ in leaves]
    tk.LAUNCHES["topk_radix_hist"] = 0
    got = tk.threshold_bits_sharded(slices, ks_port, ns, _summed(m))
    assert tk.LAUNCHES["topk_radix_hist"] == 0       # plain on the CPU
    for (x, xj), k, g in zip(leaves, ks, got):
        want = [int(jtopk.threshold_bits(
            xj[r], k[r] if isinstance(k, list) else k, interpret=True))
            for r in range(rows)]
        assert g.tolist() == [w for w in want for _ in range(m)], k


def _cover(n: int, head: int, blocks: int) -> np.ndarray:
    """How often the kernel's blocks count each of a slice's n elements,
    the slice ``head`` floats short of a 16-byte boundary."""
    T = tk.HIST_THREADS
    head = min(n, head)
    n4 = (n - head) // 4
    count = np.zeros(n, np.int64)
    count[:head] += 1                              # block 0's scalar head
    count[head + 4 * n4:] += 1                     # ... and its tail
    for b in range(blocks):
        i = np.arange(b * T, n4, blocks * T)[:, None] + np.arange(T)
        i = i[i < n4]                              # b*T + t + j*B*T
        for q in range(4):
            np.add.at(count, head + 4 * i + q, 1)
    return count


@pytest.mark.parametrize("ns,rows,max_blocks", [
    ((1, 3, 32, 64, 4097, 2500), 1, tk.HIST_MAX_BLOCKS),
    ((1, 3, 32, 64, 4097, 2500), 3, tk.HIST_MAX_BLOCKS),
    ((200_003, 64, 70_000, 1, 33), 2, 16),        # the cap binds
    ((0, 5, 8191, 123_457), 4, 8)])
def test_block_split_covers_every_element_once(ns, rows, max_blocks):
    starts = tk.hist_block_starts(ns, rows, max_blocks)
    assert starts[0] == 0 and len(starts) == len(ns) + 1
    blocks = np.diff(starts)
    assert (blocks >= 1).all()
    per = max(tk.HIST_MIN_PER_BLOCK, -(-sum(ns) // max(1, max_blocks // rows)))
    assert starts[-1] <= max(1, max_blocks // rows) + len(ns)
    for n, b in zip(ns, blocks):
        assert b == max(1, -(-n // per))            # in proportion to n
        for head in range(4):
            assert (_cover(n, head, int(b)) == 1).all(), (n, b, head)


def test_block_split_of_the_sharded_embedding():
    """qwen2-0.5b's embedding slice beside two bias slices at m = 2: the
    embedding takes all but a few of a row's blocks under the grid cap."""
    ns = (151936 * 896 // 2, 32, 64)
    starts = tk.hist_block_starts(ns, 2)
    cap = tk.HIST_MAX_BLOCKS // 2
    assert starts[1] >= cap - 8 and starts[-1] <= cap + len(ns)
    assert list(np.diff(starts)[1:]) == [1, 1]
