"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``: without a CUDA card every test skips.  Imports torch and
the port only (no JAX), so it runs on a GPU machine as

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

K1, K2 and K4 must be bit-equal to the plain versions; K3 within rtol
1e-5 (float32 sums in another order) and bit-equal to itself run to run.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import quantize as quant  # noqa: E402
from repro_torch.kernels import topk_compress as topk  # noqa: E402

pytestmark = pytest.mark.cuda


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


@pytest.mark.parametrize("rows,n,r", [(5, 50176, 8), (5, 10, 1), (3, 1001, 4)])
def test_qr_kernels_match_plain(cuda_device, rows, n, r):
    x = _rows(rows, n, cuda_device, n + r)
    x[1] = 0.0                                   # norm 0 -> all zero
    u = torch.rand((rows, n), device=cuda_device)
    norm = quant.l2_norm(x)
    assert torch.equal(norm, quant.l2_norm(x))
    torch.testing.assert_close(norm, ref.l2_norm(x), rtol=1e-5, atol=0.0)
    out = quant.quantize_qr_with_uniforms(x, r, u, norm)
    assert _same_bits(out, ref.quantize_qr_with_uniforms(x, r, u, norm))


def test_launch_counters_count_cuda_launches(cuda_device):
    x = _rows(4, 256, cuda_device, 0)
    ops.reset_launch_counts()
    ops.topk_mask(x, 10)
    ops.quantize_qr(x, 4, torch.zeros((4, 2), dtype=torch.int64))
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"topk_threshold_bits": 1, "topk_mask": 1,
                                   "l2_norm": 1, "quantize_qr": 1}
