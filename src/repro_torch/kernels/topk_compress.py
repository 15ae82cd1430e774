"""TopK radix threshold (K1) and mask (K2): wrappers and plain versions.

The port of ``repro.kernels.topk_compress``.  The functions take
row-batched ``(rows, n)`` input (one row per client's leaf) and dispatch
by the tensor's device: a CPU tensor runs the plain version in
:mod:`repro_torch.kernels.ref`; a CUDA tensor launches the hand-written
kernel in ``csrc/topk_compress.cu`` or raises.  bf16 input is cast to
float32 for the kernel (an exact order-embedding of the magnitudes).  K1
is one launch a call and allocates nothing but its output;
:func:`threshold_mask` (and so :func:`topk_mask`) runs K2 inside K1's
launch, and :func:`mask_by_threshold` is K2 alone, for a threshold
computed elsewhere.  :func:`radix_hist` is K1's histogram pass alone,
for the model-sharded wire: :func:`threshold_bits_sharded` walks its
counts after a reduction across the model ranks, one launch a digit and
leaf, one reduction a digit for all of a tree's sharded leaves.

``LAUNCHES`` counts kernel launches per wrapper (``topk_threshold_mask``
for K1 and K2 in one launch); only the CUDA path adds to it, so a CPU run
leaves it at 0.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

LAUNCHES = {"topk_threshold_bits": 0, "topk_mask": 0,
            "topk_threshold_mask": 0, "topk_radix_hist": 0}

# resident_max_n(), asked of the card once
_RESIDENT_MAX_N = None

_P = ctypes.c_void_p


def _bind(lib: ctypes.CDLL) -> None:
    lib.topk_threshold_bits.argtypes = [_P, _P, ctypes.c_int, ctypes.c_int,
                                        ctypes.c_longlong, _P, _P, _P]
    lib.topk_threshold_bits.restype = ctypes.c_int
    lib.topk_resident_max_n.argtypes = []
    lib.topk_resident_max_n.restype = ctypes.c_longlong
    lib.topk_mask_apply.argtypes = [_P, _P, _P, ctypes.c_int,
                                    ctypes.c_longlong, _P]
    lib.topk_mask_apply.restype = ctypes.c_int
    lib.topk_radix_hist.argtypes = [_P, ctypes.c_int, ctypes.c_longlong, _P,
                                    ctypes.c_int, _P, _P]
    lib.topk_radix_hist.restype = ctypes.c_int
    lib.topk_error_string.argtypes = [ctypes.c_int]
    lib.topk_error_string.restype = ctypes.c_char_p


def _lib() -> ctypes.CDLL:
    return build.load("topk_compress", _bind)


def _select(xf: torch.Tensor, k, thr: torch.Tensor, out) -> None:
    """Launches K1 on float32 rows ``xf`` (n > 0) into ``thr``, and K2 in
    the same launch where ``out`` (float32, xf's shape) is given."""
    rows, n = xf.shape
    if isinstance(k, torch.Tensor):
        kk = k.to(device=xf.device, dtype=torch.int32).contiguous()
        if kk.shape != (rows,):
            raise ValueError(f"k must be a scalar or ({rows},), got "
                             f"{tuple(kk.shape)}")
        k_ptr, k_scalar = kk.data_ptr(), 0
    else:       # any k >= n gives 0 and any k <= 0 gives 0xFFFFFFFF
        k_ptr, k_scalar = None, max(0, min(int(k), n))
    lib = _lib()
    code = lib.topk_threshold_bits(xf.data_ptr(), k_ptr, k_scalar, rows, n,
                                   thr.data_ptr(),
                                   None if out is None else out.data_ptr(),
                                   build.stream_ptr())
    build.check(code, "topk_threshold_bits", lib, "topk_error_string")


def _cuda_input(x: torch.Tensor) -> torch.Tensor:
    xf = build.cuda_rows(x)
    if xf.shape[1] >= 2 ** 31:
        raise ValueError(f"n must be below 2^31, got {xf.shape[1]}")
    return xf


def threshold_bits(x: torch.Tensor, k) -> torch.Tensor:
    """K1: per-row bit pattern (int64 holding uint32) of the k-th largest
    ``|x|``; ``k`` is an int or a per-row tensor.  ``k >= n`` gives 0 and
    ``k <= 0`` gives ``0xFFFFFFFF``."""
    if build.on_cpu(x):
        return ref.topk_threshold_bits(x, k)
    xf = _cuda_input(x)
    thr = torch.empty(xf.shape[0], dtype=torch.int64, device=xf.device)
    if xf.shape[1] == 0:
        return thr.zero_()
    _select(xf, k, thr, None)
    LAUNCHES["topk_threshold_bits"] += 1
    return thr


def threshold_mask(x: torch.Tensor, k):
    """K1 and K2 in one launch: ``(thr, masked)``, each row's threshold bit
    pattern as :func:`threshold_bits` gives it and the float32 rows
    ``where(bits >= thr[row], x, 0)`` (ties at the threshold kept; ``k >=
    n`` keeps the row, ``k <= 0`` zeroes it).

    Rows longer than :func:`resident_max_n` take K1 then K2's standalone
    kernel: there K1's clusters (one a row) read x from HBM again for the
    mask, and K2 alone streams it on every SM, which measured faster."""
    if build.on_cpu(x):
        thr = ref.topk_threshold_bits(x, k)
        return thr, ref.mask_by_threshold(x, thr).to(torch.float32)
    xf = _cuda_input(x)
    if xf.shape[1] > resident_max_n():
        thr = threshold_bits(xf, k)
        return thr, mask_by_threshold(xf, thr)
    thr = torch.empty(xf.shape[0], dtype=torch.int64, device=xf.device)
    out = torch.empty(xf.shape, dtype=torch.float32, device=xf.device)
    if xf.shape[1] == 0:
        return thr.zero_(), out
    _select(xf, k, thr, out)
    LAUNCHES["topk_threshold_mask"] += 1
    return thr, out


def resident_max_n() -> int:
    """The largest row K1 holds in its clusters' shared memory from the
    first pass on (longer rows are read from HBM until their candidates
    fit); needs the card."""
    global _RESIDENT_MAX_N
    if _RESIDENT_MAX_N is None:
        _RESIDENT_MAX_N = int(_lib().topk_resident_max_n())
    return _RESIDENT_MAX_N


def mask_by_threshold(x: torch.Tensor, thr: torch.Tensor) -> torch.Tensor:
    """K2: ``where(bits >= thr[row], x, 0)`` in x's dtype."""
    if build.on_cpu(x):
        return ref.mask_by_threshold(x, thr)
    xf = build.cuda_rows(x)
    rows, n = xf.shape
    thr = build.expect(thr, "thr", torch.int64, (rows,), xf.device)
    out = torch.empty_like(xf)
    if n == 0:
        return out.to(x.dtype)
    lib = _lib()
    code = lib.topk_mask_apply(build.ptr(xf), build.ptr(thr), build.ptr(out),
                               rows, n, build.stream_ptr())
    build.check(code, "topk_mask_apply", lib, "topk_error_string")
    LAUNCHES["topk_mask"] += 1
    return out.to(x.dtype)


def topk_mask(x: torch.Tensor, k) -> torch.Tensor:
    """K1 and K2 in one launch (:func:`threshold_mask`): zero all but each
    row's k largest-magnitude entries, in x's dtype (ties at the threshold
    kept; ``k >= n`` keeps every entry)."""
    return threshold_mask(x, k)[1].to(x.dtype)


def radix_hist(x: torch.Tensor, prefix: torch.Tensor,
               shift: int) -> torch.Tensor:
    """K1's histogram pass alone: each row's ``(256,)`` int32 counts of the
    8-bit magnitude digit at ``shift`` among the elements whose bits above
    it equal ``prefix[row]``'s (``ref.radix_digit_hist``).  ``prefix`` is
    ``(rows,)`` int64 on x's device."""
    if build.on_cpu(x):
        return ref.radix_digit_hist(ref.mag_bits(x), prefix,
                                    shift).to(torch.int32)
    xf = _cuda_input(x)
    rows, n = xf.shape
    prefix = build.expect(prefix, "prefix", torch.int64, (rows,), xf.device)
    hist = torch.zeros((rows, 256), dtype=torch.int32, device=xf.device)
    if n == 0:
        return hist
    lib = _lib()
    code = lib.topk_radix_hist(xf.data_ptr(), rows, n, prefix.data_ptr(),
                               int(shift), hist.data_ptr(),
                               build.stream_ptr())
    build.check(code, "topk_radix_hist", lib, "topk_error_string")
    LAUNCHES["topk_radix_hist"] += 1
    return hist


def threshold_bits_sharded(xs, ks, n_totals, reduce) -> list:
    """The exact TopK thresholds of rows sharded across ranks, for several
    row sets at once (the sharded leaves of a tree, each ``(rows, n_i)``
    with the same rows): ``xs[i]`` holds this rank's slice of each row of
    ``n_totals[i]`` elements, and ``reduce`` sums an ``(R, 256)`` int32
    histogram over the ranks (an all-reduce).  Four passes of
    :func:`radix_hist` a set, the sets' counts reduced together (one
    reduction a pass for all of them) and walked on the device
    (``ref.radix_walk``): every rank gets the bit patterns
    ``ref.topk_threshold_bits`` gives on the whole rows, ties included,
    with the edge conventions at ``n_totals[i]``."""
    xs = [x if build.on_cpu(x) else _cuda_input(x) for x in xs]
    rows, dev = xs[0].shape[0], xs[0].device
    k = torch.cat([ref._per_row(k_i, rows, dev) for k_i in ks])
    n_total = torch.tensor([int(n) for n in n_totals],
                           device=dev).repeat_interleave(rows)

    def hist(prefix, shift):
        return torch.cat([radix_hist(x, prefix[i * rows:(i + 1) * rows],
                                     shift) for i, x in enumerate(xs)])

    thr = ref.radix_walk(hist, k, rows * len(xs), n_total, dev, reduce)
    return list(thr.split(rows))
