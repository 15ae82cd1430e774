"""QSGD Q_r: sum of squares (K3) and stochastic rounding (K4) — wrappers
and plain versions.

The port of ``repro.kernels.quantize``.  Both functions take row-batched
``(rows, n)`` input (one row per client's leaf) and dispatch by the
tensor's device: a CPU tensor runs the plain version in
:mod:`repro_torch.kernels.ref`; a CUDA tensor launches the hand-written
kernel in ``csrc/quantize.cu`` or raises.  K4 takes the norm as an input
and has two entries: :func:`quantize_qr_with_uniforms` reads the uniforms
(the JAX function's counterpart), :func:`quantize_qr_keyed` draws them in
the kernel from the rows' threefry keys, bit for bit
``jax.random.uniform``'s, with one r for every row or one r a row.  Both
are bit-equal to the plain version given the same norm and uniforms.

``LAUNCHES`` counts kernel launches per wrapper; only the CUDA path adds
to it, so a CPU run leaves it at 0.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch import prng
from repro_torch.kernels import build, ref

# "quantize_qr" counts both of K4's entries; "sum_squares" is K3 without
# its sqrt (the model-sharded wire's entry)
LAUNCHES = {"l2_norm": 0, "sum_squares": 0, "quantize_qr": 0}

# K3's scratch per (device index, stream): (uint32 counters in int32
# containers, zeroed once and left at 0 by every launch; float32 partials).
# A launch on another stream may run at the same time and must not share
# the counters; launches on one stream run in order and can.
_NORM_SCRATCH: dict = {}
_NORM_CHUNK = 8192        # elements a K3 block, about
_NORM_MAX_PARTS = 512     # K3 blocks a row, at most (csrc/quantize.cu)
_NORM_MAX_BLOCKS = 132 * 16

_P = ctypes.c_void_p


def _bind(lib: ctypes.CDLL) -> None:
    lib.qr_l2_norm.argtypes = [_P, ctypes.c_int, ctypes.c_longlong, _P, _P,
                               ctypes.c_int, _P, _P]
    lib.qr_l2_norm.restype = ctypes.c_int
    lib.qr_sum_squares.argtypes = lib.qr_l2_norm.argtypes
    lib.qr_sum_squares.restype = ctypes.c_int
    lib.qr_quantize.argtypes = [_P, _P, _P, _P, ctypes.c_int,
                                ctypes.c_longlong, ctypes.c_float, _P]
    lib.qr_quantize.restype = ctypes.c_int
    lib.qr_quantize_keyed.argtypes = [_P, _P, _P, _P, _P, ctypes.c_int,
                                      ctypes.c_longlong, ctypes.c_float, _P,
                                      _P]
    lib.qr_quantize_keyed.restype = ctypes.c_int
    lib.qr_error_string.argtypes = [ctypes.c_int]
    lib.qr_error_string.restype = ctypes.c_char_p


def _lib() -> ctypes.CDLL:
    return build.load("quantize", _bind)


def norm_parts(rows: int, n: int) -> int:
    """K3's blocks a row for ``rows`` rows of ``n`` elements: one a
    ``_NORM_CHUNK`` elements, within ``_NORM_MAX_BLOCKS`` in all and
    ``_NORM_MAX_PARTS`` a row.  The order of K3's sums depends on it (and
    on whether x is 16-byte aligned), never on the run."""
    cap = min(_NORM_MAX_BLOCKS // rows, _NORM_MAX_PARTS)
    return max(1, min(-(-n // _NORM_CHUNK), cap))


def _norm_scratch(device: torch.device, stream: int, rows: int,
                  n_partials: int) -> tuple:
    """K3's counters and partials for ``stream``, grown when too small."""
    key = (device.index, stream)
    have = _NORM_SCRATCH.get(key)
    if have is None or have[0].numel() < rows or have[1].numel() < n_partials:
        old_rows, old_parts = (0, 0) if have is None else (
            have[0].numel(), have[1].numel())
        have = (torch.zeros(max(rows, old_rows), dtype=torch.int32,
                            device=device),
                torch.empty(max(n_partials, old_parts), dtype=torch.float32,
                            device=device))
        _NORM_SCRATCH[key] = have
    return have


def _sumsq_launch(x: torch.Tensor, entry: str) -> torch.Tensor:
    """K3's one launch through ``entry`` (``qr_l2_norm`` or
    ``qr_sum_squares``) on CUDA rows: (rows,) float32."""
    xf = build.cuda_rows(x)
    rows, n = xf.shape
    out = xf.new_empty(rows)
    if n == 0:
        return out.zero_()
    lib = _lib()
    parts = norm_parts(rows, n)
    stream = build.stream_ptr()
    count, partial = _norm_scratch(out.device, stream, rows, rows * parts)
    code = getattr(lib, entry)(xf.data_ptr(), rows, n, partial.data_ptr(),
                               count.data_ptr(), parts, out.data_ptr(),
                               stream)
    build.check(code, entry, lib, "qr_error_string")
    return out


def l2_norm(x: torch.Tensor) -> torch.Tensor:
    """K3: per-row ``sqrt(sum x**2)`` (float32), deterministic on the card:
    one launch, no scratch allocated per call."""
    if build.on_cpu(x):
        return ref.l2_norm(x)
    norm = _sumsq_launch(x, "qr_l2_norm")
    LAUNCHES["l2_norm"] += 1
    return norm


def sum_squares(x: torch.Tensor) -> torch.Tensor:
    """K3 without its sqrt: per-row ``sum x**2`` (float32), the value
    :func:`l2_norm` takes the square root of, bit for bit.  The sharded
    wire sums it over the model ranks before the root."""
    if build.on_cpu(x):
        return ref.sum_squares(x)
    out = _sumsq_launch(x, "qr_sum_squares")
    LAUNCHES["sum_squares"] += 1
    return out


def quantize_qr_with_uniforms(x: torch.Tensor, r: int, u: torch.Tensor,
                              norm: torch.Tensor) -> torch.Tensor:
    """K4: Q_r of each row against ``norm[row]`` with uniforms ``u``
    (``(rows, n)`` float32), in x's dtype."""
    if build.on_cpu(x):
        return ref.quantize_qr_with_uniforms(x, r, u, norm)
    xf = build.cuda_rows(x)
    rows, n = xf.shape
    r = int(r)
    if not 1 <= r <= 126:
        raise ValueError(f"r must be in [1, 126], got {r}")
    u = build.expect(u, "u", torch.float32, (rows, n), xf.device)
    norm = build.expect(norm, "norm", torch.float32, (rows,), xf.device)
    out = torch.empty_like(xf)
    if n == 0:
        return out.to(x.dtype)
    lib = _lib()
    code = lib.qr_quantize(build.ptr(xf), build.ptr(u), build.ptr(norm),
                           build.ptr(out), rows, n, float(2 ** r),
                           build.stream_ptr())
    build.check(code, "qr_quantize", lib, "qr_error_string")
    LAUNCHES["quantize_qr"] += 1
    return out.to(x.dtype)


def row_levels(r: torch.Tensor, rows: int, device) -> torch.Tensor:
    """Per-row level counts ``float32(2 ** r[row])`` on ``device`` for a
    ``(rows,)`` integer ``r`` in [1, 126], each exact."""
    r = torch.as_tensor(r)
    if r.shape != (rows,) or r.dtype.is_floating_point or r.dtype == torch.bool:
        raise ValueError(f"per-row r must be an integer ({rows},) tensor, got "
                         f"{r.dtype} {tuple(r.shape)}")
    if not bool(((r >= 1) & (r <= 126)).all()):
        raise ValueError(f"r must be in [1, 126], got {r.tolist()}")
    return ref.qr_levels(r.cpu(), rows, "cpu")[:, 0].to(device)


def quantize_qr_keyed(x: torch.Tensor, r, keys: torch.Tensor,
                      norm: torch.Tensor) -> torch.Tensor:
    """K4 drawing its own uniforms: Q_r of each row against ``norm[row]``
    with row ``i``'s uniforms ``jax.random.uniform(keys[i], (n,))``, in x's
    dtype.  ``keys`` is the ``(rows, 2)`` int64 key data holding uint32
    words, on the host or on x's device.  ``r`` is an int, or a ``(rows,)``
    integer tensor giving each row its own r (per-client overrides): the
    kernel then reads each row's level count ``2 ** r[row]`` from a
    device array, which takes one copy to x's device.

    Up to ``build.KEYS_BY_VALUE`` rows of host keys travel in the launch's
    parameters, so the call with a scalar r is one device operation; more
    rows, or keys elsewhere, take one copy to x's device."""
    if build.on_cpu(x):
        return ref.quantize_qr_with_uniforms(
            x, r, prng.uniform(keys, x.shape[-1]), norm)
    xf = build.cuda_rows(x)
    rows, n = xf.shape
    if isinstance(r, torch.Tensor):
        per_row = row_levels(r, rows, xf.device)
        levels = 0.0
    else:
        r = int(r)
        if not 1 <= r <= 126:
            raise ValueError(f"r must be in [1, 126], got {r}")
        per_row, levels = None, float(2 ** r)
    if n >= 2 ** 32:
        raise ValueError(f"n must be below 2**32, got {n}")
    norm = build.expect(norm, "norm", torch.float32, (rows,), xf.device)
    out = torch.empty_like(xf)
    if n == 0:
        return out.to(x.dtype)
    lib = _lib()
    keys, dev_ptr, host_ptr = build.key_args(keys, rows, xf.device)
    code = lib.qr_quantize_keyed(xf.data_ptr(), dev_ptr, host_ptr,
                                 norm.data_ptr(), out.data_ptr(), rows, n,
                                 levels, None if per_row is None
                                 else per_row.data_ptr(), build.stream_ptr())
    build.check(code, "qr_quantize_keyed", lib, "qr_error_string")
    LAUNCHES["quantize_qr"] += 1
    return out.to(x.dtype)
