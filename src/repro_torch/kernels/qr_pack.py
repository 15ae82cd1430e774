"""Fused Q_r quantize + bit-plane pack (K7): wrappers and plain version.

The port of ``repro.kernels.qr_pack``.  Takes row-batched ``(rows, n)``
input (one row per client's leaf) and dispatches by the tensor's device:
a CPU tensor runs the plain version in :mod:`repro_torch.kernels.ref`; a
CUDA tensor launches the hand-written kernel in ``csrc/qr_pack.cu`` or
raises.  K7 takes the norm as an input and has two entries:
:func:`quantize_pack_with_uniforms` reads the uniforms (the JAX
function's counterpart), :func:`quantize_pack_keyed` draws them in the
kernel from the rows' threefry keys, bit for bit ``jax.random.uniform``'s.
Both are bit-equal to the plain version given the same norm and uniforms.

``LAUNCHES`` counts kernel launches; only the CUDA path adds to it, so a
CPU run leaves it at 0.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch import prng
from repro_torch.kernels import build, ref

LAUNCHES = {"quantize_pack_with_uniforms": 0, "quantize_pack_keyed": 0}

#: Widest quantizer the packed codes carry: codes stay float32-exact
#: integers and fit a uint32 word with their sign bit.
MAX_R = 16

_P = ctypes.c_void_p


def _bind(lib: ctypes.CDLL) -> None:
    lib.qr_pack_codes.argtypes = [_P, _P, _P, ctypes.c_int, ctypes.c_longlong,
                                  ctypes.c_int, _P, _P]
    lib.qr_pack_codes.restype = ctypes.c_int
    lib.qr_pack_codes_keyed.argtypes = [_P, _P, _P, _P, ctypes.c_int,
                                        ctypes.c_longlong, ctypes.c_int, _P,
                                        _P]
    lib.qr_pack_codes_keyed.restype = ctypes.c_int
    lib.qr_pack_error_string.argtypes = [ctypes.c_int]
    lib.qr_pack_error_string.restype = ctypes.c_char_p


def _lib() -> ctypes.CDLL:
    return build.load("qr_pack", _bind)


def _cuda_input(x: torch.Tensor, r: int):
    xf = build.cuda_rows(x)
    r = int(r)
    if not 1 <= r <= MAX_R:
        raise ValueError(f"r must be in [1, {MAX_R}], got {r}")
    return xf, r


def quantize_pack_with_uniforms(x: torch.Tensor, r: int, u: torch.Tensor,
                                norm: torch.Tensor) -> torch.Tensor:
    """K7: each row's (1+r)-bit Q_r codes against ``norm[row]`` with
    uniforms ``u`` (``(rows, n)`` float32), packed into
    ``(rows, ceil(n/32) * (1+r))`` words (int32 containers)."""
    if build.on_cpu(x):
        return ref.quantize_pack_with_uniforms(x, r, u, norm)
    xf, r = _cuda_input(x, r)
    rows, n = xf.shape
    u = build.expect(u, "u", torch.float32, (rows, n), xf.device)
    norm = build.expect(norm, "norm", torch.float32, (rows,), xf.device)
    words = torch.empty((rows, -(-n // 32) * (1 + r)), dtype=torch.int32,
                        device=xf.device)
    if n == 0:
        return words
    lib = _lib()
    code = lib.qr_pack_codes(build.ptr(xf), build.ptr(u), build.ptr(norm),
                             rows, n, r, build.ptr(words), build.stream_ptr())
    build.check(code, "qr_pack_codes", lib, "qr_pack_error_string")
    LAUNCHES["quantize_pack_with_uniforms"] += 1
    return words


def quantize_pack_keyed(x: torch.Tensor, r: int, keys: torch.Tensor,
                        norm: torch.Tensor) -> torch.Tensor:
    """K7 drawing its own uniforms: each row's (1+r)-bit Q_r codes against
    ``norm[row]`` with row ``i``'s uniforms ``jax.random.uniform(keys[i],
    (n,))``, packed into ``(rows, ceil(n/32) * (1+r))`` words.  ``keys``
    is the ``(rows, 2)`` int64 key data holding uint32 words, on the host
    or on x's device.

    Up to ``build.KEYS_BY_VALUE`` rows of host keys travel in the launch's
    parameters, so the call is one device operation; more rows, or keys
    elsewhere, take one copy to x's device."""
    if build.on_cpu(x):
        return ref.quantize_pack_with_uniforms(
            x, r, prng.uniform(keys, x.shape[-1]), norm)
    xf, r = _cuda_input(x, r)
    rows, n = xf.shape
    if n >= 2 ** 32:
        raise ValueError(f"n must be below 2**32, got {n}")
    norm = build.expect(norm, "norm", torch.float32, (rows,), xf.device)
    words = torch.empty((rows, -(-n // 32) * (1 + r)), dtype=torch.int32,
                        device=xf.device)
    if n == 0:
        return words
    lib = _lib()
    keys, dev_ptr, host_ptr = build.key_args(keys, rows, xf.device)
    code = lib.qr_pack_codes_keyed(xf.data_ptr(), dev_ptr, host_ptr,
                                   norm.data_ptr(), rows, n, r,
                                   words.data_ptr(), build.stream_ptr())
    build.check(code, "qr_pack_codes_keyed", lib, "qr_pack_error_string")
    LAUNCHES["quantize_pack_keyed"] += 1
    return words
