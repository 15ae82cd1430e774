"""Fused Q_r quantize + bit-plane pack (K7): wrapper and plain version.

The port of ``repro.kernels.qr_pack``.  Takes row-batched ``(rows, n)``
input (one row per client's leaf) and dispatches by the tensor's device:
a CPU tensor runs the plain version in :mod:`repro_torch.kernels.ref`; a
CUDA tensor launches the hand-written kernel in ``csrc/qr_pack.cu`` or
raises.  The norm and the uniforms are inputs, so kernel and plain
version are bit-equal given the same norm and uniforms.

``LAUNCHES`` counts kernel launches; only the CUDA path adds to it, so a
CPU run leaves it at 0.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

LAUNCHES = {"quantize_pack_with_uniforms": 0}

#: Widest quantizer the packed codes carry: codes stay float32-exact
#: integers and fit a uint32 word with their sign bit.
MAX_R = 16

_P = ctypes.c_void_p


def _bind(lib: ctypes.CDLL) -> None:
    lib.qr_pack_codes.argtypes = [_P, _P, _P, ctypes.c_int, ctypes.c_longlong,
                                  ctypes.c_int, _P, _P]
    lib.qr_pack_codes.restype = ctypes.c_int
    lib.qr_pack_error_string.argtypes = [ctypes.c_int]
    lib.qr_pack_error_string.restype = ctypes.c_char_p


def _lib() -> ctypes.CDLL:
    return build.load("qr_pack", _bind)


def quantize_pack_with_uniforms(x: torch.Tensor, r: int, u: torch.Tensor,
                                norm: torch.Tensor) -> torch.Tensor:
    """K7: each row's (1+r)-bit Q_r codes against ``norm[row]`` with
    uniforms ``u`` (``(rows, n)`` float32), packed into
    ``(rows, ceil(n/32) * (1+r))`` words (int32 containers)."""
    if build.on_cpu(x):
        return ref.quantize_pack_with_uniforms(x, r, u, norm)
    xf = build.cuda_rows(x)
    rows, n = xf.shape
    r = int(r)
    if not 1 <= r <= MAX_R:
        raise ValueError(f"r must be in [1, {MAX_R}], got {r}")
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
