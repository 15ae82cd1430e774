"""Bit-plane pack (K8) and unpack (K9) of b-bit codes: wrappers and plain
versions.

The port of ``repro.kernels.pack_codes``.  The functions take
row-batched input (one row per client's leaf) and dispatch by the
tensor's device: a CPU tensor runs the plain version in
:mod:`repro_torch.kernels.ref`; a CUDA tensor launches the hand-written
kernel in ``csrc/pack_codes.cu`` or raises.  Codes and words are uint32
bit patterns in int32 containers.  Layout: word ``j*b + t`` holds bit
``t`` of group ``j``'s 32 codes.  K9 has two entries: :func:`unpack_codes`
(the JAX function's counterpart) and :func:`unpack_qr_values`, which
decodes the words straight to the Q_r values they stand for (the ``qr``
and ``topk_qr`` codecs' decode) in the same launch.

``LAUNCHES`` counts kernel launches per wrapper; only the CUDA path adds
to it, so a CPU run leaves it at 0.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

LAUNCHES = {"pack_codes": 0, "unpack_codes": 0, "unpack_qr_values": 0}

_P = ctypes.c_void_p


def _bind(lib: ctypes.CDLL) -> None:
    for fn in (lib.pack_codes, lib.unpack_codes):
        fn.argtypes = [_P, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, _P, _P]
        fn.restype = ctypes.c_int
    lib.unpack_qr_values.argtypes = [_P, ctypes.c_int, ctypes.c_longlong,
                                     ctypes.c_int, _P, _P, _P]
    lib.unpack_qr_values.restype = ctypes.c_int
    lib.pack_error_string.argtypes = [ctypes.c_int]
    lib.pack_error_string.restype = ctypes.c_char_p


def _lib() -> ctypes.CDLL:
    return build.load("pack_codes", _bind)


def pack_codes(codes: torch.Tensor, b: int) -> torch.Tensor:
    """K8: each row's ``n`` b-bit codes as ``ceil(n/32) * b`` words."""
    if build.on_cpu(codes):
        return ref.pack_codes(codes, b)
    b = ref.check_width(b)
    c = build.cuda_codes(codes)
    rows, n = c.shape
    words = torch.empty((rows, -(-n // 32) * b), dtype=torch.int32,
                        device=c.device)
    if n == 0:
        return words
    lib = _lib()
    code = lib.pack_codes(build.ptr(c), rows, n, b, build.ptr(words),
                          build.stream_ptr())
    build.check(code, "pack_codes", lib, "pack_error_string")
    LAUNCHES["pack_codes"] += 1
    return words


def _cuda_words(words: torch.Tensor, b: int, n: int) -> torch.Tensor:
    w = build.cuda_codes(words)
    if w.shape[1] != -(-n // 32) * b:
        raise ValueError(f"expected {-(-n // 32) * b} words for n={n}, b={b}, "
                         f"got {w.shape[1]}")
    return w


def unpack_codes(words: torch.Tensor, b: int, n: int) -> torch.Tensor:
    """K9: each row's ``n`` b-bit codes from its ``ceil(n/32) * b`` words."""
    if build.on_cpu(words):
        return ref.unpack_codes(words, b, n)
    b, n = ref.check_width(b), int(n)
    w = _cuda_words(words, b, n)
    rows = w.shape[0]
    codes = torch.empty((rows, n), dtype=torch.int32, device=w.device)
    if n == 0:
        return codes
    lib = _lib()
    code = lib.unpack_codes(build.ptr(w), rows, n, b, build.ptr(codes),
                            build.stream_ptr())
    build.check(code, "unpack_codes", lib, "pack_error_string")
    LAUNCHES["unpack_codes"] += 1
    return codes


def unpack_qr_values(words: torch.Tensor, r: int, n: int,
                     norm: torch.Tensor) -> torch.Tensor:
    """K9 decoding to Q_r values: each row's ``n`` (1+r)-bit codes from its
    ``ceil(n/32) * (1+r)`` words, as the float32 values
    ``ref.qr_values(codes, norm, r)`` gives, in one launch (the codes stay
    in registers)."""
    if build.on_cpu(words):
        return ref.qr_values(ref.unpack_codes(words, 1 + int(r), n), norm, r)
    r, n = int(r), int(n)
    if not 1 <= r <= 31:
        raise ValueError(f"r must be in [1, 31], got {r}")
    w = _cuda_words(words, 1 + r, n)
    rows = w.shape[0]
    norm = build.expect(norm, "norm", torch.float32, (rows,), w.device)
    out = torch.empty((rows, n), dtype=torch.float32, device=w.device)
    if n == 0:
        return out
    lib = _lib()
    code = lib.unpack_qr_values(build.ptr(w), rows, n, r, build.ptr(norm),
                                build.ptr(out), build.stream_ptr())
    build.check(code, "unpack_qr_values", lib, "pack_error_string")
    LAUNCHES["unpack_qr_values"] += 1
    return out
