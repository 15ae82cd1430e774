"""The RG-LRU recurrence (K11): wrapper and plain version.

The port of ``repro.kernels.rglru_scan``.  :func:`rglru_scan` dispatches
by the tensor's device: a CPU tensor runs the plain time loop in
:mod:`repro_torch.kernels.ref`; a CUDA tensor launches the hand-written
kernel in ``csrc/rglru_scan.cu`` or raises.  The kernel keeps the plain
version's operation order without FMA contraction, so the two are
bit-equal on the card.  :func:`rglru_scan_bwd`, its gradient, dispatches
the same way (the backward kernel in the same source, or
``ref.rglru_scan_bwd``), bit-equal to its plain version too.

``LAUNCHES`` counts kernel launches; only the CUDA path adds to it, so a
CPU run leaves it at 0.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

LAUNCHES = {"rglru_scan": 0, "rglru_scan_bwd": 0}

_P = ctypes.c_void_p


def _bind(lib: ctypes.CDLL) -> None:
    lib.rglru_scan.argtypes = [_P, _P, ctypes.c_int, ctypes.c_int,
                               ctypes.c_int, _P, _P, _P]
    lib.rglru_scan.restype = ctypes.c_int
    lib.rglru_scan_bwd.argtypes = [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_int, _P, _P, _P]
    lib.rglru_scan_bwd.restype = ctypes.c_int
    lib.rglru_error_string.argtypes = [ctypes.c_int]
    lib.rglru_error_string.restype = ctypes.c_char_p


def _lib() -> ctypes.CDLL:
    return build.load("rglru_scan", _bind)


def rglru_scan(x: torch.Tensor, a: torch.Tensor):
    """K11: ``h_t = a_t * h_{t-1} + sqrt(max(1 - a_t^2, 0)) * x_t`` from
    ``h_0 = 0``, elementwise over channels.

    x, a: (B, T, D) float32.  Returns ``(y, h_T)``: y (B, T, D) float32 and
    h_T (B, D) float32."""
    if build.on_cpu(x):
        return ref.rglru_scan(x, a, dtype=ref.loop_dtype(x))
    if x.dim() != 3:
        raise ValueError(f"expects (B, T, D) input, got shape {tuple(x.shape)}")
    b, t, d = x.shape
    x = build.expect(x, "x", torch.float32, (b, t, d), x.device)
    a = build.expect(a, "a", torch.float32, (b, t, d), x.device)
    if not 1 <= b <= 65535:
        raise ValueError(f"B must be in [1, 65535], got {b}")
    y = torch.empty_like(x)
    h = torch.empty((b, d), dtype=torch.float32, device=x.device)
    if t == 0 or d == 0:
        return y, h.zero_()
    lib = _lib()
    code = lib.rglru_scan(build.ptr(x), build.ptr(a), b, t, d, build.ptr(y),
                          build.ptr(h), build.stream_ptr())
    build.check(code, "rglru_scan", lib, "rglru_error_string")
    LAUNCHES["rglru_scan"] += 1
    return y, h


def rglru_scan_bwd(x: torch.Tensor, a: torch.Tensor, y: torch.Tensor,
                   dy: torch.Tensor):
    """K11's backward: ``(dx, da)`` of :func:`rglru_scan` at ``(x, a)``
    for the output gradient ``dy`` (h_T carries none), from the forward's
    ``y``.

    x, a, y, dy: (B, T, D) float32 (dy may be any strided view; it is
    made contiguous).  Returns dx, da: (B, T, D) float32."""
    if build.on_cpu(x):
        return ref.rglru_scan_bwd(x, a, y, dy, dtype=ref.loop_dtype(x))
    if x.dim() != 3:
        raise ValueError(f"expects (B, T, D) input, got shape {tuple(x.shape)}")
    b, t, d = x.shape
    ins = [build.expect(z, name, torch.float32, (b, t, d), x.device)
           for z, name in ((x, "x"), (a, "a"), (y, "y"), (dy, "dy"))]
    if not 1 <= b <= 65535:
        raise ValueError(f"B must be in [1, 65535], got {b}")
    dx = torch.empty_like(ins[0])
    da = torch.empty_like(ins[0])
    if t == 0 or d == 0:
        return dx, da
    lib = _lib()
    code = lib.rglru_scan_bwd(*(build.ptr(z) for z in ins), b, t, d,
                              build.ptr(dx), build.ptr(da), build.stream_ptr())
    build.check(code, "rglru_scan_bwd", lib, "rglru_error_string")
    LAUNCHES["rglru_scan_bwd"] += 1
    return dx, da
