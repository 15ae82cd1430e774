"""The RWKV6 WKV recurrence (K12): wrapper and plain version.

The port of ``repro.kernels.wkv6``.  :func:`wkv6_scan` dispatches by the
tensor's device: a CPU tensor runs the plain time loop in
:mod:`repro_torch.kernels.ref`; a CUDA tensor launches the hand-written
kernel in ``csrc/wkv6.cu`` or raises.  Two routes, by the dtype of r/k/v:
bfloat16 (prefill's) runs the chunked scan on the tensor cores, held to
the JAX package's tolerance for this kernel (3e-4); float32 runs the
sequential kernel, whose state update keeps the plain
version's operation order (S_T has its bits on the card) while y's
64-term sums run in another order and agree within a tolerance.

:func:`wkv6_scan_bwd`, its gradient, dispatches the same way: a CPU
tensor runs ``ref.wkv6_scan_bwd``, a CUDA tensor the backward kernels in
``csrc/wkv6_bwd.cu``, held to the plain version within a tolerance: in
bf16 (training's) the chunked route on the tensor cores (a state kernel
and a chunk-gradient kernel, then torch's fixed-order sum of du's
partials), in float32 the sequential kernel.

``LAUNCHES`` counts kernel launches; only the CUDA path adds to it, so a
CPU run leaves it at 0.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

LAUNCHES = {"wkv6_scan": 0, "wkv6_scan_bwd": 0}

HEAD = 64     # K = V = 64: the head size every RWKV6 model here uses
CHUNK = 16    # steps a chunk of the bf16 routes, forward and backward

_P = ctypes.c_void_p
_LL = ctypes.c_longlong


def _bind(lib: ctypes.CDLL) -> None:
    lib.wkv6_scan.argtypes = [_P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                              ctypes.c_int, _LL, _LL, _LL, ctypes.c_int, _LL,
                              _LL, _LL, _P, _P, _P]
    lib.wkv6_scan.restype = ctypes.c_int
    lib.wkv6_error_string.argtypes = [ctypes.c_int]
    lib.wkv6_error_string.restype = ctypes.c_char_p


def _lib() -> ctypes.CDLL:
    return build.load("wkv6", _bind)


def _bind_bwd(lib: ctypes.CDLL) -> None:
    lib.wkv6_scan_bwd.argtypes = [_P, _P, _P, _P, _P, _P, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_int, _LL, _LL, _LL,
                                  _LL, _LL, _LL, _LL, _LL, _LL,
                                  _P, _P, _P, _P, _P, _P, _P]
    lib.wkv6_scan_bwd.restype = ctypes.c_int
    lib.wkv6_scan_bwd_chunked.argtypes = lib.wkv6_scan_bwd.argtypes
    lib.wkv6_scan_bwd_chunked.restype = ctypes.c_int
    for fn in (lib.wkv6_bwd_ckpt_floats, lib.wkv6_bwd_state_floats):
        fn.argtypes = [ctypes.c_int]
        fn.restype = _LL
    lib.wkv6_bwd_error_string.argtypes = [ctypes.c_int]
    lib.wkv6_bwd_error_string.restype = ctypes.c_char_p


def _lib_bwd() -> ctypes.CDLL:
    return build.load("wkv6_bwd", _bind_bwd)


def _check_operands(r, k, v, w, u):
    """The forward's and the backward's shared checks: ``(b, h, t)``."""
    if r.dim() != 4:
        raise ValueError(f"expects (B, H, T, K) input, got {tuple(r.shape)}")
    b, h, t, kd = r.shape
    if kd != HEAD or v.shape[-1] != HEAD:
        raise ValueError(f"head size must be {HEAD}, got K={kd}, "
                         f"V={v.shape[-1]}")
    if r.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"r must be float32 or bfloat16, got {r.dtype}")
    shape = (b, h, t, HEAD)
    for z, name, dtype in ((r, "r", r.dtype), (k, "k", r.dtype),
                           (v, "v", r.dtype), (w, "w", torch.float32)):
        if z.dtype != dtype or tuple(z.shape) != shape or z.device != r.device:
            raise ValueError(f"{name} must be a {dtype} {shape} tensor on "
                             f"{r.device}, got {z.dtype} {tuple(z.shape)} "
                             f"on {z.device}")
        if z.stride(-1) != 1 or z.stride()[:3] != r.stride()[:3]:
            raise ValueError(f"{name} must have a dense last dimension and "
                             f"r's strides {r.stride()}, got {z.stride()}")
    if not 1 <= b * h <= 2 ** 31 - 1:
        raise ValueError(f"B*H must be in [1, 2^31), got {b * h}")
    return b, h, t


def _rows16(z: torch.Tensor) -> bool:
    """Whether ``z``'s rows are 16-byte aligned (data pointer and (b, h, t)
    strides in multiples of 8 elements), as the bf16 routes' cp.async
    copies read them."""
    return not (z.data_ptr() % 16 or any(st % 8 for st in z.stride()[:3]))


def _check_rows16(r, k, v, w) -> None:
    for z, name in ((r, "r"), (k, "k"), (v, "v"), (w, "w")):
        if not _rows16(z):
            raise ValueError(f"{name}: the bf16 route needs 16-byte "
                             f"aligned rows (data_ptr and the (b, h, "
                             f"t) strides in multiples of 8 elements), "
                             f"got {z.data_ptr() % 16} and {z.stride()}")


def wkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor):
    """K12: ``y_t = (S + diag(u) k_t v_t^T)^T r_t``, ``S <- diag(w_t) S +
    k_t v_t^T`` from ``S_0 = 0``, per (batch, head).

    r, k, v: (B, H, T, 64) float32 or bfloat16 (all three alike); w:
    (B, H, T, 64) float32; u: (H, 64) float32.  On the card r/k/v/w may be
    strided views with a dense last dimension (``rwkv6._heads`` of a
    (B, T, D) activation, read in place), sharing their strides; in bf16
    their rows must be 16-byte aligned (data pointers and (b, h, t) strides
    in multiples of 8 elements), or the call raises.  Returns
    ``(y, S_T)``: y (B, H, T, 64) at r's dtype (on the card a
    (B, H, T, 64) view of a (B, T, H, 64) tensor, so ``_unheads`` needs no
    copy) and S_T (B, H, 64, 64) float32."""
    if build.on_cpu(r):
        return ref.wkv6_scan(r, k, v, w, u, dtype=ref.loop_dtype(r))
    b, h, t = _check_operands(r, k, v, w, u)
    if r.dtype == torch.bfloat16:
        _check_rows16(r, k, v, w)
    u = build.expect(u, "u", torch.float32, (h, HEAD), r.device)
    y = torch.empty((b, t, h, HEAD), dtype=r.dtype, device=r.device)
    s = torch.empty((b, h, HEAD, HEAD), dtype=torch.float32, device=r.device)
    if t == 0:
        return y.transpose(1, 2), s.zero_()
    sb, sh, st, _ = r.stride()
    yb, yt, yh, _ = y.stride()
    lib = _lib()
    code = lib.wkv6_scan(build.ptr(r), build.ptr(k), build.ptr(v),
                         build.ptr(w), build.ptr(u), b, h, t, sb, sh, st,
                         int(r.dtype == torch.bfloat16), yb, yh, yt,
                         build.ptr(y), build.ptr(s), build.stream_ptr())
    build.check(code, "wkv6_scan", lib, "wkv6_error_string")
    LAUNCHES["wkv6_scan"] += 1
    return y.transpose(1, 2), s


def wkv6_scan_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: torch.Tensor, dy: torch.Tensor):
    """K12's backward: ``(dr, dk, dv, dw, du)`` of :func:`wkv6_scan` at
    ``(r, k, v, w, u)`` for the output gradient ``dy`` (S_T carries none).

    r, k, v, w, u as :func:`wkv6_scan` takes them (strided views read in
    place, no copy; in bf16 with 16-byte aligned rows, or the call
    raises); dy: (B, H, T, 64) at r's dtype, any strides with a dense last
    dimension (the gradient of the forward's y view arrives as one; in
    bf16 a view whose rows are not 16-byte aligned is copied first).  The
    kernels compute in float32 whatever r's dtype.  Returns dr, dk, dv at
    r's dtype (the bf16 route writes them at bf16 itself) and dw float32,
    each a (B, H, T, 64) view of a (B, T, H, 64) tensor (so
    ``rwkv6._heads``' backward needs no copy), and du (H, 64) float32, the
    per-(b, h) (bf16: per-(b, h, chunk)) partials summed in a fixed order.
    ``LAUNCHES["wkv6_scan_bwd"]`` counts one a call: the bf16 route runs
    two kernels (``wkv6_bwd_states``, ``wkv6_bwd_chunks``) and du's sum,
    the float32 route one kernel (``wkv6_back``) and the sum."""
    if build.on_cpu(r):
        return ref.wkv6_scan_bwd(r, k, v, w, u, dy,
                                 dtype=ref.loop_dtype(r))
    b, h, t = _check_operands(r, k, v, w, u)
    u = build.expect(u, "u", torch.float32, (h, HEAD), r.device)
    if (dy.dtype != r.dtype or tuple(dy.shape) != (b, h, t, HEAD)
            or dy.device != r.device or dy.stride(-1) != 1):
        raise ValueError(f"dy must be a {r.dtype} {(b, h, t, HEAD)} tensor on "
                         f"{r.device} with a dense last dimension, got "
                         f"{dy.dtype} {tuple(dy.shape)} on {dy.device}, "
                         f"strides {dy.stride()}")
    chunked = r.dtype == torch.bfloat16
    if chunked:
        _check_rows16(r, k, v, w)
        if not _rows16(dy):
            dy = dy.contiguous()
    f32 = dict(dtype=torch.float32, device=r.device)
    grads = [torch.empty((b, t, h, HEAD), dtype=r.dtype,
                         device=r.device).transpose(1, 2) for _ in range(3)]
    grads.append(torch.empty((b, t, h, HEAD), **f32).transpose(1, 2))
    chunks = -(-t // CHUNK) if chunked else 1
    du_part = torch.empty((b, h, chunks, HEAD), **f32)
    if t == 0:
        return (*(g.zero_() for g in grads), du_part.sum((0, 2)).zero_())
    lib = _lib_bwd()
    floats = (lib.wkv6_bwd_state_floats(t) if chunked
              else lib.wkv6_bwd_ckpt_floats(t))
    scratch = torch.empty((b * h, floats), **f32)
    sb, sh, st, _ = r.stride()
    gb, gh, gt, _ = dy.stride()
    ob, oh, ot, _ = grads[0].stride()
    entry = lib.wkv6_scan_bwd_chunked if chunked else lib.wkv6_scan_bwd
    code = entry(build.ptr(r), build.ptr(k), build.ptr(v), build.ptr(w),
                 build.ptr(u), build.ptr(dy), b, h, t, sb, sh, st, gb, gh, gt,
                 ob, oh, ot, *(build.ptr(g) for g in grads),
                 build.ptr(du_part), build.ptr(scratch), build.stream_ptr())
    build.check(code, "wkv6_scan_bwd", lib, "wkv6_bwd_error_string")
    LAUNCHES["wkv6_scan_bwd"] += 1
    return (*grads, du_part.sum((0, 2)))
