"""Forward flash attention (K10): wrapper and plain version.

The port of ``repro.kernels.flash_attention``.  :func:`flash_attention`
dispatches by the tensor's device: a CPU tensor runs the plain version,
:func:`repro_torch.kernels.ref.mha_attention`; a CUDA tensor launches a
hand-written kernel or raises.  Both hold the same checks first, so a call
that one device refuses the other refuses too.

On the card the dtype picks the route (:func:`route`): bfloat16 takes the
wgmma kernel fed by TMA in ``csrc/flash_attention_sm90.cu``, float32 the
SIMT kernel in ``csrc/flash_attention.cu`` (tensor-core operands would
round q, k and P below the float32 tolerance).  TMA wants each of q, k, v
16-byte aligned with (b, h, t) strides that are multiples of 16 bytes;
:func:`tma_refusal` says why a view breaks that, and the bf16 route raises
on such a view rather than copying it.  :func:`key_tile_range` is the
kernel's schedule: the key tiles a tile of 64 query rows visits.

The semantics are the oracle's, in one respect not the Pallas kernel's: a
query row that sees no key at all (``Tk = 0``, or a window that lies
wholly past the last key) is 0, where the Pallas kernel, which masks with
-1e30, returns the mean of v.  The Pallas kernel's ``bq``, ``bk`` and
``interpret`` are TPU tiling and not semantics, so this signature leaves
them out; and any ``Tq``/``Tk`` is taken (the kernel masks the ragged
edge), where the Pallas kernel wants them divisible by its blocks.

``LAUNCHES`` counts kernel launches; only the CUDA path adds to it, so a
CPU run leaves it at 0.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build, ref

LAUNCHES = {"flash_attention": 0}

HEAD_DIMS = (32, 64, 128, 256)   # every head size of the JAX tests and the zoo
ROUTES = {torch.bfloat16: "wgmma", torch.float32: "simt"}
ROWS_PER_WARPGROUP = 64          # query rows of one wgmma consumer
_INT_MAX = 2 ** 31 - 1
_TMA_STRIDE_LIMIT = 2 ** 40

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


def _bind(lib: ctypes.CDLL) -> None:
    lib.flash_attention_fwd.argtypes = (
        [_P, _P, _P] + [_I] * 6 + [_LL] * 9
        + [ctypes.c_float, _I, _I, _I, ctypes.c_float, _P, _P])
    lib.flash_attention_fwd.restype = _I
    lib.flash_attention_error_string.argtypes = [_I]
    lib.flash_attention_error_string.restype = ctypes.c_char_p


def _bind_sm90(lib: ctypes.CDLL) -> None:
    lib.flash_attention_bf16_fwd.argtypes = (
        [_P, _P, _P] + [_I] * 6 + [_LL] * 9
        + [ctypes.c_float, _I, _I, _I, ctypes.c_float, _P, _P])
    lib.flash_attention_bf16_fwd.restype = _I
    lib.flash_attention_sm90_error_string.argtypes = [_I]
    lib.flash_attention_sm90_error_string.restype = ctypes.c_char_p
    lib.flash_attention_sm90_smem_bytes.argtypes = [_I]
    lib.flash_attention_sm90_smem_bytes.restype = _LL


def wgmma_smem_bytes(dh: int) -> int:
    """Dynamic shared memory one block of the bf16 (wgmma) kernel takes at
    head size ``dh``, as the built library reports it."""
    return int(_lib_sm90().flash_attention_sm90_smem_bytes(int(dh)))


def route(dtype: torch.dtype) -> str:
    """The kernel a CUDA tensor of ``dtype`` launches: ``"wgmma"``
    (bfloat16) or ``"simt"`` (float32)."""
    if dtype not in ROUTES:
        raise TypeError(f"expects float32 or bfloat16, got {dtype}")
    return ROUTES[dtype]


def tma_strides(shape, strides, elem_size: int) -> tuple:
    """The (b, h, t) byte strides a TMA map gets for a (B, H, T, Dh) view:
    a size-1 axis, whose stride is never stepped, takes the next inner
    axis's extent instead, so any stride PyTorch gives it passes."""
    b, h, t, dh = shape
    st = strides[2] * elem_size if t > 1 else dh * elem_size
    sh = strides[1] * elem_size if h > 1 else st * t
    sb = strides[0] * elem_size if b > 1 else sh * h
    return sb, sh, st


def tma_refusal(shape, strides, elem_size: int, data_ptr: int):
    """Why TMA cannot read a (B, H, T, Dh) view with these element strides
    in place, or None if it can: the base must be 16-byte aligned, the last
    axis dense, and each (b, h, t) byte stride a multiple of 16 below
    2^40."""
    if data_ptr % 16:
        return f"data pointer {data_ptr:#x} is not 16-byte aligned"
    if strides[3] != 1 and shape[3] > 1:
        return f"last axis has stride {strides[3]}, not 1"
    for name, s in zip("bht", tma_strides(shape, strides, elem_size)):
        if s % 16 or not 0 < s < _TMA_STRIDE_LIMIT:
            return (f"{name} stride of {s} bytes is not a positive multiple "
                    f"of 16 below 2^40")
    return None


def block_k(dh: int) -> int:
    """Keys a tile of the wgmma kernel at head size ``dh`` (``kBN`` in
    ``csrc/flash_attention_sm90.cu``): 128, but 64 at Dh 256, where wider
    tiles do not fit in shared memory beside Q."""
    return 128 if dh <= 128 else 64


def key_tile_range(r0: int, tq: int, tk: int, causal: bool,
                   window: Optional[int], q_offset: int, bk: int) -> tuple:
    """Key tiles ``[lo, hi)`` of ``bk`` keys that hold a key visible to some
    query row in ``[r0, r0 + 64)`` below ``tq`` (one consumer warpgroup's
    rows); ``lo == hi`` when there is none.  The wgmma kernel's own
    schedule (``key_tile_range`` in ``csrc/flash_attention_sm90.cu``)."""
    if r0 >= tq:
        return 0, 0
    r1 = min(r0 + ROWS_PER_WARPGROUP - 1, tq - 1)
    kend = min(tk, q_offset + r1 + 1) if causal else tk
    kbeg = max(0, q_offset + r0 - window + 1) if window else 0
    if kend <= kbeg:
        return 0, 0
    return kbeg // bk, -(-kend // bk)


def key_tiles_per_query_tile(tq: int, tk: int, causal: bool,
                             window: Optional[int], q_offset: int,
                             dh: int) -> list:
    """How many key tiles each tile of 64 query rows computes at head size
    ``dh``."""
    out = []
    for r0 in range(0, tq, ROWS_PER_WARPGROUP):
        lo, hi = key_tile_range(r0, tq, tk, causal, window, q_offset,
                                block_k(dh))
        out.append(hi - lo)
    return out


def _lib() -> ctypes.CDLL:
    return build.load("flash_attention", _bind)


def _lib_sm90() -> ctypes.CDLL:
    return build.load("flash_attention_sm90", _bind_sm90)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: Optional[int], q_offset: int,
           softcap: Optional[float]) -> None:
    for z, name in ((q, "q"), (k, "k"), (v, "v")):
        if z.dim() != 4:
            raise ValueError(f"{name} must be (B, H, T, Dh), got shape "
                             f"{tuple(z.shape)}")
        if z.dtype not in (torch.float32, torch.bfloat16) or z.dtype != q.dtype:
            raise TypeError(f"q, k, v must be all float32 or all bfloat16, "
                            f"got {q.dtype}, {k.dtype}, {v.dtype}")
        if z.device != q.device:
            raise ValueError(f"q, k, v must lie on one device, got "
                             f"{q.device}, {k.device}, {v.device}")
        if z.stride(-1) != 1:
            raise ValueError(f"{name} must have a dense last dimension, got "
                             f"strides {z.stride()}")
    b, hq, tq, dh = q.shape
    if tuple(k.shape) != tuple(v.shape):
        raise ValueError(f"k and v must have one shape, got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if k.shape[0] != b or k.shape[3] != dh:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} in B or Dh")
    if k.shape[1] < 1 or hq % k.shape[1]:
        raise ValueError(f"Hq={hq} must be a multiple of Hkv={k.shape[1]}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"Dh must be one of {HEAD_DIMS}, got {dh}")
    if not 0 <= q_offset <= _INT_MAX - tq:
        raise ValueError(f"q_offset must be in [0, 2^31 - Tq), got {q_offset}")
    if window is not None and not 1 <= window <= _INT_MAX:
        raise ValueError(f"window must be None or in [1, 2^31), got {window}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be None or > 0, got {softcap}")
    if not (b <= 65535 and hq <= 65535 and k.shape[2] <= _INT_MAX):
        raise ValueError(f"B and Hq must be at most 65535 and Tk below 2^31, "
                         f"got q {tuple(q.shape)}, k {tuple(k.shape)}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """K10: softmax attention of q (B, Hq, Tq, Dh) over k, v (B, Hkv, Tk,
    Dh), query head h reading KV head ``h // (Hq // Hkv)``.

    q, k, v: all float32 or all bfloat16, on one device, each with a dense
    last dimension (strided views such as ``_split_heads`` output are read
    in place on the card; in bf16 each must pass :func:`tma_refusal`); Dh
    in :data:`HEAD_DIMS`.  ``q_offset`` is the
    absolute position of q's first row; ``window`` keeps the keys within
    ``window`` positions behind the query; ``softcap`` caps the scaled
    logits as ``softcap * tanh(s / softcap)`` before the mask.  Returns a
    dense (B, Hq, Tq, Dh) tensor at q's dtype.
    """
    q_offset = int(q_offset)
    window = None if window is None else int(window)
    softcap = None if softcap is None else float(softcap)
    _check(q, k, v, window, q_offset, softcap)
    if build.on_cpu(q):
        return ref.mha_attention(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset, softcap=softcap)
    b, hq, tq, dh = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    out = torch.empty((b, hq, tq, dh), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    opts = (1.0 / dh ** 0.5, int(bool(causal)), window or 0, q_offset,
            softcap or 0.0, build.ptr(out), build.stream_ptr())
    if route(q.dtype) == "wgmma":
        strides = []
        for z, name in ((q, "q"), (k, "k"), (v, "v")):
            why = tma_refusal(z.shape, z.stride(), z.element_size(),
                              z.data_ptr())
            if why is not None:
                raise ValueError(f"bf16 flash_attention reads {name} with "
                                 f"TMA, which cannot take this view: {why}")
            strides += tma_strides(z.shape, z.stride(), z.element_size())
        lib = _lib_sm90()
        code = lib.flash_attention_bf16_fwd(
            build.ptr(q), build.ptr(k), build.ptr(v), b, hq, hq // hkv, tq,
            tk, dh, *strides, *opts)
        build.check(code, "flash_attention (wgmma)", lib,
                    "flash_attention_sm90_error_string")
    else:
        lib = _lib()
        strides = [s for z in (q, k, v) for s in z.stride()[:3]]
        code = lib.flash_attention_fwd(
            build.ptr(q), build.ptr(k), build.ptr(v), b, hq, hq // hkv, tq,
            tk, dh, *strides, *opts)
        build.check(code, "flash_attention (simt)", lib,
                    "flash_attention_error_string")
    LAUNCHES["flash_attention"] += 1
    return out
