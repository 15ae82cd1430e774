"""Forward flash attention (K10): wrapper and plain version.

The port of ``repro.kernels.flash_attention``.  :func:`flash_attention`
dispatches by the tensor's device: a CPU tensor runs the plain version,
:func:`repro_torch.kernels.ref.mha_attention`; a CUDA tensor launches the
hand-written kernel in ``csrc/flash_attention.cu`` or raises.  Both hold
the same checks first, so a call that one device refuses the other
refuses too.

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
_INT_MAX = 2 ** 31 - 1

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


def _bind(lib: ctypes.CDLL) -> None:
    lib.flash_attention_fwd.argtypes = (
        [_P, _P, _P] + [_I] * 6 + [_LL] * 9
        + [ctypes.c_float, _I, _I, _I, ctypes.c_float, _I, _P, _P])
    lib.flash_attention_fwd.restype = _I
    lib.flash_attention_error_string.argtypes = [_I]
    lib.flash_attention_error_string.restype = ctypes.c_char_p


def _lib() -> ctypes.CDLL:
    return build.load("flash_attention", _bind)


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
    in place on the card); Dh in :data:`HEAD_DIMS`.  ``q_offset`` is the
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
    lib = _lib()
    strides = [s for z in (q, k, v) for s in z.stride()[:3]]
    code = lib.flash_attention_fwd(
        build.ptr(q), build.ptr(k), build.ptr(v), b, hq, hq // hkv, tq, tk,
        dh, *strides, 1.0 / dh ** 0.5, int(bool(causal)), window or 0,
        q_offset, softcap or 0.0, int(q.dtype == torch.bfloat16),
        build.ptr(out), build.stream_ptr())
    build.check(code, "flash_attention", lib, "flash_attention_error_string")
    LAUNCHES["flash_attention"] += 1
    return out
