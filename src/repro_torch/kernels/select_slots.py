"""Select -> slot compaction (K5) and its Q_r-code flavour (K6): wrappers
and plain versions.

The port of ``repro.kernels.select_slots.compact_slots`` and
``compact_code_slots``.  Both take row-batched ``(rows, n)`` input (one
row per client's leaf) with one threshold per row (K1's bit pattern) and
dispatch by the tensor's device: a CPU tensor runs the plain version in
:mod:`repro_torch.kernels.ref`; a CUDA tensor launches the hand-written
kernel in ``csrc/select_slots.cu`` or raises.  bf16 input is compared on
its float32 magnitude bits (an exact order-embedding); K5 casts its values
back.

K5 and K6 are one kernel, a single pass with a decoupled look-back over
tiles, instanced on its payload (K5: the survivor's value; K6: its Q_r
code): each call is one launch, allocates only its outputs (in one block)
and keeps its tile descriptors in a workspace per (device, stream) that
the two share and no call clears.

``LAUNCHES`` counts kernel launches; only the CUDA path adds to it, so a
CPU run leaves it at 0.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.qr_pack import MAX_R

LAUNCHES = {"compact_slots": 0, "compact_code_slots": 0}

# K5's and K6's workspace per (device index, stream): [int64 tensor
# holding uint64s, launches since its descriptors were last zeroed].
# Entry 0 is the ticket word (the launch epoch, and the tickets taken: 0
# after every launch); then one descriptor a tile, tagged by the epoch so
# that nothing is cleared between calls.  Launches on one stream run in
# order, and each leaves the ticket at 0 taken with a new epoch, so a K5
# and a K6 launch can follow each other on one workspace.  A launch on
# another stream may run at the same time and must not share it.
_WORKSPACE: dict = {}
# The workspace is zeroed again before the 31-bit epoch could come round to
# a stale descriptor's.
_EPOCH_REFRESH = 1 << 30

_P = ctypes.c_void_p


def _bind(lib: ctypes.CDLL) -> None:
    lib.slots_tiles.argtypes = [ctypes.c_longlong]
    lib.slots_tiles.restype = ctypes.c_longlong
    lib.compact_slots.argtypes = [_P, _P, ctypes.c_int, ctypes.c_longlong,
                                  ctypes.c_int, _P, _P, _P]
    lib.compact_slots.restype = ctypes.c_int
    lib.compact_code_slots.argtypes = [_P, _P, _P, _P, ctypes.c_int,
                                       ctypes.c_longlong, ctypes.c_float,
                                       ctypes.c_int, _P, _P, _P]
    lib.compact_code_slots.restype = ctypes.c_int
    lib.slots_error_string.argtypes = [ctypes.c_int]
    lib.slots_error_string.restype = ctypes.c_char_p


def _lib() -> ctypes.CDLL:
    return build.load("select_slots", _bind)


def _workspace(device: torch.device, stream: int, n_desc: int) -> torch.Tensor:
    """The ticket word and ``n_desc`` descriptors for ``stream``: grown
    (zeroed) when too few, and zeroed after ``_EPOCH_REFRESH`` launches."""
    key = (device.index, stream)
    ws = _WORKSPACE.get(key)
    if ws is None or ws[0].numel() < 1 + n_desc or ws[1] >= _EPOCH_REFRESH:
        size = 1 + n_desc if ws is None else max(1 + n_desc, ws[0].numel())
        ws = [torch.zeros(size, dtype=torch.int64, device=device), 0]
        _WORKSPACE[key] = ws
    ws[1] += 1
    return ws[0]


def _outputs(rows: int, cap: int, device: torch.device):
    """One int32 block for a call's three outputs, which the kernel writes
    whole: ``(block, idx, words, nnz)``, the last three views of it."""
    rc = rows * cap
    out = torch.empty(2 * rc + rows, dtype=torch.int32, device=device)
    return (out, out.as_strided((rows, cap), (cap, 1), 0),
            out.as_strided((rows, cap), (cap, 1), rc),
            out.as_strided((rows,), (1,), 2 * rc))


def compact_slots(x: torch.Tensor, thr: torch.Tensor, cap: int):
    """K5: each row's survivors of ``thr[row]`` (``|x|`` bits ``>= t`` and
    ``!= 0``) as ``cap`` slots in index order.

    Returns ``(idx, vals, nnz)``: ``idx`` (rows, cap) int32 with the
    sentinel ``n`` in empty slots, ``vals`` (rows, cap) at x's dtype (0 in
    empty slots) and ``nnz`` (rows,) int32, the whole survivor count."""
    if build.on_cpu(x):
        return ref.compact_slots(x, thr, cap)
    xf = build.cuda_rows(x)
    rows, n = xf.shape
    cap = int(cap)
    if not 0 <= cap < 2 ** 31 or n >= 2 ** 31:
        raise ValueError(f"cap and n must fit int32, got cap={cap}, n={n}")
    dev = xf.device
    thr = build.expect(thr, "thr", torch.int64, (rows,), dev)
    out, idx, words, nnz = _outputs(rows, cap, dev)
    vals = words.view(torch.float32)
    if n == 0:
        return idx.fill_(0), vals.zero_().to(x.dtype), nnz.zero_()
    lib = _lib()
    stream = build.stream_ptr()
    ws = _workspace(dev, stream, rows * lib.slots_tiles(n))
    code = lib.compact_slots(xf.data_ptr(), thr.data_ptr(), rows, n, cap,
                             ws.data_ptr(), out.data_ptr(), stream)
    build.check(code, "compact_slots", lib, "slots_error_string")
    LAUNCHES["compact_slots"] += 1
    return idx, vals.to(x.dtype), nnz


def compact_code_slots(x: torch.Tensor, u: torch.Tensor, norm: torch.Tensor,
                       thr: torch.Tensor, r: int, cap: int):
    """K6: each row's survivors of ``thr[row]`` as ``cap`` slots in index
    order, carrying their (1+r)-bit Q_r codes of the TopK-masked row
    against ``norm[row]`` (the masked row's norm, K3's) with the uniform at
    the survivor's own index of ``u`` (``(rows, n)`` float32).

    Returns ``(idx, codes, nnz)``: ``idx`` (rows, cap) int32 with the
    sentinel ``n``, ``codes`` (rows, cap) int32 holding the uint32 codes
    (0 in empty slots) and ``nnz`` (rows,) int32, the whole survivor
    count."""
    if build.on_cpu(x):
        return ref.compact_code_slots(x, u, norm, thr, r, cap)
    xf = build.cuda_rows(x)
    rows, n = xf.shape
    cap, r = int(cap), int(r)
    if not 0 <= cap < 2 ** 31 or n >= 2 ** 31:
        raise ValueError(f"cap and n must fit int32, got cap={cap}, n={n}")
    if not 1 <= r <= MAX_R:
        raise ValueError(f"r must be in [1, {MAX_R}], got {r}")
    dev = xf.device
    u = build.expect(u, "u", torch.float32, (rows, n), dev)
    norm = build.expect(norm, "norm", torch.float32, (rows,), dev)
    thr = build.expect(thr, "thr", torch.int64, (rows,), dev)
    out, idx, codes, nnz = _outputs(rows, cap, dev)
    if n == 0:
        return idx.fill_(0), codes.zero_(), nnz.zero_()
    lib = _lib()
    stream = build.stream_ptr()
    ws = _workspace(dev, stream, rows * lib.slots_tiles(n))
    code = lib.compact_code_slots(xf.data_ptr(), u.data_ptr(),
                                  norm.data_ptr(), thr.data_ptr(), rows, n,
                                  float(2 ** r), cap, ws.data_ptr(),
                                  out.data_ptr(), stream)
    build.check(code, "compact_code_slots", lib, "slots_error_string")
    LAUNCHES["compact_code_slots"] += 1
    return idx, codes, nnz
