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
computed elsewhere.  :func:`radix_hist_grouped` is K1's histogram pass
alone over several leaves in one launch (K1h; :func:`radix_hist` is its
one-leaf call), for the model-sharded wire: :func:`threshold_bits_sharded`
counts a digit of every sharded leaf in one launch, reduces the counts
across the model ranks in one reduction and walks them on the card.

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
    lib.topk_radix_hist.argtypes = [_P, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_int, _P, ctypes.c_longlong, _P,
                                    _P, _P, _P, _P, ctypes.c_int, _P, _P]
    lib.topk_radix_hist.restype = ctypes.c_int
    lib.topk_radix_finish.argtypes = [_P, ctypes.c_int, ctypes.c_int, _P, _P,
                                      _P, _P, _P]
    lib.topk_radix_finish.restype = ctypes.c_int
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


#: K1h's blocks: threads a block, the grid cap over a row's slices
#: (``kThreads``, ``kMaxBlocks`` in ``csrc/topk_compress.cu``) and the
#: fewest elements a block takes.
HIST_THREADS = 256
HIST_MAX_BLOCKS = 132 * 16
HIST_MIN_PER_BLOCK = 16 * HIST_THREADS


def hist_block_starts(ns, rows: int, max_blocks: int = HIST_MAX_BLOCKS) -> list:
    """K1h's block split: the prefix sum of each slice's blocks a row, for
    slices of ``ns`` elements and ``rows`` rows.  Blocks go to the slices
    in proportion to their size, at least :data:`HIST_MIN_PER_BLOCK`
    elements a block and about ``max_blocks // rows`` blocks a row in all
    (one more at most a slice, whose rounding up gives it at least one
    block).  Block ``b`` of a slice's ``B`` counts its float4s ``b *
    HIST_THREADS + t + i * B * HIST_THREADS`` (thread ``t``), and its first
    block the scalar head and tail."""
    cap = max(1, max_blocks // max(1, rows))
    per = max(HIST_MIN_PER_BLOCK, -(-sum(int(n) for n in ns) // cap))
    starts = [0]
    for n in ns:
        starts.append(starts[-1] + max(1, -(-int(n) // per)))
    return starts


class _Leaves:
    """The float32 CUDA slices of one K1h call, ``(rows, n_i)`` each: the
    leaf table on the card (one copy; none for one leaf counted under
    given prefixes) and the walk's two state buffers."""

    def __init__(self, xs, walk: bool, ks=None, n_totals=None):
        self.xs, self.rows, self.dev = xs, xs[0].shape[0], xs[0].device
        if any(x.shape[0] != self.rows for x in xs):
            raise ValueError("every leaf must have the same rows, got "
                             f"{[x.shape[0] for x in xs]}")
        L, R = len(xs), self.rows
        ns = [x.shape[1] for x in xs]
        self.lr = L * R
        self.starts = hist_block_starts(ns, R)
        self.table = self.state = self.k = None
        if L == 1 and not walk:
            return
        kv = [0] * self.lr
        if walk:
            if not any(isinstance(k, torch.Tensor) for k in ks):
                kv = [int(k) for k in ks for _ in range(R)]
            else:   # a per-row k on the card: read from there
                self.k = torch.cat([ref._per_row(k_i, R, self.dev)
                                    for k_i in ks]).contiguous()
        words = ([x.data_ptr() for x in xs] + ns + self.starts
                 + [int(n) for n in (n_totals or [0] * L)] + kv)
        buf = torch.empty(len(words) + (4 * self.lr if walk else 0),
                          dtype=torch.int64, device=self.dev)
        # pageable memory: the copy is staged at once, with no wait for
        # the stream's earlier work
        buf[:len(words)].copy_(torch.tensor(words, dtype=torch.int64),
                               non_blocking=True)
        self.table = buf
        if walk:
            self.state = buf[len(words):].view(2, 2 * self.lr)
            if self.k is None:
                self.k = buf[len(words) - self.lr:len(words)]

    def hist(self, shift: int, prefix=None, prev=None, step: int = 0):
        """One digit's ``(L * rows, 256)`` int32 counts: under ``prefix``,
        or (None) under the walk's, ``prev`` the previous digit's reduced
        counts (None at the first, ``step`` 0)."""
        lib = _lib()
        hist = torch.empty((self.lr, 256), dtype=torch.int32, device=self.dev)
        x0 = self.xs[0]
        st_in = st_out = k = None
        if prefix is None:
            st_out = self.state[step % 2].data_ptr()
            st_in = self.state[(step - 1) % 2].data_ptr()
            k = self.k.data_ptr()
        code = lib.topk_radix_hist(
            None if self.table is None else self.table.data_ptr(),
            len(self.xs), self.rows, self.starts[-1], x0.data_ptr(),
            x0.shape[1], None if prefix is None else prefix.data_ptr(),
            None if prev is None else prev.data_ptr(), st_in, st_out, k,
            int(shift), hist.data_ptr(), build.stream_ptr())
        build.check(code, "topk_radix_hist", lib, "topk_error_string")
        LAUNCHES["topk_radix_hist"] += 1
        return hist

    def counts(self, h: torch.Tensor) -> torch.Tensor:
        """A reduction's result as the next launch reads it."""
        if tuple(h.shape) != (self.lr, 256) or h.dtype.is_floating_point:
            raise ValueError(f"reduce must return ({self.lr}, 256) integer "
                             f"counts, got {h.dtype} {tuple(h.shape)}")
        return h.to(device=self.dev, dtype=torch.int32).contiguous()

    def finish(self, last: torch.Tensor) -> torch.Tensor:
        """The walk's thresholds ``(L * rows,)`` int64 from the last
        digit's reduced counts."""
        lib = _lib()
        thr = torch.empty(self.lr, dtype=torch.int64, device=self.dev)
        code = lib.topk_radix_finish(
            self.table.data_ptr(), len(self.xs), self.rows, last.data_ptr(),
            self.state[(len(ref.RADIX_SHIFTS) - 1) % 2].data_ptr(),
            self.k.data_ptr(), thr.data_ptr(), build.stream_ptr())
        build.check(code, "topk_radix_finish", lib, "topk_error_string")
        return thr


def radix_hist_grouped(xs, prefix: torch.Tensor, shift: int) -> torch.Tensor:
    """K1's histogram pass alone over several leaves in one launch (K1h):
    ``(L * rows, 256)`` int32, leaf-major, each row the counts of the
    8-bit magnitude digit at ``shift`` among the elements whose bits above
    it equal ``prefix[row]``'s (``ref.radix_digit_hist_grouped``).  ``xs``
    are ``(rows, n_i)`` with the same rows; ``prefix`` is ``(L * rows,)``
    int64 on their device."""
    if build.on_cpu(xs[0]):
        return ref.radix_digit_hist_grouped([ref.mag_bits(x) for x in xs],
                                            prefix, shift).to(torch.int32)
    xs = [_cuda_input(x) for x in xs]
    lv = _Leaves(xs, walk=False)
    prefix = build.expect(prefix, "prefix", torch.int64, (lv.lr,), lv.dev)
    return lv.hist(shift, prefix=prefix)


def radix_hist(x: torch.Tensor, prefix: torch.Tensor,
               shift: int) -> torch.Tensor:
    """K1h on one leaf: each row's ``(256,)`` int32 counts of the 8-bit
    magnitude digit at ``shift`` among the elements whose bits above it
    equal ``prefix[row]``'s (``ref.radix_digit_hist``).  ``prefix`` is
    ``(rows,)`` int64 on x's device."""
    return radix_hist_grouped([x], prefix, shift)


def threshold_bits_sharded(xs, ks, n_totals, reduce) -> list:
    """The exact TopK thresholds of rows sharded across ranks, for several
    row sets at once (the sharded leaves of a tree, each ``(rows, n_i)``
    with the same rows): ``xs[i]`` holds this rank's slice of each row of
    ``n_totals[i]`` elements, ``ks[i]`` is an int or a per-row tensor, and
    ``reduce`` sums an ``(R, 256)`` integer histogram over the ranks (an
    all-reduce).  A digit is one K1h launch over every set and one
    reduction; the walk runs on the card (in the next digit's launch, then
    a finishing launch).  Every rank gets the bit patterns
    ``ref.topk_threshold_bits`` gives on the whole rows, ties included,
    with the edge conventions at ``n_totals[i]``."""
    if build.on_cpu(xs[0]):
        rows, dev = xs[0].shape[0], xs[0].device
        bits = [ref.mag_bits(x) for x in xs]
        k = torch.cat([ref._per_row(k_i, rows, dev) for k_i in ks])
        n_total = torch.tensor([int(n) for n in n_totals],
                               device=dev).repeat_interleave(rows)
        thr = ref.radix_walk(
            lambda prefix, shift: ref.radix_digit_hist_grouped(bits, prefix,
                                                               shift),
            k, rows * len(xs), n_total, dev, reduce)
        return list(thr.split(rows))
    xs = [_cuda_input(x) for x in xs]
    lv = _Leaves(xs, walk=True, ks=list(ks), n_totals=list(n_totals))
    prev = None
    for step, shift in enumerate(ref.RADIX_SHIFTS):
        prev = lv.counts(reduce(lv.hist(shift, prev=prev, step=step)))
    return list(lv.finish(prev).split(lv.rows))
