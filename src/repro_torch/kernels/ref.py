"""Plain PyTorch versions of the port's kernels.

These are the oracles the CUDA kernels are held against on the card, and
the path a wrapper takes when its tensor lies on the CPU.  They mirror
``repro.kernels.ref`` and the Pallas kernels' semantics.  The uplink's
functions are batched over rows: each takes ``(rows, n)`` and treats each
row as one vector (one client's leaf), with a per-row ``k`` or norm.  The
two recurrent scans of the model zoo (:func:`rglru_scan`,
:func:`wkv6_scan`) are plain time loops over their ``(B, ..., T, ...)``
inputs; :func:`mha_attention` forms the whole (Tq, Tk) logit matrix.

uint32 bit patterns are held in int64 (torch's uint32 coverage is thin):
magnitudes have a clear sign bit, so their patterns are exact non-negative
int64 values and the integer order is the float order.
"""

from __future__ import annotations

import torch

#: MSB-first 8-bit digit positions of the radix threshold walk.
RADIX_SHIFTS = (24, 16, 8, 0)
ALL_ONES = 0xFFFFFFFF


def _rows(x: torch.Tensor) -> torch.Tensor:
    if x.dim() != 2:
        raise ValueError(f"expects (rows, n) input, got shape {tuple(x.shape)}")
    return x


def _per_row(v, rows: int, device) -> torch.Tensor:
    t = torch.as_tensor(v, dtype=torch.int64, device=device)
    return t.expand(rows) if t.dim() == 0 else t


def loop_dtype(x: torch.Tensor) -> torch.dtype:
    """The type a scan's plain loop runs in for input ``x``: float64 for
    float64 input (a yardstick, and what ``gradcheck`` needs), else
    float32, the kernels' type."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def mag_bits(x: torch.Tensor) -> torch.Tensor:
    """|x| as uint32 bit patterns (after an f32 cast), in int64.

    The f32 cast is an exact order-embedding for bf16 inputs, so masks on
    the cast bits equal masks on the original dtype."""
    return x.to(torch.float32).abs().view(torch.int32).to(torch.int64)


def radix_digit_hist(bits: torch.Tensor, prefix: torch.Tensor,
                     shift: int) -> torch.Tensor:
    """Per-row 256-bin integer histogram of the 8-bit digit at ``shift``,
    counting only elements whose decided high bits match ``prefix[row]``.
    Integer counts are exact at any size (the TPU kernel's float32 counts
    are exact only below 2**24)."""
    high = (ALL_ONES << (shift + 8)) & ALL_ONES if shift + 8 < 32 else 0
    match = (bits & high) == (prefix[:, None] & high)
    digit = (bits >> shift) & 0xFF
    hist = torch.zeros((bits.shape[0], 256), dtype=torch.int64,
                       device=bits.device)
    return hist.scatter_add_(1, digit, match.to(torch.int64))


def radix_digit_hist_grouped(bits, prefix: torch.Tensor,
                             shift: int) -> torch.Tensor:
    """:func:`radix_digit_hist` of several leaves' ``(rows, n_i)`` bit
    patterns (the same rows) in one ``(L * rows, 256)`` histogram,
    leaf-major, under the ``(L * rows,)`` prefixes in the same order."""
    rows = bits[0].shape[0]
    return torch.cat([radix_digit_hist(b, prefix[i * rows:(i + 1) * rows],
                                       shift) for i, b in enumerate(bits)])


def radix_walk_step(hist: torch.Tensor, k_rem: torch.Tensor):
    """Fix one digit per row: the largest ``d`` with ``count(digit >= d)
    >= k_rem``; ``k_rem`` loses the strictly-greater bucket."""
    ge = torch.flip(torch.cumsum(torch.flip(hist, (1,)), 1), (1,))
    digit = torch.clamp((ge >= k_rem[:, None]).sum(1) - 1, 0, 255)
    above = torch.where(
        digit < 255,
        ge.gather(1, torch.clamp(digit + 1, max=255)[:, None])[:, 0],
        torch.zeros_like(k_rem))
    return digit, k_rem - above


def radix_walk(hist_fn, k, rows: int, n_total: int, device,
               reduce=None) -> torch.Tensor:
    """The four-pass radix walk, MSB first, over the histograms
    ``hist_fn(prefix, shift)`` gives (``(rows, 256)`` counts under each
    row's decided ``prefix``), each summed by ``reduce`` (an all-reduce of
    the ``(rows, 256)`` int32 counts over the ranks a row is sharded
    across; None for a whole row).  ``n_total`` is the whole row's size
    (an int, or one a row), for the edge conventions: ``k >= n_total``
    gives 0 (every entry kept), ``k <= 0`` gives ``0xFFFFFFFF`` (empty
    support)."""
    kk = _per_row(k, rows, device)
    prefix = torch.zeros(rows, dtype=torch.int64, device=device)
    k_rem = kk.clone()
    for shift in RADIX_SHIFTS:
        hist = hist_fn(prefix, shift)
        if reduce is not None:
            hist = reduce(hist.to(torch.int32))
        digit, k_rem = radix_walk_step(hist.to(torch.int64), k_rem)
        prefix = prefix | (digit << shift)
    prefix = torch.where(kk >= n_total, torch.zeros_like(prefix), prefix)
    return torch.where(kk <= 0, torch.full_like(prefix, ALL_ONES), prefix)


def topk_threshold_bits(x: torch.Tensor, k, *, n_total=None,
                        reduce=None) -> torch.Tensor:
    """Per-row uint32 bit pattern (int64) of the k-th largest ``|x|``.

    Four radix-histogram passes, MSB first, exactly as the TPU kernel
    walks them (``repro.kernels.topk_compress.threshold_bits``), with its
    edge conventions: ``k >= n`` gives 0 (every entry kept) and ``k <= 0``
    gives ``0xFFFFFFFF`` (empty support).  For ``1 <= k < n`` this is the
    value ``repro.kernels.ref.topk_threshold_bits`` returns: the largest
    ``t`` with ``count(bits >= t) >= k``, ties included.

    With ``reduce`` each row of ``x`` is this rank's slice of a row of
    ``n_total`` elements sharded across ranks, and every pass's counts are
    summed over them (the reference's ``psum_axis`` at 8-bit digits): the
    walk returns the whole row's threshold from the slices alone, the
    integer counts making the sum exact.
    """
    x = _rows(x)
    rows, n = x.shape
    bits = mag_bits(x)
    return radix_walk(lambda prefix, shift: radix_digit_hist(bits, prefix,
                                                             shift),
                      k, rows, n if n_total is None else int(n_total),
                      x.device, reduce)


def mask_by_threshold(x: torch.Tensor, thr: torch.Tensor) -> torch.Tensor:
    """``where(bits >= t[row], x, 0)`` — the TopK mask pass, in x's dtype."""
    x = _rows(x)
    keep = mag_bits(x) >= thr[:, None]
    return torch.where(keep, x, torch.zeros_like(x))


def topk_mask(x: torch.Tensor, k) -> torch.Tensor:
    """Zero all but each row's k largest-magnitude entries (ties at the
    threshold kept; ``k >= n`` returns the row unchanged)."""
    return mask_by_threshold(x, topk_threshold_bits(x, k))


def sum_squares(x: torch.Tensor) -> torch.Tensor:
    """Per-row ``sum(x**2)`` over float32 values."""
    xf = _rows(x).to(torch.float32)
    return torch.sum(xf * xf, dim=1)


def l2_norm(x: torch.Tensor) -> torch.Tensor:
    """Per-row ``sqrt(sum(x**2))`` over float32 values."""
    return torch.sqrt(sum_squares(x))


def jax_sign(x: torch.Tensor) -> torch.Tensor:
    """``jnp.sign``: +-1, and x itself at +-0 and NaN (``torch.sign``
    returns +0 for -0.0 and 0 for NaN)."""
    one = torch.ones_like(x)
    return torch.where(x > 0, one, torch.where(x < 0, -one, x))


def qr_levels(r, rows: int, device):
    """The level count ``2 ** r`` as a float, or, for a ``(rows,)`` tensor
    of per-row r, as the ``(rows, 1)`` float32 column ``float32(2 ** r)``
    (exact: r is an integer below 127)."""
    if not isinstance(r, torch.Tensor):
        return float(2 ** int(r))
    ones = torch.ones(rows, dtype=torch.float32, device=device)
    return torch.ldexp(ones, r.to(device=device, dtype=torch.int32))[:, None]


def quantize_qr_with_uniforms(x: torch.Tensor, r, u: torch.Tensor,
                              norm: torch.Tensor) -> torch.Tensor:
    """Q_r of each row with the row's ``norm`` and uniforms ``u`` given;
    ``r`` is an int or a ``(rows,)`` integer tensor, one r a row.

    Same operation order as ``repro.kernels.ref.quantize_qr_with_uniforms``
    (and the TPU kernel), so equal inputs give bit-equal outputs.
    """
    x = _rows(x)
    levels = qr_levels(r, x.shape[0], x.device)
    xf = x.to(torch.float32)
    nrm = norm.to(torch.float32)[:, None]
    pos = nrm > 0
    y = xf.abs() / torch.where(pos, nrm, torch.ones_like(nrm))
    scaled = levels * y
    lo = torch.floor(scaled)
    frac = scaled - lo
    xi = (lo + (u < frac).to(torch.float32)) / levels
    out = nrm * jax_sign(xf) * xi
    return torch.where(pos, out, torch.zeros_like(out)).to(x.dtype)


# --------------------------------------------------------------------------- #
# The packed wire (DESIGN.md §8): slots, Q_r codes and bit-plane words
# --------------------------------------------------------------------------- #
#
# uint32 bit patterns (slot indices, codes, words) travel in int32
# containers holding the same 32 bits, so a payload's bytes are the
# reference's (4 per index and per word); the arithmetic runs in int64.

U32 = 1 << 32


def as_u32(t: torch.Tensor) -> torch.Tensor:
    """An int32 container's uint32 value, in int64."""
    return t.to(torch.int64) & ALL_ONES


def to_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) as int32 containers of the same bits."""
    return torch.where(v >= (1 << 31), v - U32, v).to(torch.int32)


def support_slots(support: torch.Tensor, cap: int) -> torch.Tensor:
    """Per row, the indices of the ``cap`` lowest-index True entries of
    ``support`` (int32); empty slots carry the sentinel ``n``.

    Slot ``j`` holds the index of the (j+1)-th True entry, found by binary
    search on the row's support-count cumsum, as
    ``repro.kernels.ref.support_slots`` does.  Counts are int64, exact at
    any n."""
    support = _rows(support)
    rows = support.shape[0]
    csum = torch.cumsum(support.to(torch.int64), dim=1)
    want = torch.arange(1, int(cap) + 1, dtype=torch.int64,
                        device=support.device).expand(rows, int(cap))
    return torch.searchsorted(csum.contiguous(), want.contiguous(),
                              side="left").to(torch.int32)


def compact_slots(x: torch.Tensor, thr: torch.Tensor, cap: int):
    """K5's plain version: the survivors of threshold ``thr[row]``
    (``bits >= t`` and ``bits != 0``) as ``cap`` slots in index order.

    Returns ``(idx, vals, nnz)``: ``idx`` (rows, cap) int32 with the
    sentinel ``n`` in empty slots, ``vals`` (rows, cap) at x's dtype with 0
    in empty slots, and ``nnz`` (rows,) int32, the whole survivor count
    (ties beyond ``cap`` included: the bit accounting counts them all).
    Tie overflow keeps the lowest-index ``cap``.
    """
    x = _rows(x)
    n = x.shape[1]
    bits = mag_bits(x)
    support = (bits >= thr[:, None]) & (bits != 0)
    idx = support_slots(support, cap)
    safe = torch.clamp(idx.to(torch.int64), 0, max(n - 1, 0))
    gathered = (torch.gather(x, 1, safe) if n else
                torch.zeros(idx.shape, dtype=x.dtype, device=x.device))
    vals = torch.where(idx < n, gathered, torch.zeros_like(gathered))
    return idx, vals, support.sum(dim=1).to(torch.int32)


def topk_slots(x: torch.Tensor, k, cap: int):
    """TopK select + slot extraction (the ``topk`` codec's encode):
    ``compact_slots`` at the radix threshold of each row's k-th largest
    magnitude."""
    return compact_slots(x, topk_threshold_bits(x, k), cap)


def topk_slots_sharded(x: torch.Tensor, k_global, cap: int, n_total: int,
                       reduce):
    """Shard-local slots of the exact whole-row TopK (DESIGN.md §9;
    ``repro.kernels.ref.topk_slots_sharded``): each row of ``x`` is this
    rank's slice of a row of ``n_total`` elements, the threshold is the
    whole row's (:func:`topk_threshold_bits` with ``reduce``), and the
    slots index the slice (sentinel: the slice's size).  A slice whose
    survivors overflow the per-shard ``cap`` keeps the lowest-index
    ``cap``.  Returns :func:`compact_slots`'s ``(idx, vals, nnz)``, ``nnz``
    the slice's whole survivor count."""
    thr = topk_threshold_bits(x, k_global, n_total=n_total, reduce=reduce)
    return compact_slots(x, thr, cap)


def qr_codes_with_uniforms(x: torch.Tensor, r: int, u: torch.Tensor,
                           norm: torch.Tensor) -> torch.Tensor:
    """The Q_r transform's stochastic levels as (1+r)-bit codes (int32):
    ``sign << r | min(level, 2**r - 1)``.

    Same uniforms and arithmetic as :func:`quantize_qr_with_uniforms`
    (``repro.kernels.ref.qr_codes_with_uniforms``): the top level ``2**r``
    saturates to ``2**r - 1`` so codes fit their r bits.
    """
    x = _rows(x)
    r = int(r)
    levels = float(2 ** r)
    xf = x.to(torch.float32)
    nrm = norm.to(torch.float32)[:, None]
    y = xf.abs() / torch.where(nrm > 0, nrm, torch.ones_like(nrm))
    scaled = levels * y
    lo = torch.floor(scaled)
    code = (lo + (u < scaled - lo).to(torch.float32)).to(torch.int64)
    code = torch.clamp(code, max=2 ** r - 1)
    sign = (xf < 0).to(torch.int64)
    return ((sign << r) | code).to(torch.int32)


def check_width(b: int) -> int:
    """A code width as an int in [1, 32], or ``ValueError``."""
    b = int(b)
    if not 1 <= b <= 32:
        raise ValueError(f"code width must be in [1, 32], got {b}")
    return b


def pack_codes(codes: torch.Tensor, b: int) -> torch.Tensor:
    """K8's plain version: bit-plane pack each row's ``n`` b-bit codes into
    ``ceil(n/32) * b`` words (int32 containers).

    Codes are grouped 32 at a time; word ``j*b + t`` holds bit ``t`` of
    group ``j``'s codes, code ``32*j + l`` at bit ``l`` — the layout of
    ``repro.kernels.ref.pack_codes``.  Bits of a code at or above ``b`` are
    ignored; the last group is padded with code 0.
    """
    codes = _rows(codes)
    b = check_width(b)
    rows, n = codes.shape
    n32 = -(-n // 32)
    c = torch.nn.functional.pad(as_u32(codes), (0, n32 * 32 - n))
    c = c.reshape(rows, n32, 32)
    lanes = torch.arange(32, dtype=torch.int64, device=codes.device)
    planes = [(((c >> t) & 1) << lanes).sum(dim=2) for t in range(b)]
    return to_i32(torch.stack(planes, dim=2).reshape(rows, n32 * b))


def unpack_codes(words: torch.Tensor, b: int, n: int) -> torch.Tensor:
    """K9's plain version, the inverse of :func:`pack_codes`: each row's
    ``n`` b-bit codes (int32 containers) from its ``ceil(n/32) * b`` words."""
    words = _rows(words)
    b, n = check_width(b), int(n)
    rows = words.shape[0]
    n32 = -(-n // 32)
    if words.shape[1] != n32 * b:
        raise ValueError(f"expected {n32 * b} words for n={n}, b={b}, got "
                         f"{words.shape[1]}")
    w = as_u32(words).reshape(rows, n32, b)
    lanes = torch.arange(32, dtype=torch.int64, device=words.device)
    codes = torch.zeros((rows, n32, 32), dtype=torch.int64,
                        device=words.device)
    for t in range(b):
        codes |= ((w[:, :, t, None] >> lanes) & 1) << t
    return to_i32(codes.reshape(rows, n32 * 32)[:, :n])


def qr_values(codes: torch.Tensor, norm: torch.Tensor, r: int) -> torch.Tensor:
    """The plain version of K9's values entry: each row's (1+r)-bit codes
    as float32 values against the row's norm, in the transform's operation
    order (``repro.compress.wire._qr_values``): ``norm * sgn * (m / 2**r)``
    where ``norm > 0``, else 0.  A sign bit over level 0 gives -0.0."""
    r = int(r)
    levels = float(2 ** r)
    m = (codes & (2 ** r - 1)).to(torch.float32)
    one = torch.ones((), dtype=torch.float32, device=codes.device)
    sgn = torch.where(((codes >> r) & 1) != 0, -one, one)
    nrm = norm[:, None]
    out = nrm * sgn * (m / levels)
    return torch.where(nrm > 0, out, torch.zeros_like(out))


def quantize_pack_with_uniforms(x: torch.Tensor, r: int, u: torch.Tensor,
                                norm: torch.Tensor) -> torch.Tensor:
    """K7's plain version: Q_r codes straight to bit-plane words,
    ``(rows, ceil(n/32) * (1 + r))`` int32 containers."""
    return pack_codes(qr_codes_with_uniforms(x, r, u, norm), 1 + int(r))


def compact_code_slots(x: torch.Tensor, u: torch.Tensor, norm: torch.Tensor,
                       thr: torch.Tensor, r: int, cap: int):
    """K6's plain version: the survivors of threshold ``thr[row]`` as
    ``cap`` slots in index order, each carrying its (1+r)-bit Q_r code.

    The codes are those of the TopK-masked vector ``where(bits >= t, x,
    0)`` against ``norm[row]`` (the masked vector's l2 norm) with the
    uniform drawn at the survivor's own index of ``u`` (``(rows, n)``), in
    :func:`qr_codes_with_uniforms`'s operation order.  Returns ``(idx,
    codes, nnz)``: ``idx`` as :func:`compact_slots` gives it (sentinel
    ``n``), ``codes`` (rows, cap) int32 holding the uint32 code (0 in empty
    slots) and ``nnz`` (rows,) int32, the whole survivor count.
    """
    x = _rows(x)
    n = x.shape[1]
    bits = mag_bits(x)
    keep = bits >= thr[:, None]
    support = keep & (bits != 0)
    xf = x.to(torch.float32)
    masked = torch.where(keep, xf, torch.zeros_like(xf))
    codes = qr_codes_with_uniforms(masked, r, u, norm)
    idx = support_slots(support, cap)
    safe = torch.clamp(idx.to(torch.int64), 0, max(n - 1, 0))
    gathered = (torch.gather(codes, 1, safe) if n else
                torch.zeros(idx.shape, dtype=torch.int32, device=x.device))
    kept = torch.where(idx < n, gathered, torch.zeros_like(gathered))
    return idx, kept, support.sum(dim=1).to(torch.int32)


def topk_qr_slots(x: torch.Tensor, k, cap: int, r: int, u: torch.Tensor):
    """TopK -> Q_r -> packed slots, the ``topk_qr`` codec's encode
    (``repro.kernels.ref.topk_qr_slots``, row-batched).

    Threshold of each row's k-th largest magnitude, the masked vector and
    its norm (the quantizer's scale, reduced over the n-sized masked row as
    the transform reduces it), the survivors' codes in ``cap`` slots
    (:func:`compact_code_slots`), then the codes bit-plane packed at ``b =
    1 + r``.  Returns ``(idx, words, norm, nnz)``: ``words`` is
    ``(rows, ceil(cap/32) * (1+r))`` int32 containers.
    """
    x = _rows(x)
    thr = topk_threshold_bits(x, k)
    xf = x.to(torch.float32)
    masked = torch.where(mag_bits(x) >= thr[:, None], xf, torch.zeros_like(xf))
    norm = l2_norm(masked)
    idx, codes, nnz = compact_code_slots(x, u, norm, thr, r, cap)
    return idx, pack_codes(codes, 1 + int(r)), norm, nnz


def rglru_scan(x: torch.Tensor, a: torch.Tensor, h0=None,
               dtype: torch.dtype = torch.float32):
    """The RG-LRU recurrence (``repro.kernels.ref.rglru_scan``), a plain
    time loop in float32: ``h_t = a_t * h_{t-1} + sqrt(max(1 - a_t^2, 0))
    * x_t`` elementwise over channels.

    x, a: (B, T, D); h0: (B, D) or None (zeros).  Returns ``(y, h_T)``:
    y (B, T, D) at x's dtype and h_T (B, D) at ``dtype``, the type the
    loop runs in (float64 gives a yardstick).  One op at a time, in this
    order, so K11 (built without FMA contraction) has its bits.
    """
    b, t, d = x.shape
    af = a.to(dtype)
    gx = torch.sqrt(torch.clamp(1.0 - af * af, min=0.0)) * x.to(dtype)
    h = (torch.zeros((b, d), dtype=dtype, device=x.device)
         if h0 is None else h0.to(dtype))
    ys = torch.empty((b, t, d), dtype=dtype, device=x.device)
    for i in range(t):
        h = af[:, i] * h + gx[:, i]
        ys[:, i] = h
    return ys.to(x.dtype), h


def wkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor, s0=None,
              dtype: torch.dtype = torch.float32):
    """The RWKV6 WKV recurrence (``repro.kernels.ref.wkv6_scan``), a plain
    time loop in float32::

        y_t = (S_{t-1} + diag(u) k_t v_t^T)^T r_t
        S_t = diag(w_t) S_{t-1} + k_t v_t^T

    r, k, w: (B, H, T, K); v: (B, H, T, V); u: (H, K); s0: (B, H, K, V) or
    None (zeros).  Returns ``(y, S_T)``: y (B, H, T, V) at r's dtype and
    S_T (B, H, K, V) at ``dtype``, the type the loop runs in (float64 gives
    a yardstick for the float32 loop's own rounding).
    """
    b, h, t, _ = r.shape
    vd = v.shape[-1]
    rf, kf, vf, wf = (z.to(dtype) for z in (r, k, v, w))
    uf = u.to(dtype)[None, :, :, None]
    s = (torch.zeros((b, h, r.shape[-1], vd), dtype=dtype,
                     device=r.device) if s0 is None else s0.to(dtype))
    ys = torch.empty((b, h, t, vd), dtype=dtype, device=r.device)
    for i in range(t):
        kv = kf[:, :, i, :, None] * vf[:, :, i, None, :]          # (B,H,K,V)
        ys[:, :, i] = torch.einsum("bhk,bhkv->bhv", rf[:, :, i], s + uf * kv)
        s = wf[:, :, i, :, None] * s + kv
    return ys.to(r.dtype), s


def rglru_scan_bwd(x: torch.Tensor, a: torch.Tensor, y: torch.Tensor,
                   dy: torch.Tensor, dtype: torch.dtype = torch.float32):
    """The gradient of :func:`rglru_scan` from ``h_0 = 0`` (K11's
    backward): a reverse time loop over ``g_t = dy_t + a_{t+1} g_{t+1}``,
    ``dx_t = beta_t g_t`` and ``da_t = g_t h_{t-1} + x_t g_t dbeta_t/da_t``
    with ``beta = sqrt(max(1 - a^2, 0))``.

    x, a, y (the forward's float32 h), dy: (B, T, D).  Each step takes the
    operations of ``jax.vjp`` of ``repro.kernels.ref.rglru_scan`` in their
    order: ``dbeta`` flows as ``((g x) (0.5 / beta)) m`` (``m``: ``max``'s
    share of the cotangent, 1 above the tie, 0.5 at ``1 - a^2 == 0``, 0
    below), negated, times ``2 a``; ``0.5 / beta`` is taken as ``(1 /
    beta) * 0.5``, equal to it for every beta in (0, 1] (and what torch's
    ``0.5 / tensor`` computes).  So at ``a = 1`` da is what JAX gives:
    ``-inf`` or ``inf`` where ``g x != 0``, NaN where it is 0.  One op at a
    time in ``dtype`` (float64 gives a yardstick), so K11's backward
    (built without FMA contraction) has its bits in float32.  Returns
    ``(dx, da)`` at x's and a's dtypes.
    """
    b, t, d = x.shape
    xf, af, yf, gf = (z.to(dtype) for z in (x, a, y, dy))
    m = 1.0 - af * af
    beta = torch.sqrt(torch.clamp(m, min=0.0))
    share = torch.where(m > 0, 1.0, torch.where(m == 0, 0.5, 0.0)).to(dtype)
    dx = torch.empty((b, t, d), dtype=dtype, device=x.device)
    da = torch.empty((b, t, d), dtype=dtype, device=x.device)
    carry = torch.zeros((b, d), dtype=dtype, device=x.device)
    zero = torch.zeros((b, d), dtype=dtype, device=x.device)
    for i in range(t - 1, -1, -1):
        g = gf[:, i] + carry
        dx[:, i] = beta[:, i] * g
        h_prev = yf[:, i - 1] if i else zero
        dbeta = ((g * xf[:, i]) * (torch.reciprocal(beta[:, i]) * 0.5)) * share[:, i]
        da[:, i] = g * h_prev + (-dbeta) * (2.0 * af[:, i])
        carry = af[:, i] * g
    return dx.to(x.dtype), da.to(a.dtype)


def wkv6_scan_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: torch.Tensor, dy: torch.Tensor,
                  dtype: torch.dtype = torch.float32, chunk: int = 64):
    """The gradient of :func:`wkv6_scan` from ``S_0 = 0`` (K12's backward),
    S_T unused.  A reverse loop carrying ``dS_t`` (the gradient of the
    state after step t, 0 after the last)::

        dr_t = (S_{t-1} + diag(u) k_t v_t^T) dy_t
        dk_t = u * r_t (v_t . dy_t) + dS_t v_t
        dv_t = (r_t . (u * k_t)) dy_t + dS_t^T k_t
        dw_t = rowsum(dS_t * S_{t-1})
        du   = sum over (b, t) of r_t * k_t (v_t . dy_t)
        dS_{t-1} = diag(w_t) dS_t + r_t dy_t^T

    ``S_{t-1}`` is recomputed from states stored every ``chunk`` steps in
    a first forward pass, as the reference's two-level scan recomputes its
    chunks under remat (dividing by w instead would fail: w = exp(-exp(.))
    underflows to 0).  r, k, w, dy: (B, H, T, K); v: (B, H, T, V); u:
    (H, K).  Runs in ``dtype`` (float64 gives a yardstick); returns ``(dr,
    dk, dv, dw, du)`` at the inputs' dtypes.
    """
    b, h, t, kd = r.shape
    vd = v.shape[-1]
    rf, kf, vf, wf, gy = (z.to(dtype) for z in (r, k, v, w, dy))
    uf = u.to(dtype)
    dev = r.device
    s = torch.zeros((b, h, kd, vd), dtype=dtype, device=dev)
    marks = []                                   # S before each chunk
    for i in range(t):
        if i % chunk == 0:
            marks.append(s)
        s = wf[:, :, i, :, None] * s + kf[:, :, i, :, None] * vf[:, :, i, None, :]
    grads = [torch.empty((b, h, t, n), dtype=dtype, device=dev)
             for n in (kd, kd, vd, kd)]
    dr, dk, dv, dw = grads
    du = torch.zeros((b, h, kd), dtype=dtype, device=dev)
    ds = torch.zeros((b, h, kd, vd), dtype=dtype, device=dev)
    for c in range(len(marks) - 1, -1, -1):
        lo, hi = c * chunk, min((c + 1) * chunk, t)
        prev = [marks[c]]                        # S_{t-1} for t in [lo, hi)
        for i in range(lo, hi - 1):
            prev.append(wf[:, :, i, :, None] * prev[-1]
                        + kf[:, :, i, :, None] * vf[:, :, i, None, :])
        for i in range(hi - 1, lo - 1, -1):
            s_prev = prev[i - lo]
            r_t, k_t, v_t, g_t = rf[:, :, i], kf[:, :, i], vf[:, :, i], gy[:, :, i]
            vdy = (v_t * g_t).sum(-1, keepdim=True)              # (B,H,1)
            dr[:, :, i] = (torch.einsum("bhkv,bhv->bhk", s_prev, g_t)
                           + uf * k_t * vdy)
            dk[:, :, i] = uf * r_t * vdy + torch.einsum("bhkv,bhv->bhk", ds, v_t)
            dv[:, :, i] = ((r_t * uf * k_t).sum(-1, keepdim=True) * g_t
                           + torch.einsum("bhkv,bhk->bhv", ds, k_t))
            dw[:, :, i] = (ds * s_prev).sum(-1)
            du = du + r_t * k_t * vdy
            ds = wf[:, :, i, :, None] * ds + r_t[..., :, None] * g_t[..., None, :]
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw.to(w.dtype),
            du.sum(0).to(u.dtype))


def mha_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window=None, q_offset: int = 0,
                  softcap=None) -> torch.Tensor:
    """Naive softmax attention with GQA, causal mask, sliding window and
    logit softcap (``repro.kernels.ref.mha_attention``), K10's oracle.

    q: (B, Hq, Tq, Dh); k, v: (B, Hkv, Tk, Dh) with ``Hq % Hkv == 0``
    (query head h reads KV head ``h // (Hq // Hkv)``).  Logits in float32,
    divided by ``sqrt(Dh)`` in float32, then ``softcap * tanh(s /
    softcap)``, then the mask: query i (absolute position ``q_offset + i``)
    sees key j where ``j <= q_offset + i`` (causal) and ``j > q_offset + i
    - window``.  A row with no visible key is 0.  Returns (B, Hq, Tq, Dh)
    at q's dtype.  Each step after the product runs in place on the one
    (B, Hq, Tq, Tk) float32 buffer, so the oracle holds two of them at
    most (the softmax's output is the second).
    """
    b, hq, tq, dh = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    group = hq // hkv
    kr = torch.repeat_interleave(k, group, dim=1).to(torch.float32)
    vr = torch.repeat_interleave(v, group, dim=1).to(torch.float32)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32), kr)
    # true divisions by float32 scalars on the device, as XLA divides
    f32 = dict(dtype=torch.float32, device=q.device)
    logits.div_(torch.tensor(float(dh), **f32).sqrt())
    if softcap is not None:
        cap = torch.tensor(float(softcap), **f32)
        logits.div_(cap).tanh_().mul_(cap)
    qpos = q_offset + torch.arange(tq, device=q.device)[:, None]
    kpos = torch.arange(tk, device=q.device)[None, :]
    mask = torch.ones((tq, tk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits.masked_fill_(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    del logits
    probs.nan_to_num_(nan=0.0)                     # rows with no visible key
    return torch.einsum("bhqk,bhkd->bhqd", probs, vr).to(q.dtype)
