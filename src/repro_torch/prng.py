"""A counter-based PRNG that reproduces ``jax.random`` (threefry2x32) bit
for bit, in plain PyTorch.

Every trajectory of the reference package hangs off jax's threefry key
chain: the 5-way round split, the cohort ``choice``, the batch
``randint`` and the Q_r uniforms.  Reimplementing that chain exactly lets
the port's rounds match the reference's cohorts, batch indices and
rounding draws bit for bit, so the parity tests compare counts exactly.

A key is the raw ``key_data`` pair ``(k0, k1)`` of uint32 words, held as
an int64 tensor of shape ``(..., 2)``; every function batches over the
leading key axes.  torch's uint32 coverage is thin, so all uint32
arithmetic runs in int64 with ``& 0xFFFFFFFF`` after each add and shift.

The formulas follow jax's partitionable threefry mode (the default since
jax 0.5): with ``T(key, (hi, lo))`` = threefry2x32 over the counter pair,

* ``split(key, n)[i] == T(key, (0, i))``;
* ``bits(key, (n,))[i] == hi ^ lo`` of ``T(key, (0, i))``;
* ``uniform == view_f32((bits >> 9) | 0x3F800000) - 1``.

Key chains are cheap and stay wherever the caller keeps them (the round
drivers keep them on the host); bulk draws (``bits``/``uniform`` over a
parameter vector) run on the ``device`` they are asked for.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch import not_ported

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & MASK32


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor):
    """Threefry-2x32 with 20 rounds on int64 tensors holding uint32
    values; all four arguments broadcast against each other."""
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & MASK32
    x1 = (x1 + k1) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def PRNGKey(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``'s key data: ``(seed >> 32, seed & mask)``
    for a 32-bit seed (the high word is 0; a negative seed wraps)."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 32:
        raise ValueError(f"seed {seed} does not fit 32 bits")
    return torch.tensor([0, seed & MASK32], dtype=torch.int64)


def key_data(key) -> torch.Tensor:
    """A key as an int64 ``(..., 2)`` tensor (accepts numpy uint32 key
    data, e.g. ``np.asarray(jax.random.key_data(k))``)."""
    if isinstance(key, torch.Tensor):
        if key.shape[-1:] != (2,):
            raise ValueError(f"key data must end in 2 words, got {key.shape}")
        return key.to(torch.int64)
    arr = np.asarray(key)
    if arr.shape[-1:] != (2,):
        raise ValueError(f"key data must end in 2 words, got {arr.shape}")
    return torch.from_numpy(arr.astype(np.int64))


def _counter_hash(key: torch.Tensor, n: int, device=None):
    """``T(key, (0, i))`` for ``i < n``: two ``(..., n)`` words."""
    key = key_data(key).to(device)
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    k0 = key[..., 0:1]
    k1 = key[..., 1:2]
    return threefry2x32(k0, k1, torch.zeros_like(i), i)


def split(key, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``(..., 2)`` -> ``(..., num, 2)``."""
    o0, o1 = _counter_hash(key, int(num))
    return torch.stack((o0, o1), dim=-1)


def fold_in(key, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: threefry2x32 of ``key`` over the
    seed words ``(0, uint32(data))``.  ``data`` may be a tensor of any
    shape (e.g. a cohort's client ids); ``(2,)`` key -> ``data.shape +
    (2,)`` keys."""
    key = key_data(key)
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & MASK32
    o0, o1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack((o0, o1), dim=-1)


def bits(key, n: int, device=None) -> torch.Tensor:
    """``jax.random.bits(key, (n,))`` (uint32 values in int64):
    ``(..., 2)`` keys -> ``(..., n)`` words, computed on ``device``."""
    o0, o1 = _counter_hash(key, int(n), device)
    return o0 ^ o1


def uniform(key, n: int, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, (n,))`` in [0, 1), float32."""
    b = bits(key, n, device)
    mant = ((b >> 9) | 0x3F800000).to(torch.int32)
    return mant.view(torch.float32) - 1.0


# XLA's float32 log on the CPU: the Cephes polynomial its CPU backend
# emits, whose machine code fuses the polynomial's multiply-adds (the six
# inner steps, the two Horner steps in x^3 and y * x^3 + q1 * e) into FMAs.
# Its constants are float32: each is rounded here once.
_LOG_SQRTHF, *_LOG_P, _LOG_Q1, _LOG_Q2 = (float(np.float32(c)) for c in (
    0.707106781186547524, 7.0376836292E-2, -1.1514610310E-1,
    1.1676998740E-1, -1.2420140846E-1, 1.4249322787E-1, -1.6668057665E-1,
    2.0000714765E-1, -2.4999993993E-1, 3.3333331174E-1, -2.12194440e-4,
    0.693359375))


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` with one rounding (the product of two float32
    values is exact in float64); b and c are tensors or float32 values."""
    b = b.double() if torch.is_tensor(b) else b
    c = c.double() if torch.is_tensor(c) else c
    return (a.double() * b + c).float()


def xla_log(x: torch.Tensor) -> torch.Tensor:
    """``jnp.log`` of a positive normal float32 tensor as XLA computes it
    on the CPU, bit for bit (``torch.log`` is correctly rounded and differs
    in about 14% of values; checked over every uniform ``gumbel`` draws and
    the logs of those).  Inputs at or below the smallest normal give
    ``log(tiny)``; gumbel never passes one."""
    tiny = float(np.finfo(np.float32).tiny)
    bits = torch.clamp(x, min=tiny).view(torch.int32)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)
    low = m < _LOG_SQRTHF
    m = (m - 1.0) + torch.where(low, m, torch.zeros_like(m))
    e = e - low.to(torch.float32)
    x2 = m * m
    x3 = x2 * m
    p = _LOG_P
    y = _fma(_fma(m, p[0], p[1]), m, p[2])
    y1 = _fma(_fma(m, p[3], p[4]), m, p[5])
    y2 = _fma(_fma(m, p[6], p[7]), m, p[8])
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, _LOG_Q1 * e)
    m = m - 0.5 * x2
    return (m + y) + _LOG_Q2 * e


# XLA's float32 sin on the CPU is a call to the C library's sinf; glibc's
# (since 2.28) reduces and evaluates in double and rounds once.  Its
# constants: the quadrant signs, 2/pi scaled by 2^24, pi/2, the cosine
# polynomial c0..c4 and the sine polynomial s1..s3 (the second table, for
# quadrants 2 and 3, negates the cosine half), and 4/pi's bits for the
# reduction of |x| >= 120.
_SIN_SIGN = (1.0, -1.0, -1.0, 1.0)
_SIN_HPI_INV = float.fromhex("0x1.45F306DC9C883p+23")
_SIN_HPI = float.fromhex("0x1.921FB54442D18p0")
_SIN_PI63 = float.fromhex("0x1.921FB54442D18p-62")
_SIN_TABLE = tuple(float.fromhex(h) for h in (
    "0x1p0", "-0x1.ffffffd0c621cp-2", "0x1.55553e1068f19p-5",
    "-0x1.6c087e89a359dp-10", "0x1.99343027bf8c3p-16",
    "-0x1.555545995a603p-3", "0x1.1107605230bc4p-7",
    "-0x1.994eb3774cf24p-13"))
_SIN_TABLE_Q23 = tuple(-c for c in _SIN_TABLE[:5]) + _SIN_TABLE[5:]
_INV_PIO4 = (
    0xa2, 0xa2f9, 0xa2f983, 0xa2f9836e, 0xf9836e4e, 0x836e4e44, 0x6e4e4415,
    0x4e441529, 0x441529fc, 0x1529fc27, 0x29fc2757, 0xfc2757d1, 0x2757d1f5,
    0x57d1f534, 0xd1f534dd, 0xf534ddc0, 0x34ddc0db, 0xddc0db62, 0xc0db6295,
    0xdb629599, 0x6295993c, 0x95993c43, 0x993c4390, 0x3c439041)


def _sinf_poly(x, x2, odd, q23):
    """glibc's ``sinf_poly``: the sine polynomial on even quadrants, the
    cosine one on odd, from the table the quadrant picks (float64)."""
    def poly(c):
        x3 = x * x2
        s = (x3 * x2) * (x2 * c[7] + c[6]) + (x3 * c[5] + x)
        x4 = x2 * x2
        cos = (x4 * x2) * (x2 * c[4] + c[3]) + (x4 * c[2] + (x2 * c[1] + c[0]))
        return torch.where(odd, cos, s)
    return torch.where(q23, poly(_SIN_TABLE_Q23), poly(_SIN_TABLE))


def xla_sin(y: torch.Tensor) -> torch.Tensor:
    """``jnp.sin`` of a float32 tensor as XLA computes it on the CPU, bit
    for bit: glibc's ``sinf`` (``torch.sin`` differs in about 1 value in
    5, the correctly rounded sine in about 1 in 80).  The reduction and
    both polynomials run in float64 as glibc's do, so every step is one
    IEEE operation and the card gives the CPU's bits."""
    y = y.to(torch.float32)
    yi = y.view(torch.int32).to(torch.int64) & MASK32
    top = (yi >> 20) & 0x7FF                      # glibc's abstop12
    x = y.double()
    zero = torch.zeros_like(yi)
    # |y| < 120: one multiply-subtract by pi/2, the quadrant from the
    # truncated 2^24-scaled product
    n = (torch.trunc(x * _SIN_HPI_INV).to(torch.int64) + 0x800000) >> 24
    n = torch.where(top < 0x42F, n, zero)
    xr = x - n.double() * _SIN_HPI
    # |y| >= 120: 4/pi's bits in 64-bit integer arithmetic (int64 wraps
    # as uint64 does; right shifts are masked to be logical)
    tab = torch.tensor(_INV_PIO4, dtype=torch.int64, device=y.device)
    j = (yi >> 26) & 15
    m = ((yi & 0xFFFFFF) | 0x800000) << ((yi >> 23) & 7)
    r0 = (m * tab[j]) & MASK32
    r0 = (((m * tab[j + 8]) >> 32) & MASK32) | (r0 << 32)
    r0 = r0 + m * tab[j + 4]
    nl = ((r0 + (1 << 61)) >> 62) & 3
    xl = (r0 - (nl << 62)).double() * _SIN_PI63
    large = top >= 0x42F
    sign_q = torch.where(large, nl + ((yi >> 31) & 1), n)
    n = torch.where(large, nl, n)
    xr = torch.where(large, xl, xr)
    sign = torch.tensor(_SIN_SIGN, dtype=torch.float64,
                        device=y.device)[sign_q & 3]
    reduced = _sinf_poly(xr * sign, xr * xr, (n & 1) == 1,
                         (sign_q & 2) == 2)
    # |y| < 0.75 (glibc's cut at abstop12(pi/4)): no reduction
    small = _sinf_poly(x, x * x, torch.zeros_like(top, dtype=torch.bool),
                       torch.zeros_like(top, dtype=torch.bool))
    out = torch.where(top < 0x3F4, small, reduced).float()
    # tiny arguments return themselves; inf and NaN give NaN
    out = torch.where(top < 0x398, y, out)
    return torch.where(top >= 0x7F8, torch.full_like(y, math.nan), out)


# XLA's float32 log-plus-one on the CPU: for |x| < sqrt(2) - 1 the Cephes
# rational approximation x - x^2/2 + x^3 P(x)/Q(x), whose two Horner
# chains its machine code fuses into FMAs; elsewhere log(1 + x).
_LOG1P_SMALL = float(np.float32(0.41421356237309504880))
_LOG1P_P = tuple(float(np.float32(c)) for c in (
    4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
    6.5787325942061044846969E0, 2.9911919328553073277375E1,
    6.0949667980987787057556E1, 5.7112963590585538103336E1,
    2.0039553499201281259648E1))
_LOG1P_Q = tuple(float(np.float32(c)) for c in (
    1.0, 1.5062909083469192043167E1, 8.3047565967967209469434E1,
    2.2176239823732856465394E2, 3.0909872225312059774938E2,
    2.1642788614495947685003E2, 6.0118660497603843919306E1))


def xla_log1p(x: torch.Tensor) -> torch.Tensor:
    """``jnp.log1p`` of a float32 tensor above -1 as XLA computes it on the
    CPU, bit for bit (checked over ``-u*u`` for every uniform ``normal``
    draws)."""
    x2 = x * x
    p = torch.full_like(x, _LOG1P_P[0])
    for c in _LOG1P_P[1:]:
        p = _fma(p, x, c)
    q = torch.full_like(x, _LOG1P_Q[0])
    for c in _LOG1P_Q[1:]:
        q = _fma(q, x, c)
    small = x + (x2 * -0.5 + (x * x2) * (p / q))
    return torch.where(x.abs() < _LOG1P_SMALL, small, xla_log(x + 1.0))


# lax.erf_inv for float32 as XLA expands it (Giles' single-precision
# approximation): 9 coefficients for w < 5 and 9 for w >= 5, highest first.
_ERFINV_LT5 = tuple(float(np.float32(c)) for c in (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941))
_ERFINV_GE5 = tuple(float(np.float32(c)) for c in (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682))
_SQRT2 = float(np.float32(math.sqrt(2.0)))


def normal(key, shape, device=None) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` in float32, bit for bit with jax
    on the CPU: ``sqrt(2)·erf_inv(u)`` with ``u`` uniform in (-1, 1) and
    XLA's own ``erf_inv`` (``w = -log1p(-u*u)``, Giles' polynomial in
    ``w - 2.5`` or ``sqrt(w) - 3`` with every Horner step one FMA)."""
    shape = tuple(int(s) for s in shape)
    out = normal_from_uniform(uniform(key, math.prod(shape), device))
    return out.reshape(key_data(key).shape[:-1] + shape)


def normal_from_uniform(f: torch.Tensor) -> torch.Tensor:
    """The normals :func:`normal` makes of float32 uniforms ``f`` in
    [0, 1)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    # jax: max(lo, f * (1 - lo) + lo), and 1 - lo rounds to 2 in float32
    u = torch.clamp(f * 2.0 + lo, min=lo)
    w = -xla_log1p(u * -u)
    lt5 = w < 5.0
    # sqrt in float64, rounded once: torch's float32 sqrt on the CPU is not
    # correctly rounded everywhere, XLA's is
    z = torch.where(lt5, w - 2.5, torch.sqrt(w.double()).float() - 3.0)
    p = torch.where(lt5, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma(p, z, torch.where(lt5, a, b))
    x = torch.where(u.abs() == 1.0, u * math.inf, p * u)
    return x * _SQRT2


def gumbel(key, shape, device=None) -> torch.Tensor:
    """``jax.random.gumbel(key, shape)`` in float32, jax's default "low"
    mode: ``-log(-log(u))`` with ``u`` uniform in [tiny, 1), bit for bit
    with jax on the CPU (the uniforms have jax's bits and :func:`xla_log`
    is XLA's log)."""
    shape = tuple(int(s) for s in shape)
    tiny = float(np.finfo(np.float32).tiny)
    u = uniform(key, math.prod(shape), device)
    # jax: max(tiny, u * (1 - tiny) + tiny), and 1 - tiny rounds to 1
    u = torch.clamp(u + tiny, min=tiny)
    g = -xla_log(-xla_log(u))
    return g.reshape(key_data(key).shape[:-1] + shape)


def categorical(key, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)`` for one key:
    ``argmax(gumbel(key, logits.shape) + logits)`` over the last axis
    (int64; ties go to the first index, as in jax)."""
    key = key_data(key)
    if key.shape != (2,):
        raise ValueError("categorical takes one key")
    g = gumbel(key, logits.shape, logits.device)
    return torch.argmax(g + logits.to(torch.float32), dim=-1)


def randint(key, n: int, minval, maxval, device=None) -> torch.Tensor:
    """``jax.random.randint(key, (n,), minval, maxval)``'s int32 values, as
    int64 (ready to index with).

    ``minval``/``maxval`` may be per-key tensors of the key batch shape
    (e.g. a per-client shard size).  jax draws two words per value and
    folds them with a multiplier; the uint32 wrap of that multiplier's
    square is part of the result and is kept here.
    """
    key = key_data(key)
    k = split(key, 2)
    hb = bits(k[..., 0, :], n, device)
    lb = bits(k[..., 1, :], n, device)
    dev = hb.device
    lo = torch.as_tensor(minval, dtype=torch.int64, device=dev)
    hi = torch.as_tensor(maxval, dtype=torch.int64, device=dev)
    lo = lo.reshape(lo.shape + (1,) * (hb.dim() - lo.dim()))
    hi = hi.reshape(hi.shape + (1,) * (hb.dim() - hi.dim()))
    span = torch.where(hi <= lo, torch.ones_like(hi), (hi - lo) & MASK32)
    mult = torch.remainder(torch.full_like(span, 2 ** 16), span)
    mult = torch.remainder((mult * mult) & MASK32, span)
    off = (torch.remainder(hb, span) * mult) & MASK32
    off = (off + torch.remainder(lb, span)) & MASK32
    return lo + torch.remainder(off, span)


def _shuffle_rounds(n: int) -> int:
    """jax's static round count for its sort-based shuffle."""
    return int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))


def permutation(key, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` for one key: repeated stable
    sorts of ``arange(n)`` by fresh 32-bit words."""
    key = key_data(key)
    if key.shape != (2,):
        raise ValueError("permutation takes one key")
    x = torch.arange(n, dtype=torch.int64)
    for _ in range(_shuffle_rounds(n)):
        key, sub = split(key, 2)
        order = torch.sort(bits(sub, n), stable=True).indices
        x = x[order]
    return x


def choice(key, n: int, s: int, replace: bool = False) -> torch.Tensor:
    """``jax.random.choice(key, n, (s,), replace=False)``: the first ``s``
    entries of ``permutation(key, n)``."""
    if replace:
        raise not_ported("choice(replace=True)")
    if not 0 <= s <= n:
        raise ValueError(f"cannot draw {s} of {n} without replacement")
    return permutation(key, n)[:s]
