"""A float64 mirror of K12's chunked backward (``csrc/wkv6_bwd.cu``, the bf16
route) against the plain backward and JAX's gradient, on the CPU.

The kernel splits the reverse pass into chunks of ``L = 16`` steps: a
state pass forward over chunks stores S (the state before each chunk), a
state-gradient pass backward stores G (dL/dS after each chunk's last
step), and a gradient kernel then works on every chunk at once from its S
and G.  Every decay is a prefix, suffix or running product of w (nothing
is divided by w).  The mirror below runs the same decomposition in torch float64, term
by term and loop by loop as the kernel orders it:

* the passes across chunks: ``S_next = diag(D) S + K~^T V`` and ``G_prev
  = diag(D) G + R~^T dY`` (``K~ = k * Q``, ``R~ = r * P``);
* inside a chunk: ``M = dY V^T``, ``S dy_t``, ``G v_s``, A (the forward's
  intra-chunk matrix, its diagonal ``r_t . (u * k_t)``), dv = ``G^T K~ +
  A^T dY``; the per-channel pair sums of dr, dk and dw's terms (b) and
  (d) by a backward running sum ``z`` and a forward running product
  ``alpha`` per key step s; dw's term (c) by a backward running sum;
  term (a) from ``rowsum(G * S)``.

Tolerances, stated before the runs:

* against ``ref.wkv6_scan_bwd`` run in float64: per gradient, |d| <=
  ``MIRROR_TOL`` (1e-10) x max |plain| (the two sum the same float64
  terms in another order);
* against ``jax.vjp`` of ``repro.kernels.ref.wkv6_scan``, which casts its
  operands to float32 inside: rtol = atol = ``SCAN_TOL`` (1e-5) on inputs
  that float32 holds exactly, as ``tests/test_torch_train.py`` holds the
  plain backward to it.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # xdist workers share the cores: no spinning OpenMP pools

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import rwkv6  # noqa: E402

L = 16
HEAD = 64
MIRROR_TOL = 1e-10
SCAN_TOL = 1e-5

F64 = torch.float64


def _pad(z, n, value=0.0):
    """(B, H, T, K) -> (B, H, n, L, K): chunks of L steps, the tail filled
    with ``value``."""
    b, h, t, kd = z.shape
    z = torch.nn.functional.pad(z, (0, 0, 0, n * L - t), value=value)
    return z.reshape(b, h, n, L, kd)


def chunked_bwd(r, k, v, w, u, dy):
    """K12's backward by chunks, in float64: ``(dr, dk, dv, dw, du)``."""
    b, h, t, kd = r.shape
    n = -(-t // L)
    u = u.to(F64)
    # a ragged tail: w = 1 and zeros past the end, as the kernels read it
    rc, kc, vc, gc = (_pad(z.to(F64), n) for z in (r, k, v, dy))
    wc = _pad(w.to(F64), n, 1.0)
    # P_t, Q_t: the products of w over a chunk's steps before and after t
    P = torch.empty_like(wc)
    Q = torch.empty_like(wc)
    p = torch.ones_like(wc[:, :, :, 0])
    for i in range(L):
        P[:, :, :, i] = p
        p = p * wc[:, :, :, i]
    D = p
    q = torch.ones_like(p)
    for i in reversed(range(L)):
        Q[:, :, :, i] = q
        q = q * wc[:, :, :, i]

    # the state pass (forward) and the state-gradient pass (backward)
    S = torch.zeros((b, h, kd, kd), dtype=F64)
    states = []
    for c in range(n):
        states.append(S)
        kt = kc[:, :, c] * Q[:, :, c]
        S = D[:, :, c, :, None] * S + torch.einsum("bhsi,bhsj->bhij", kt,
                                                   vc[:, :, c])
    G = torch.zeros_like(S)
    grads_of_state = [None] * n
    for c in reversed(range(n)):
        grads_of_state[c] = G
        rt = rc[:, :, c] * P[:, :, c]
        G = D[:, :, c, :, None] * G + torch.einsum("bhti,bhtj->bhij", rt,
                                                   gc[:, :, c])

    dr, dk, dv, dw = (torch.empty((b, h, n, L, kd), dtype=F64)
                      for _ in range(4))
    du = torch.zeros((b, h, kd), dtype=F64)
    for c in range(n):
        S, G = states[c], grads_of_state[c]
        rr, kk, vv, ww, gg = (z[:, :, c] for z in (rc, kc, vc, wc, gc))
        Pc, Qc = P[:, :, c], Q[:, :, c]
        # the products the kernel runs on the tensor cores
        M = torch.einsum("bhtj,bhsj->bhts", gg, vv)
        sd = torch.einsum("bhij,bhtj->bhti", S, gg)
        gv = torch.einsum("bhij,bhsj->bhsi", G, vv)
        A = torch.zeros((b, h, L, L), dtype=F64)
        for s in range(L):
            A[:, :, s, s] = (rr[:, :, s] * u * kk[:, :, s]).sum(-1)
            mk = kk[:, :, s]
            for i in range(s + 1, L):
                A[:, :, i, s] = (rr[:, :, i] * mk).sum(-1)
                mk = mk * ww[:, :, i]
        dv[:, :, c] = (torch.einsum("bhsi,bhij->bhsj", kk * Qc, G)
                       + torch.einsum("bhts,bhtj->bhsj", A, gg))
        # the pair sums, one key step s at a time
        adr = torch.zeros_like(rr)
        adw = torch.zeros_like(rr)
        dk_in = torch.zeros_like(rr)
        for s in range(L):
            z = torch.zeros_like(rr[:, :, 0])
            zs = [None] * L
            for i in reversed(range(L)):
                zs[i] = z
                if i == s:
                    dk_in[:, :, s] = z
                z = ww[:, :, i] * z + rr[:, :, i] * M[:, :, i, s, None]
            alpha = torch.zeros_like(z)
            for i in range(L):
                adr[:, :, i] += alpha * M[:, :, i, s, None]
                adw[:, :, i] += alpha * (zs[i] + Qc[:, :, i] * gv[:, :, s])
                alpha = kk[:, :, s] if i == s else alpha * ww[:, :, i]
        e = torch.zeros_like(rr[:, :, 0])           # dw's term (c)
        for i in reversed(range(L)):
            adw[:, :, i] += Pc[:, :, i] * e
            e = ww[:, :, i] * e + rr[:, :, i] * sd[:, :, i]
        vd = torch.diagonal(M, dim1=-2, dim2=-1)[..., None]
        dr[:, :, c] = Pc * sd + adr + u[:, None] * kk * vd
        dk[:, :, c] = Qc * gv + dk_in + u[:, None] * rr * vd
        dw[:, :, c] = Pc * Qc * (G * S).sum(-1)[:, :, None] + adw
        du += (rr * kk * vd).sum(2)
    out = [z.reshape(b, h, n * L, kd)[:, :, :t] for z in (dr, dk, dv, dw)]
    return (*out, du.sum(0))


def _inputs(b, t, seed, heads_w=()):
    """(r, k, v, w, u, dy) as float32 numpy arrays (H = 2, K = 64);
    ``heads_w``: (b, h, value) holding w at ``value`` on a whole head."""
    rng = np.random.default_rng(seed)
    h = 2
    r, k, v = (0.5 * rng.standard_normal((b, h, t, HEAD)) for _ in range(3))
    w = rng.uniform(0.0, 1.0, (b, h, t, HEAD))
    for bi, hi, value in heads_w:
        w[bi, hi] = value
    u = 0.1 * rng.standard_normal((h, HEAD))
    dy = rng.standard_normal((b, h, t, HEAD))
    return [z.astype(np.float32) for z in (r, k, v, w, u, dy)]


def _assert_within(got, want, tol):
    for name, g, w_ in zip(("dr", "dk", "dv", "dw", "du"), got, want):
        assert g.shape == w_.shape, name
        d = float((g.double() - w_.double()).abs().max())
        assert d <= tol * float(w_.abs().max()), (name, d)


EDGE_HEADS = {
    "random w": (),
    "w = 0 on a head": ((0, 0, 0.0),),
    "w = 1e-7 and 1 - 1e-7 on heads": ((0, 1, 1e-7), (-1, 0, 1.0 - 1e-7)),
}


@pytest.mark.parametrize("heads_w", list(EDGE_HEADS.values()),
                         ids=list(EDGE_HEADS))
@pytest.mark.parametrize("b,t", [(1, 1), (2, 15), (1, 16), (2, 17), (2, 37)])
def test_chunked_mirror_matches_plain_backward(b, t, heads_w):
    """Chunk edges at L = 16 (T = 1, 15, 16, 17, 37: one step, a ragged
    single chunk, exactly one, one step past, a ragged third chunk)."""
    args = [torch.from_numpy(z).to(F64) for z in _inputs(b, t, 10 + t,
                                                          heads_w)]
    want = ref.wkv6_scan_bwd(*args, dtype=F64)
    _assert_within(chunked_bwd(*args), want, MIRROR_TOL)


def test_chunked_mirror_reads_strided_heads():
    """``rwkv6._heads`` views of (B, T, H*64) activations, the layout the
    kernel reads in place, and dy as a transposed (B, T, H, 64) view."""
    r, k, v, w, u, dy = (torch.from_numpy(z).to(F64)
                         for z in _inputs(2, 37, 3, ((1, 1, 0.0),)))
    flat = [z.transpose(1, 2).reshape(2, 37, 2 * HEAD) for z in (r, k, v, w)]
    views = [rwkv6._heads(z, HEAD) for z in flat]
    assert not views[0].is_contiguous()
    dy_view = dy.transpose(1, 2).contiguous().transpose(1, 2)
    want = ref.wkv6_scan_bwd(r, k, v, w, u, dy, dtype=F64)
    _assert_within(chunked_bwd(*views, u, dy_view), want, MIRROR_TOL)


@pytest.fixture(scope="module")
def jax_wkv6_vjp():
    """``jax.vjp`` of the JAX reference scan, jitted once (one compile a
    shape)."""
    def grads(r, k, v, w, u, dy):
        (_, s), vjp = jax.vjp(jref.wkv6_scan, r, k, v, w, u)
        return vjp((dy, jnp.zeros_like(s)))
    return jax.jit(grads)


@pytest.mark.parametrize("b,t", [(2, 17), (1, 37)])
def test_chunked_mirror_matches_jax_vjp(jax_wkv6_vjp, b, t):
    """Against JAX's gradient (float32 inside the reference), w held at 0
    and at 1 - 1e-7 on whole heads."""
    ins = _inputs(b, t, 20 + t, ((0, 0, 0.0), (-1, 1, 1.0 - 1e-7)))
    want = jax_wkv6_vjp(*(jnp.asarray(z) for z in ins))
    got = chunked_bwd(*(torch.from_numpy(z).to(F64) for z in ins))
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_, np.float64),
                                   rtol=SCAN_TOL, atol=SCAN_TOL)
