"""The port's attention entry point, ``ops.mha_attention`` (K10), against
the JAX package's oracle ``ref.mha_attention`` and its Pallas kernel
``flash_attention`` in interpret mode (``bq = bk = 64``), on the CPU; and
the CUDA kernel against its plain version on a card.

The cases are those of the JAX package's own flash tests
(``tests/test_kernels.py``): five option sets, three GQA shapes, a decode
offset and both dtypes, on inputs from numpy seeds.  Tolerances are the
JAX tests' own: rtol = atol = 2e-5 in float32 (softmax sums in other
orders), 2e-2 in bfloat16, compared in the working type.  A ragged
``T = 100`` runs against the oracle only (the Pallas kernel wants T
divisible by its blocks).  A row with no visible key is 0 in the port and
the oracle; the Pallas kernel, which masks with -1e30, gives the mean of v
there.

On the card bfloat16 takes the wgmma kernel fed by TMA and float32 the
SIMT kernel; the pieces of that route that are plain Python (the dtype's
route, the TMA eligibility check, the schedule of key tiles) are tested
here on the CPU, the schedule against a brute-force mask.

JAX is imported inside a fixture, so the ``cuda`` tests run on a card
machine that has no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_flash.py
"""

from types import SimpleNamespace

import numpy as np
import pytest

import chip_smoke

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # xdist workers share the cores: no spinning OpenMP pools

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

F32_TOL, BF16_TOL = 2e-5, 2e-2

OPTIONS = [dict(causal=True), dict(causal=False),
           dict(causal=True, window=64), dict(causal=True, softcap=30.0),
           dict(causal=True, window=32, softcap=50.0)]
GQA = [(8, 8, 32), (8, 1, 64), (6, 2, 128)]


@pytest.fixture(scope="module")
def jx():
    """The JAX package's oracle and Pallas kernel (CPU only)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import flash_attention as jfa
    from repro.kernels import ref as jref
    return SimpleNamespace(jnp=jnp, fa=jfa, ref=jref)


def _qkv(seed, qshape, kshape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(qshape).astype(np.float32),
            rng.standard_normal(kshape).astype(np.float32),
            rng.standard_normal(kshape).astype(np.float32))


def _port(arrays, dtype=torch.float32, **kw):
    return ops.mha_attention(*(torch.from_numpy(a).to(dtype) for a in arrays),
                             **kw)


def _jax(jx, arrays, dtype=None, pallas=False, bq=64, **kw):
    jnp = jx.jnp
    args = [jnp.asarray(a, dtype or jnp.float32) for a in arrays]
    if pallas:
        out = jx.fa.flash_attention(*args, interpret=True, bq=bq, bk=64, **kw)
    else:
        out = jx.ref.mha_attention(*args, **kw)
    return np.asarray(out, np.float32)


def _close(got, want, tol=F32_TOL):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


# --------------------------------------------------------------------------- #
# the JAX package's cases: the oracle and the Pallas kernel
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("kw", OPTIONS, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()))
def test_options_match_jax_oracle_and_pallas(jx, kw):
    arrays = _qkv(0, (2, 4, 128, 64), (2, 2, 128, 64))
    got = _port(arrays, **kw)
    assert got.shape == (2, 4, 128, 64) and got.dtype == torch.float32
    _close(got, _jax(jx, arrays, **kw))
    _close(got, _jax(jx, arrays, pallas=True, **kw))


@pytest.mark.parametrize("hq,hkv,dh", GQA)
def test_gqa_shapes_match_jax_oracle_and_pallas(jx, hq, hkv, dh):
    arrays = _qkv(1, (1, hq, 128, dh), (1, hkv, 128, dh))
    got = _port(arrays, causal=True)
    _close(got, _jax(jx, arrays, causal=True))
    _close(got, _jax(jx, arrays, pallas=True, causal=True))


def test_decode_offset_matches_jax_oracle_and_pallas(jx):
    arrays = _qkv(2, (2, 4, 1, 64), (2, 2, 256, 64))
    kw = dict(causal=True, q_offset=255)
    got = _port(arrays, **kw)
    _close(got, _jax(jx, arrays, **kw))
    _close(got, _jax(jx, arrays, pallas=True, bq=1, **kw))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dtypes_match_jax_oracle_and_pallas(jx, dtype):
    arrays = _qkv(3, (1, 2, 128, 64), (1, 2, 128, 64))
    jdt = getattr(jx.jnp, dtype)
    got = _port(arrays, getattr(torch, dtype), causal=True)
    assert got.dtype == getattr(torch, dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    _close(got, _jax(jx, arrays, jdt, causal=True), tol)
    _close(got, _jax(jx, arrays, jdt, pallas=True, causal=True), tol)


@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=False),
                                dict(causal=True, window=30, softcap=20.0),
                                dict(causal=True, q_offset=7)],
                         ids=["causal", "full", "window-softcap", "offset"])
def test_ragged_length_matches_jax_oracle(jx, kw):
    arrays = _qkv(4, (2, 6, 100, 32), (2, 3, 100, 32))
    _close(_port(arrays, **kw), _jax(jx, arrays, **kw))


def test_rows_with_no_visible_key_are_zero_where_pallas_gives_mean_of_v(jx):
    """q_offset 120, window 20, Tk 128: row i sees keys (100 + i, 120 + i]
    below 128, so rows 0-26 see keys and rows 27-63 none."""
    arrays = _qkv(5, (1, 2, 64, 64), (1, 1, 128, 64))
    kw = dict(causal=True, window=20, q_offset=120)
    got = _port(arrays, **kw).numpy()
    _close(got, _jax(jx, arrays, **kw))
    pallas = _jax(jx, arrays, pallas=True, **kw)
    _close(got[:, :, :27], pallas[:, :, :27])
    assert not got[:, :, 27:].any()
    mean_v = arrays[2].mean(axis=2, keepdims=True)           # (1, 1, 1, 64)
    np.testing.assert_allclose(pallas[:, :, 27:],
                               np.broadcast_to(mean_v, (1, 2, 37, 64)),
                               rtol=F32_TOL, atol=F32_TOL)


def test_cpu_calls_launch_nothing():
    ops.reset_launch_counts()
    arrays = _qkv(6, (1, 2, 8, 32), (1, 1, 8, 32))
    got = _port(arrays, causal=True)
    want = ref.mha_attention(*(torch.from_numpy(a) for a in arrays))
    assert torch.equal(got, want)
    assert ops.launch_counts()["flash_attention"] == 0


# --------------------------------------------------------------------------- #
# the wrapper's checks (the same on either device)
# --------------------------------------------------------------------------- #

def _t(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize("args,kw,err", [
    ((_t(2, 4, 8, 64), _t(2, 2, 8, 64), _t(2, 2, 8)), {}, ValueError),
    ((_t(2, 4, 8, 64), _t(2, 2, 8, 64, dtype=torch.bfloat16),
      _t(2, 2, 8, 64)), {}, TypeError),
    ((_t(1, 2, 8, 64, dtype=torch.float16),) * 3, {}, TypeError),
    ((_t(1, 3, 8, 64), _t(1, 2, 8, 64), _t(1, 2, 8, 64)), {}, ValueError),
    ((_t(1, 2, 8, 48), _t(1, 2, 8, 48), _t(1, 2, 8, 48)), {}, ValueError),
    ((_t(1, 2, 64, 8).transpose(-1, -2), _t(1, 2, 8, 64), _t(1, 2, 8, 64)),
     {}, ValueError),
    ((_t(1, 2, 8, 64), _t(1, 2, 8, 64), _t(1, 2, 9, 64)), {}, ValueError),
    ((_t(2, 2, 8, 64), _t(1, 2, 8, 64), _t(1, 2, 8, 64)), {}, ValueError),
    ((_t(1, 2, 8, 64),) * 3, dict(window=0), ValueError),
    ((_t(1, 2, 8, 64),) * 3, dict(softcap=0.0), ValueError),
    ((_t(1, 2, 8, 64),) * 3, dict(q_offset=-1), ValueError),
], ids=["rank", "mixed-dtype", "float16", "group", "head-dim", "last-dim",
        "kv-shape", "batch", "window", "softcap", "q-offset"])
def test_wrapper_refuses(args, kw, err):
    with pytest.raises(err):
        fa.flash_attention(*args, **kw)


# --------------------------------------------------------------------------- #
# the card's route, in plain Python: dtype, TMA eligibility, key-tile schedule
# --------------------------------------------------------------------------- #

def test_route_by_dtype():
    assert fa.route(torch.bfloat16) == "wgmma"
    assert fa.route(torch.float32) == "simt"
    with pytest.raises(TypeError):
        fa.route(torch.float16)


def _view(kind):
    """(shape, strides in elements, element size, data pointer)."""
    if kind == "dense":
        t = torch.zeros(2, 4, 77, 128, dtype=torch.bfloat16)
        return t.shape, t.stride(), 2, 4096
    if kind == "split-heads":           # (B, T, H * Dh) -> (B, H, T, Dh)
        t = torch.zeros(2, 77, 8 * 32, dtype=torch.bfloat16)
        v = t.reshape(2, 77, 8, 32).transpose(1, 2)
        return v.shape, v.stride(), 2, 4096
    if kind == "size-one-axes":         # B = H = T = 1: any stride passes
        return (1, 1, 1, 64), (3, 5, 7, 1), 2, 4096
    if kind == "padded-rows":           # T stride 132 * 2 = 264 bytes
        t = torch.zeros(1, 2, 50, 132, dtype=torch.bfloat16)[..., :128]
        return t.shape, t.stride(), 2, 4096
    if kind == "odd-heads":             # H stride 40 * 2 = 80 bytes: fine;
        return (1, 3, 10, 32), (1240, 40, 124, 1), 2, 4096   # T: 248 no
    if kind == "misaligned":
        t = torch.zeros(1, 2, 8, 64, dtype=torch.bfloat16)
        return t.shape, t.stride(), 2, 4096 + 8
    if kind == "expanded":              # a KV head broadcast: stride 0
        t = torch.zeros(1, 1, 8, 64, dtype=torch.bfloat16).expand(1, 4, 8, 64)
        return t.shape, t.stride(), 2, 4096
    raise KeyError(kind)


@pytest.mark.parametrize("kind,ok", [
    ("dense", True), ("split-heads", True), ("size-one-axes", True),
    ("padded-rows", False), ("odd-heads", False), ("misaligned", False),
    ("expanded", False)])
def test_tma_refusal(kind, ok):
    why = fa.tma_refusal(*_view(kind))
    assert (why is None) == ok, why


def test_tma_strides_are_bytes_and_fill_size_one_axes():
    assert fa.tma_strides((2, 4, 77, 128), (4 * 77 * 128, 77 * 128, 128, 1),
                          2) == (2 * 4 * 77 * 128, 2 * 77 * 128, 256)
    # B = H = T = 1: each takes the next inner axis's extent
    assert fa.tma_strides((1, 1, 1, 64), (3, 5, 7, 1), 2) == (128, 128, 128)


def _visible(tq, tk, causal, window, q_offset):
    qpos = q_offset + np.arange(tq)[:, None]
    kpos = np.arange(tk)[None, :]
    ok = np.ones((tq, tk), bool)
    if causal:
        ok &= kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    return ok


SCHEDULES = [(128, 128, True, None, 0), (128, 128, False, None, 0),
             (1000, 1000, True, 300, 0), (333, 333, True, None, 0),
             (1, 4641, True, None, 4640), (64, 128, True, 20, 120),
             (200, 200, True, 50, 0), (100, 100, True, None, 7),
             (300, 4641, True, 1024, 4341), (70, 90, False, 33, 5),
             (5, 0, True, None, 0)]


@pytest.mark.parametrize("dh", [128, 256])
@pytest.mark.parametrize("tq,tk,causal,window,q_offset", SCHEDULES)
def test_key_tile_schedule_matches_brute_force_mask(tq, tk, causal, window,
                                                    q_offset, dh):
    """Each tile of 64 query rows visits exactly the key tiles (128 keys at
    Dh 128, 64 at Dh 256) that hold a visible (query, key) pair; the
    visible pairs are those the chip smoke's bound counts."""
    vis = _visible(tq, tk, causal, window, q_offset)
    assert int(vis.sum()) == chip_smoke.attention_pairs(tq, tk, causal,
                                                        window, q_offset)
    bk = fa.block_k(dh)
    assert bk == (128 if dh == 128 else 64)
    counts = fa.key_tiles_per_query_tile(tq, tk, causal, window, q_offset,
                                         dh)
    assert len(counts) == -(-tq // 64)
    for qt, n in enumerate(counts):
        rows = vis[64 * qt:64 * qt + 64]
        want = {key // bk for key in np.nonzero(rows.any(axis=0))[0]}
        lo, hi = fa.key_tile_range(64 * qt, tq, tk, causal, window, q_offset,
                                   bk)
        assert set(range(lo, hi)) == want
        assert n == len(want)


# --------------------------------------------------------------------------- #
# on a card: the kernel against its plain version
# --------------------------------------------------------------------------- #

@pytest.fixture
def cuda_device():
    """The card, with the plain version's float32 products in full float32
    (TF32 off, restored after)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("b,hq,hkv,tq,tk,dh,kw", [
    (2, 4, 2, 128, 128, 64, dict(causal=True)),
    (2, 4, 2, 128, 128, 64, dict(causal=False)),
    (2, 4, 2, 128, 128, 64, dict(causal=True, window=64)),
    (2, 4, 2, 128, 128, 64, dict(causal=True, softcap=30.0)),
    (2, 4, 2, 128, 128, 64, dict(causal=True, window=32, softcap=50.0)),
    (1, 8, 8, 128, 128, 32, dict(causal=True)),
    (1, 7, 1, 1000, 1000, 128, dict(causal=True, window=300)),
    (1, 8, 2, 333, 333, 256, dict(causal=True, softcap=50.0)),
    (2, 4, 2, 1, 4641, 256, dict(causal=True, q_offset=4640)),
    (1, 2, 1, 64, 128, 64, dict(causal=True, window=20, q_offset=120)),
])
def test_kernel_matches_plain(cuda_device, dtype, b, hq, hkv, tq, tk, dh, kw):
    gen = torch.Generator(device=cuda_device).manual_seed(tq + dh)
    q = torch.randn((b, hq, tq, dh), generator=gen, device=cuda_device)
    k, v = (torch.randn((b, hkv, tk, dh), generator=gen, device=cuda_device)
            for _ in range(2))
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    ops.reset_launch_counts()
    got = ops.mha_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == 1
    want = ref.mha_attention(q, k, v, **kw)
    assert got.dtype == dtype and got.shape == want.shape
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_kernel_reads_strided_heads_in_place(cuda_device):
    """q/k/v as ``_split_heads`` views of (B, T, H * Dh) activations."""
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    b, t, dh = 2, 77, 128
    acts = [torch.randn((b, t, h * dh), generator=gen, device=cuda_device)
            .to(torch.bfloat16) for h in (8, 2, 2)]
    q, k, v = (a.reshape(b, t, -1, dh).transpose(1, 2) for a in acts)
    got = ops.mha_attention(q, k, v, causal=True, window=40)
    want = ref.mha_attention(q, k, v, causal=True, window=40)
    torch.testing.assert_close(got.float(), want.float(), rtol=BF16_TOL,
                               atol=BF16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [32, 64, 128, 256])
@pytest.mark.parametrize("group", [1, 2, 4, 7, 8])
def test_bf16_kernel_every_head_size_and_group(cuda_device, dh, group):
    """The wgmma route at every head size and GQA group, with a window and
    a softcap on odd groups."""
    kw = (dict(causal=True, window=100, softcap=30.0) if group % 2 else
          dict(causal=True))
    gen = torch.Generator(device=cuda_device).manual_seed(dh + group)
    q = torch.randn((1, 2 * group, 256, dh), generator=gen,
                    device=cuda_device).to(torch.bfloat16)
    k, v = (torch.randn((1, 2, 256, dh), generator=gen, device=cuda_device)
            .to(torch.bfloat16) for _ in range(2))
    got = ops.mha_attention(q, k, v, **kw)
    want = ref.mha_attention(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), rtol=BF16_TOL,
                               atol=BF16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,tq,tk,dh,kw", [
    (1, 8, 2, 1000, 1000, 128, dict(causal=True, window=300, softcap=50.0)),
    (1, 4, 4, 1000, 1000, 64, dict(causal=False)),
    (4, 16, 8, 1, 4641, 256, dict(causal=True, q_offset=4640,
                                  softcap=50.0)),
], ids=["ragged-window-softcap", "ragged-full", "decode-4641"])
def test_bf16_kernel_ragged_and_long_decode(cuda_device, b, hq, hkv, tq, tk,
                                            dh, kw):
    gen = torch.Generator(device=cuda_device).manual_seed(tq + tk)
    q = torch.randn((b, hq, tq, dh), generator=gen,
                    device=cuda_device).to(torch.bfloat16)
    k, v = (torch.randn((b, hkv, tk, dh), generator=gen, device=cuda_device)
            .to(torch.bfloat16) for _ in range(2))
    ops.reset_launch_counts()
    got = ops.mha_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == 1
    want = ref.mha_attention(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), rtol=BF16_TOL,
                               atol=BF16_TOL)


@pytest.mark.cuda
def test_bf16_kernel_refuses_a_view_tma_cannot_read(cuda_device):
    """T stride 132 * 2 = 264 bytes, not a multiple of 16: refused with
    the reason, not copied; the same view in float32 (the SIMT route) is
    read as it is."""
    buf = torch.randn((1, 2, 50, 132), device=cuda_device)
    q = buf.to(torch.bfloat16)[..., :128]
    with pytest.raises(ValueError, match="multiple of 16"):
        fa.flash_attention(q, q, q)
    got = fa.flash_attention(buf[..., :128], buf[..., :128], buf[..., :128])
    want = ref.mha_attention(buf[..., :128], buf[..., :128], buf[..., :128])
    torch.testing.assert_close(got, want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.cuda
def test_bf16_kernel_runs_on_tensor_cores_and_tma(cuda_device):
    """The wgmma library's SASS holds HGMMA (wgmma) and UTMALDG (TMA
    loads)."""
    from repro_torch.kernels import build
    if build.cuobjdump_path() is None:
        pytest.skip("cuobjdump is not in the CUDA toolkit")
    counts = build.sass_counts("flash_attention_sm90", ("HGMMA", "UTMALDG"))
    assert counts["HGMMA"] > 0 and counts["UTMALDG"] > 0, counts
