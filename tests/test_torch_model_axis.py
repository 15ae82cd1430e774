"""The model axis's static half and its slice-level pieces (DESIGN.md §9),
against the JAX package, with no process group.

* Statics: ``sharded_wire_spec`` (caps, nbytes, model dims),
  ``per_device_payload_nbytes`` and ``shard_cap`` on the reference's
  ``WIRE_SHAPES`` tree (``tests/test_big_model_mesh.py``) and a reduced
  qwen2-0.5b tree at m = 1, 2, 4, 8, and ``check_sharded_supported``'s
  rejections, against the reference's functions on the same shapes.
* Slices: the summed-count radix walk over m slices, emulated in one
  process (each slice a row, the reduction a sum over a client's rows),
  bit-equal to JAX's ``ref.topk_threshold_bits`` on the whole vector, ties
  included; each slice's slots and values equal to JAX's
  ``support_slots`` on that slice (also past the slice's cap); K7's keyed
  entry through ``ops.quantize_pack_global_norm`` bit-equal to JAX's
  ``ref.quantize_pack_with_uniforms`` of the slice under
  ``jax.random.fold_in(key, j)``'s uniforms and JAX's norm; and
  ``decode_shard_local`` equal to JAX's on the same buffers.
* Placements: ``param_shardings`` (``torch.distributed.tensor``
  placements) shards over ``model`` exactly the dimension
  ``model_dim_index`` names, on every leaf of every config at m = 1 and 8,
  with the reference's ``param_spec`` / ``_sanitize`` as the oracle (the
  reference's parameter shapes, a stand-in mesh); ``batch_spec``,
  ``cache_spec`` and ``state_sharding`` against the reference's specs.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # xdist workers share the cores: no spinning OpenMP pools

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.compress import Compose as JCompose  # noqa: E402
from repro.compress import Identity as JIdentity  # noqa: E402
from repro.compress import Int8Sync as JInt8Sync  # noqa: E402
from repro.compress import QuantQr as JQuantQr  # noqa: E402
from repro.compress import TopK as JTopK  # noqa: E402
from repro.compress import wire as jwire  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.sharding import specs as jspecs  # noqa: E402
from repro_torch import configs, prng  # noqa: E402
from repro_torch import tree as tree_util  # noqa: E402
from repro_torch.compress import (  # noqa: E402
    Compose, Identity, Int8Sync, QuantQr, TopK, wire)
from repro_torch.core.distributed import validate_model_axis  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import topk_compress as tk  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.sharding import specs  # noqa: E402
from tests.test_big_model_mesh import WIRE_SHAPES  # noqa: E402

COMPS = {"topk10": (TopK(0.1), JTopK(0.1)), "topk40": (TopK(0.4), JTopK(0.4)),
         "qr4": (QuantQr(4), JQuantQr(4)), "dense": (Identity(), JIdentity())}
SHARDS = (1, 2, 4, 8)


def _is_shape(x):
    return isinstance(x, tuple) and all(isinstance(d, int) for d in x)


def _wire_tree():
    """WIRE_SHAPES as float32 meta tensors (the port) and
    ShapeDtypeStructs (the reference)."""
    port = tree_util.map(lambda s: torch.empty(s.shape, device="meta"),
                         _shape_dict(WIRE_SHAPES))
    return port, _jax_tree(port)


def _shape_dict(tree):
    if _is_shape(tree):
        return _Shape(tree)
    return {k: _shape_dict(v) for k, v in tree.items()}


class _Shape:
    """A shape as a tree leaf (the port's trees treat tuples as nodes)."""

    def __init__(self, shape):
        self.shape = shape


def _jax_tree(port_tree):
    def one(t):
        return jax.ShapeDtypeStruct(tuple(t.shape), jnp.dtype(
            str(t.dtype).replace("torch.", "")))
    return tree_util.map(one, port_tree)


def _qwen_tree():
    spec = configs.reduced(configs.get_spec("qwen2-0.5b"))
    port = tree_util.map(
        lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"),
        steps._params_struct(spec))
    return port, _jax_tree(port)


TREES = {"wire_shapes": _wire_tree, "qwen2-0.5b reduced": _qwen_tree}


def _mdims(port_tree, m):
    return tuple(specs.model_dim_index(path, tuple(leaf.shape), m)
                 for path, leaf in tree_util.leaves_with_paths(port_tree))


def _jmdims(port_tree, m):
    return tuple(jspecs.model_dim_index(specs.path_str(path),
                                        tuple(leaf.shape), m)
                 for path, leaf in tree_util.leaves_with_paths(port_tree))


# --------------------------------------------------------------------------- #
# statics
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("m", SHARDS)
@pytest.mark.parametrize("comp", list(COMPS))
@pytest.mark.parametrize("tree", list(TREES))
def test_sharded_wire_spec_matches_reference(tree, comp, m):
    port_tree, jax_tree = TREES[tree]()
    pcomp, jcomp = COMPS[comp]
    mdims = _mdims(port_tree, m)
    assert mdims == _jmdims(port_tree, m)
    if m > 1:
        assert any(d is not None for d in mdims)
    spec = wire.sharded_wire_spec(pcomp, port_tree, mdims, m)
    jspec = jwire.sharded_wire_spec(jcomp, jax_tree, mdims, m)
    assert (spec.codec, spec.caps, spec.r, spec.nbytes, spec.model_shards,
            spec.model_dims) == (jspec.codec, jspec.caps, jspec.r,
                                 jspec.nbytes, jspec.model_shards,
                                 jspec.model_dims)
    assert spec.shapes == jspec.shapes
    assert wire.per_device_payload_nbytes(spec) == \
        jwire.per_device_payload_nbytes(jspec)
    assert wire._local_sizes(spec) == jwire._local_sizes(jspec)
    for shp, mdim in zip(spec.shapes, spec.model_dims):
        assert wire._local_shape(shp, mdim, m) == \
            tuple(jwire._local_shape(shp, mdim, m))
    if m == 1:
        assert wire.per_device_payload_nbytes(spec) == spec.nbytes


@pytest.mark.parametrize("k", [1, 5, 64, 1000, 4096, 19_611_853])
def test_shard_cap_matches_reference(k):
    for m in (1, 2, 4, 8, 16):
        for n_local in (7, 10 ** 6, 10 ** 9):
            cap = wire.shard_cap(k, m, n_local)
            assert cap == jwire.shard_cap(k, m, n_local)
            assert cap <= n_local
            if n_local >= k:
                assert m * cap >= k


REJECTED = {"compose": (Compose(TopK(0.25), QuantQr(4)),
                        JCompose(JTopK(0.25), JQuantQr(4))),
            "int8": (Int8Sync(), JInt8Sync()),
            "topk-global": (TopK(0.3, scope="global"),
                            JTopK(0.3, scope="global")),
            "qr-global": (QuantQr(4, scope="global"),
                          JQuantQr(4, scope="global"))}


@pytest.mark.parametrize("comp", list(REJECTED))
def test_sharded_codec_rejections(comp):
    pcomp, jcomp = REJECTED[comp]
    with pytest.raises(ValueError) as got:
        wire.check_sharded_supported(pcomp, 2)
    with pytest.raises(ValueError) as want:
        jwire.check_sharded_supported(jcomp, 2)
    assert str(got.value) == str(want.value)
    # fine off the model axis
    assert wire.check_sharded_supported(pcomp, 1) == \
        jwire.check_sharded_supported(jcomp, 1)


def test_sharded_codec_accepts():
    for name, (pcomp, jcomp) in COMPS.items():
        assert wire.check_sharded_supported(pcomp, 4) == \
            jwire.check_sharded_supported(jcomp, 4)


def test_unsharded_specs_keep_their_fields():
    payload, _ = wire.encode(TopK(0.1), {"w": torch.ones(2, 100)})
    assert payload.spec.model_shards == 1 and payload.spec.model_dims == ()


# --------------------------------------------------------------------------- #
# slices, emulated in one process
# --------------------------------------------------------------------------- #

N, CLIENTS = 4096, 2
KS = (1, 409, 2048, 4095)


def _vectors(case: str) -> np.ndarray:
    rng = np.random.default_rng({"gauss": 0, "ties": 1, "zeros": 2}[case])
    x = rng.standard_normal((CLIENTS, N)).astype(np.float32)
    if case == "ties":          # a quarter of each row at one magnitude
        x[:, ::4] = np.where(x[:, ::4] > 0, 0.5, -0.5)
    elif case == "zeros":       # zeros (and -0.0), and ties at 1.0
        x[:, : N // 2] = 0.0
        x[:, 1: N // 2: 3] = -0.0
        x[:, N // 2:: 5] = 1.0
    return x


def _slices(x: np.ndarray, m: int) -> torch.Tensor:
    """(clients, n) -> (clients * m, n / m): client c's slice j is row
    c * m + j."""
    return torch.from_numpy(x.reshape(CLIENTS * m, N // m).copy())


def _summed(m: int):
    """The model group's reduction, emulated: each run of m rows (one
    client's slices of one leaf) summed and given to all of them."""
    def reduce(h):
        s = h.reshape(-1, m, h.shape[-1]).sum(1, keepdim=True)
        return s.expand(-1, m, h.shape[-1]).reshape(h.shape)
    return reduce


@pytest.fixture(scope="module")
def jax_threshold():
    return jax.jit(jref.topk_threshold_bits)


@pytest.mark.parametrize("case", ["gauss", "ties", "zeros"])
@pytest.mark.parametrize("m", [2, 4, 8])
def test_summed_count_walk_matches_whole_vector(jax_threshold, m, case):
    x = _vectors(case)
    rows = _slices(x, m)
    for k in KS:
        want = [int(jax_threshold(jnp.asarray(x[c]), k))
                for c in range(CLIENTS)]
        # the walk alone, and beside another leaf in the same reductions
        other = _slices(_vectors("gauss")[:, ::-1].copy(), m)
        for got in (ref.topk_threshold_bits(rows, k, n_total=N,
                                            reduce=_summed(m)),
                    tk.threshold_bits_sharded([rows], [k], [N],
                                              _summed(m))[0],
                    tk.threshold_bits_sharded([other, rows], [409, k],
                                              [N, N], _summed(m))[1]):
            assert got.tolist() == [w for w in want for _ in range(m)], k


slots = jax.jit(jref.support_slots, static_argnums=1)


@pytest.mark.parametrize("case", ["gauss", "ties", "zeros"])
@pytest.mark.parametrize("m", [2, 4])
def test_shard_slots_match_support_slots(jax_threshold, m, case):
    """Each slice's slots and values at the whole vector's threshold are
    JAX's ``support_slots`` of the slice, at the per-shard cap and at a
    cap the slice's support overflows (the lowest-index ``cap`` kept);
    the slice's count is its whole support."""
    x = _vectors(case)
    rows = _slices(x, m)
    k = TopK(0.1)._k(N)

    @jax.jit
    def support(sl, t):
        bits = jref._mag_bits(sl)
        return (bits >= t) & (bits != 0)

    for cap in (wire.shard_cap(k, m, N // m), 16):
        idx, vals, nnz = ops.topk_slots_sharded([rows], [k], [cap], [N],
                                                _summed(m))[0]
        ridx, rvals, rnnz = ref.topk_slots_sharded(rows, k, cap, N,
                                                   _summed(m))
        assert torch.equal(idx, ridx) and torch.equal(vals, rvals)
        assert torch.equal(nnz, rnnz)
        for c in range(CLIENTS):
            t = jax_threshold(jnp.asarray(x[c]), k)
            for j in range(m):
                sl = jnp.asarray(rows[c * m + j].numpy())
                sup = support(sl, t)
                want = np.asarray(slots(sup, cap))
                np.testing.assert_array_equal(idx[c * m + j].numpy(), want)
                safe = np.clip(want, 0, N // m - 1)
                wv = np.where(want < N // m, np.asarray(sl)[safe], 0.0)
                np.testing.assert_array_equal(vals[c * m + j].numpy(), wv)
                assert int(nnz[c * m + j]) == int(sup.sum())


@pytest.mark.parametrize("r", [1, 4, 8])
@pytest.mark.parametrize("m", [2, 4])
def test_global_norm_pack_matches_reference(m, r):
    """K7's keyed entry (its plain version here) on each slice, keyed by
    the client key folded with the slice's rank and packed against the
    whole vector's norm: JAX's pack of the slice under
    ``jax.random.uniform(jax.random.fold_in(key, j), ...)``."""
    x = _vectors("gauss")
    rows = _slices(x, m)
    jkeys = jax.random.split(jax.random.PRNGKey(11), CLIENTS)
    keys = torch.from_numpy(np.asarray(jkeys).astype(np.int64))
    pack = jax.jit(jref.quantize_pack_with_uniforms, static_argnums=1)
    norms = []
    want = []
    for c in range(CLIENTS):
        xf = jnp.asarray(x[c])
        norm = jnp.sqrt(jnp.sum(xf * xf))
        norms += [float(norm)] * m
        for j in range(m):
            sl = jnp.asarray(rows[c * m + j].numpy())
            u = jax.random.uniform(jax.random.fold_in(jkeys[c], j), sl.shape,
                                   dtype=jnp.float32)
            want.append(np.asarray(pack(sl, r, u, norm)).view(np.int32))
    folded = torch.stack([prng.fold_in(keys[c], j) for c in range(CLIENTS)
                          for j in range(m)])
    got = ops.quantize_pack_global_norm(rows, r, folded,
                                        torch.tensor(norms))
    np.testing.assert_array_equal(got.numpy(), np.stack(want))
    # the summed squares' root: the whole vector's norm (another order)
    ss = _summed(m)(ops.sum_squares(rows)[:, None])[:, 0]
    np.testing.assert_allclose(torch.sqrt(ss).numpy(), norms, rtol=1e-6)


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("comp", ["topk10", "qr4", "dense"])
def test_decode_shard_local_matches_reference(comp, m):
    """Buffers of one shard (random, valid: distinct slot indices with
    sentinels, any words and norms) decoded by the port and, client by
    client, by JAX's ``wire.decode_shard_local``."""
    rng = np.random.default_rng(3)
    port_tree, jax_tree = _wire_tree()
    pcomp, jcomp = COMPS[comp]
    mdims = _mdims(port_tree, m)
    spec = wire.sharded_wire_spec(pcomp, port_tree, mdims, m)
    jspec = jwire.sharded_wire_spec(jcomp, jax_tree, mdims, m)
    data = []
    for i, n in enumerate(wire._local_sizes(spec)):
        if spec.codec == "topk":
            cap = spec.caps[i]
            idx = np.stack([np.sort(rng.choice(n + cap, cap, replace=False))
                            for _ in range(CLIENTS)])
            idx = np.minimum(idx, n).astype(np.int32)   # some sentinels
            vals = rng.standard_normal((CLIENTS, cap)).astype(np.float32)
            data.append((idx, vals))
        elif spec.codec == "qr":
            words = rng.integers(-2 ** 31, 2 ** 31, (CLIENTS, -(-n // 32) * 5),
                                 dtype=np.int64).astype(np.int32)
            data.append((words, rng.random(CLIENTS).astype(np.float32)))
        else:
            data.append((rng.standard_normal((CLIENTS, n)).astype(
                np.float32),))
    got = wire.decode_shard_local(
        tuple(tuple(torch.from_numpy(b) for b in u) for u in data), spec)
    # the reference's uint32 index and word buffers, client by client
    jdata = tuple(tuple(jnp.asarray(b.view(np.uint32) if b.dtype == np.int32
                                    else b) for b in u) for u in data)
    want = jax.tree_util.tree_leaves(jax.jit(jax.vmap(
        lambda d: jwire.decode_shard_local(d, jspec)))(jdata))
    for a, b in zip(tree_util.leaves(got), want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# --------------------------------------------------------------------------- #
# placements
# --------------------------------------------------------------------------- #

class _Mesh:
    """A stand-in ``("data", "model")`` mesh for both packages' rules."""

    def __init__(self, m, data=1):
        self.mesh_dim_names = self.axis_names = ("data", "model")
        self.shape = {"data": data, "model": m}

    # the port reads ``shape`` in the names' order
    @property
    def port(self):
        mesh = _Mesh(self.shape["model"], self.shape["data"])
        mesh.shape = (self.shape["data"], self.shape["model"])
        return mesh


_STRUCTS: dict = {}


def _at(tree, path):
    """The placements at ``path`` (each leaf's is a tuple, which the
    port's tree functions would walk into)."""
    for k in path:
        tree = tree[k]
    return tree


def _struct(arch):
    if arch not in _STRUCTS:
        _STRUCTS[arch] = jsteps._params_struct(jconfigs.get_spec(arch))
    return _STRUCTS[arch]


@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_param_shardings_agree_with_wire_rules(arch, m):
    """The placements shard over ``model`` exactly the dimension
    ``model_dim_index`` names, and the reference's ``param_spec`` after
    ``_sanitize`` names it too; a dimension ``_sanitize`` drops makes
    ``validate_model_axis`` raise."""
    struct = _struct(arch)
    jspec = jconfigs.get_spec(arch)
    n_exp = jsteps._n_experts(jspec)
    mesh = _Mesh(m)
    shardings = specs.param_shardings(struct, mesh.port, n_experts=n_exp)
    eom = bool(n_exp) and n_exp % m == 0
    try:
        validate_model_axis(mesh.port, configs.get_spec(arch))
        valid = True
    except ValueError:
        valid = False
    dropped = []
    for path, leaf in tree_util.leaves_with_paths(struct):
        pl = _at(shardings, path)
        assert len(pl) == 2
        placed = [pl[1].dim] if pl[1].is_shard() else []
        p = specs.path_str(path)
        mdi = specs.model_dim_index(path, tuple(leaf.shape), m,
                                    expert_over_model=eom)
        assert placed == ([] if mdi is None else [mdi]), (p, pl, mdi)
        want = jspecs._sanitize(jspecs.param_spec(p, leaf.shape, mesh, eom),
                                leaf.shape, mesh)
        assert placed == [i for i, e in enumerate(want) if e == "model"], p
        assert pl == specs.placements(tuple(want), mesh.port), p
        rule = jspecs.param_spec(p, leaf.shape, mesh, eom)
        if any(e == "model" for e in rule) and not placed:
            dropped.append(p)
    if valid:
        assert not dropped, dropped
    elif m > 1:
        assert dropped


def test_batch_and_cache_specs_match_reference():
    mesh = _Mesh(4, data=2)
    assert specs.batch_spec(mesh.port) == specs.placements(
        tuple(jspecs.batch_spec(mesh)), mesh.port) == (Shard(0), Replicate())
    assert specs.cache_spec(mesh.port, 2, 64) == specs.placements(
        tuple(jspecs.cache_spec(mesh, 2, 64)), mesh.port) == (Shard(0),
                                                              Shard(2))


def test_state_sharding():
    """The reference's rules (``state_sharding``) on a decode state: the
    long KV cache's length over ``model``, a short one whole, batch over
    ``data`` where it divides, the length scalar replicated."""
    mesh = _Mesh(4, data=2).port

    def t(*shape):
        return torch.empty(shape, device="meta")

    state = {"caches": {"layer_0": {"k": t(4, 2, 64, 16), "v": t(4, 2, 8, 16)},
                        "layer_1": {"s": t(4, 2, 8, 8), "conv": t(3, 5)}},
             "length": t()}
    got = specs.state_sharding(state, mesh)
    assert got["caches"]["layer_0"]["k"] == (Shard(0), Shard(2))
    assert got["caches"]["layer_0"]["v"] == (Shard(0), Replicate())
    assert got["caches"]["layer_1"]["s"] == (Shard(0), Replicate())
    assert got["caches"]["layer_1"]["conv"] == (Replicate(), Replicate())
    assert got["length"] == (Replicate(), Replicate())


def test_validate_model_axis_matches_reference():
    for arch in ("qwen2-0.5b", "seamless-m4t-large-v2"):
        for m in (1, 2, 4, 8):
            try:
                want = jspecs_validate(arch, m)
            except ValueError as e:
                with pytest.raises(ValueError) as got:
                    validate_model_axis(_Mesh(m).port, configs.get_spec(arch))
                assert str(got.value) == str(e)
            else:
                assert validate_model_axis(_Mesh(m).port,
                                           configs.get_spec(arch)) == want


def jspecs_validate(arch, m):
    from repro.core.distributed import validate_model_axis as jvalidate

    class Mesh:
        axis_names = ("clients", "data", "model")
        shape = {"clients": 1, "data": 1, "model": m}

    return jvalidate(Mesh(), jconfigs.get_spec(arch))


def test_dataclass_fields():
    fields = {f.name: f.default for f in dataclasses.fields(wire.WireSpec)}
    assert fields["model_shards"] == 1 and fields["model_dims"] == ()
