"""The model axis over ranks (DESIGN.md §9): ``ModelShardCtx``'s
shard-local wire and a composed clients x model round, on the CPU under
gloo, against the port's unsharded wire and rounds and the JAX package's
unsharded wire and rounds.

One spawn of 4 gloo ranks (a ``FileStore`` under ``tmp_path``, joined
with a timeout, as ``tests/test_torch_distributed.py`` does) builds the
meshes (clients, data, model) = (1, 1, 2) on ranks 0-1, (2, 1, 2) and
(1, 1, 4) on all four, (2, 2, 1) on all four and the flat ``(2,)`` on
ranks 0-1, and runs on them: ``encode_payload`` -> ``gather_decoded_
payload`` and ``encode_broadcast`` -> ``decode_broadcast`` of the
reference's ``WIRE_SHAPES`` tree (``tests/test_big_model_mesh.py``,
tie-free magnitudes) under TopK(0.1), TopK(0.4), dense and Q_r(4); a
masked client; a leaf whose whole support falls in one shard (that shard
overflows its cap); 2 rounds of FedAvg TopK(0.1) packed on the
reference's ``TINY`` transformer on (2, 1, 2), (2, 2, 1) and the flat
(2,); and the mesh checks.  The ranks pickle what they get for this
process, which holds it to:

* the port's unsharded ``wire.encode``/``decode`` and JAX's
  ``jax.vmap(wire.encode)``/``decode``, bit for bit, for topk and dense
  (decoded trees and ``BitsReport``), up- and downlink;
* for qr, the bits exactly and each leaf's error within 1.5x the
  unsharded error (the dither of a sharded leaf comes from a folded key);
* the overflowing shard's slots equal to JAX's ``support_slots`` of its
  slice at its cap, the bits unchanged;
* the composed TINY round's bits equal to the flat round's, and its state
  bit-equal where the round reports no tie beyond k and no overflow
  (else ``train_loss`` within rtol 2e-3 and the bits within rtol 1e-4,
  the reference's tolerances); the flat round within the flat-round
  tolerances of JAX's unsharded round (``tests/test_torch_distributed_
  ref.py``: bits exact, ``train_loss`` rtol 2e-4 / atol 1e-6, the state
  within atol 1e-5).
"""

import os
import pickle
import time
import traceback

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # xdist workers share the cores: no spinning OpenMP pools

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.compress import Identity as JIdentity  # noqa: E402
from repro.compress import QuantQr as JQuantQr  # noqa: E402
from repro.compress import TopK as JTopK  # noqa: E402
from repro.compress import wire as jwire  # noqa: E402
from repro.core import fed_data as jfed_data  # noqa: E402
from repro.core.baselines import FedAvg as JFedAvg  # noqa: E402
from repro.core.baselines import FedConfig as JFedConfig  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch import tree as tree_util  # noqa: E402
from repro_torch.compress import Identity, QuantQr, TopK, wire  # noqa: E402
from repro_torch.core import fed_data  # noqa: E402
from repro_torch.core.baselines import FedAvg, FedConfig  # noqa: E402
from repro_torch.core.clients import RoundPlan  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from tests import test_big_model_mesh as jmesh  # noqa: E402

C = jmesh.C
JOIN_TIMEOUT_S = 120.0
COMPS = {"topk10": (TopK(0.1), JTopK(0.1)), "topk40": (TopK(0.4), JTopK(0.4)),
         "dense": (Identity(), JIdentity()), "qr4": (QuantQr(4), JQuantQr(4))}
#: (clients, data, model) -> the ranks that hold it
MESHES = {(1, 1, 2): (0, 1), (2, 1, 2): (0, 1, 2, 3), (1, 1, 4): (0, 1, 2, 3),
          (2, 2, 1): (0, 1, 2, 3)}
MODEL_MESHES = [(1, 1, 2), (2, 1, 2), (1, 1, 4)]
FLAT = (2,)
#: the reference's TINY (``tests/test_big_model_mesh.py``) in the port
TINY = tfm.ModelConfig(name="tiny", n_layers=1, d_model=32, n_heads=2,
                       n_kv_heads=2, head_dim=16, d_ff=64, vocab=64,
                       qkv_bias=True)
PER, SEQ, ROUNDS = 4, 8, 2
FED = dict(gamma=0.05, local_steps=2, n_clients=4, clients_per_round=4,
           batch_size=2)
#: the forced overflow: (64, 16) embedding, model dim 0; at m = 2 every
#: survivor of TopK(0.4) lies in shard 0's 32 rows
OVERFLOW_SHAPE = (64, 16)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def tiny_data():
    rng = np.random.default_rng(0)
    x = rng.integers(0, TINY.vocab, (C * PER, SEQ)).astype(np.int32)
    y = np.zeros((C * PER,), np.float32)
    parts = [np.arange(i * PER, (i + 1) * PER) for i in range(C)]
    return x, y, parts


def tiny_loss(params, xb, yb):
    """Each stacked client's ``transformer.loss`` on its own rows."""
    return torch.stack([
        tfm.loss(tree_util.map(lambda t: t[i], params), TINY, xb[i],
                 loss_chunk=SEQ)
        for i in range(xb.shape[0])])


def overflow_tree():
    """The 512 largest magnitudes in the first 32 rows (shard 0 at m = 2),
    the same leaf for every client."""
    rng = np.random.default_rng(7)
    half = int(np.prod(OVERFLOW_SHAPE)) // 2
    x = np.concatenate([rng.permutation(half) + half + 1.0,
                        rng.permutation(half) + 1.0]).astype(np.float32)
    return {"embed": {"embedding": np.stack([x.reshape(OVERFLOW_SHAPE)] * C)}}


# --------------------------------------------------------------------------- #
# the ranks
# --------------------------------------------------------------------------- #

def _t(tree):
    return tree_util.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _plan():
    return RoundPlan(steps=torch.ones(C, dtype=torch.int32),
                     participating=torch.ones(C, dtype=torch.bool),
                     speed=torch.ones(C), bandwidth=torch.ones(C),
                     comp_overrides={})


def _report(ctx, rep):
    return {f: ctx.all_clients(getattr(rep, f)).numpy()
            for f in ("value_bits", "index_bits", "meta_bits")}


def _leaves_np(tree):
    return [t.detach().numpy().copy() for t in tree_util.leaves(tree)]


def _roundtrips(ctx, inputs) -> dict:
    stacked, keys = _t(inputs["stacked"]), torch.from_numpy(inputs["keys"])
    out = {}
    for name, (comp, _) in COMPS.items():
        payload, rep = ctx.encode_payload(comp, ctx.shard_tree(_plan()),
                                          ctx.shard_tree(stacked),
                                          ctx.shard(keys))
        dec = ctx.gather_decoded_payload(payload, torch.ones(C))
        out[name] = {"dec": _leaves_np(dec), "report": _report(ctx, rep),
                     "nbytes": payload.nbytes,
                     "device_nbytes": wire._buffers_nbytes(payload.data),
                     "per_device": wire.per_device_payload_nbytes(
                         payload.spec)}
        one = tree_util.map(lambda t: t[0], stacked)
        pb, rb = ctx.encode_broadcast(comp, one, keys[0])
        out[name]["bcast"] = (_leaves_np(ctx.decode_broadcast(pb)),
                              float(rb.total_bits[0]))
    masked = _t(inputs["masked"])
    payload, _ = ctx.encode_payload(TopK(0.2), ctx.shard_tree(_plan()),
                                    ctx.shard_tree(masked))
    out["masked"] = _leaves_np(ctx.gather_decoded_payload(
        payload, torch.tensor([1.0, 0.0, 1.0, 1.0])))
    return out


def _overflow(ctx, inputs) -> dict:
    tree = _t(inputs["overflow"])
    payload, rep = ctx.encode_payload(TopK(0.4), ctx.shard_tree(_plan()),
                                      ctx.shard_tree(tree))
    idx, vals = payload.data[0]
    return {"idx": idx.numpy().copy(), "vals": vals.numpy().copy(),
            "cap": payload.spec.caps[0], "report": _report(ctx, rep),
            "dec": _leaves_np(ctx.gather_decoded_payload(payload,
                                                         torch.ones(C)))}


def _tiny_round(mesh, inputs) -> dict:
    x, y, parts = inputs["tiny_data"]
    data = fed_data.from_numpy_partition(x, y, parts, device="cpu")
    alg = FedAvg(tiny_loss, data, FedConfig(**FED), TopK(0.1), wire="packed")
    alg.use_mesh(mesh)
    ctx = alg._sharded.ctx
    ctx.record = [] if hasattr(ctx, "model_shards") else None
    state, metrics = alg.run_rounds(alg.init(_t(inputs["tiny_params"])),
                                    prng.PRNGKey(3), ROUNDS)
    ties = overflow = 0
    for rec in ctx.record or ():
        spec, counts = rec["spec"], rec["counts"]
        for i, mdim in enumerate(spec.model_dims):
            if mdim is None:
                continue
            k = TopK(0.1)._k(int(np.prod(spec.shapes[i])))
            ties += int(torch.clamp(counts["nnz"][:, i] - k, min=0).sum())
            overflow += int(torch.clamp(
                counts["nnz_local"][:, i] - spec.caps[i], min=0).sum())
    nbytes = ctx.record[-1]["spec"].nbytes if ctx.record else None
    return {"state": _leaves_np(state.x), "ties": ties, "overflow": overflow,
            "nbytes": nbytes,
            "metrics": {k: np.asarray(v) for k, v in metrics.items()}}


def _checks(rank, meshes, inputs) -> dict:
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.core import distributed
    from repro_torch.launch import mesh as mesh_mod
    out = {}

    def check(name, fn):
        try:
            fn()
            out[name] = None
        except Exception:           # recorded for the parent's assert
            out[name] = traceback.format_exc()

    def raises(fn, exc, match):
        try:
            fn()
        except exc as e:
            if match not in str(e):
                raise AssertionError(f"{e!r} does not say {match!r}")
            return
        raise AssertionError(f"no {exc.__name__}")

    def make_client_mesh_checks_config():
        qwen = configs.get_spec("qwen2-0.5b")
        seamless = configs.get_spec("seamless-m4t-large-v2")
        raises(lambda: mesh_mod.make_client_mesh(
            model=4, config=seamless, device="cpu"), ValueError, "vocab")
        import dataclasses
        bad = dataclasses.replace(qwen, model=dataclasses.replace(
            qwen.model, vocab=151_935))
        raises(lambda: mesh_mod.make_client_mesh(
            1, model=2, config=bad, device="cpu"), ValueError, "vocab")
        m = mesh_mod.make_client_mesh(model=2, config=qwen, device="cpu")
        assert m.mesh_dim_names == ("clients", "data", "model")
        assert tuple(m.shape) == (2, 1, 2)
        # clients outermost, row-major: the model group is the rank pair
        assert dist.get_process_group_ranks(m.get_group("model")) == \
            [rank - rank % 2, rank - rank % 2 + 1]
        assert dist.get_process_group_ranks(m.get_group("clients")) == \
            [rank % 2, rank % 2 + 2]
        raises(lambda: mesh_mod.make_client_mesh(3, model=2, device="cpu"),
               ValueError, "world size")

    def contexts():
        m22 = meshes[(2, 1, 2)]
        ctx = distributed.client_ctx(m22, C)
        assert isinstance(ctx, distributed.ModelShardCtx)
        assert (ctx.n_shards, ctx.model_shards) == (2, 2)
        assert ctx.model_rank == rank % 2
        assert isinstance(distributed.shard_round(
            lambda st, k, ctx: (st, {}), m22, C).ctx, distributed.ModelShardCtx)
        ctx221 = distributed.client_ctx(meshes[(2, 2, 1)], C)
        assert ctx221.model_shards == 1
        raises(lambda: distributed.client_ctx(m22, 3), ValueError, "divide")

    def overrides_rejected():
        ctx = distributed.client_ctx(meshes[(2, 1, 2)], C)
        plan = _plan()._replace(comp_overrides={"density": torch.ones(2)})
        raises(lambda: ctx.encode_payload(TopK(0.1), plan, ctx.shard_tree(
            _t(inputs["stacked"]))), ValueError, "overrides")

    for fn in (make_client_mesh_checks_config, contexts, overrides_rejected):
        check(fn.__name__, fn)
    return out


def _rank_main(rank, world, store_path, out_dir):
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.core.distributed import ModelShardCtx

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        with open(os.path.join(out_dir, "inputs.pkl"), "rb") as f:
            inputs = pickle.load(f)     # written by the parent just before

        def mesh(ranks, shape, names):
            # every rank makes every mesh, in the same order
            return DeviceMesh("cpu", torch.tensor(ranks).view(shape),
                              mesh_dim_names=names)

        names3 = ("clients", "data", "model")
        meshes = {shape: mesh(list(ranks), shape, names3)
                  for shape, ranks in MESHES.items()}
        meshes[FLAT] = mesh([0, 1], FLAT, ("clients",))
        results = {}
        for shape in MODEL_MESHES:
            if rank in MESHES[shape]:
                ctx = ModelShardCtx(meshes[shape])
                results[("wire", shape)] = _roundtrips(ctx, inputs)
        if rank in MESHES[(1, 1, 2)]:
            results["overflow"] = _overflow(ModelShardCtx(meshes[(1, 1, 2)]),
                                            inputs)
        for shape in ((2, 1, 2), (2, 2, 1), FLAT):
            if rank in MESHES.get(shape, (0, 1)):
                results[("tiny", shape)] = _tiny_round(meshes[shape], inputs)
        results["checks"] = _checks(rank, meshes, inputs)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
    finally:
        dist.destroy_process_group()


def _spawn(tmp: str, inputs: dict, world: int = 4) -> dict:
    import torch.multiprocessing as mp
    with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    ctx = mp.start_processes(_rank_main, args=(world, os.path.join(tmp, "store"),
                                               tmp),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise AssertionError(
                    f"the {world} ranks did not finish in {JOIN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    out = {}
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            out[r] = pickle.load(f)   # written by the ranks just above
    return out


@pytest.fixture(scope="module")
def inputs():
    keys = jax.random.split(jax.random.PRNGKey(5), C)
    x, y, parts = tiny_data()
    params = jtfm.init_params(jax.random.PRNGKey(0), jmesh.TINY)
    return {"stacked": _np_tree(jmesh.tie_free_stacked(seed=3)),
            "masked": _np_tree(jmesh.tie_free_stacked(seed=1)),
            "overflow": overflow_tree(),
            "keys": np.asarray(keys).astype(np.int64),
            "tiny_data": (x, y, parts), "tiny_params": _np_tree(params)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, inputs):
    return _spawn(str(tmp_path_factory.mktemp("ranks")), inputs)


@pytest.fixture(scope="module")
def unsharded(inputs):
    """``{comp: (port decode leaves, port report, JAX decode leaves, JAX
    report, JAX broadcast decode, JAX broadcast bits)}`` on the same
    stacked tree and keys."""
    stacked = _t(inputs["stacked"])
    keys = torch.from_numpy(inputs["keys"])
    jstacked = jax.tree_util.tree_map(jnp.asarray, inputs["stacked"])
    jkeys = jnp.asarray(inputs["keys"], jnp.uint32)
    out = {}
    for name, (comp, jcomp) in COMPS.items():
        payload, rep = wire.encode(comp, stacked, keys)

        @jax.jit
        def roundtrip(t, k, c=jcomp):
            pay, rep = jax.vmap(lambda a, b: jwire.encode(c, a, b))(t, k)
            return jax.vmap(jwire.decode)(pay), rep

        jdec, jrep = roundtrip(jstacked, jkeys)
        b_pay, b_rep = wire.encode(comp, tree_util.map(lambda t: t[:1],
                                                       stacked), keys[:1])
        out[name] = {
            "dec": _leaves_np(wire.decode(payload)),
            "report": {f: getattr(rep, f).numpy()
                       for f in ("value_bits", "index_bits", "meta_bits")},
            "jdec": [np.asarray(a) for a in jax.tree_util.tree_leaves(jdec)],
            "jreport": {f: np.asarray(getattr(jrep, f), np.float32)
                        for f in ("value_bits", "index_bits", "meta_bits")},
            "bcast": ([a[0] for a in _leaves_np(wire.decode(b_pay))],
                      float(b_rep.total_bits[0])),
            "nbytes": payload.nbytes}
    return out


# --------------------------------------------------------------------------- #
# the shard-local wire against the unsharded wires
# --------------------------------------------------------------------------- #

def _owners(shape):
    return MESHES[shape]


@pytest.mark.parametrize("shape", MODEL_MESHES)
@pytest.mark.parametrize("name", ["topk10", "topk40", "dense"])
def test_roundtrip_bit_equal_to_both_unsharded_wires(ranks, unsharded, name,
                                                     shape):
    want = unsharded[name]
    for r in _owners(shape):
        got = ranks[r][("wire", shape)][name]
        for a, b, c in zip(got["dec"], want["dec"], want["jdec"]):
            np.testing.assert_array_equal(a, b, err_msg=f"{shape} rank {r}")
            np.testing.assert_array_equal(a, c, err_msg=f"{shape} rank {r}")
        for f, v in got["report"].items():
            np.testing.assert_array_equal(v, want["report"][f], err_msg=f)
            np.testing.assert_array_equal(v, want["jreport"][f], err_msg=f)


@pytest.mark.parametrize("shape", MODEL_MESHES)
@pytest.mark.parametrize("name", ["topk10", "topk40", "dense", "qr4"])
def test_broadcast_roundtrip(ranks, unsharded, inputs, name, shape):
    """The downlink: the one-row broadcast's decode bit-equal to the
    unsharded wire's (topk, dense) and JAX's, its bits exact; qr within
    1.5x the unsharded error."""
    want, want_bits = unsharded[name]["bcast"]
    jwant = [a[0] for a in unsharded[name]["jdec"]]
    x = [np.asarray(a)[0]
         for a in jax.tree_util.tree_leaves(inputs["stacked"])]
    for r in _owners(shape):
        got, bits = ranks[r][("wire", shape)][name]["bcast"]
        assert bits == want_bits
        for a, b, c, xx in zip(got, want, jwant, x):
            if name == "qr4":
                assert np.linalg.norm(xx - a) <= 1.5 * np.linalg.norm(
                    xx - b) + 1e-6
            else:
                np.testing.assert_array_equal(a, b)
                np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("shape", MODEL_MESHES)
def test_qr_bits_exact_and_error_comparable(ranks, unsharded, inputs, shape):
    want = unsharded["qr4"]
    x = [np.asarray(a) for a in jax.tree_util.tree_leaves(inputs["stacked"])]
    for r in _owners(shape):
        got = ranks[r][("wire", shape)]["qr4"]
        for f, v in got["report"].items():
            np.testing.assert_array_equal(v, want["report"][f], err_msg=f)
            np.testing.assert_array_equal(v, want["jreport"][f], err_msg=f)
        for xx, a, b in zip(x, got["dec"], want["dec"]):
            assert np.linalg.norm(xx - a) <= 1.5 * np.linalg.norm(xx - b) \
                + 1e-6


@pytest.mark.parametrize("shape", MODEL_MESHES)
@pytest.mark.parametrize("name", list(COMPS))
def test_bytes_per_device(ranks, name, shape):
    """Each rank's buffers a client are ``per_device_payload_nbytes``;
    ``m`` x the sharded part + the replicated part is ``nbytes``."""
    m = shape[2]
    for r in _owners(shape):
        got = ranks[r][("wire", shape)][name]
        assert got["device_nbytes"] == got["per_device"]
        overhang = m * got["per_device"] - got["nbytes"]   # (m - 1) x repl
        assert overhang >= 0 and overhang % (m - 1) == 0


@pytest.mark.parametrize("shape", MODEL_MESHES)
def test_masked_clients_decode_to_zero(ranks, inputs, shape):
    """A non-participant's buffers are zeroed before the gather: its rows
    decode to zero, the others' to the unsharded wire's decode."""
    payload, _ = wire.encode(TopK(0.2), _t(inputs["masked"]))
    want = _leaves_np(wire.decode(payload))
    for r in _owners(shape):
        got = ranks[r][("wire", shape)]["masked"]
        for leaf, w in zip(got, want):
            assert not leaf[1].any()
            np.testing.assert_array_equal(leaf[[0, 2, 3]], w[[0, 2, 3]])


def test_overflow_keeps_the_lowest_index_cap(ranks, inputs):
    """Every survivor of TopK(0.4) lies in shard 0's rows, past its cap:
    shard 0 keeps JAX's ``support_slots`` of its slice at the cap; the
    bits count the whole support, as the unsharded wire's do."""
    x = inputs["overflow"]["embed"]["embedding"]
    got = ranks[0]["overflow"]
    cap = got["cap"]
    n = x[0].size
    k = JTopK(0.4)._k(n)
    assert cap < k
    for c in range(C):
        xs = jnp.asarray(x[c].reshape(-1))
        t = jref.topk_threshold_bits(xs, k)
        half = jnp.asarray(x[c][:OVERFLOW_SHAPE[0] // 2].reshape(-1))
        bits = jref._mag_bits(half)
        support = (bits >= t) & (bits != 0)
        assert int(support.sum()) == k
        idx = np.asarray(jref.support_slots(support, cap))
        np.testing.assert_array_equal(got["idx"][c], idx)
        np.testing.assert_array_equal(got["vals"][c],
                                      np.asarray(half)[idx])
    _, rep = wire.encode(TopK(0.4), _t(inputs["overflow"]))
    for f, v in got["report"].items():
        np.testing.assert_array_equal(v, getattr(rep, f).numpy(), err_msg=f)
    # the decode holds the kept slots and nothing of shard 1
    dec = got["dec"][0].reshape(C, -1)
    assert (dec != 0).sum(axis=1).tolist() == [cap] * C


# --------------------------------------------------------------------------- #
# the composed round
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def jax_tiny(inputs):
    x, y, parts = inputs["tiny_data"]
    data = jfed_data.from_numpy_partition(x, y, parts)
    alg = JFedAvg(lambda p, xb, yb: jtfm.loss(p, jmesh.TINY, xb,
                                              loss_chunk=SEQ),
                  data, JFedConfig(**FED), JTopK(0.1), wire="packed")
    params = jax.tree_util.tree_map(jnp.asarray, inputs["tiny_params"])
    with jax.threefry_partitionable(True):
        st, m = alg.run_rounds(alg.init(params), jax.random.PRNGKey(3),
                               ROUNDS)
    return ([np.asarray(a) for a in jax.tree_util.tree_leaves(st.x)],
            {k: np.asarray(v) for k, v in m.items()})


def test_composed_round_against_the_flat_round(ranks):
    flat = ranks[0][("tiny", FLAT)]
    got = ranks[0][("tiny", (2, 1, 2))]
    for r in (1, 2, 3):     # every rank ends with the same state and metrics
        other = ranks[r][("tiny", (2, 1, 2))]
        for a, b in zip(other["state"], got["state"]):
            np.testing.assert_array_equal(a, b)
    # ties are counted on the whole support (model rank 0 of each clients
    # rank), overflows on each rank's own slice
    ties = sum(ranks[r][("tiny", (2, 1, 2))]["ties"] for r in (0, 2))
    overflow = sum(ranks[r][("tiny", (2, 1, 2))]["overflow"]
                   for r in range(4))
    assert set(got["metrics"]) == set(flat["metrics"])
    for k, v in flat["metrics"].items():
        if k != "train_loss" and "payload_bytes" not in k:
            np.testing.assert_array_equal(got["metrics"][k], v, err_msg=k)
    # the packed bytes are the sharded spec's (each shard's cap has slack)
    np.testing.assert_array_equal(got["metrics"]["uplink_payload_bytes"],
                                  np.float32(C * got["nbytes"]))
    assert (got["metrics"]["uplink_payload_bytes"] * 8
            >= got["metrics"]["uplink_bits"]).all()
    if ties == overflow == 0:
        # no tie beyond k and no overflow in any round: the same values
        case = "bit-equal"
        for a, b in zip(got["state"], flat["state"]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(got["metrics"]["train_loss"],
                                      flat["metrics"]["train_loss"])
    else:
        case = "ties or overflow"
        np.testing.assert_allclose(got["metrics"]["train_loss"],
                                   flat["metrics"]["train_loss"], rtol=2e-3)
        np.testing.assert_allclose(got["metrics"]["uplink_bits"],
                                   flat["metrics"]["uplink_bits"], rtol=1e-4)
    # the seeded round's float32 magnitudes have no tie at a threshold
    assert case == "bit-equal", (ties, overflow)


def test_data_axis_round_is_the_flat_round(ranks):
    """(2, 2, 1): the data ranks replicate the rounds over the unsharded
    wire: state and metrics bit-equal to the flat (2,) round on every
    rank."""
    flat = ranks[0][("tiny", FLAT)]
    for r in range(4):
        got = ranks[r][("tiny", (2, 2, 1))]
        assert got["ties"] == got["overflow"] == 0
        for a, b in zip(got["state"], flat["state"]):
            np.testing.assert_array_equal(a, b)
        for k, v in flat["metrics"].items():
            np.testing.assert_array_equal(got["metrics"][k], v, err_msg=k)


def test_flat_round_against_jax(ranks, jax_tiny):
    jstate, jm = jax_tiny
    flat = ranks[0][("tiny", FLAT)]
    assert set(flat["metrics"]) == set(jm)
    for k, want in jm.items():
        got = np.asarray(flat["metrics"][k])
        if k == "train_loss":
            np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-6)
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)
    for a, b in zip(flat["state"], jstate):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


@pytest.mark.parametrize("check", [
    "make_client_mesh_checks_config", "contexts", "overrides_rejected"])
def test_rank_checks(ranks, check):
    for r in range(4):
        err = ranks[r]["checks"][check]
        assert err is None, f"rank {r}: {err}"
