"""The client axis over ranks (DESIGN.md §6): the port's sharded rounds
against its unsharded rounds, on the CPU under gloo.

One spawn of 4 gloo ranks (a ``FileStore`` under ``tmp_path``, no fixed
port) runs the setup of ``tests/test_distributed.py`` (quadratic data, 16
clients, 6 dims, s = 8, 4 rounds, key 9) on subgroups of 1, 2 and 4
ranks: the seven ``ALGORITHMS``, the packed wire, LoCoDL, and
``semi_sync(2)`` / ``async_buffered(2, 0.5)`` under lognormal speeds.
Every rank of a group writes its final state, metrics and meter to a file
that this process reads; the parent joins the spawn with a timeout, so a
hung collective fails the test instead of holding the run.

Held: every metric but ``train_loss`` (the five exact metrics of
``tests/test_distributed.py`` among them) and the meter's bits bit-equal
to the unsharded port at every D; params within rtol 1e-5 / atol 1e-6 and
``train_loss`` within rtol 1e-5 / atol 1e-7 (the all-reduce sums in
another order); at D = 1 the params and every metric bit-equal; every
rank of a group ends with the same state and metrics bit for bit.  The
validation cases of ``tests/test_distributed.py`` run inside the ranks.
The unsharded port against the JAX package is
``tests/test_torch_distributed_ref.py``.
"""

import os
import pickle
import time
import traceback

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # xdist workers share the cores: no spinning OpenMP pools

from repro_torch import prng  # noqa: E402
from repro_torch import tree as tree_util  # noqa: E402
from repro_torch.compress import TopK  # noqa: E402
from repro_torch.core import fed_data, server  # noqa: E402
from repro_torch.core.aggregation import AggregationPolicy  # noqa: E402
from repro_torch.core.baselines import (  # noqa: E402
    FedAvg, FedConfig, FedDyn, Scaffold)
from repro_torch.core.client_store import HostStore  # noqa: E402
from repro_torch.core.clients import (  # noqa: E402
    ClientAvailability, ClientProfile, ClientSchedule)
from repro_torch.core.comm import CommMeter  # noqa: E402
from repro_torch.core.distributed import usable_shard_counts  # noqa: E402
from repro_torch.core.fedcomloc import (  # noqa: E402
    FedComLoc, FedComLocConfig)
from repro_torch.core.locodl import LoCoDL, LoCoDLConfig  # noqa: E402

N_CLIENTS, DIM, S, ROUNDS, KEY = 16, 6, 8, 4, 9
GROUPS = (1, 2, 4)
JOIN_TIMEOUT_S = 120.0


def quadratic_data():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(N_CLIENTS, DIM))
    b = rng.normal(size=(N_CLIENTS,))
    reps = 8
    x = np.repeat(a, reps, axis=0).astype(np.float32)
    y = np.repeat(b, reps).astype(np.float32)
    parts = [np.arange(i * reps, (i + 1) * reps) for i in range(N_CLIENTS)]
    return fed_data.from_numpy_partition(x, y, parts, device="cpu")


def sq_loss(params, xb, yb):
    pred = torch.bmm(xb, params["w"].unsqueeze(-1)).squeeze(-1)
    return 0.5 * ((pred - yb) ** 2).mean(-1)


def p0():
    return {"w": torch.zeros(DIM)}


def straggler_schedule():
    return ClientSchedule(
        profile=ClientProfile.lognormal(N_CLIENTS, speed_sigma=1.5, seed=3),
        deadline=3.0, drop_stragglers=True, bit_cost=1e-6)


def lognormal_schedule():
    return ClientSchedule(
        profile=ClientProfile.lognormal(N_CLIENTS, speed_sigma=1.0, seed=3),
        bit_cost=1e-6)


ALGORITHMS = ["fedcomloc_com", "fedcomloc_ef", "fedcomloc_drop",
              "fedavg", "fedavg_drop", "scaffold", "feddyn"]
POLICIES = {"semi_sync": AggregationPolicy.semi_sync(2),
            "async_buffered": AggregationPolicy.async_buffered(2, 0.5)}
#: every run the ranks make: the seven algorithms, the packed wire of each
#: round body, LoCoDL, and the two non-neutral policies
CONFIGS = (ALGORITHMS
           + ["fedcomloc_com@packed", "fedcomloc_ef@packed",
              "fedavg_drop@packed", "scaffold@packed", "feddyn@packed",
              "locodl", "locodl@packed"]
           + [f"fedcomloc@{p}" for p in POLICIES])


def build(name, data, store=None):
    """A fresh algorithm: ``tests/test_distributed.py``'s ``build`` in the
    port, plus ``@packed`` (the packed wire), LoCoDL and ``@<policy>``."""
    name, _, opt = name.partition("@")
    wire = "packed" if opt == "packed" else "account"
    if name.startswith("fedcomloc"):
        cfg = FedComLocConfig(gamma=0.05, p=0.2, n_clients=N_CLIENTS,
                              clients_per_round=S, batch_size=4,
                              variant="com",
                              error_feedback=name == "fedcomloc_ef")
        if opt in POLICIES:
            return FedComLoc(sq_loss, data, cfg, TopK(density=0.5),
                             schedule=lognormal_schedule(),
                             policy=POLICIES[opt], store=store)
        return FedComLoc(sq_loss, data, cfg,
                         TopK(density=0.25 if name == "fedcomloc_ef"
                              else 0.5),
                         schedule=(straggler_schedule()
                                   if name == "fedcomloc_drop" else None),
                         wire=wire, store=store)
    if name == "locodl":
        cfg = LoCoDLConfig(gamma=0.05, p=0.2, lam=0.5, n_clients=N_CLIENTS,
                           clients_per_round=S, batch_size=4)
        return LoCoDL(sq_loss, data, cfg, TopK(density=0.5), wire=wire,
                      store=store)
    fed = FedConfig(n_clients=N_CLIENTS, clients_per_round=S, batch_size=4,
                    local_steps=5)
    sched = straggler_schedule() if name.endswith("_drop") else None
    if name.startswith("fedavg"):
        return FedAvg(sq_loss, data, fed, TopK(density=0.5), schedule=sched,
                      wire=wire, store=store)
    if name == "scaffold":
        return Scaffold(sq_loss, data, fed, wire=wire, store=store)
    if name == "feddyn":
        return FedDyn(sq_loss, data, fed, wire=wire, store=store)
    raise ValueError(name)


def _numpy_state(state) -> dict:
    """Every tensor leaf of a round state, by field, as numpy."""
    out = {}
    for field, value in state._asdict().items():
        if isinstance(value, (dict, tuple)) and value != ():
            out[field] = [t.numpy().copy() for t in tree_util.leaves(value)]
    return out


def run(alg, mesh=None):
    """``run_rounds`` from the zero model on key 9: (numpy state, metrics,
    meter snapshot)."""
    if mesh is not None:
        alg.use_mesh(mesh)
    state, metrics = alg.run_rounds(alg.init(p0()), prng.PRNGKey(KEY),
                                    ROUNDS)
    return _numpy_state(state), metrics, alg.meter.snapshot()


# --------------------------------------------------------------------------- #
# the ranks
# --------------------------------------------------------------------------- #

def _checks(rank, mesh4, data):
    """The validation cases of ``tests/test_distributed.py`` and the
    drivers on a mesh; returns ``{name: None or the failure}``."""
    import torch.distributed as dist

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

    def host_mesh_has_no_clients_axis():
        raises(lambda: distributed.validate_client_mesh(
            mesh_mod.make_host_mesh(), S), ValueError, "clients")

    def sample_must_divide():
        raises(lambda: distributed.validate_client_mesh(mesh4, 7),
               ValueError, "divide")
        raises(lambda: distributed.shard_round(
            lambda st, k, ctx: (st, {}), mesh4, 7), ValueError, "divide")
        cfg = FedComLocConfig(n_clients=N_CLIENTS, clients_per_round=6,
                              batch_size=4, variant="none")
        raises(lambda: FedComLoc(sq_loss, data, cfg).use_mesh(mesh4),
               ValueError, "divide")

    def mesh_shapes():
        m1 = mesh_mod.make_client_mesh(1, device="cpu")
        assert m1.mesh_dim_names == ("clients",) and tuple(m1.shape) == (1,)
        full = mesh_mod.make_client_mesh(device="cpu")
        assert tuple(full.shape) == (4,)
        assert dist.get_rank(full.get_group("clients")) == rank
        assert distributed.usable_shard_counts(S) == [1, 2, 4]
        composed = mesh_mod.make_client_mesh(2, data=2, device="cpu")
        assert composed.mesh_dim_names == ("clients", "data", "model")
        assert tuple(composed.shape) == (2, 2, 1)
        raises(lambda: mesh_mod.make_production_mesh(),
               NotImplementedError, "not yet ported")
        raises(lambda: mesh_mod.make_client_mesh(5, device="cpu"),
               ValueError, "world size")

    def per_round_driver():
        _, ref, _ = run(build("scaffold", data), mesh4)
        alg = build("scaffold", data).use_mesh(mesh4)
        state, key = alg.init(p0()), prng.PRNGKey(KEY)
        for r in range(ROUNDS):
            key, sub = prng.split(key, 2)
            state, m = alg.round(state, sub)
            assert m["uplink_bits"] == float(ref["uplink_bits"][r])
            np.testing.assert_array_equal(m["client_steps"],
                                          ref["client_steps"][r])

    def unbind_restores_unsharded():
        alg = build("fedavg", data).use_mesh(mesh4)
        assert alg.use_mesh(mesh4) is alg and alg._mesh is mesh4
        alg.use_mesh(None)
        assert alg._mesh is None and alg._sharded is None
        got, gm, _ = run(alg)
        want, wm, _ = run(build("fedavg", data))
        np.testing.assert_array_equal(got["x"][0], want["x"][0])
        np.testing.assert_array_equal(gm["uplink_bits"], wm["uplink_bits"])

    def run_federated_accepts_mesh():
        alg = build("fedcomloc_com", data)
        hist = server.run_federated(alg, p0(), num_rounds=3,
                                    key=prng.PRNGKey(2), mesh=mesh4)
        assert alg._mesh is mesh4 and alg.meter.rounds == 3
        assert hist.final_params is not None

    def device_meter_on_a_mesh():
        alg = build("fedcomloc_com", data)
        alg.meter = CommMeter("device")
        _, m, snap = run(alg, mesh4)
        assert isinstance(alg.meter._uplink, torch.Tensor)
        assert snap["uplink_bits"] == float(m["uplink_bits"].sum(
            dtype=np.float32))

    for fn in (host_mesh_has_no_clients_axis, sample_must_divide,
               mesh_shapes, per_round_driver, unbind_restores_unsharded,
               run_federated_accepts_mesh, device_meter_on_a_mesh):
        check(fn.__name__, fn)
    return out


def _rank_main(rank, world, store_path, out_dir):
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        data = quadratic_data()

        def mesh(ranks):
            # every rank makes every group, in the same order
            group = dist.new_group(ranks)
            return (DeviceMesh.from_group(group, "cpu",
                                          mesh_dim_names=("clients",))
                    if rank in ranks else None)

        # D = 1: each rank runs a share of the configs on a group of its own
        meshes = {(1, r): mesh([r]) for r in range(world)}
        meshes.update({(d, 0): mesh(list(range(d))) for d in GROUPS[1:]})
        results = {}
        for (d, first), m in meshes.items():
            for i, name in enumerate(CONFIGS):
                if m is not None and (d > 1 or i % world == first):
                    results[(name, d)] = run(build(name, data), m)
        mesh4 = meshes[(4, 0)]
        results["checks"] = _checks(rank, mesh4, data)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
    finally:
        dist.destroy_process_group()


def _spawn(tmp: str, world: int = 4) -> dict:
    """Run :func:`_rank_main` on ``world`` spawned ranks; returns each
    rank's results.  Fails if the ranks are not done in
    ``JOIN_TIMEOUT_S`` (the processes are killed)."""
    import torch.multiprocessing as mp
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
def ranks(tmp_path_factory):
    return _spawn(str(tmp_path_factory.mktemp("ranks")))


@pytest.fixture(scope="module")
def unsharded():
    data = quadratic_data()
    return {name: run(build(name, data)) for name in CONFIGS}


# --------------------------------------------------------------------------- #
# sharded against unsharded
# --------------------------------------------------------------------------- #

def _assert_state(got, want, exact: bool, label: str):
    assert got.keys() == want.keys(), label
    for field in want:
        for a, b in zip(got[field], want[field]):
            if exact:
                np.testing.assert_array_equal(a, b, err_msg=f"{label} {field}")
            else:
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6,
                                           err_msg=f"{label} {field}")


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("name", CONFIGS)
def test_sharded_rounds_match_unsharded(ranks, unsharded, name, d):
    state, m, snap = ranks[0][(name, d)]
    st_ref, m_ref, snap_ref = unsharded[name]
    label = f"{name} D={d}"
    # every metric but the loss (the five exact metrics of
    # tests/test_distributed.py among them) comes from the full plan or
    # gathered full vectors: bit-equal at any D
    assert set(m) == set(m_ref)
    for k in m_ref:
        if k != "train_loss":
            np.testing.assert_array_equal(m[k], m_ref[k],
                                          err_msg=f"{label} {k}")
    np.testing.assert_allclose(m["train_loss"], m_ref["train_loss"],
                               rtol=1e-5, atol=1e-7, err_msg=label)
    _assert_state(state, st_ref, exact=False, label=label)
    assert snap == snap_ref, label
    # the state is replicated: every rank ends the rounds with the same
    # values, and reports the same metrics
    for r in range(1, d):
        st_r, m_r, snap_r = ranks[r][(name, d)]
        _assert_state(st_r, state, exact=True, label=f"{label} rank {r}")
        for k in m:
            np.testing.assert_array_equal(m_r[k], m[k], err_msg=k)
        assert snap_r == snap


@pytest.mark.parametrize("name", CONFIGS)
def test_single_rank_mesh_is_bit_identical(ranks, unsharded, name):
    """On a one-rank mesh even the params are bit-equal: the sharded round
    is the same computation in the same order."""
    state, m, snap = ranks[CONFIGS.index(name) % 4][(name, 1)]
    st_ref, m_ref, snap_ref = unsharded[name]
    _assert_state(state, st_ref, exact=True, label=name)
    assert set(m) == set(m_ref)
    for k in m_ref:
        np.testing.assert_array_equal(m[k], m_ref[k], err_msg=k)
    assert snap == snap_ref


@pytest.mark.parametrize("check", [
    "host_mesh_has_no_clients_axis", "sample_must_divide", "mesh_shapes",
    "per_round_driver", "unbind_restores_unsharded",
    "run_federated_accepts_mesh", "device_meter_on_a_mesh"])
def test_rank_checks(ranks, check):
    for r in range(4):
        err = ranks[r]["checks"][check]
        assert err is None, f"rank {r}: {err}"


# --------------------------------------------------------------------------- #
# without a process group
# --------------------------------------------------------------------------- #

def test_usable_shard_counts():
    assert usable_shard_counts(8, max_devices=8) == [1, 2, 4, 8]
    assert usable_shard_counts(8, max_devices=3) == [1, 2]
    assert usable_shard_counts(6, max_devices=8) == [1, 2, 3, 6]
    assert usable_shard_counts(8, max_devices=0) == [1]


def test_use_mesh_refuses_host_stores_and_the_tree_sampler():
    mesh = object()     # refused before the mesh is read
    alg = build("fedcomloc_ef", quadratic_data(), store=HostStore())
    with pytest.raises(ValueError, match="HostStore"):
        alg.use_mesh(mesh)
    sched = ClientSchedule(
        profile=ClientProfile.homogeneous(N_CLIENTS),
        availability=ClientAvailability.diurnal(N_CLIENTS, seed=0),
        sampler="tree")
    cfg = FedComLocConfig(n_clients=N_CLIENTS, clients_per_round=S,
                          batch_size=4, variant="com")
    alg = FedComLoc(sq_loss, quadratic_data(), cfg, TopK(0.5),
                    schedule=sched)
    with pytest.raises(ValueError, match="tree"):
        alg.use_mesh(mesh)
    assert alg.use_mesh(None) is alg and alg._mesh is None


def test_device_meter_sums_tensors_until_read():
    meter = CommMeter("device")
    assert CommMeter("jnp").mode == "device"
    meter.record_round(uplink_bits=torch.tensor(3.0),
                       downlink_bits=torch.tensor(1.5))
    meter.record_rounds(uplink_bits=torch.tensor([1.0, 2.0]),
                        downlink_bits=None, num_rounds=2)
    assert isinstance(meter._uplink, torch.Tensor)
    assert meter._uplink.dtype == torch.float32
    assert meter.snapshot() == {"rounds": 3, "uplink_bits": 6.0,
                                "downlink_bits": 1.5, "total_bits": 7.5}
    with pytest.raises(ValueError, match="mode"):
        CommMeter("bogus")


def test_the_model_axis_is_not_ported():
    """The model axis is ported (``ModelShardCtx``; over gloo ranks in
    ``tests/test_torch_model_axis_ranks.py``): a mesh composed with a
    model or data axis larger than 1 selects it, and the client axis is
    validated before any process group is touched."""
    from repro_torch.core import distributed

    class Mesh:
        mesh_dim_names = ("clients", "data", "model")
        shape = (2, 1, 2)

        def get_group(self, axis):
            raise LookupError(axis)      # no process group here

    assert issubclass(distributed.ModelShardCtx, distributed.ShardCtx)
    with pytest.raises(LookupError, match="clients"):
        distributed.client_ctx(Mesh(), S)
    with pytest.raises(LookupError, match="clients"):
        distributed.shard_round(lambda st, k, ctx: (st, {}), Mesh(), S)
    Mesh.shape = (2, 1, 1)
    with pytest.raises(ValueError, match="divide"):
        distributed.client_ctx(Mesh(), 7)
