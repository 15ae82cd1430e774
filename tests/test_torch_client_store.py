"""The port's client stores: the contracts of ``tests/test_client_store.py``
and ``tests/test_pipelined_store.py`` on the port.

* ``HostStore`` (plain, memory-mapped, pipelined) runs the same trajectory
  as ``InMemoryStore`` bit for bit, for FedAvg (no slots), FedComLoc-EF,
  Scaffold (both wires), FedDyn and LoCoDL, under ``round`` and
  ``run_rounds``, with uniform, Gumbel and tree cohorts;
* lazy fill rows, the version token, telemetry counts;
* the plan is a hint: hits on a correct plan, a wrong plan's fallback, a
  RAW hazard, a disjoint scatter, a re-plan, a worker error surfacing;
* availability: offline picks run no steps and join no aggregate, and
  rounds where the whole cohort is offline still pipeline bit-identically;
* the store's telemetry equals the reference's ``HostStore`` on the same
  run (the flush-stall count is a race in both and is not compared).
"""

import dataclasses
import time

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # xdist workers share the cores: no spinning OpenMP pools

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro_torch import compress, prng  # noqa: E402
from repro_torch import tree as tree_util  # noqa: E402
from repro_torch.core import fed_data  # noqa: E402
from repro_torch.core.baselines import (  # noqa: E402
    FedAvg, FedConfig, FedDyn, Scaffold)
from repro_torch.core.client_store import (  # noqa: E402
    ClientStore, HostStore, InMemoryStore, resolve_store)
from repro_torch.core.clients import (  # noqa: E402
    ClientAvailability, ClientProfile, ClientSchedule)
from repro_torch.core.fedcomloc import (  # noqa: E402
    FedComLoc, FedComLocConfig)
from repro_torch.core.locodl import LoCoDL, LoCoDLConfig  # noqa: E402

N, D, S, ROUNDS = 6, 5, 3, 5


def quadratic_data():
    """``tests/test_client_store.quadratic_setup`` for the port."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=(N, D))
    b = rng.normal(size=(N,))
    reps = 8
    x = np.repeat(a, reps, axis=0).astype(np.float32)
    y = np.repeat(b, reps).astype(np.float32)
    parts = [np.arange(i * reps, (i + 1) * reps) for i in range(N)]
    return fed_data.from_numpy_partition(x, y, parts, device="cpu")


def sq_loss(params, xb, yb):
    pred = torch.bmm(xb, params["w"].unsqueeze(-1)).squeeze(-1)
    return 0.5 * ((pred - yb) ** 2).mean(-1)


DATA = quadratic_data()
ALGORITHMS = ["fedavg", "fedcomloc_ef", "scaffold", "feddyn", "locodl"]
STATEFUL = ALGORITHMS[1:]


def build(name, store=None, schedule=None, wire="account"):
    """``tests/test_client_store.build`` in the port."""
    if name == "fedcomloc_ef":
        cfg = FedComLocConfig(gamma=0.05, p=0.25, n_clients=N,
                              clients_per_round=S, batch_size=4,
                              variant="com", error_feedback=True)
        return FedComLoc(sq_loss, DATA, cfg, compress.TopK(density=0.5),
                         schedule=schedule, store=store, wire=wire)
    if name == "locodl":
        cfg = LoCoDLConfig(gamma=0.05, p=0.25, lam=0.5, n_clients=N,
                           clients_per_round=S, batch_size=4)
        return LoCoDL(sq_loss, DATA, cfg, compress.TopK(density=0.5),
                      schedule=schedule, store=store, wire=wire)
    fed = FedConfig(gamma=0.05, local_steps=4, n_clients=N,
                    clients_per_round=S, batch_size=4)
    if name == "fedavg":
        return FedAvg(sq_loss, DATA, fed, compress.TopK(density=0.5),
                      schedule=schedule, store=store, wire=wire)
    cls = {"scaffold": Scaffold, "feddyn": FedDyn}[name]
    return cls(sq_loss, DATA, fed, schedule=schedule, store=store, wire=wire)


def P0():
    return {"w": torch.zeros(D)}


def run_fused(alg, rounds=ROUNDS, seed=11):
    return alg.run_rounds(alg.init(P0()), prng.PRNGKey(seed), rounds)


def run_stepped(alg, rounds=ROUNDS, seed=11):
    state, key, ms = alg.init(P0()), prng.PRNGKey(seed), []
    for _ in range(rounds):
        key, sub = prng.split(key, 2)
        state, m = alg.round(state, sub)
        ms.append(m)
    return state, ms


def churny_schedule(sampler="gumbel"):
    """``tests/test_client_store.churny_schedule``: about a third of the 6
    clients online, so offline picks enter the cohort of 3."""
    avail = ClientAvailability.diurnal(
        N, period=5.0, amp=0.9, churn_rate=0.37, online_frac=0.34, seed=4)
    return ClientSchedule(profile=ClientProfile.homogeneous(N),
                          availability=avail, sampler=sampler)


def assert_same_run(ref, got, label):
    """Every state leaf and metric bit-equal (a HostStore slot is a
    version token, so only ``x`` and the store-free leaves compare)."""
    (st_a, m_a), (st_b, m_b) = ref, got
    np.testing.assert_array_equal(st_a.x["w"].numpy(), st_b.x["w"].numpy(),
                                  err_msg=f"{label} x")
    assert set(m_a) == set(m_b)
    for k in m_a:
        np.testing.assert_array_equal(np.asarray(m_a[k]), np.asarray(m_b[k]),
                                      err_msg=f"{label} {k}")


# --------------------------------------------------------------------------- #
# 1. HostStore == InMemoryStore
# --------------------------------------------------------------------------- #

SCHEDULES = {"uniform": lambda: None, "gumbel": churny_schedule,
             "tree": lambda: churny_schedule("tree")}

STORES = {
    "host": lambda tmp: HostStore(),
    "mmap": lambda tmp: HostStore(mmap_dir=tmp / "spool"),
    "prefetch": lambda tmp: HostStore(prefetch=True),
    "mmap_prefetch": lambda tmp: HostStore(mmap_dir=tmp / "spool",
                                           prefetch=True),
}


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("store", sorted(STORES))
@pytest.mark.parametrize("name", ALGORITHMS)
def test_host_store_matches_memory_fused(name, store, schedule, tmp_path):
    ref = run_fused(build(name, InMemoryStore(), SCHEDULES[schedule]()))
    alg = build(name, STORES[store](tmp_path), SCHEDULES[schedule]())
    got = run_fused(alg)
    alg.store.flush()
    assert_same_run(ref, got, f"{name}/{store}/{schedule}")
    if "mmap" in store and name != "fedavg":
        assert list((tmp_path / "spool").glob("*.mm")), "nothing spooled"
    if "prefetch" in store and name != "fedavg":
        tel = alg.store.telemetry()
        # the tree and uniform cohorts are replayed into a plan; gumbel
        # cohorts are not (write-behind only)
        assert (tel["prefetch_hits"] > 0) == (schedule != "gumbel")


@pytest.mark.parametrize("store", ["host", "prefetch"])
@pytest.mark.parametrize("name", ALGORITHMS)
def test_host_store_matches_memory_stepped(name, store, tmp_path):
    sched = churny_schedule("tree")
    st_ref, ms_ref = run_stepped(build(name, InMemoryStore(), sched))
    alg = build(name, STORES[store](tmp_path), churny_schedule("tree"))
    st, ms = run_stepped(alg)
    np.testing.assert_array_equal(st_ref.x["w"].numpy(), st.x["w"].numpy())
    for r, (ma, mb) in enumerate(zip(ms_ref, ms)):
        for k in ma:
            np.testing.assert_array_equal(np.asarray(ma[k]),
                                          np.asarray(mb[k]),
                                          err_msg=f"{name} r{r} {k}")


@pytest.mark.parametrize("store", ["memory", "prefetch"])
def test_scaffold_packed_wire_reads_its_variates_from_the_store(store):
    """Scaffold's packed server side gathers the cohort's old variates
    from the store a second time, as the reference does."""
    ref = run_fused(build("scaffold", InMemoryStore(), wire="packed"))
    alg = build("scaffold",
                HostStore(prefetch=True) if store == "prefetch"
                else InMemoryStore(), wire="packed")
    got = run_fused(alg)
    assert_same_run(ref, got, "scaffold packed")
    if store == "prefetch":
        tel = alg.store.telemetry()
        assert tel["rows_gathered"] == 2 * tel["rows_scattered"]
        assert tel["prefetch_hits"] == ROUNDS


def test_default_store_is_memory():
    alg = build("scaffold")
    assert isinstance(alg.store, InMemoryStore)
    assert resolve_store(None).host_side is False
    assert HostStore().host_side is True
    assert isinstance(HostStore(), ClientStore)
    with pytest.raises(TypeError, match="ClientStore"):
        resolve_store("mmap")


def test_memory_slots_are_the_stacked_state():
    alg = build("locodl")
    st = alg.init({"w": torch.arange(D, dtype=torch.float32)})
    assert st.xs["w"].shape == (N, D) and st.h["w"].shape == (N, D)
    np.testing.assert_array_equal(st.xs["w"].numpy(),
                                  np.tile(np.arange(D), (N, 1)))
    assert not st.h["w"].any()


# --------------------------------------------------------------------------- #
# 2. lazy rows, tokens, telemetry
# --------------------------------------------------------------------------- #

def test_gather_untouched_rows_serves_fill():
    store = HostStore()
    tok = store.init_slot("xs", {"w": torch.arange(4, dtype=torch.float32)},
                          100, init="broadcast")
    rows = store.gather("xs", tok, torch.tensor([7, 93]))
    np.testing.assert_array_equal(rows["w"].numpy(),
                                  np.stack([np.arange(4.0)] * 2))
    assert not store._slots["xs"].touched.any()
    assert tok.dtype == torch.int32 and int(tok) == 0


def test_scatter_then_gather_roundtrip_and_telemetry():
    store = HostStore()
    tok = store.init_slot("e", {"w": torch.zeros(3)}, 50)
    tok2 = store.scatter("e", tok, torch.tensor([4, 9]),
                         {"w": torch.ones(2, 3)})
    rows = store.gather("e", tok2, torch.tensor([4, 9, 30]))
    np.testing.assert_array_equal(
        rows["w"].numpy(), np.stack([np.ones(3), np.ones(3), np.zeros(3)]))
    assert int(tok2) == 1
    assert store._slots["e"].touched.sum() == 2
    tel = store.telemetry()
    assert tel["bytes_scattered"] == 2 * 3 * 4
    assert tel["bytes_gathered"] == 3 * 3 * 4
    assert (tel["rows_gathered"], tel["rows_scattered"]) == (3, 2)


def test_scatter_copies_the_rows():
    """A scatter owns a copy: writing the caller's tensor afterwards does
    not reach the store, pipelined or not."""
    for store in (HostStore(), HostStore(prefetch=True)):
        tok = store.init_slot("e", {"w": torch.zeros(3)}, 10)
        rows = {"w": torch.ones(1, 3)}
        tok = store.scatter("e", tok, torch.tensor([2]), rows)
        rows["w"].fill_(7.0)
        store.flush()
        np.testing.assert_array_equal(
            store.gather("e", tok, torch.tensor([2]))["w"].numpy(),
            np.ones((1, 3)))


def test_init_mode_validated():
    for store in (HostStore(), InMemoryStore()):
        with pytest.raises(ValueError, match="init must be one of"):
            store.init_slot("x", {"w": torch.zeros(2)}, 4, init="randn")


def test_mismatched_scatter_and_unknown_slot():
    store = HostStore()
    tok = store.init_slot("e", {"w": torch.zeros(2)}, 4)
    with pytest.raises(ValueError, match="mismatched tree structure"):
        store.scatter("e", tok, torch.tensor([0]),
                      {"w": torch.zeros(1, 2), "b": torch.zeros(1, 2)})
    with pytest.raises(KeyError, match="never registered"):
        store.load_state_dict({"ghost": {}})
    with pytest.raises(TypeError, match="bfloat16"):
        store.init_slot("b", {"w": torch.zeros(2, dtype=torch.bfloat16)}, 4)


def test_state_dict_roundtrip():
    a = HostStore(prefetch=True)
    tok = a.init_slot("e", {"w": torch.zeros(3)}, 8)
    a.scatter("e", tok, torch.tensor([1, 5]),
              {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)})
    sd = a.state_dict()                         # a flush barrier
    assert sorted(sd["e"]) == ["data", "fill", "touched"]
    b = HostStore()
    b.init_slot("e", {"w": torch.zeros(3)}, 8)
    b.load_state_dict(sd)
    np.testing.assert_array_equal(
        b.gather("e", tok, torch.tensor([5, 1, 0]))["w"].numpy(),
        [[3, 4, 5], [0, 1, 2], [0, 0, 0]])


# --------------------------------------------------------------------------- #
# 3. the plan is a hint
# --------------------------------------------------------------------------- #

def _slot_store():
    store = HostStore(prefetch=True)
    return store, store.init_slot("e", {"w": torch.zeros(3)}, 50)


def test_correct_plan_hits_and_wrong_plan_falls_back():
    store, tok = _slot_store()
    store.submit_cohort_plan([np.asarray([4, 9])])
    store.flush()
    assert store._staged
    rows = store.gather("e", tok, torch.tensor([4, 9]))
    np.testing.assert_array_equal(rows["w"].numpy(), np.zeros((2, 3)))
    assert store.telemetry()["prefetch_hits"] == 1
    store.submit_cohort_plan([np.asarray([1, 2])])
    store.flush()
    rows = store.gather("e", tok, torch.tensor([7, 8]))
    np.testing.assert_array_equal(rows["w"].numpy(), np.zeros((2, 3)))
    tel = store.telemetry()
    assert tel["prefetch_misses"] == 1 and tel["rows_gathered"] == 4


def test_raw_hazard_invalidates_staged_rows():
    store, tok = _slot_store()
    store.submit_cohort_plan([np.asarray([4, 9])])
    store.flush()                              # rows 4, 9 staged (zeros)
    tok = store.scatter("e", tok, torch.tensor([9, 30]),
                        {"w": torch.ones(2, 3)})
    rows = store.gather("e", tok, torch.tensor([4, 9]))
    store.flush()
    np.testing.assert_array_equal(rows["w"].numpy(),
                                  np.stack([np.zeros(3), np.ones(3)]))
    tel = store.telemetry()
    assert tel["raw_hazards"] == 1 and tel["prefetch_hits"] == 0


def test_disjoint_scatter_keeps_staged_rows():
    store, tok = _slot_store()
    store.submit_cohort_plan([np.asarray([4, 9])])
    store.flush()
    tok = store.scatter("e", tok, torch.tensor([30, 31]),
                        {"w": torch.ones(2, 3)})
    rows = store.gather("e", tok, torch.tensor([4, 9]))
    store.flush()
    np.testing.assert_array_equal(rows["w"].numpy(), np.zeros((2, 3)))
    tel = store.telemetry()
    assert tel["raw_hazards"] == 0 and tel["prefetch_hits"] == 1


def test_replan_flushes_and_replaces_stale_staging():
    store, tok = _slot_store()
    store.submit_cohort_plan([np.asarray([1, 2]), np.asarray([3, 4])])
    store.flush()
    store.submit_cohort_plan([np.asarray([5, 6])])
    store.flush()
    rows = store.gather("e", tok, torch.tensor([5, 6]))
    np.testing.assert_array_equal(rows["w"].numpy(), np.zeros((2, 3)))
    assert store.telemetry()["prefetch_hits"] == 1


@pytest.mark.parametrize("surface", ["flush", "gather", "scatter"])
def test_worker_error_surfaces(surface):
    store, tok = _slot_store()
    with store._cond:
        store._queue.append(("apply", "ghost", np.asarray([0]),
                             [np.zeros((1, 3), np.float32)]))
        store._pending += 1
        store._cond.notify_all()
    store._ensure_worker()
    if surface != "flush":
        while store._pending:                  # the worker has failed
            time.sleep(0.01)
    with pytest.raises(RuntimeError, match="pipeline worker failed"):
        if surface == "gather":
            store.gather("e", tok, torch.tensor([1]))
        elif surface == "scatter":
            store.scatter("e", tok, torch.tensor([1]),
                          {"w": torch.zeros(1, 3)})
        else:
            store.flush()


# --------------------------------------------------------------------------- #
# 4. availability
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("sampler", ["gumbel", "tree"])
@pytest.mark.parametrize("name", ["fedcomloc_ef", "scaffold", "locodl"])
def test_availability_excludes_offline_clients(name, sampler):
    st, m = run_fused(build(name, HostStore(), churny_schedule(sampler)))
    agg = np.asarray(m["clients_aggregated"])
    steps = np.asarray(m["client_steps"])
    assert (agg < S).any()
    assert agg.min() >= 0 and agg.max() <= S
    assert ((steps == 0).sum(axis=1) == S - agg).all()
    assert np.isfinite(st.x["w"].numpy()).all()


def test_all_dropped_cohort_edge():
    avail = ClientAvailability.diurnal(
        N, period=5.0, amp=1.0, churn_rate=0.41, online_frac=0.08, seed=4)
    sched = ClientSchedule(profile=ClientProfile.homogeneous(N),
                           availability=avail, sampler="tree")
    ref = run_fused(build("fedcomloc_ef", HostStore(), sched), rounds=8)
    got = run_fused(build("fedcomloc_ef", HostStore(prefetch=True),
                          dataclasses.replace(sched)), rounds=8)
    agg = np.asarray(ref[1]["clients_aggregated"])
    assert (agg == 0).any(), "schedule no longer produces an empty cohort"
    assert_same_run(ref, got, "all-dropped cohort")
    assert np.isfinite(np.asarray(got[1]["train_loss"])).all()


# --------------------------------------------------------------------------- #
# 5. against the reference's HostStore
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def reference_store_run():
    """The reference's FedComLoc-EF on the tree schedule with a pipelined
    HostStore: its trajectory and its store's counters."""
    from repro.core.client_store import HostStore as JHostStore
    from tests import test_client_store as jref
    from tests.test_pipelined_store import tree_schedule
    with jax.threefry_partitionable(True):
        alg = jref.build("fedcomloc_ef", JHostStore(prefetch=True),
                         tree_schedule())
        state, metrics = alg.run_rounds(
            alg.init({"w": jnp.zeros((D,), jnp.float32)}),
            jax.random.PRNGKey(11), ROUNDS)
        alg.store.flush()
    return state, metrics, alg.store.telemetry()


COUNTERS = ("rows_gathered", "rows_scattered", "bytes_gathered",
            "bytes_scattered", "prefetch_hits", "prefetch_misses",
            "raw_hazards")


@pytest.mark.parametrize("mmap", [False, True], ids=["ram", "mmap"])
def test_telemetry_matches_reference_store(reference_store_run, mmap,
                                           tmp_path):
    jstate, jm, jtel = reference_store_run
    alg = build("fedcomloc_ef",
                HostStore(mmap_dir=tmp_path if mmap else None,
                          prefetch=True), churny_schedule("tree"))
    st, m = run_fused(alg)
    alg.store.flush()
    tel = alg.store.telemetry()
    assert sorted(tel) == sorted(jtel)
    assert {k: tel[k] for k in COUNTERS} == {k: jtel[k] for k in COUNTERS}
    for k in ("client_steps", "clients_aggregated", "uplink_bits"):
        np.testing.assert_array_equal(np.asarray(m[k]), np.asarray(jm[k]))
    np.testing.assert_allclose(st.x["w"].numpy(), np.asarray(jstate.x["w"]),
                               rtol=0, atol=1e-5)
    assert tree_util.leaves(st.h) == [st.h] and int(st.h) == ROUNDS
