"""Heterogeneous clients and the event-driven aggregation policies in the
port, against the reference.

* The 12 golden configs of ``tests/test_golden.py`` that need no downlink
  (FedComLoc, FedAvg, Scaffold and FedDyn, each under sync,
  ``semi_sync(2)`` and ``async_buffered(2, 0.5)``, lognormal client
  speeds), re-stated in the port and held against the JAX package's trace
  computed live in the same test, on both wires.  The committed golden
  files hold jax's older non-partitionable threefry stream, so they are
  not the yardstick here.  Tolerances are ``test_golden.py``'s: counting
  metrics exact, ``sim_time``/``client_finish`` rtol 1e-6, ``train_loss``
  rtol 2e-4; the final server model within atol 1e-5.
* The policy semantics of ``tests/test_aggregation.py`` and the straggler
  semantics of ``tests/test_clients.py`` that need no mesh and no
  hierarchical policy, on the port alone.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import clients as jclients  # noqa: E402
from repro_torch import compress, prng  # noqa: E402
from repro_torch.core import aggregation, fed_data, server  # noqa: E402
from repro_torch.core.aggregation import AggregationPolicy  # noqa: E402
from repro_torch.core.baselines import (  # noqa: E402
    FedAvg, FedConfig, FedDyn, Scaffold)
from repro_torch.core.clients import (  # noqa: E402
    ClientProfile, ClientSchedule, masked_mean)
from repro_torch.core.fedcomloc import (  # noqa: E402
    FedComLoc, FedComLocConfig)
from tests import test_golden as golden  # noqa: E402


@pytest.fixture(autouse=True)
def _partitionable_threefry():
    """The port reproduces jax's partitionable threefry stream (the
    default since jax 0.5); pin it whatever the ambient config says."""
    with jax.threefry_partitionable(True):
        yield


N, D, S, ROUNDS, SEED = golden.N, golden.D, golden.S, golden.ROUNDS, golden.SEED
PARAM_ATOL = 1e-5
POLICIES = {
    "sync": None,
    "semi_sync": AggregationPolicy.semi_sync(2),
    "async_buffered": AggregationPolicy.async_buffered(2, 0.5),
}
ALGORITHMS = ("fedcomloc", "fedavg", "scaffold", "feddyn")


def quadratic_data(n=N, d=D, seed=0):
    """``test_golden.quadratic_data`` for the port, on the CPU."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, d))
    b = rng.normal(size=(n,))
    reps = 8
    x = np.repeat(a, reps, axis=0).astype(np.float32)
    y = np.repeat(b, reps).astype(np.float32)
    parts = [np.arange(i * reps, (i + 1) * reps) for i in range(n)]
    return fed_data.from_numpy_partition(x, y, parts, device="cpu")


def sq_loss(params, xb, yb):
    """Per-client squared loss over stacked ``w`` ``(s, d)``."""
    pred = torch.bmm(xb, params["w"].unsqueeze(-1)).squeeze(-1)
    return 0.5 * ((pred - yb) ** 2).mean(-1)


def schedule():
    return ClientSchedule(
        profile=ClientProfile.lognormal(N, speed_sigma=1.0, seed=3),
        bit_cost=1e-6)


def build(algorithm, policy_name, wire="account"):
    """``test_golden.build`` in the port."""
    data, policy = quadratic_data(), POLICIES[policy_name]
    if algorithm == "fedcomloc":
        cfg = FedComLocConfig(gamma=0.05, p=0.25, n_clients=N,
                              clients_per_round=S, batch_size=4,
                              variant="com")
        return FedComLoc(sq_loss, data, cfg, compress.TopK(density=0.5),
                         schedule=schedule(), policy=policy, wire=wire)
    fed = FedConfig(gamma=0.05, local_steps=4, n_clients=N,
                    clients_per_round=S, batch_size=4)
    cls = {"fedavg": FedAvg, "scaffold": Scaffold, "feddyn": FedDyn}[algorithm]
    kw = ({"compressor": compress.TopK(density=0.5)}
          if algorithm == "fedavg" else {})
    return cls(sq_loss, data, fed, schedule=schedule(), policy=policy,
               wire=wire, **kw)


@pytest.mark.parametrize("wire", ["account", "packed"])
@pytest.mark.parametrize("algorithm,policy_name",
                         [(a, p) for a in ALGORITHMS for p in POLICIES])
def test_golden_config_matches_live_reference(algorithm, policy_name, wire):
    jalg = golden.build(algorithm, policy_name).set_wire(wire)
    jstate, jm = jalg.run_rounds(
        jalg.init({"w": jax.numpy.zeros((D,), jax.numpy.float32)}),
        jax.random.PRNGKey(SEED), ROUNDS)
    talg = build(algorithm, policy_name, wire)
    tstate, tm = talg.run_rounds(talg.init({"w": torch.zeros(D)}),
                                 prng.PRNGKey(SEED), ROUNDS)
    assert sorted(tm) == sorted(jm)
    for name, want in jm.items():
        got = np.asarray(tm[name], np.float64)
        want = np.asarray(want, np.float64)
        tol = golden.TOLERANCES.get(name)
        if tol is None:
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, rtol=tol[0], atol=tol[1],
                                       err_msg=name)
    np.testing.assert_allclose(tstate.x["w"].numpy(),
                               np.asarray(jstate.x["w"]), rtol=0,
                               atol=PARAM_ATOL)
    assert talg.meter.snapshot() == jalg.meter.snapshot()


DEADLINE = {"deadline": 3.0, "bit_cost": 1e-6}


def _jbuild(algorithm, policy, drop, wire):
    """The reference's algorithm of ``build`` under a straggler deadline."""
    sched = jclients.ClientSchedule(
        jclients.ClientProfile.lognormal(N, speed_sigma=1.0, seed=3),
        drop_stragglers=drop, **DEADLINE)
    data = golden.quadratic_data()
    if algorithm == "fedcomloc":
        cfg = golden.FedComLocConfig(gamma=0.05, p=0.25, n_clients=N,
                                     clients_per_round=S, batch_size=4,
                                     variant="com")
        return golden.FedComLoc(golden.sq_loss, data, cfg,
                                golden.TopK(density=0.5), schedule=sched,
                                policy=policy, wire=wire)
    fed = golden.FedConfig(gamma=0.05, local_steps=4, n_clients=N,
                           clients_per_round=S, batch_size=4)
    cls = {"fedavg": golden.FedAvg, "scaffold": golden.Scaffold,
           "feddyn": golden.FedDyn}[algorithm]
    kw = ({"compressor": golden.TopK(density=0.5)}
          if algorithm == "fedavg" else {})
    return cls(golden.sq_loss, data, fed, schedule=sched, policy=policy,
               wire=wire, **kw)


@pytest.mark.parametrize("wire", ["account", "packed"])
@pytest.mark.parametrize("policy_name", ["sync", "semi_sync"])
@pytest.mark.parametrize("drop", [False, True], ids=["deadline", "drop"])
@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_deadline_rounds_match_live_reference(algorithm, drop, policy_name,
                                              wire):
    """Per-client step masks under a deadline (and drop-out), held to the
    reference as the golden configs are."""
    jalg = _jbuild(algorithm, golden.POLICIES[policy_name], drop, wire)
    jstate, jm = jalg.run_rounds(
        jalg.init({"w": jax.numpy.zeros((D,), jax.numpy.float32)}),
        jax.random.PRNGKey(SEED), ROUNDS)
    talg = build(algorithm, policy_name, wire)
    talg.sched = ClientSchedule(
        ClientProfile.lognormal(N, speed_sigma=1.0, seed=3),
        drop_stragglers=drop, **DEADLINE)
    tstate, tm = talg.run_rounds(talg.init({"w": torch.zeros(D)}),
                                 prng.PRNGKey(SEED), ROUNDS)
    assert len(np.unique(jm["client_steps"])) > 1   # the deadline binds
    for name, want in jm.items():
        tol = golden.TOLERANCES.get(name, (0.0, 0.0))
        np.testing.assert_allclose(np.asarray(tm[name], np.float64),
                                   np.asarray(want, np.float64),
                                   rtol=tol[0], atol=tol[1], err_msg=name)
    np.testing.assert_allclose(tstate.x["w"].numpy(),
                               np.asarray(jstate.x["w"]), rtol=0,
                               atol=PARAM_ATOL)


@pytest.mark.parametrize("kw", [
    {"speed_sigma": 1.0, "seed": 3},
    {"speed_sigma": 0.5, "bandwidth_sigma": 0.7, "seed": 0}])
def test_lognormal_profile_equals_reference(kw):
    got = ClientProfile.lognormal(10, **kw)
    want = jclients.ClientProfile.lognormal(10, **kw)
    np.testing.assert_array_equal(got.speed.numpy(), np.asarray(want.speed))
    np.testing.assert_array_equal(got.bandwidth.numpy(),
                                  np.asarray(want.bandwidth))


@pytest.mark.parametrize("kw", [
    {"lo": 0.3, "hi": 2.0, "seed": 1},
    {"bandwidth_lo": 0.5, "bandwidth_hi": 4.0, "seed": 2}])
def test_uniform_profile_equals_reference(kw):
    got = ClientProfile.uniform(7, **kw)
    want = jclients.ClientProfile.uniform(7, **kw)
    np.testing.assert_array_equal(got.speed.numpy(), np.asarray(want.speed))
    np.testing.assert_array_equal(got.bandwidth.numpy(),
                                  np.asarray(want.bandwidth))


def test_deadline_plan_and_finish_equal_reference():
    """Per-client steps under a deadline, drop-out and the finish clock,
    from the same profile, cohort and bits."""
    kw = {"deadline": 2.0, "drop_stragglers": True, "step_cost": 0.7,
          "bit_cost": 1e-3}
    tsched = ClientSchedule(ClientProfile.lognormal(8, speed_sigma=1.0,
                                                    seed=5), **kw)
    jsched = jclients.ClientSchedule(
        jclients.ClientProfile.lognormal(8, speed_sigma=1.0, seed=5), **kw)
    clients = np.array([7, 0, 3, 5, 1])
    bits = np.array([640.0, 96.0, 1e5, 3.0, 7.5], np.float32)
    tplan = tsched.plan(torch.from_numpy(clients), 6)
    jplan = jsched.plan(jax.numpy.asarray(clients), 6)
    np.testing.assert_array_equal(tplan.steps.numpy(), np.asarray(jplan.steps))
    np.testing.assert_array_equal(tplan.participating.numpy(),
                                  np.asarray(jplan.participating))
    assert 0 < int(tplan.participating.sum()) < 5
    np.testing.assert_array_equal(
        tsched.finish_times(tplan, torch.from_numpy(bits)).numpy(),
        np.asarray(jsched.finish_times(jplan, jax.numpy.asarray(bits))))


# --------------------------------------------------------------------------- #
# policy semantics (tests/test_aggregation.py, on the port)
# --------------------------------------------------------------------------- #

N_AGG, DIM_AGG, S_AGG, R_AGG = 8, 6, 4, 4
AGG_DATA = quadratic_data(N_AGG, DIM_AGG)


def agg_build(name, policy=None):
    sched = ClientSchedule(
        profile=ClientProfile.lognormal(N_AGG, speed_sigma=1.0, seed=3),
        bit_cost=1e-6)
    if name == "fedcomloc":
        cfg = FedComLocConfig(gamma=0.05, p=0.2, n_clients=N_AGG,
                              clients_per_round=S_AGG, batch_size=4,
                              variant="com")
        return FedComLoc(sq_loss, AGG_DATA, cfg, compress.TopK(density=0.5),
                         schedule=sched, policy=policy)
    fed = FedConfig(gamma=0.05, local_steps=5, n_clients=N_AGG,
                    clients_per_round=S_AGG, batch_size=4)
    return FedAvg(sq_loss, AGG_DATA, fed, compress.TopK(density=0.5),
                  schedule=sched, policy=policy)


def run_rounds(alg, rounds=R_AGG, seed=9, w0=None):
    w0 = torch.zeros(DIM_AGG) if w0 is None else w0
    return alg.run_rounds(alg.init({"w": w0}), prng.PRNGKey(seed), rounds)


def test_semi_sync_waits_for_kth_finish():
    k = 2
    _, m = run_rounds(agg_build("fedcomloc", AggregationPolicy.semi_sync(k)))
    _, m_sync = run_rounds(agg_build("fedcomloc"))
    for r in range(R_AGG):
        finish = np.sort(m["client_finish"][r])
        assert m["sim_time"][r] == finish[k - 1]
        assert m["clients_aggregated"][r] == k
        bits = m["client_uplink_bits"][r]
        assert (bits == 0).sum() == S_AGG - k
        assert m["uplink_bits"][r] == bits.sum()
    assert (m["sim_time"] <= m_sync["sim_time"] + 1e-6).all()
    assert m["sim_time"].sum() < 0.7 * m_sync["sim_time"].sum()


def _one_slow_schedule(n, **kw):
    speed = torch.ones(n)
    speed[0] = 1e-3                      # client 0 always finishes last
    return ClientSchedule(profile=ClientProfile(speed=speed,
                                                bandwidth=torch.ones(n)), **kw)


def _full_cohort_fedcomloc(n, sched, policy=None):
    cfg = FedComLocConfig(gamma=0.05, p=0.25, n_clients=n,
                          clients_per_round=n, batch_size=4, variant="com")
    return FedComLoc(sq_loss, quadratic_data(n, DIM_AGG), cfg,
                     compress.TopK(density=0.5), schedule=sched,
                     policy=policy)


def test_semi_sync_excluded_clients_keep_control_variates():
    n = 5
    alg = _full_cohort_fedcomloc(n, _one_slow_schedule(n),
                                 AggregationPolicy.semi_sync(n - 1))
    state, m = alg.round(alg.init({"w": torch.zeros(DIM_AGG)}),
                         prng.PRNGKey(0))
    assert m["client_uplink_bits"][np.argmax(m["client_finish"])] == 0.0
    assert m["clients_aggregated"] == n - 1
    h = state.h["w"].numpy()             # rows follow client ids
    assert np.all(h[0] == 0.0)
    assert np.all(np.any(h[1:] != 0.0, axis=1))


def test_semi_sync_with_drops_counts_only_real_reports():
    n, d = 5, 8
    sched = ClientSchedule(
        profile=ClientProfile(
            speed=torch.tensor([1e-3, 1e-3, 1.0, 1.2, 1.4]),
            bandwidth=torch.full((n,), 0.01)),
        deadline=2.0, drop_stragglers=True, bit_cost=1e-1)
    cfg = FedComLocConfig(gamma=0.05, p=0.25, n_clients=n,
                          clients_per_round=n, batch_size=4, variant="com")
    alg = FedComLoc(sq_loss, quadratic_data(n, d), cfg,
                    compress.TopK(density=0.5), schedule=sched,
                    policy=AggregationPolicy.semi_sync(2))
    state, m = alg.round(alg.init({"w": torch.ones(d)}), prng.PRNGKey(0))
    assert (m["client_steps"] == 0).sum() == 2
    assert m["clients_aggregated"] == 2.0
    assert (m["client_uplink_bits"] > 0).sum() == 2
    part_finish = np.sort(m["client_finish"][m["client_steps"] > 0])
    assert m["sim_time"] == part_finish[1] > 2.0
    assert not torch.allclose(state.x["w"], torch.ones(d))


def test_semi_sync_fewer_participants_than_k_holds_to_deadline():
    n = 4
    sched = ClientSchedule(
        profile=ClientProfile(speed=torch.tensor([1e-3, 1e-3, 1e-3, 1.0]),
                              bandwidth=torch.ones(n)),
        deadline=10.0, drop_stragglers=True)
    alg = _full_cohort_fedcomloc(n, sched, AggregationPolicy.semi_sync(3))
    _, m = alg.round(alg.init({"w": torch.zeros(DIM_AGG)}), prng.PRNGKey(0))
    assert (m["client_steps"] == 0).sum() == 3
    assert m["clients_aggregated"] == 1.0
    assert m["sim_time"] == pytest.approx(10.0)


def test_semi_sync_ties_all_kept():
    """Homogeneous finishes: every tie at the K-th finish is kept, so K < s
    aggregates the whole cohort."""
    alg = agg_build("fedavg", AggregationPolicy.semi_sync(2))
    alg.sched = ClientSchedule(profile=ClientProfile.homogeneous(N_AGG),
                               bit_cost=1e-6)
    _, m = run_rounds(alg)
    np.testing.assert_array_equal(m["clients_aggregated"],
                                  np.full((R_AGG,), float(S_AGG)))


def test_async_staleness_levels_follow_arrival_order():
    _, m = run_rounds(agg_build("fedcomloc",
                                AggregationPolicy.async_buffered(2, 0.5)))
    _, m_sync = run_rounds(agg_build("fedcomloc"))
    for r in range(R_AGG):
        order = np.argsort(m["client_finish"][r], kind="stable")
        np.testing.assert_array_equal(m["client_staleness"][r][order],
                                      [0.0, 0.0, 1.0, 1.0])
    for name in ("uplink_bits", "client_uplink_bits", "sim_time"):
        np.testing.assert_array_equal(m[name], m_sync[name], err_msg=name)


def test_async_ties_rank_by_position():
    """Equal finishes rank stably by cohort position (``jnp.argsort``):
    with every finish tied the staleness levels are ``rank // capacity``
    in cohort order."""
    policy = aggregation.validate_policy(
        AggregationPolicy.async_buffered(2, 0.5), 6)
    sched = ClientSchedule(profile=ClientProfile.homogeneous(6))
    plan = sched.plan(torch.arange(6), 3)
    out = aggregation.apply_policy(policy, sched, plan, torch.zeros(6))
    np.testing.assert_array_equal(out.staleness.numpy(),
                                  [0, 0, 1, 1, 2, 2])
    np.testing.assert_allclose(out.coef.numpy(),
                               np.repeat([1.0, 2 ** -0.5, 3 ** -0.5], 2) / 2,
                               rtol=1e-6)


def test_async_server_applies_staleness_weighted_flushes():
    def step(alpha):
        alg = agg_build("fedavg", AggregationPolicy.async_buffered(2, alpha))
        state, _ = alg.round(alg.init({"w": torch.zeros(DIM_AGG)}),
                             prng.PRNGKey(5))
        return state.x["w"].numpy().astype(np.float64)

    s0, s1 = step(0.0), step(1.0)
    mean1 = 2.0 * (s0 - s1)
    mean0 = s0 - mean1
    np.testing.assert_allclose(step(2.0), mean0 + 0.25 * mean1,
                               rtol=1e-4, atol=1e-6)


def test_async_alpha_zero_applies_full_cohort():
    st_sync, _ = run_rounds(agg_build("fedavg"), rounds=1)
    st, _ = run_rounds(agg_build("fedavg",
                                 AggregationPolicy.async_buffered(2, 0.0)),
                       rounds=1)
    np.testing.assert_allclose(st.x["w"].numpy(),
                               2.0 * st_sync.x["w"].numpy(),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("policy", [AggregationPolicy.semi_sync(S_AGG),
                                    AggregationPolicy.async_buffered(S_AGG)],
                         ids=["semi_sync", "async_buffered"])
def test_neutral_policy_matches_sync(policy):
    st_ref, m_ref = run_rounds(agg_build("fedcomloc"))
    st, m = run_rounds(agg_build("fedcomloc", policy))
    for name in m_ref:
        if name == "train_loss":
            np.testing.assert_allclose(m[name], m_ref[name], rtol=1e-5)
        else:
            np.testing.assert_array_equal(m[name], m_ref[name], err_msg=name)
    np.testing.assert_allclose(st.x["w"].numpy(), st_ref.x["w"].numpy(),
                               rtol=1e-5, atol=1e-6)


def test_policy_round_matches_run_rounds():
    policy = AggregationPolicy.async_buffered(2, 0.5)
    alg_a, alg_b = agg_build("fedcomloc", policy), agg_build("fedcomloc",
                                                             policy)
    sb, fused = run_rounds(alg_b)
    state, key = alg_a.init({"w": torch.zeros(DIM_AGG)}), prng.PRNGKey(9)
    for r in range(R_AGG):
        key, sub = prng.split(key, 2)
        state, m = alg_a.round(state, sub)
        assert m["uplink_bits"] == float(fused["uplink_bits"][r])
        np.testing.assert_array_equal(m["client_staleness"],
                                      fused["client_staleness"][r])
    assert torch.equal(state.x["w"], sb.x["w"])
    assert alg_a.meter.snapshot() == alg_b.meter.snapshot()


def test_run_federated_and_set_policy():
    alg = agg_build("fedcomloc")
    assert alg.policy.is_sync
    hist = server.run_federated(alg, {"w": torch.zeros(DIM_AGG)}, 3,
                                prng.PRNGKey(2),
                                policy=AggregationPolicy.semi_sync(2))
    assert alg.policy.mode == "semi_sync" and alg.policy.wait_for == 2
    assert alg.meter.rounds == 3 and hist.final_params is not None
    assert alg.set_policy(None) is alg and alg.policy.is_sync


def test_policy_validation():
    with pytest.raises(ValueError, match="wait_for"):
        aggregation.validate_policy(AggregationPolicy.semi_sync(S + 1), S)
    with pytest.raises(ValueError, match="divide"):
        aggregation.validate_policy(AggregationPolicy.async_buffered(3), S)
    with pytest.raises(ValueError, match="mode"):
        AggregationPolicy(mode="nope")
    with pytest.raises(ValueError):
        AggregationPolicy(mode="sync", capacity=2)
    with pytest.raises(ValueError):
        AggregationPolicy(mode="async_buffered", alpha=-1.0)
    with pytest.raises(TypeError):
        aggregation.validate_policy("semi_sync", S)
    assert aggregation.validate_policy(
        AggregationPolicy.async_buffered(), S).capacity == S
    assert aggregation.validate_policy(
        AggregationPolicy(mode="semi_sync"), S).wait_for == S
    with pytest.raises(ValueError, match="divide"):
        agg_build("fedcomloc", AggregationPolicy.async_buffered(3))


# --------------------------------------------------------------------------- #
# straggler semantics (tests/test_clients.py, on the port)
# --------------------------------------------------------------------------- #

def drive(alg, d, rounds, seed=0, w0=None):
    state = alg.init({"w": torch.zeros(d) if w0 is None else w0})
    key, ms = prng.PRNGKey(seed), []
    for _ in range(rounds):
        key, sub = prng.split(key, 2)
        state, m = alg.round(state, sub)
        ms.append(m)
    return state, ms


@pytest.mark.parametrize("drop", [False, True])
@pytest.mark.parametrize("algorithm", ["fedcomloc", "fedavg"])
def test_het_round_matches_run_rounds(algorithm, drop):
    n, d, rounds = 6, 8, 5
    sched = ClientSchedule(
        profile=ClientProfile.uniform(n, lo=0.3, hi=2.0, seed=1),
        deadline=3.0, drop_stragglers=drop)

    def mk():
        if algorithm == "fedcomloc":
            cfg = FedComLocConfig(gamma=0.05, p=0.25, n_clients=n,
                                  clients_per_round=4, batch_size=4)
            return FedComLoc(sq_loss, quadratic_data(n, d), cfg,
                             compress.TopK(0.3), schedule=sched)
        cfg = FedConfig(gamma=0.05, local_steps=5, n_clients=n,
                        clients_per_round=3, batch_size=4)
        return FedAvg(sq_loss, quadratic_data(n, d), cfg,
                      compress.TopK(0.4), schedule=sched)

    alg_a, alg_b = mk(), mk()
    sa, per = drive(alg_a, d, rounds, seed=42)
    sb, fused = alg_b.run_rounds(alg_b.init({"w": torch.zeros(d)}),
                                 prng.PRNGKey(42), rounds)
    assert torch.equal(sa.x["w"], sb.x["w"])
    steps = np.stack([m["client_steps"] for m in per])
    assert len(np.unique(steps)) > 1        # the deadline truncates
    for i, m in enumerate(per):
        for name in ("uplink_bits", "sim_time", "client_steps",
                     "client_uplink_bits"):
            np.testing.assert_array_equal(m[name], fused[name][i],
                                          err_msg=name)
    assert alg_a.meter.snapshot() == alg_b.meter.snapshot()
    np.testing.assert_allclose(fused["client_uplink_bits"].sum(axis=1),
                               fused["uplink_bits"])


def test_dropped_straggler_transmits_nothing_and_keeps_state():
    n = 5
    alg = _full_cohort_fedcomloc(
        n, _one_slow_schedule(n, deadline=10.0, drop_stragglers=True))
    state, m = alg.round(alg.init({"w": torch.zeros(DIM_AGG)}),
                         prng.PRNGKey(0))
    steps, bits = m["client_steps"], m["client_uplink_bits"]
    assert (steps == 0).sum() == 1
    assert bits[steps == 0] == 0.0
    assert m["uplink_bits"] == bits.sum()
    h = state.h["w"].numpy()
    assert np.all(h[0] == 0.0)
    assert np.all(np.any(h[1:] != 0.0, axis=1))
    assert m["sim_time"] == 10.0
    assert m["client_finish"][steps == 0] == 10.0


@pytest.mark.parametrize("wire", ["account", "packed"])
def test_all_dropped_round_keeps_server_model(wire):
    n, d = 4, 6
    sched = ClientSchedule(
        profile=ClientProfile(speed=torch.full((n,), 1e-3),
                              bandwidth=torch.ones(n)),
        deadline=1.0, drop_stragglers=True)
    data = quadratic_data(n, d)
    cfg = FedComLocConfig(gamma=0.05, p=0.25, n_clients=n,
                          clients_per_round=2, batch_size=4, variant="com")
    w0 = prng.normal(prng.PRNGKey(11), (d,), device="cpu")
    alg = FedComLoc(sq_loss, data, cfg, compress.TopK(density=0.5),
                    schedule=sched, wire=wire)
    state, ms = drive(alg, d, 2, w0=w0)
    assert torch.equal(state.x["w"], w0)
    assert torch.equal(state.h["w"], torch.zeros(n, d))
    assert all(m["uplink_bits"] == 0.0 for m in ms)
    bcfg = FedConfig(gamma=0.05, local_steps=5, n_clients=n,
                     clients_per_round=2, batch_size=4)
    for cls in (FedAvg, FedDyn, Scaffold):
        bstate, bms = drive(cls(sq_loss, data, bcfg, schedule=sched,
                                wire=wire), d, 2, w0=w0)
        assert torch.equal(bstate.x["w"], w0), cls.__name__
        assert all(m["uplink_bits"] == 0.0 for m in bms)


@pytest.mark.parametrize("cls", [FedAvg, Scaffold, FedDyn])
def test_baselines_run_heterogeneous(cls):
    n, d = 6, 8
    cfg = FedConfig(gamma=0.05, local_steps=5, n_clients=n,
                    clients_per_round=4, batch_size=4)
    sched = ClientSchedule(
        profile=ClientProfile.uniform(n, lo=0.3, hi=2.0, seed=1),
        deadline=4.0, drop_stragglers=True)
    _, ms = drive(cls(sq_loss, quadratic_data(n, d), cfg, schedule=sched),
                  d, 8)
    losses = [m["train_loss"] for m in ms]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert all(0 <= m["sim_time"] <= 4.0 + 1e-6 for m in ms)


def test_scaffold_zero_step_client_keeps_control_variate():
    n, d = 5, 6
    cfg = FedConfig(gamma=0.05, local_steps=5, n_clients=n,
                    clients_per_round=n, batch_size=4)
    alg = Scaffold(sq_loss, quadratic_data(n, d), cfg,
                   schedule=_one_slow_schedule(n, deadline=2.0))
    state, _ = drive(alg, d, 6)
    assert torch.all(state.ci["w"][0] == 0.0)
    assert torch.any(state.c["w"] != 0.0)


def test_dropped_straggler_finish_is_exactly_deadline():
    n = 4
    sched = ClientSchedule(
        profile=ClientProfile(speed=torch.tensor([1.0, 1.0, 1.0, 1e-3]),
                              bandwidth=torch.ones(n)),
        deadline=2.0, drop_stragglers=True, step_cost=1.0, bit_cost=1e-3)
    plan = sched.plan(torch.arange(n), 2)
    assert not bool(plan.participating[3])
    bits = torch.full((n,), 1e6)
    finish = sched.finish_times(plan, bits).numpy()
    assert finish[3] == 2.0
    np.testing.assert_array_equal(
        finish, sched.finish_times(plan, bits * plan.participating).numpy())
    np.testing.assert_allclose(finish[0], 2.0 + 1e6 * 1e-3, rtol=1e-6)
    assert float(sched.sim_time(plan, bits)) == pytest.approx(1002.0)


def test_masked_mean_zero_weight_gives_zeros():
    tree = {"w": torch.ones(3, 4)}
    assert torch.equal(masked_mean(tree, torch.zeros(3))["w"],
                       torch.zeros(4))


def test_schedule_validation():
    profile = ClientProfile.homogeneous(4)
    with pytest.raises(ValueError):
        ClientSchedule(profile=profile, drop_stragglers=True)
    with pytest.raises(ValueError):
        ClientSchedule(profile=profile, deadline=0.0)
    with pytest.raises(ValueError):
        ClientSchedule(profile=profile, sampler="nope")
