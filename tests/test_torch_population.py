"""Population scale in the port, against the reference on the CPU.

* ``prng.fold_in`` and ``SyntheticFederatedData``: keys, ``w0``, the
  clients' optima and ``x`` bit-equal to ``jax.random``'s draws; ``y``
  (a float32 matrix product) within rtol 1e-6.
* ``prng.xla_sin`` bit-equal to ``jnp.sin`` (glibc's ``sinf``, which XLA
  calls on the CPU) over 10^6 arguments, and ``ClientAvailability.weights``
  bit-equal to the reference's over 48 rounds, with and without churn, as
  its rounds compute them (under ``jit``).
* Gumbel and tree cohorts and their online masks equal to the
  reference's over 10 rounds at n = 2000, and on the thin population of
  ``tests/test_client_store.py`` where offline clients pad the cohort.
* ``HierarchicalPolicy`` outcomes equal to the reference's
  ``apply_policy`` for sync, semi_sync and async tiers, edge latency and
  drops.
* FedComLoc-EF and LoCoDL rounds on the tree sampler, a hierarchical
  policy and ``SyntheticFederatedData``: bits, ``sim_time`` and counts
  exact, losses at ``tests/test_golden.py``'s tolerances, the final model
  within 1e-5.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # xdist workers share the cores: no spinning OpenMP pools

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.compress import TopK as JTopK  # noqa: E402
from repro.core import aggregation as jagg  # noqa: E402
from repro.core import clients as jclients  # noqa: E402
from repro.core import fed_data as jfed  # noqa: E402
from repro.core.fedcomloc import FedComLoc as JFedComLoc  # noqa: E402
from repro.core.fedcomloc import FedComLocConfig as JFedComLocConfig  # noqa: E402
from repro.core.locodl import LoCoDL as JLoCoDL  # noqa: E402
from repro.core.locodl import LoCoDLConfig as JLoCoDLConfig  # noqa: E402
from repro_torch import compress, prng  # noqa: E402
from repro_torch.core import aggregation, clients, fed_data  # noqa: E402
from repro_torch.core.client_store import HostStore  # noqa: E402
from repro_torch.core.fedcomloc import (  # noqa: E402
    FedComLoc, FedComLocConfig)
from repro_torch.core.locodl import LoCoDL, LoCoDLConfig  # noqa: E402
from tests import test_golden as golden  # noqa: E402


@pytest.fixture(autouse=True)
def _partitionable_threefry():
    with jax.threefry_partitionable(True):
        yield


N, D, S, BATCH, ROUNDS, EDGES = 2000, 16, 8, 8, 5, 4
PARAM_ATOL = 1e-5


def _kd(jkey) -> torch.Tensor:
    return prng.key_data(np.asarray(jax.random.key_data(jkey)))


# --------------------------------------------------------------------------- #
# fold_in and procedural data
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5])
def test_fold_in_matches_jax(seed):
    ids = np.array([[0, 1], [2 ** 31 - 1, 999_999]])
    key = jax.random.PRNGKey(seed)
    want = np.stack([np.asarray(jax.random.key_data(
        jax.random.fold_in(key, int(c)))) for c in ids.ravel()])
    got = prng.fold_in(_kd(key), torch.from_numpy(ids))
    assert got.shape == (2, 2, 2)
    np.testing.assert_array_equal(got.reshape(-1, 2).numpy(), want)


@pytest.fixture(scope="module")
def synth():
    return (jfed.SyntheticFederatedData.create(N, D, hetero=0.2, noise=0.01,
                                               seed=3),
            fed_data.SyntheticFederatedData.create(
                N, D, hetero=0.2, noise=0.01, seed=3, device="cpu"))


def test_synthetic_weights_are_bit_equal(synth):
    jd, td = synth
    assert td.n_clients == N and td.dim == D
    np.testing.assert_array_equal(td.w0.numpy(), np.asarray(jd.w0))
    ids = np.array([0, 1, 1999, 2 ** 31 - 1, 999_999])
    want = np.stack([np.asarray(jd.client_weights(int(c))) for c in ids])
    np.testing.assert_array_equal(
        td.client_weights(torch.from_numpy(ids)).numpy(), want)


@pytest.mark.parametrize("noise", [0.0, 0.01])
def test_synthetic_batches_match(synth, noise):
    jd, td = synth
    jd = dataclasses.replace(jd, noise=noise)
    td = dataclasses.replace(td, noise=noise)
    keys = jax.random.split(jax.random.PRNGKey(4), 6)
    ids = [0, 5, 1999, 77, 5, 1024]
    xs, ys = zip(*[jd.sample_batch(keys[i], ids[i], BATCH) for i in range(6)])
    tx, ty = td.sample_batch(_kd(keys).reshape(2, 3, 2),
                             torch.tensor(ids).reshape(2, 3), BATCH)
    assert tx.shape == (2, 3, BATCH, D) and ty.shape == (2, 3, BATCH)
    np.testing.assert_array_equal(tx.reshape(6, BATCH, D).numpy(),
                                  np.stack(xs))
    np.testing.assert_allclose(ty.reshape(6, BATCH).numpy(), np.stack(ys),
                               rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------------------- #
# availability: XLA's sin and the weights
# --------------------------------------------------------------------------- #

def test_xla_sin_is_jnp_sin_on_a_million_arguments():
    rng = np.random.default_rng(0)
    phase = rng.random(200_000).astype(np.float32)
    # the diurnal phases 2 pi (t/24 + phi) the weights take, the large
    # arguments of the 4/pi reduction, tiny ones, signs, inf and NaN
    args = np.concatenate(
        [np.float32(2 * np.pi) * (np.float32(t) / np.float32(24) + phase)
         for t in (0, 3, 17, 40)]
        + [rng.uniform(-1e5, 1e5, 150_000), 10 ** rng.uniform(-40, 38, 50_000),
           -(10 ** rng.uniform(-40, 38, 1000)),
           [0.0, -0.0, 0.74999994, 0.75, 119.99999, 120.0, np.inf, -np.inf,
            np.nan]]).astype(np.float32)
    assert args.size > 10 ** 6
    want = np.asarray(jax.jit(jnp.sin)(jnp.asarray(args)))
    got = prng.xla_sin(torch.from_numpy(args)).numpy()
    np.testing.assert_array_equal(got.view(np.int32)[~np.isnan(want)],
                                  want.view(np.int32)[~np.isnan(want)])
    assert np.isnan(got[np.isnan(want)]).all()


AVAIL = {"diurnal": dict(period=24.0, amp=0.8),
         "churn": dict(period=24.0, amp=0.8, churn_rate=0.05,
                       online_frac=0.7),
         "deep": dict(period=5.0, amp=1.0, churn_rate=0.37,
                      online_frac=0.34)}


@pytest.mark.parametrize("trace", sorted(AVAIL))
def test_availability_weights_are_bit_equal(trace):
    """As the reference's rounds compute them: under ``jit``."""
    n = 4000
    ja = jclients.ClientAvailability.diurnal(n, seed=1, **AVAIL[trace])
    ta = clients.ClientAvailability.diurnal(n, seed=1, **AVAIL[trace])
    np.testing.assert_array_equal(ta.phase.numpy(), np.asarray(ja.phase))
    weights = jax.jit(ja.weights)
    for t in range(48):
        want = np.asarray(weights(jnp.int32(t)))
        got = ta.weights(t).numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32), err_msg=f"t={t}")


def test_availability_validation():
    with pytest.raises(ValueError, match="amp"):
        clients.ClientAvailability.diurnal(4, amp=1.5)
    with pytest.raises(ValueError, match="online_frac"):
        clients.ClientAvailability.diurnal(4, online_frac=0.0)
    avail = clients.ClientAvailability.diurnal(5)
    with pytest.raises(ValueError, match="availability traces 5"):
        clients.ClientSchedule(clients.ClientProfile.homogeneous(4),
                               availability=avail)


# --------------------------------------------------------------------------- #
# cohorts
# --------------------------------------------------------------------------- #

def _schedules(n, sampler, **avail):
    seed = avail.pop("seed", 0)
    ja = jclients.ClientAvailability.diurnal(n, seed=seed, **avail)
    ta = clients.ClientAvailability.diurnal(n, seed=seed, **avail)
    return (jclients.ClientSchedule(jclients.ClientProfile.homogeneous(n),
                                    availability=ja, sampler=sampler),
            clients.ClientSchedule(clients.ClientProfile.homogeneous(n),
                                   availability=ta, sampler=sampler))


# the thin population of tests/test_client_store.py: fewer than s clients
# online, so offline clients pad the cohort
THIN = dict(period=5.0, amp=0.9, churn_rate=0.37, online_frac=0.34, seed=4)


@pytest.mark.parametrize("population", ["large", "thin"])
@pytest.mark.parametrize("sampler", ["gumbel", "tree"])
def test_cohorts_match_reference(sampler, population):
    n, s, avail = ((N, S, dict(AVAIL["churn"]))
                   if population == "large" else (6, 3, dict(THIN)))
    js, ts = _schedules(n, sampler, **avail)
    sample = jax.jit(lambda k, t: js.sample_cohort(k, s, t))
    key = jax.random.PRNGKey(11)
    offline = 0
    for t in range(10):
        key, sub = jax.random.split(key)
        jc, jo = sample(sub, jnp.int32(t))
        tc, to = ts.sample_cohort(_kd(sub), s, t)
        assert tc.dtype == torch.int64
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc),
                                      err_msg=f"t={t}")
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        offline += int((~to).sum())
    if population == "thin":
        assert offline > 0, "the thin population no longer pads cohorts"


def test_tree_plan_is_the_round_draw():
    """``plan_cohort_host`` hands the reference's sampler the key as its
    uint32 words, so the memo and the seed are the reference's."""
    js, ts = _schedules(N, "tree", **AVAIL["churn"])
    key = jax.random.PRNGKey(2 ** 31 + 9)          # a word above 2^31
    for t in (0, 1, 7):
        jc, jo = js.plan_cohort_host(key, S, t)
        tc, to = ts.plan_cohort_host(_kd(key), S, t)
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_array_equal(to, jo)
    assert ts.tree_sampler is ts.tree_sampler
    assert ts.uses_host_sampler and not _schedules(N, "gumbel")[1] \
        .uses_host_sampler


def test_plan_masks_offline_picks():
    js, ts = _schedules(6, "gumbel", **THIN)
    avail = np.array([True, False, True])
    tplan = ts.plan(torch.tensor([0, 3, 5]), 4,
                    available=torch.from_numpy(avail))
    jplan = js.plan(jnp.asarray([0, 3, 5]), 4, available=jnp.asarray(avail))
    np.testing.assert_array_equal(tplan.steps.numpy(), np.asarray(jplan.steps))
    np.testing.assert_array_equal(tplan.participating.numpy(),
                                  np.asarray(jplan.participating))
    bits = np.array([10.0, 20.0, 30.0], np.float32)
    np.testing.assert_array_equal(
        ts.finish_times(tplan, torch.from_numpy(bits)).numpy(),
        np.asarray(js.finish_times(jplan, jnp.asarray(bits))))
    assert ts.may_drop and ts.heterogeneous_steps


# --------------------------------------------------------------------------- #
# hierarchical aggregation
# --------------------------------------------------------------------------- #

TIERS = {
    "sync": lambda A: A.sync(),
    "semi_sync": lambda A: A.semi_sync(2),
    "async": lambda A: A.async_buffered(2, 0.5),
}


@pytest.mark.parametrize("drops", [False, True], ids=["all", "drops"])
@pytest.mark.parametrize("latency", [0.0, 0.5])
@pytest.mark.parametrize("server", sorted(TIERS))
@pytest.mark.parametrize("edge", sorted(TIERS))
def test_hierarchical_outcome_matches_reference(edge, server, latency,
                                                drops):
    s, e = 8, 4
    jpol = jagg.validate_policy(jagg.HierarchicalPolicy(
        edge=TIERS[edge](jagg.AggregationPolicy),
        server=TIERS[server](jagg.AggregationPolicy) if server != "semi_sync"
        else jagg.AggregationPolicy.semi_sync(3),
        n_edges=e, edge_latency=latency), s)
    tpol = aggregation.validate_policy(aggregation.HierarchicalPolicy(
        edge=TIERS[edge](aggregation.AggregationPolicy),
        server=TIERS[server](aggregation.AggregationPolicy)
        if server != "semi_sync"
        else aggregation.AggregationPolicy.semi_sync(3),
        n_edges=e, edge_latency=latency), s)
    rng = np.random.default_rng(5)
    speed = rng.lognormal(0.0, 1.0, s).astype(np.float32)
    steps = np.full(s, 4, np.int32)
    part = np.ones(s, bool)
    if drops:
        part[[1, 4, 5]] = False                 # edge 2 empties entirely
        steps[[1, 4, 5]] = 0
    bits = (rng.integers(100, 1000, s) * part).astype(np.float32)
    jplan = jclients.RoundPlan(
        steps=jnp.asarray(steps), participating=jnp.asarray(part),
        speed=jnp.asarray(speed), bandwidth=jnp.ones(s), comp_overrides={})
    tplan = clients.RoundPlan(
        steps=torch.from_numpy(steps), participating=torch.from_numpy(part),
        speed=torch.from_numpy(speed), bandwidth=torch.ones(s),
        comp_overrides={})
    jsched = jclients.ClientSchedule(jclients.ClientProfile.homogeneous(s),
                                     bit_cost=1e-3)
    tsched = clients.ClientSchedule(clients.ClientProfile.homogeneous(s),
                                    bit_cost=1e-3)
    want = jagg.apply_policy(jpol, jsched, jplan, jnp.asarray(bits))
    got = aggregation.apply_policy(tpol, tsched, tplan,
                                   torch.from_numpy(bits))
    for field in ("participating", "partf", "n_selected", "sim_time",
                  "finish", "staleness", "coef", "discount", "weight",
                  "edges_aggregated"):
        np.testing.assert_array_equal(
            np.asarray(getattr(got, field)),
            np.asarray(getattr(want, field)), err_msg=field)
    assert aggregation.uses_delta_combine(tpol) == \
        jagg.uses_delta_combine(jpol)
    assert aggregation.policy_metrics(got).keys() == \
        jagg.policy_metrics(want).keys()


def test_hierarchical_validation():
    with pytest.raises(ValueError, match="n_edges must be positive"):
        aggregation.HierarchicalPolicy(n_edges=0)
    with pytest.raises(TypeError, match="flat"):
        aggregation.HierarchicalPolicy(edge=aggregation.HierarchicalPolicy())
    with pytest.raises(ValueError, match="must divide"):
        aggregation.validate_policy(
            aggregation.HierarchicalPolicy(n_edges=3), 8)
    pol = aggregation.validate_policy(aggregation.HierarchicalPolicy(
        edge=aggregation.AggregationPolicy.async_buffered(), n_edges=4), 8)
    assert pol.edge.capacity == 2 and pol.server.capacity is None
    assert pol.may_exclude and not pol.is_sync


# --------------------------------------------------------------------------- #
# whole rounds: the population benchmark's setup, cut to size
# --------------------------------------------------------------------------- #

def _jloss(p, xb, yb):
    return 0.5 * jnp.mean((xb @ p["w"] - yb) ** 2)


def _tloss(p, xb, yb):
    pred = torch.bmm(xb, p["w"].unsqueeze(-1)).squeeze(-1)
    return 0.5 * ((pred - yb) ** 2).mean(-1)


def _build(pkg, name, store=None):
    """``benchmarks/population_scale.py``'s two algorithms at n = 2000,
    dim 16, 8 a round over 4 edges, batch 8, TopK(0.25)."""
    jx = pkg == "jax"
    cl, agg = (jclients, jagg) if jx else (clients, aggregation)
    avail = cl.ClientAvailability.diurnal(N, **AVAIL["churn"], seed=0)
    sched = cl.ClientSchedule(profile=cl.ClientProfile.homogeneous(N),
                              availability=avail, bit_cost=1e-3,
                              sampler="tree")
    pol = agg.HierarchicalPolicy(edge=agg.AggregationPolicy.sync(),
                                 server=agg.AggregationPolicy.sync(),
                                 n_edges=EDGES, edge_latency=0.5)
    data = (jfed.SyntheticFederatedData.create(N, D, hetero=0.2, noise=0.01,
                                               seed=0) if jx
            else fed_data.SyntheticFederatedData.create(
                N, D, hetero=0.2, noise=0.01, seed=0, device="cpu"))
    top = (JTopK if jx else compress.TopK)(density=0.25)
    loss = _jloss if jx else _tloss
    if name == "fedcomloc_pop":
        cfg = (JFedComLocConfig if jx else FedComLocConfig)(
            gamma=0.1, p=0.2, n_clients=N, clients_per_round=S,
            batch_size=BATCH, variant="com", error_feedback=True)
        return (JFedComLoc if jx else FedComLoc)(
            loss, data, cfg, top, schedule=sched, policy=pol, store=store)
    cfg = (JLoCoDLConfig if jx else LoCoDLConfig)(
        gamma=0.1, p=0.2, lam=0.5, n_clients=N, clients_per_round=S,
        batch_size=BATCH)
    return (JLoCoDL if jx else LoCoDL)(loss, data, cfg, top, schedule=sched,
                                       policy=pol, store=store)


@pytest.fixture(scope="module")
def jax_runs():
    out = {}
    for name in ("fedcomloc_pop", "locodl_pop"):
        alg = _build("jax", name)
        out[name] = alg.run_rounds(alg.init({"w": jnp.zeros((D,))}),
                                   jax.random.PRNGKey(1), ROUNDS)
    return out


@pytest.mark.parametrize("store", ["memory", "host_prefetch"])
@pytest.mark.parametrize("name", ["fedcomloc_pop", "locodl_pop"])
def test_population_rounds_match_reference(name, store, jax_runs):
    jstate, jm = jax_runs[name]
    talg = _build("torch", name,
                  HostStore(prefetch=True) if store == "host_prefetch"
                  else None)
    tstate, tm = talg.run_rounds(talg.init({"w": torch.zeros(D)}),
                                 prng.PRNGKey(1), ROUNDS)
    assert sorted(tm) == sorted(jm)
    for k, want in jm.items():
        got = np.asarray(tm[k], np.float64)
        want = np.asarray(want, np.float64)
        tol = golden.TOLERANCES.get(k)
        if tol is None:
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            np.testing.assert_allclose(got, want, rtol=tol[0], atol=tol[1],
                                       err_msg=k)
    np.testing.assert_allclose(tstate.x["w"].numpy(),
                               np.asarray(jstate.x["w"]), rtol=0,
                               atol=PARAM_ATOL)
    assert (np.asarray(tm["edges_aggregated"]) == EDGES).all()
    assert (np.asarray(tm["clients_aggregated"]) == S).all()
