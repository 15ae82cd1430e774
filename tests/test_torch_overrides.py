"""Per-client compressor overrides (DESIGN.md §5) in the port, against the
reference.

* ``ClientProfile.with_density_allocation``: uniform, bandwidth-
  proportional, and with the clip binding (the host bisection), equal to
  the JAX package's values bit for bit.
* ``TopK``'s ``density``, ``QuantQr``'s ``r`` and ``Compose``'s routed
  overrides against ``vmap_compress`` on the same keys: masks and reports
  bit-equal, ``k = round(float32(d) * float32(n))`` half to even
  (densities at exact halves of ``d * n`` included); Q_r bit-equal given
  the reference's norms, and within a level of it otherwise (torch's and
  XLA's float32 sums differ in the last place).
* Validation: unknown override names, values out of range, a profile on
  an algorithm with no compressor, the packed wire with overrides.
* Three rounds of ``benchmarks/het_system.py``'s FedComLoc (lognormal
  speeds and bandwidths, bandwidth-proportional densities, "wait" and
  "drop") against the live reference, on a smaller MLP and data set.
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # xdist workers share the cores: no spinning OpenMP pools

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import compress as jcomp  # noqa: E402
from repro.core import clients as jclients  # noqa: E402
from repro.core import fed_data as jfed  # noqa: E402
from repro.core.fedcomloc import FedComLoc as JFedComLoc  # noqa: E402
from repro.core.fedcomloc import FedComLocConfig as JConfig  # noqa: E402
from repro.models import small as jsmall  # noqa: E402
from repro_torch import compress, convert, prng  # noqa: E402
from repro_torch import tree as tree_util  # noqa: E402
from repro_torch.compress.compressors import override_k  # noqa: E402
from repro_torch.core import clients, fed_data  # noqa: E402
from repro_torch.core.baselines import FedConfig, Scaffold  # noqa: E402
from repro_torch.core.fedcomloc import FedComLoc, FedComLocConfig  # noqa: E402
from repro_torch.data import dirichlet, synthetic  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import small  # noqa: E402


@pytest.fixture(autouse=True)
def _partitionable_threefry():
    """The port reproduces jax's partitionable threefry stream (the
    default since jax 0.5); pin it whatever the ambient config says."""
    with jax.threefry_partitionable(True):
        yield


S = 4
# leaf sizes 120, 50, 30 and 12: d * n lands on exact halves at d = 0.05
# (n = 50 and 30) and at d = 0.125 (n = 12)
SHAPES = {"a": (30, 4), "b": (50,), "c": (30,), "d": (12,)}
DENSITY = np.array([0.05, 0.125, 1.0, 0.3], np.float32)
R_OV = np.array([4, 8, 1, 16], np.int32)


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal((S,) + shp).astype(np.float32)
            for k, shp in SHAPES.items()}


def _keys(seed):
    keys = jax.random.split(jax.random.PRNGKey(seed), S)
    return keys, torch.from_numpy(np.asarray(keys).astype(np.int64))


def _both(jc, tc, ov, seed=0):
    tree = _tree(seed)
    jkeys, tkeys = _keys(seed)
    names = tuple(sorted(ov))
    plan = jclients.RoundPlan(
        steps=jnp.ones(S, jnp.int32), participating=jnp.ones(S, bool),
        speed=jnp.ones(S), bandwidth=jnp.ones(S),
        comp_overrides={n: jnp.asarray(ov[n]) for n in names})
    jout, jrep = jclients.vmap_compress(
        jc, plan, jax.tree.map(jnp.asarray, tree), jkeys)
    tplan = clients.RoundPlan(
        steps=torch.ones(S, dtype=torch.int32),
        participating=torch.ones(S, dtype=torch.bool), speed=torch.ones(S),
        bandwidth=torch.ones(S),
        comp_overrides={n: torch.from_numpy(ov[n]) for n in names})
    tout, trep = clients.batched_compress(
        tc, tplan, convert.params_from_jax(tree, "cpu"), tkeys)
    return tree, jout, jrep, tout, trep


def _reports_equal(jrep, trep):
    for name in ("value_bits", "index_bits", "meta_bits", "total_bits"):
        want = np.broadcast_to(np.asarray(getattr(jrep, name), np.float32),
                               (S,))
        np.testing.assert_array_equal(getattr(trep, name).numpy(), want,
                                      err_msg=name)


# --------------------------------------------------------------------------- #
# density allocation
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("profile,mode", [
    (lambda m: m.ClientProfile.lognormal(20, speed_sigma=1.0,
                                         bandwidth_sigma=0.7, seed=0),
     "uniform"),
    (lambda m: m.ClientProfile.lognormal(20, speed_sigma=1.0,
                                         bandwidth_sigma=0.7, seed=0),
     "bandwidth"),
    (lambda m: m.ClientProfile.uniform(20, lo=0.7, hi=1.4, bandwidth_lo=0.5,
                                       bandwidth_hi=2.0, seed=0),
     "bandwidth"),
    # sigma 2: the largest bandwidths ask for d > 1 and the clip binds
    (lambda m: m.ClientProfile.lognormal(12, bandwidth_sigma=2.0, seed=3),
     "bandwidth")], ids=["uniform", "bandwidth", "bandwidth_uniform_bw",
                         "binding_clip"])
def test_density_allocation_equals_reference(profile, mode):
    want = np.asarray(profile(jclients).with_density_allocation(
        0.2, mode=mode).comp_params["density"])
    got = profile(clients).with_density_allocation(
        0.2, mode=mode).comp_params["density"]
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert abs(float(np.mean(want.astype(np.float64))) - 0.2) < 1e-6
    if mode == "bandwidth" and profile(clients).n_clients == 12:
        assert (want == 1.0).any()          # the clip binds


def test_density_allocation_validates():
    prof = clients.ClientProfile.homogeneous(4)
    with pytest.raises(ValueError, match="outside"):
        prof.with_density_allocation(0.001, mode="bandwidth")
    with pytest.raises(ValueError, match="mode"):
        prof.with_density_allocation(0.2, mode="speed")


def test_override_k_rounds_half_to_even_in_float32():
    """float32(0.05) * 50 is 2.5 in float32 (2 after half-to-even) but
    2.50000004 in float64 (Python's round gives 3)."""
    d = torch.tensor([0.05, 0.05, 0.125, 0.3], dtype=torch.float32)
    got = override_k(d, 50).tolist()
    want = np.asarray(jnp.round(jnp.asarray(d.numpy()) * 50)
                      .astype(jnp.int32)).tolist()
    assert got == want == [2, 2, 6, 15]
    assert round(float(d[0]) * 50) == 3


# --------------------------------------------------------------------------- #
# overrides against vmap_compress
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("scope", ["tensor", "global"])
@pytest.mark.parametrize("impl", ["select", "quantile"])
def test_topk_density_override_bit_equal(scope, impl):
    _, jout, jrep, tout, trep = _both(
        jcomp.TopK(0.3, scope=scope, impl=impl),
        compress.TopK(0.3, scope=scope, impl=impl), {"density": DENSITY})
    for k in SHAPES:
        np.testing.assert_array_equal(tout[k].numpy().view(np.uint32),
                                      np.asarray(jout[k]).view(np.uint32),
                                      err_msg=k)
    _reports_equal(jrep, trep)
    # client 2 has d = 1: dense payload, no index bits
    assert float(trep.index_bits[2]) == 0.0


def _assert_qr_close(a, b, norm, r):
    """Q_r of the two packages: bit-equal when the norms agree to the bit,
    else every entry within an ulp except a handful a level apart."""
    if np.array_equal(a.view(np.uint32), b.view(np.uint32)):
        return
    flips = ~np.isclose(a, b, rtol=1e-6, atol=1e-7)
    assert flips.sum() <= 3, flips.sum()
    np.testing.assert_allclose(np.abs(a - b)[flips], norm / 2.0 ** r,
                               rtol=1e-5)


@pytest.mark.parametrize("scope", ["tensor", "global"])
def test_quantqr_r_override(scope):
    tree, jout, jrep, tout, trep = _both(
        jcomp.QuantQr(8, scope=scope), compress.QuantQr(8, scope=scope),
        {"r": R_OV})
    _reports_equal(jrep, trep)
    units = ([np.concatenate([tree[k].reshape(S, -1) for k in sorted(SHAPES)],
                             1)] if scope == "global"
             else [tree[k].reshape(S, -1) for k in sorted(SHAPES)])
    jflat = [np.asarray(jout[k]).reshape(S, -1) for k in sorted(SHAPES)]
    tflat = [tout[k].numpy().reshape(S, -1) for k in sorted(SHAPES)]
    if scope == "global":
        jflat, tflat = [np.concatenate(jflat, 1)], [np.concatenate(tflat, 1)]
    _, tkeys = _keys(0)
    leaf_keys = prng.split(tkeys, len(SHAPES))
    for j, (x, a, b) in enumerate(zip(units, jflat, tflat)):
        for c in range(S):
            norm = float(np.sqrt(np.sum(x[c].astype(np.float64) ** 2)))
            _assert_qr_close(a[c], b[c], norm, int(R_OV[c]))
        # given the reference's norms, bit-equal, all rows in one call
        jnorm = np.asarray(jnp.sqrt(jnp.sum(jnp.asarray(x) ** 2, axis=1)))
        got = ref.quantize_qr_with_uniforms(
            torch.from_numpy(x), torch.from_numpy(R_OV),
            prng.uniform(leaf_keys[:, j], x.shape[1]), torch.tensor(jnorm))
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      a.view(np.uint32))


@pytest.mark.parametrize("ov", [{"density": DENSITY}, {"r": R_OV},
                                {"density": DENSITY, "r": R_OV}],
                         ids=["density", "r", "both"])
def test_compose_routes_overrides(ov):
    tree, jout, jrep, tout, trep = _both(
        jcomp.Compose(jcomp.TopK(0.5), jcomp.QuantQr(4)),
        compress.Compose(compress.TopK(0.5), compress.QuantQr(4)), ov)
    _reports_equal(jrep, trep)
    rs = R_OV if "r" in ov else np.full(S, 4)
    for k in SHAPES:
        a, b = np.asarray(jout[k]).reshape(S, -1), tout[k].numpy().reshape(S, -1)
        np.testing.assert_array_equal(a != 0, b != 0, err_msg=k)
        for c in range(S):
            norm = float(np.sqrt(np.sum(a[c].astype(np.float64) ** 2)))
            _assert_qr_close(a[c], b[c], max(norm, 1e-30), int(rs[c]))


def test_plan_gathers_the_cohorts_overrides():
    prof = clients.ClientProfile.lognormal(8, bandwidth_sigma=0.7,
                                           seed=1).with_density_allocation(
        0.2, mode="bandwidth").with_comp_param("r", np.arange(1, 9))
    sched = clients.ClientSchedule(prof)
    cohort = torch.tensor([5, 0, 7])
    plan = sched.plan(cohort, 4)
    assert sorted(plan.comp_overrides) == ["density", "r"]
    np.testing.assert_array_equal(plan.comp_overrides["density"].numpy(),
                                  prof.comp_params["density"][cohort].numpy())
    assert plan.comp_overrides["r"].tolist() == [6, 1, 8]
    assert plan.comp_overrides["r"].dtype == torch.int32


# --------------------------------------------------------------------------- #
# validation
# --------------------------------------------------------------------------- #

def _sched(**params):
    prof = clients.ClientProfile.homogeneous(4)
    for name, v in params.items():
        prof = prof.with_comp_param(name, v)
    return clients.ClientSchedule(prof)


@pytest.mark.parametrize("comp,sched,match", [
    (compress.TopK(0.3), lambda: _sched(r=np.full(4, 4)), "not accepted"),
    (compress.TopK(0.3), lambda: _sched(density=np.full(4, 1.5)),
     "density override"),
    (compress.QuantQr(4), lambda: _sched(r=np.full(4, 0)), "r override"),
    (compress.QuantQr(4), lambda: _sched(r=np.full(4, 4.0)), "r override"),
    (compress.Compose(compress.TopK(0.3), compress.QuantQr(4)),
     lambda: _sched(density=np.zeros(4)), "density override"),
    (compress.Int8Sync(), lambda: _sched(r=np.full(4, 4)), "not accepted")],
    ids=["unknown_name", "density_range", "r_below_1", "r_not_integer",
         "compose_density", "int8sync"])
def test_validate_schedule_rejects(comp, sched, match):
    with pytest.raises(ValueError, match=match):
        clients.validate_schedule(sched(), 4, comp)


def test_overrides_need_a_compressor_and_the_right_shape():
    with pytest.raises(ValueError, match="no compressor"):
        Scaffold(None, _het_setup()["tdata"],
                 FedConfig(n_clients=20, clients_per_round=5),
                 schedule=clients.ClientSchedule(
                     clients.ClientProfile.homogeneous(20)
                     .with_density_allocation(0.2)))
    with pytest.raises(ValueError, match="must have shape"):
        clients.ClientProfile.homogeneous(4).with_comp_param(
            "density", np.ones(3))


def test_packed_wire_with_overrides_raises():
    sched = _sched(density=np.full(4, 0.3))
    cfg = FedComLocConfig(n_clients=4, clients_per_round=2, variant="com")
    data = _het_setup()["tdata"]
    with pytest.raises(ValueError, match="overrides"):
        FedComLoc(None, data, cfg, compress.TopK(0.3), schedule=sched,
                  wire="packed")
    alg = FedComLoc(None, data, cfg, compress.TopK(0.3), schedule=sched)
    with pytest.raises(ValueError, match="overrides"):
        alg.set_wire("packed")
    plan = sched.plan(torch.tensor([0, 1]), 1)
    with pytest.raises(ValueError, match="overrides"):
        clients.vmap_encode(compress.TopK(0.3), plan,
                            {"w": torch.zeros(2, 5)},
                            prng.split(prng.PRNGKey(0), 2))


# --------------------------------------------------------------------------- #
# het_system's FedComLoc against the live reference
# --------------------------------------------------------------------------- #

N_CLIENTS, HIDDEN = 20, 16

_HET = {}


def _het_setup():
    if not _HET:
        ds = synthetic.make_mnist_like(n_train=1600, n_test=100)
        parts = dirichlet.dirichlet_partition(ds.y_train, n_clients=N_CLIENTS,
                                              alpha=0.7, seed=0)
        jm = jsmall.MLP(784, HIDDEN, 10)
        _HET.update(
            jdata=jfed.from_numpy_partition(ds.x_train, ds.y_train, parts),
            tdata=fed_data.from_numpy_partition(ds.x_train, ds.y_train, parts,
                                                device="cpu"),
            jm=jm, tm=small.MLP(784, HIDDEN, 10),
            p0=jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0))))
    return _HET


@pytest.mark.parametrize("policy", ["wait", "drop"])
def test_het_system_rounds_match_reference(policy):
    """``het_system/lognormal_bandwidth_{wait,drop}``, 3 rounds: bits per
    client exact (each client's TopK at its own density), the loss within
    rtol 1e-4 and the parameters within atol 1e-5."""
    st = _het_setup()
    kw = ({"deadline": 10.0, "drop_stragglers": True}
          if policy == "drop" else {})

    def sched(m):
        prof = m.ClientProfile.lognormal(N_CLIENTS, speed_sigma=1.0,
                                         bandwidth_sigma=0.7, seed=0)
        return m.ClientSchedule(
            profile=prof.with_density_allocation(0.2, mode="bandwidth"),
            bit_cost=1e-7, **kw)

    cfg = dict(gamma=0.1, p=0.1, n_clients=N_CLIENTS, clients_per_round=5,
               batch_size=32, variant="com")
    ja = JFedComLoc(jsmall.cross_entropy_loss(st["jm"].apply), st["jdata"],
                    JConfig(**cfg), jcomp.TopK(0.2), schedule=sched(jclients))
    ta = FedComLoc(small.cross_entropy_loss(st["tm"].apply), st["tdata"],
                   FedComLocConfig(**cfg), compress.TopK(0.2),
                   schedule=sched(clients))
    js, jm = ja.run_rounds(ja.init(jax.tree.map(jnp.asarray, st["p0"])),
                           jax.random.PRNGKey(1), 3)
    ts, tm = ta.run_rounds(ta.init(convert.params_from_jax(st["p0"], "cpu")),
                           prng.PRNGKey(1), 3)
    assert sorted(tm) == sorted(jm)
    for name, want in jm.items():
        if name == "train_loss":
            np.testing.assert_allclose(tm[name], np.asarray(want), rtol=1e-4,
                                       atol=1e-6)
        elif name in ("sim_time", "client_finish"):
            np.testing.assert_allclose(tm[name], np.asarray(want), rtol=1e-6)
        else:
            np.testing.assert_array_equal(tm[name], np.asarray(want),
                                          err_msg=name)
    for a, b in zip(jax.tree.leaves(js.x), tree_util.leaves(ts.x)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-5)
    # each participating client's bits: sum over leaves of k_i(leaf) * 64,
    # k_i = round(float32(d_i) * float32(n)) clipped to [1, n]
    dens = ta.sched.profile.comp_params["density"]
    sizes = [x.size for x in jax.tree.leaves(st["p0"])]
    key = prng.PRNGKey(1)
    for r in range(3):
        key, sub = prng.split(key, 2)
        cohort, _ = ta.sched.sample_cohort(prng.split(sub, 5)[0], 5)
        want = [sum(int(torch.clamp(override_k(dens[c:c + 1], n), 1, n))
                    for n in sizes) * 64.0 for c in cohort.tolist()]
        part = tm["client_steps"][r] > 0
        np.testing.assert_array_equal(tm["client_uplink_bits"][r][part],
                                      np.asarray(want)[part])
        assert len(set(np.asarray(want)[part].tolist())) > 1
