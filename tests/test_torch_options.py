"""FedComLoc-Com's remaining uplink options in the port against the
reference: double compression (``Compose(TopK, QuantQr)``), ``Int8Sync``,
leaky error feedback with server momentum, and geometric local phases, on
both wires, from the same carried weights and keys.

Counting metrics (cohorts, steps, bits, payload bytes) must be equal; the
train loss agrees within rtol 1e-4 and the parameters within atol 1e-5,
the tolerances of ``tests/test_torch_fedcomloc.py`` (float32 matmuls and
sums run in other orders in XLA and torch).  At r = 16 one Q_r level
(norm / 2**16, ~3e-5 here) is finer than those float32 differences can
stay clear of: an iterate 1e-8 off crosses a rounding boundary in a few of
every 10**4 survivors.  That run is held round by round from the
reference's state, every parameter within 1e-5 except coordinates moved
by one such level flip (ROADMAP Queue C).  Packed rounds of the port
equal its account rounds within rtol 1e-6 / atol 1e-7, except where the
wire saturates a Q_r code at the top level; Compose's packed rounds are
therefore held against account rounds of the transform with that
saturation applied.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # xdist workers share the cores: no spinning OpenMP pools

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import compress as jcomp  # noqa: E402
from repro.core import fed_data as jfed  # noqa: E402
from repro.core import server as jserver  # noqa: E402
from repro.core.fedcomloc import FedComLoc as JFedComLoc  # noqa: E402
from repro.core.fedcomloc import FedComLocConfig as JConfig  # noqa: E402
from repro.models import small as jsmall  # noqa: E402
from repro_torch import compress, convert, prng  # noqa: E402
from repro_torch import tree as tree_util  # noqa: E402
from repro_torch.compress import wire  # noqa: E402
from repro_torch.core import fed_data, server  # noqa: E402
from repro_torch.core.fedcomloc import (  # noqa: E402
    FedComLoc, FedComLocConfig, geometric_steps)
from repro_torch.data import dirichlet, synthetic  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import small  # noqa: E402


@pytest.fixture(autouse=True)
def _partitionable_threefry():
    """The port reproduces jax's partitionable threefry stream (the
    default since jax 0.5); pin it whatever the ambient config says."""
    with jax.threefry_partitionable(True):
        yield


LOSS_RTOL, LOSS_ATOL, PARAM_ATOL = 1e-4, 1e-6, 1e-5
WIRE_RTOL, WIRE_ATOL = 1e-6, 1e-7
HIDDEN, N_CLIENTS, COHORT, BATCH, P, ROUNDS = 16, 6, 3, 8, 0.25, 3
COUNTED = ("num_local_steps", "uplink_bits", "downlink_bits", "client_steps",
           "client_uplink_bits", "client_finish", "sim_time",
           "client_staleness", "clients_aggregated")
PACKED_COUNTED = COUNTED + ("uplink_payload_bytes", "client_payload_bytes")

#: name -> (compressor factory over a compress module, config overrides)
RUNS = {
    "k25_q4": (lambda c: c.Compose(c.TopK(0.25), c.QuantQr(4)), {}),
    "k50_q16": (lambda c: c.Compose(c.TopK(0.5), c.QuantQr(16)), {}),
    "int8": (lambda c: c.Int8Sync(), {}),
    "ef_mom": (lambda c: c.TopK(0.1),
               {"error_feedback": True, "server_momentum": 0.6}),
    "qr8_geometric": (lambda c: c.QuantQr(8), {"local_steps": "geometric"}),
}


@pytest.fixture(scope="module")
def setup():
    ds = synthetic.make_mnist_like(n_train=600, n_test=600)
    parts = dirichlet.dirichlet_partition(ds.y_train, n_clients=N_CLIENTS,
                                          alpha=0.7, seed=0)
    jm, tm = jsmall.MLP(784, HIDDEN, 10), small.MLP(784, HIDDEN, 10)
    return {
        "ds": ds,
        "jdata": jfed.from_numpy_partition(ds.x_train, ds.y_train, parts),
        "tdata": fed_data.from_numpy_partition(ds.x_train, ds.y_train, parts,
                                               device="cpu"),
        "jm": jm, "tm": tm,
        "p0": jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0))),
    }


def _config(cls, run, **extra):
    return cls(gamma=0.1, p=P, n_clients=N_CLIENTS, clients_per_round=COHORT,
               batch_size=BATCH, variant="com", **{**RUNS[run][1], **extra})


def _port(setup, run, wire_mode, comp=None):
    return FedComLoc(small.cross_entropy_loss(setup["tm"].apply),
                     setup["tdata"], _config(FedComLocConfig, run),
                     comp if comp is not None else RUNS[run][0](compress),
                     wire=wire_mode)


def _reference(setup, run, wire_mode):
    return JFedComLoc(jsmall.cross_entropy_loss(setup["jm"].apply),
                      setup["jdata"], _config(JConfig, run),
                      RUNS[run][0](jcomp), wire=wire_mode)


# --------------------------------------------------------------------------- #
# geometric local phases
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("p", [0.05, 0.1, 0.3])
def test_geometric_step_count_matches_reference(setup, p):
    """The drawn count equals the reference's ``_num_local_steps`` over
    2000 keys, float32 ``log1p`` and all (an ulp apart would flip the
    ``floor`` at a boundary)."""
    cfg = JConfig(p=p, n_clients=N_CLIENTS, clients_per_round=COHORT,
                  local_steps="geometric")
    ja = JFedComLoc(None, setup["jdata"], cfg, jcomp.QuantQr(8))
    jkeys = jax.random.split(jax.random.PRNGKey(int(p * 1000)), 2000)
    want = np.asarray(jax.jit(jax.vmap(ja._num_local_steps))(jkeys))
    keys = torch.from_numpy(np.asarray(jkeys).astype(np.int64))
    got = geometric_steps(prng.uniform(keys, 1)[:, 0], p, cfg.steps_cap)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.min() == 1 and len(np.unique(want)) > 5
    ta = FedComLoc(None, setup["tdata"], FedComLocConfig(
        p=p, n_clients=N_CLIENTS, clients_per_round=COHORT,
        local_steps="geometric"), compress.QuantQr(8))
    for i in range(0, 2000, 97):
        assert ta._num_local_steps(keys[i]) == int(want[i])


def test_geometric_count_is_capped():
    u = torch.tensor([0.0, 0.5, 1.0 - 2 ** -24, 0.999])
    assert geometric_steps(u, 0.1, 40).tolist() == [1, 7, 40, 40]
    assert FedComLocConfig(p=0.1, local_steps="geometric").steps_cap == 40
    assert FedComLocConfig(p=0.1, local_steps="geometric",
                           max_local_steps=12).steps_cap == 12


# --------------------------------------------------------------------------- #
# rounds against the reference
# --------------------------------------------------------------------------- #

def _assert_tree_close(jtree, ttree):
    jl = jax.tree.leaves(jtree)
    tl = tree_util.leaves(convert.params_to_numpy(ttree)) if ttree != () else []
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(b, np.asarray(a), rtol=0, atol=PARAM_ATOL)


@pytest.mark.parametrize("run,wire_mode", [
    ("k25_q4", "account"), ("k25_q4", "packed"), ("int8", "account"), ("int8", "packed"), ("ef_mom", "account"),
    ("ef_mom", "packed"), ("qr8_geometric", "account"),
    ("qr8_geometric", "packed")])
def test_rounds_match_reference(setup, run, wire_mode):
    ja, ta = _reference(setup, run, wire_mode), _port(setup, run, wire_mode)
    js = ja.init(jax.tree.map(jnp.asarray, setup["p0"]))
    ts = ta.init(convert.params_from_jax(setup["p0"], "cpu"))
    counted = PACKED_COUNTED if wire_mode == "packed" else COUNTED
    jkey, tkey = jax.random.PRNGKey(1), prng.PRNGKey(1)
    steps = []
    for _ in range(ROUNDS):
        jkey, jsub = jax.random.split(jkey)
        tkey, tsub = prng.split(tkey, 2)
        jc_, _ = ja.sched.sample_cohort(jax.random.split(jsub, 5)[0], COHORT)
        tc_, _ = ta.sched.sample_cohort(prng.split(tsub, 5)[0], COHORT)
        np.testing.assert_array_equal(tc_.numpy(), np.asarray(jc_))
        js, jmet = ja.round(js, jsub)
        ts, tmet = ta.round(ts, tsub)
        assert set(jmet) == set(tmet)
        for name in counted:
            np.testing.assert_array_equal(np.asarray(tmet[name]),
                                          np.asarray(jmet[name]), err_msg=name)
        np.testing.assert_allclose(tmet["train_loss"], jmet["train_loss"],
                                   rtol=LOSS_RTOL, atol=LOSS_ATOL)
        for part in ("x", "h", "e", "mom"):
            _assert_tree_close(getattr(js, part), getattr(ts, part))
        steps.append(int(tmet["num_local_steps"]))
    assert ja.meter.snapshot() == ta.meter.snapshot()
    if run == "qr8_geometric":
        assert steps != [ta.cfg.steps_cap] * ROUNDS       # drawn, not fixed


def test_r16_rounds_match_reference_up_to_level_flips(setup, monkeypatch):
    """``Compose(TopK(0.5), QuantQr(16))`` on the packed wire, each round
    from the reference's state: counting metrics exactly, the loss within
    ``LOSS_RTOL``, and every parameter within ``PARAM_ATOL`` except
    coordinates moved by a Q_r level flip.  A flip moves client i's
    decoded coordinate by ``level_i = norm_i / 2**16``; so x moves by at
    most ``level / s`` there and h (``+= (p/gamma) (x - x^_i)``) by at most
    ``(p/gamma) (1 + 1/s) level``, with ``level`` the largest of the
    round's masked norms (recorded from the port's encode) over 2**16.
    Fewer than 1 in 1000 coordinates of a leaf (at least 2) may flip, in
    x and in each cohort row of h."""
    norms = []
    orig = ops.topk_qr_slots

    def recording(*args):
        out = orig(*args)
        norms.append(out[2].clone())
        return out

    monkeypatch.setattr(ops, "topk_qr_slots", recording)
    ja, ta = _reference(setup, "k50_q16", "packed"), _port(setup, "k50_q16",
                                                           "packed")
    js = ja.init(jax.tree.map(jnp.asarray, setup["p0"]))
    ts = ta.init(convert.params_from_jax(setup["p0"], "cpu"))
    jkey, tkey = jax.random.PRNGKey(1), prng.PRNGKey(1)
    flips = 0
    for _ in range(2 * ROUNDS):
        jkey, jsub = jax.random.split(jkey)
        tkey, tsub = prng.split(tkey, 2)
        norms.clear()
        js, jmet = ja.round(js, jsub)
        ts, tmet = ta.round(ts, tsub)
        for name in PACKED_COUNTED:
            np.testing.assert_array_equal(np.asarray(tmet[name]),
                                          np.asarray(jmet[name]), err_msg=name)
        np.testing.assert_allclose(tmet["train_loss"], jmet["train_loss"],
                                   rtol=LOSS_RTOL, atol=LOSS_ATOL)
        levels = [float(nm.max()) / 2 ** 16 for nm in norms]
        assert len(levels) == 6
        bounds = {"x": 1.0 / COHORT, "h": P / 0.1 * (1.0 + 1.0 / COHORT)}
        for part, factor in bounds.items():
            jl = jax.tree.leaves(getattr(js, part))
            tl = tree_util.leaves(convert.params_to_numpy(getattr(ts, part)))
            for a, b, level in zip(jl, tl, levels):
                d = np.abs(b - np.asarray(a))
                moved = d > PARAM_ATOL
                # a flip in x moves that coordinate of every cohort row of h
                cap = max(2, d[0].size // 1000 if part == "h" else d.size // 1000)
                assert moved.sum() <= cap * (COHORT if part == "h" else 1)
                assert (d <= PARAM_ATOL + factor * level * 1.001).all()
                flips += int(moved.sum()) if part == "x" else 0
        ts = ts._replace(
            x=convert.params_from_jax(jax.tree.map(np.asarray, js.x), "cpu"),
            h=convert.params_from_jax(jax.tree.map(np.asarray, js.h), "cpu"))
    assert ja.meter.snapshot() == ta.meter.snapshot()
    assert flips > 0          # the allowance is exercised, not idle


def test_run_federated_ef_momentum_matches_reference(setup):
    """``run_federated`` with error feedback and server momentum on the
    packed wire: evaluation after rounds 1, 3 and 4."""
    ja, ta = _reference(setup, "ef_mom", "account"), _port(
        setup, "ef_mom", "account")
    ds = setup["ds"]
    jeval = jserver.make_eval_fn(setup["jm"].apply, jnp.asarray(ds.x_test),
                                 jnp.asarray(ds.y_test))
    teval = server.make_eval_fn(setup["tm"].apply, torch.from_numpy(ds.x_test),
                                torch.from_numpy(ds.y_test))
    jh = jserver.run_federated(ja, jax.tree.map(jnp.asarray, setup["p0"]), 4,
                               jax.random.PRNGKey(1), jeval, eval_every=2,
                               wire="packed")
    th = server.run_federated(ta, convert.params_from_jax(setup["p0"], "cpu"),
                              4, prng.PRNGKey(1), teval, eval_every=2,
                              wire="packed")
    assert th.rounds == jh.rounds == [1, 3, 4]
    for name in ("uplink_bits", "downlink_bits", "total_bits", "sim_time"):
        assert getattr(th, name) == getattr(jh, name), name
    np.testing.assert_allclose(th.train_loss, jh.train_loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(th.test_acc, jh.test_acc, atol=2 / 512)
    _assert_tree_close(jh.final_params, th.final_params)


# --------------------------------------------------------------------------- #
# packed rounds against account rounds, in the port
# --------------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class WireSaturated(compress.Compressor):
    """``Compose(TopK, QuantQr)``'s transform as the wire delivers it: a
    value at the top level ``2**r`` (``|out| == norm``) becomes ``norm *
    (2**r - 1) / 2**r``, in ``_qr_values``'s operation order.  Counts the
    saturated codes it meets."""

    comp: compress.Compose
    seen: list = dataclasses.field(default_factory=lambda: [0])

    def compress(self, stacked, keys=None):
        out, rep = self.comp.compress(stacked, keys)
        s = tree_util.leaves(stacked)[0].shape[0]
        r, k = self.comp.second.r, self.comp.first

        def saturate(x, o):
            flat, of = x.reshape(s, -1), o.reshape(s, -1)
            norm = ops._quant.l2_norm(ops.topk_mask(flat, k._k(flat.shape[1])))
            nrm = norm[:, None]
            top = (of.abs() == nrm) & (nrm > 0)
            self.seen[0] += int(top.sum())
            sat = nrm * torch.sign(of) * ((2 ** r - 1) / float(2 ** r))
            return torch.where(top, sat, of).reshape(o.shape)

        return tree_util.map(saturate, stacked, out), rep


def _packed_and_account(setup, run, rounds):
    """``run_rounds`` of the port on both wires from the same weights and
    key; Compose's account run goes through :class:`WireSaturated`.
    Returns ``{mode: (state, metrics)}`` and the saturation count."""
    p0 = convert.params_from_jax(setup["p0"], "cpu")
    saturated = None
    if isinstance(RUNS[run][0](compress), compress.Compose):
        saturated = WireSaturated(RUNS[run][0](compress))
    out = {}
    for mode in ("account", "packed"):
        alg = _port(setup, run, mode,
                    saturated if mode == "account" else None)
        out[mode] = alg.run_rounds(alg.init(p0), prng.PRNGKey(7), rounds)
    return out, (saturated.seen[0] if saturated is not None else 0)


@pytest.mark.parametrize("run", sorted(RUNS))
def test_packed_rounds_equal_account_rounds(setup, run):
    out, _ = _packed_and_account(setup, run, ROUNDS)
    (sa, ma), (sp, mp) = out["account"], out["packed"]
    for part in ("x", "h", "e", "mom"):
        pa, pp = getattr(sa, part), getattr(sp, part)
        for a, b in zip(tree_util.leaves(pa) if pa != () else [],
                        tree_util.leaves(pp) if pp != () else []):
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=WIRE_RTOL,
                                       atol=WIRE_ATOL)
    for key in ("uplink_bits", "downlink_bits", "client_uplink_bits",
                "sim_time", "clients_aggregated", "num_local_steps"):
        np.testing.assert_array_equal(mp[key], ma[key], err_msg=key)
    per = wire.payload_nbytes(RUNS[run][0](compress),
                              convert.params_from_jax(setup["p0"], "cpu"))
    assert (mp["client_payload_bytes"] == per).all()
    assert (mp["uplink_payload_bytes"] * 8 >= mp["uplink_bits"]).all()


def test_compose_packed_rounds_saturate_as_the_wire_says(setup):
    """At TopK(0.25) the 10-wide output bias keeps 2 survivors, so the top
    Q_r level (one survivor holding more than (15/16)**2 of the pair's
    energy, then a round-up) is reached within a few rounds.  Over 10
    rounds the packed run equals the account run with the wire's
    saturation applied, and does see saturated codes."""
    out, seen = _packed_and_account(setup, "k25_q4", 10)
    (sa, ma), (sp, mp) = out["account"], out["packed"]
    assert seen > 0
    for a, b in zip(tree_util.leaves(sa.x) + tree_util.leaves(sa.h),
                    tree_util.leaves(sp.x) + tree_util.leaves(sp.h)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=WIRE_RTOL,
                                   atol=WIRE_ATOL)
    np.testing.assert_array_equal(mp["uplink_bits"], ma["uplink_bits"])


def test_cpu_run_leaves_every_launch_counter_at_zero(setup):
    ops.reset_launch_counts()
    for run in RUNS:
        for mode in ("account", "packed"):
            alg = _port(setup, run, mode)
            alg.run_rounds(alg.init(convert.params_from_jax(setup["p0"],
                                                            "cpu")),
                           prng.PRNGKey(0), 1)
    counts = ops.launch_counts()
    assert len(counts) == 19 and all(v == 0 for v in counts.values()), counts


def test_ef_state_layout(setup):
    ta = _port(setup, "ef_mom", "account")
    st = ta.init(convert.params_from_jax(setup["p0"], "cpu"))
    for e, x in zip(tree_util.leaves(st.e), tree_util.leaves(st.x)):
        assert e.shape == (N_CLIENTS,) + x.shape and not e.any()
    for m, x in zip(tree_util.leaves(st.mom), tree_util.leaves(st.x)):
        assert m.shape == x.shape and not m.any()
    plain = _port(setup, "k25_q4", "account").init(
        convert.params_from_jax(setup["p0"], "cpu"))
    assert plain.e == () and plain.mom == ()
    with pytest.raises(ValueError, match="Com variant"):
        FedComLocConfig(variant="local", error_feedback=True)


def test_k25_q4_diverges_at_the_quickstart_config_in_both_packages():
    """Figure 16's k25_q4 at the quickstart configuration (MLP
    784-64-64-10, 20 Dirichlet(0.7) clients, 5 a round, batch 32, gamma =
    p = 0.1) is unstable in the reference itself: its train loss passes 1
    by round 5.  The port follows it round for round (loss within
    ``LOSS_RTOL``), so the divergence the card shows is the algorithm's at
    this configuration, not the port's."""
    ds = synthetic.make_mnist_like(n_train=8000, n_test=1000)
    parts = dirichlet.dirichlet_partition(ds.y_train, n_clients=20, alpha=0.7,
                                          seed=0)
    jm, tm = jsmall.MLP(784, 64, 10), small.MLP(784, 64, 10)
    kw = dict(gamma=0.1, p=0.1, n_clients=20, clients_per_round=5,
              batch_size=32, variant="com")
    ja = JFedComLoc(jsmall.cross_entropy_loss(jm.apply),
                    jfed.from_numpy_partition(ds.x_train, ds.y_train, parts),
                    JConfig(**kw), RUNS["k25_q4"][0](jcomp))
    ta = FedComLoc(small.cross_entropy_loss(tm.apply),
                   fed_data.from_numpy_partition(ds.x_train, ds.y_train, parts,
                                                 device="cpu"),
                   FedComLocConfig(**kw), RUNS["k25_q4"][0](compress))
    p0 = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    js = ja.init(jax.tree.map(jnp.asarray, p0))
    ts = ta.init(convert.params_from_jax(p0, "cpu"))
    jkey, tkey = jax.random.PRNGKey(1), prng.PRNGKey(1)
    jl, tl = [], []
    for _ in range(6):
        jkey, jsub = jax.random.split(jkey)
        tkey, tsub = prng.split(tkey, 2)
        js, jmet = ja.round(js, jsub)
        ts, tmet = ta.round(ts, tsub)
        jl.append(jmet["train_loss"])
        tl.append(tmet["train_loss"])
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert jl[0] < 1.0 < jl[4] < jl[5]
