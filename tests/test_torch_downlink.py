"""The compressed downlink (DESIGN.md §10) in the port, against the
reference.

* The validation, account/packed parity, reconcile and meter cases of
  ``tests/test_downlink.py`` for FedComLoc, LoCoDL and the three
  baselines, on the port alone.
* Each of FedComLoc, LoCoDL, FedAvg (TopK uplink), Scaffold and FedDyn
  with ``downlink`` in {account, packed} x {TopK(0.5), QuantQr(4),
  Compose(TopK(0.5), QuantQr(4))} against the JAX package's
  ``run_rounds`` on the golden quadratic setup of ``tests/test_golden.py``
  (lognormal speeds, sync): counting metrics (bits, steps,
  ``downlink_payload_bytes``) exact, ``train_loss`` within rtol 2e-4
  (``test_golden.py``'s), the final server model within atol 1e-5.
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # xdist workers share the cores: no spinning OpenMP pools

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro import compress as jcomp  # noqa: E402
from repro_torch import compress, prng  # noqa: E402
from repro_torch.compress import wire  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core.baselines import (  # noqa: E402
    FedAvg, FedConfig, FedDyn, Scaffold)
from repro_torch.core.fedcomloc import FedComLoc, FedComLocConfig  # noqa: E402
from repro_torch.core.locodl import LoCoDL, LoCoDLConfig  # noqa: E402
from tests import test_golden as golden  # noqa: E402
from tests import test_torch_policies as tp  # noqa: E402


@pytest.fixture(autouse=True)
def _partitionable_threefry():
    """The port reproduces jax's partitionable threefry stream (the
    default since jax 0.5); pin it whatever the ambient config says."""
    with jax.threefry_partitionable(True):
        yield


N, D, S, R, SEED = golden.N, golden.D, golden.S, golden.ROUNDS, golden.SEED
PARAM_ATOL = 1e-5
ALGS = ("fedcomloc", "locodl", "fedavg", "scaffold", "feddyn")
DATA = tp.quadratic_data()
DOWN = {
    "topk": (lambda c: c.TopK(0.5)),
    "qr4": (lambda c: c.QuantQr(4)),
    "compose": (lambda c: c.Compose(c.TopK(0.5), c.QuantQr(4))),
}
# (name, downlink compressor) — every codec family and scope
DOWN_CODECS = [
    ("identity", lambda: compress.Identity()),
    ("topk", lambda: compress.TopK(0.3)),
    ("topk-global", lambda: compress.TopK(0.3, scope="global")),
    ("qr-r4", lambda: compress.QuantQr(4)),
    ("qr-global", lambda: compress.QuantQr(4, scope="global")),
    ("compose", lambda: compress.Compose(compress.TopK(0.3),
                                         compress.QuantQr(4))),
    ("int8", lambda: compress.Int8Sync()),
]


def build(alg_name, downlink="dense", down_comp=None, policy=None,
          schedule=None, **kw):
    """``tests/test_downlink.py``'s ``build`` in the port."""
    if alg_name == "fedcomloc":
        cfg = FedComLocConfig(gamma=0.05, p=0.25, n_clients=N,
                              clients_per_round=S, batch_size=4,
                              variant="com")
        return FedComLoc(tp.sq_loss, DATA, cfg, compress.TopK(0.5),
                         schedule=schedule, policy=policy, downlink=downlink,
                         downlink_compressor=down_comp, **kw)
    if alg_name == "locodl":
        cfg = LoCoDLConfig(gamma=0.05, p=0.25, lam=0.5, n_clients=N,
                           clients_per_round=S, batch_size=4)
        return LoCoDL(tp.sq_loss, DATA, cfg, compress.TopK(0.5),
                      schedule=schedule, policy=policy, downlink=downlink,
                      downlink_compressor=down_comp, **kw)
    cfg = FedConfig(gamma=0.05, local_steps=4, n_clients=N,
                    clients_per_round=S, batch_size=4)
    cls = {"fedavg": FedAvg, "scaffold": Scaffold, "feddyn": FedDyn}[alg_name]
    ckw = {"compressor": compress.TopK(0.5)} if alg_name == "fedavg" else {}
    return cls(tp.sq_loss, DATA, cfg, schedule=schedule, policy=policy,
               downlink=downlink, downlink_compressor=down_comp, **ckw, **kw)


def run(alg):
    state, metrics = alg.run_rounds(alg.init({"w": torch.zeros(D)}),
                                    prng.PRNGKey(7), R)
    return state.x["w"].numpy(), metrics


# --------------------------------------------------------------------------- #
# validation
# --------------------------------------------------------------------------- #

def test_non_dense_requires_compressor():
    with pytest.raises(ValueError, match="compressor"):
        build("fedavg", downlink="account")


def test_unknown_mode_rejected():
    with pytest.raises(ValueError, match="downlink"):
        build("fedavg", downlink="sparse", down_comp=compress.TopK(0.5))
    assert engine.DOWNLINK_MODES == ("dense", "account", "packed")


def test_packed_requires_wire_supported():
    with pytest.raises(ValueError, match="impl"):
        build("fedavg", downlink="packed",
              down_comp=compress.TopK(0.5, impl="quantile"))
    with pytest.raises(ValueError, match="no wire codec"):
        build("fedavg", downlink="packed", down_comp=object())


@pytest.mark.parametrize("over,match", [({"variant": "global"}, "lobal"),
                                        ({"server_momentum": 0.5},
                                         "momentum")])
def test_fedcomloc_combos_rejected(over, match):
    cfg = FedComLocConfig(**{**dict(gamma=0.05, p=0.25, n_clients=N,
                                    clients_per_round=S, batch_size=4,
                                    variant="com"), **over})
    with pytest.raises(ValueError, match=match):
        FedComLoc(tp.sq_loss, DATA, cfg, compress.TopK(0.5),
                  downlink="account", downlink_compressor=compress.TopK(0.5))
    alg = FedComLoc(tp.sq_loss, DATA, cfg, compress.TopK(0.5))
    with pytest.raises(ValueError, match=match):
        alg.set_downlink("packed", compress.QuantQr(4))


def test_set_downlink_rebinds():
    alg = build("fedavg")
    assert alg.set_downlink("account", compress.TopK(0.5)) is alg
    assert alg.downlink == "account" and alg._round_key_fanout == 4
    w1, m1 = run(alg)
    w2, m2 = run(build("fedavg", downlink="account",
                       down_comp=compress.TopK(0.5)))
    np.testing.assert_array_equal(w1, w2)
    np.testing.assert_array_equal(m1["downlink_bits"], m2["downlink_bits"])


def test_locodl_lam_validated():
    for lam in (0.0, 1.5):
        with pytest.raises(ValueError, match="lam"):
            LoCoDLConfig(lam=lam)


# --------------------------------------------------------------------------- #
# account == packed, bit-identical, every algorithm
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("alg_name", ALGS)
def test_account_packed_bit_identical(alg_name):
    wa, ma = run(build(alg_name, downlink="account",
                       down_comp=compress.QuantQr(4)))
    wp, mp = run(build(alg_name, downlink="packed",
                       down_comp=compress.QuantQr(4)))
    np.testing.assert_array_equal(wa, wp)
    for k in ("downlink_bits", "uplink_bits", "client_uplink_bits"):
        np.testing.assert_array_equal(ma[k], mp[k], err_msg=k)
    assert "downlink_payload_bytes" not in ma
    assert (mp["downlink_payload_bytes"] * 8 - mp["downlink_bits"] >= 0).all()


@pytest.mark.parametrize("alg_name", ALGS)
def test_compressed_downlink_cheaper_than_dense(alg_name):
    _, md = run(build(alg_name))
    _, mc = run(build(alg_name, downlink="account",
                      down_comp=compress.QuantQr(4)))
    assert "downlink_payload_bytes" not in md
    assert float(np.sum(mc["downlink_bits"])) < float(np.sum(md["downlink_bits"]))


# --------------------------------------------------------------------------- #
# reconcile: measured broadcast bytes against the accounted bits
# --------------------------------------------------------------------------- #

def expected_pad_bits(comp, one):
    """Word-padding slack of one broadcast payload: ``(32 ceil(m/32) - m)
    (1 + r)`` a packed-code unit of m codes, none for dense, topk and
    int8 (every slot filled: the deltas here have no exact zeros)."""
    codec = wire.check_supported(comp)
    payload, _ = wire.encode(comp, {"w": one["w"][None]},
                             prng.split(prng.PRNGKey(0), 1))
    spec = payload.spec
    b = 1 + spec.r
    if codec == "qr":
        return float(sum((32 * -(-n // 32) - n) * b for n in (D,)))
    if codec == "topk_qr":
        return float(sum((32 * -(-c // 32) - c) * b for c in spec.caps))
    return 0.0


@pytest.mark.parametrize("name,make", DOWN_CODECS, ids=[n for n, _ in DOWN_CODECS])
@pytest.mark.parametrize("alg_name", ("fedcomloc", "locodl"))
def test_bytes_reconcile_with_bits(alg_name, name, make):
    comp = make()
    _, m = run(build(alg_name, downlink="packed", down_comp=comp))
    slack = m["downlink_payload_bytes"] * 8 - m["downlink_bits"]
    np.testing.assert_array_equal(
        slack, S * expected_pad_bits(comp, {"w": torch.zeros(D)}))
    np.testing.assert_array_equal(
        m["downlink_payload_bytes"],
        np.float32(S * wire.payload_nbytes(comp, {"w": torch.zeros(D)})))


def test_downlink_meter_accumulates_payload():
    alg = build("fedavg", downlink="packed", down_comp=compress.QuantQr(4))
    _, m = run(alg)
    assert alg.meter.downlink_bits == pytest.approx(
        float(np.sum(m["downlink_bits"])))


# --------------------------------------------------------------------------- #
# against the JAX package, on the golden quadratic setup
# --------------------------------------------------------------------------- #

def _jbuild(alg_name, downlink, jc):
    if alg_name == "locodl":
        cfg = golden.LoCoDLConfig(gamma=0.05, p=0.25, lam=0.5, n_clients=N,
                                  clients_per_round=S, batch_size=4)
        return golden.LoCoDL(golden.sq_loss, golden.quadratic_data(), cfg,
                             golden.TopK(density=0.5),
                             schedule=golden.schedule(), downlink=downlink,
                             downlink_compressor=jc)
    return golden.build(alg_name, "sync").set_downlink(downlink, jc)


def _tbuild(alg_name, downlink, tc):
    if alg_name == "locodl":
        cfg = LoCoDLConfig(gamma=0.05, p=0.25, lam=0.5, n_clients=N,
                           clients_per_round=S, batch_size=4)
        return LoCoDL(tp.sq_loss, tp.quadratic_data(), cfg,
                      compress.TopK(density=0.5), schedule=tp.schedule(),
                      downlink=downlink, downlink_compressor=tc)
    return tp.build(alg_name, "sync").set_downlink(downlink, tc)


@pytest.mark.parametrize("comp", list(DOWN))
@pytest.mark.parametrize("downlink", ["account", "packed"])
@pytest.mark.parametrize("alg_name", ALGS)
def test_downlink_rounds_match_live_reference(alg_name, downlink, comp):
    jalg = _jbuild(alg_name, downlink, DOWN[comp](jcomp))
    jstate, jm = jalg.run_rounds(
        jalg.init({"w": jax.numpy.zeros((D,), jax.numpy.float32)}),
        jax.random.PRNGKey(SEED), R)
    talg = _tbuild(alg_name, downlink, DOWN[comp](compress))
    tstate, tm = talg.run_rounds(talg.init({"w": torch.zeros(D)}),
                                 prng.PRNGKey(SEED), R)
    assert sorted(tm) == sorted(jm)
    assert ("downlink_payload_bytes" in tm) == (downlink == "packed")
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

