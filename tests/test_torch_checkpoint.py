"""The port's checkpoints (``repro_torch.checkpoint``), and resuming across
the two packages.

* Round trip: nested trees with NamedTuples, ``()`` subtrees, Python ints
  (written as int32), key data (written as uint32 words), bool and
  bfloat16 leaves (bfloat16 through its bits: ``ml_dtypes`` is imported
  nowhere in the port); the structure and dtype errors; an atomic save.
* Resume in the port: save at round 2, load into a fresh algorithm and
  store, finish the run: bit-equal to the uninterrupted port run, for
  FedComLoc-EF, Scaffold, FedDyn and LoCoDL, with the in-memory store and
  with a HostStore (plain and pipelined, its buffers through
  ``state_dict``).
* Across packages: a checkpoint the reference wrote at round 2 resumes in
  the port, and one the port wrote resumes in the reference; each
  finishes equal to the other package's uninterrupted run at the parity
  tolerances (counting metrics exact, losses at ``tests/test_golden.py``'s
  rtol, the model within 1e-5).
"""

import ast
import pathlib

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # xdist workers share the cores: no spinning OpenMP pools

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro_torch import prng  # noqa: E402
from repro_torch.checkpoint import checkpoint  # noqa: E402
from repro_torch.core.client_store import HostStore, InMemoryStore  # noqa: E402
from tests import test_golden as golden  # noqa: E402
from tests import test_torch_client_store as tstore  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
R, R_SAVE = 5, 2
PARAM_ATOL = 1e-5


@pytest.fixture(autouse=True)
def _partitionable_threefry():
    with jax.threefry_partitionable(True):
        yield


# --------------------------------------------------------------------------- #
# round trip
# --------------------------------------------------------------------------- #

def test_roundtrip_nested_tree_and_meta(tmp_path):
    tree = {
        "params": {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
                   "b": torch.tensor([1.5, -2.0], dtype=torch.bfloat16)},
        "step": 7,
        "key": prng.PRNGKey(2 ** 32 - 3),
        "stack": (torch.zeros(2, 3), torch.tensor([True, False])),
        "empty": (),
    }
    path = tmp_path / "ckpt.npz"
    checkpoint.save(path, tree, meta={"round": 7, "tag": "x"})
    out, meta = checkpoint.load(path, like=tree)
    assert meta == {"round": 7, "tag": "x"}
    assert out["step"] == 7 and isinstance(out["step"], int)
    assert out["empty"] == ()
    assert out["key"].dtype == torch.int64
    assert torch.equal(out["key"], tree["key"])
    assert out["params"]["b"].dtype == torch.bfloat16
    assert torch.equal(out["params"]["b"], tree["params"]["b"])
    assert torch.equal(out["params"]["w"], tree["params"]["w"])
    assert torch.equal(out["stack"][1], tree["stack"][1])
    with np.load(path) as z:
        manifest = z["__manifest__"]
        assert z["leaf_0"].dtype == np.uint32       # key data: the words
        assert z["leaf_5"].dtype == np.int32        # the int
    assert '"bfloat16"' in str(manifest)


def test_load_without_like_returns_leaves(tmp_path):
    path = tmp_path / "c.npz"
    checkpoint.save(path, {"a": torch.ones(3), "b": torch.zeros(2)})
    leaves, meta = checkpoint.load(path)
    assert isinstance(leaves, list) and len(leaves) == 2 and meta == {}


def test_structure_mismatch_raises(tmp_path):
    path = tmp_path / "c.npz"
    checkpoint.save(path, {"a": torch.ones(3)})
    with pytest.raises(checkpoint.CheckpointStructureError, match="1 leaves"):
        checkpoint.load(path, like={"a": torch.ones(3), "b": torch.ones(2)})


def test_extension_dtype_without_names_raises(tmp_path):
    path = tmp_path / "old.npz"
    np.savez(path, __manifest__='{"meta": {}, "n_leaves": 1}',
             leaf_0=np.zeros(2, np.uint16).view("V2"))
    with pytest.raises(checkpoint.CheckpointDtypeError, match="predates"):
        checkpoint.load(path)


@pytest.mark.parametrize("bad,error,match", [
    (torch.tensor([-1, 0]), ValueError, "uint32 words"),     # not key words
    (torch.tensor([3]), TypeError, "not key data"),          # an int64 count
], ids=["key_out_of_range", "int64_not_a_key"])
def test_failed_save_keeps_the_old_checkpoint(tmp_path, bad, error, match):
    path = tmp_path / "c.npz"
    checkpoint.save(path, {"a": torch.ones(2)}, meta={"v": 1})
    with pytest.raises(error, match=match):
        checkpoint.save(path, {"a": bad})
    _, meta = checkpoint.load(path)
    assert meta == {"v": 1}
    assert sorted(p.name for p in tmp_path.iterdir()) == ["c.npz"]


def test_int64_template_leaf_must_be_a_key(tmp_path):
    """An int64 template leaf that is not ``(..., 2)`` key data is refused
    rather than read back through ``prng.key_data``."""
    path = tmp_path / "c.npz"
    checkpoint.save(path, {"k": prng.PRNGKey(5)})
    with pytest.raises(TypeError, match="not key data"):
        checkpoint.load(path, like={"k": torch.zeros(2, 3,
                                                     dtype=torch.int64)})
    out, _ = checkpoint.load(path, like={"k": prng.PRNGKey(0)})
    assert torch.equal(out["k"], prng.PRNGKey(5))


def test_bf16_crosses_packages_without_ml_dtypes(tmp_path):
    """The port never imports ``ml_dtypes``; the reference (which does)
    reads the port's bfloat16 leaf, and the port reads the reference's."""
    for f in sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
            ROOT / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(f.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import)
                     else [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            assert not any(n.split(".")[0] == "ml_dtypes" for n in names), f
    from repro.checkpoint import checkpoint as jcheckpoint
    vals = np.array([1.5, -2.0, 3.140625], np.float32)
    checkpoint.save(tmp_path / "t.npz",
                    {"b": torch.from_numpy(vals).to(torch.bfloat16)})
    jtree, _ = jcheckpoint.load(tmp_path / "t.npz",
                                like={"b": jnp.zeros(3, jnp.bfloat16)})
    assert jtree["b"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(jtree["b"], np.float32), vals)
    jcheckpoint.save(tmp_path / "j.npz",
                     {"b": jnp.asarray(vals, jnp.bfloat16)})
    ttree, _ = checkpoint.load(tmp_path / "j.npz",
                               like={"b": torch.zeros(3, dtype=torch.bfloat16)})
    assert ttree["b"].dtype == torch.bfloat16
    np.testing.assert_array_equal(ttree["b"].float().numpy(), vals)


# --------------------------------------------------------------------------- #
# resume in the port
# --------------------------------------------------------------------------- #

BACKENDS = {"memory": InMemoryStore, "host": HostStore,
            "prefetch": lambda: HostStore(prefetch=True)}


def _schedule(name):
    # the tree sampler gives the pipelined store a plan to prefetch
    return tstore.churny_schedule("tree")


@pytest.mark.parametrize("backend", sorted(BACKENDS))
@pytest.mark.parametrize("name", tstore.STATEFUL)
def test_resume_matches_uninterrupted(name, backend, tmp_path):
    make = BACKENDS[backend]
    ref_alg = tstore.build(name, make(), _schedule(name))
    st_ref, m_ref = tstore.run_fused(ref_alg, rounds=R)

    a = tstore.build(name, make(), _schedule(name))
    key0 = prng.PRNGKey(11)
    state, _ = a.run_rounds(a.init(tstore.P0()), key0, R_SAVE)
    key = key0
    for _ in range(R_SAVE):                   # stay on the round key chain
        key, _ = prng.split(key, 2)
    payload = {"state": state, "key": key}
    if backend != "memory":
        payload["store"] = a.store.state_dict()
    path = tmp_path / "mid.npz"
    checkpoint.save(path, payload, meta={"rounds_done": R_SAVE})

    b = tstore.build(name, make(), _schedule(name))   # a fresh process
    like = {"state": b.init(tstore.P0()), "key": key0}
    if backend != "memory":
        like["store"] = b.store.state_dict()
    restored, meta = checkpoint.load(path, like=like)
    assert meta["rounds_done"] == R_SAVE
    assert restored["state"].round == R_SAVE
    assert type(restored["state"]).__name__ == type(state).__name__
    if backend != "memory":
        b.store.load_state_dict(restored["store"])
    st_b, m_b = b.run_rounds(restored["state"], restored["key"], R - R_SAVE)
    np.testing.assert_array_equal(st_ref.x["w"].numpy(), st_b.x["w"].numpy())
    for k in m_ref:
        np.testing.assert_array_equal(np.asarray(m_ref[k])[R_SAVE:],
                                      np.asarray(m_b[k]), err_msg=k)


# --------------------------------------------------------------------------- #
# across packages
# --------------------------------------------------------------------------- #

# (algorithm, store) pairs run in both packages
CROSS = [("fedcomloc_ef", "memory"), ("fedcomloc_ef", "host"),
         ("locodl", "memory")]


def _jbuild(name, backend):
    from repro.core.client_store import HostStore as JHostStore
    from repro.core.client_store import InMemoryStore as JInMemoryStore
    from tests import test_client_store as jref
    from tests.test_pipelined_store import tree_schedule
    store = JHostStore() if backend == "host" else JInMemoryStore()
    return jref.build(name, store, tree_schedule())


def _tbuild(name, backend):
    return tstore.build(name, HostStore() if backend == "host"
                        else InMemoryStore(), tstore.churny_schedule("tree"))


def _jsave(alg, state, key, path):
    from repro.checkpoint import checkpoint as jcheckpoint
    payload = {"state": state, "key": key}
    if alg.store.host_side:
        payload["store"] = alg.store.state_dict()
    jcheckpoint.save(path, payload, meta={"rounds_done": R_SAVE})


def _jstepped(alg, state, key, rounds, save_at=None, path=None):
    """The reference's ``round`` loop from ``(state, key)``; saves the
    checkpoint once ``save_at`` rounds are done."""
    ms = []
    for r in range(rounds):
        if r == save_at:
            _jsave(alg, state, key, path)
        key, sub = jax.random.split(key)
        state, m = alg.round(state, sub)
        ms.append(m)
    return state, ms


def _tstepped(alg, state, key, rounds, save_at=None, path=None):
    ms = []
    for r in range(rounds):
        if r == save_at:
            payload = {"state": state, "key": key}
            if alg.store.host_side:
                payload["store"] = alg.store.state_dict()
            checkpoint.save(path, payload, meta={"rounds_done": R_SAVE})
        key, sub = prng.split(key, 2)
        state, m = alg.round(state, sub)
        ms.append(m)
    return state, ms


@pytest.fixture(scope="module")
def cross_runs(tmp_path_factory):
    """Each package's uninterrupted stepped run of every CROSS pair,
    writing its checkpoint at round ``R_SAVE`` on the way."""
    out = {}
    with jax.threefry_partitionable(True):
        for name, backend in CROSS:
            d = tmp_path_factory.mktemp(f"{name}_{backend}")
            ja = _jbuild(name, backend)
            jrun = _jstepped(ja, ja.init({"w": jnp.zeros((5,), jnp.float32)}),
                             jax.random.PRNGKey(11), R, R_SAVE, d / "jax.npz")
            ta = _tbuild(name, backend)
            trun = _tstepped(ta, ta.init(tstore.P0()), prng.PRNGKey(11), R,
                             R_SAVE, d / "torch.npz")
            out[(name, backend)] = (jrun, trun, d)
    return out


def _assert_parity(got, want, label):
    """Stepped per-round metrics and the final model at the parity
    tolerances; ``got`` covers the rounds after the checkpoint."""
    (st_got, ms_got), (st_want, ms_want) = got, want
    ms_want = ms_want[R_SAVE:]
    assert len(ms_got) == len(ms_want)
    for r, (mg, mw) in enumerate(zip(ms_got, ms_want)):
        assert sorted(mg) == sorted(mw)
        for k in mw:
            g = np.asarray(mg[k], np.float64)
            w = np.asarray(mw[k], np.float64)
            tol = golden.TOLERANCES.get(k)
            if tol is None:
                np.testing.assert_array_equal(g, w, err_msg=f"{label} r{r} {k}")
            else:
                np.testing.assert_allclose(g, w, rtol=tol[0], atol=tol[1],
                                           err_msg=f"{label} r{r} {k}")
    np.testing.assert_allclose(np.asarray(st_got.x["w"]),
                               np.asarray(st_want.x["w"]), rtol=0,
                               atol=PARAM_ATOL, err_msg=f"{label} x")


@pytest.mark.parametrize("name,backend", CROSS)
def test_jax_checkpoint_resumes_in_port(name, backend, cross_runs):
    jrun, _, d = cross_runs[(name, backend)]
    b = _tbuild(name, backend)
    like = {"state": b.init(tstore.P0()), "key": prng.PRNGKey(0)}
    if backend == "host":
        like["store"] = b.store.state_dict()
    restored, meta = checkpoint.load(d / "jax.npz", like=like)
    assert meta == {"rounds_done": R_SAVE}
    assert restored["state"].round == R_SAVE
    if backend == "host":
        b.store.load_state_dict(restored["store"])
    got = _tstepped(b, restored["state"], restored["key"], R - R_SAVE)
    _assert_parity(got, jrun, f"jax->port {name}/{backend}")


@pytest.mark.parametrize("name,backend", CROSS)
def test_port_checkpoint_resumes_in_jax(name, backend, cross_runs):
    from repro.checkpoint import checkpoint as jcheckpoint
    _, trun, d = cross_runs[(name, backend)]
    b = _jbuild(name, backend)
    like = {"state": b.init({"w": jnp.zeros((5,), jnp.float32)}),
            "key": jax.random.PRNGKey(0)}
    if backend == "host":
        like["store"] = b.store.state_dict()
    restored, meta = jcheckpoint.load(d / "torch.npz", like=like)
    assert meta == {"rounds_done": R_SAVE}
    assert int(restored["state"].round) == R_SAVE
    if backend == "host":
        b.store.load_state_dict(
            jax.tree_util.tree_map(np.asarray, restored["store"]))
    got = _jstepped(b, restored["state"], restored["key"], R - R_SAVE)
    _assert_parity(got, trun, f"port->jax {name}/{backend}")
