"""The unsharded port against the JAX package on the setup of
``tests/test_distributed.py`` (the reference's own mesh path fails on jax
0.9, so the sharded port is held to the unsharded port in
``tests/test_torch_distributed.py``, and the unsharded port to JAX here),
the device meter against the reference's ``"jnp"`` meter, and
``sharding/specs.py``'s path rules against the reference's.

Rounds: each of the seven ``ALGORITHMS`` runs ``run_rounds`` once in each
package (JAX's jitted once, in a module fixture), from the zero model on
key 9.  Metrics to the tolerances of ``tests/test_golden.py:42-47``
(``train_loss`` rtol 2e-4 / atol 1e-6, ``sim_time`` and ``client_finish``
rtol 1e-6, the rest exact), the state within atol 1e-5 (the port's round
tests' ``PARAM_ATOL``).  Specs: every zoo config's ``reduced()`` parameter
tree by path and shape (JAX's ``eval_shape``, the port's under
``FakeTensorMode``: no weights built), leaf by leaf.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # xdist workers share the cores: no spinning OpenMP pools

import jax  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.sharding import specs as jspecs  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch import tree as tree_util  # noqa: E402
from repro_torch.core.comm import CommMeter  # noqa: E402
from repro_torch.models import encdec, transformer as tfm  # noqa: E402
from repro_torch.sharding import specs  # noqa: E402
from tests import test_distributed as jdist  # noqa: E402
from tests import test_torch_distributed as tdist  # noqa: E402

TOLERANCES = {"train_loss": (2e-4, 1e-6), "sim_time": (1e-6, 0.0),
              "client_finish": (1e-6, 0.0)}
PARAM_ATOL = 1e-5


def _jax_run(alg):
    st, m = alg.run_rounds(alg.init(jdist.P0), jax.random.PRNGKey(tdist.KEY),
                           tdist.ROUNDS)
    state = {f: [np.asarray(a) for a in jax.tree.leaves(v)]
             for f, v in st._asdict().items()
             if isinstance(v, (dict, tuple)) and v != ()}
    return state, {k: np.asarray(v) for k, v in m.items()}, alg.meter


@pytest.fixture(scope="module")
def both():
    """``{name: (jax run, port run)}`` for the seven algorithms (JAX's Com
    run with the reference's ``"jnp"`` meter), and the port's Com run with
    the device meter."""
    data = tdist.quadratic_data()
    out = {}
    with jax.threefry_partitionable(True):
        for name in tdist.ALGORITHMS:
            jalg = jdist.build(name)
            if name == "fedcomloc_com":     # its bits are exact in float32
                jalg.meter = type(jalg.meter)(mode="jnp")
            out[name] = (_jax_run(jalg), tdist.run(tdist.build(name, data)))
        talg = tdist.build("fedcomloc_com", data)
        talg.meter = CommMeter("device")
        out["meters"] = (out["fedcomloc_com"][0][2], tdist.run(talg)[2],
                         talg.meter)
    return out


@pytest.mark.parametrize("name", tdist.ALGORITHMS)
def test_unsharded_port_matches_reference(both, name):
    (jst, jm, jmeter), (tst, tm, tsnap) = both[name]
    assert set(tm) == set(jm), name
    for k, want in jm.items():
        got = np.asarray(tm[k])
        assert got.shape == want.shape, k
        if k in TOLERANCES:
            rtol, atol = TOLERANCES[k]
            np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                       err_msg=f"{name} {k}")
        else:
            np.testing.assert_array_equal(got, want, err_msg=f"{name} {k}")
    assert tst.keys() == jst.keys()
    for field in jst:
        for a, b in zip(jst[field], tst[field]):
            np.testing.assert_allclose(b, a, rtol=0, atol=PARAM_ATOL,
                                       err_msg=f"{name} {field}")
    assert tsnap == jmeter.snapshot()


def test_device_meter_matches_the_jnp_meter(both):
    jmeter, tsnap, tmeter = both["meters"]
    assert isinstance(tmeter._uplink, torch.Tensor)
    assert isinstance(jmeter._uplink, jax.Array)
    assert tsnap == jmeter.snapshot()


# --------------------------------------------------------------------------- #
# sharding/specs.py against the reference's rules
# --------------------------------------------------------------------------- #

class _JMesh:
    """The reference's rules read ``axis_names`` and ``shape[name]``."""

    def __init__(self, **axes):
        self.axis_names = tuple(axes)
        self.shape = dict(axes)


class _TMesh:
    """The port's read ``mesh_dim_names`` and ``shape``, as a
    ``DeviceMesh`` has them."""

    def __init__(self, **axes):
        self.mesh_dim_names = tuple(axes)
        self.shape = tuple(axes.values())


MESHES = [dict(data=1, model=1), dict(data=2, model=4),
          dict(data=16, model=16), dict(pod=2, data=4, model=8)]


def _reference_leaves(arch):
    spec = jconfigs.reduced(jconfigs.get_spec(arch))
    init = jencdec.init_params if spec.is_encdec else jtfm.init_params
    shapes = jax.eval_shape(lambda k: init(k, spec.model),
                            jax.random.PRNGKey(0))
    flat, _ = jax.tree_util.tree_flatten_with_path(shapes)
    return [(jspecs._path_str(p), tuple(leaf.shape)) for p, leaf in flat]


def _port_leaves(arch):
    spec = configs.reduced(configs.get_spec(arch))
    init = encdec.init_params if spec.is_encdec else tfm.init_params
    with FakeTensorMode():
        params = init(spec.model, torch.Generator().manual_seed(0))
    return [(specs.path_str(keys), tuple(leaf.shape))
            for keys, leaf in tree_util.leaves_with_paths(params)]


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_param_specs_match_reference(arch):
    want = _reference_leaves(arch)
    got = _port_leaves(arch)
    assert got == want
    for axes in MESHES:
        jm, tm = _JMesh(**axes), _TMesh(**axes)
        for path, shape in got:
            for eom in (False, True):
                js = jspecs.param_spec(path, shape, jm, eom)
                ts = specs.param_spec(path, shape, tm, eom)
                assert ts == tuple(js), (path, axes, eom)
                assert specs._sanitize(ts, shape, tm) == tuple(
                    jspecs._sanitize(js, shape, jm)), (path, axes)
        for n in (1, 7, 64, 256):
            assert specs.batch_axis(tm, n) == jspecs.batch_axis(jm, n)
    for path, shape in got:
        for shards in (1, 2, 4, 16):
            for eom in (False, True):
                assert specs.model_dim_index(
                    path, shape, shards, expert_over_model=eom) == \
                    jspecs.model_dim_index(path, shape, shards,
                                           expert_over_model=eom), path


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_validate_model_axis_matches_reference(arch):
    """The model axis's divisibility check on the published configs:
    the same size returned, or the same error, at every axis size."""
    from repro.core import distributed as jdistributed
    from repro_torch.core import distributed
    jspec, tspec = jconfigs.get_spec(arch), configs.get_spec(arch)
    for m in (1, 2, 3, 4, 8, 16, 64):
        axes = dict(clients=1, data=1, model=m)
        try:
            want = jdistributed.validate_model_axis(_JMesh(**axes), jspec)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                distributed.validate_model_axis(_TMesh(**axes), tspec)
            assert str(got.value) == str(e)
        else:
            assert distributed.validate_model_axis(_TMesh(**axes),
                                                   tspec) == want
    assert distributed.validate_model_axis(_TMesh(clients=4), tspec) == 1
