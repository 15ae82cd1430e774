"""The one-card FedComLoc round against the JAX package's, continued from
``tests/test_torch_fed_train.py`` (its model, helpers and tolerances):
the global and local variants on one client, and two stacked clients
against JAX in a subprocess with two host devices (a (2, 1, 1) ``("pod",
"data", "model")`` mesh), which hands back numpy arrays.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # xdist workers share the cores: no spinning OpenMP pools

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro_torch import tree as tree_util  # noqa: E402
from tests import test_torch_fed_train as fed  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _partitionable_threefry():
    with jax.threefry_partitionable(True):
        yield


@pytest.fixture(scope="module")
def jparams():
    return fed.init_jax_params()


@pytest.mark.parametrize("kw", [
    dict(compressor="topk", density=0.25, variant="global"),
    dict(compressor="quant", variant="local")], ids=["topk-global",
                                                     "quant-local"])
def test_fed_round_variants_match_jax(kw, jparams):
    fed.match(fed.port_rounds(kw, jparams, 1), fed.jax_rounds(kw, jparams))


_TWO_CLIENTS = textwrap.dedent("""
    import dataclasses, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh
    from repro.configs import get_spec
    from repro.configs.base import SHAPES, reduced
    from repro.launch import fed_train
    from repro.models import transformer as tfm
    jax.config.update("jax_threefry_partitionable", True)
    small = dict(n_layers=1, d_model=64, d_ff=128, vocab=64, n_heads=2,
                 n_kv_heads=1, head_dim=32)
    spec = reduced(get_spec("qwen2-0.5b"))
    spec = dataclasses.replace(spec, model=dataclasses.replace(spec.model,
                                                               **small))
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(2, 1, 1),
                ("pod", "data", "model"))
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len={T},
                                global_batch=4)
    b = fed_train.build_fed_round(spec, shape, mesh, fed_train.FedTrainConfig(
        gamma=0.3, local_steps=2, compressor="topk", density=0.25))
    p = tfm.init_params(jax.random.PRNGKey(0), spec.model)
    ps = jax.tree_util.tree_map(lambda x: jnp.stack([x, x]), p)
    hs = jax.tree_util.tree_map(jnp.zeros_like, ps)
    toks = np.random.default_rng(0).integers(0, 64, (2, 2, {T})).astype(
        np.int32)
    key, out = jax.random.PRNGKey(1), []
    with mesh:
        step = jax.jit(b.fn, in_shardings=b.in_shardings,
                       out_shardings=b.out_shardings)
        for _ in range({ROUNDS}):
            key, sub = jax.random.split(key)
            ps, hs, loss, bits = step(ps, hs, {{"tokens": jnp.asarray(toks)}},
                                      sub)
            out.append((float(loss), float(bits)))
    leaves = jax.tree_util.tree_leaves((ps, hs))
    np.savez(sys.argv[1], out=np.asarray(out),
             *[np.asarray(x) for x in leaves])
""").format(T=fed.T, ROUNDS=fed.ROUNDS)


def test_fed_round_matches_jax_on_two_clients(tmp_path, jparams):
    """Two stacked clients (TopK uplink): the clients' mean, the control
    variates' correction and the per-client keys, against JAX on a
    (2, 1, 1) mesh of two host devices."""
    out = tmp_path / "jax.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=2",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", _TWO_CLIENTS, str(out)], env=env,
                   check=True, timeout=300)
    got = np.load(out)
    tp, th, tout = fed.port_rounds(dict(compressor="topk", density=0.25),
                                jparams, 2)
    leaves = tree_util.leaves(tp) + tree_util.leaves(th)
    for (tl, tb), (jl, jb) in zip(tout, got["out"]):
        np.testing.assert_allclose(tl, jl, rtol=fed.LOSS_RTOL)
        assert tb == jb
    for i, leaf in enumerate(leaves):
        np.testing.assert_allclose(leaf.numpy(), got[f"arr_{i}"], rtol=0,
                                   atol=fed.STATE_ATOL)
    assert float(max(x.abs().max() for x in tree_util.leaves(th))) > 0
