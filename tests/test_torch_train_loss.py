"""The zoo's training loss and train step in the port against the JAX
package, on the CPU: ``transformer.loss`` and its gradients for the
reduced configs of every ported decoder architecture (the
encoder-decoder's ``encdec.loss`` is held in
``tests/test_torch_encdec.py``, the MoE family's in
``tests/test_torch_moe.py``), remat on and off, and
``steps.build_train_step`` over 3 Adam steps against the JAX
``build_train_step`` on a one-device host mesh.

Both packages start from the same weights (the port's seeded init,
carried with ``convert``); tokens come from a numpy seed.  Each JAX
computation is compiled once under ``jax.jit``.  Tolerances, float32, stated before the
runs:

* the loss: rtol 1e-5; each gradient leaf: |d| <= 1e-4 max |JAX leaf|
  (float32 sums in another order through the scans, attention's chunks
  and the chunked cross-entropy);
* remat off against remat on: equal (the recompute repeats the same
  operations);
* 3 Adam steps (lr 1e-4): each step's loss rtol 1e-5; Adam's m and v
  after the last within 1e-5 of JAX's (to their scale) plus rtol 1e-4, t
  equal; the parameters within 1e-5 plus rtol 1e-4 but for at most 0.1%
  of a leaf's entries, and every entry within 3 lr: Adam divides m by
  sqrt(v), so where a gradient is float32 noise (near 0) a step moves the
  parameter by up to lr in a direction the noise picks.
"""

import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # xdist workers share the cores: no spinning OpenMP pools

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_spec as jget_spec  # noqa: E402
from repro.configs.base import reduced as jreduced  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import tree as tree_util  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_spec, reduced  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402

LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
STEP_ATOL, STEP_RTOL = 1e-5, 1e-4
LR = 1e-4                  # steps._optimizer_for: Adam at 1e-4
NOISE_SHARE = 1e-3
T, CHUNK = 16, 8


def _tokens(vocab, b=2, t=T, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(
        np.int32)


@functools.lru_cache(maxsize=None)
def _jax_model(arch):
    """The JAX package's reduced config, and weights for it made once a
    module by the port's seeded init and handed to JAX as arrays (the two
    packages share the layout; the weights need only be the same in
    both, and JAX's eager init compiles an XLA program a shape)."""
    jm = jreduced(jget_spec(arch)).model
    tp = tfm.init_params(reduced(get_spec(arch)).model,
                         torch.Generator().manual_seed(0))
    return jm, jax.tree.map(jnp.asarray, convert.params_to_numpy(tp))


def _carry(tree):
    return convert.params_from_jax(jax.tree.map(np.asarray, tree), "cpu")


def _port_loss_and_grads(tp, m, toks, remat=True):
    live = [leaf.detach().requires_grad_() for leaf in tree_util.leaves(tp)]
    loss = tfm.loss(tree_util.unflatten(tp, live), m,
                    torch.from_numpy(toks).long(), loss_chunk=CHUNK,
                    remat=remat)
    return loss.detach(), torch.autograd.grad(loss, live)


# the MoE family's loss and gradients are held in tests/test_torch_moe.py
DECODER_ARCHS = [a for a in ARCH_IDS if not get_spec(a).is_encdec
                 and get_spec(a).family != "moe"]


@pytest.mark.parametrize("arch", DECODER_ARCHS)
def test_loss_and_gradients_match_jax(arch):
    """qwen2-vl runs text-only here (M-RoPE's default ids)."""
    jm, jp = _jax_model(arch)
    toks = _tokens(jm.vocab)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, t: jtfm.loss(p, jm, t, loss_chunk=CHUNK)))(
            jp, jnp.asarray(toks))
    loss, grads = _port_loss_and_grads(_carry(jp), reduced(get_spec(arch)).model,
                                       toks)
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    want = jax.tree_util.tree_leaves(jg)
    assert len(grads) == len(want)
    for got, w in zip(grads, want):
        w = np.asarray(w)
        np.testing.assert_allclose(got.numpy(), w, rtol=0,
                                   atol=GRAD_REL * float(np.abs(w).max()))


@pytest.mark.parametrize("arch", ["rwkv6-3b", "recurrentgemma-2b"])
def test_remat_off_equals_remat_on(arch):
    m = reduced(get_spec(arch)).model
    tp = tfm.init_params(m, torch.Generator().manual_seed(0))
    toks = _tokens(m.vocab, t=12)
    on = _port_loss_and_grads(tp, m, toks, remat=True)
    off = _port_loss_and_grads(tp, m, toks, remat=False)
    assert torch.equal(on[0], off[0])
    assert all(torch.equal(a, b) for a, b in zip(on[1], off[1]))


@pytest.mark.parametrize("arch", ["rwkv6-3b", "recurrentgemma-2b"])
def test_train_step_matches_jax_over_three_adam_steps(arch):
    jspec = jreduced(jget_spec(arch))
    jm, jp = _jax_model(arch)
    shape = dataclasses.replace(jsteps.SHAPES["train_4k"], seq_len=T,
                                global_batch=2)
    jb = jsteps.build_train_step(jspec, shape, make_host_mesh(),
                                 loss_chunk=CHUNK)
    jinit = jsteps.optimizers.make(*jsteps._optimizer_for(jspec))[0]
    jstate = jinit(jp)
    tb = steps.build_train_step(reduced(get_spec(arch)),
                                InputShape("t", T, 2, "train"),
                                loss_chunk=CHUNK)
    assert jsteps._optimizer_for(jspec) == steps._optimizer_for(
        reduced(get_spec(arch)))
    tp, tstate = _carry(jp), _carry(jstate)
    step = jax.jit(jb.fn)
    for i in range(3):
        toks = _tokens(jm.vocab, seed=10 + i)
        jp, jstate, jl = step(jp, jstate, {"tokens": jnp.asarray(toks)})
        tp, tstate, tl = tb.fn(tp, tstate,
                               {"tokens": torch.from_numpy(toks).long()})
        np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    assert int(tstate["t"]) == int(jstate["t"]) == 3
    assert tstate["t"].dtype == torch.int32
    for got, want in zip(tree_util.leaves((tstate["m"], tstate["v"])),
                         jax.tree_util.tree_leaves((jstate["m"],
                                                    jstate["v"]))):
        want = np.asarray(want)
        np.testing.assert_allclose(
            got.numpy(), want, rtol=STEP_RTOL,
            atol=STEP_ATOL * max(1.0, float(np.abs(want).max())))
    for got, want in zip(tree_util.leaves(tp), jax.tree_util.tree_leaves(jp)):
        d = np.abs(got.numpy() - np.asarray(want))
        off = d > STEP_ATOL + STEP_RTOL * np.abs(np.asarray(want))
        assert off.mean() <= NOISE_SHARE and d.max() <= 3 * LR, (
            off.sum(), d.max())
