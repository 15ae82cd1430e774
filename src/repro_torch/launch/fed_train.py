"""FedComLoc as a training feature of the model zoo (DESIGN.md §2), the
port of ``repro.launch.fed_train``, on one card.

Each client is one entry of a stacked leading axis: parameters and
control variates carry it on every leaf, and ``n_clients`` is its length
(the reference reads it from its mesh's ``pod`` axis; the mesh-sharded
form is not ported).  One round:

  1. L local steps: x_i <- x_i - gamma * (grad_i - h_i), client by client
     (the reference's ``jax.vmap(value_and_grad)``, same numerics);
  2. communication (theta = 1): the uplink iterate is compressed (TopK /
     Q_r, or the int8 payload through ``wire.encode``/``decode``), the
     clients' mean is taken over the leading axis, and the control
     variates absorb the skip correction h_i += (p/gamma)(x_bar - x^_i).

The updates take gamma and p / gamma at the leaves' dtype, as JAX's weak
typing does (:func:`repro_torch.optim.optimizers.weak`).  Keys are drawn
as the reference draws them: ``split(key, L + 2)``, the
local steps' keys first, the uplink's ``split(keys[-1], n_clients)``,
the global variant's downlink key ``keys[-2]``.  Each round also returns
``comm_bits``, the exact wire cost of its payload (BitsReport totals).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch import prng
from repro_torch import tree as tree_util
from repro_torch.compress import make_compressor as _make
from repro_torch.compress import wire
from repro_torch.compress.compressors import Compressor
from repro_torch.compress.report import dense_bits
from repro_torch.configs.base import ArchSpec, InputShape
from repro_torch.launch.steps import (StepBundle, TensorSpec, _params_struct,
                                      batch_struct, loss_fn)
from repro_torch.optim.optimizers import weak

PyTree = Any

LOSS_CHUNK = 512    # the reference's fed round chunks its loss by 512


@dataclasses.dataclass(frozen=True)
class FedTrainConfig:
    gamma: float = 3e-4
    p: float = 0.1
    local_steps: int = 10           # = round(1/p)
    compressor: str = "topk"        # topk | quant | none
    density: float = 0.1            # topk density
    quant_bits: int = 8
    variant: str = "com"            # com | global | local | none
    # "int8": the sync moves an int8 payload (levels) + per-tensor scales
    # (wire.encode / wire.decode).  Requires compressor="quant" with
    # quant_bits <= 7 magnitude bits.
    sync_mode: str = "dense"        # dense | int8
    # Aggregation policy (DESIGN.md §7): the round IS one synchronous
    # average, so only "sync" is executable here; the event-driven
    # policies live in the simulator (repro_torch.core.aggregation).
    aggregation: str = "sync"       # sync | semi_sync | async_buffered
    wait_for: int | None = None     # K (semi_sync)
    buffer_capacity: int | None = None   # buffer size (async_buffered)
    staleness_alpha: float = 0.0    # staleness exponent (async_buffered)

    def aggregation_policy(self):
        """The config's aggregation policy as a validated core object.

        All policy fields are forwarded so the core's cross-field checks
        fire: a knob that doesn't belong to the selected mode (e.g.
        ``wait_for`` under ``aggregation="sync"``) raises instead of being
        silently discarded.
        """
        from repro_torch.core.aggregation import AggregationPolicy
        if self.aggregation not in ("sync", "semi_sync", "async_buffered"):
            raise ValueError(f"unknown aggregation {self.aggregation!r}")
        return AggregationPolicy(
            mode=self.aggregation, wait_for=self.wait_for,
            capacity=self.buffer_capacity, alpha=self.staleness_alpha)


def make_compressor(fed: FedTrainConfig) -> Compressor:
    """Resolve the config to a registry entry (quantile TopK at scale)."""
    if fed.compressor in ("none", "identity"):
        return _make("none")
    if fed.compressor == "topk":
        return _make("topk", density=fed.density, impl="quantile")
    if fed.compressor == "quant":
        return _make("quant", r=fed.quant_bits)
    raise ValueError(f"unknown compressor {fed.compressor!r}")


def _total_bits(rep) -> torch.Tensor:
    """``report.reduce_sum().total_bits``: each bucket summed over the
    clients, float32."""
    return rep.value_bits.sum() + rep.index_bits.sum() + rep.meta_bits.sum()


def build_fed_round(spec: ArchSpec, shape: InputShape,
                    fed: FedTrainConfig) -> StepBundle:
    """One FedComLoc round over the stacked clients.

    ``fn(params, h, batch, key) -> (params, h, loss, comm_bits)``:
    ``params`` and ``h`` are stacked trees (every leaf ``(n_clients,
    ...)``), ``batch`` the family's batch (``steps.batch_struct``) with
    the client axis in front (the text decoders' ``{"tokens": (n_clients,
    B_local, T) int}``), ``key`` a ``(2,)`` key.  ``params`` and ``h`` are updated in place
    and returned (the reference's round donates both): the round holds
    the stacked parameters and control variates once, one client's
    gradient, and the compressed uplink.  ``loss`` is the mean over the
    local steps of the clients' mean loss and ``comm_bits`` the payload's
    bits, both float32 scalars.  The number of clients is the leading
    axis's length (the reference's ``mesh.shape["pod"]``), so ``args``
    leave it open (None), and the batch's per-client rows with it: the
    shape's global batch splits evenly over the clients.
    """
    if not fed.aggregation_policy().is_sync:
        raise ValueError(
            f'aggregation={fed.aggregation!r}: the round is one synchronous '
            f'average, so only "sync" is executable here; run event-driven '
            f'policies through the simulator (repro_torch.core.aggregation, '
            f'DESIGN.md §7)')
    comp = make_compressor(fed)
    if fed.sync_mode == "int8" and fed.compressor != "quant":
        raise ValueError('sync_mode="int8" requires compressor="quant"')
    # Int8Sync itself rejects quant_bits > 7 (level * sign must fit int8).
    int8 = (_make("int8", magnitude_bits=fed.quant_bits)
            if fed.sync_mode == "int8" else None)

    params_struct = tree_util.map(
        lambda s: TensorSpec((None,) + s.shape, s.dtype), _params_struct(spec))
    batch = {name: TensorSpec((None, None) + s.shape[1:], s.dtype)
             for name, s in batch_struct(spec, 1, shape.seq_len).items()}
    loss_of = loss_fn(spec, LOSS_CHUNK)

    def client_grad(x_i, batch_i):
        live = [leaf.detach().requires_grad_()
                for leaf in tree_util.leaves(x_i)]
        loss = loss_of(tree_util.unflatten(x_i, live), batch_i)
        grads = torch.autograd.grad(loss, live, allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), grads

    def fed_round(params, h, batch_, key):
        x = params
        n = tree_util.leaves(x)[0].shape[0]
        xs, hs = tree_util.leaves(x), tree_util.leaves(h)
        keys = prng.split(key, fed.local_steps + 2)
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=xs[0].device)
        # --- local phase: L steps, no communication ---------------------- #
        for step in range(fed.local_steps):
            x_eval = x
            if fed.variant == "local":
                x_eval = comp.apply(x, prng.split(keys[step], n))
            losses = []
            for i in range(n):
                loss, grads = client_grad(
                    tree_util.map(lambda leaf: leaf[i], x_eval),
                    {name: v[i] for name, v in batch_.items()})
                losses.append(loss)
                with torch.no_grad():
                    for xl, gl, hl in zip(xs, grads, hs):
                        xl[i] = (xl[i] - weak(fed.gamma, gl)
                                 * (gl - hl[i].to(gl.dtype))).to(xl.dtype)
                del grads
            loss_sum = loss_sum + torch.stack(losses).mean()
        # --- communication round (theta = 1) ----------------------------- #
        with torch.no_grad():
            x_hat = x
            comm_bits = torch.tensor(dense_bits(x_hat), dtype=torch.float32,
                                     device=xs[0].device)
            if fed.variant == "com" and fed.sync_mode == "int8":
                payload, up_rep = wire.encode(int8, x_hat,
                                              prng.split(keys[-1], n))
                x_hat = wire.decode(payload)
                # the mean in float32 straight from the payload (dequant,
                # mean, one cast), as the reference takes it
                x_bar = tree_util.unflatten(x_hat, [
                    (q.to(torch.float32)
                     * sc.reshape((-1,) + (1,) * (q.dim() - 1))
                     ).mean(dim=0).to(dt)
                    for (q, sc), dt in zip(payload.data,
                                           payload.spec.dtypes)])
                comm_bits = _total_bits(up_rep)
            else:
                if fed.variant == "com":
                    x_hat, up_rep = comp.compress(x_hat,
                                                  prng.split(keys[-1], n))
                    comm_bits = _total_bits(up_rep)
                x_bar = tree_util.map(lambda t_: t_.mean(dim=0), x_hat)
            if fed.variant == "global":
                x_bar, down_rep = comp.compress(
                    tree_util.map(lambda t_: t_[None], x_bar), keys[-2][None])
                x_bar = tree_util.map(lambda t_: t_[0], x_bar)
                comm_bits = comm_bits + n * _total_bits(down_rep)
            for hl, xh, xb in zip(hs, tree_util.leaves(x_hat),
                                  tree_util.leaves(x_bar)):
                hl.add_(weak(fed.p / fed.gamma, hl)
                        * (xb[None] - xh).to(hl.dtype))
            for xl, xb in zip(xs, tree_util.leaves(x_bar)):
                xl.copy_(xb[None].expand(xl.shape).to(xl.dtype))
        return (x, h, loss_sum / fed.local_steps,
                comm_bits.to(torch.float32))

    return StepBundle(fn=fed_round,
                      args=(params_struct, params_struct, batch,
                            TensorSpec((2,), torch.int64)))
