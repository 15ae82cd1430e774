"""FedComLoc as a training feature of the model zoo (DESIGN.md §2), the
port of ``repro.launch.fed_train``.

Two forms of one round.  On one card (``mesh=None``) each client is one
entry of a stacked leading axis: parameters and control variates carry it
on every leaf, and ``n_clients`` is its length.  On a ``("pod", "data",
"model")`` ``DeviceMesh`` each rank of the ``pod`` axis holds one client
(the reference's pod-as-client mapping, its leaves with a leading axis of
1), its batch rows split over ``data``; ``n_clients`` is the ``pod``
size.  One round:

  1. L local steps: x_i <- x_i - gamma * (grad_i - h_i), client by client
     (the reference's ``jax.vmap(value_and_grad)``, same numerics); on a
     mesh the loss and gradient are averaged over ``data`` in one
     all-reduce of one flat buffer a step, and nothing crosses ``pod``;
  2. communication (theta = 1): the uplink iterate is compressed (TopK /
     Q_r, or the int8 payload through ``wire.encode``/``decode``), the
     clients' mean is taken (over the leading axis; on a mesh one
     all-reduce over ``pod`` of the flat iterate, or, for the int8 payload,
     one all-gather of its bytes and the mean in client order), and the
     control variates absorb the skip correction
     h_i += (p/gamma)(x_bar - x^_i).

Both forms run one body through a :class:`ClientAxisCtx`: the identity
collectives of the stacked axis, or :class:`PodCtx`.  The updates take
gamma and p / gamma at the leaves' dtype, as JAX's weak typing does
(:func:`repro_torch.optim.optimizers.weak`).  Keys are drawn as the
reference draws them: ``split(key, L + 2)``, the local steps' keys first,
the uplink's ``split(keys[-1], n_clients)`` (a pod rank takes its row),
the global variant's downlink key ``keys[-2]`` on every rank.  Each round
also returns ``comm_bits``, the exact wire cost of its payload (BitsReport
totals, summed over the clients in client order).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

from repro_torch import not_ported, prng
from repro_torch import tree as tree_util
from repro_torch.compress import make_compressor as _make
from repro_torch.compress import wire
from repro_torch.compress.compressors import Compressor
from repro_torch.compress.report import dense_bits
from repro_torch.configs.base import ArchSpec, InputShape
from repro_torch.core.clients import ClientAxisCtx
from repro_torch.core.distributed import ShardCtx, _bytes, _from_bytes
from repro_torch.launch.steps import (StepBundle, TensorSpec, _params_struct,
                                      batch_struct, loss_fn)
from repro_torch.optim.optimizers import weak
from repro_torch.sharding.specs import mesh_axes

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


class StackedCtx(ClientAxisCtx):
    """The one-card round's client axis: every client on the leading axis,
    no data axis, and every collective the identity."""

    data = 1

    def gather_payload(self, data) -> tuple:
        return data


class PodCtx(ShardCtx):
    """One client on each rank of ``mesh``'s ``pod`` axis, its batch rows
    split over the ``data`` axis: :class:`ShardCtx` over the pod group
    (its row of the clients' keys, metric gathers in client order, the
    clients' mean in one ``all_reduce(SUM)`` of one flat buffer, full-width
    values, zeros included, as the reference's one cross-pod all-reduce
    moves them), plus

    * ``gather_payload``: a payload's buffers gathered over ``pod`` in one
      byte tensor, in client order;
    * ``data_mean``: one ``all_reduce(SUM)`` over ``data`` of a flat
      buffer (the loss and the gradient of a step), divided by its size.

    When ``record`` is a list, each collective appends ``(axis, op,
    bytes)``: the bytes it takes from this rank."""

    axis = "pod"

    def __init__(self, mesh):
        axes = mesh_axes(mesh)
        super().__init__(mesh.get_group("pod"), axes["pod"])
        self.data = axes.get("data", 1)
        self.data_group = mesh.get_group("data") if self.data > 1 else None
        self.data_rank = (dist.get_rank(self.data_group)
                          if self.data_group is not None else 0)
        self.record: list | None = None

    def _note(self, axis: str, op: str, t: torch.Tensor) -> None:
        if self.record is not None:
            self.record.append((axis, op, t.numel() * t.element_size()))

    def local_batch(self, batch: dict) -> dict:
        """This rank's share of a ``(n_clients, B, ...)`` batch: its
        client's row, and of it the ``B / data`` rows of its data rank."""
        def rows(t):
            t = self.shard(t)
            b = t.shape[1] // self.data
            return t[:, self.data_rank * b:(self.data_rank + 1) * b]
        return {name: rows(t) for name, t in batch.items()}

    def data_mean(self, flat: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(flat, self.data_group, "data") / self.data

    def gather_payload(self, data) -> tuple:
        flat, layout = _bytes(data)
        return _from_bytes(self.all_clients(flat), layout)


def _pod_ctx(mesh, shape: InputShape) -> PodCtx:
    """The validated context of a ``("pod", "data", "model")`` mesh."""
    axes = mesh_axes(mesh)
    if "pod" not in axes:
        raise ValueError(f"fed_train requires a multi-pod mesh: mesh axes "
                         f"{tuple(axes)} have no 'pod' axis")
    if axes.get("model", 1) > 1:
        raise not_ported("the pod round's model axis (tensor-parallel "
                         "compute on DTensors, ROADMAP Queue A (c))")
    rows = axes["pod"] * axes.get("data", 1)
    if shape.global_batch % rows:
        raise ValueError(f"global batch {shape.global_batch} does not divide "
                         f"over pod x data = {rows} ranks")
    return PodCtx(mesh)


def build_fed_round(spec: ArchSpec, shape: InputShape,
                    fed: FedTrainConfig, mesh=None) -> StepBundle:
    """One FedComLoc round.

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

    With ``mesh`` (a ``DeviceMesh`` with a ``pod`` axis, optionally
    ``data``; a ``model`` axis above 1 is not ported) every rank of it
    calls ``fn`` with the same key, its client's ``params`` and ``h``
    (leading axis 1: ``fn.ctx.shard_tree`` of the stacked trees) and its
    share of the client's batch (``fn.ctx.local_batch`` of the whole
    batch), and every rank gets the same ``loss`` and ``comm_bits``.
    ``fn.ctx`` is the round's :class:`PodCtx`.
    """
    if not fed.aggregation_policy().is_sync:
        raise ValueError(
            f'aggregation={fed.aggregation!r}: the round is one synchronous '
            f'average, so only "sync" is executable here; run event-driven '
            f'policies through the simulator (repro_torch.core.aggregation, '
            f'DESIGN.md §7)')
    ctx = StackedCtx() if mesh is None else _pod_ctx(mesh, shape)
    comp = make_compressor(fed)
    if fed.sync_mode == "int8" and fed.compressor != "quant":
        raise ValueError('sync_mode="int8" requires compressor="quant"')
    # Int8Sync itself rejects quant_bits > 7 (level * sign must fit int8).
    int8 = (_make("int8", magnitude_bits=fed.quant_bits)
            if fed.sync_mode == "int8" else None)

    lead, rows = (None, None) if mesh is None else (
        1, shape.global_batch // (ctx.n_shards * ctx.data))
    params_struct = tree_util.map(
        lambda s: TensorSpec((lead,) + s.shape, s.dtype), _params_struct(spec))
    batch = {name: TensorSpec((lead, rows) + s.shape[1:], s.dtype)
             for name, s in batch_struct(spec, 1, shape.seq_len).items()}
    loss_of = loss_fn(spec, LOSS_CHUNK)

    def client_grad(x_i, batch_i):
        live = [leaf.detach().requires_grad_()
                for leaf in tree_util.leaves(x_i)]
        loss = loss_of(tree_util.unflatten(x_i, live), batch_i)
        grads = torch.autograd.grad(loss, live, allow_unused=True,
                                    materialize_grads=True)
        if ctx.data > 1:
            # the data ranks' mean loss and gradient, in one collective
            flat = ctx.data_mean(torch.cat(
                [loss.detach().reshape(1).to(torch.float32)]
                + [g.reshape(-1).to(torch.float32) for g in grads]))
            parts = flat[1:].split([g.numel() for g in grads])
            return flat[0].to(loss.dtype), tuple(
                p.reshape(g.shape).to(g.dtype) for p, g in zip(parts, grads))
        return loss.detach(), grads

    def fed_round(params, h, batch_, key):
        x = params
        xs, hs = tree_util.leaves(x), tree_util.leaves(h)
        n_local = xs[0].shape[0]
        if mesh is not None and n_local != 1:
            raise ValueError(f"a pod rank holds one client, got leaves with "
                             f"a leading axis of {n_local}")
        n = n_local * ctx.n_shards
        keys = prng.split(key, fed.local_steps + 2)
        # --- local phase: L steps, nothing crosses the client axis -------- #
        step_losses = []
        for step in range(fed.local_steps):
            x_eval = x
            if fed.variant == "local":
                x_eval = comp.apply(x, ctx.shard(prng.split(keys[step], n)))
            losses = []
            for i in range(n_local):
                loss, grads = client_grad(
                    tree_util.map(lambda leaf: leaf[i], x_eval),
                    {name: v[i] for name, v in batch_.items()})
                losses.append(loss)
                with torch.no_grad():
                    for xl, gl, hl in zip(xs, grads, hs):
                        xl[i] = (xl[i] - weak(fed.gamma, gl)
                                 * (gl - hl[i].to(gl.dtype))).to(xl.dtype)
                del grads
            step_losses.append(torch.stack(losses))
        # the clients' losses in client order, (L, n_clients)
        losses = ctx.all_clients(torch.stack(step_losses, dim=1)).T
        loss_sum = torch.zeros((), dtype=torch.float32, device=xs[0].device)
        for row in losses:
            loss_sum = loss_sum + row.contiguous().mean()
        # --- communication round (theta = 1) ----------------------------- #
        with torch.no_grad():
            x_hat = x
            comm_bits = torch.tensor(dense_bits(x_hat) * ctx.n_shards,
                                     dtype=torch.float32,
                                     device=xs[0].device)
            up_keys = ctx.shard(prng.split(keys[-1], n))
            up_rep = None
            if fed.variant == "com" and fed.sync_mode == "int8":
                payload, up_rep = wire.encode(int8, x_hat, up_keys)
                x_hat = wire.decode(payload)
                # the mean in float32 straight from the clients' payloads
                # (dequant, mean, one cast), as the reference takes it
                x_bar = tree_util.unflatten(x_hat, [
                    (q.to(torch.float32)
                     * sc.reshape((-1,) + (1,) * (q.dim() - 1))
                     ).mean(dim=0).to(dt)
                    for (q, sc), dt in zip(ctx.gather_payload(payload.data),
                                           payload.spec.dtypes)])
            else:
                if fed.variant == "com":
                    x_hat, up_rep = comp.compress(x_hat, up_keys)
                x_bar = ctx.mean_clients(x_hat)
            if up_rep is not None:
                # every client's report in client order: _total_bits of
                # the (n_clients,) buckets
                rep = ctx.all_clients(torch.stack(
                    [up_rep.value_bits, up_rep.index_bits, up_rep.meta_bits],
                    dim=1)).T.contiguous()
                comm_bits = rep[0].sum() + rep[1].sum() + rep[2].sum()
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

    fed_round.ctx = ctx
    return StepBundle(fn=fed_round,
                      args=(params_struct, params_struct, batch,
                            TensorSpec((2,), torch.int64)))
