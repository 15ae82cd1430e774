"""Baseline FL algorithms the paper compares against (§4.7, Figure 9), the
port of ``repro.core.baselines``.

* ``FedAvg``       (McMahan et al., 2016): local SGD and averaging, with
  an optional uplink compressor;
* ``SparseFedAvg``: FedAvg with a TopK uplink;
* ``Scaffold``     (Karimireddy et al., 2020): control variates c, c_i,
  option II update, server stepsize 1; ships model and variate dense;
* ``FedDyn``       (Acar et al., 2021): dynamic regularisation with the
  server-side correction h; ships the model dense.

Each runs the cohort's local SGD as stacked rows on the device (one
forward/backward a step for every sampled client), consumes the
reference's key chain exactly (``_round_key_fanout``-way round split,
``split(k_local, local_steps)`` per step and ``split(k_step, s)`` per
client), masks per-client steps under a straggler deadline, and combines
under the sync, semi_sync and async_buffered policies on both wires
(DESIGN.md §7, §8), with a dense or a delta-coded downlink (DESIGN.md
§10: clients start from the model they last received, ``y``; Scaffold's
one payload codes the ``(x, c)`` pair).  Scaffold's ``ci`` and FedDyn's
``grads`` live behind the client-store contract (``store=``, DESIGN.md
§11).  Scaffnew is FedComLoc with ``variant="none"``.  Every round body
takes a client-axis ``ctx`` (DESIGN.md §6), as FedComLoc's does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch import prng
from repro_torch import tree as tree_util
from repro_torch.compress import Compressor, Identity, TopK, dense_bits
from repro_torch.core import aggregation, comm
from repro_torch.core.clients import (
    NULL_CTX, ClientAxisCtx, ClientSchedule, apply_downlink, batched_compress,
    keep_where, masked_mean, mean_over_active, payload_metrics, per_client,
    tree_where, validate_schedule)
from repro_torch.core.engine import RoundEngine, value_and_grad
from repro_torch.core.fed_data import FederatedData

PyTree = Any
LossFn = Callable[[PyTree, torch.Tensor, torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class FedConfig:
    gamma: float = 0.1            # local stepsize
    local_steps: int = 10
    n_clients: int = 100
    clients_per_round: int = 10
    batch_size: int = 32
    alpha: float = 0.1            # FedDyn regularisation strength

    def __post_init__(self):
        if self.n_clients <= 0:
            raise ValueError("n_clients must be positive")
        if not (0 < self.clients_per_round <= self.n_clients):
            raise ValueError(
                f"clients_per_round must be in [1, n_clients]: got "
                f"{self.clients_per_round} with n_clients={self.n_clients}")
        if self.local_steps <= 0:
            raise ValueError("local_steps must be positive")


def _tmap(f, *trees):
    return tree_util.map(f, *trees)


def _local_sgd(loss_fn: LossFn, data: FederatedData, cfg: FedConfig,
               x0: PyTree, clients: torch.Tensor, key: torch.Tensor,
               grad_adjust: Optional[Callable[[PyTree, PyTree], PyTree]] = None,
               steps: Optional[torch.Tensor] = None,
               ctx: ClientAxisCtx = NULL_CTX):
    """Minibatch SGD on every sampled client at once.

    ``x0`` is the stacked ``(s, ...)`` start, ``clients`` the ``(s,)`` host
    cohort.  ``steps`` is the optional ``(s,)`` per-client step count: all
    ``cfg.local_steps`` steps run and a client past its count carries
    through unchanged.  ``grad_adjust(g, x)`` adjusts the stacked
    gradient.  Under a sharded ``ctx`` (DESIGN.md §6) ``x0``, ``clients``
    and ``steps`` are the shard's rows and the per-step mean losses are
    summed across shards.  Returns ``(x_final, summed per-step mean
    loss)``.
    """
    s, n_steps = cfg.clients_per_round, cfg.local_steps
    s_loc = ctx.local_count(s)
    # step j, client i draws split(split(key, L)[j], s)[i], the full split
    # sliced to the shard's clients
    keys = ctx.shard(prng.split(prng.split(key, n_steps), s).transpose(
        0, 1)).transpose(0, 1)                               # (L, s_loc, 2)
    xb_all, yb_all = data.sample_batch(
        keys, clients.unsqueeze(0).expand(n_steps, s_loc), cfg.batch_size)
    x_i = x0
    loss_sum = torch.zeros((), dtype=torch.float32, device=data.device)
    for j in range(n_steps):
        losses, g = value_and_grad(loss_fn, x_i, xb_all[j], yb_all[j])
        if grad_adjust is not None:
            g = grad_adjust(g, x_i)
        x_new = _tmap(lambda xc, gc: xc - cfg.gamma * gc, x_i, g)
        if steps is None:
            x_i = x_new
            loss_sum = loss_sum + ctx.mean_clients(losses)
            continue
        active = j < steps
        x_i = x_new if bool(active.all()) else keep_where(active, x_new, x_i)
        loss_sum = loss_sum + mean_over_active(losses, active, ctx)
    return x_i, loss_sum


def _broadcast(x: PyTree, s: int) -> PyTree:
    return _tmap(lambda p: p.unsqueeze(0).expand((s,) + tuple(p.shape)), x)


def _on(x: PyTree, device) -> PyTree:
    return _tmap(lambda p: p.detach().to(device), x)


def _combine(policy, out, may_exclude: bool, deltas: PyTree,
             weight: torch.Tensor, ctx: ClientAxisCtx) -> PyTree:
    """The server's combine of the ``(s, ...)`` client deltas: the
    staleness-weighted sum (async_buffered), the participation-weighted
    mean (an excluding policy or schedule, ``weight`` the rows' weights),
    or the plain mean, across ``ctx``'s shards."""
    if aggregation.uses_delta_combine(policy):
        return aggregation.async_weighted_sum(out, deltas, ctx)
    if may_exclude:
        return masked_mean(deltas, weight, ctx, weight_sum=out.n_selected)
    return ctx.mean_clients(deltas)


class _Baseline(RoundEngine):
    """Constructor and round prologue shared by the baselines."""

    def __init__(self, loss_fn: LossFn, data: FederatedData, cfg: FedConfig,
                 compressor: Compressor | None,
                 schedule: ClientSchedule | None,
                 policy: aggregation.AggregationPolicy | None,
                 wire: str, downlink: str,
                 downlink_compressor: Compressor | None, store,
                 meter_mode: str):
        self.loss_fn, self.data, self.cfg = loss_fn, data, cfg
        self.policy = policy
        self.wire = wire
        self.downlink = downlink
        self.down_comp = downlink_compressor
        self.store = store
        self.comp = compressor
        self.sched = validate_schedule(
            schedule if schedule is not None
            else ClientSchedule.homogeneous(cfg.n_clients),
            cfg.n_clients, compressor)
        self.meter = comm.CommMeter(mode=meter_mode)
        self._setup_engine()

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def _dl_on(self) -> bool:
        return self.downlink != "dense"

    def _downlink(self, state, x_new, k_dl, s: int, dense_down: float,
                  ctx: ClientAxisCtx):
        """The round's downlink: ``(y_new, downlink_bits, extra
        metrics)``; dense, the broadcast is ``x_new`` at full width."""
        if not self._dl_on:
            return state.y, torch.tensor(dense_down, dtype=torch.float32), {}
        return apply_downlink(self.downlink, self.down_comp, ctx, state.y,
                              x_new, k_dl[0], s)

    def _cohort(self, k_sample, round_idx: int):
        """The round's cohort, plan, plan-participation mask and whether
        its steps are masked."""
        clients, avail = self.sched.sample_cohort(
            k_sample, self.cfg.clients_per_round, round_idx,
            device=self.device)
        plan = self.sched.plan(clients, self.cfg.local_steps,
                               available=avail)
        return (clients, plan, plan.participating.to(torch.float32),
                self.sched.heterogeneous_steps)

    def _mean_loss(self, loss_sum, plan, het: bool):
        return loss_sum / (max(int(plan.steps.max()), 1) if het
                           else self.cfg.local_steps)

    def _metrics(self, loss, up_bits, down_bits, plan, client_up, out,
                 payload, dl_extras):
        metrics = {"train_loss": loss,
                   "uplink_bits": up_bits,
                   "downlink_bits": down_bits,
                   "client_steps": plan.steps,
                   "client_uplink_bits": client_up,
                   "client_finish": out.finish,
                   "sim_time": out.sim_time,
                   **aggregation.policy_metrics(out)}
        if payload is not None:
            metrics.update(payload_metrics(payload, out.partf))
        metrics.update(dl_extras)
        return metrics


# --------------------------------------------------------------------------- #
# FedAvg / SparseFedAvg
# --------------------------------------------------------------------------- #

class FedAvgState(NamedTuple):
    x: PyTree
    round: int
    y: PyTree = ()   # clients' last-received model (downlink != "dense")


class FedAvg(_Baseline):
    def __init__(self, loss_fn: LossFn, data: FederatedData, cfg: FedConfig,
                 compressor: Compressor | None = None,
                 schedule: ClientSchedule | None = None,
                 policy: aggregation.AggregationPolicy | None = None,
                 wire: str = "account",
                 downlink: str = "dense",
                 downlink_compressor: Compressor | None = None,
                 store=None,
                 meter_mode: str = "host"):
        super().__init__(loss_fn, data, cfg,
                         compressor if compressor is not None else Identity(),
                         schedule, policy, wire, downlink,
                         downlink_compressor, store, meter_mode)

    def init(self, params0: PyTree) -> FedAvgState:
        x = _on(params0, self.device)
        return FedAvgState(x=x, round=0, y=x if self._dl_on else ())

    @property
    def _round_key_fanout(self) -> int:
        # the reference's split: one more key for the downlink codec
        return 4 if self._dl_on else 3

    def _round_impl(self, state: FedAvgState, key: torch.Tensor,
                    ctx: ClientAxisCtx = NULL_CTX):
        cfg, sched = self.cfg, self.sched
        s = cfg.clients_per_round
        k_sample, k_local, k_comp, *k_dl = prng.split(
            key, self._round_key_fanout)
        clients_full, plan, partf_plan, het = self._cohort(k_sample,
                                                           state.round)
        plan_l, clients = ctx.shard_tree(plan), ctx.shard(clients_full)
        # clients start from the model they last received
        ref = state.y if self._dl_on else state.x
        x0 = _broadcast(ref, ctx.local_count(s))
        x_fin, loss_sum = _local_sgd(
            self.loss_fn, self.data, cfg, x0, clients, k_local,
            steps=plan_l.steps if het else None, ctx=ctx)
        comp_keys = ctx.shard(prng.split(k_comp, s))
        payload = None
        if self.wire == "packed":
            payload, up_rep = ctx.encode_payload(self.comp, plan_l, x_fin,
                                                 comp_keys)
        else:
            x_fin, up_rep = batched_compress(self.comp, plan_l, x_fin,
                                             comp_keys)
        pol = aggregation.resolve_policy(
            self.policy, sched, plan,
            ctx.all_clients(up_rep.total_bits.cpu()) * partf_plan, ctx)
        out = pol.out
        agg_ctx, weight = ctx, pol.weight
        if payload is not None:
            # server-side decode of the masked packed stack, aggregated
            # whole with the unsharded formula
            x_fin, x0 = (ctx.gather_decoded_payload(payload, out.partf),
                         _broadcast(ref, s))
            agg_ctx, weight = NULL_CTX, out.weight
        if aggregation.uses_delta_combine(self.policy):
            x_new = _tmap(lambda x_, u: x_ + u, state.x,
                          aggregation.async_weighted_sum(
                              out, _tmap(lambda yf, xs: yf - xs, x_fin, x0),
                              agg_ctx))
        elif pol.may_exclude:
            # if every sampled client was excluded, the server keeps its
            # model
            x_new = tree_where(out.n_selected > 0,
                               masked_mean(x_fin, weight, agg_ctx,
                                           weight_sum=out.n_selected),
                               state.x)
        else:
            x_new = agg_ctx.mean_clients(x_fin)
        y_new, down_bits, dl_extras = self._downlink(
            state, x_new, k_dl, s, s * dense_bits(state.x), ctx)
        metrics = self._metrics(self._mean_loss(loss_sum, plan, het),
                                pol.client_up.sum(), down_bits, plan,
                                pol.client_up, out, payload, dl_extras)
        return FedAvgState(x=x_new, round=state.round + 1, y=y_new), metrics


def SparseFedAvg(loss_fn, data, cfg, density: float = 0.1,
                 schedule: ClientSchedule | None = None,
                 policy: aggregation.AggregationPolicy | None = None,
                 wire: str = "account",
                 downlink: str = "dense",
                 downlink_compressor: Compressor | None = None):
    return FedAvg(loss_fn, data, cfg, compressor=TopK(density=density),
                  schedule=schedule, policy=policy, wire=wire,
                  downlink=downlink,
                  downlink_compressor=downlink_compressor)


# --------------------------------------------------------------------------- #
# Scaffold (option II)
# --------------------------------------------------------------------------- #

class ScaffoldState(NamedTuple):
    x: PyTree
    c: PyTree        # server control variate
    ci: PyTree       # per-client control variates: a store slot
    round: int
    y: PyTree = ()   # clients' last-received (x, c) (downlink != "dense")


class Scaffold(_Baseline):
    def __init__(self, loss_fn: LossFn, data: FederatedData, cfg: FedConfig,
                 schedule: ClientSchedule | None = None,
                 policy: aggregation.AggregationPolicy | None = None,
                 wire: str = "account",
                 downlink: str = "dense",
                 downlink_compressor: Compressor | None = None,
                 store=None,
                 meter_mode: str = "host"):
        super().__init__(loss_fn, data, cfg, None, schedule, policy, wire,
                         downlink, downlink_compressor, store, meter_mode)

    def init(self, params0: PyTree) -> ScaffoldState:
        x = _on(params0, self.device)
        c = _tmap(torch.zeros_like, x)
        # the downlink reference is the (x, c) pair the cohort last received
        return ScaffoldState(x=x, c=c,
                             ci=self.store.init_slot("ci", x,
                                                     self.cfg.n_clients),
                             round=0, y=(x, c) if self._dl_on else ())

    @property
    def _round_key_fanout(self) -> int:
        # the reference's split: one more key for the downlink codec
        return 3 if self._dl_on else 2

    def _round_impl(self, state: ScaffoldState, key: torch.Tensor,
                    ctx: ClientAxisCtx = NULL_CTX):
        cfg, sched = self.cfg, self.sched
        s = cfg.clients_per_round
        k_sample, k_local, *k_dl = prng.split(key, self._round_key_fanout)
        clients_full, plan, partf_plan, het = self._cohort(k_sample,
                                                           state.round)
        plan_l, clients = ctx.shard_tree(plan), ctx.shard(clients_full)
        rows = self.store.cohort_index(clients, self.device)
        ci_s = self.store.gather("ci", state.ci, rows)
        # clients work from the (x, c) pair they last received
        x_ref, c_ref = state.y if self._dl_on else (state.x, state.c)
        x0 = _broadcast(x_ref, ctx.local_count(s))

        def adjust(g, x_c):
            return _tmap(lambda gc, cic, cc: gc - cic + cc.unsqueeze(0),
                         g, ci_s, c_ref)

        x_fin, loss_sum = _local_sgd(self.loss_fn, self.data, cfg, x0,
                                     clients, k_local, grad_adjust=adjust,
                                     steps=plan_l.steps if het else None,
                                     ctx=ctx)

        # option II: ci+ = ci - c + (x - y_i) / (K_i * gamma), K_i the steps
        # the client completed
        if het:
            coef = 1.0 / (torch.clamp(plan_l.steps, min=1).to(torch.float32)
                          * cfg.gamma)
            ci_new = _tmap(
                lambda cic, cc, xs, yf: cic - cc.unsqueeze(0)
                + per_client(coef, xs) * (xs - yf),
                ci_s, c_ref, x0, x_fin)
            # a zero-step client did no work: keep its old variate
            ci_new = keep_where(plan_l.steps > 0, ci_new, ci_s)
        else:
            coef = 1.0 / (cfg.local_steps * cfg.gamma)
            ci_new = _tmap(
                lambda cic, cc, xs, yf: cic - cc.unsqueeze(0)
                + coef * (xs - yf), ci_s, c_ref, x0, x_fin)
        # the model and the control variate both go up, dense
        dense = dense_bits(state.x)
        pol = aggregation.resolve_policy(self.policy, sched, plan,
                                         2 * dense * partf_plan, ctx)
        out, may_exclude = pol.out, pol.may_exclude
        if may_exclude:   # excluded stragglers never report; keep ci
            ci_new = keep_where(pol.part, ci_new, ci_s)
        payload = None
        x_up, ci_up, ci_old = x_fin, ci_new, ci_s
        agg_ctx, weight = ctx, pol.weight
        if self.wire == "packed":
            # one dense payload carries (model, variate); the server reads
            # the cohort's old variates from the store itself (the
            # reference's second read) and aggregates the whole decoded
            # stack with the unsharded formula
            payload, _ = ctx.encode_payload(None, plan_l, (x_fin, ci_new))
            x_up, ci_up = ctx.gather_decoded_payload(payload, out.partf)
            ci_old = self.store.gather(
                "ci", state.ci, self.store.cohort_index(clients_full,
                                                        self.device))
            x0 = _broadcast(x_ref, s)
            agg_ctx, weight = NULL_CTX, out.weight
        dx = _combine(self.policy, out, may_exclude,
                      _tmap(lambda yf, xs: yf - xs, x_up, x0), weight,
                      agg_ctx)
        dc = _combine(self.policy, out, may_exclude,
                      _tmap(lambda cn, co: cn - co, ci_up, ci_old), weight,
                      agg_ctx)
        if aggregation.uses_delta_combine(self.policy) or may_exclude:
            s_eff = float(out.n_selected / cfg.n_clients)
        else:
            s_eff = s / cfg.n_clients
        x_new = _tmap(lambda x_, d: x_ + d, state.x, dx)
        c_new = _tmap(lambda c_, d: c_ + s_eff * d, state.c, dc)
        ci_all = self.store.scatter("ci", state.ci, rows, ci_new, ctx)
        up_bits = (pol.client_up.sum() if may_exclude
                   else torch.tensor(2 * s * dense, dtype=torch.float32))
        # one payload delta-codes both halves of the broadcast (model and
        # server control variate) against the cohort's (x, c) reference
        y_new, down_bits, dl_extras = self._downlink(
            state, (x_new, c_new), k_dl, s, 2 * s * dense, ctx)
        metrics = self._metrics(self._mean_loss(loss_sum, plan, het), up_bits,
                                down_bits, plan, pol.client_up, out, payload,
                                dl_extras)
        return (ScaffoldState(x=x_new, c=c_new, ci=ci_all,
                              round=state.round + 1, y=y_new), metrics)


# --------------------------------------------------------------------------- #
# FedDyn
# --------------------------------------------------------------------------- #

class FedDynState(NamedTuple):
    x: PyTree
    h: PyTree        # server correction
    grads: PyTree    # per-client dual variables: a store slot
    round: int
    y: PyTree = ()   # clients' last-received model (downlink != "dense")


class FedDyn(_Baseline):
    def __init__(self, loss_fn: LossFn, data: FederatedData, cfg: FedConfig,
                 schedule: ClientSchedule | None = None,
                 policy: aggregation.AggregationPolicy | None = None,
                 wire: str = "account",
                 downlink: str = "dense",
                 downlink_compressor: Compressor | None = None,
                 store=None,
                 meter_mode: str = "host"):
        super().__init__(loss_fn, data, cfg, None, schedule, policy, wire,
                         downlink, downlink_compressor, store, meter_mode)

    def init(self, params0: PyTree) -> FedDynState:
        x = _on(params0, self.device)
        return FedDynState(x=x, h=_tmap(torch.zeros_like, x),
                           grads=self.store.init_slot("grads", x,
                                                      self.cfg.n_clients),
                           round=0, y=x if self._dl_on else ())

    @property
    def _round_key_fanout(self) -> int:
        # the reference's split: one more key for the downlink codec
        return 3 if self._dl_on else 2

    def _round_impl(self, state: FedDynState, key: torch.Tensor,
                    ctx: ClientAxisCtx = NULL_CTX):
        cfg, sched = self.cfg, self.sched
        s = cfg.clients_per_round
        k_sample, k_local, *k_dl = prng.split(key, self._round_key_fanout)
        clients_full, plan, partf_plan, het = self._cohort(k_sample,
                                                           state.round)
        plan_l, clients = ctx.shard_tree(plan), ctx.shard(clients_full)
        rows = self.store.cohort_index(clients, self.device)
        g_s = self.store.gather("grads", state.grads, rows)
        # clients start from the model they last received
        ref = state.y if self._dl_on else state.x
        x0 = _broadcast(ref, ctx.local_count(s))

        def adjust(g, x_c):
            return _tmap(
                lambda gc, gpc, xc, xs: gc - gpc + cfg.alpha * (xc - xs),
                g, g_s, x_c, x0)

        x_fin, loss_sum = _local_sgd(self.loss_fn, self.data, cfg, x0,
                                     clients, k_local, grad_adjust=adjust,
                                     steps=plan_l.steps if het else None,
                                     ctx=ctx)
        dense = dense_bits(state.x)
        pol = aggregation.resolve_policy(self.policy, sched, plan,
                                         dense * partf_plan, ctx)
        out, may_exclude = pol.out, pol.may_exclude
        g_new = _tmap(lambda gp, yf, xs: gp - cfg.alpha * (yf - xs),
                      g_s, x_fin, x0)
        if may_exclude:   # excluded stragglers keep their dual variables
            g_new = keep_where(pol.part, g_new, g_s)
        grads_all = self.store.scatter("grads", state.grads, rows, g_new,
                                       ctx)
        delta_combine = aggregation.uses_delta_combine(self.policy)
        payload = None
        x_up = x_fin
        agg_ctx, weight = ctx, pol.weight
        if self.wire == "packed":
            # the whole decoded stack, aggregated with the unsharded formula
            payload, _ = ctx.encode_payload(None, plan_l, x_fin)
            x_up, x0 = (ctx.gather_decoded_payload(payload, out.partf),
                        _broadcast(ref, s))
            agg_ctx, weight = NULL_CTX, out.weight
        deltas = _tmap(lambda yf, xs: yf - xs, x_up, x0)
        if delta_combine or may_exclude:
            # the server correction absorbs the (staleness-discounted)
            # delta sum of the clients it applies
            w = agg_ctx.shard(out.discount if delta_combine else out.partf)
            dsum = agg_ctx.psum(_tmap(
                lambda d_: (d_ * per_client(w, d_)).sum(dim=0), deltas))
        else:
            dsum = agg_ctx.sum_clients(deltas)
        h_new = _tmap(
            lambda h_, d_: h_ - cfg.alpha * (1.0 / cfg.n_clients) * d_,
            state.h, dsum)
        if delta_combine:
            x_new = _tmap(
                lambda x_, u, h_: x_ + u - h_ / cfg.alpha, state.x,
                aggregation.async_weighted_sum(out, deltas, agg_ctx), h_new)
            if sched.may_drop:
                # if every sampled client dropped, keep the server model
                x_new = tree_where(out.n_selected > 0, x_new, state.x)
        elif may_exclude:
            x_new = _tmap(lambda ym, h_: ym - h_ / cfg.alpha,
                          masked_mean(x_up, weight, agg_ctx,
                                      weight_sum=out.n_selected), h_new)
            x_new = tree_where(out.n_selected > 0, x_new, state.x)
        else:
            x_new = _tmap(lambda ym, h_: ym - h_ / cfg.alpha,
                          agg_ctx.mean_clients(x_up), h_new)
        up_bits = (pol.client_up.sum() if may_exclude
                   else torch.tensor(s * dense, dtype=torch.float32))
        y_new, down_bits, dl_extras = self._downlink(state, x_new, k_dl, s,
                                                     s * dense, ctx)
        metrics = self._metrics(self._mean_loss(loss_sum, plan, het), up_bits,
                                down_bits, plan, pol.client_up, out, payload,
                                dl_extras)
        return (FedDynState(x=x_new, h=h_new, grads=grads_all,
                            round=state.round + 1, y=y_new), metrics)
