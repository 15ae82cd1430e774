"""LoCoDL (arXiv 2403.04348): local training with bidirectional
compression, the fifth algorithm on the shared round contract — the port
of ``repro.core.locodl``.

LoCoDL keeps Scaffnew's local phases and per-client control variates but
compresses both links: clients send ``u_i = C_up(x^_i - y^)`` (their local
result against the shared reference model) and the server sends ``m``
from the cohort's aggregate ``v`` of those messages.  A round (probability
``p``, stepsize ``gamma``, communication stepsize ``lam``):

* local phase: Geometric(p) (or fixed round(1/p)) Scaffnew steps on each
  sampled client's own iterate, ``x_i <- x_i - gamma (grad f_i(x_i) - h_i)``;
* reference step: the server model carries no loss term, so its phase is
  ``y^ = y + gamma hy``;
* uplink: ``u_i = C_up(x^_i - y^)`` on either wire, aggregated to ``v``
  under the bound policy (sync mean, semi-sync masked mean with ``v = 0``
  when every client is excluded, async staleness-weighted sum);
* downlink: ``m`` from ``v`` through the downlink seam against a zero
  reference (``v`` is already a difference): ``"dense"`` sends ``v``,
  ``"account"``/``"packed"`` run the downlink compressor;
* updates: ``x_i <- x^_i - lam (u_i - m)``, ``y <- y^ + lam m``,
  ``h_i += (p/gamma)(x_i' - x^_i)``, ``hy += (p/gamma) lam m``; a
  policy-excluded straggler keeps its pre-round iterate and variate.

With Identity links, ``lam = 1`` and the sync policy every client lands on
``y = mean_i(x^_i)``: Scaffnew's communication round.  The round consumes
the reference's key chain exactly: one 5-way split in every downlink mode
(dense never uses the fifth key), ``split(k_local, cap)`` per step and
``split(k_step, s)`` per client, each client's key drawing its batch.

State: the per-client iterates ``xs`` and variates ``h`` live behind the
client-store contract (``store=``, DESIGN.md §11), gathered and scattered
by cohort index: stacked ``(n_clients, ...)`` on the device by default, or
on the host in a ``HostStore``, where ``xs``'s broadcast start is one fill
row; the shared reference ``y`` sits in the ``x`` slot that ``round``,
``run_rounds`` and the eval hooks read.  The round body takes a
client-axis ``ctx`` (DESIGN.md §6), as FedComLoc's does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch import prng
from repro_torch import tree as tree_util
from repro_torch.compress import Compressor, Identity, dense_bits
from repro_torch.core import aggregation, comm
from repro_torch.core.clients import (
    NULL_CTX, ClientAxisCtx, ClientSchedule, apply_downlink, batched_compress,
    keep_where, masked_mean, mean_over_active, payload_metrics, tree_where,
    validate_schedule)
from repro_torch.core.engine import RoundEngine, value_and_grad
from repro_torch.core.fed_data import FederatedData
from repro_torch.core.fedcomloc import geometric_steps

PyTree = Any
LossFn = Callable[[PyTree, torch.Tensor, torch.Tensor], torch.Tensor]


class LoCoDLState(NamedTuple):
    x: PyTree          # shared reference model y (the evaluable one)
    xs: PyTree         # per-client iterates: a store slot
    h: PyTree          # per-client control variates: a store slot
    hy: PyTree         # reference-model control variate
    round: int         # communication rounds completed


@dataclasses.dataclass(frozen=True)
class LoCoDLConfig:
    gamma: float = 0.1                 # local stepsize
    p: float = 0.1                     # communication probability
    lam: float = 0.5                   # communication stepsize (lambda)
    n_clients: int = 100
    clients_per_round: int = 10
    batch_size: int = 32
    local_steps: str = "fixed"         # fixed | geometric
    max_local_steps: Optional[int] = None  # cap (geometric); default 4/p

    def __post_init__(self):
        if not (0 < self.p <= 1):
            raise ValueError("p must be in (0, 1]")
        if not (0 < self.lam <= 1):
            raise ValueError("lam must be in (0, 1]")
        if self.n_clients <= 0:
            raise ValueError("n_clients must be positive")
        if not (0 < self.clients_per_round <= self.n_clients):
            raise ValueError(
                f"clients_per_round must be in [1, n_clients]: got "
                f"{self.clients_per_round} with n_clients={self.n_clients}")
        if self.local_steps not in ("fixed", "geometric"):
            raise ValueError('local_steps must be "fixed" or "geometric"')

    @property
    def steps_cap(self) -> int:
        if self.max_local_steps is not None:
            return self.max_local_steps
        if self.local_steps == "fixed":
            return max(1, round(1.0 / self.p))
        return max(1, round(4.0 / self.p))


class LoCoDL(RoundEngine):
    """Bidirectionally compressed Scaffnew on the shared engine contract."""

    def __init__(self, loss_fn: LossFn, data: FederatedData,
                 config: LoCoDLConfig,
                 compressor: Compressor | None = None,
                 schedule: ClientSchedule | None = None,
                 policy: aggregation.AggregationPolicy | None = None,
                 wire: str = "account",
                 downlink: str = "dense",
                 downlink_compressor: Compressor | None = None,
                 store=None,
                 meter_mode: str = "host"):
        self.loss_fn = loss_fn
        self.data = data
        self.cfg = config
        self.policy = policy
        self.wire = wire
        self.downlink = downlink
        self.down_comp = downlink_compressor
        self.store = store
        self.comp = compressor if compressor is not None else Identity()
        self.sched = validate_schedule(
            schedule if schedule is not None
            else ClientSchedule.homogeneous(config.n_clients),
            config.n_clients, self.comp)
        self.meter = comm.CommMeter(mode=meter_mode)
        self._setup_engine()

    @property
    def device(self) -> torch.device:
        return self.data.device

    def init(self, params0: PyTree) -> LoCoDLState:
        n = self.cfg.n_clients
        x = tree_util.map(lambda p: p.detach().to(self.device), params0)
        # every client's iterate starts at the broadcast model, the
        # variates at zero
        return LoCoDLState(x=x,
                           xs=self.store.init_slot("xs", x, n,
                                                   init="broadcast"),
                           h=self.store.init_slot("h", x, n),
                           hy=tree_util.map(torch.zeros_like, x), round=0)

    def _num_local_steps(self, key: torch.Tensor) -> int:
        cap = self.cfg.steps_cap
        if self.cfg.local_steps == "fixed":
            return cap
        return int(geometric_steps(prng.uniform(key, 1), self.cfg.p, cap)[0])

    # one 5-way split in every downlink mode
    _round_key_fanout = 5

    def _round_impl(self, state: LoCoDLState, key: torch.Tensor,
                    ctx: ClientAxisCtx = NULL_CTX):
        cfg, sched = self.cfg, self.sched
        # LoCoDL always has a downlink leg, so every mode shares one key
        # chain; the dense mode never uses k_dl
        k_sample, k_steps, k_local, k_up, k_dl = prng.split(key, 5)
        s = cfg.clients_per_round
        s_loc = ctx.local_count(s)
        clients_full, avail = sched.sample_cohort(k_sample, s, state.round,
                                                  device=self.device)
        num_steps = self._num_local_steps(k_steps)
        plan = sched.plan(clients_full, num_steps, available=avail)
        plan_l, clients = ctx.shard_tree(plan), ctx.shard(clients_full)
        rows = self.store.cohort_index(clients, self.device)

        h_s = self.store.gather("h", state.h, rows)
        # clients resume their own iterates: there is no model broadcast
        x0 = self.store.gather("xs", state.xs, rows)

        # step j, client i draws its batch with split(split(k_local,
        # cap)[j], s)[i] (the full split sliced to the shard's clients);
        # as in FedComLoc, only the num_steps steps that can have an
        # active client run
        step_keys = prng.split(k_local, cfg.steps_cap)[:num_steps]
        client_keys = ctx.shard(
            prng.split(step_keys, s).transpose(0, 1)).transpose(0, 1)
        xb_all, yb_all = self.data.sample_batch(
            client_keys, clients.unsqueeze(0).expand(num_steps, s_loc),
            cfg.batch_size)
        x_i = x0
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        for j in range(num_steps):
            active = j < plan_l.steps                    # (s_loc,) host mask
            losses, g = value_and_grad(self.loss_fn, x_i, xb_all[j],
                                       yb_all[j])
            x_new = tree_util.map(
                lambda xc, gc, hc: xc - cfg.gamma * (gc - hc), x_i, g, h_s)
            x_i = x_new if bool(active.all()) else keep_where(active, x_new,
                                                              x_i)
            loss_sum = loss_sum + mean_over_active(losses, active, ctx)
        x_hat = x_i

        # reference phase: the server objective is g = 0, so its local
        # phase is the closed-form drift along its control variate
        y_hat = tree_util.map(lambda y, hy: y + cfg.gamma * hy, state.x,
                              state.hy)

        # --- uplink: u_i = C_up(x^_i - y^) ------------------------------- #
        diff = tree_util.map(lambda xh, yh: xh - yh.unsqueeze(0), x_hat,
                             y_hat)
        wire_on = self.wire == "packed"
        up_keys = ctx.shard(prng.split(k_up, s))
        payload = None
        if wire_on:
            payload, up_rep = ctx.encode_payload(self.comp, plan_l, diff,
                                                 up_keys)
        else:
            u, up_rep = batched_compress(self.comp, plan_l, diff, up_keys)
        pol = aggregation.resolve_policy(
            self.policy, sched, plan,
            ctx.all_clients(up_rep.total_bits.cpu())
            * plan.participating.to(torch.float32), ctx)
        out, part, may_exclude = pol.out, pol.part, pol.may_exclude
        u_agg, agg_ctx, weight = None, ctx, pol.weight
        if wire_on:
            # one server-side decode of the masked packed stack, aggregated
            # whole with the unsharded formula; the shard's rows of it are
            # what its clients sent
            u_agg = ctx.gather_decoded_payload(payload, out.partf)
            u = ctx.shard_tree(u_agg)
            agg_ctx, weight = NULL_CTX, out.weight
        else:
            u_agg = u

        # --- aggregate v under the policy -------------------------------- #
        if aggregation.uses_delta_combine(self.policy):
            v = aggregation.async_weighted_sum(out, u_agg, agg_ctx)
        elif may_exclude:
            # all-excluded rounds send m from v = 0: y drifts only by its
            # control variate
            v = tree_where(out.n_selected > 0,
                           masked_mean(u_agg, weight, agg_ctx,
                                       weight_sum=out.n_selected),
                           tree_util.map(torch.zeros_like, y_hat))
        else:
            v = agg_ctx.mean_clients(u_agg)

        # --- downlink: m from v, delta-coded against a zero reference ---- #
        if self.downlink != "dense":
            m, down_bits, dl_extras = apply_downlink(
                self.downlink, self.down_comp, ctx,
                tree_util.map(torch.zeros_like, v), v, k_dl, s)
        else:
            m, dl_extras = v, {}
            down_bits = torch.tensor(s * dense_bits(state.x),
                                     dtype=torch.float32)

        # --- updates ----------------------------------------------------- #
        xs_rows = tree_util.map(
            lambda xh, ui, mm: xh - cfg.lam * (ui - mm.unsqueeze(0)),
            x_hat, u, m)
        h_rows = tree_util.map(
            lambda h, xn, xh: h + (cfg.p / cfg.gamma) * (xn - xh),
            h_s, xs_rows, x_hat)
        if may_exclude:
            # an excluded straggler neither sent u_i nor received m
            xs_rows = keep_where(part, xs_rows, x0)
            h_rows = keep_where(part, h_rows, h_s)
        xs_new = self.store.scatter("xs", state.xs, rows, xs_rows, ctx)
        h_new = self.store.scatter("h", state.h, rows, h_rows, ctx)
        y_new = tree_util.map(lambda yh, mm: yh + cfg.lam * mm, y_hat, m)
        hy_new = tree_util.map(
            lambda hy, mm: hy + (cfg.p / cfg.gamma) * cfg.lam * mm,
            state.hy, m)

        metrics = {
            "train_loss": loss_sum / max(int(plan.steps.max()), 1),
            "num_local_steps": torch.tensor(num_steps, dtype=torch.int32),
            "uplink_bits": pol.client_up.sum(),
            "downlink_bits": down_bits,
            "client_steps": plan.steps,
            "client_uplink_bits": pol.client_up,
            "client_finish": out.finish,
            "sim_time": out.sim_time,
            **aggregation.policy_metrics(out),
        }
        if wire_on:
            metrics.update(payload_metrics(payload, out.partf))
        metrics.update(dl_extras)
        return (LoCoDLState(x=y_new, xs=xs_new, h=h_new, hy=hy_new,
                            round=state.round + 1), metrics)
