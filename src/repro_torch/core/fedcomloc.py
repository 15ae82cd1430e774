"""FedComLoc (paper Algorithm 1) — Scaffnew + compression, three variants.
The port of ``repro.core.fedcomloc``.

* line 7  (FedComLoc-Local):  g_i evaluated at C(x_i);
* line 8  (FedComLoc-Com):    uplink iterate compressed, x^_i <- C(x^_i);
* line 11 (FedComLoc-Global): averaged iterate compressed before broadcast;
* line 16: h_i <- h_i + (p/gamma)(x_{t+1} - x^_{i,t+1}).

``variant="none"`` with ``Identity`` is Scaffnew.  The round consumes the
reference's key chain exactly — the 5-way split (6-way with a compressed
downlink, whose codec takes the sixth key), ``split(k_local, cap)``
per local step, ``split(k_step, s)`` per client and ``split(kc)`` into
batch and compression keys — so cohorts, batches and Q_r uniforms equal
the reference's bit for bit.

The cohort's local SGD is batched: the server model is broadcast to
``(s, ...)`` stacked rows and every step is one stacked forward/backward
(``torch.bmm``) for all sampled clients.  Compression runs one kernel
launch per leaf for the whole cohort.  Under ``wire="packed"`` the
cohort's uplink is encoded into real packed payloads at the client
boundary, non-participants' buffers are masked, and the server decodes
the stack once (DESIGN.md §8).  Under ``downlink="account"`` or
``"packed"`` the broadcast is delta-coded against the cohort's
last-received model ``y`` (DESIGN.md §10): the cohort restarts from ``y``
and the control variates update against the decoded ``y``.  Ported:
heterogeneous schedules (per-client step masks under a straggler
deadline, drop-out, per-client compressor overrides), the sync, semi_sync
and async_buffered policies (DESIGN.md §7), both wires, the three
downlink modes, ``local_steps="fixed"`` and ``"geometric"``, and the
beyond-paper leaky error feedback on the Com uplink and Polyak server
momentum.  The per-client ``h`` and EF memory ``e`` live behind the
client-store contract (``store=``, DESIGN.md §11): stacked on the device
by default, or on the host with :class:`~repro_torch.core.client_store.
HostStore` for populations the device cannot hold.  Every cross-client
operation goes through a :class:`~repro_torch.core.clients.ClientAxisCtx`
(``ctx``): unsharded by default, or a rank's slice of the cohort under a
client-axis mesh (``use_mesh``, DESIGN.md §6).
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

PyTree = Any
LossFn = Callable[[PyTree, torch.Tensor, torch.Tensor], torch.Tensor]

VARIANTS = ("none", "com", "local", "global")


class FedComLocState(NamedTuple):
    x: PyTree          # server model (broadcast value), on the device
    h: PyTree          # control variates: a store slot (stacked (n, ...)
                       # in memory, a version token in a HostStore)
    round: int         # communication rounds completed
    e: PyTree = ()     # per-client error-feedback memory, a slot like h
    mom: PyTree = ()   # server momentum buffer
    y: PyTree = ()     # clients' last-received model (downlink != "dense")


@dataclasses.dataclass(frozen=True)
class FedComLocConfig:
    gamma: float = 0.1                 # local stepsize
    p: float = 0.1                     # communication probability
    n_clients: int = 100
    clients_per_round: int = 10
    batch_size: int = 32
    variant: str = "com"               # none | com | local | global
    local_steps: str = "fixed"         # fixed | geometric
    max_local_steps: Optional[int] = None  # cap (geometric); default 4/p
    # ---- beyond-paper extensions ------------------------------------------ #
    error_feedback: bool = False       # leaky delta-EF on the Com uplink
    ef_decay: float = 0.7              # EF memory leak (1.0 diverges here)
    server_momentum: float = 0.0       # Polyak momentum on the server mean

    def __post_init__(self):
        if self.variant not in VARIANTS:
            raise ValueError(f"variant must be one of {VARIANTS}")
        if not (0 < self.p <= 1):
            raise ValueError("p must be in (0, 1]")
        if self.n_clients <= 0:
            raise ValueError("n_clients must be positive")
        if not (0 < self.clients_per_round <= self.n_clients):
            raise ValueError(
                f"clients_per_round must be in [1, n_clients]: got "
                f"{self.clients_per_round} with n_clients={self.n_clients}")
        if self.local_steps not in ("fixed", "geometric"):
            raise ValueError('local_steps must be "fixed" or "geometric"')
        if self.error_feedback and self.variant != "com":
            raise ValueError("error_feedback applies to the Com variant")
        if not (0.0 <= self.server_momentum < 1.0):
            raise ValueError("server_momentum must be in [0, 1)")

    @property
    def steps_cap(self) -> int:
        if self.max_local_steps is not None:
            return self.max_local_steps
        if self.local_steps == "fixed":
            return max(1, round(1.0 / self.p))
        return max(1, round(4.0 / self.p))


def geometric_steps(u: torch.Tensor, p: float, cap: int) -> torch.Tensor:
    """Local steps of a Geometric(p) phase truncated at ``cap`` — the
    iterations until the coin lands 1 — from float32 uniforms ``u``:
    ``clip(floor(log1p(-u) / log1p(-p)) + 1, 1, cap)`` as int32, in
    float32 as the reference computes it."""
    num = torch.log1p(-u.to(torch.float32))
    den = torch.log1p(torch.tensor(-p, dtype=torch.float32))
    g = torch.floor(num / den).to(torch.int32) + 1
    return torch.clamp(g, 1, cap)


class FedComLoc(RoundEngine):
    """Algorithm 1.  ``variant="none"`` with Identity compression = Scaffnew."""

    def __init__(self, loss_fn: LossFn, data: FederatedData,
                 config: FedComLocConfig,
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
        if config.variant == "none" and not isinstance(self.comp, Identity):
            raise ValueError('variant="none" requires the Identity compressor')
        self.sched = validate_schedule(
            schedule if schedule is not None
            else ClientSchedule.homogeneous(config.n_clients),
            config.n_clients, self.comp)
        self.meter = comm.CommMeter(mode=meter_mode)
        self._setup_engine()

    @property
    def device(self) -> torch.device:
        return self.data.device

    def _validate_downlink_combo(self) -> None:
        if self.downlink == "dense":
            return
        if self.cfg.variant == "global":
            raise ValueError(
                'variant="global" already compresses the broadcast its own '
                "way (line 11); combine the downlink seam with the other "
                "variants, or keep variant='global' with downlink='dense'")
        if self.cfg.server_momentum > 0:
            raise ValueError(
                "server_momentum extrapolates the broadcast point, which "
                "the delta-coded downlink reference cannot track stably; "
                "use downlink='dense' with momentum")

    def init(self, params0: PyTree) -> FedComLocState:
        n = self.cfg.n_clients
        x = tree_util.map(lambda p: p.detach().to(self.device), params0)
        e = (self.store.init_slot("e", x, n) if self.cfg.error_feedback
             else ())
        mom = (tree_util.map(torch.zeros_like, x)
               if self.cfg.server_momentum > 0 else ())
        y = x if self.downlink != "dense" else ()
        return FedComLocState(x=x, h=self.store.init_slot("h", x, n),
                              round=0, e=e, mom=mom, y=y)

    def _num_local_steps(self, key: torch.Tensor) -> int:
        cap = self.cfg.steps_cap
        if self.cfg.local_steps == "fixed":
            return cap
        # Geometric(p) truncated at cap, from jax.random.uniform(key)
        return int(geometric_steps(prng.uniform(key, 1), self.cfg.p, cap)[0])

    @property
    def _round_key_fanout(self) -> int:
        # the reference's split: one more key for the downlink codec; the
        # dense split stays 5-way
        return 6 if self.downlink != "dense" else 5

    def _round_impl(self, state: FedComLocState, key: torch.Tensor,
                    ctx: ClientAxisCtx = NULL_CTX):
        cfg, sched = self.cfg, self.sched
        dl_on = self.downlink != "dense"
        k_sample, k_steps, k_local, k_up, k_down, *k_dl = prng.split(
            key, self._round_key_fanout)
        s = cfg.clients_per_round
        s_loc = ctx.local_count(s)
        clients_full, avail = sched.sample_cohort(k_sample, s, state.round,
                                                  device=self.device)
        num_steps = self._num_local_steps(k_steps)
        # the full (s,) plan is computed on every shard (the metrics use
        # it); the per-client work below runs on this shard's slice
        plan = sched.plan(clients_full, num_steps, available=avail)
        plan_l = ctx.shard_tree(plan)
        clients = ctx.shard(clients_full)
        partf_plan_full = plan.participating.to(torch.float32)
        dev = self.device
        rows = self.store.cohort_index(clients, dev)

        h_s = self.store.gather("h", state.h, rows)
        # with a compressed downlink the cohort restarts from the model
        # the clients hold (y, last received), and every client-side
        # anchor below (EF innovation, FedBuff delta) is that model
        ref = state.y if dl_on else state.x
        x_i = tree_util.map(
            lambda p: p.unsqueeze(0).expand((s_loc,) + tuple(p.shape)).clone(),
            ref)

        # the whole round's key chain at once: step j, client i draws
        # split(split(split(k_local, cap)[j], s)[i]) -> (batch, compress),
        # the full (s,) split sliced to this shard's clients.
        # The reference scans all cap steps and masks each client past its
        # planned count (step_idx < plan.steps); a step with no active
        # client changes nothing and adds 0 to the loss, so only the
        # num_steps steps that can be active run here.
        step_keys = prng.split(k_local, cfg.steps_cap)[:num_steps]
        client_keys = ctx.shard(
            prng.split(step_keys, s).transpose(0, 1)).transpose(0, 1)
        kb_kc = prng.split(client_keys, 2)           # (steps, s_loc, 2, 2)
        xb_all, yb_all = self.data.sample_batch(
            kb_kc[..., 0, :], clients.unsqueeze(0).expand(num_steps, s_loc),
            cfg.batch_size)

        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        for j in range(num_steps):
            active = j < plan_l.steps                    # (s_loc,) host mask
            x_eval = (self.comp.apply(x_i, kb_kc[j, :, 1],
                                      **plan_l.comp_overrides)
                      if cfg.variant == "local" else x_i)
            losses, g = value_and_grad(self.loss_fn, x_eval, xb_all[j],
                                       yb_all[j])
            x_new = tree_util.map(
                lambda xc, gc, hc: xc - cfg.gamma * (gc - hc), x_i, g, h_s)
            x_i = x_new if bool(active.all()) else keep_where(active, x_new,
                                                              x_i)
            loss_sum = loss_sum + mean_over_active(losses, active, ctx)
        x_hat = x_i

        # --- communication (theta_t = 1) --------------------------------- #
        dense = dense_bits(state.x)
        client_up = torch.full((s_loc,), dense, dtype=torch.float32)
        up_bits = torch.tensor(s * dense, dtype=torch.float32)
        down_bits = torch.tensor(s * dense, dtype=torch.float32)
        wire_on = self.wire == "packed"
        ef_on = cfg.variant == "com" and cfg.error_feedback
        if cfg.variant == "com":
            up_keys = ctx.shard(prng.split(k_up, s))
            if ef_on:
                # EF on the uplink innovation: clients send
                # C(x^_i - x + e_i), the server rebuilds x + sent, and the
                # residual stays in e_i; the bits are the innovation's
                e_s = self.store.gather("e", state.e, rows)
                innov = tree_util.map(
                    lambda xh, x0, e: xh - x0.unsqueeze(0) + e,
                    x_hat, ref, e_s)
                up_tree = innov
            else:
                up_tree = x_hat
            if wire_on:
                # the client boundary emits the packed payload; the round
                # carries on with the server's decode of it
                payload, up_rep = ctx.encode_payload(self.comp, plan_l,
                                                     up_tree, up_keys)
            else:
                sent, up_rep = batched_compress(self.comp, plan_l, up_tree,
                                                up_keys)
            client_up = up_rep.total_bits.cpu()
            up_bits = None
        elif wire_on:
            # uncompressed-uplink variants still move a real dense buffer
            payload, _ = ctx.encode_payload(None, plan_l, x_hat)

        # --- aggregation policy (DESIGN.md §7) --------------------------- #
        # the policy runs on the full (s,) bits, the same on every shard
        pol = aggregation.resolve_policy(
            self.policy, sched, plan,
            ctx.all_clients(client_up) * partf_plan_full, ctx)
        out, part, may_exclude = pol.out, pol.part, pol.may_exclude
        client_up = pol.client_up             # excluded clients send nothing
        if up_bits is None or may_exclude:
            up_bits = client_up.sum()
        if wire_on:
            # decode once, server-side, on the full masked stack; the
            # shard's rows of it are what its clients sent.  Non-com
            # variants ship the raw iterate, so x_hat keeps its rows.
            dec_full = ctx.gather_decoded_payload(payload, out.partf)
            srv_hat = dec_full
            if cfg.variant == "com":
                sent = ctx.shard_tree(dec_full)
                if ef_on:
                    srv_hat = tree_util.map(
                        lambda x0, snt: x0.unsqueeze(0) + snt, ref, dec_full)
        if cfg.variant == "com":
            x_hat = (tree_util.map(lambda x0, snt: x0.unsqueeze(0) + snt,
                                   ref, sent) if ef_on else sent)
        e_new = state.e
        if ef_on:
            # leaky memory: undecayed EF diverges inside Scaffnew
            e_s_new = tree_util.map(lambda c, snt: cfg.ef_decay * (c - snt),
                                    innov, sent)
            if may_exclude:    # an excluded client never transmitted
                e_s_new = keep_where(part, e_s_new, e_s)
            e_new = self.store.scatter("e", state.e, rows, e_s_new, ctx)
        # the server's aggregate: on the packed wire from the full decoded
        # stack with the unsharded formula, else from the shards' rows
        agg_hat, agg_ctx, weight = ((srv_hat, NULL_CTX, out.weight)
                                    if wire_on else (x_hat, ctx, pol.weight))
        if aggregation.uses_delta_combine(self.policy):
            # FedBuff server application in delta form: each buffer flush
            # applies its staleness-discounted mean of anchor deltas
            delta = tree_util.map(lambda xh, x0: xh - x0.unsqueeze(0),
                                  agg_hat, ref)
            x_bar = tree_util.map(
                lambda x0, u: x0 + u, state.x,
                aggregation.async_weighted_sum(out, delta, agg_ctx))
        elif may_exclude:
            # if every sampled client was excluded, the server keeps its
            # model
            x_bar = tree_where(out.n_selected > 0,
                               masked_mean(agg_hat, weight, agg_ctx,
                                           weight_sum=out.n_selected),
                               state.x)
        else:
            x_bar = agg_ctx.mean_clients(agg_hat)
        if cfg.variant == "global":
            x_bar, down_rep = self.comp.compress(
                tree_util.map(lambda t: t.unsqueeze(0), x_bar),
                k_down.unsqueeze(0))
            x_bar = tree_util.map(lambda t: t[0], x_bar)
            down_bits = down_rep.total_bits[0].cpu() * s

        # the downlink seam: delta-code the new broadcast against the
        # cohort's reference, once; every client adopts the decoded y_new
        y_new = state.y
        dl_extras = {}
        if dl_on:
            y_new, down_bits, dl_extras = apply_downlink(
                self.downlink, self.down_comp, ctx, state.y, x_bar, k_dl[0],
                s)
        bcast = y_new if dl_on else x_bar

        # line 16: h_i += (p/gamma) (x_{t+1} - x^_{i,t+1}) for i in S, with
        # x_{t+1} the model the clients adopt
        h_s_new = tree_util.map(
            lambda h, xh, xb_: h + (cfg.p / cfg.gamma) * (xb_.unsqueeze(0) - xh),
            h_s, x_hat, bcast)
        if may_exclude:   # an excluded client keeps its control variate
            h_s_new = keep_where(part, h_s_new, h_s)
        h_new = self.store.scatter("h", state.h, rows, h_s_new, ctx)

        # beyond-paper: Polyak momentum on the broadcast point only (the
        # control variates above saw the plain mean)
        mom_new = state.mom
        if cfg.server_momentum > 0:
            m = cfg.server_momentum
            mom_new = tree_util.map(
                lambda mo, xb_, x0: m * mo + (1 - m) * (xb_ - x0),
                state.mom, x_bar, state.x)
            x_bar = tree_util.map(lambda x0, mo: x0 + mo, state.x, mom_new)

        metrics = {
            "train_loss": loss_sum / max(int(plan.steps.max()), 1),
            "num_local_steps": torch.tensor(num_steps, dtype=torch.int32),
            "uplink_bits": up_bits,
            "downlink_bits": down_bits,
            "client_steps": plan.steps,
            "client_uplink_bits": client_up,
            "client_finish": out.finish,
            "sim_time": out.sim_time,
            **aggregation.policy_metrics(out),
        }
        if wire_on:
            metrics.update(payload_metrics(payload, out.partf))
        metrics.update(dl_extras)
        return (FedComLocState(x=x_bar, h=h_new, round=state.round + 1,
                               e=e_new, mom=mom_new, y=y_new), metrics)
