"""FedComLoc (paper Algorithm 1) — Scaffnew + compression, three variants.
The port of ``repro.core.fedcomloc``.

* line 7  (FedComLoc-Local):  g_i evaluated at C(x_i);
* line 8  (FedComLoc-Com):    uplink iterate compressed, x^_i <- C(x^_i);
* line 11 (FedComLoc-Global): averaged iterate compressed before broadcast;
* line 16: h_i <- h_i + (p/gamma)(x_{t+1} - x^_{i,t+1}).

``variant="none"`` with ``Identity`` is Scaffnew.  The round consumes the
reference's key chain exactly — the 5-way split, ``split(k_local, cap)``
per local step, ``split(k_step, s)`` per client and ``split(kc)`` into
batch and compression keys — so cohorts, batches and Q_r uniforms equal
the reference's bit for bit.

The cohort's local SGD is batched: the server model is broadcast to
``(s, ...)`` stacked rows and every step is one stacked forward/backward
(``torch.bmm``) for all sampled clients.  Compression runs one kernel
launch per leaf for the whole cohort.  Under ``wire="packed"`` the
cohort's uplink is encoded into real packed payloads at the client
boundary, non-participants' buffers are masked, and the server decodes
the stack once (DESIGN.md §8).  Ported: heterogeneous schedules (per-client
step masks under a straggler deadline, drop-out), the sync, semi_sync and
async_buffered policies (DESIGN.md §7), ``wire="account"`` and
``"packed"``, ``downlink="dense"``, ``local_steps="fixed"`` and
``"geometric"``, and the beyond-paper leaky error feedback on the Com
uplink and Polyak server momentum.  Other downlinks and client stores are
not yet ported.
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
    ClientSchedule, batched_compress, gather_decoded, keep_where,
    masked_mean, mean_over_active, payload_metrics, tree_where,
    validate_schedule, vmap_encode)
from repro_torch.core.engine import RoundEngine, value_and_grad
from repro_torch.core.fed_data import FederatedData

PyTree = Any
LossFn = Callable[[PyTree, torch.Tensor, torch.Tensor], torch.Tensor]

VARIANTS = ("none", "com", "local", "global")


class FedComLocState(NamedTuple):
    x: PyTree          # server model (broadcast value), on the device
    h: PyTree          # control variates, stacked (n_clients, ...)
    round: int         # communication rounds completed
    e: PyTree = ()     # per-client error-feedback memory, stacked like h
    mom: PyTree = ()   # server momentum buffer


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
                 store=None,
                 meter_mode: str = "host"):
        self.loss_fn = loss_fn
        self.data = data
        self.cfg = config
        self.policy = policy
        self.wire = wire
        self.downlink = downlink
        self.store = store
        self.comp = compressor if compressor is not None else Identity()
        if config.variant == "none" and not isinstance(self.comp, Identity):
            raise ValueError('variant="none" requires the Identity compressor')
        self.sched = validate_schedule(
            schedule if schedule is not None
            else ClientSchedule.homogeneous(config.n_clients),
            config.n_clients)
        self.meter = comm.CommMeter(mode=meter_mode)
        self._setup_engine()

    @property
    def device(self) -> torch.device:
        return self.data.device

    def init(self, params0: PyTree) -> FedComLocState:
        n = self.cfg.n_clients
        x = tree_util.map(lambda p: p.detach().to(self.device), params0)

        def stacked_zeros(p):
            return torch.zeros((n,) + tuple(p.shape), dtype=p.dtype,
                               device=p.device)

        e = (tree_util.map(stacked_zeros, x) if self.cfg.error_feedback
             else ())
        mom = (tree_util.map(torch.zeros_like, x)
               if self.cfg.server_momentum > 0 else ())
        return FedComLocState(x=x, h=tree_util.map(stacked_zeros, x),
                              round=0, e=e, mom=mom)

    def _num_local_steps(self, key: torch.Tensor) -> int:
        cap = self.cfg.steps_cap
        if self.cfg.local_steps == "fixed":
            return cap
        # Geometric(p) truncated at cap, from jax.random.uniform(key)
        return int(geometric_steps(prng.uniform(key, 1), self.cfg.p, cap)[0])

    @property
    def _round_key_fanout(self) -> int:
        return 5          # the reference's split with a dense downlink

    def _round_impl(self, state: FedComLocState, key: torch.Tensor):
        cfg, sched = self.cfg, self.sched
        k_sample, k_steps, k_local, k_up, k_down = prng.split(
            key, self._round_key_fanout)
        s = cfg.clients_per_round
        clients, _ = sched.sample_cohort(k_sample, s, state.round)
        num_steps = self._num_local_steps(k_steps)
        plan = sched.plan(clients, num_steps)
        dev = self.device
        rows = clients.to(dev)

        h_s = tree_util.map(lambda h: h[rows], state.h)
        x_i = tree_util.map(
            lambda p: p.unsqueeze(0).expand((s,) + tuple(p.shape)).clone(),
            state.x)

        # the whole round's key chain at once: step j, client i draws
        # split(split(split(k_local, cap)[j], s)[i]) -> (batch, compress).
        # The reference scans all cap steps and masks each client past its
        # planned count (step_idx < plan.steps); a step with no active
        # client changes nothing and adds 0 to the loss, so only the
        # num_steps steps that can be active run here.
        step_keys = prng.split(k_local, cfg.steps_cap)[:num_steps]
        client_keys = prng.split(step_keys, s)           # (steps, s, 2)
        kb_kc = prng.split(client_keys, 2)               # (steps, s, 2, 2)
        xb_all, yb_all = self.data.sample_batch(
            kb_kc[..., 0, :], clients.unsqueeze(0).expand(num_steps, s),
            cfg.batch_size)

        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        for j in range(num_steps):
            active = j < plan.steps                      # (s,) host mask
            x_eval = (self.comp.apply(x_i, kb_kc[j, :, 1])
                      if cfg.variant == "local" else x_i)
            losses, g = value_and_grad(self.loss_fn, x_eval, xb_all[j],
                                       yb_all[j])
            x_new = tree_util.map(
                lambda xc, gc, hc: xc - cfg.gamma * (gc - hc), x_i, g, h_s)
            x_i = x_new if bool(active.all()) else keep_where(active, x_new,
                                                              x_i)
            loss_sum = loss_sum + mean_over_active(losses, active)
        x_hat = x_i

        # --- communication (theta_t = 1) --------------------------------- #
        dense = dense_bits(state.x)
        client_up = torch.full((s,), dense, dtype=torch.float32)
        up_bits = torch.tensor(s * dense, dtype=torch.float32)
        down_bits = torch.tensor(s * dense, dtype=torch.float32)
        wire_on = self.wire == "packed"
        ef_on = cfg.variant == "com" and cfg.error_feedback
        if cfg.variant == "com":
            up_keys = prng.split(k_up, s)
            if ef_on:
                # EF on the uplink innovation: clients send
                # C(x^_i - x + e_i), the server rebuilds x + sent, and the
                # residual stays in e_i; the bits are the innovation's
                e_s = tree_util.map(lambda e: e[rows], state.e)
                innov = tree_util.map(
                    lambda xh, x0, e: xh - x0.unsqueeze(0) + e,
                    x_hat, state.x, e_s)
                up_tree = innov
            else:
                up_tree = x_hat
            if wire_on:
                # the client boundary emits the packed payload; the round
                # carries on with the server's decode of it
                payload, up_rep = vmap_encode(self.comp, plan, up_tree,
                                              up_keys)
            else:
                sent, up_rep = batched_compress(self.comp, plan, up_tree,
                                                up_keys)
            client_up = up_rep.total_bits.cpu()
            up_bits = None
        elif wire_on:
            # uncompressed-uplink variants still move a real dense buffer
            payload, _ = vmap_encode(None, plan, x_hat)

        # --- aggregation policy (DESIGN.md §7) --------------------------- #
        pol = aggregation.resolve_policy(
            self.policy, sched, plan,
            client_up * plan.participating.to(torch.float32))
        out, may_exclude = pol.out, pol.may_exclude
        part = out.participating
        client_up = pol.client_up             # excluded clients send nothing
        if up_bits is None or may_exclude:
            up_bits = client_up.sum()
        if wire_on:
            # decode once, server-side, on the masked stack; non-com
            # variants ship the raw iterate, so their decode equals x_hat
            # on every row the aggregation keeps
            sent = gather_decoded(payload, out.partf)
            if cfg.variant != "com":
                x_hat = sent
        if cfg.variant == "com":
            x_hat = (tree_util.map(lambda x0, snt: x0.unsqueeze(0) + snt,
                                   state.x, sent) if ef_on else sent)
        e_new = state.e
        if ef_on:
            # leaky memory: undecayed EF diverges inside Scaffnew
            e_s_new = tree_util.map(lambda c, snt: cfg.ef_decay * (c - snt),
                                    innov, sent)
            if may_exclude:    # an excluded client never transmitted
                e_s_new = keep_where(part, e_s_new, e_s)
            e_new = tree_util.map(lambda e, es: e.index_copy(0, rows, es),
                                  state.e, e_s_new)
        if aggregation.uses_delta_combine(self.policy):
            # FedBuff server application in delta form: each buffer flush
            # applies its staleness-discounted mean of anchor deltas
            delta = tree_util.map(lambda xh, x0: xh - x0.unsqueeze(0),
                                  x_hat, state.x)
            x_bar = tree_util.map(lambda x0, u: x0 + u, state.x,
                                  aggregation.async_weighted_sum(out, delta))
        elif may_exclude:
            # if every sampled client was excluded, the server keeps its
            # model
            x_bar = tree_where(out.n_selected > 0,
                               masked_mean(x_hat, out.weight),
                               state.x)
        else:
            x_bar = tree_util.map(lambda t: t.mean(dim=0), x_hat)
        if cfg.variant == "global":
            x_bar, down_rep = self.comp.compress(
                tree_util.map(lambda t: t.unsqueeze(0), x_bar),
                k_down.unsqueeze(0))
            x_bar = tree_util.map(lambda t: t[0], x_bar)
            down_bits = down_rep.total_bits[0].cpu() * s

        # line 16: h_i += (p/gamma) (x_{t+1} - x^_{i,t+1}) for i in S
        h_s_new = tree_util.map(
            lambda h, xh, xb_: h + (cfg.p / cfg.gamma) * (xb_.unsqueeze(0) - xh),
            h_s, x_hat, x_bar)
        if may_exclude:   # an excluded client keeps its control variate
            h_s_new = keep_where(part, h_s_new, h_s)
        h_new = tree_util.map(lambda h, hs: h.index_copy(0, rows, hs),
                              state.h, h_s_new)

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
        return (FedComLocState(x=x_bar, h=h_new, round=state.round + 1,
                               e=e_new, mom=mom_new), metrics)
