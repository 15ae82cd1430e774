"""Aggregation policies (the port of ``repro.core.aggregation``): sync,
semi-sync wait-for-K and FedBuff-style buffered async, on the
``ClientSchedule`` sim-time clock (DESIGN.md §7).

* ``sync`` — the server waits for the slowest sampled client and averages
  every plan participant; ``sim_time`` is the largest finish time.
* ``semi_sync(K)`` — the server aggregates once the K fastest plan
  participants have finished; ties at the K-th finish are all kept, the
  rest are excluded like deadline drops (they transmit nothing and keep
  their state), and ``sim_time`` is the K-th smallest finish.
* ``async_buffered(capacity, alpha)`` — updates arrive in finish order
  and each buffer of ``capacity`` arrivals is applied as its mean delta,
  scaled by ``1/(1+staleness)^alpha`` where staleness is the flush index.

``HierarchicalPolicy`` composes two of these tiers, edge -> server
(DESIGN.md §11).  The outcome is computed on the host from the ``(s,)``
plan and bits vectors with the reference's float32 formulas.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch import tree as tree_util
from repro_torch.core.clients import NULL_CTX, per_client

MODES = ("sync", "semi_sync", "async_buffered")


@dataclasses.dataclass(frozen=True)
class AggregationPolicy:
    """How the server combines one round's sampled-client updates.

    ``wait_for`` (semi_sync) and ``capacity`` (async_buffered) default to
    ``clients_per_round`` at validation time, which reproduces sync.
    ``alpha`` is the staleness exponent of the weight
    ``1/(1+staleness)^alpha``.
    """

    mode: str = "sync"
    wait_for: Optional[int] = None     # K (semi_sync)
    capacity: Optional[int] = None     # buffer size (async_buffered)
    alpha: float = 0.0                 # staleness exponent (async_buffered)

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {self.mode!r}")
        if self.wait_for is not None and self.wait_for <= 0:
            raise ValueError("wait_for must be positive")
        if self.capacity is not None and self.capacity <= 0:
            raise ValueError("capacity must be positive")
        if self.alpha < 0:
            raise ValueError("alpha must be non-negative")
        if self.mode != "semi_sync" and self.wait_for is not None:
            raise ValueError("wait_for only applies to semi_sync")
        if self.mode != "async_buffered" and (self.capacity is not None
                                              or self.alpha != 0.0):
            raise ValueError("capacity/alpha only apply to async_buffered")

    @classmethod
    def sync(cls) -> "AggregationPolicy":
        return cls()

    @classmethod
    def semi_sync(cls, wait_for: int) -> "AggregationPolicy":
        return cls(mode="semi_sync", wait_for=wait_for)

    @classmethod
    def async_buffered(cls, capacity: Optional[int] = None,
                       alpha: float = 0.0) -> "AggregationPolicy":
        return cls(mode="async_buffered", capacity=capacity, alpha=alpha)

    @property
    def is_sync(self) -> bool:
        return self.mode == "sync"

    @property
    def may_exclude(self) -> bool:
        """True if the policy itself can exclude a sampled client from the
        aggregate (semi_sync stragglers)."""
        return self.mode == "semi_sync"


SYNC = AggregationPolicy()


@dataclasses.dataclass(frozen=True)
class HierarchicalPolicy:
    """Two-tier edge -> server aggregation (DESIGN.md §11).

    The ``s`` sampled clients split into ``n_edges`` contiguous groups of
    ``s / n_edges``; each edge runs its ``edge`` policy over its group on
    the client finish clock, and the server runs the ``server`` policy
    over edge arrival times (each edge's ``sim_time`` plus
    ``edge_latency``).  The tiers compose in the outcome vectors:
    participation is client ∩ edge ∩ server, ``weight`` makes the masked
    mean the mean of edge means, ``coef``/``discount`` multiply,
    staleness adds, and ``sim_time`` is the server tier's.
    """

    edge: AggregationPolicy = dataclasses.field(
        default_factory=AggregationPolicy)
    server: AggregationPolicy = dataclasses.field(
        default_factory=AggregationPolicy)
    n_edges: int = 1
    edge_latency: float = 0.0

    def __post_init__(self):
        if self.n_edges <= 0:
            raise ValueError("n_edges must be positive")
        if self.edge_latency < 0:
            raise ValueError("edge_latency must be non-negative")
        for tier in (self.edge, self.server):
            if not isinstance(tier, AggregationPolicy):
                raise TypeError("edge/server tiers must be flat "
                                "AggregationPolicy instances")

    @property
    def mode(self) -> str:
        return "hierarchical"

    @property
    def is_sync(self) -> bool:
        return False

    @property
    def may_exclude(self) -> bool:
        """Hierarchical outcomes are weighted (a mean of edge means), so
        rounds always take the masked aggregation path."""
        return True


def uses_delta_combine(policy) -> bool:
    """True if the round applies the server update in delta form
    (``sum_i coef_i * delta_i``): async_buffered, or a hierarchical policy
    with an async tier (the composed ``coef`` telescopes both)."""
    if isinstance(policy, HierarchicalPolicy):
        return (policy.edge.mode == "async_buffered"
                or policy.server.mode == "async_buffered")
    return policy.mode == "async_buffered"


def validate_policy(policy, clients_per_round: int):
    """Resolve ``None``/defaults against ``clients_per_round`` and check
    realisability, at construction time."""
    if policy is None:
        return SYNC
    if isinstance(policy, HierarchicalPolicy):
        s = clients_per_round
        if s % policy.n_edges != 0:
            raise ValueError(
                f"n_edges={policy.n_edges} must divide clients_per_round="
                f"{s} (contiguous equal-size edge groups)")
        return dataclasses.replace(
            policy,
            edge=validate_policy(policy.edge, s // policy.n_edges),
            server=validate_policy(policy.server, policy.n_edges))
    if not isinstance(policy, AggregationPolicy):
        raise TypeError(f"policy must be an AggregationPolicy, got "
                        f"{type(policy).__name__}")
    s = clients_per_round
    if policy.mode == "semi_sync":
        k = s if policy.wait_for is None else policy.wait_for
        if not (1 <= k <= s):
            raise ValueError(
                f"semi_sync wait_for={k} must be in [1, clients_per_round="
                f"{s}]")
        return dataclasses.replace(policy, wait_for=k)
    if policy.mode == "async_buffered":
        cap = s if policy.capacity is None else policy.capacity
        if not (1 <= cap <= s) or s % cap != 0:
            raise ValueError(
                f"async_buffered capacity={cap} must divide "
                f"clients_per_round={s}")
        return dataclasses.replace(policy, capacity=cap)
    return policy


class PolicyOutcome(NamedTuple):
    """One round's aggregation decision (``(s,)`` host vectors).

    ``participating`` folds the plan's straggler mask together with the
    policy's exclusions; ``coef`` is each client's weight in the delta-form
    server application ``x + sum_i coef_i * delta_i`` (participation, the
    staleness weight and the per-flush buffer-mean divisor);
    ``discount`` is the un-normalised staleness weight
    ``partf/(1+staleness)^alpha``; ``weight`` is the mean-aggregation
    weight (``partf`` for every flat policy; a hierarchical outcome's
    makes ``masked_mean(x, weight, weight_sum=n_selected)`` the mean of
    edge means); ``edges_aggregated`` counts the edges the server applied
    (hierarchical only).
    """

    participating: torch.Tensor   # (s,) bool — plan ∩ policy
    partf: torch.Tensor           # (s,) f32
    n_selected: torch.Tensor      # () f32 — partf.sum()
    sim_time: torch.Tensor        # () f32
    finish: torch.Tensor          # (s,) f32 — per-client finish times
    staleness: torch.Tensor       # (s,) f32 — flush index
    coef: torch.Tensor            # (s,) f32
    discount: torch.Tensor        # (s,) f32
    weight: torch.Tensor          # (s,) f32
    edges_aggregated: Optional[torch.Tensor] = None   # () f32


def _outcome_from_finish(policy: AggregationPolicy,
                         participating: torch.Tensor,
                         finish: torch.Tensor) -> PolicyOutcome:
    s = finish.shape[0]
    partf_plan = participating.to(torch.float32)
    inf = torch.tensor(float("inf"), dtype=torch.float32)

    if policy.mode == "semi_sync":
        # the K-th smallest finish among plan participants (a dropped
        # straggler sorts last as +inf); ties at it are all kept
        finish_eff = torch.where(participating, finish, inf)
        kth = torch.sort(finish_eff).values[policy.wait_for - 1]
        part = (finish_eff <= kth) & participating
        partf = part.to(torch.float32)
        # fewer than K participants: every report arrives and the dropped
        # stragglers hold the round open until the deadline
        sim_time = torch.max(finish) if bool(torch.isinf(kth)) else kth
        zeros = torch.zeros(s, dtype=torch.float32)
        return PolicyOutcome(
            participating=part, partf=partf, n_selected=partf.sum(),
            sim_time=sim_time, finish=finish, staleness=zeros,
            coef=partf / torch.clamp(partf.sum(), min=1.0),
            discount=partf, weight=partf)

    if policy.mode == "async_buffered":
        cap = policy.capacity
        # arrival order on the sim clock, stable as jnp.argsort; plan
        # drops never arrive and take no buffer slot
        finish_eff = torch.where(participating, finish, inf)
        order = torch.argsort(finish_eff, stable=True)
        ranks = torch.empty(s, dtype=torch.int32)
        ranks[order] = torch.arange(s, dtype=torch.int32)
        flush = torch.div(ranks, cap, rounding_mode="floor")
        staleness = flush.to(torch.float32) * partf_plan
        discount = partf_plan * torch.pow(1.0 + staleness,
                                          torch.tensor(-policy.alpha,
                                                       dtype=torch.float32))
        n_part = partf_plan.sum()
        n_flush = torch.clamp(n_part - flush.to(torch.float32) * cap,
                              0.0, float(cap))
        coef = discount / torch.clamp(n_flush, min=1.0)
        return PolicyOutcome(
            participating=participating, partf=partf_plan,
            n_selected=n_part, sim_time=torch.max(finish), finish=finish,
            staleness=staleness, coef=coef, discount=discount,
            weight=partf_plan)

    zeros = torch.zeros(s, dtype=torch.float32)
    return PolicyOutcome(
        participating=participating, partf=partf_plan,
        n_selected=partf_plan.sum(), sim_time=torch.max(finish),
        finish=finish, staleness=zeros,
        coef=partf_plan / torch.clamp(partf_plan.sum(), min=1.0),
        discount=partf_plan, weight=partf_plan)


def _apply_hierarchical(policy: HierarchicalPolicy,
                        participating: torch.Tensor,
                        finish: torch.Tensor) -> PolicyOutcome:
    """The edge tier on each contiguous group, then the server tier over
    the edges' arrival times, composed as the reference composes them."""
    s, e = finish.shape[0], policy.n_edges
    k = s // e
    tiers = [_outcome_from_finish(policy.edge, participating[i * k:(i + 1) * k],
                                  finish[i * k:(i + 1) * k])
             for i in range(e)]
    edge = PolicyOutcome(*(torch.stack([getattr(t, f) for t in tiers])
                           for f in PolicyOutcome._fields[:-1]))
    # each edge's aggregate reaches the server one hop after its clock
    # closes; an empty edge sends nothing
    srv = _outcome_from_finish(
        policy.server, edge.n_selected > 0,
        edge.sim_time + torch.tensor(policy.edge_latency,
                                     dtype=torch.float32))
    part = (edge.participating & srv.participating[:, None]).reshape(s)
    partf = part.to(torch.float32)
    n_sel = partf.sum()
    # scale so that sum(weight) == n_selected and the masked mean's
    # divisor cancels back to the mean of edge means
    edge_wn = edge.weight / torch.clamp(edge.n_selected, min=1.0)[:, None]
    srv_wn = srv.weight / torch.clamp(srv.n_selected, min=1.0)
    weight = n_sel * (srv_wn[:, None] * edge_wn).reshape(s)
    return PolicyOutcome(
        participating=part, partf=partf, n_selected=n_sel,
        sim_time=srv.sim_time, finish=finish,
        staleness=(edge.staleness + srv.staleness[:, None]).reshape(s),
        coef=(edge.coef * srv.coef[:, None]).reshape(s),
        discount=(edge.discount * srv.discount[:, None]).reshape(s),
        weight=weight, edges_aggregated=srv.n_selected)


def apply_policy(policy, sched, plan,
                 client_bits_full: torch.Tensor) -> PolicyOutcome:
    """Resolve one round's policy from the plan and the ``(s,)`` wire cost
    each plan participant would transmit (0 for dropped stragglers)."""
    finish = sched.finish_times(plan, client_bits_full)
    if isinstance(policy, HierarchicalPolicy):
        return _apply_hierarchical(policy, plan.participating, finish)
    return _outcome_from_finish(policy, plan.participating, finish)


class ResolvedPolicy(NamedTuple):
    """One round's policy outcome and the views every round body needs."""

    out: PolicyOutcome
    part: torch.Tensor        # the shard's bool participation (plan and policy)
    may_exclude: bool         # gate the keep-old state paths
    client_up: torch.Tensor   # full (s,) applied wire bits (excluded -> 0)
    weight: torch.Tensor      # the shard's float32 mean-aggregation weights


def resolve_policy(policy, sched, plan, client_bits_full: torch.Tensor,
                   ctx=NULL_CTX) -> ResolvedPolicy:
    """``apply_policy`` on the full ``(s,)`` plan, and the shard's views of
    it under a sharded ``ctx`` (DESIGN.md §6)."""
    out = apply_policy(policy, sched, plan, client_bits_full)
    part = ctx.shard(out.participating)
    return ResolvedPolicy(
        out=out, part=part,
        may_exclude=sched.may_drop or policy.may_exclude,
        client_up=client_bits_full * out.partf,
        weight=ctx.shard(out.weight))


def async_weighted_sum(out: PolicyOutcome, stacked, ctx=NULL_CTX):
    """Staleness-weighted delta combine ``sum_i coef_i * stacked_i`` over
    the client axis (the async server application, in delta form).  Under
    a sharded ``ctx`` ``stacked`` holds the shard's rows; ``out.coef`` is
    the full vector, sliced here, and the shards' sums are summed."""
    coef = ctx.shard(out.coef)
    return ctx.psum(tree_util.map(
        lambda t: (t * per_client(coef, t)).sum(dim=0), stacked))


def policy_metrics(out: PolicyOutcome) -> dict:
    """``client_staleness`` and ``clients_aggregated``, the number of
    updates the server applied this round (and ``edges_aggregated`` under
    a hierarchical policy)."""
    metrics = {"client_staleness": out.staleness,
               "clients_aggregated": out.n_selected}
    if out.edges_aggregated is not None:
        metrics["edges_aggregated"] = out.edges_aggregated
    return metrics
