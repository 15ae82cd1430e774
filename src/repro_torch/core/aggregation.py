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

The outcome is computed on the host from the ``(s,)`` plan and bits
vectors with the reference's float32 formulas.  ``HierarchicalPolicy`` is
not yet ported and raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch import not_ported
from repro_torch import tree as tree_util

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


class HierarchicalPolicy:
    """Two-tier edge -> server aggregation (the reference's DESIGN.md
    §11); not yet ported."""

    def __init__(self, *args, **kwargs):
        raise not_ported("HierarchicalPolicy")


def uses_delta_combine(policy) -> bool:
    """True if the round applies the server update in delta form
    (``sum_i coef_i * delta_i``): async_buffered."""
    return policy.mode == "async_buffered"


def validate_policy(policy, clients_per_round: int) -> AggregationPolicy:
    """Resolve ``None``/defaults against ``clients_per_round`` and check
    realisability, at construction time."""
    if policy is None:
        return SYNC
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
    weight (``partf`` for every flat policy).
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


def apply_policy(policy, sched, plan,
                 client_bits_full: torch.Tensor) -> PolicyOutcome:
    """Resolve one round's policy from the plan and the ``(s,)`` wire cost
    each plan participant would transmit (0 for dropped stragglers)."""
    finish = sched.finish_times(plan, client_bits_full)
    return _outcome_from_finish(policy, plan.participating, finish)


class ResolvedPolicy(NamedTuple):
    out: PolicyOutcome
    may_exclude: bool         # gate the keep-old state paths
    client_up: torch.Tensor   # (s,) applied wire bits (excluded -> 0)


def resolve_policy(policy, sched, plan,
                   client_bits_full: torch.Tensor) -> ResolvedPolicy:
    out = apply_policy(policy, sched, plan, client_bits_full)
    return ResolvedPolicy(
        out=out, may_exclude=sched.may_drop or policy.may_exclude,
        client_up=client_bits_full * out.partf)


def async_weighted_sum(out: PolicyOutcome, stacked):
    """Staleness-weighted delta combine ``sum_i coef_i * stacked_i`` over
    the client axis (the async server application, in delta form)."""
    from repro_torch.core.clients import per_client
    return tree_util.map(
        lambda t: (t * per_client(out.coef, t)).sum(dim=0), stacked)


def policy_metrics(out: PolicyOutcome) -> dict:
    """``client_staleness`` and ``clients_aggregated``, the number of
    updates the server applied this round."""
    return {"client_staleness": out.staleness,
            "clients_aggregated": out.n_selected}
