"""Aggregation policies (the port of ``repro.core.aggregation``): the
synchronous outcome only.

Under ``sync`` the server waits for the slowest sampled client and
averages every participant; ``sim_time`` is the largest finish time.
``semi_sync``, ``async_buffered`` and hierarchical policies are not yet
ported.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch import not_ported

MODES = ("sync", "semi_sync", "async_buffered")


@dataclasses.dataclass(frozen=True)
class AggregationPolicy:
    mode: str = "sync"
    wait_for: Optional[int] = None
    capacity: Optional[int] = None
    alpha: float = 0.0

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {self.mode!r}")
        if self.mode != "sync":
            raise not_ported(f"aggregation mode {self.mode!r}")

    @classmethod
    def sync(cls) -> "AggregationPolicy":
        return cls()

    @property
    def may_exclude(self) -> bool:
        return False


SYNC = AggregationPolicy()


def validate_policy(policy) -> AggregationPolicy:
    if policy is None:
        return SYNC
    if not isinstance(policy, AggregationPolicy):
        raise not_ported(f"policy {type(policy).__name__}")
    return policy


class PolicyOutcome(NamedTuple):
    """One round's aggregation decision (``(s,)`` host vectors)."""

    participating: torch.Tensor
    partf: torch.Tensor
    n_selected: torch.Tensor
    sim_time: torch.Tensor
    finish: torch.Tensor
    staleness: torch.Tensor


def apply_policy(policy, sched, plan,
                 client_bits_full: torch.Tensor) -> PolicyOutcome:
    """The sync outcome, with the reference's formula graph."""
    finish = sched.finish_times(plan, client_bits_full)
    partf = plan.participating.to(torch.float32)
    s = finish.shape[0]
    return PolicyOutcome(
        participating=plan.participating, partf=partf,
        n_selected=partf.sum(), sim_time=torch.max(finish), finish=finish,
        staleness=torch.zeros(s, dtype=torch.float32))


class ResolvedPolicy(NamedTuple):
    out: PolicyOutcome
    may_exclude: bool
    client_up: torch.Tensor   # (s,) applied wire bits (excluded -> 0)


def resolve_policy(policy, sched, plan,
                   client_bits_full: torch.Tensor) -> ResolvedPolicy:
    out = apply_policy(policy, sched, plan, client_bits_full)
    return ResolvedPolicy(
        out=out, may_exclude=sched.may_drop or policy.may_exclude,
        client_up=client_bits_full * out.partf)


def policy_metrics(out: PolicyOutcome) -> dict:
    return {"client_staleness": out.staleness,
            "clients_aggregated": out.n_selected}
