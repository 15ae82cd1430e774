"""Client layer of the round (the port of ``repro.core.clients``, the
subset on the homogeneous synchronous path).

* :class:`ClientProfile` / :class:`ClientSchedule` — per-client speed and
  bandwidth and the per-round :class:`RoundPlan` (steps, participation);
  ``finish_times``/``sim_time`` are the sim-clock cost model;
* ``sample_cohort`` — the uniform without-replacement cohort draw, bit for
  bit ``jax.random.choice`` on the same key;
* ``mean_over_active`` and ``batched_compress`` (the counterpart of
  ``vmap_compress``: one compress call for the whole stacked cohort);
* the packed uplink (DESIGN.md §8): ``vmap_encode`` at the client
  boundary, ``mask_payload`` and ``gather_decoded`` on the server, and
  ``payload_metrics``.  The port has one device, so there is no client
  axis to gather across.

Plans and cohorts live on the host (small ``(s,)`` tensors); the stacked
model rows live on the device.  Deadlines, drop-out, availability, the
tree sampler and per-client compressor overrides are not yet ported and
raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional

import torch

from repro_torch import not_ported, prng



class RoundPlan(NamedTuple):
    """One round's resolved schedule for the ``s`` sampled clients (host)."""

    steps: torch.Tensor          # (s,) int64 — local steps each completes
    participating: torch.Tensor  # (s,) bool
    speed: torch.Tensor          # (s,) float32
    bandwidth: torch.Tensor      # (s,) float32
    comp_overrides: Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class ClientProfile:
    """Per-client relative compute ``speed`` and uplink ``bandwidth``."""

    speed: torch.Tensor
    bandwidth: torch.Tensor
    comp_params: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict)

    def __post_init__(self):
        speed = torch.as_tensor(self.speed, dtype=torch.float32)
        bandwidth = torch.as_tensor(self.bandwidth, dtype=torch.float32)
        object.__setattr__(self, "speed", speed)
        object.__setattr__(self, "bandwidth", bandwidth)
        if speed.dim() != 1 or bandwidth.shape != speed.shape:
            raise ValueError(
                f"speed/bandwidth must be matching (n,) arrays, got "
                f"{tuple(speed.shape)} / {tuple(bandwidth.shape)}")
        if not (bool((speed > 0).all()) and bool((bandwidth > 0).all())):
            raise ValueError("speed and bandwidth must be positive")
        if self.comp_params:
            raise not_ported("per-client compressor overrides")

    @property
    def n_clients(self) -> int:
        return self.speed.shape[0]

    @classmethod
    def homogeneous(cls, n_clients: int) -> "ClientProfile":
        ones = torch.ones(n_clients, dtype=torch.float32)
        return cls(speed=ones, bandwidth=ones)


@dataclasses.dataclass(frozen=True)
class ClientSchedule:
    """Turns a profile into per-round :class:`RoundPlan` s.

    ``step_cost``/``bit_cost`` are the sim-time of one local step at speed
    1 and of one uplink bit at bandwidth 1.
    """

    profile: ClientProfile
    deadline: Optional[float] = None
    drop_stragglers: bool = False
    step_cost: float = 1.0
    bit_cost: float = 0.0
    availability: Optional[object] = None
    sampler: str = "gumbel"

    def __post_init__(self):
        if self.deadline is not None or self.drop_stragglers:
            raise not_ported("straggler deadlines and drop-out")
        if self.availability is not None:
            raise not_ported("client availability")
        if self.sampler != "gumbel":
            raise not_ported(f"sampler={self.sampler!r}")
        if self.step_cost <= 0:
            raise ValueError("step_cost must be positive")
        if self.bit_cost < 0:
            raise ValueError("bit_cost must be non-negative")

    @classmethod
    def homogeneous(cls, n_clients: int) -> "ClientSchedule":
        return cls(profile=ClientProfile.homogeneous(n_clients))

    @property
    def n_clients(self) -> int:
        return self.profile.n_clients

    @property
    def may_drop(self) -> bool:
        return False

    def sample_cohort(self, key: torch.Tensor, s: int, round_idx=0):
        """The round's cohort ``(s,)``: ``jax.random.choice(key, n, (s,),
        replace=False)`` bit for bit.  Returns ``(clients, None)`` (no
        availability process)."""
        return prng.choice(key, self.n_clients, s), None

    def plan(self, clients: torch.Tensor, nominal_steps: int) -> RoundPlan:
        """Resolve the sampled ``clients`` for one round."""
        s = clients.shape[0]
        return RoundPlan(
            steps=torch.full((s,), int(nominal_steps), dtype=torch.int64),
            participating=torch.ones(s, dtype=torch.bool),
            speed=self.profile.speed[clients],
            bandwidth=self.profile.bandwidth[clients],
            comp_overrides={})

    def finish_times(self, plan: RoundPlan,
                     client_uplink_bits: torch.Tensor) -> torch.Tensor:
        """Per-client finish times on the sim clock: local phase plus
        uplink (float32, the reference's operation order)."""
        compute = plan.steps.to(torch.float32) * self.step_cost / plan.speed
        comm = (client_uplink_bits.to(torch.float32) * self.bit_cost
                / plan.bandwidth)
        comm = torch.where(plan.participating, comm, torch.zeros_like(comm))
        return compute + comm

    def sim_time(self, plan: RoundPlan, client_uplink_bits) -> torch.Tensor:
        return torch.max(self.finish_times(plan, client_uplink_bits))


def mean_over_active(values: torch.Tensor,
                     active: torch.Tensor) -> torch.Tensor:
    """Mean of per-client scalars over the active subset; 0 if none is
    active.  With every client active this is ``values.mean()``'s sum and
    divisor."""
    act = active.to(device=values.device, dtype=values.dtype)
    return (values * act).sum() / torch.clamp(act.sum(), min=1.0)


def batched_compress(comp, plan: RoundPlan, stacked, keys: torch.Tensor):
    """Compress a stacked-client tree in one call (the counterpart of
    ``vmap_compress``): returns ``(compressed stacked tree, BitsReport)``
    with ``(s,)`` report vectors — ``report.total_bits`` is the per-client
    wire cost."""
    if plan.comp_overrides:
        raise not_ported("per-client compressor overrides")
    return comp.compress(stacked, keys)


def vmap_encode(comp, plan: RoundPlan, stacked,
                keys: Optional[torch.Tensor] = None):
    """Wire-encode a stacked-client uplink tree in one call, the packed
    counterpart of :func:`batched_compress`.  Returns ``(Payload,
    BitsReport)``; the report equals the account-mode one, so finish
    clocks and bit metrics don't change between modes."""
    from repro_torch.compress import wire
    if plan.comp_overrides:
        raise ValueError(
            "packed wire mode cannot carry per-client compressor overrides "
            "(static payload capacity); run them in account mode")
    return wire.encode(comp, stacked, keys)


def mask_payload(payload, partf: torch.Tensor):
    """Zero the packed buffers of non-participating clients: such a client
    sends a fully masked payload, which decodes to an all-zero tree that
    the aggregation already discards."""
    keep = (partf > 0).to(payload.data[0][0].device)

    def mask(b):
        k = keep.reshape((-1,) + (1,) * (b.dim() - 1))
        return torch.where(k, b, torch.zeros((), dtype=b.dtype,
                                             device=b.device))

    data = tuple(tuple(mask(b) for b in unit) for unit in payload.data)
    return type(payload)(data, payload.spec)


def payload_metrics(payload, partf_full: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The measured-bytes metrics of a packed round: the per-client
    payload size masked by participation (float32), and its sum."""
    pb = torch.tensor(float(payload.nbytes), dtype=torch.float32) * partf_full
    return {"client_payload_bytes": pb, "uplink_payload_bytes": pb.sum()}


def gather_decoded(payload, partf_full: torch.Tensor):
    """The server side of the packed uplink: mask non-participants and
    decode the whole ``(s, ...)`` stack once."""
    from repro_torch.compress import wire
    return wire.decode(mask_payload(payload, partf_full))


def validate_schedule(schedule: ClientSchedule,
                      n_clients: int) -> ClientSchedule:
    if schedule.n_clients != n_clients:
        raise ValueError(
            f"schedule profiles {schedule.n_clients} clients but the config "
            f"has n_clients={n_clients}")
    return schedule
