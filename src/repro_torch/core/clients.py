"""Client layer of the round (the port of ``repro.core.clients`` on one
device).

* :class:`ClientProfile` / :class:`ClientSchedule` — per-client speed and
  bandwidth (homogeneous, lognormal or uniform) and the per-round
  :class:`RoundPlan`: a straggler ``deadline`` truncates slow clients'
  steps and ``drop_stragglers`` removes clients that finish none;
  ``finish_times``/``sim_time`` are the sim-clock cost model;
* :class:`ClientAvailability` — the diurnal + churn availability trace of
  a population (DESIGN.md §11), a pure function of the round index;
* ``sample_cohort`` — the uniform without-replacement cohort draw, bit for
  bit ``jax.random.choice`` on the same key; with an availability trace,
  the weighted draw: the Gumbel-top-k on the device (``sampler="gumbel"``)
  or the host's segment tree (``sampler="tree"``,
  :mod:`repro_torch.core.sampling`), both the reference's cohorts bit for
  bit, with ``RoundPlan.available`` flagging offline picks;
* per-client compressor overrides: ``ClientProfile.comp_params`` (e.g.
  ``{"density": (n,)}``, or ``with_density_allocation``'s bandwidth-
  proportional densities), gathered into ``RoundPlan.comp_overrides`` for
  the cohort and routed by ``batched_compress`` as ``(s,)`` tensors;
* ``keep_where``, ``tree_where``, ``mean_over_active``, ``masked_mean``
  and ``batched_compress`` (the counterpart of ``vmap_compress``: one
  compress call for the whole stacked cohort);
* the packed uplink (DESIGN.md §8): ``vmap_encode`` at the client
  boundary, ``mask_payload`` and ``gather_decoded`` on the server, and
  ``payload_metrics``;
* the compressed downlink (DESIGN.md §10): ``apply_downlink`` delta-codes
  the broadcast against the cohort's last-received model, on a one-row
  stack (one payload serves the whole cohort);
* :class:`ClientAxisCtx` (DESIGN.md §6): every cross-client operation of
  a round body.  The base class, ``NULL_CTX``, is the unsharded path;
  :class:`repro_torch.core.distributed.ShardCtx` splits the sampled
  clients over the ranks of a ``torch.distributed`` group.

Plans and cohorts live on the host (small ``(s,)`` tensors); the stacked
model rows live on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import prng
from repro_torch import tree as tree_util

PyTree = Any


class RoundPlan(NamedTuple):
    """One round's resolved schedule for the ``s`` sampled clients (host)."""

    steps: torch.Tensor          # (s,) int32 — local steps each completes
    participating: torch.Tensor  # (s,) bool — False = straggler dropped
    speed: torch.Tensor          # (s,) float32
    bandwidth: torch.Tensor      # (s,) float32
    comp_overrides: Dict[str, torch.Tensor]   # name -> (s,) values
    # (s,) bool — False = the availability trace marked this pick offline:
    # it never starts, transmits nothing and holds nothing open; None
    # when no availability trace is attached
    available: Optional[torch.Tensor] = None


def _as_param(values) -> torch.Tensor:
    """Per-client override values as ``jnp.asarray`` holds them with 64-bit
    types off: floats as float32, integers as int32."""
    v = torch.as_tensor(np.asarray(values))
    if v.dtype.is_floating_point:
        return v.to(torch.float32)
    if v.dtype != torch.bool:
        return v.to(torch.int32)
    return v


def _xla_cpu_mean(v: torch.Tensor) -> torch.Tensor:
    """``jnp.mean`` of a float32 vector as XLA's CPU backend computes it
    for up to 32 elements: a left-to-right float32 sum times the float32
    constant ``1/n`` (XLA folds the division by a constant into that
    multiply).  Longer vectors sum in blocks there, so their last bit may
    part from this."""
    acc = np.float32(0.0)
    for x in v.numpy().astype(np.float32):
        acc = np.float32(acc + x)
    return torch.tensor(acc * (np.float32(1.0) / np.float32(v.numel())),
                        dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class ClientProfile:
    """Per-client relative compute ``speed`` and uplink ``bandwidth``, and
    per-client compressor parameters ``comp_params`` (override name ->
    ``(n,)`` values, see ``Compressor.param_overrides``)."""

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
        params = {k: _as_param(v) for k, v in dict(self.comp_params).items()}
        object.__setattr__(self, "comp_params", params)
        for name, v in params.items():
            if v.shape != speed.shape:
                raise ValueError(
                    f"comp_params[{name!r}] must have shape "
                    f"{tuple(speed.shape)}, got {tuple(v.shape)}")

    @property
    def n_clients(self) -> int:
        return self.speed.shape[0]

    @classmethod
    def homogeneous(cls, n_clients: int) -> "ClientProfile":
        ones = torch.ones(n_clients, dtype=torch.float32)
        return cls(speed=ones, bandwidth=ones)

    @classmethod
    def lognormal(cls, n_clients: int, *, speed_sigma: float = 0.5,
                  bandwidth_sigma: float = 0.0, seed: int = 0
                  ) -> "ClientProfile":
        """Median-1 lognormal speeds/bandwidths (heavy straggler tail): the
        reference's numpy draws, rounded to float32."""
        rng = np.random.default_rng(seed)
        speed = rng.lognormal(0.0, speed_sigma, n_clients)
        bw = (rng.lognormal(0.0, bandwidth_sigma, n_clients)
              if bandwidth_sigma > 0 else np.ones(n_clients))
        return cls(speed=torch.from_numpy(speed.astype(np.float32)),
                   bandwidth=torch.from_numpy(bw.astype(np.float32)))

    @classmethod
    def uniform(cls, n_clients: int, *, lo: float = 0.5, hi: float = 2.0,
                bandwidth_lo: Optional[float] = None,
                bandwidth_hi: Optional[float] = None, seed: int = 0
                ) -> "ClientProfile":
        """Speeds (and optionally bandwidths) uniform in [lo, hi]."""
        rng = np.random.default_rng(seed)
        speed = rng.uniform(lo, hi, n_clients)
        if bandwidth_lo is None:
            bw = np.ones(n_clients)
        else:
            bw = rng.uniform(bandwidth_lo,
                             bandwidth_hi if bandwidth_hi is not None
                             else bandwidth_lo, n_clients)
        return cls(speed=torch.from_numpy(speed.astype(np.float32)),
                   bandwidth=torch.from_numpy(bw.astype(np.float32)))

    def with_comp_param(self, name: str, values) -> "ClientProfile":
        params = dict(self.comp_params)
        params[name] = values
        return dataclasses.replace(self, comp_params=params)

    def with_density_allocation(self, base_density: float,
                                mode: str = "uniform",
                                floor: float = 0.01) -> "ClientProfile":
        """Attach a per-client TopK ``density`` allocation, the reference's
        values bit for bit.

        ``mode="uniform"`` gives every client ``base_density``;
        ``mode="bandwidth"`` spends the same total bit budget in proportion
        to each client's bandwidth (d_i proportional to bw_i, clipped to
        [floor, 1]).  ``mean(d) == base_density``: where the clip binds, the
        slope is bisected on the host (float64) so that the clipped mean
        lands on ``base_density``; where it does not, d is the float32
        ``clip(float32(base) * bw / mean(bw), floor, 1)``.
        """
        n = self.n_clients
        if mode == "uniform":
            d = torch.full((n,), base_density, dtype=torch.float32)
        elif mode == "bandwidth":
            if not (floor <= base_density <= 1.0):
                raise ValueError(
                    f"base_density={base_density} outside [floor={floor}, "
                    "1.0]: the clipped allocation cannot average to it")
            raw = self.bandwidth.numpy().astype(np.float64)
            raw = raw / raw.mean()
            clipped = np.clip(base_density * raw, floor, 1.0)
            if abs(clipped.mean() - base_density) <= 1e-9:
                rel = self.bandwidth / _xla_cpu_mean(self.bandwidth)
                d = torch.clamp(torch.tensor(base_density, dtype=torch.float32)
                                * rel, floor, 1.0)
            else:
                # mean(clip(c * raw, floor, 1)) is monotone in c and spans
                # [floor, 1], which holds base_density: bisect the slope
                lo, hi = 0.0, base_density
                while np.clip(hi * raw, floor, 1.0).mean() < base_density:
                    hi *= 2.0
                for _ in range(80):
                    mid = 0.5 * (lo + hi)
                    if np.clip(mid * raw, floor, 1.0).mean() < base_density:
                        lo = mid
                    else:
                        hi = mid
                d = torch.from_numpy(
                    np.clip(hi * raw, floor, 1.0).astype(np.float32))
        else:
            raise ValueError(f"unknown allocation mode {mode!r}")
        return self.with_comp_param("density", d)


def _f32(v) -> float:
    """``v`` rounded to float32, as a Python float."""
    return float(np.float32(v))


@dataclasses.dataclass(frozen=True)
class ClientAvailability:
    """A population's availability trace (DESIGN.md §11): a pure function
    of the round index, so resumed and replayed runs see the same trace.

    * diurnal: ``w_i(t) = 1 - amp * (0.5 + 0.5 * sin(2 pi (t/period +
      phase_i)))``, the client's timezone in ``phase_i``;
    * churn: client i is in the population iff ``frac(t * churn_rate +
      stagger_i) < online_frac``.

    ``weights(t)`` is the ``(n,)`` sampling weight; 0 means offline.
    ``phase``/``stagger`` live on the host (float32); ``weights`` runs on
    the device it is asked for.
    """

    phase: torch.Tensor               # (n,) diurnal phase in [0, 1)
    stagger: torch.Tensor             # (n,) churn stagger in [0, 1)
    period: float = 24.0              # rounds per diurnal cycle
    amp: float = 0.8                  # diurnal modulation depth in [0, 1]
    churn_rate: float = 0.0           # population fraction cycling a round
    online_frac: float = 1.0          # steady-state in-population fraction

    def __post_init__(self):
        phase = torch.as_tensor(np.asarray(self.phase, np.float32))
        stagger = torch.as_tensor(np.asarray(self.stagger, np.float32))
        object.__setattr__(self, "phase", phase)
        object.__setattr__(self, "stagger", stagger)
        object.__setattr__(self, "_device_copies", {})
        if phase.dim() != 1 or stagger.shape != phase.shape:
            raise ValueError("phase/stagger must be matching (n,) arrays")
        if not 0.0 <= self.amp <= 1.0:
            raise ValueError("amp must be in [0, 1]")
        if self.period <= 0:
            raise ValueError("period must be positive")
        if self.churn_rate < 0:
            raise ValueError("churn_rate must be non-negative")
        if not 0.0 < self.online_frac <= 1.0:
            raise ValueError("online_frac must be in (0, 1]")

    @property
    def n_clients(self) -> int:
        return self.phase.shape[0]

    @classmethod
    def diurnal(cls, n_clients: int, *, period: float = 24.0,
                amp: float = 0.8, churn_rate: float = 0.0,
                online_frac: float = 1.0, seed: int = 0
                ) -> "ClientAvailability":
        """Uniform-random timezones and churn staggers (the reference's
        numpy draws, rounded to float32)."""
        rng = np.random.default_rng(seed)
        return cls(phase=rng.random(n_clients).astype(np.float32),
                   stagger=rng.random(n_clients).astype(np.float32),
                   period=period, amp=amp, churn_rate=churn_rate,
                   online_frac=online_frac)

    def _on(self, device):
        """``(phase, stagger)`` on ``device``, copied there once."""
        dev = torch.device("cpu" if device is None else device)
        pair = self._device_copies.get(dev)
        if pair is None:
            pair = (self.phase.to(dev), self.stagger.to(dev))
            self._device_copies[dev] = pair
        return pair

    def weights(self, round_idx, device=None) -> torch.Tensor:
        """The ``(n,)`` float32 availability weight at ``round_idx``, on
        ``device`` (the host by default), bit for bit the weights the
        reference's rounds use.  Inside their compiled graph XLA folds
        ``t / period`` into ``t * float32(1 / period)`` and fuses ``1 - amp
        * h`` into one FMA, so the reference's ``weights(t)`` called op by
        op, outside ``jit``, differs from these in about 1 weight in 3.
        The sine is XLA's (``prng.xla_sin``)."""
        phase, stagger = self._on(device)
        # the round's scalars in numpy float32 on the host (a CUDA division
        # by a scalar multiplies by its reciprocal instead)
        t = np.float32(round_idx)
        rate = t * (np.float32(1.0) / np.float32(self.period))
        h = prng.xla_sin((phase + float(rate)) * _f32(2.0 * np.pi)) * 0.5 + 0.5
        # the product of two float32 values and 1 minus it are exact in
        # float64, so this rounds once, as the FMA does
        w = (1.0 - h.double() * _f32(self.amp)).float()
        if self.churn_rate > 0.0 and self.online_frac < 1.0:
            shift = float(t * np.float32(self.churn_rate))
            u = torch.fmod(stagger + shift, 1.0)
            w = torch.where(u < _f32(self.online_frac), w,
                            torch.zeros_like(w))
        return w


@dataclasses.dataclass(frozen=True)
class ClientSchedule:
    """Turns a profile + straggler policy into per-round
    :class:`RoundPlan` s.

    ``deadline`` is a sim-time budget for the local phase: client i
    completes ``min(nominal, floor(deadline·speed_i/step_cost))`` steps.
    With ``drop_stragglers`` clients that complete zero steps are removed
    from the round (no uplink payload, no control-variate update, excluded
    from the server average, holding the round open to the deadline);
    otherwise they report their unchanged broadcast iterate.
    ``step_cost``/``bit_cost`` are the sim-time of one local step at speed
    1 and of one uplink bit at bandwidth 1.

    ``availability`` attaches a :class:`ClientAvailability` trace: the
    cohort is drawn proportionally to the round's weights, and a sampled
    but offline client (only when fewer than ``s`` are online) runs zero
    steps, transmits nothing, joins no aggregate and holds nothing open.
    ``sampler`` picks the weighted draw: ``"gumbel"`` (O(n) on the
    device) or ``"tree"`` (O(s log n) on the host, the population-scale
    choice, DESIGN.md §12).  They consume randomness differently, so
    their cohorts differ while their distributions agree.  Without a
    trace the sampler is inert and the uniform draw runs.
    """

    profile: ClientProfile
    deadline: Optional[float] = None
    drop_stragglers: bool = False
    step_cost: float = 1.0
    bit_cost: float = 0.0
    availability: Optional[ClientAvailability] = None
    sampler: str = "gumbel"

    def __post_init__(self):
        if self.deadline is not None and self.deadline <= 0:
            raise ValueError("deadline must be positive")
        if self.step_cost <= 0:
            raise ValueError("step_cost must be positive")
        if self.bit_cost < 0:
            raise ValueError("bit_cost must be non-negative")
        if self.drop_stragglers and self.deadline is None:
            raise ValueError("drop_stragglers requires a deadline")
        if self.sampler not in ("gumbel", "tree"):
            raise ValueError(
                f"unknown sampler {self.sampler!r}: expected 'gumbel' or "
                f"'tree'")
        if self.availability is not None:
            if not isinstance(self.availability, ClientAvailability):
                raise TypeError(
                    f"availability must be a ClientAvailability, got "
                    f"{type(self.availability).__name__}")
            if self.availability.n_clients != self.profile.n_clients:
                raise ValueError(
                    f"availability traces {self.availability.n_clients} "
                    f"clients but the profile has {self.profile.n_clients}")

    @classmethod
    def homogeneous(cls, n_clients: int) -> "ClientSchedule":
        return cls(profile=ClientProfile.homogeneous(n_clients))

    @property
    def n_clients(self) -> int:
        return self.profile.n_clients

    @property
    def may_drop(self) -> bool:
        return self.drop_stragglers or self.availability is not None

    @property
    def heterogeneous_steps(self) -> bool:
        """True if per-client step counts can differ within a round
        (deadline truncation, or offline clients running none): round
        bodies mask their local steps."""
        return self.deadline is not None or self.availability is not None

    @property
    def uses_host_sampler(self) -> bool:
        """True when cohorts are drawn on the host (``sampler="tree"``
        with an availability trace)."""
        return self.sampler == "tree" and self.availability is not None

    @property
    def tree_sampler(self):
        """The schedule's :class:`~repro_torch.core.sampling.TreeSampler`
        (segment tree and draw memo, shared by the round and the cohort
        planner), built at first use."""
        if not self.uses_host_sampler:
            raise ValueError("schedule does not use the tree sampler")
        inst = getattr(self, "_tree_sampler", None)
        if inst is None:
            from repro_torch.core.sampling import TreeSampler
            inst = TreeSampler(self.availability)
            object.__setattr__(self, "_tree_sampler", inst)
        return inst

    def plan_cohort_host(self, key, s: int, round_idx: int):
        """The tree sampler's cohort for ``(key, round_idx)``: numpy
        ``(clients (s,) int32, online (s,) bool)``, memoised, so the cohort
        planner and the round share one draw.  The key goes in as its
        uint32 words, as the reference hands them over."""
        kd = np.asarray(prng.key_data(key).cpu().numpy(), np.uint32)
        return self.tree_sampler.draw(kd, round_idx, s)

    def sample_cohort(self, key: torch.Tensor, s: int, round_idx=0,
                      device=None):
        """The round's cohort ``(s,)`` (host int64) and its online mask.

        Without an availability trace: ``jax.random.choice(key, n, (s,),
        replace=False)`` bit for bit, and ``None``.  With one, a weighted
        draw without replacement proportional to the round's weights:
        ``sampler="tree"`` on the host; ``"gumbel"`` on ``device``, the
        top ``s`` of ``log(max(w, 1e-20)) + gumbel(key, (n,))`` with
        offline clients at -inf, ties to the lower index as
        ``lax.top_k`` breaks them (a stable descending sort)."""
        n = self.n_clients
        if self.availability is None:
            return prng.choice(key, n, s), None
        if self.sampler == "tree":
            clients, online = self.plan_cohort_host(key, s, round_idx)
            return (torch.from_numpy(clients.astype(np.int64)),
                    torch.from_numpy(online))
        w = self.availability.weights(round_idx, device)
        online = w > 0.0
        g = prng.gumbel(key, (n,), device=w.device)
        floor = torch.tensor(_f32(1e-20), device=w.device)
        scores = torch.where(online, prng.xla_log(torch.maximum(w, floor)) + g,
                             torch.full_like(w, -float("inf")))
        top = torch.sort(scores, descending=True, stable=True).indices[:s]
        return top.cpu(), online[top].cpu()

    def plan(self, clients: torch.Tensor, nominal_steps: int,
             available: Optional[torch.Tensor] = None) -> RoundPlan:
        """Resolve the sampled ``clients`` for one round (host tensors);
        ``available`` is ``sample_cohort``'s online mask."""
        s = clients.shape[0]
        speed = self.profile.speed[clients]
        steps = torch.full((s,), int(nominal_steps), dtype=torch.int32)
        participating = torch.ones(s, dtype=torch.bool)
        if self.deadline is not None:
            # float32 deadline * speed / step_cost, floored, as the
            # reference computes it
            can_do = torch.floor(
                torch.tensor(self.deadline, dtype=torch.float32) * speed
                / torch.tensor(self.step_cost, dtype=torch.float32)
            ).to(torch.int32)
            steps = torch.minimum(steps, torch.clamp(can_do, min=0))
            if self.drop_stragglers:
                participating = steps > 0
        if available is not None:
            # an offline client runs nothing and joins no aggregate
            steps = torch.where(available, steps, torch.zeros_like(steps))
            participating = participating & available
        return RoundPlan(
            steps=steps, participating=participating, speed=speed,
            bandwidth=self.profile.bandwidth[clients],
            comp_overrides={k: v[clients]
                            for k, v in self.profile.comp_params.items()},
            available=available)

    def finish_times(self, plan: RoundPlan,
                     client_uplink_bits: torch.Tensor) -> torch.Tensor:
        """Per-client finish times on the sim clock: local phase plus
        uplink (float32, the reference's operation order)."""
        compute = plan.steps.to(torch.float32) * self.step_cost / plan.speed
        comm = (client_uplink_bits.to(torch.float32) * self.bit_cost
                / plan.bandwidth)
        comm = torch.where(plan.participating, comm, torch.zeros_like(comm))
        finish = compute + comm
        if self.deadline is not None and self.drop_stragglers:
            # a dropped straggler holds the round until the deadline
            finish = torch.where(
                plan.participating, finish,
                torch.tensor(self.deadline, dtype=torch.float32))
        if plan.available is not None:
            # an offline client never starts: it holds nothing open
            finish = torch.where(plan.available, finish,
                                 torch.zeros_like(finish))
        return finish

    def sim_time(self, plan: RoundPlan, client_uplink_bits) -> torch.Tensor:
        return torch.max(self.finish_times(plan, client_uplink_bits))


def per_client(mask: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """A ``(s,)`` vector on ``leaf``'s device, shaped to broadcast over a
    ``(s, ...)`` stacked leaf."""
    return mask.to(leaf.device).reshape(
        (mask.shape[0],) + (1,) * (leaf.dim() - 1))


def keep_where(mask: torch.Tensor, new: PyTree, old: PyTree) -> PyTree:
    """Per-client select over stacked trees: take ``new`` where ``mask`` is
    set, keep ``old`` elsewhere (e.g. revert non-participants' updates)."""
    return tree_util.map(
        lambda n, o: torch.where(per_client(mask, n), n, o), new, old)


def tree_where(cond: torch.Tensor, a: PyTree, b: PyTree) -> PyTree:
    """Scalar-condition select over whole trees (e.g. 'every sampled client
    dropped — keep the server model'); ``cond`` is a host scalar."""
    return a if bool(cond) else b


class ClientAxisCtx:
    """The unsharded view of the sampled-client axis (DESIGN.md §6).

    Round bodies write every cross-client operation against this
    interface.  Each method of the base class is exactly the operation
    the round bodies inlined before it existed, so the unsharded rounds
    are unchanged; :class:`repro_torch.core.distributed.ShardCtx`
    overrides them with a slice of the cohort a rank and collectives."""

    #: ranks the sampled-client axis is split across
    n_shards: int = 1

    def local_count(self, s: int) -> int:
        """Clients this shard owns of the ``s`` sampled a round."""
        return s

    def shard(self, arr: torch.Tensor) -> torch.Tensor:
        """This shard's rows of a full ``(s, ...)`` tensor."""
        return arr

    def shard_tree(self, tree: PyTree) -> PyTree:
        """``shard`` over every ``(s, ...)`` leaf (a stacked tree, a
        :class:`RoundPlan`)."""
        return tree

    def all_clients(self, vec: torch.Tensor) -> torch.Tensor:
        """The full ``(s, ...)`` tensor from every shard's rows, in shard
        order: metric vectors pass through it before any reduction, so
        every total comes from the same full vector at any shard count."""
        return vec

    def psum(self, x):
        """Sum a tensor (or a tree of them) across shards."""
        return x

    def all_clients_tree(self, tree: PyTree) -> PyTree:
        """``all_clients`` over every leaf: on the packed wire this moves
        the packed buffers across shards, not dense trees."""
        return tree

    def mean_clients(self, stacked: PyTree) -> PyTree:
        """Mean over the client axis of a stacked tree."""
        return tree_util.map(lambda t: t.mean(dim=0), stacked)

    def sum_clients(self, stacked: PyTree) -> PyTree:
        """Sum over the client axis of a stacked tree."""
        return tree_util.map(lambda t: t.sum(dim=0), stacked)

    def scatter_rows(self, full: PyTree, idx: torch.Tensor,
                     upd: PyTree) -> PyTree:
        """Write the shard's ``(s_loc, ...)`` rows ``upd`` at ``idx`` (on
        ``full``'s device) into the ``(n_clients, ...)`` store ``full``."""
        return tree_util.map(lambda t, r: t.index_copy(0, idx, r), full, upd)

    def encode_payload(self, comp, plan: RoundPlan, stacked: PyTree,
                       keys: Optional[torch.Tensor] = None):
        """The client boundary of the packed uplink (:func:`vmap_encode`)."""
        return vmap_encode(comp, plan, stacked, keys)

    def gather_decoded_payload(self, payload, partf_full: torch.Tensor):
        """The server side of the packed uplink (:func:`gather_decoded`):
        the full ``(s, ...)`` decode, on every shard."""
        return gather_decoded(payload, partf_full, self)

    def encode_broadcast(self, comp, tree: PyTree,
                         key: Optional[torch.Tensor] = None):
        """The downlink encode (DESIGN.md §10): one payload for the whole
        cohort, as a one-row stack.  The broadcast tree is the same on
        every shard, and so is its payload."""
        from repro_torch.compress import wire
        return wire.encode(comp, tree_util.map(lambda t: t.unsqueeze(0), tree),
                           None if key is None else key.unsqueeze(0))

    def decode_broadcast(self, payload) -> PyTree:
        """The clients' downlink decode, the companion of
        :meth:`encode_broadcast`."""
        from repro_torch.compress import wire
        return tree_util.map(lambda t: t[0], wire.decode(payload))


#: The default (unsharded) client-axis context.
NULL_CTX = ClientAxisCtx()


def mean_over_active(values: torch.Tensor, active: torch.Tensor,
                     ctx: ClientAxisCtx = NULL_CTX) -> torch.Tensor:
    """Mean of per-client scalars over the active subset; 0 if none is
    active.  With every client active this is ``values.mean()``'s sum and
    divisor.  Under a sharded ``ctx`` the masked sum and the active count
    are summed across shards."""
    act = active.to(device=values.device, dtype=values.dtype)
    return (ctx.psum((values * act).sum())
            / torch.clamp(ctx.psum(act.sum()), min=1.0))


def masked_mean(stacked: PyTree, weights: torch.Tensor,
                ctx: ClientAxisCtx = NULL_CTX,
                weight_sum: Optional[torch.Tensor] = None) -> PyTree:
    """Mean over the client axis weighted by the host ``weights`` ``(s,)``
    (e.g. the participation mask); a zero-weight round returns zeros,
    never NaN.  ``weight_sum`` replaces ``weights.sum()`` as the divisor
    (a hierarchical policy's weights sum to its ``n_selected`` only up to
    rounding).  Under a sharded ``ctx`` ``stacked`` and ``weights`` are
    the shard's rows, the numerator is summed across shards, and
    ``weight_sum`` (the full vector's total) keeps the divisor the
    unsharded one."""
    wsum = float(torch.clamp(weights.sum() if weight_sum is None
                             else weight_sum, min=1.0))
    return tree_util.map(
        lambda t: ctx.psum((t * per_client(weights, t)).sum(dim=0)) / wsum,
        stacked)


def batched_compress(comp, plan: RoundPlan, stacked, keys: torch.Tensor):
    """Compress a stacked-client tree in one call (the counterpart of
    ``vmap_compress``): returns ``(compressed stacked tree, BitsReport)``
    with ``(s,)`` report vectors — ``report.total_bits`` is the per-client
    wire cost.  The plan's per-client overrides go to ``comp.compress``
    as ``(s,)`` tensors, one value a client's row."""
    return comp.compress(stacked, keys, **plan.comp_overrides)


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


def gather_decoded(payload, partf_full: torch.Tensor,
                   ctx: ClientAxisCtx = NULL_CTX):
    """The server side of the packed uplink: mask non-participants, gather
    the packed buffers across shards (a sharded round's only uplink
    traffic) and decode the whole ``(s, ...)`` stack once."""
    from repro_torch.compress import wire
    masked = mask_payload(payload, ctx.shard(partf_full))
    return wire.decode(type(payload)(ctx.all_clients_tree(masked.data),
                                     payload.spec))


def apply_downlink(mode: str, comp, ctx: ClientAxisCtx, ref: PyTree,
                   x_new: PyTree, key: torch.Tensor, s: int):
    """The downlink seam (DESIGN.md §10) every round body shares: the
    server delta-codes the new broadcast ``x_new`` against ``ref``, the
    model the cohort last received, once for the whole cohort, and every
    client adopts ``y_new = ref + decode(C(x_new - ref))``.

    The delta goes through the compressor or the wire as a one-row stack
    (leading axis 1, key ``key[None]``): ``"account"`` applies the
    transform, ``"packed"`` moves the packed payload (``ctx``'s
    ``encode_broadcast`` / ``decode_broadcast``) and adds the measured
    ``downlink_payload_bytes`` (``s`` copies of it).  Both draw from the
    same key the same way, so the two modes are bit-identical.  Returns
    ``(y_new, downlink_bits, extra metrics)`` with the bits counted once a
    receiving client (``s * report.total_bits``)."""
    delta = tree_util.map(lambda a, b: a - b, x_new, ref)
    if mode == "packed":
        payload, rep = ctx.encode_broadcast(comp, delta, key)
        dec = ctx.decode_broadcast(payload)
        extras = {"downlink_payload_bytes": torch.tensor(
            float(s * payload.nbytes), dtype=torch.float32)}
    else:
        dec, rep = comp.compress(
            tree_util.map(lambda t: t.unsqueeze(0), delta), key.unsqueeze(0))
        dec = tree_util.map(lambda t: t[0], dec)
        extras = {}
    y_new = tree_util.map(lambda y, d: y + d, ref, dec)
    return y_new, rep.total_bits[0] * s, extras


def validate_schedule(schedule: ClientSchedule, n_clients: int,
                      compressor=None) -> ClientSchedule:
    """Check a schedule against an algorithm's config and compressor: the
    client count, and each per-client override's name and values."""
    if schedule.n_clients != n_clients:
        raise ValueError(
            f"schedule profiles {schedule.n_clients} clients but the config "
            f"has n_clients={n_clients}")
    params = schedule.profile.comp_params
    if params:
        if compressor is None:
            # an algorithm that never compresses would silently drop them
            raise ValueError(
                f"profile comp_params {sorted(params)} given, but this "
                f"algorithm has no compressor to apply them")
        accepted = set(compressor.param_overrides())
        unknown = set(params) - accepted
        if unknown:
            raise ValueError(
                f"profile comp_params {sorted(unknown)} are not accepted by "
                f"{type(compressor).__name__} (accepts {sorted(accepted)})")
        for name, values in params.items():
            compressor.validate_override(name, values.numpy())
    return schedule
