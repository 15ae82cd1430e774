"""Round drivers (the port of ``repro.core.engine``).

Algorithms define ``_round_impl(state, key, ctx) -> (state, metrics)`` where
``metrics`` holds scalars and ``(s,)`` per-client vectors (tensors);
:class:`RoundEngine` provides the two drivers:

* ``round(state, key)`` — one round, metrics pulled to the host;
* ``run_rounds(state, key, num_rounds)`` — ``num_rounds`` rounds on the
  reference's fused key chain (``key, sub = split(key)`` per round),
  metrics stacked over a leading round axis.  Here it is a Python loop; a
  CUDA graph over a round is later work.

Both record into ``self.meter`` (:class:`repro_torch.core.comm.CommMeter`).
``use_mesh`` binds a client-axis mesh (DESIGN.md §6): both drivers then
run ``_round_impl`` under a :class:`repro_torch.core.distributed.ShardCtx`
with the sampled clients split over the mesh's ``clients`` ranks, every
rank calling them with the same state and key; on a mesh composed with a
``model`` axis (DESIGN.md §9) under a ``ModelShardCtx``, whose wire runs
shard-local over the model ranks.
``set_policy`` binds one of the three aggregation policies (DESIGN.md §7),
``set_wire`` the wire mode, ``"account"`` or ``"packed"`` (DESIGN.md §8),
and ``set_downlink`` the downlink mode, ``"dense"``, ``"account"`` or
``"packed"`` (DESIGN.md §10).  ``store=`` picks where per-client state
lives (:mod:`repro_torch.core.client_store`); before the rounds run, the
engine replays their key chain on the host and hands a prefetching
``HostStore`` the cohorts they will gather (``_plan_cohorts``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch import tree as tree_util

PyTree = Any

WIRE_MODES = ("account", "packed")

DOWNLINK_MODES = ("dense", "account", "packed")


def value_and_grad(loss_fn, params: PyTree, xb, yb):
    """Per-client losses ``(s,)`` and gradients of stacked ``params``: one
    forward/backward for the whole cohort (each client's loss depends only
    on its own rows, so the summed loss's gradient is each client's)."""
    flat = [p.detach().requires_grad_(True) for p in tree_util.leaves(params)]
    with torch.enable_grad():
        losses = loss_fn(tree_util.unflatten(params, flat), xb, yb)
        grads = torch.autograd.grad(losses.sum(), flat)
    return losses.detach(), tree_util.unflatten(params, list(grads))


def _host(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def validate_downlink(downlink: Optional[str], compressor) -> str:
    """Resolve and check a downlink mode (DESIGN.md §10) at construction
    time.  ``"dense"`` (the default) broadcasts the raw model and accounts
    it at full width; ``"account"`` and ``"packed"`` delta-code the
    broadcast against the clients' last-received model through a downlink
    compressor (``Identity()`` for the dense codec), the latter moving the
    real packed payload, so it needs a compressor the wire layer can pack.
    """
    downlink = "dense" if downlink is None else downlink
    if downlink not in DOWNLINK_MODES:
        raise ValueError(
            f"downlink must be one of {DOWNLINK_MODES}, got {downlink!r}")
    if downlink != "dense":
        if compressor is None:
            raise ValueError(
                f'downlink="{downlink}" needs a downlink compressor '
                "(downlink_compressor=...; Identity() for the dense codec)")
        if downlink == "packed":
            from repro_torch.compress import wire as wire_mod
            wire_mod.check_supported(compressor)
    return downlink


def validate_wire(wire: Optional[str], compressor, schedule=None) -> str:
    """Resolve and check a wire mode at construction time.  ``"account"``
    (the default) moves dense trees and only the bits ledger claims
    compression; ``"packed"`` needs a compressor the wire layer can pack
    (``repro_torch.compress.wire.check_supported``) and a schedule without
    per-client compressor overrides, which change payload shapes."""
    wire = "account" if wire is None else wire
    if wire not in WIRE_MODES:
        raise ValueError(f"wire must be one of {WIRE_MODES}, got {wire!r}")
    if wire == "packed":
        from repro_torch.compress import wire as wire_mod
        wire_mod.check_supported(compressor)
        if schedule is not None and schedule.profile.comp_params:
            raise ValueError(
                "packed wire mode cannot carry per-client compressor "
                f"overrides {sorted(schedule.profile.comp_params)} (static "
                "payload capacity); run per-client overrides in account "
                "mode")
    return wire


class RoundEngine:
    """Mixin: host-stepped ``round`` + multi-round ``run_rounds``."""

    _mesh = None        # the bound client-axis mesh (None: unsharded)
    _sharded = None     # shard_round(_round_impl, _mesh) while it is bound

    def _setup_engine(self) -> None:
        from repro_torch.core import aggregation, client_store
        self.policy = aggregation.validate_policy(
            getattr(self, "policy", None), self.cfg.clients_per_round)
        self.store = client_store.resolve_store(getattr(self, "store", None))
        self.wire = validate_wire(getattr(self, "wire", None),
                                  getattr(self, "comp", None),
                                  getattr(self, "sched", None))
        self.down_comp = getattr(self, "down_comp", None)
        self.downlink = validate_downlink(getattr(self, "downlink", None),
                                          self.down_comp)
        self._validate_downlink_combo()

    def set_wire(self, wire: str) -> "RoundEngine":
        """Bind a wire mode, ``"account"`` or ``"packed"``; returns self."""
        self.wire = validate_wire(wire, getattr(self, "comp", None),
                                  getattr(self, "sched", None))
        return self

    def _validate_downlink_combo(self) -> None:
        """Algorithm-specific downlink checks (none here); FedComLoc
        overrides it."""

    def set_downlink(self, downlink: str, compressor=None) -> "RoundEngine":
        """Bind a downlink mode (DESIGN.md §10), ``"dense"``, ``"account"``
        or ``"packed"``; ``compressor`` replaces the bound downlink
        compressor when given.  The downlink reference ``y`` lives in the
        algorithm's state, so call this before ``init``.  Returns self."""
        comp = compressor if compressor is not None else self.down_comp
        self.downlink = validate_downlink(downlink, comp)
        self.down_comp = comp
        self._validate_downlink_combo()
        return self

    def set_policy(self, policy) -> "RoundEngine":
        """Bind an aggregation policy (DESIGN.md §7), ``None`` = sync;
        returns self."""
        from repro_torch.core import aggregation
        self.policy = aggregation.validate_policy(
            policy, self.cfg.clients_per_round)
        return self

    def use_mesh(self, mesh, axis: str = "clients") -> "RoundEngine":
        """Bind (or, with ``None``, unbind) a client-axis mesh, a
        ``torch.distributed`` ``DeviceMesh`` with a ``clients`` axis, alone
        or composed with ``data`` and ``model`` axes
        (:func:`repro_torch.launch.mesh.make_client_mesh`).  With a mesh
        bound, ``round`` and ``run_rounds`` split the sampled clients over
        its ranks (DESIGN.md §6): metric scalars bit-identical to the
        unsharded rounds, parameters allclose (bit-identical on one rank).
        A ``model`` axis packs the wire shard-local (DESIGN.md §9): bits
        still exact, values apart only where ties or a shard's cap say.
        Binding the mesh already bound is a no-op.  Returns self."""
        if (mesh is self._mesh
                or (mesh is not None and self._mesh is not None
                    and mesh == self._mesh)):
            return self
        sharded = None
        if mesh is not None:
            if self.store.host_side:
                raise ValueError(
                    "host-side client stores (HostStore) cannot run under a "
                    "client-axis mesh; use the in-memory store with meshes, "
                    "or drop the mesh for out-of-core populations")
            if getattr(getattr(self, "sched", None), "uses_host_sampler",
                       False):
                raise ValueError(
                    "host-side cohort sampling (sampler='tree') cannot run "
                    "under a client-axis mesh; use sampler='gumbel' with "
                    "meshes")
            from repro_torch.core import distributed
            sharded = distributed.shard_round(
                self._round_impl, mesh, self.cfg.clients_per_round, axis)
        self._mesh, self._sharded = mesh, sharded
        return self

    def _step(self, state, key):
        """One ``_round_impl`` call, split over the bound mesh if any."""
        if self._sharded is None:
            return self._round_impl(state, key)
        return self._sharded(state, key)

    #: the round's key fanout: ``_round_impl`` draws its sampling key as
    #: ``split(key, fanout)[0]``; algorithms set it so that
    #: ``_plan_cohorts`` can replay the key chain (``None``: no plan)
    _round_key_fanout: Optional[int] = None

    def _plan_cohorts(self, state, key, num_rounds: int,
                      stepped: bool = False) -> None:
        """Replay the coming rounds' sampling keys on the host and hand
        the cohorts to a prefetching store.

        Round r's key is r applications of ``key, sub = split(key)`` and
        its sampling key ``split(sub, fanout)[0]``.  Tree-sampler
        schedules draw each cohort in O(s log n) (memoised, so the round
        reuses the same arrays); schedules without availability replay the
        uniform ``choice``.  Gumbel schedules are not replayed (that is
        the O(n) work the tree sampler removes): the store then runs
        write-behind only.  The plan is a hint; a wrong one costs a
        prefetch miss, never a wrong row."""
        store, sched = self.store, getattr(self, "sched", None)
        if (not getattr(store, "prefetch", False) or sched is None
                or self._round_key_fanout is None):
            return
        if sched.availability is not None and not sched.uses_host_sampler:
            return
        s = self.cfg.clients_per_round
        t0 = int(state.round)
        key = prng.key_data(key)
        cohorts = []
        for r in range(num_rounds):
            if stepped:
                sub = key           # round() receives the round key itself
            else:
                key, sub = prng.split(key, 2)
            k_sample = prng.split(sub, self._round_key_fanout)[0]
            if sched.uses_host_sampler:
                clients, _ = sched.plan_cohort_host(k_sample, s, t0 + r)
            else:
                clients = prng.choice(k_sample, sched.n_clients, s).numpy()
            cohorts.append(clients)
        store.submit_cohort_plan(cohorts)

    def round(self, state, key) -> Tuple[Any, Dict[str, Any]]:
        """Run one communication round; returns (state, metrics) with
        scalars as python floats and per-client vectors as numpy arrays."""
        self._plan_cohorts(state, key, 1, stepped=True)
        state, metrics = self._step(state, prng.key_data(key))
        self.meter.record_round(
            uplink_bits=metrics.get("uplink_bits", 0.0),
            downlink_bits=metrics.get("downlink_bits", 0.0))
        out = {}
        for k, v in metrics.items():
            a = _host(v)
            out[k] = a if a.ndim else float(a)
        return state, out

    def run_rounds(self, state, key, num_rounds: int
                   ) -> Tuple[Any, Dict[str, np.ndarray]]:
        """Run ``num_rounds`` rounds on the fused engine's key chain.

        Returns ``(state, metrics)`` with each metric stacked over a leading
        ``(num_rounds,)`` axis.  After this call, advance your key by
        ``num_rounds`` ``split`` steps to stay on the same chain.
        """
        num_rounds = int(num_rounds)
        if num_rounds <= 0:
            raise ValueError("num_rounds must be positive")
        key = prng.key_data(key)
        self._plan_cohorts(state, key, num_rounds)
        rows = []
        for _ in range(num_rounds):
            key, sub = prng.split(key, 2)
            state, metrics = self._step(state, sub)
            rows.append(metrics)
        stacked = {k: np.stack([_host(m[k]) for m in rows]) for k in rows[0]}
        bits = stacked
        if self.meter.mode == "device":
            # the meter sums the rounds' own tensors, where they are
            bits = {k: torch.stack([torch.as_tensor(m[k]) for m in rows])
                    for k in ("uplink_bits", "downlink_bits") if k in rows[0]}
        self.meter.record_rounds(uplink_bits=bits.get("uplink_bits"),
                                 downlink_bits=bits.get("downlink_bits"),
                                 num_rounds=num_rounds)
        return state, stacked
