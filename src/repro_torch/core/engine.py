"""Round drivers (the port of ``repro.core.engine``).

Algorithms define ``_round_impl(state, key) -> (state, metrics)`` where
``metrics`` holds scalars and ``(s,)`` per-client vectors (tensors);
:class:`RoundEngine` provides the two drivers:

* ``round(state, key)`` — one round, metrics pulled to the host;
* ``run_rounds(state, key, num_rounds)`` — ``num_rounds`` rounds on the
  reference's fused key chain (``key, sub = split(key)`` per round),
  metrics stacked over a leading round axis.  Here it is a Python loop; a
  CUDA graph over a round is later work.

Both record into ``self.meter`` (:class:`repro_torch.core.comm.CommMeter`).
``set_policy`` binds one of the three aggregation policies (DESIGN.md §7)
and ``set_wire`` the wire mode, ``"account"`` or ``"packed"`` (DESIGN.md
§8); only ``downlink="dense"`` is ported.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import not_ported, prng
from repro_torch import tree as tree_util

PyTree = Any

WIRE_MODES = ("account", "packed")


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


def validate_wire(wire: Optional[str], compressor) -> str:
    """Resolve and check a wire mode at construction time.  ``"account"``
    (the default) moves dense trees and only the bits ledger claims
    compression; ``"packed"`` needs a compressor the wire layer can pack
    (``repro_torch.compress.wire.check_supported``)."""
    wire = "account" if wire is None else wire
    if wire not in WIRE_MODES:
        raise ValueError(f"wire must be one of {WIRE_MODES}, got {wire!r}")
    if wire == "packed":
        from repro_torch.compress import wire as wire_mod
        wire_mod.check_supported(compressor)
    return wire


class RoundEngine:
    """Mixin: host-stepped ``round`` + multi-round ``run_rounds``."""

    def _setup_engine(self) -> None:
        from repro_torch.core import aggregation
        self.policy = aggregation.validate_policy(
            getattr(self, "policy", None), self.cfg.clients_per_round)
        self.wire = validate_wire(getattr(self, "wire", None),
                                  getattr(self, "comp", None))
        if getattr(self, "downlink", "dense") != "dense":
            raise not_ported(f"downlink={self.downlink!r}")
        if getattr(self, "store", None) is not None:
            raise not_ported("client stores")

    def set_wire(self, wire: str) -> "RoundEngine":
        """Bind a wire mode, ``"account"`` or ``"packed"``; returns self."""
        self.wire = validate_wire(wire, getattr(self, "comp", None))
        return self

    def set_policy(self, policy) -> "RoundEngine":
        """Bind an aggregation policy (DESIGN.md §7), ``None`` = sync;
        returns self."""
        from repro_torch.core import aggregation
        self.policy = aggregation.validate_policy(
            policy, self.cfg.clients_per_round)
        return self

    def round(self, state, key) -> Tuple[Any, Dict[str, Any]]:
        """Run one communication round; returns (state, metrics) with
        scalars as python floats and per-client vectors as numpy arrays."""
        state, metrics = self._round_impl(state, prng.key_data(key))
        out = {}
        for k, v in metrics.items():
            a = _host(v)
            out[k] = a if a.ndim else float(a)
        self.meter.record_round(uplink_bits=out.get("uplink_bits", 0.0),
                                downlink_bits=out.get("downlink_bits", 0.0))
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
        rows = []
        for _ in range(num_rounds):
            key, sub = prng.split(key, 2)
            state, metrics = self._round_impl(state, sub)
            rows.append(metrics)
        stacked = {k: np.stack([_host(m[k]) for m in rows]) for k in rows[0]}
        self.meter.record_rounds(uplink_bits=stacked.get("uplink_bits"),
                                 downlink_bits=stacked.get("downlink_bits"),
                                 num_rounds=num_rounds)
        return state, stacked
