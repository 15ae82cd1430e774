"""Communication accounting (the paper's "communicated bits" x-axes) —
the port of ``repro.core.comm``.

The bits on the wire are computed from the actual payloads by
:mod:`repro_torch.compress` and accumulated here, uplink (client ->
server) and downlink (server -> client) separately.  Two accumulator
modes:

* ``mode="host"`` (the default): every record coerces to python floats,
  a device sync the per-round driver makes for its metrics anyway;
* ``mode="device"`` (the reference's ``"jnp"``, which is accepted as its
  spelling): the sums stay tensors on the device they were recorded from,
  in the metrics' dtype; the adds are queued device operations, and
  nothing synchronises until a property or ``snapshot()`` is read.
"""

from __future__ import annotations

from typing import Any, Union

import numpy as np
import torch

Scalar = Union[float, Any]  # float, or a tensor in "device" mode

MODES = ("host", "device")


class CommMeter:
    def __init__(self, mode: str = "host"):
        mode = "device" if mode == "jnp" else mode
        if mode not in MODES:
            raise ValueError(f"unknown CommMeter mode {mode!r}")
        self.mode = mode
        self._uplink: Scalar = 0.0
        self._downlink: Scalar = 0.0
        self.rounds = 0

    def _value(self, v) -> Scalar:
        """A recorded amount: a python float in host mode; in device mode
        a tensor where it was, in its own dtype, as the reference's
        ``"jnp"`` sums keep the metric's float32."""
        if self.mode == "host":
            return float(v)
        if isinstance(v, torch.Tensor):
            return v.detach()
        return torch.from_numpy(np.asarray(v)) if isinstance(
            v, np.ndarray) else v

    def record_round(self, *, uplink_bits, downlink_bits) -> None:
        self._uplink = self._uplink + self._value(uplink_bits)
        self._downlink = self._downlink + self._value(downlink_bits)
        self.rounds += 1

    def record_rounds(self, *, uplink_bits, downlink_bits,
                      num_rounds: int) -> None:
        """Batched recording: per-round arrays (summed here) or None."""
        def total(v):
            return 0.0 if v is None else self._value(v.sum())

        self._uplink = self._uplink + total(uplink_bits)
        self._downlink = self._downlink + total(downlink_bits)
        self.rounds += int(num_rounds)

    # -- reading (host floats; a sync in "device" mode) -------------------- #

    @property
    def uplink_bits(self) -> float:
        return float(self._uplink)

    @property
    def downlink_bits(self) -> float:
        return float(self._downlink)

    @property
    def total_bits(self) -> float:
        return self.uplink_bits + self.downlink_bits

    def snapshot(self) -> dict:
        return {"rounds": self.rounds, "uplink_bits": self.uplink_bits,
                "downlink_bits": self.downlink_bits,
                "total_bits": self.total_bits}
