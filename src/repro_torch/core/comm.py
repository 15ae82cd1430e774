"""Communication accounting (the paper's "communicated bits" x-axes) —
the port of ``repro.core.comm``, host mode.

The bits on the wire are computed from the actual payloads by
:mod:`repro_torch.compress` and accumulated here as python floats, uplink
(client -> server) and downlink (server -> client) separately.
"""

from __future__ import annotations

from repro_torch import not_ported


class CommMeter:
    def __init__(self, mode: str = "host"):
        if mode != "host":
            raise not_ported(f"CommMeter mode {mode!r}")
        self.mode = mode
        self._uplink = 0.0
        self._downlink = 0.0
        self.rounds = 0

    def record_round(self, *, uplink_bits, downlink_bits) -> None:
        self._uplink += float(uplink_bits)
        self._downlink += float(downlink_bits)
        self.rounds += 1

    def record_rounds(self, *, uplink_bits, downlink_bits,
                      num_rounds: int) -> None:
        """Batched recording: per-round arrays (summed here) or None."""
        def total(v):
            return 0.0 if v is None else float(v.sum())

        self._uplink += total(uplink_bits)
        self._downlink += total(downlink_bits)
        self.rounds += int(num_rounds)

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
