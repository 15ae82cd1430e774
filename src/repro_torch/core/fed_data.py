"""Federated dataset container (the port of ``repro.core.fed_data``).

Holds the global arrays on the device plus per-client index tables (ragged
sizes padded to the max; batch sampling draws uniformly in
``[0, size_i)`` so padding never biases).  Produced from a
:mod:`repro_torch.data.dirichlet` partition.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import prng


@dataclasses.dataclass(frozen=True)
class FederatedData:
    x: torch.Tensor               # (N, ...) global inputs, on the device
    y: torch.Tensor               # (N,) targets (int64 labels), on the device
    client_indices: torch.Tensor  # (n_clients, max_size) int64, on the device
    client_sizes: torch.Tensor    # (n_clients,) int64, on the host

    @property
    def device(self) -> torch.device:
        return self.x.device

    def sample_batch(self, keys: torch.Tensor, clients: torch.Tensor,
                     batch: int):
        """Uniform-with-replacement minibatches, batched over leading axes.

        ``keys`` ``(..., 2)`` and ``clients`` ``(...)`` (host tensors) give
        one batch per entry: ``randint(key, (batch,), 0, max(size, 1))``
        positions into that client's shard, exactly the reference's draw.
        Returns ``(x (..., batch, ...), y (..., batch))`` on the device.
        """
        clients = clients.to(torch.int64)
        span = torch.clamp(self.client_sizes[clients], min=1)
        pos = prng.randint(keys, batch, 0, span)
        dev = self.device
        idx = self.client_indices[clients.to(dev).unsqueeze(-1), pos.to(dev)]
        return self.x[idx], self.y[idx]


def from_numpy_partition(x: np.ndarray, y: np.ndarray,
                         parts: list[np.ndarray],
                         device="cuda") -> FederatedData:
    """``parts[i]`` = global indices owned by client ``i`` (ragged)."""
    n = len(parts)
    max_sz = max(max(len(p) for p in parts), 1)
    idx = np.zeros((n, max_sz), dtype=np.int64)
    sizes = np.zeros((n,), dtype=np.int64)
    for i, p in enumerate(parts):
        sizes[i] = len(p)
        if len(p):
            idx[i, :len(p)] = p
    y = np.asarray(y)
    if np.issubdtype(y.dtype, np.integer):
        y = y.astype(np.int64)          # class labels index with int64
    return FederatedData(
        x=torch.from_numpy(np.asarray(x)).to(device),
        y=torch.from_numpy(y).to(device),
        client_indices=torch.from_numpy(idx).to(device),
        client_sizes=torch.from_numpy(sizes))
