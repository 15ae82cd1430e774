"""Federated dataset containers (the port of ``repro.core.fed_data``).

* :class:`FederatedData` holds the global arrays on the device plus
  per-client index tables (ragged sizes padded to the max; batch sampling
  draws uniformly in ``[0, size_i)`` so padding never biases).  Produced
  from a :mod:`repro_torch.data.dirichlet` partition.
* :class:`SyntheticFederatedData` is procedural regression data for
  million-client populations: O(dim) memory for any ``n_clients``, each
  client's law derived from its id (DESIGN.md §11).

Both take the same batched ``sample_batch(keys (..., 2), clients (...),
batch)`` and draw the reference's values from the same keys.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import prng

#: normals :meth:`SyntheticFederatedData.sample_batch` draws at once; a
#: local step of the population benchmark (64 clients x 256 x 2048) runs
#: in 8 pieces of this size
_CHUNK_ELEMS = 1 << 22


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


@dataclasses.dataclass(frozen=True)
class SyntheticFederatedData:
    """Procedural federated regression data: O(dim) memory for any
    ``n_clients``.

    Only the ``(dim,)`` ground-truth weights ``w0`` are stored.  Client
    ``c`` draws batches from ``y = x @ (w0 + hetero * n_c) + noise * eps``
    with ``n_c ~ N(0, I)`` seeded by ``fold_in(PRNGKey(seed + 1), c)``,
    the reference's draws bit for bit (``y`` goes through a float32 matrix
    product, so it agrees to rounding).
    """

    w0: torch.Tensor           # (dim,) ground-truth weights, on the device
    n_clients: int
    hetero: float = 0.1        # per-client optimum spread
    noise: float = 0.0         # observation noise stddev
    seed: int = 0              # root of the per-client draws

    @classmethod
    def create(cls, n_clients: int, dim: int, *, hetero: float = 0.1,
               noise: float = 0.0, seed: int = 0,
               device="cuda") -> "SyntheticFederatedData":
        w0 = prng.normal(prng.PRNGKey(seed), (dim,), device=device)
        return cls(w0=w0, n_clients=n_clients, hetero=hetero, noise=noise,
                   seed=seed)

    @property
    def device(self) -> torch.device:
        return self.w0.device

    @property
    def dim(self) -> int:
        return self.w0.shape[0]

    def client_weights(self, clients) -> torch.Tensor:
        """Each client's optimum ``w0 + hetero * normal(fold_in(PRNGKey(
        seed + 1), c), (dim,))``: ``clients (...)`` -> ``(..., dim)``."""
        kc = prng.fold_in(prng.PRNGKey(self.seed + 1),
                          torch.as_tensor(clients).cpu())
        return self.w0 + self.hetero * prng.normal(kc, (self.dim,),
                                                   device=self.device)

    def sample_batch(self, keys: torch.Tensor, clients, batch: int):
        """Fresh regression minibatches, batched over leading axes: per
        entry ``kx, ke = split(key)``, ``x = normal(kx, (batch, dim))``,
        ``y = x @ w_c`` (plus ``noise * normal(ke, (batch,))``).  Returns
        ``(x (..., batch, dim), y (..., batch))`` on the device; the draws
        run a few entries at a time so that their temporaries stay small.
        """
        keys = prng.key_data(keys).cpu()
        clients = torch.as_tensor(clients, dtype=torch.int64).cpu()
        lead = tuple(clients.shape)
        flat_keys = prng.split(keys.reshape(-1, 2), 2)        # (E, 2, 2)
        w = self.client_weights(clients.reshape(-1))          # (E, dim)
        e, d = flat_keys.shape[0], self.dim
        x = torch.empty((e, batch, d), dtype=torch.float32,
                        device=self.device)
        step = max(1, _CHUNK_ELEMS // max(batch * d, 1))
        for i in range(0, e, step):
            x[i:i + step] = prng.normal(flat_keys[i:i + step, 0],
                                        (batch, d), device=self.device)
        y = torch.bmm(x, w.unsqueeze(-1)).squeeze(-1)
        if self.noise:
            y = y + self.noise * prng.normal(flat_keys[:, 1], (batch,),
                                             device=self.device)
        return (x.reshape(lead + (batch, d)), y.reshape(lead + (batch,)))


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
