"""Dirichlet(alpha) heterogeneous partitioning (paper §4, Appendix B.1).

Each client draws a class-preference vector from Dir(alpha); labels/images
are assigned per those preferences until all data is distributed — lower
alpha = more heterogeneous shards (alpha -> 0: single-class clients;
alpha -> inf: IID).  Mirrors the FedLab partitioner the paper uses.

A copy of ``repro.data.dirichlet``; the same seed gives equal partitions.
"""

from __future__ import annotations

import numpy as np


def dirichlet_partition(labels: np.ndarray, n_clients: int, alpha: float,
                        seed: int = 0, min_size: int = 1) -> list[np.ndarray]:
    """Return per-client global-index lists."""
    rng = np.random.default_rng(seed)
    labels = np.asarray(labels)
    n_classes = int(labels.max()) + 1
    by_class = [np.flatnonzero(labels == c) for c in range(n_classes)]
    for idx in by_class:
        rng.shuffle(idx)

    while True:
        parts: list[list[int]] = [[] for _ in range(n_clients)]
        for c in range(n_classes):
            idx = by_class[c]
            props = rng.dirichlet(np.full(n_clients, alpha))
            # split this class's samples proportionally
            cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
            for i, chunk in enumerate(np.split(idx, cuts)):
                parts[i].extend(chunk.tolist())
        sizes = np.array([len(p) for p in parts])
        if sizes.min() >= min_size:
            break
        seed += 1
        rng = np.random.default_rng(seed)
    return [np.asarray(sorted(p), dtype=np.int64) for p in parts]
