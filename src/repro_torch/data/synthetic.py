"""Synthetic structured dataset: the offline stand-in for MNIST.

A copy of ``repro.data.synthetic``'s numpy code for the port's slices
(``make_mnist_like``, ``make_lm_tokens``); the same seed gives byte-equal
arrays.  Each class
gets an anchor in a latent space; samples are anchor + noise, pushed
through a fixed random nonlinear "renderer" into 784 dimensions.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Dataset:
    x_train: np.ndarray
    y_train: np.ndarray
    x_test: np.ndarray
    y_test: np.ndarray
    n_classes: int

    @property
    def input_shape(self):
        return self.x_train.shape[1:]


def _render(z: np.ndarray, rng: np.random.Generator, out_dim: int,
            depth: int) -> np.ndarray:
    h = z
    for _ in range(depth):
        w = rng.normal(size=(h.shape[1], h.shape[1])) / np.sqrt(h.shape[1])
        h = np.tanh(h @ w)
    w_out = rng.normal(size=(h.shape[1], out_dim)) / np.sqrt(h.shape[1])
    return h @ w_out


def make_mnist_like(n_train: int = 60_000, n_test: int = 10_000,
                    seed: int = 0, noise: float = 0.35) -> Dataset:
    """10-class, 784-dim, high SNR — an MLP should reach >0.9 accuracy."""
    return _make(n_train, n_test, seed, latent=32, out_dim=784,
                 depth=1, noise=noise, n_classes=10, image=False)


def _make(n_train, n_test, seed, *, latent, out_dim, depth, noise,
          n_classes, image) -> Dataset:
    rng = np.random.default_rng(seed)
    anchors = rng.normal(size=(n_classes, latent))
    anchors *= 2.0 / np.linalg.norm(anchors, axis=1, keepdims=True)

    def sample(n, rng_):
        y = rng_.integers(0, n_classes, size=n)
        z = anchors[y] + noise * rng_.normal(size=(n, latent))
        return z, y

    n_total = n_train + n_test
    z, y = sample(n_total, rng)
    render_rng = np.random.default_rng(seed + 1)
    x = _render(z, render_rng, out_dim, depth).astype(np.float32)
    x = (x - x.mean(axis=0)) / (x.std(axis=0) + 1e-6)
    if image:
        x = x.reshape(-1, 32, 32, 3)
    return Dataset(
        x_train=x[:n_train], y_train=y[:n_train].astype(np.int32),
        x_test=x[n_train:], y_test=y[n_train:].astype(np.int32),
        n_classes=n_classes)


def make_lm_tokens(vocab: int, n_seqs: int, seq_len: int,
                   seed: int = 0) -> np.ndarray:
    """Synthetic token streams with Markov structure (serving prompts)."""
    rng = np.random.default_rng(seed)
    # sparse bigram transition structure: each token prefers a few successors
    n_next = 8
    succ = rng.integers(0, vocab, size=(vocab, n_next))
    out = np.empty((n_seqs, seq_len), dtype=np.int32)
    tok = rng.integers(0, vocab, size=n_seqs)
    for t in range(seq_len):
        out[:, t] = tok
        explore = rng.random(n_seqs) < 0.1
        nxt = succ[tok, rng.integers(0, n_next, size=n_seqs)]
        tok = np.where(explore, rng.integers(0, vocab, size=n_seqs), nxt)
    return out
