"""Input pipeline of the port: deterministic synthetic datasets, a copy of
``repro.data.pipeline`` (numpy only; the port imports nothing of the JAX
package, so it keeps its own copy).

The data are the same arrays, drawn by the same ``numpy`` generators in
the same order: ``synth_mnist`` / ``make_classification`` (the paper
nets' stand-ins for MNIST and CIFAR, Figs 2-5), the ``split`` and the
epoch shuffles of ``ClassificationDataset.batches``, and ``TokenStream``
(next-token pairs with a Zipf unigram base and order-1 Markov mixing).
Nothing is downloaded.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass
class ClassificationDataset:
    x: np.ndarray  # (N, D) f32
    y: np.ndarray  # (N,) i32
    num_classes: int

    def split(
        self, frac: float = 0.9
    ) -> tuple["ClassificationDataset", "ClassificationDataset"]:
        n = int(len(self.x) * frac)
        return (
            ClassificationDataset(self.x[:n], self.y[:n], self.num_classes),
            ClassificationDataset(self.x[n:], self.y[n:], self.num_classes),
        )

    def batches(
        self, batch_size: int, seed: int = 0, epochs: int = 1,
        drop_remainder: bool = True,
    ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        rng = np.random.default_rng(seed)
        n = len(self.x)
        for _ in range(epochs):
            order = rng.permutation(n)
            stop = n - n % batch_size if drop_remainder else n
            for i in range(0, stop, batch_size):
                idx = order[i : i + batch_size]
                yield self.x[idx], self.y[idx]


def make_classification(
    n: int,
    dim: int,
    num_classes: int,
    seed: int = 0,
    noise: float = 1.0,
    subspace: Optional[int] = None,
) -> ClassificationDataset:
    """K-Gaussian-mixture classification with class means on a low-dim
    subspace (makes low-rank weight approximations meaningful, Fig 3)."""
    rng = np.random.default_rng(seed)
    sub = subspace or min(dim, 64)
    basis = rng.standard_normal((sub, dim)).astype(np.float32)
    basis /= np.linalg.norm(basis, axis=1, keepdims=True)
    means = rng.standard_normal((num_classes, sub)).astype(np.float32) * 3.0
    y = rng.integers(0, num_classes, size=n).astype(np.int32)
    x = means[y] @ basis + noise * rng.standard_normal((n, dim)).astype(
        np.float32
    )
    # normalize to [0, 1]-ish like pixel data, keeps ReLU stats realistic
    x = (x - x.min()) / (x.max() - x.min())
    return ClassificationDataset(x.astype(np.float32), y, num_classes)


def synth_mnist(n: int = 12_000, seed: int = 0) -> ClassificationDataset:
    """784-d, 10-class stand-in for MNIST (paper Fig 2/3 substrate)."""
    return make_classification(n, 784, 10, seed=seed, noise=1.2, subspace=32)


@dataclasses.dataclass
class TokenStream:
    """Deterministic LM token stream with checkpointable position.

    Zipf unigram base with order-1 Markov structure: p(t | prev) mixes a
    per-prev permutation of the Zipf table, so cross-entropy is reducible
    below the unigram entropy — enough signal for the ~100M-param example
    run to show a falling loss curve.
    """

    vocab_size: int
    seq_len: int
    batch_size: int  # per-host batch
    seed: int = 0
    host_id: int = 0
    num_hosts: int = 1
    step: int = 0  # checkpointable iterator state

    def _rng_for(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            (self.seed * 1_000_003 + step) * self.num_hosts + self.host_id
        )

    def next_batch(self) -> dict[str, np.ndarray]:
        rng = self._rng_for(self.step)
        self.step += 1
        b, s, v = self.batch_size, self.seq_len, self.vocab_size
        # Zipf ranks with Markov mixing
        ranks = rng.zipf(1.3, size=(b, s + 1)).astype(np.int64)
        base = np.minimum(ranks, v) - 1
        shift = np.arange(b)[:, None] * 7 + np.roll(base, 1, axis=1) * 31
        toks = ((base + shift) % v).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def state(self) -> dict:
        return {"step": self.step, "seed": self.seed, "host_id": self.host_id}

    def restore(self, state: dict) -> None:
        self.step = int(state["step"])
