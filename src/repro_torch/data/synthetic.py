"""Deterministic synthetic data: LM token streams and MIPS datasets (from
``repro.data.synthetic``).

The LM stream is a seeded Zipf-unigram / Markov-bigram mixture, with
learnable structure so a few hundred training steps visibly reduce the
loss.  The MIPS generators reproduce the paper's experimental settings:
gaussian, uniform, the adversarial Bernoulli construction of Fig. 1, and
a low-rank matrix-factorization proxy for the Netflix/Yahoo embeddings
of Fig. 4.
All are numpy, draw from ``numpy.random.default_rng`` in the JAX
package's order, and so return the JAX package's arrays bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Tuple

import numpy as np

__all__ = ["LMStream", "gaussian_dataset", "uniform_dataset",
           "adversarial_dataset", "mf_dataset"]


@dataclasses.dataclass
class LMStream:
    """A deterministic LM batch stream, indexable by step: a restart
    resumes at exactly the right batch (no data replayed or skipped)."""

    vocab: int
    batch: int
    seq: int
    seed: int = 0

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """``{"tokens", "labels"}`` int32 ``(batch, seq)``, the labels the
        tokens shifted by one."""
        rng = np.random.default_rng((self.seed, step))
        # zipf unigram over a head of the vocab + bigram chain
        head = min(self.vocab, 4096)
        base = rng.zipf(1.3, size=(self.batch, self.seq + 1)) % head
        drift = np.cumsum(rng.integers(0, 3, size=(self.batch, self.seq + 1)),
                          axis=1)
        toks = ((base + drift) % self.vocab).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def gaussian_dataset(n: int, N: int, seed: int = 0
                     ) -> Tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, N)).astype(np.float32),
            rng.normal(size=N).astype(np.float32))


def uniform_dataset(n: int, N: int, seed: int = 0
                    ) -> Tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, size=(n, N)).astype(np.float32),
            rng.uniform(0, 1, size=N).astype(np.float32))


def adversarial_dataset(n: int, N: int, seed: int = 0) -> np.ndarray:
    """The paper's Fig-1 construction, directly as a reward matrix.

    Each arm's true mean is uniform in [0, 1]; rewards are Bernoulli and
    the oracle returns all 1-rewards before any 0-reward (rows sorted
    descending) to make arms maximally indistinguishable.
    """
    rng = np.random.default_rng(seed)
    means = rng.uniform(0, 1, size=n)
    ones = np.rint(means * N).astype(np.int64)
    R = np.zeros((n, N), dtype=np.float32)
    for i, k in enumerate(ones):  # sorted: 1s first = adversarial order
        R[i, :k] = 1.0
    return R


def mf_dataset(n: int, N: int, rank: int = 32, seed: int = 0,
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Matrix-factorization embedding proxy (Fig. 4 real-world stand-in).

    Low-rank structure with a heavy-tailed spectrum + noise, mimicking
    ALS/SGD item embeddings from recommender training.
    """
    rng = np.random.default_rng(seed)
    spectrum = 1.0 / np.sqrt(1 + np.arange(rank))
    U = rng.normal(size=(n, rank)) * spectrum
    Wd = rng.normal(size=(rank, N))
    V = (U @ Wd + 0.05 * rng.normal(size=(n, N))).astype(np.float32)
    u_q = rng.normal(size=rank) * spectrum
    q = (u_q @ Wd + 0.05 * rng.normal(size=N)).astype(np.float32)
    return V, q
