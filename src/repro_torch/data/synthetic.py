"""Deterministic MIPS datasets (from ``repro.data.synthetic``).

The generators reproduce the paper's experimental settings: gaussian,
uniform, the adversarial Bernoulli construction of Fig. 1, and a low-rank
matrix-factorization proxy for the Netflix/Yahoo embeddings of Fig. 4.
They are numpy, draw from ``numpy.random.default_rng(seed)`` in the JAX
package's order, and so return the JAX package's arrays bit for bit.
The LM token stream of that module comes with the model zoo.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["gaussian_dataset", "uniform_dataset", "adversarial_dataset",
           "mf_dataset"]


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
