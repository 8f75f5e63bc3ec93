"""Serving tables for the port: carried over from the JAX package's
parameters, or built from a numpy seed.

The JAX package serves the tied embedding (or the unembedding) of
``repro.models.model.init_params``: a ``(padded_vocab, d_model)`` table
whose rows past ``vocab`` are padding, masked by ``n_valid = vocab``.
`serving_table_from_jax` carries such parameters (as numpy arrays) into
the port; `make_serving_table` builds a table of the same shape and
distribution, N(0, 0.02), without the model zoo (torch cannot reproduce
``jax.random``, so its values differ from the JAX package's).
"""

from __future__ import annotations

from typing import Mapping, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig

__all__ = ["serving_table_from_jax", "make_serving_table"]

#: init_params' embedding scale
_EMBED_STD = 0.02


def serving_table_from_jax(params_np: Mapping[str, np.ndarray],
                           cfg: ArchConfig) -> Tuple[torch.Tensor, int]:
    """``(table (padded_vocab, d_model) float32 on the CPU, n_valid)``
    from the JAX package's parameters, converted to numpy."""
    name = "embed" if cfg.tie_embeddings else "unembed"
    table = np.asarray(params_np[name], dtype=np.float32)
    if table.shape != (cfg.padded_vocab, cfg.d_model):
        raise ValueError(f"params[{name!r}] has shape {table.shape}, "
                         f"expected {(cfg.padded_vocab, cfg.d_model)}")
    return torch.from_numpy(table.copy()), cfg.vocab


def make_serving_table(cfg: ArchConfig, seed: int = 0, device="cuda"
                       ) -> Tuple[torch.Tensor, int]:
    """``(table (padded_vocab, d_model) float32 on device, n_valid)``
    drawn N(0, 0.02) from ``numpy.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((cfg.padded_vocab, cfg.d_model),
                                dtype=np.float32)
    table *= np.float32(_EMBED_STD)
    return torch.from_numpy(table).to(device), cfg.vocab
