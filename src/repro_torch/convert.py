"""Serving tables for the port: carried over from the JAX package's
parameters, or built from a numpy seed.

The JAX package serves the tied embedding (or the unembedding) of
``repro.models.model.init_params``: a ``(padded_vocab, d_model)`` table
whose rows past ``vocab`` are padding, masked by ``n_valid = vocab``.
`serving_table_from_jax` carries such parameters (as numpy arrays) into
the port; `make_serving_table` builds a table of the same shape and
distribution, N(0, 0.02), without the model zoo (torch cannot reproduce
``jax.random``, so its values differ from the JAX package's).
`quantized_from_jax` carries the JAX package's quantized table artifacts
(int8/int4 codes and scales, pq codes and codebook) into the port, for
``quantized=`` of `bounded_me_decode` and `CascadeExecutor`.
`store_from_jax` carries a JAX package store's page image
(``DynamicTableStore.page_state()``) into a port store.
"""

from __future__ import annotations

from typing import Mapping, Sequence, Tuple

from repro_torch.store import DynamicTableStore

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig

__all__ = ["serving_table_from_jax", "make_serving_table",
           "quantized_from_jax", "store_from_jax"]

#: init_params' embedding scale
_EMBED_STD = 0.02

#: (table artifact dtype, aux artifact dtype) of each quantized tier
_ARTIFACT_DTYPES = {"int8": (np.int8, np.float32),
                    "int4": (np.int8, np.float32),
                    "pq": (np.uint8, np.float32)}


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


def quantized_from_jax(artifacts_np: Sequence[np.ndarray], precision: str
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's table artifacts of a quantized tier, as tensors
    on the CPU: ``(V8, vscale)`` for int8, ``(P4, vscale)`` for int4,
    ``(codes, codebook)`` for pq — e.g. ``_quantize_table``'s output or a
    store's ``quantized()``, converted to numpy.  Layouts are shared, so
    nothing is re-laid; dtypes are checked, not cast."""
    if precision not in _ARTIFACT_DTYPES:
        raise ValueError(f"no quantized artifacts for precision "
                         f"{precision!r} (expected 'int8', 'int4' or 'pq')")
    Vq, vaux = (np.asarray(a) for a in artifacts_np)
    want = _ARTIFACT_DTYPES[precision]
    if (Vq.dtype, vaux.dtype) != want:
        raise TypeError(f"{precision} artifacts must be {want[0].__name__} "
                        f"and {want[1].__name__}, got {Vq.dtype} and "
                        f"{vaux.dtype}")
    if Vq.ndim != 4 or vaux.ndim != (4 if precision == "pq" else 2):
        raise ValueError(f"{precision} artifacts have shapes {Vq.shape} "
                         f"and {vaux.shape}")
    return torch.from_numpy(Vq.copy()), torch.from_numpy(vaux.copy())


#: page-image keys `store_from_jax` reads, and their scalar types
_PAGE_SCALARS = {"capacity_rows": int, "tile": int, "block": int,
                 "pq_subdims": int, "pq_codes": int, "dim": int,
                 "version": int, "value_abs_max": float, "next_id": int,
                 "precision": str}


def store_from_jax(state: Mapping, device="cuda") -> DynamicTableStore:
    """A port `DynamicTableStore` on ``device`` from the JAX package's
    store page image (``page_state()``, its arrays converted to numpy):
    the same rows, ids, geometry, frozen pq codebook, version,
    ``value_abs_max``, id allocator and staged mutations.  Dtypes and
    shapes are checked, not cast."""
    missing = ({"rows", "ids", "codebook", "staged"} | set(_PAGE_SCALARS)) \
        - set(state)
    if missing:
        raise ValueError(f"page image lacks {sorted(missing)}")
    for key, kind in _PAGE_SCALARS.items():
        if not isinstance(state[key], (kind, np.generic)) or isinstance(
                state[key], bool):
            raise TypeError(f"page image {key!r} must be {kind.__name__}, "
                            f"got {type(state[key]).__name__}")
    rows, ids = np.asarray(state["rows"]), np.asarray(state["ids"])
    N = int(state["dim"])
    if rows.dtype != np.float32 or rows.ndim != 2 or rows.shape[1] != N:
        raise TypeError(f"page rows must be float32 (n, {N}), got "
                        f"{rows.dtype} {rows.shape}")
    if ids.dtype != np.int64 or ids.shape != rows.shape[:1]:
        raise TypeError(f"page ids must be int64 ({rows.shape[0]},), got "
                        f"{ids.dtype} {ids.shape}")
    cb = state["codebook"]
    if (cb is None) != (state["precision"] != "pq"):
        raise ValueError(f"a {state['precision']} page image "
                         f"{'lacks' if cb is None else 'carries'} a codebook")
    if cb is not None:
        cb = np.asarray(cb)
        if cb.dtype != np.float32 or cb.ndim != 4:
            raise TypeError(f"page codebook must be float32 (n_blocks, S, "
                            f"n_codes, w), got {cb.dtype} {cb.shape}")
    staged = []
    for op, ext_id, row in state["staged"]:
        if op == "upsert":
            row = np.asarray(row)
            if row.dtype != np.float32 or row.shape != (N,):
                raise TypeError(f"staged upsert of id {ext_id}: row must "
                                f"be float32 ({N},), got {row.dtype} "
                                f"{row.shape}")
            row = row.copy()
        elif op != "delete":
            raise ValueError(f"unknown staged op {op!r}")
        staged.append((op, int(ext_id), row))
    return DynamicTableStore.from_page(
        dict(state, rows=rows, ids=ids, codebook=cb, staged=staged),
        device=device)
