"""Models and serving tables for the port: carried over from the JAX
package's parameters, or built from a numpy seed.

The JAX package serves the tied embedding (or the unembedding) of
``repro.models.model.init_params``: a ``(padded_vocab, d_model)`` table
in the model's type (bf16 at full width, f32 in smoke configs) whose rows
past ``vocab`` are padding, masked by ``n_valid = vocab``.
`serving_table_from_jax` carries such parameters (as numpy arrays) into
the port, and `params_from_jax` a whole model's parameter set, of any
family, into the `repro_torch.models.model.build_model` of its config;
`make_serving_table` builds a table of the same shape, type and
distribution, N(0, 0.02) rounded to the config's type, without the
model zoo (torch cannot reproduce ``jax.random``, so its values differ
from the JAX package's).
`quantized_from_jax` carries the JAX package's quantized table artifacts
(int8/int4 codes and scales, pq codes and codebook) into the port, for
``quantized=`` of `bounded_me_decode` and `CascadeExecutor`.
`store_from_jax` carries a JAX package store's page image
(``DynamicTableStore.page_state()``) into a port store.
`opt_state_from_jax` carries the JAX package's optimizer state into the
port's `repro_torch.optim.adamw.OptState`, with the moment and error
trees unstacked as `params_from_jax` unstacks the parameters; and
`to_jax_tree` carries the port's named tensors (a model's parameters,
its gradients, a moment) back into the JAX package's nested stacks, for
comparison.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.boundedme_torch import as_kept, resolve_device
from repro_torch.models.model import EMBED_STD, LM, build_model
from repro_torch.optim.adamw import OptState
from repro_torch.store import DynamicTableStore

__all__ = ["tensor_from_jax", "serving_table_from_jax", "make_serving_table",
           "params_from_jax", "quantized_from_jax", "store_from_jax",
           "opt_state_from_jax", "to_jax_tree"]

#: (table artifact dtype, aux artifact dtype) of each quantized tier
_ARTIFACT_DTYPES = {"int8": (np.int8, np.float32),
                    "int4": (np.int8, np.float32),
                    "pq": (np.uint8, np.float32)}


def tensor_from_jax(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor of a JAX array converted to numpy, in its own type: a
    bfloat16 array (numpy's ``ml_dtypes`` type) becomes a
    ``torch.bfloat16`` tensor of the same bits; any other is copied."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(a.copy())


def serving_table_from_jax(params_np: Mapping[str, np.ndarray],
                           cfg: ArchConfig) -> Tuple[torch.Tensor, int]:
    """``(table (padded_vocab, d_model) on the CPU, n_valid)`` from the
    JAX package's parameters, converted to numpy: float32 or bfloat16,
    as the parameters are (the JAX package serves a bf16 model's
    embedding in bf16); any other type is widened to float32."""
    name = "embed" if cfg.tie_embeddings else "unembed"
    table = as_kept(tensor_from_jax(params_np[name]), "cpu")
    if tuple(table.shape) != (cfg.padded_vocab, cfg.d_model):
        raise ValueError(f"params[{name!r}] has shape "
                         f"{tuple(table.shape)}, expected "
                         f"{(cfg.padded_vocab, cfg.d_model)}")
    return table, cfg.vocab


def make_serving_table(cfg: ArchConfig, seed: int = 0, device="cuda"
                       ) -> Tuple[torch.Tensor, int]:
    """``(table (padded_vocab, d_model) on device, n_valid)`` drawn
    N(0, 0.02) in float32 from ``numpy.random.default_rng(seed)``, then
    rounded to the config's type as ``init_params`` rounds its embedding:
    bfloat16 at full width, float32 in smoke configs."""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((cfg.padded_vocab, cfg.d_model),
                                dtype=np.float32)
    table *= np.float32(EMBED_STD)
    return (torch.from_numpy(table).to(device).to(getattr(torch, cfg.dtype)),
            cfg.vocab)


def _stacks(tree: Mapping) -> Iterator[Tuple[Tuple[str, ...], str,
                                             np.ndarray]]:
    """``(path, pattern, leaf)`` of each leaf of a JAX parameter-shaped
    tree: its keys, and the port's name with one ``{}`` per stack axis —
    the layer stacks ``layers`` / ``enc_layers`` one
    (``"layers.{}.wq"``), the hybrid ``periods`` a period axis, then the
    period's own stack but for ``attn`` (``"periods.{}.moe.{}.w_up"``);
    top-level arrays none."""
    for key, val in tree.items():
        if key in ("layers", "enc_layers"):
            for name, stack in val.items():
                yield (key, name), f"{key}.{{}}.{name}", stack
        elif key == "periods":
            for group, sub in val.items():
                inner = "" if group == "attn" else "{}."
                for name, stack in sub.items():
                    yield ((key, group, name),
                           f"periods.{{}}.{group}.{inner}{name}", stack)
        else:
            yield (key,), key, val


def _port_params(params_np: Mapping) -> Iterator[Tuple[str, torch.Tensor]]:
    """The JAX package's parameter tree under the port's names, each stack
    sliced over its stack axes (`_stacks`)."""
    for _, pattern, leaf in _stacks(params_np):
        stack = tensor_from_jax(leaf)
        lead = pattern.count("{}")
        for idx in np.ndindex(*stack.shape[:lead]):
            yield pattern.format(*idx), stack[idx].contiguous()


def to_jax_tree(tensors: Mapping[str, torch.Tensor], like: Mapping
                ) -> Dict:
    """The port's named tensors (``layers.3.wq`` ...) as the nested numpy
    tree of ``like`` (a JAX parameter-shaped tree: `_stacks`), each stack
    rebuilt from its slices; bfloat16 widened to float32."""
    out: Dict = {}
    for path, pattern, leaf in _stacks(like):
        lead = pattern.count("{}")
        shape = np.shape(leaf)
        slices = [tensors[pattern.format(*idx)].detach().cpu()
                  for idx in np.ndindex(*shape[:lead])]
        arr = torch.stack(slices).reshape(shape)
        if arr.dtype == torch.bfloat16:
            arr = arr.to(torch.float32)
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = arr.numpy()
    return out


def opt_state_from_jax(state_np, device="cuda") -> OptState:
    """The port's `OptState` on ``device`` from the JAX package's
    ``OptState`` (``step``, ``mu``, ``nu``, ``err``; arrays converted to
    numpy): each moment and error tree unstacked under the port's names
    as `params_from_jax` unstacks the parameters, in its own type (f32
    or bf16 moments): the card by default, the CPU when asked."""
    device = resolve_device(device)

    def tree(t):
        return None if t is None else {
            name: v.to(device) for name, v in _port_params(t)}
    return OptState(step=torch.tensor(int(np.asarray(state_np.step)),
                                      dtype=torch.int32, device=device),
                    mu=tree(state_np.mu), nu=tree(state_np.nu),
                    err=tree(state_np.err))


def params_from_jax(params_np: Mapping, cfg: ArchConfig, device="cuda"
                    ) -> LM:
    """The `build_model` of ``cfg`` on ``device`` holding the JAX
    package's parameters (``init_params(cfg, key)``, each array converted
    to numpy, as nested mappings): layer ``i`` takes slice ``i`` of each
    ``layers`` / ``enc_layers`` stack, and hybrid period ``i`` its slice
    of each ``periods`` stack (then slice ``j`` of the period's
    ``mamba``, ``moe``, ``mlp`` and ``norms`` stacks).  Every tensor keeps
    its type and value.  Missing, extra or misshapen parameters (a stack
    of another depth among them) raise."""
    model = build_model(cfg, device="meta")
    want = dict(model.named_parameters())
    got = dict(_port_params(params_np))
    if set(got) != set(want):
        raise ValueError(f"parameters differ: missing "
                         f"{sorted(set(want) - set(got))}, extra "
                         f"{sorted(set(got) - set(want))}")
    for name, t in got.items():
        if t.shape != want[name].shape or t.dtype != want[name].dtype:
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)}, the "
                             f"model has {want[name].dtype} "
                             f"{tuple(want[name].shape)}")
    model.load_state_dict(got, assign=True)
    return model.to(resolve_device(device))


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
