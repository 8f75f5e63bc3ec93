"""Partition specs of parameters, batches and caches, and the placement
of a served table over the serving mesh.

The PyTorch counterpart of ``repro.distributed.specs``.  `param_pspecs`,
`batch_pspecs`, `cache_pspecs`, `tree_pspecs` and `batch_axes` decide
the JAX package's specs by its name and shape rules, over the port's
names: the port keeps one tensor per layer (``layers.3.wq``,
``periods.0.moe.1.w_up``) where the JAX package stacks a leaf over the
layers for a scan, so a port tensor's spec is its JAX leaf's with the
leading stack entries dropped (one per layer index in the name, as
`repro_torch.optim.adamw.jax_rank` counts them).  2D "FSDP-style"
sharding (weights over both data and model) is applied with ``fsdp``.
Kv heads stay replicated; ``ep_ok`` (experts divide the model axis) and
``di_ok`` (the Mamba inner dim and heads do) decide as in JAX.

`place_params` and `place_tree` turn specs into DTensors on a
``DeviceMesh`` (`repro_torch.distributed.sharding.placements`).  Where
the JAX package needs a dimension to divide evenly (a jitted argument's
sharding), they raise; DTensor is never left to pad a shard.

`serving_table_sharding` places a served table: where the JAX package
returns a ``NamedSharding`` and ``device_put`` moves the table, the port
places the table itself, padded to ``shards * n_local`` rows, split into
row shards, and each shard laid out tile-major once on its device.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.boundedme_torch import BlockedPlan, tile_table
from repro_torch.distributed.sharding import (PartitionSpec as P,
                                              axis_sizes, is_dtensor,
                                              placements)

__all__ = ["param_pspecs", "batch_pspecs", "cache_pspecs", "tree_pspecs",
           "batch_axes", "place_params", "place_tree", "local_bytes",
           "serving_table_sharding"]


def batch_axes(mesh, global_batch: int):
    """('pod', 'data') filtered to the mesh, dropped if the batch does not
    divide; then 'data' alone (batch 16 on a (2, 16, 16) mesh); else
    None."""
    sizes = axis_sizes(mesh)
    axes = tuple(a for a in ("pod", "data") if a in sizes)
    size = int(np.prod([sizes[a] for a in axes])) if axes else 1
    if axes and global_batch % size == 0:
        return axes
    if "data" in sizes and global_batch % sizes["data"] == 0:
        return ("data",)
    return None


def _jax_param_spec(cfg: ArchConfig, key: str, r: int, ep_ok: bool,
                    di_ok: bool, fsdp_axis) -> tuple:
    """The JAX package's spec of the leaf at ``key`` (its path, ``/``
    joined) of rank ``r``, stack dims included."""
    name = key.split("/")[-1]
    lead = (None,) * (r - 2)
    is_expert = "moe" in key or (cfg.family == "moe" and name in (
        "w_gate", "w_up", "w_down", "router"))
    if name in ("embed", "unembed"):
        return ("model", fsdp_axis)
    if name == "enc_pos":
        return (None, None)
    if name.endswith("wq") or name == "bq":
        return (*lead, fsdp_axis, "model") if r >= 2 \
            else ((None,) * (r - 1) + ("model",))
    if name.endswith(("wk", "wv")) or name in ("bk", "bv"):
        return (*lead, fsdp_axis, None) if r >= 2 else (None,) * r
    if name.endswith("wo"):
        return (*lead, "model", fsdp_axis)
    if is_expert:
        lead3 = (None,) * (r - 3)
        if name == "router":
            return (*lead, None, None)
        if name in ("w_gate", "w_up"):        # (..., E, d, ff)
            return ((*lead3, "model", fsdp_axis, None) if ep_ok
                    else (*lead3, None, fsdp_axis, "model"))
        if name == "w_down":                  # (..., E, ff, d)
            return ((*lead3, "model", None, fsdp_axis) if ep_ok
                    else (*lead3, None, "model", fsdp_axis))
    if name in ("w_gate", "w_up"):            # dense mlp (..., d, ff)
        return (*lead, fsdp_axis, "model")
    if name == "w_down":                      # (..., ff, d)
        return (*lead, "model", fsdp_axis)
    if name == "b_up":
        return (None,) * (r - 1) + ("model",)
    if name in ("wz", "wx"):                  # mamba (..., d, di)
        return (*lead, fsdp_axis, "model" if di_ok else None)
    if name == "out_proj":                    # (..., di, d)
        return (*lead, "model" if di_ok else None, fsdp_axis)
    return (None,) * r


def _split_name(name: str):
    """``(JAX key, stack dims)`` of a port parameter name: the name
    without its layer indices, ``/`` joined, and how many there were."""
    parts = name.split(".")
    stack = sum(p.isdigit() for p in parts)
    return "/".join(p for p in parts if not p.isdigit()), stack


def param_pspecs(cfg: ArchConfig, params: Mapping[str, Any], mesh,
                 fsdp: bool = False) -> Dict[str, P]:
    """``{name: PartitionSpec}`` of a model's parameters (``dict(model.
    named_parameters())``, of any device, ``"meta"`` included): the JAX
    package's spec of each one's leaf, its stack entries dropped.

    With ``fsdp`` the stack entry the JAX rule gives a per-layer bias of
    the attention (``bq``, ``bk``, ``bv``: their JAX leaves are rank 2
    and are split over ``data`` on the layer axis) is dropped with it,
    so the port keeps those biases whole on ``data``.
    """
    sizes = axis_sizes(mesh)
    msize = sizes["model"]
    ep_ok = cfg.n_experts > 0 and cfg.n_experts % msize == 0
    di_ok = (cfg.ssm_heads > 0 and cfg.d_inner % msize == 0
             and cfg.ssm_heads % msize == 0)
    fsdp_axis = "data" if (fsdp and "data" in sizes) else None
    out = {}
    for name, t in params.items():
        key, stack = _split_name(name)
        spec = _jax_param_spec(cfg, key, t.dim() + stack, ep_ok, di_ok,
                               fsdp_axis)
        out[name] = P(*spec[stack:])
    return out


def batch_pspecs(mesh, global_batch: int, batch: Mapping[str, Any]
                 ) -> Dict[str, P]:
    """Each batch entry's leading dim on `batch_axes`, the rest
    replicated."""
    axes = batch_axes(mesh, global_batch)
    return {k: P(axes, *(None,) * (v.dim() - 1)) for k, v in batch.items()}


def _jax_cache_spec(key: str, r: int, baxes, kvseq) -> tuple:
    if key in ("k", "v"):       # (L, B, S, KV, D) / (periods, B, S, KV, D)
        return (*(None,) * (r - 4), baxes, kvseq, None, None)
    if key in ("ck", "cv"):     # (L, B, S_enc, H, D)
        return (*(None,) * (r - 4), baxes, None, "model", None)
    if key == "h":              # (L, B, H, Sd, P) / (periods, nm, B, ...)
        b_at = 1 if r == 5 else 2
        return (*(None,) * b_at, baxes, *(None,) * (r - b_at - 1))
    return (None,) * r


def cache_pspecs(mesh, global_batch: int, caches: List[Mapping[str, Any]],
                 seq_axes=None) -> List[Dict[str, P]]:
    """The caches' specs, one dict per layer (per hybrid period) as the
    port keeps them: batch on `batch_axes`, the KV sequence on
    ``seq_axes`` (default 'model'), the cross K/V heads on 'model'; the
    JAX stacked leaf's spec with its layer entry dropped."""
    baxes = batch_axes(mesh, global_batch)
    kvseq = seq_axes if seq_axes is not None else (
        "model" if "model" in axis_sizes(mesh) else None)
    return [{k: P(*_jax_cache_spec(k, v.dim() + 1, baxes, kvseq)[1:])
             for k, v in layer.items()} for layer in caches]


def tree_pspecs(tree) -> Any:
    """Replicated specs for every tensor of a tree (mappings, lists;
    scalars, schedules, rng)."""
    if isinstance(tree, Mapping):
        return {k: tree_pspecs(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_pspecs(v) for v in tree)
    return P(*(None,) * getattr(tree, "ndim", 0))


def _check_divides(name: str, shape, spec, mesh) -> None:
    sizes = axis_sizes(mesh)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else entry
        n = int(np.prod([sizes[a] for a in axes]))
        if shape[d] % n:
            raise ValueError(f"{name}: dimension {d} of {tuple(shape)} does "
                             f"not divide over {axes} ({n})")


def place_tree(tree: Mapping[str, torch.Tensor], specs: Mapping[str, P],
               mesh) -> Dict[str, torch.Tensor]:
    """Each tensor of ``tree`` as a DTensor on ``mesh`` by its spec, each
    rank cutting its shards from its own copy, with no collective (every
    rank holds the same: the seeded weights, a checkpoint, the stream's
    batch); raises where a sharded dimension does not divide."""
    from torch.distributed.tensor import distribute_tensor
    out = {}
    for name, t in tree.items():
        _check_divides(name, t.shape, specs[name], mesh)
        out[name] = distribute_tensor(t, mesh, placements(mesh, specs[name]),
                                      src_data_rank=None)
    return out


@torch.no_grad()
def place_params(model: torch.nn.Module, specs: Mapping[str, P], mesh
                 ) -> torch.nn.Module:
    """Replace each parameter of ``model`` by a DTensor parameter placed
    by ``specs`` (`param_pspecs`) on ``mesh``, in place; the parameters
    keep their ``requires_grad``."""
    for mod_name, mod in model.named_modules():
        for n, p in list(mod.named_parameters(recurse=False)):
            name = f"{mod_name}.{n}" if mod_name else n
            t = place_tree({name: p.detach()}, specs, mesh)[name]
            setattr(mod, n, torch.nn.Parameter(
                t, requires_grad=p.requires_grad))
    return model


def local_bytes(tensors) -> int:
    """The bytes one rank holds of ``tensors`` (an iterable of tensors
    and DTensors): a DTensor counts its local shard, of rank 0's size on
    an even split."""
    n = 0
    for t in tensors:
        if is_dtensor(t):
            shape = list(t.shape)
            for mdim, pl in enumerate(t.placements):
                if pl.is_shard():
                    shape[pl.dim] = -(-shape[pl.dim]
                                      // t.device_mesh.size(mdim))
            n += int(np.prod(shape)) * t.element_size()
        else:
            n += t.numel() * t.element_size()
    return n


def serving_table_sharding(table, mesh, plan: BlockedPlan
                           ) -> List[torch.Tensor]:
    """The row shards of an (n, N) table, one per mesh device.

    ``plan`` is the shard plan (`repro_torch.distributed.sharding.
    make_shard_plan`): shard s holds rows ``[s * plan.n, (s + 1) *
    plan.n)``, zero rows past n, laid out by `tile_table` on
    ``mesh.devices[s]`` in the table's own type (float32 or bfloat16).
    Only one shard's rows are in flight at a time, so no device ever
    holds the whole table twice.
    """
    table = torch.as_tensor(table)
    n, N = table.shape
    S = len(mesh.devices)
    n_local = plan.n
    if plan.N != N or S * n_local < n:
        raise ValueError(f"plan of {n_local} rows x {plan.N} cannot shard a "
                         f"({n}, {N}) table {S} ways")
    out = []
    for s, dev in enumerate(mesh.devices):
        rows = table[s * n_local:min(n, (s + 1) * n_local)]
        if rows.shape[0] < n_local:           # ragged: pad the last shards
            rows = torch.nn.functional.pad(
                rows.to(dev), (0, 0, 0, n_local - rows.shape[0]))
        out.append(tile_table(rows, plan, dev))
    return out
