"""Fault-tolerant checkpoints: atomic npz shards, a manifest, keep-last-k
(``repro.checkpoint.checkpointer``).

The JAX package's layout on disk: ``step_%08d/shard_0.npz`` and
``meta.json``, written into ``step_%08d.tmp`` and renamed into place, so
a failure mid-write never corrupts the latest restore point; then
``manifest.json`` lists the steps kept.  A tree is nested mappings (and
named tuples, such as `repro_torch.optim.adamw.OptState`) of tensors,
under the port's names: ``{"params": model state, "opt": OptState}``
saves as ``params/layers.0.wq``, ``opt/step``, ``opt/mu/layers.0.wq``;
a None subtree (no error buffer) holds nothing.  Arrays are saved
device-agnostic, bf16 widened to f32 (npz has no bf16; the widening is
exact) and narrowed back on restore, and no mesh layout is recorded.

Elastic re-meshing, as in the JAX package's design: a DTensor leaf is
saved whole (``full_tensor()``, a gather over its mesh), so every rank
calls `save_checkpoint` and only rank 0 of the process group writes
the npz and the manifest, the others waiting at a barrier; a restore
places each array by the leaf of ``tree_like`` it fills, so a tree of
DTensors on another mesh (a (2, 2) save restored on (1, 2) or (1, 1))
gets the same values re-sharded, each rank cutting its shards from the
file itself.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from collections.abc import Mapping
from typing import Any, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed.sharding import is_dtensor

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "list_steps"]

_MANIFEST = "manifest.json"


def _leaves(tree: Any, prefix: str = ""
            ) -> Iterator[Tuple[str, torch.Tensor]]:
    """``(key, tensor)`` of every leaf of ``tree``, keys joining the
    mapping keys and named-tuple fields with ``/``."""
    if tree is None:
        return
    if isinstance(tree, tuple) and hasattr(tree, "_asdict"):
        tree = tree._asdict()
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def _rank() -> int:
    """This process's rank (0 without a process group)."""
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and \
        dist.is_initialized() else 0


def _barrier() -> None:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        dist.barrier()


def _as_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if is_dtensor(t):
        t = t.full_tensor()
    if hasattr(t, "reconcile"):   # ranks simulated in one process agree
        t = t.reconcile()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.cpu().numpy()


def save_checkpoint(ckpt_dir: str, step: int, tree: Any,
                    keep_last: int = 3) -> str:
    """Write ``tree`` as step ``step`` atomically; keep the last
    ``keep_last`` steps (all with 0).  Returns the step's directory.
    Under a process group every rank calls it (DTensor leaves gather),
    rank 0 writes."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    flat = {k: _as_numpy(v) for k, v in _leaves(tree)}
    if _rank() == 0:
        _write(ckpt_dir, final, step, flat, keep_last)
    _barrier()
    return final


def _write(ckpt_dir: str, final: str, step: int, flat: dict,
           keep_last: int) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "shard_0.npz"), **flat)
    meta = {"step": step, "time": time.time(), "n_arrays": len(flat),
            "bytes": int(sum(v.nbytes for v in flat.values()))}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                      # atomic commit
    _update_manifest(ckpt_dir, keep_last)


def _update_manifest(ckpt_dir: str, keep_last: int) -> None:
    steps = list_steps(ckpt_dir)
    for s in steps[:-keep_last] if keep_last > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
    with open(os.path.join(ckpt_dir, _MANIFEST), "w") as f:
        json.dump({"steps": list_steps(ckpt_dir)}, f)


def list_steps(ckpt_dir: str) -> List[int]:
    """The committed steps under ``ckpt_dir``, ascending (a ``.tmp``
    directory, or one without ``meta.json``, is not one)."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.endswith(".tmp") \
                and os.path.exists(os.path.join(ckpt_dir, d, "meta.json")):
            out.append(int(d.split("_")[1]))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = list_steps(ckpt_dir)
    return steps[-1] if steps else None


def _rebuild(tree: Any, prefix: str, data) -> Any:
    """``tree``'s structure with each leaf read from ``data`` at its key,
    in the leaf's type and on its device (a DTensor leaf: on its mesh, in
    its placements)."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_asdict"):
        return type(tree)(**{k: _rebuild(v, f"{prefix}{k}/", data)
                             for k, v in tree._asdict().items()})
    if isinstance(tree, Mapping):
        return {k: _rebuild(v, f"{prefix}{k}/", data)
                for k, v in tree.items()}
    key = prefix[:-1]
    arr = data[key]
    if arr.shape != tuple(tree.shape):
        raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} vs "
                         f"model {tuple(tree.shape)}")
    if is_dtensor(tree):
        from torch.distributed.tensor import distribute_tensor
        full = torch.from_numpy(arr).to(device=tree.to_local().device,
                                        dtype=tree.dtype)
        return distribute_tensor(full, tree.device_mesh, tree.placements,
                                 src_data_rank=None)
    return torch.from_numpy(arr).to(device=tree.device, dtype=tree.dtype)


def restore_checkpoint(ckpt_dir: str, tree_like: Any,
                       step: Optional[int] = None) -> Tuple[Any, int]:
    """``(tree, step)``: step ``step`` (default the latest) read into the
    structure of ``tree_like``, each tensor in the type and on the device
    (or mesh and placements) of ``tree_like``'s.  Raises
    FileNotFoundError without a checkpoint, KeyError on a missing key,
    ValueError on a shape mismatch."""
    if step is None:
        step = latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}", "shard_0.npz")
    with np.load(path) as data:
        missing = {k for k, _ in _leaves(tree_like)} - set(data.files)
        if missing:
            raise KeyError(f"checkpoint at step {step} missing keys: "
                           f"{sorted(missing)[:5]}...")
        return _rebuild(tree_like, "", data), step
