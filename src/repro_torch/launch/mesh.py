"""The meshes of the port (``repro.launch.mesh``): the serving mesh
(``make_serving_mesh``) and the local training mesh's shape
(``make_local_mesh``).

The production mesh waits for multi-card training (ROADMAP.md queue 1
item 7).  Building a mesh touches no device state at import.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.boundedme_torch import resolve_device
from repro_torch.distributed.sharding import Mesh

__all__ = ["Mesh", "make_local_mesh", "make_serving_mesh"]


def _devices(dev: torch.device) -> int:
    """The devices of ``dev``'s kind there are: the cards, or one CPU."""
    return torch.cuda.device_count() if dev.type == "cuda" else 1


def make_local_mesh(data: int = 1, model: int = 1, device="cuda"
                    ) -> Tuple[int, int]:
    """The ``(data, model)`` shape of a small training mesh over the
    devices there are, clamped as the JAX package clamps it: ``data`` at
    most the device count, ``model`` at least 1 and at most what ``data``
    leaves.  On one card or the CPU it is ``(1, 1)``."""
    n = _devices(resolve_device(device))
    data = min(data, n)
    model = max(1, min(model, n // data))
    return data, model


def make_serving_mesh(model: Optional[int] = None,
                      device="cuda") -> Optional[Mesh]:
    """A one-axis ``("model",)`` `Mesh` for sharded serving, or None.

    As in the JAX package: ``model`` shards (default every card there is)
    capped at the cards there are, and None on one — callers then serve
    unsharded.  On the CPU there is one device, so the answer is None; a
    mesh that repeats a device (the tests' CPU meshes, one card holding
    several shards) is built with `Mesh` directly.
    """
    dev = resolve_device(device)
    have = _devices(dev)
    n = have if model is None else min(int(model), have)
    if n <= 1:
        return None
    return Mesh([torch.device("cuda", i) for i in range(n)])
