"""The serving mesh of the port (``repro.launch.mesh``'s
``make_serving_mesh``).

The production and local training meshes wait for training (ROADMAP.md
queue 1 item 7).  Building a mesh touches no device state at import.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.boundedme_torch import resolve_device
from repro_torch.distributed.sharding import Mesh

__all__ = ["Mesh", "make_serving_mesh"]


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
    have = torch.cuda.device_count() if dev.type == "cuda" else 1
    n = have if model is None else min(int(model), have)
    if n <= 1:
        return None
    return Mesh([torch.device("cuda", i) for i in range(n)])
