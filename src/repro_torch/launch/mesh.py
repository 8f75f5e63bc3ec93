"""The meshes of the port (``repro.launch.mesh``).

* The serving mesh (`make_serving_mesh`): the one-axis ``("model",)``
  `repro_torch.distributed.sharding.Mesh`, a list of cards one process
  drives (sharded serving, the vocab-sharded decode head).
* The training meshes (`make_local_mesh`, `make_production_mesh`): a
  ``torch.distributed.device_mesh.DeviceMesh`` with the JAX mesh's axis
  names, ``("data", "model")`` or ``("pod", "data", "model")``, over the
  ranks of the default process group: one rank per card under
  ``torchrun`` (NCCL; ``gloo`` on the CPU), a ``fake`` group in the dry
  run, or ranks simulated in one process under
  ``torch.distributed._local_tensor.LocalTensorMode`` (the counterpart of
  XLA's forced host device count).  Both need the group to be of the
  mesh's size.

Importing this module touches no device and no process group.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core.boundedme_torch import resolve_device
from repro_torch.distributed.sharding import Mesh

__all__ = ["Mesh", "local_mesh_shape", "make_local_mesh",
           "make_production_mesh", "make_serving_mesh", "simulated_mesh"]


def _devices(dev: torch.device) -> int:
    """The devices of ``dev``'s kind there are: the cards, or one CPU."""
    return torch.cuda.device_count() if dev.type == "cuda" else 1


def _ranks() -> int:
    """The ranks of the default process group (1 without one)."""
    dist = torch.distributed
    return dist.get_world_size() if dist.is_available() and \
        dist.is_initialized() else 1


def local_mesh_shape(data: int = 1, model: int = 1) -> Tuple[int, int]:
    """The ``(data, model)`` shape of a small training mesh over the ranks
    there are, clamped as the JAX package clamps its local mesh: ``data``
    at most the rank count, ``model`` at least 1 and at most what
    ``data`` leaves.  Without a process group there is one rank, and the
    shape is ``(1, 1)``."""
    n = _ranks()
    data = min(data, n)
    model = max(1, min(model, n // data))
    return data, model


def _device_mesh(device, shape, names):
    from torch.distributed.device_mesh import init_device_mesh
    n = 1
    for s in shape:
        n *= s
    if _ranks() != n:
        raise RuntimeError(
            f"a {shape} mesh needs a process group of {n} ranks, have "
            f"{_ranks()}: run under torchrun, a fake group or LocalTensorMode")
    dev = torch.device(device)
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=names)


def make_local_mesh(data: int = 1, model: int = 1, device="cuda"):
    """A ``("data", "model")`` ``DeviceMesh`` of `local_mesh_shape` over
    the ranks of the default process group on ``device``'s kind (the
    card unless the caller asks for the CPU); raises where the clamped
    mesh does not cover every rank."""
    dev = resolve_device(device)
    return _device_mesh(dev, local_mesh_shape(data, model),
                        ("data", "model"))


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The (16, 16) ``("data", "model")`` single-pod mesh, or the (2, 16,
    16) ``("pod", "data", "model")`` one, over a process group of 256 or
    512 ranks (the dry run's ``fake`` group: ``device`` is then only the
    kind its tensors claim, and no card is touched)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _device_mesh(device, shape, axes)


@contextlib.contextmanager
def simulated_mesh(shape: Sequence[int] = (1, 1),
                   names: Sequence[str] = ("data", "model"), device="cuda"):
    """A ``DeviceMesh`` of ``shape`` whose ranks are simulated in this
    process, for the duration: a ``fake`` default process group of the
    mesh's size and ``LocalTensorMode``, under which every op runs once
    for each rank, on ``device`` (all ranks' local tensors on the one
    card, or on the CPU), and every collective is carried out exactly
    between them.  The counterpart of XLA's forced host device count;
    raises if a process group is already up."""
    import torch.distributed as dist
    from torch.distributed._local_tensor import LocalTensorMode
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dev = resolve_device(device)
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    n = 1
    for s in shape:
        n *= s
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    try:
        with LocalTensorMode(n):
            yield _device_mesh(dev, tuple(shape), tuple(names))
    finally:
        dist.destroy_process_group()


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
