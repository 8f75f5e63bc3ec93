"""The exact blocked matvec kernel: binding and wrapper.

Hand-written CUDA C++ in ``csrc/blocked_matvec.cu`` (it replaces
``blocked_matvec_pallas`` of the JAX package; its source note says what
bounds it and what its design does), built by
`repro_torch.kernels.library` at first use.  `blocked_matvec_cuda`
launches it on CUDA tensors and raises on anything else: one persistent
launch whose grid and ring geometry `repro_torch.kernels.stream` decides
(`launched_grid` reads back the grid a launch ran with), counted as
``blocked_matvec`` and as ``blocked_matvec[bulk]`` or ``[ldg]`` by the
branch it took;
`repro_torch.kernels.ops.blocked_matvec` chooses between it and the plain
PyTorch version by the tensors' device.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import library, stream

__all__ = ["build", "check_operands", "tiles", "blocked_matvec_cuda",
           "launched_grid", "SOURCE"]

SOURCE = library.CSRC / "blocked_matvec.cu"

#: operand dtypes, in the CUDA entry's dtype-code order
DTYPES = (torch.float32, torch.bfloat16)

library.register(["blocked_matvec", "blocked_matvec[bulk]",
                  "blocked_matvec[ldg]"])

_GRID = library.GridWord()
#: the `stream.Stream` fields the C entry takes, in its order
GEOMETRY = ("bulk", "rows", "slabs", "stages", "stage_bytes", "group",
            "pairs", "info_off", "ring_off", "q_off", "part_off", "smem")


def build():
    """Compile the kernel unless this source is built: ``(library path,
    ptxas report)``."""
    return library.build(SOURCE)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = library.load(SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.blocked_matvec.argtypes = ([i] + [p] * 4 + [i] * (4 + len(GEOMETRY))
                                   + [p])
    lib.blocked_matvec.restype = i
    lib.blocked_matvec_config.argtypes = [i] * 3 + [ctypes.POINTER(i)] * 2
    lib.blocked_matvec_config.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def occupancy(device: torch.device, dtype: int, bulk: bool,
              smem: int) -> Tuple[int, int]:
    """``(SMs, CTAs per SM)`` of a launch on ``device`` with this dtype
    code, branch and dynamic shared memory."""
    return library.occupancy(_lib(), "blocked_matvec_config", device, dtype,
                             int(bulk), smem)


@functools.lru_cache(maxsize=256)
def _plan(device: torch.device, code: int, n: int, d: int, tile_d: int,
          elt: int, misalign: int):
    """``(geometry, grid)`` of a launch, made once per shape;
    ``misalign`` is W's address mod 16."""
    geo = stream.matvec_stream(d, tile_d, elt, misalign)
    grid = stream.grid_ctas(geo.chunks(n),
                            *occupancy(device, code, geo.bulk, geo.smem))
    return geo, grid


def launched_grid(device) -> int:
    """The CTA count of the last launch on ``device``
    (`library.GridWord.read`)."""
    return _GRID.read(device)


def tiles(n: int, d: int, tile_n: int, tile_d: int) -> Tuple[int, int]:
    """The tiles clamped to the shape; raises ``ValueError`` where they do
    not divide it, exactly where ``blocked_matvec_pallas`` does."""
    tile_n, tile_d = min(tile_n, n), min(tile_d, d)
    if n % tile_n or d % tile_d:
        raise ValueError(f"(n={n}, d={d}) not divisible by tiles "
                         f"({tile_n}, {tile_d}); pad upstream")
    return tile_n, tile_d


def check_operands(W: torch.Tensor, q: torch.Tensor) -> None:
    """Raise on operands that neither the kernel nor its plain version
    takes: ``W (n, d)`` and ``q (d,)``, both float32 or both bfloat16."""
    if W.dim() != 2 or q.dim() != 1 or q.shape[0] != W.shape[1]:
        raise ValueError(f"W must be (n, d) and q (d,), got "
                         f"{tuple(W.shape)} and {tuple(q.shape)}")
    if W.dtype not in DTYPES or q.dtype != W.dtype:
        raise TypeError(f"W and q must both be float32 or both bfloat16, "
                        f"got {W.dtype} and {q.dtype}")


def blocked_matvec_cuda(W: torch.Tensor, q: torch.Tensor, *,
                        tile_n: int = 256, tile_d: int = 512
                        ) -> torch.Tensor:
    """Exact ``W @ q`` on CUDA tensors: ``(n,)`` float32, each row's sum
    taken over the ``d / tile_d`` slabs in order.  Raises before any
    launch on shapes the tiles do not divide."""
    if not W.is_cuda:
        raise ValueError(f"the CUDA kernel needs CUDA tensors, W is on "
                         f"{W.device}")
    check_operands(W, q)
    n, d = W.shape
    tile_n, tile_d = tiles(n, d, tile_n, tile_d)
    if q.device != W.device:
        raise ValueError(f"q is on {q.device}, W on {W.device}")
    if not (W.is_contiguous() and q.is_contiguous()):
        raise ValueError("W and q must be contiguous")
    out = torch.empty((n,), dtype=torch.float32, device=W.device)
    if n == 0:
        return out
    dev, code = W.device, DTYPES.index(W.dtype)
    geo, grid = _plan(dev, code, n, d, tile_d, W.element_size(),
                      W.data_ptr() % 16)
    lib = _lib()
    with library.on_device(dev):
        library.require_current(dev)
        s = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.blocked_matvec(code, W.data_ptr(), q.data_ptr(),
                                out.data_ptr(), _GRID.on(dev).data_ptr(), n,
                                grid, d, tile_d, *geo.ints(GEOMETRY), s)
    library.check_launch(lib, rc, "blocked_matvec")
    library.count("blocked_matvec", f"blocked_matvec[{geo.branch}]")
    return out
