"""The gathered tile-dot kernel: binding and wrapper.

Hand-written CUDA C++ in ``csrc/gather_dot.cu`` (it replaces
``gather_block_dot_pallas`` of the JAX package; its source note says what
bounds it and what its design does), built by
`repro_torch.kernels.library` at first use.  `gather_block_dot_cuda`
launches it on CUDA tensors and raises on anything else: one persistent
launch whose grid and ring geometry `repro_torch.kernels.stream` decides
(`launched_grid` reads back the grid a launch ran with), counted as
``gather_block_dot`` and as ``gather_block_dot[bulk]`` or ``[ldg]`` by
the branch it took;
`repro_torch.kernels.ops.gather_block_dot` chooses between it and the
plain PyTorch version by the tensors' device.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import library, stream

__all__ = ["build", "check_operands", "gather_block_dot_cuda",
           "launched_grid", "SOURCE"]

SOURCE = library.CSRC / "gather_dot.cu"

#: operand dtypes, in the CUDA entry's dtype-code order
DTYPES = (torch.float32, torch.bfloat16)

library.register(["gather_block_dot", "gather_block_dot[bulk]",
                  "gather_block_dot[ldg]"])

_GRID = library.GridWord()
#: the `stream.Stream` fields the C entry takes, in its order
GEOMETRY = ("bulk", "chunk", "rows", "stages", "stage_bytes", "group",
            "pairs", "info_off", "ring_off", "q_off", "part_off",
            "carry_off", "smem")


def build():
    """Compile the kernel unless this source is built: ``(library path,
    ptxas report)``."""
    return library.build(SOURCE)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = library.load(SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gather_block_dot.argtypes = ([i] + [p] * 6 + [i] * (7 + len(GEOMETRY))
                                     + [p])
    lib.gather_block_dot.restype = i
    lib.gather_block_dot_config.argtypes = [i] * 3 + [ctypes.POINTER(i)] * 2
    lib.gather_block_dot_config.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def occupancy(device: torch.device, dtype: int, bulk: bool,
              smem: int) -> Tuple[int, int]:
    """``(SMs, CTAs per SM)`` of a launch on ``device`` with this dtype
    code, branch and dynamic shared memory."""
    return library.occupancy(_lib(), "gather_block_dot_config", device, dtype,
                             int(bulk), smem)


@functools.lru_cache(maxsize=256)
def _plan(device: torch.device, code: int, T: int, R: int, C: int, elt: int,
          dt: int, misalign: int):
    """``(geometry, grid)`` of a launch, made once per shape;
    ``misalign`` is V4's address mod 16."""
    geo = stream.gather_stream(R, C, elt, dt, misalign)
    grid = stream.grid_ctas(geo.chunks(T),
                            *occupancy(device, code, geo.bulk, geo.smem))
    return geo, grid


def launched_grid(device) -> int:
    """The CTA count of the last launch on ``device``
    (`library.GridWord.read`)."""
    return _GRID.read(device)


def check_operands(V4: torch.Tensor, idx: torch.Tensor, cols: torch.Tensor,
                   qsel: torch.Tensor) -> None:
    """Raise on operands that neither the kernel nor its plain version
    takes: ``V4 (n_tiles, n_blocks, R, C)`` and ``qsel (dt, C)`` both
    float32 or both bfloat16, integer ``idx (T,)`` and ``cols (dt,)``."""
    if V4.dim() != 4:
        raise ValueError(f"V4 must be (n_tiles, n_blocks, R, C), got "
                         f"{tuple(V4.shape)}")
    if V4.dtype not in DTYPES or qsel.dtype != V4.dtype:
        raise TypeError(f"V4 and qsel must both be float32 or both "
                        f"bfloat16, got {V4.dtype} and {qsel.dtype}")
    for name, t in (("idx", idx), ("cols", cols)):
        if t.dim() != 1 or t.dtype.is_floating_point or t.dtype == torch.bool:
            raise TypeError(f"{name} must be a 1-d integer tensor, got "
                            f"{t.dtype} {tuple(t.shape)}")
    if tuple(qsel.shape) != (cols.shape[0], V4.shape[3]):
        raise ValueError(f"qsel shape {tuple(qsel.shape)} != (dt, C) = "
                         f"{(cols.shape[0], V4.shape[3])}")


def gather_block_dot_cuda(V4: torch.Tensor, idx: torch.Tensor,
                          cols: torch.Tensor, qsel: torch.Tensor
                          ) -> torch.Tensor:
    """``out[t] = sum_b V4[idx[t], cols[b]] @ qsel[b]`` on CUDA tensors:
    ``(T, R)`` float32, the blocks added in order b = 0 ... dt - 1.

    ``V4`` and ``qsel`` contiguous; ``idx`` and ``cols`` are taken as
    int32.  A tile or column index out of range gives NaN rows.
    """
    if not V4.is_cuda:
        raise ValueError(f"the CUDA kernel needs CUDA tensors, V4 is on "
                         f"{V4.device}")
    check_operands(V4, idx, cols, qsel)
    dev = V4.device
    for name, t in (("idx", idx), ("cols", cols), ("qsel", qsel)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, V4 on {dev}")
    if not (V4.is_contiguous() and qsel.is_contiguous()):
        raise ValueError("V4 and qsel must be contiguous")
    idx = idx.to(torch.int32).contiguous()
    cols = cols.to(torch.int32).contiguous()
    n_tiles, n_blocks, R, C = V4.shape
    T, dt = idx.shape[0], cols.shape[0]
    if T * max(dt, 1) >= 2 ** 31 or n_tiles * n_blocks >= 2 ** 31:
        raise ValueError(f"T * dt = {T * dt} gathered cells or "
                         f"{n_tiles * n_blocks} cells of V4 exceed the "
                         f"kernel's int32 indices")
    out = torch.empty((T, R), dtype=torch.float32, device=dev)
    if T == 0 or dt == 0:
        return out.zero_()          # an empty sum: nothing to launch
    code = DTYPES.index(V4.dtype)
    geo, grid = _plan(dev, code, T, R, C, V4.element_size(), dt,
                      V4.data_ptr() % 16)
    lib = _lib()
    with library.on_device(dev):
        library.require_current(dev)
        s = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.gather_block_dot(
            code, V4.data_ptr(), idx.data_ptr(), cols.data_ptr(),
            qsel.data_ptr(), out.data_ptr(), _GRID.on(dev).data_ptr(), T,
            grid, n_tiles, n_blocks, R, C, dt, *geo.ints(GEOMETRY), s)
    library.check_launch(lib, rc, "gather_block_dot")
    library.count("gather_block_dot", f"gather_block_dot[{geo.branch}]")
    return out
