"""The exact blocked matvec kernel: binding and wrapper.

Hand-written CUDA C++ in ``csrc/blocked_matvec.cu`` (it replaces
``blocked_matvec_pallas`` of the JAX package; its source note says what
bounds it and what its design does), built by
`repro_torch.kernels.library` at first use.  `blocked_matvec_cuda`
launches it on CUDA tensors and raises on anything else;
`repro_torch.kernels.ops.blocked_matvec` chooses between it and the plain
PyTorch version by the tensors' device.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import library

__all__ = ["build", "check_operands", "tiles", "blocked_matvec_cuda",
           "SOURCE"]

SOURCE = library.CSRC / "blocked_matvec.cu"

#: operand dtypes, in the CUDA entry's dtype-code order
DTYPES = (torch.float32, torch.bfloat16)

library.register(["blocked_matvec"])


def build():
    """Compile the kernel unless this source is built: ``(library path,
    ptxas report)``."""
    return library.build(SOURCE)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = library.load(SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.blocked_matvec.argtypes = [i] + [p] * 3 + [i] * 5 + [p]
    lib.blocked_matvec.restype = i
    return lib


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
    per16 = 16 // W.element_size()
    vec = int(d % per16 == 0 and tile_d % per16 == 0
              and W.data_ptr() % 16 == 0 and q.data_ptr() % 16 == 0)
    out = torch.empty((n,), dtype=torch.float32, device=W.device)
    lib = _lib()
    with torch.cuda.device(W.device):
        stream = torch.cuda.current_stream(W.device).cuda_stream
        rc = lib.blocked_matvec(DTYPES.index(W.dtype), W.data_ptr(),
                                q.data_ptr(), out.data_ptr(), n, d, tile_n,
                                tile_d, vec, stream)
    library.check_launch(lib, rc, "blocked_matvec")
    library.count("blocked_matvec")
    return out
