"""The gathered tile-dot kernel: binding and wrapper.

Hand-written CUDA C++ in ``csrc/gather_dot.cu`` (it replaces
``gather_block_dot_pallas`` of the JAX package; its source note says what
bounds it and what its design does), built by
`repro_torch.kernels.library` at first use.  `gather_block_dot_cuda`
launches it on CUDA tensors and raises on anything else;
`repro_torch.kernels.ops.gather_block_dot` chooses between it and the
plain PyTorch version by the tensors' device.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import library

__all__ = ["build", "check_operands", "gather_block_dot_cuda", "SOURCE"]

SOURCE = library.CSRC / "gather_dot.cu"

#: operand dtypes, in the CUDA entry's dtype-code order
DTYPES = (torch.float32, torch.bfloat16)

library.register(["gather_block_dot"])


def build():
    """Compile the kernel unless this source is built: ``(library path,
    ptxas report)``."""
    return library.build(SOURCE)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = library.load(SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gather_block_dot.argtypes = [i] + [p] * 5 + [i] * 7 + [p]
    lib.gather_block_dot.restype = i
    return lib


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
    per16 = 16 // V4.element_size()
    vec = int(C % per16 == 0 and V4.data_ptr() % 16 == 0
              and qsel.data_ptr() % 16 == 0)
    out = torch.empty((T, R), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.gather_block_dot(
            DTYPES.index(V4.dtype), V4.data_ptr(), idx.data_ptr(),
            cols.data_ptr(), qsel.data_ptr(), out.data_ptr(), n_tiles,
            n_blocks, R, C, T, dt, vec, stream)
    library.check_launch(lib, rc, "gather_block_dot")
    library.count("gather_block_dot")
    return out
