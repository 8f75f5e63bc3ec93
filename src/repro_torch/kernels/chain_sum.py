"""The chain-sum kernel: its passes, binding and wrapper.

Hand-written CUDA C++ in ``csrc/chain_sum.cu``.  It replaces no TPU
kernel: it is the port's counterpart of the bf16 ``reduce`` that the JAX
package's program asks for where it transposes the broadcast of a 16-bit
bias (its source note says what bounds it and what its design does).
Built by `repro_torch.kernels.library` at first use.  `chain_sum_cuda`
launches it on CUDA tensors and raises on anything else, one launch per
pass of `passes`, each counted as ``chain_sum``;
`repro_torch.kernels.ops.chain_sum` chooses between it and the plain
PyTorch version (`repro_torch.kernels.ref.chain_sum_ref`) by the
tensor's device.

The order of the adds is XLA's CPU reduce, as measured against the JAX
package's jitted 16-bit ``reduce`` (``tests/test_torch_chain_sum.py``):
one chain over the leading dimensions in row-major order where none of
them exceeds `WINDOW`; otherwise XLA's tree reduction, windows of
`WINDOW` along each longer dimension (the whole of a shorter one),
padded with zeros split low and high, each window summed as a chain,
and the same again over the grid of window sums (`passes`).  That is
XLA's bf16 order.  It takes bf16 only: XLA's CPU f16 windows (not run
through f32 converts) depart from this order past `WINDOW`, and no
model of the repository trains in f16.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence, Tuple

import torch

from repro_torch.kernels import library

__all__ = ["build", "check_operand", "chain_sum_cuda", "passes", "Pass",
           "SOURCE", "WINDOW", "MAX_LEAD"]

SOURCE = library.CSRC / "chain_sum.cu"

#: the window of XLA's CPU tree reduction along one reduced dimension
WINDOW = 32
#: the most leading dimensions a sum runs over
MAX_LEAD = 4

library.register(["chain_sum"])


class Pass(NamedTuple):
    """One pass over a grid ``G`` of leading indices: windows of extent
    ``w`` with ``pad`` zeros below each dimension, ``n`` windows along
    each; its sums form the next pass's grid ``n``."""
    G: Tuple[int, ...]
    w: Tuple[int, ...]
    pad: Tuple[int, ...]
    n: Tuple[int, ...]


def passes(lead: Sequence[int]) -> Tuple[Pass, ...]:
    """The passes of XLA's CPU order over leading dimensions ``lead``:
    windows of `WINDOW` while any dimension exceeds it, then one window
    over the whole grid."""
    G, out = tuple(int(d) for d in lead), []
    while any(d > WINDOW for d in G):
        w = tuple(min(d, WINDOW) for d in G)
        extra = tuple((-d) % WINDOW if d > WINDOW else 0 for d in G)
        n = tuple((d + e) // ww for d, e, ww in zip(G, extra, w))
        out.append(Pass(G, w, tuple(e // 2 for e in extra), n))
        G = n
    out.append(Pass(G, G, (0,) * len(G), (1,) * len(G)))
    return tuple(out)


def build():
    """Compile the kernel unless this source is built: ``(library path,
    ptxas report)``."""
    return library.build(SOURCE)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = library.load(SOURCE)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.chain_sum.argtypes = [p, p, i, ctypes.POINTER(ll), ll, p]
    lib.chain_sum.restype = i
    return lib


def check_operand(g: torch.Tensor) -> None:
    """Raise on an operand that neither the kernel nor its plain version
    takes: ``g (d_0, ..., d_{k-1}, W)``, ``1 <= k <= MAX_LEAD``,
    bfloat16."""
    if not 2 <= g.dim() <= MAX_LEAD + 1:
        raise ValueError(f"g must be (d_0, ..., d_k-1, W) with 1 <= k <= "
                         f"{MAX_LEAD}, got {tuple(g.shape)}")
    if g.dtype != torch.bfloat16:
        raise TypeError(f"g must be bfloat16, got {g.dtype}")


def chain_sum_cuda(g: torch.Tensor) -> torch.Tensor:
    """A contiguous CUDA ``g (d_0, ..., d_{k-1}, W)`` summed over its
    leading dimensions in bf16, in `passes`' order, one
    rounding per add: ``(W,)``."""
    if not g.is_cuda:
        raise ValueError(f"the CUDA kernel needs a CUDA tensor, g is on "
                         f"{g.device}")
    check_operand(g)
    if not g.is_contiguous():
        raise ValueError("g must be contiguous")
    W, k = g.shape[-1], g.dim() - 1
    if W == 0:
        return g.new_empty((0,))
    lib, dev = _lib(), g.device
    x = g
    with library.on_device(dev):
        for ps in passes(g.shape[:-1]):
            out = torch.empty((*ps.n, W), dtype=g.dtype, device=dev)
            geo = (ctypes.c_longlong * (4 * k))(*ps.G, *ps.w, *ps.pad,
                                                *ps.n)
            library.require_current(dev)
            s = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.chain_sum(x.data_ptr(), out.data_ptr(), k, geo, W, s)
            library.check_launch(lib, rc, "chain_sum")
            library.count("chain_sum")
            x = out
    return x.reshape(W)
