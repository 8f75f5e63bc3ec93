"""Public kernel entry points of the port.

Each entry point sends CUDA tensors to its hand-written kernel and CPU
tensors to the kernel's plain PyTorch version (`repro_torch.kernels.ref`),
by the device of the tensors it is given and nothing else: a CUDA tensor
never falls back to the plain version, and a failed build or launch
raises.  Every kernel counts its launches (`launch_counts`), which take
the place of the JAX package's ``count_pallas_calls``.

The entry points are generic in the feature-tile width ``C``: 'row' and
'coord' plans differ only in the geometry of the operands.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.fused_cascade import (fused_cascade_batched_cuda,
                                               launch_counts,
                                               reset_launch_counts)

__all__ = ["on_cuda", "fused_cascade_batched", "launch_counts",
           "reset_launch_counts"]


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on a CUDA device, False when every one
    lies on the CPU; raises on a mix or on any other device."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    devices = sorted(str(t.device) for t in tensors)
    raise ValueError(f"kernel operands must all be on CUDA or all on the "
                     f"CPU, got devices {devices}")


def fused_cascade_batched(V4: torch.Tensor, Qb: torch.Tensor,
                          slotcode: torch.Tensor, rounds_meta: torch.Tensor,
                          cols: torch.Tensor, *, n_arms: int, K: int,
                          t_final: int, n_final: int,
                          k_out: Optional[int] = None,
                          n_valid: Optional[int] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole BoundedME cascade of a query batch in one dispatch.

    ``V4 (n_tiles, n_blocks, R, C)`` float32 tile-major table, ``Qb (B,
    n_blocks, C)`` blocked queries, ``slotcode (S,)`` / ``rounds_meta
    (n_rounds + 1, 3)`` from `FlatSchedule.packed`, ``cols (B, S)`` the
    column block each step pulls (``perm[flat.bpos]``), all int32.
    ``k_out`` (default K) widens the final extraction, ``K <= k_out <=
    n_final * R``; rows ``>= n_valid`` (default ``n_arms``) never win a
    ranking.  Returns ``(ids (B, k_out) int32, vals (B, k_out) float32)``
    sorted by descending score, vals being unscaled block means; entries
    past the live rows carry ``-inf``.
    """
    kw = dict(n_arms=n_arms, K=K, t_final=t_final, n_final=n_final,
              k_out=k_out, n_valid=n_valid)
    if on_cuda(V4, Qb, slotcode, rounds_meta, cols):
        return fused_cascade_batched_cuda(V4, Qb, slotcode, rounds_meta,
                                          cols, **kw)
    return ref.fused_cascade_batched_ref(V4, Qb, slotcode, rounds_meta,
                                         cols, **kw)
