"""Public kernel entry points of the port.

Each entry point sends CUDA tensors to its hand-written kernel and CPU
tensors to the kernel's plain PyTorch version (`repro_torch.kernels.ref`),
by the device of the tensors it is given and nothing else: a CUDA tensor
never falls back to the plain version, and a failed build or launch
raises.  Every kernel counts its launches (`launch_counts`), which take
the place of the JAX package's ``count_pallas_calls``.

The entry points are generic in the feature-tile width ``C``: 'row' and
'coord' plans differ only in the geometry of the operands.  The launch
counts also break the fused cascade down by entry and tier
(``fused_cascade[int8]``, ``fused_cascade_batched[pq+adaptive]``).

The fused cascade (kernel 1) is reached through two registered
operators, ``torch.ops.repro_torch.fused_cascade_batched`` and
``torch.ops.repro_torch.fused_cascade``: their CUDA implementation is
the ``ctypes`` launch (`repro_torch.kernels.fused_cascade`), their CPU
implementation the plain version, and a fake implementation gives the
outputs' shapes and types.  The dispatcher then carries the kernel
through what wraps a tensor: ``local_map`` hands it each rank's shard,
``LocalTensorMode`` runs it once per simulated rank on that rank's local
tensors, and ``FakeTensorMode`` (the dry run) takes the fake
implementation, where the ``ctypes`` call itself could reach none of
them.  Each operator returns a list: ``[ids, vals]``, and
``rounds_used`` third where ``cert`` turns early exit on.  The chain
sum (``torch.ops.repro_torch.chain_sum``, the backward of a bf16
bias) is registered the same way, so that the dry run traces a train
step through it.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
from torch import Tensor

from repro_torch.kernels import ref
from repro_torch.kernels.blocked_matvec import blocked_matvec_cuda
from repro_torch.kernels.chain_sum import chain_sum_cuda, check_operand
from repro_torch.kernels.fused_cascade import (fused_cascade_batched_cuda,
                                               fused_cascade_cuda)
from repro_torch.kernels.gather_dot import gather_block_dot_cuda
from repro_torch.kernels.library import launch_counts, reset_launch_counts

__all__ = ["on_cuda", "gather_block_dot", "fused_cascade",
           "fused_cascade_batched", "blocked_matvec", "chain_sum",
           "launch_counts",
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


def gather_block_dot(V4: torch.Tensor, idx: torch.Tensor,
                     cols: torch.Tensor, qsel: torch.Tensor) -> torch.Tensor:
    """The per-round BoundedME pull step of the unfused path:
    ``out[t] = sum_b V4[idx[t], cols[b]] @ qsel[b]``.

    ``V4 (n_tiles, n_blocks, R, C)`` and ``qsel (dt, C)`` both float32 or
    both bfloat16, integer ``idx (T,)`` and ``cols (dt,)`` (indices may
    repeat).  Returns ``(T, R)`` float32, the blocks added in order.
    Both routes give NaN for row t when ``idx[t]`` is outside ``[0,
    n_tiles)``, and for every row when a ``cols`` entry is outside ``[0,
    n_blocks)``; the JAX package's interpret mode clamps such indices,
    and on the TPU its result is undefined.
    """
    if on_cuda(V4, idx, cols, qsel):
        return gather_block_dot_cuda(V4, idx, cols, qsel)
    return ref.gather_block_dot_ref(V4, idx, cols, qsel)


# ---- kernel 1 as registered operators ---------------------------------------
# The scalar arguments come last and resolved (``k_out`` and ``n_valid``
# as ints): under ``LocalTensorMode`` an int may differ per simulated rank
# (each rank's live count), and the dispatcher hands each rank its own.


def _kwargs(n_arms, K, t_final, n_final, k_out, n_valid, vscale, qscale,
            codebook, packed_int4, cert, k_cert, track_var) -> dict:
    return dict(n_arms=n_arms, K=K, t_final=t_final, n_final=n_final,
                k_out=k_out, n_valid=n_valid, vscale=vscale, qscale=qscale,
                codebook=codebook, packed_int4=packed_int4, cert=cert,
                k_cert=k_cert, track_var=track_var)


@torch.library.custom_op("repro_torch::fused_cascade_batched",
                         mutates_args=(), device_types="cpu")
def _cascade_batched_op(V4: Tensor, Qb: Tensor, slotcode: Tensor,
                        rounds_meta: Tensor, cols: Tensor,
                        vscale: Optional[Tensor], qscale: Optional[Tensor],
                        codebook: Optional[Tensor], cert: Optional[Tensor],
                        n_arms: int, K: int, t_final: int, n_final: int,
                        k_out: int, n_valid: int, packed_int4: bool,
                        k_cert: int, track_var: bool) -> List[Tensor]:
    """The plain version (`ref.fused_cascade_batched_ref`)."""
    return list(ref.fused_cascade_batched_ref(
        V4, Qb, slotcode, rounds_meta, cols, **_kwargs(
            n_arms, K, t_final, n_final, k_out, n_valid, vscale, qscale,
            codebook, packed_int4, cert, k_cert, track_var)))


@_cascade_batched_op.register_kernel("cuda")
def _cascade_batched_cuda(V4, Qb, slotcode, rounds_meta, cols, vscale,
                          qscale, codebook, cert, n_arms, K, t_final,
                          n_final, k_out, n_valid, packed_int4, k_cert,
                          track_var):
    """The CUDA kernel's launch (`fused_cascade_batched_cuda`, looked up
    here at each call)."""
    return list(fused_cascade_batched_cuda(
        V4, Qb, slotcode, rounds_meta, cols, **_kwargs(
            n_arms, K, t_final, n_final, k_out, n_valid, vscale, qscale,
            codebook, packed_int4, cert, k_cert, track_var)))


@_cascade_batched_op.register_fake
def _cascade_batched_fake(V4, Qb, slotcode, rounds_meta, cols, vscale,
                          qscale, codebook, cert, n_arms, K, t_final,
                          n_final, k_out, n_valid, packed_int4, k_cert,
                          track_var):
    B = cols.shape[0]
    out = [V4.new_empty((B, k_out), dtype=torch.int32),
           V4.new_empty((B, k_out), dtype=torch.float32)]
    if cert is not None:
        out.append(V4.new_empty((B,), dtype=torch.int32))
    return out


@torch.library.custom_op("repro_torch::fused_cascade", mutates_args=(),
                         device_types="cpu")
def _cascade_op(V4: Tensor, qb: Tensor, slotcode: Tensor,
                rounds_meta: Tensor, cols: Tensor, vscale: Optional[Tensor],
                qscale: Optional[Tensor], codebook: Optional[Tensor],
                cert: Optional[Tensor], n_arms: int, K: int, t_final: int,
                n_final: int, k_out: int, n_valid: int, packed_int4: bool,
                k_cert: int, track_var: bool) -> List[Tensor]:
    """The plain version (`ref.fused_cascade_ref`)."""
    return list(ref.fused_cascade_ref(
        V4, qb, slotcode, rounds_meta, cols, **_kwargs(
            n_arms, K, t_final, n_final, k_out, n_valid, vscale, qscale,
            codebook, packed_int4, cert, k_cert, track_var)))


@_cascade_op.register_kernel("cuda")
def _cascade_cuda(V4, qb, slotcode, rounds_meta, cols, vscale, qscale,
                  codebook, cert, n_arms, K, t_final, n_final, k_out,
                  n_valid, packed_int4, k_cert, track_var):
    """The CUDA kernel's launch (`fused_cascade_cuda`)."""
    return list(fused_cascade_cuda(
        V4, qb, slotcode, rounds_meta, cols, **_kwargs(
            n_arms, K, t_final, n_final, k_out, n_valid, vscale, qscale,
            codebook, packed_int4, cert, k_cert, track_var)))


@_cascade_op.register_fake
def _cascade_fake(V4, qb, slotcode, rounds_meta, cols, vscale, qscale,
                  codebook, cert, n_arms, K, t_final, n_final, k_out,
                  n_valid, packed_int4, k_cert, track_var):
    out = [V4.new_empty((k_out,), dtype=torch.int32),
           V4.new_empty((k_out,), dtype=torch.float32)]
    if cert is not None:
        out.append(V4.new_empty((), dtype=torch.int32))
    return out


def fused_cascade(V4: torch.Tensor, qb: torch.Tensor,
                  slotcode: torch.Tensor, rounds_meta: torch.Tensor,
                  cols: torch.Tensor, *, n_arms: int, K: int, t_final: int,
                  n_final: int, k_out: Optional[int] = None,
                  n_valid: Optional[int] = None,
                  vscale: Optional[torch.Tensor] = None,
                  qscale: Optional[torch.Tensor] = None,
                  codebook: Optional[torch.Tensor] = None,
                  packed_int4: bool = False,
                  cert: Optional[torch.Tensor] = None,
                  k_cert: int = 1, track_var: bool = False):
    """The whole BoundedME cascade of one query in one dispatch.

    As `fused_cascade_batched` with one query: ``qb (n_blocks, C)``,
    ``cols (S,)`` and, on the int tiers, ``qscale (n_blocks,)``; ``k_out``,
    ``n_valid``, ``vscale``, ``codebook`` and ``cert`` as there.  Returns
    ``(ids (k_out,) int32, vals (k_out,) float32)``, vals unscaled block
    means, and with ``cert`` also a scalar ``rounds_used`` int32 tensor.
    """
    tensors = [t for t in (V4, qb, slotcode, rounds_meta, cols, vscale,
                           qscale, codebook, cert) if t is not None]
    on_cuda(*tensors)
    return tuple(_cascade_op(
        V4, qb, slotcode, rounds_meta, cols, vscale, qscale, codebook, cert,
        n_arms, K, t_final, n_final, K if k_out is None else int(k_out),
        n_arms if n_valid is None else n_valid, packed_int4, k_cert,
        track_var))


def fused_cascade_batched(V4: torch.Tensor, Qb: torch.Tensor,
                          slotcode: torch.Tensor, rounds_meta: torch.Tensor,
                          cols: torch.Tensor, *, n_arms: int, K: int,
                          t_final: int, n_final: int,
                          k_out: Optional[int] = None,
                          n_valid: Optional[int] = None,
                          vscale: Optional[torch.Tensor] = None,
                          qscale: Optional[torch.Tensor] = None,
                          codebook: Optional[torch.Tensor] = None,
                          packed_int4: bool = False,
                          cert: Optional[torch.Tensor] = None,
                          k_cert: int = 1, track_var: bool = False):
    """The whole BoundedME cascade of a query batch in one dispatch.

    ``V4 (n_tiles, n_blocks, R, Cs)`` tile-major table, ``Qb (B,
    n_blocks, C)`` blocked queries, ``slotcode (S,)`` / ``rounds_meta
    (n_rounds + 1, 3)`` from `FlatSchedule.packed`, ``cols (B, S)`` the
    column block each step pulls (``perm[flat.bpos]``), all int32.
    ``k_out`` (default K) widens the final extraction, ``K <= k_out <=
    n_final * R``; rows ``>= n_valid`` (default ``n_arms``) never win a
    ranking.

    The tier follows from the operands, as in the JAX package's
    ``fused_cascade_batched``: float32 or bfloat16 ``V4`` with float32
    ``Qb`` (fp32; a bf16 table is widened exactly and launches count as
    ``[bf16]``); int8
    ``V4`` and ``Qb`` with ``vscale (n_tiles, n_blocks)`` and ``qscale
    (B, n_blocks)`` float32 (int8); the same with ``V4``'s last dim
    nibble-packed to C/2 and ``packed_int4=True`` (int4, W4A8); uint8 pq
    codes ``V4 (..., S)`` with float32 ``Qb`` and ``codebook (n_blocks,
    S, n_codes, w)`` (pq).  ``cert (n_rounds + 1, 2)`` float32 from
    `cert_coeffs` turns on adaptive early exit, certifying the top
    ``k_cert`` rows, with the M2 accumulator of the 'bernstein' radii
    when ``track_var``.

    Returns ``(ids (B, k_out) int32, vals (B, k_out) float32)`` sorted by
    descending score, vals being unscaled block means; entries past the
    live rows carry ``-inf``.  With ``cert`` a third output ``rounds_used
    (B,) int32`` counts the rounds each query pulled in.

    A batch that shares one block permutation may pass ``cols`` as one
    row expanded over the batch (stride 0): the kernel then reads round
    1's cells once for the whole batch.  Results do not depend on it.
    """
    tensors = [t for t in (V4, Qb, slotcode, rounds_meta, cols, vscale,
                           qscale, codebook, cert) if t is not None]
    on_cuda(*tensors)
    return tuple(_cascade_batched_op(
        V4, Qb, slotcode, rounds_meta, cols, vscale, qscale, codebook, cert,
        n_arms, K, t_final, n_final, K if k_out is None else int(k_out),
        n_arms if n_valid is None else n_valid, packed_int4, k_cert,
        track_var))


def blocked_matvec(W: torch.Tensor, q: torch.Tensor, *, tile_n: int = 256,
                   tile_d: int = 512) -> torch.Tensor:
    """Exact blocked matvec ``W @ q``: ``W (n, d)`` and ``q (d,)`` both
    float32 or both bfloat16, ``(tile_n, tile_d)`` tiles clamped to the
    shape and required to divide it (``ValueError`` otherwise).  Returns
    ``(n,)`` float32."""
    if on_cuda(W, q):
        return blocked_matvec_cuda(W, q, tile_n=tile_n, tile_d=tile_d)
    return ref.blocked_matvec_ref(W, q, tile_n=tile_n, tile_d=tile_d)


@torch.library.custom_op("repro_torch::chain_sum", mutates_args=(),
                         device_types="cpu")
def _chain_sum_op(g: Tensor) -> Tensor:
    """The plain version (`ref.chain_sum_ref`)."""
    return ref.chain_sum_ref(g)


@_chain_sum_op.register_kernel("cuda")
def _chain_sum_cuda(g):
    """The CUDA kernel's launches (`chain_sum_cuda`)."""
    return chain_sum_cuda(g)


@_chain_sum_op.register_fake
def _chain_sum_fake(g):
    return g.new_empty(g.shape[-1:])


def chain_sum(g: torch.Tensor, lead: Optional[int] = None) -> torch.Tensor:
    """``g`` bf16 summed over its first ``lead`` dimensions (default all
    but the last, at most four) in bf16: one add and one rounding per
    element, in the order of XLA's CPU ``reduce``
    (`repro_torch.kernels.chain_sum.passes`: a chain in row-major order,
    or windows of 32 where a dimension is longer).  That is the program
    of the JAX package's gradient of a bf16 bias, where PyTorch's sums
    round once.  Returns ``g.shape[lead:]``; ``g`` is made contiguous
    first."""
    lead = g.dim() - 1 if lead is None else int(lead)
    if not 1 <= lead <= g.dim():
        raise ValueError(f"lead {lead} for a rank-{g.dim()} tensor")
    on_cuda(g)
    rest = g.shape[lead:]
    flat = g.reshape(*g.shape[:lead], math.prod(rest)).contiguous()
    check_operand(flat)
    return _chain_sum_op(flat).reshape(rest)
