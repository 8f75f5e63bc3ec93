"""Plain PyTorch version of the fused cascade kernel.

`fused_cascade_batched_ref` computes what the CUDA kernel
(``csrc/fused_cascade.cu``) computes, with the same operands and outputs,
and shares no code with it.  It walks the flat schedule round by round,
vectorised over survivors and queries, never step by step: within a
round the survivor list is fixed and each tile receives only its own
pulls, so the round's k-th pulls of all slots form one batched gather and
``einsum``, taken in k order — each tile still sums its column blocks in
schedule order.  Eliminations are a stable descending sort of the masked
tile-max means cut at ``n_keep`` (highest score first, lowest slot on
ties), which is the order the kernel's extraction writes survivors in.

The CPU tests use it as the port's implementation on CPU tensors, and
``chip_smoke.py`` holds the kernel against it on the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.schedule import END_BIT, PULL_BIT, SLOT_MASK

__all__ = ["fused_cascade_batched_ref"]

#: gathered elements per chunk (x4 bytes): bounds the round-1 working set
_CHUNK_ELEMS = 1 << 26


def _segments(code: np.ndarray):
    """Split the step codes into rounds: yields (pull steps, ends_round)."""
    ends = np.nonzero(code & END_BIT)[0]
    bounds = list(zip(np.r_[0, ends + 1], np.r_[ends + 1, code.shape[0]]))
    for i, (lo, hi) in enumerate(bounds):
        if lo == hi and i == len(bounds) - 1:
            break
        steps = lo + np.nonzero(code[lo:hi] & PULL_BIT)[0]
        yield steps, i < len(ends)


def _occurrence_rank(slots: np.ndarray) -> np.ndarray:
    """For each step, how many earlier steps of the round pull its slot."""
    order = np.argsort(slots, kind="stable")
    s = slots[order]
    first = np.r_[True, s[1:] != s[:-1]]
    start = np.maximum.accumulate(np.where(first, np.arange(s.size), 0))
    rank = np.empty_like(order)
    rank[order] = np.arange(s.size) - start
    return rank


def _pull_round(acc, surv, V4, Qb, cols, code, steps, pulled):
    B = Qb.shape[0]
    R, C = V4.shape[2], V4.shape[3]
    dev = V4.device
    bi = torch.arange(B, device=dev)[:, None]
    slots = (code[steps] & SLOT_MASK).astype(np.int64)
    rank = _occurrence_rank(slots)
    chunk = max(1, _CHUNK_ELEMS // (B * R * C))
    for k in range(int(rank.max(initial=-1)) + 1):
        sel = rank == k            # slots are distinct within one rank
        st = torch.as_tensor(steps[sel], device=dev)
        sl = torch.as_tensor(slots[sel], device=dev)
        for lo in range(0, st.numel(), chunk):
            tiles = surv[:, sl[lo:lo + chunk]]                  # (B, m)
            cc = cols[:, st[lo:lo + chunk]].long()              # (B, m)
            part = torch.einsum("bmrc,bmc->bmr", V4[tiles, cc], Qb[bi, cc])
            acc[bi, tiles] += part
            if pulled is not None:
                pulled[tiles.reshape(-1), cc.reshape(-1)] = True


def _masked_means(acc, tiles, denom, R, n_valid):
    """(B, T, R) means of the tiles' rows, -inf past ``n_valid``."""
    B = tiles.shape[0]
    bi = torch.arange(B, device=acc.device)[:, None]
    rows = tiles[..., None] * R + torch.arange(R, device=acc.device)
    means = acc[bi, tiles] / denom
    return torch.where(rows < n_valid, means,
                       torch.full_like(means, -torch.inf))


def fused_cascade_batched_ref(V4: torch.Tensor, Qb: torch.Tensor,
                              slotcode: torch.Tensor,
                              rounds_meta: torch.Tensor, cols: torch.Tensor,
                              *, n_arms: int, K: int, t_final: int,
                              n_final: int, k_out: Optional[int] = None,
                              n_valid: Optional[int] = None,
                              pulled: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused cascade over a query batch, in plain PyTorch.

    Operands and results as in
    `repro_torch.kernels.fused_cascade.fused_cascade_batched_cuda`; runs
    on the operands' device.  ``pulled``, an optional ``(n_tiles,
    n_blocks)`` bool tensor, is set wherever any query pulls a cell: the
    union of bytes the batch reads (``chip_smoke.py`` bounds the kernel's
    time with it).
    """
    n_tiles, n_blocks, R, C = V4.shape
    B = Qb.shape[0]
    dev = V4.device
    k_out = K if k_out is None else int(k_out)
    n_valid = n_arms if n_valid is None else int(n_valid)
    if not 1 <= k_out <= n_final * R:
        raise ValueError(f"k_out={k_out} outside [1, n_final*R="
                         f"{n_final * R}]")
    code = slotcode.cpu().numpy().astype(np.int64)
    meta = rounds_meta.cpu().numpy().astype(np.int64)
    Qb = Qb.float()
    acc = torch.zeros((B, n_tiles, R), dtype=torch.float32, device=dev)
    surv = torch.arange(n_tiles, device=dev).repeat(B, 1)
    rnd = 0
    for steps, ends_round in _segments(code):
        if steps.size:
            _pull_round(acc, surv, V4, Qb, cols, code, steps, pulled)
        if not ends_round:
            continue
        t_cum, T, keep = (int(x) for x in meta[rnd])
        rnd += 1
        denom = torch.tensor(float(t_cum * C), dtype=torch.float32,
                             device=dev)
        tiles = surv[:, :T]
        score = _masked_means(acc, tiles, denom, R, n_valid).amax(-1)
        order = torch.sort(score, dim=1, descending=True, stable=True)[1]
        surv[:, :keep] = torch.gather(tiles, 1, order[:, :keep])
    denom = torch.tensor(float(max(1, t_final) * C), dtype=torch.float32,
                         device=dev)
    tiles = surv[:, :n_final]
    flat = _masked_means(acc, tiles, denom, R, n_valid).reshape(B, -1)
    vals, pos = torch.sort(flat, dim=1, descending=True, stable=True)
    pos = pos[:, :k_out]
    ids = torch.gather(tiles, 1, pos // R) * R + pos % R
    return ids.to(torch.int32), vals[:, :k_out].contiguous()
