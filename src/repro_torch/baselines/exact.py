"""Exhaustive MIPS baseline with explicit cost accounting (from
``repro.baselines.exact``)."""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.boundedme import as_operand, top_order

__all__ = ["SearchResult", "exact_mips", "matvec"]


@dataclasses.dataclass
class SearchResult:
    topk: torch.Tensor      # (K,) int64 indices, best first
    scores: torch.Tensor    # (K,) inner products (NOT divided by N)
    query_multiplies: int   # multiply count attributable to this query
    preprocess_multiplies: int = 0
    candidates: int = 0     # size of the exactly-rescored candidate set


def matvec(V: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``V @ q`` in the wider of the two dtypes, as numpy promotes them."""
    dt = torch.promote_types(V.dtype, q.dtype)
    return V.to(dt) @ q.to(dt)


def exact_mips(V, q, K: int = 1, *, device=None) -> SearchResult:
    """``V @ q`` on V's device and its top K (ties: the lower index)."""
    V = as_operand(V, device)
    scores = matvec(V, as_operand(q, V.device))
    order = top_order(scores, K)
    return SearchResult(order, scores[order], V.shape[0] * V.shape[1],
                        candidates=V.shape[0])
