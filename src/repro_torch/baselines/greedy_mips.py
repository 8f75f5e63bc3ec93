"""GREEDY-MIPS baseline (Yu et al., NIPS 2017), from
``repro.baselines.greedy_mips``.

Preprocessing: for every dimension j, the data indices sorted by v_i^(j)
(O(N n log n)).  Query phase: visit candidate (i, j) entries in decreasing
q^(j) v_i^(j) order with an N-way max-heap over dimensions (Greedy screening)
until ``budget`` distinct candidates are collected, then rescore exactly.
The budget B is the (implicit) efficiency/accuracy knob — no suboptimality
guarantee for non-uniform data, which is the paper's Motivation II contrast.

On the card: the index is built by a stable ``torch.argsort`` on the
table's device and the candidates are rescored there; the screening is
the reference's sequential heap walk, on numpy copies of the index and
the table taken once at build (its products in the operands' own dtypes,
so it visits the reference's entries in the reference's order).
"""

from __future__ import annotations

import dataclasses
import heapq

import numpy as np
import torch

from repro_torch.baselines.exact import SearchResult, matvec
from repro_torch.core.boundedme import as_operand, top_order

__all__ = ["GreedyIndex", "build_greedy", "greedy_mips"]


@dataclasses.dataclass
class GreedyIndex:
    order_desc: torch.Tensor    # (N, n) argsort of each column, descending
    V: torch.Tensor
    preprocess_multiplies: int  # comparison count proxy for O(N n log n)
    host_order: np.ndarray      # numpy copies the screening walks
    host_V: np.ndarray


def build_greedy(V, *, device=None) -> GreedyIndex:
    V = as_operand(V, device)
    n, N = V.shape
    order_desc = torch.argsort(-V, dim=0, stable=True).T.contiguous()
    pre = int(N * n * max(1, np.log2(max(2, n))))
    return GreedyIndex(order_desc, V, pre, order_desc.cpu().numpy(),
                       V.cpu().numpy())


def _screen(index: GreedyIndex, qh: np.ndarray, budget: int):
    """The Greedy screening walk: ``(candidates in visit order, cost)``."""
    V, order = index.host_V, index.host_order
    n, N = V.shape
    budget = min(budget, n)
    # heap entries: (-q_j * v_{i_r, j}, j, rank r); ranks advance per dim
    heap = []
    cost = 0
    for j in range(N):
        if qh[j] == 0.0:
            continue
        col = order[j] if qh[j] > 0 else order[j][::-1]
        val = qh[j] * V[col[0], j]
        cost += 1
        heap.append((-val, j, 0, col))
    heapq.heapify(heap)
    seen = set()
    cand = []
    while heap and len(cand) < budget:
        negval, j, r, col = heapq.heappop(heap)
        i = int(col[r])
        if i not in seen:
            seen.add(i)
            cand.append(i)
        if r + 1 < n:
            val = qh[j] * V[col[r + 1], j]
            cost += 1
            heapq.heappush(heap, (-val, j, r + 1, col))
    return cand, cost


def greedy_mips(index: GreedyIndex, q, K: int = 1,
                budget: int = 128) -> SearchResult:
    q = as_operand(q, index.V.device)
    cand, cost = _screen(index, q.cpu().numpy(), budget)
    ids = torch.as_tensor(cand, dtype=torch.int64).to(index.V.device)
    scores = matvec(index.V[ids], q)
    cost += ids.numel() * index.V.shape[1]
    order_k = top_order(scores, K)
    return SearchResult(ids[order_k], scores[order_k], cost,
                        index.preprocess_multiplies, ids.numel())
