"""LSH-MIPS baseline (Shrivastava & Li 2014 / Neyshabur & Srebro 2015),
from ``repro.baselines.lsh_mips``.

MIPS -> angular NNS via the Bachrach et al. (2014) Euclidean transform:
scale every v by 1/U (U = max norm) and append sqrt(1 - |v|^2) so all data
lie on the unit sphere; the query appends 0 and is normalized.  Then
sign-random-projection LSH with the standard amplification: ``b`` hyper hash
functions (OR), each an AND of ``a`` random projections.  Candidates from
matching buckets are exactly rescored.

Preprocessing cost: O(N n a b) projections — the Table 1 entry.

On the card: the planes are drawn in numpy exactly as the JAX package
draws them, then moved to the table's device, so the index is the
reference's; projections run in float64 (numpy promotes the float64
planes with a float32 table the same way) and the sign bits are packed by
shifts, as CUDA has no int64 ``matmul``.  Each table's buckets, a Python
dict in the JAX package, are one row of a CSR: the row ids stable-sorted
by code (so a bucket lists its rows in index order, as the dict does) and
the codes in that order, in which ``torch.searchsorted`` finds a query's
bucket as the run ``[lo, hi)``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.baselines.exact import SearchResult, matvec
from repro_torch.core.boundedme import as_operand, top_order

__all__ = ["LSHIndex", "build_lsh", "lsh_mips"]


def _transform_data(V: torch.Tensor) -> Tuple[torch.Tensor, float]:
    norms = torch.linalg.vector_norm(V, dim=1)
    U = float(norms.max()) or 1.0
    Vs = V / U
    aug = torch.sqrt(torch.clamp(1.0 - (norms / U) ** 2, min=0.0))
    return torch.cat([Vs, aug[:, None]], dim=1), U


def _transform_query(q: torch.Tensor) -> torch.Tensor:
    """``[q / |q|, 0]`` in float64 (numpy widens on the appended 0.0)."""
    qn = float(torch.linalg.vector_norm(q)) or 1.0
    return torch.cat([(q / qn).to(torch.float64),
                      q.new_zeros(1, dtype=torch.float64)])


@dataclasses.dataclass
class LSHIndex:
    planes: torch.Tensor        # (b, a, N+1) random hyperplanes, float64
    codes: torch.Tensor         # (b, n) each table's bucket ids, sorted
    ids: torch.Tensor           # (b, n) row ids in that order
    V: torch.Tensor             # original data (for exact rescoring)
    preprocess_multiplies: int


def _codes(planes: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Pack a sign-projection AND-construction into integer bucket ids."""
    a = planes.shape[1]
    proj = torch.einsum("bad,nd->nba", planes, X.to(planes.dtype)) > 0
    shifts = torch.arange(a, device=planes.device)
    return (proj.to(torch.int64) << shifts).sum(dim=-1)  # (n, b)


def build_lsh(V, a: int = 8, b: int = 16, seed: int = 0, *,
              device=None) -> LSHIndex:
    V = as_operand(V, device)
    rng = np.random.default_rng(seed)
    Vt, _ = _transform_data(V)
    planes = torch.as_tensor(rng.normal(size=(b, a, Vt.shape[1]))).to(
        V.device)
    codes, ids = torch.sort(_codes(planes, Vt).T, dim=1, stable=True)
    pre = V.shape[0] * Vt.shape[1] * a * b
    return LSHIndex(planes, codes.contiguous(), ids.contiguous(), V, pre)


def lsh_mips(index: LSHIndex, q, K: int = 1) -> SearchResult:
    """Candidates from the query's bucket in every table, rescored on the
    index's device (ties: the lower index)."""
    V = index.V
    q = as_operand(q, V.device)
    qt = _transform_query(q)
    qcodes = _codes(index.planes, qt[None, :])[0][:, None]  # (b, 1)
    lo = torch.searchsorted(index.codes, qcodes)
    hi = torch.searchsorted(index.codes, qcodes, right=True)
    pos = torch.arange(index.codes.shape[1], device=V.device)
    hits = index.ids[(pos >= lo) & (pos < hi)]
    query_cost = index.planes.shape[0] * index.planes.shape[1] * qt.numel()
    if hits.numel() == 0:
        empty = torch.empty(0, dtype=torch.promote_types(V.dtype, q.dtype),
                            device=V.device)
        return SearchResult(torch.empty(0, dtype=torch.int64,
                                        device=V.device), empty, query_cost,
                            index.preprocess_multiplies, 0)
    ids = torch.unique(hits)
    scores = matvec(V[ids], q)
    query_cost += ids.numel() * q.numel()
    order = top_order(scores, K)
    return SearchResult(ids[order], scores[order], query_cost,
                        index.preprocess_multiplies, ids.numel())
