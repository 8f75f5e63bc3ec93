"""MIPS helpers of the port (from ``repro.core.mips``).

Only what the serving path needs so far: the exhaustive baseline and the
table's max magnitude, from which the executor derives its a-priori
value range.  ``mips_topk`` and ``nns_topk`` are ROADMAP queue 1 item 6.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["exact_topk", "table_abs_max"]


def exact_topk(V: torch.Tensor, q: torch.Tensor, K: int = 1
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exhaustive baseline: full matvec + top-K.  Scores are (q.v)/N."""
    scores = (V @ q).to(torch.float32) / V.shape[1]
    vals, ids = torch.topk(scores, K)
    return ids, vals


def table_abs_max(V: torch.Tensor) -> float:
    """max|V_ij| as a host float."""
    return float(V.abs().max())
