"""PCA-MIPS baseline (Bachrach et al., RecSys 2014), from
``repro.baselines.pca_mips``.

MIPS -> Euclidean NNS via the same augmentation as LSH-MIPS, then a PCA tree:
at depth t the data are split at the median of their projection onto the t-th
principal component.  A query descends to one leaf (optionally spilling to
sibling leaves within ``spill`` of the split) and exactly rescores the leaf.
Preprocessing: O(N^2 n) for the PCA + O(n log n) tree build (Table 1).

On the card: the SVD, the projections and each node's split run on the
table's device, and the leaves hold their row ids there; the tree itself
(depth at most ``depth``) is a small node structure walked on the host.
A node's median is the mean of its two middle order statistics on an
even count, as ``np.median`` takes it.  The SVD fixes each component's
sign as its library does: a flipped component mirrors its nodes' splits,
so a query reaches the mirrored child, which holds the same rows, but
where a node's count is odd (its median row changes sides).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from repro_torch.baselines.exact import SearchResult, matvec
from repro_torch.baselines.lsh_mips import _transform_data, _transform_query
from repro_torch.core.boundedme import as_operand, top_order

__all__ = ["PCATree", "build_pca_tree", "pca_mips"]


@dataclasses.dataclass
class _Node:
    depth: int
    ids: Optional[torch.Tensor] = None    # leaf only
    threshold: float = 0.0
    left: Optional["_Node"] = None
    right: Optional["_Node"] = None


@dataclasses.dataclass
class PCATree:
    components: torch.Tensor  # (depth, N+1) principal directions
    root: _Node
    V: torch.Tensor
    depth: int
    preprocess_multiplies: int


def _median(vals: torch.Tensor) -> float:
    """``np.median``: the middle value, or the mean of the two middle
    values on an even count (in ``vals``' dtype)."""
    s = torch.sort(vals).values
    m = s.numel()
    if m % 2:
        return float(s[m // 2])
    return float((s[m // 2 - 1] + s[m // 2]) / 2)


def _build(ids: torch.Tensor, proj: torch.Tensor, depth: int,
           max_depth: int) -> _Node:
    if depth >= max_depth or ids.numel() <= 1:
        return _Node(depth, ids=ids)
    vals = proj[ids, depth]
    thr = _median(vals)
    left_mask = vals <= thr
    n_left = int(left_mask.sum())
    # guard degenerate splits (all-equal projections)
    if n_left in (0, ids.numel()):
        return _Node(depth, ids=ids)
    node = _Node(depth, threshold=thr)
    node.left = _build(ids[left_mask], proj, depth + 1, max_depth)
    node.right = _build(ids[~left_mask], proj, depth + 1, max_depth)
    return node


def build_pca_tree(V, depth: int = 6, *, device=None) -> PCATree:
    V = as_operand(V, device)
    Vt, _ = _transform_data(V)
    mu = Vt.mean(dim=0)
    X = Vt - mu
    # top-`depth` principal components via SVD
    _, _, vt = torch.linalg.svd(X, full_matrices=False)
    comps = vt[:depth]
    proj = X @ comps.T  # (n, depth)
    root = _build(torch.arange(V.shape[0], device=V.device), proj, 0, depth)
    d = Vt.shape[1]
    pre = d * d * V.shape[0] + depth * V.shape[0] * d
    return PCATree(comps, root, V, depth, pre)


def pca_mips(tree: PCATree, q, K: int = 1,
             spill: float = 0.0) -> SearchResult:
    V = tree.V
    q = as_operand(q, V.device)
    qt = _transform_query(q)
    # queries are projected against the same centered components
    qproj = matvec(tree.components, qt).tolist()
    cost = tree.components.numel()
    leaves: List[torch.Tensor] = []

    def descend(node: _Node):
        if node.ids is not None:
            leaves.append(node.ids)
            return
        v = qproj[node.depth]
        if v <= node.threshold + spill:
            descend(node.left)
        if v > node.threshold - spill:
            descend(node.right)

    descend(tree.root)
    ids = (torch.unique(torch.cat(leaves)) if leaves
           else torch.empty(0, dtype=torch.int64, device=V.device))
    scores = matvec(V[ids], q)
    cost += ids.numel() * q.numel()
    order = top_order(scores, K)
    return SearchResult(ids[order], scores[order], cost,
                        tree.preprocess_multiplies, ids.numel())
