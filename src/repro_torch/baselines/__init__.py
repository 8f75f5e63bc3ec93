"""MIPS baselines from the paper's comparison (Table 1 / Figs 2-4), from
``repro.baselines``: built and queried on the card by default."""

from repro_torch.baselines.exact import SearchResult, exact_mips
from repro_torch.baselines.lsh_mips import LSHIndex, build_lsh, lsh_mips
from repro_torch.baselines.greedy_mips import (GreedyIndex, build_greedy,
                                               greedy_mips)
from repro_torch.baselines.pca_mips import PCATree, build_pca_tree, pca_mips

__all__ = [
    "SearchResult", "exact_mips", "LSHIndex", "build_lsh", "lsh_mips",
    "GreedyIndex", "build_greedy", "greedy_mips", "PCATree",
    "build_pca_tree", "pca_mips",
]
