"""Quickstart: MIPS with a suboptimality knob and zero preprocessing, in
PyTorch on a CUDA card.

The port of ``examples/quickstart.py``: the same data, knobs and printed
lines.  Each BoundedME search is one launch of the fused-cascade kernel
(``fused_cascade[fp32]``) on the card; ``--device cpu`` runs its plain
PyTorch version.

    PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.core.boundedme_torch import make_plan, resolve_device
from repro_torch.core.mips import exact_topk, mips_topk

#: the eps multiples of the score spread that the example sweeps
MULTS = (0.5, 2.0, 8.0)


def knobs(V: np.ndarray, q: np.ndarray):
    """``(sigma, value_range)`` of the table, on the host in numpy as the
    JAX example computes them: the spread of 512 rows' mean products, and
    a soft value range of 8 sigma of the coordinate products."""
    N = V.shape[1]
    sigma = float(np.std(V[:512] @ q / N))
    vr = float(8.0 * np.std(V) * np.std(q))
    return sigma, vr


def search(V: torch.Tensor, q: torch.Tensor, eps: float, vr: float, *,
           perm=None, device="cuda"):
    """One BoundedME top-5 search at ``eps`` (mean-product scale), delta
    0.1, blocks of 128 columns, exact final scores: ``(ids (5,), scores
    (5,))``.  The block permutation is ``perm`` when given, else drawn
    from a generator seeded 0 (the JAX example's ``PRNGKey(0)``)."""
    gen = None if perm is not None else torch.Generator().manual_seed(0)
    return mips_topk(V, q, K=5, method="boundedme", eps=eps, delta=0.1,
                     value_range=vr, perm=perm, generator=gen,
                     final_exact=True, block=128, device=device)


def run(V: np.ndarray, q: np.ndarray, *, device="cuda", perm=None,
        log=print) -> dict:
    """The example's work on an ``(n, N)`` table ``V`` and query ``q``:
    the exact top-5, then one BoundedME search per eps multiple of
    `MULTS`, each line printed through ``log`` as the JAX example prints
    it.

    Returns ``{"exact": ids (5,) tensor, "sigma", "value_range", "runs":
    [{"mult", "eps", "speedup", "ids", "scores", "overlap", "wall_s"}]}``
    with the tensors on ``device``."""
    n, N = V.shape
    dev = resolve_device(device)           # raises for a missing card
    Vt = torch.from_numpy(V).to(dev)
    qt = torch.from_numpy(q).to(dev)

    # exact baseline: full (n x N) matvec
    ids_exact, _ = exact_topk(Vt, qt, K=5)
    log(f"exact top-5: {np.asarray(ids_exact.cpu())}")
    exact = set(ids_exact.tolist())

    # eps is on the mean-product scale, in units of the cross-arm score
    # spread; the value range is soft (8 sigma of coordinate products)
    sigma, vr = knobs(V, q)
    out = {"exact": ids_exact, "sigma": sigma, "value_range": vr,
           "runs": []}
    for mult in MULTS:
        eps = mult * sigma
        plan = make_plan(n, N, K=5, eps=eps, delta=0.1, value_range=vr,
                         block=128)
        t0 = time.time()
        ids, scores = search(Vt, qt, eps, vr, perm=perm, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.time() - t0
        overlap = len(set(ids.tolist()) & exact)
        log(f"eps={mult:3.1f}*sigma: top-5 overlap {overlap}/5, "
            f"FLOP speedup {plan.speedup:4.1f}x, "
            f"wall {wall:.2f}s "
            f"(eps-optimal w.p. >= 0.9)")
        out["runs"].append({"mult": mult, "eps": eps,
                            "speedup": plan.speedup, "ids": ids,
                            "scores": scores, "overlap": overlap,
                            "wall_s": wall})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    from repro_torch.data.synthetic import mf_dataset

    # recommender-style item embeddings (the paper's fig-4 regime):
    # low-rank structure => real gaps between arm means => bandit wins
    n, N = 20_000, 8192
    V, q = mf_dataset(n, N, rank=32, seed=0)
    run(V, q, device=args.device)


if __name__ == "__main__":
    main()
