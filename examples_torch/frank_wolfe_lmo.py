"""Motivation I: BoundedME as an approximate LMO inside Frank-Wolfe, in
PyTorch on a CUDA card.

The port of ``examples/frank_wolfe_lmo.py``: the same problem, iterations
and printed lines.  Frank-Wolfe over the convex hull of a vector set S
solves
    min_{x in conv(S)} f(x)
and each iteration needs an LMO:  argmin_{v in S} <grad f(x), v>  — a MIPS
query with q = -grad.  Because x (hence q) changes every iteration, any
preprocessing-based index would have to amortize over ... one query.  The
bandit LMO is the paper's Algorithm 1 (`repro_torch.core.boundedme`), plain
PyTorch on the device, as in the JAX package; no kernel.

    PYTHONPATH=src python examples_torch/frank_wolfe_lmo.py [--device cpu]
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.core.boundedme import bounded_me, reward_matrix
from repro_torch.core.boundedme_torch import resolve_device


def frank_wolfe(S, target, iters=30, lmo="exact", eps=0.3, seed=0,
                device="cuda", trace=None):
    """min_x ||x - target||^2 over conv(S) with exact or bandit LMO.

    ``S`` (n, N) float32 and ``target`` (N,) (float64, as the JAX example
    builds it) are numpy arrays or tensors.  The arithmetic follows the
    JAX example's numpy types: ``x`` stays float32, the gradient, the
    query and the exact LMO's products are float64.  Each bandit step's
    coordinate permutation is ``default_rng(seed).permutation(N)``, drawn
    in order as the JAX ``reward_matrix`` draws it, so both packages pull
    the same reward lists.  ``trace``, when given, gets one ``(t, i,
    pulls)`` per iteration: the LMO's pick and its multiplies.

    Returns ``(x (N,) float32 tensor on device, total multiplies)``.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    S = torch.as_tensor(S, dtype=torch.float32).to(dev)
    target = torch.as_tensor(target).to(dev)
    n, N = S.shape
    S64 = S.double() if lmo == "exact" else None
    s_max = float(S.abs().max())
    x = S[0].clone()
    pulls = 0
    for t in range(iters):
        grad = 2.0 * (x - target)
        q = -grad
        if lmo == "exact":
            i = int(torch.argmax(S64 @ q))
            step = n * N
        else:
            vr = s_max * float(q.abs().max())
            R = reward_matrix(S, q, perm=rng.permutation(N))
            res = bounded_me(R, K=1, eps=eps * vr, delta=0.1,
                             value_range=2 * vr)
            i = int(res.topk[0])
            step = res.total_pulls
        pulls += step
        if trace is not None:
            trace.append((t, i, step))
        gamma = 2.0 / (t + 2.0)
        x = (1 - gamma) * x + gamma * S[i]
    return x, pulls


def problem(n: int = 1000, N: int = 20_000):
    """``(S (n, N) float32, target (N,) float64)``, numpy, from
    ``default_rng(1)`` as the JAX example draws them: a target inside the
    hull, a convex combination of the first 8 atoms."""
    rng = np.random.default_rng(1)
    S = rng.normal(size=(n, N)).astype(np.float32)
    w = rng.dirichlet(np.ones(8))
    target = (w[None] @ S[:8]).ravel()
    return S, target


#: the example's LMOs: (lmo, eps or None)
LMOS = (("exact", None), ("boundedme", 0.2), ("boundedme", 0.5))


def run(S, target, *, iters=25, device="cuda", log=print) -> list:
    """Frank-Wolfe with each LMO of `LMOS`, one printed line each, as
    the JAX example prints them.  Returns ``[{"tag", "lmo", "eps",
    "rel_err", "multiplies" (of naive), "pulls", "seconds", "x",
    "trace"}]``."""
    n, N = S.shape
    out = []
    for lmo, eps in LMOS:
        trace = []
        t0 = time.time()
        x, pulls = frank_wolfe(S, target, iters=iters, lmo=lmo,
                               eps=eps or 0, device=device, trace=trace)
        xn = x.cpu().numpy()
        seconds = time.time() - t0
        err = float(np.linalg.norm(xn - target) / np.linalg.norm(target))
        tag = lmo if eps is None else f"{lmo}(eps={eps})"
        log(f"{tag:18s}: rel err {err:.4f}, "
            f"LMO multiplies {pulls / (iters * n * N):.2f}x naive, "
            f"{seconds:.1f}s")
        out.append({"tag": tag, "lmo": lmo, "eps": eps, "rel_err": err,
                    "multiplies": pulls / (iters * n * N), "pulls": pulls,
                    "seconds": seconds, "x": xn, "trace": trace})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    S, target = problem(1000, 20_000)
    run(S, target, iters=25, device=args.device)


if __name__ == "__main__":
    main()
