"""BoundedSE — beyond-paper: instance-adaptive elimination under MAB-BP
(from ``repro.core.bounded_se``).

BoundedME (the paper) sizes every round for the *worst case*: its pull
counts depend only on (n, N, eps, delta), never on the observed gaps, so
easy instances (large gaps) pay the same as hard ones.  Classical
Successive Elimination is gap-adaptive but uses i.i.d. Hoeffding radii that
ignore the finite list.  BoundedSE combines both: SE-style anytime
elimination with the *without-replacement* deviation radius
``(b-a) sqrt(rho_m log(c m^2 / delta') / 2m)`` (Corollary 1 + a union bound
over the pull schedule), which (i) shrinks to **zero** at m = N, so the
algorithm degrades gracefully to exhaustive search, and (ii) stops as soon
as the top-K set is separated by eps — adaptively early on easy instances.

Guarantee: returned set is eps-optimal w.p. >= 1-delta (union bound over
arms x checkpoints), **provided pulls are uniformly-random without
replacement** — which the MIPS reduction guarantees by construction
(`reward_matrix` samples coordinates in a fresh random order; the adversary
controls values, never the pull order).  Under an order-controlling
adversary (the paper's Fig-1 oracle) the anytime radius is invalid — use
BoundedME there, whose worst-case round sizing is order-robust.

Reductions run on R's own device, with the sums, ties and operand rules
of `repro_torch.core.boundedme`.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import bounds
from repro_torch.core.boundedme import (BoundedMEResult, as_operand,
                                        top_order, true_div)
from repro_torch.core.schedule import Schedule

__all__ = ["bounded_se"]


def bounded_se(R, K: int = 1, eps: float = 0.1, delta: float = 0.05,
               value_range: float = 1.0, batch: int = 32, *,
               device=None) -> BoundedMEResult:
    """Anytime eps-top-K identification on reward matrix R (oracle order)."""
    R = as_operand(R, device)
    n, N = R.shape
    if K >= n:
        means = R.mean(dim=1)
        order = top_order(means, K)
        return BoundedMEResult(order, means[order], 0, 0,
                               Schedule(n, N, K, eps, delta, value_range, ()))
    alive = torch.arange(n, device=R.device)
    sums = torch.zeros(n, dtype=torch.float64, device=R.device)
    t, total, checks = 0, 0, 0
    n_checks = max(1, int(math.ceil(N / batch)))
    # per-arm, per-checkpoint confidence budget (union bound)
    delta_pt = delta / (n * n_checks)

    while alive.numel() > K and t < N:
        t_new = min(batch, N - t)
        sums[alive] += R[alive, t:t + t_new].sum(dim=1)
        t += t_new
        total += alive.numel() * t_new
        checks += 1
        rad = bounds.deviation_bound(t, N, delta_pt, value_range)
        means = true_div(sums[alive], t)
        # K-th best lower bound vs each arm's upper bound
        kth = torch.topk(means, K).values[K - 1]
        keep_idx = torch.nonzero(means + rad >= kth - rad).flatten()
        if keep_idx.numel() >= K:
            alive = alive[keep_idx]
        if 2.0 * rad <= eps:     # everyone surviving is eps-good vs kth
            break
    means = true_div(sums[alive], max(1, t))
    order = top_order(means, K)
    sched = Schedule(n, N, K, eps, delta, value_range, ())
    return BoundedMEResult(alive[order], means[order], total, checks, sched)
