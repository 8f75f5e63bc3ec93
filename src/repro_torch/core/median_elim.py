"""Classical fixed-confidence bandit baselines (i.i.d. bounds), from
``repro.core.median_elim``.

These are the "existing MAB methods" of the paper's comparison: they assume
rewards are i.i.d. draws from an infinite population and size their pulls
with Hoeffding, so their per-round pull counts are NOT capped by N.  We cap
*consumption* at N (reading past the list would be meaningless) but keep the
Hoeffding-sized accounting so the sample-complexity gap versus BoundedME is
visible — exactly the point of the MAB-BP setting.

Reductions run on R's own device, with the sums, ties and operand rules
of `repro_torch.core.boundedme`.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import bounds
from repro_torch.core.boundedme import (BoundedMEResult, as_operand,
                                        top_order, true_div)
from repro_torch.core.schedule import Round, Schedule

__all__ = ["median_elimination", "successive_elimination"]


def median_elimination(R, K: int = 1, eps: float = 0.1, delta: float = 0.05,
                       value_range: float = 1.0, *,
                       device=None) -> BoundedMEResult:
    """Even-Dar et al. (2002) Median Elimination with Hoeffding pull counts."""
    R = as_operand(R, device)
    n, N = R.shape
    alive = torch.arange(n, device=R.device)
    sums = torch.zeros(n, dtype=torch.float64, device=R.device)
    t_prev, total, l = 0, 0, 1
    eps_l, delta_l = eps / 4.0, delta / 2.0
    rounds = []
    while alive.numel() > K:
        gap = alive.numel() - K
        delta_eff = delta_l * (gap // 2 + 1) / (2.0 * gap)
        t_l = bounds.hoeffding_required(eps_l / 2.0, delta_eff, value_range)
        t_read = min(t_l, N)  # cannot read past the finite list
        if t_read > t_prev:
            sums[alive] += R[alive, t_prev:t_read].sum(dim=1)
        total += alive.numel() * max(0, t_l - t_prev)  # Hoeffding accounting
        n_keep = K + gap // 2
        means = true_div(sums[alive], max(1, t_read))
        alive = alive[top_order(means, n_keep)].sort().values
        rounds.append(Round(l, alive.numel(), n_keep, t_l, t_l - t_prev,
                            eps_l, delta_l))
        t_prev = max(t_prev, t_read)
        eps_l, delta_l, l = 0.75 * eps_l, 0.5 * delta_l, l + 1
    means = true_div(sums[alive], max(1, t_prev))
    order = top_order(means, K)
    sched = Schedule(n, N, K, eps, delta, value_range, tuple(rounds))
    return BoundedMEResult(alive[order], means[order], total, len(rounds),
                           sched)


def successive_elimination(R, K: int = 1, eps: float = 0.1,
                           delta: float = 0.05, value_range: float = 1.0,
                           batch: int = 32, *,
                           device=None) -> BoundedMEResult:
    """Even-Dar et al. (2006) successive elimination, Hoeffding radii.

    Pull all surviving arms ``batch`` times per sweep; drop any arm whose UCB
    falls below the K-th best LCB; stop when the radius is below eps/2 or K
    arms remain.  Consumption capped at the list length N.
    """
    R = as_operand(R, device)
    n, N = R.shape
    alive = torch.arange(n, device=R.device)
    sums = torch.zeros(n, dtype=torch.float64, device=R.device)
    t_acc = 0   # iid-accounted pulls per arm (can exceed N!)
    t_read = 0  # entries actually consumed from the finite list (<= N)
    total, sweeps = 0, 0
    delta_arm = delta / max(2, n)  # union bound over arms (crude)
    while alive.numel() > K:
        t_new = min(batch, max(0, N - t_read))
        if t_new:
            sums[alive] += R[alive, t_read:t_read + t_new].sum(dim=1)
            t_read += t_new
        t_acc += batch
        # accounting is iid-Hoeffding: an algorithm unaware of the finite
        # list must keep pulling (with replacement) to shrink its radius
        total += alive.numel() * batch
        sweeps += 1
        # the radius on the host in numpy's arithmetic, as the reference
        rad_iid = float(value_range * np.sqrt(np.log(1.0 / delta_arm)
                                              / (2.0 * t_acc)))
        means = true_div(sums[alive], t_read)
        lcb_k = torch.topk(means, K).values[K - 1] - rad_iid
        keep_idx = torch.nonzero(means + rad_iid >= lcb_k).flatten()
        if keep_idx.numel() >= K:
            alive = alive[keep_idx]
        if rad_iid <= eps / 2.0:
            break
    means = true_div(sums[alive], max(1, t_read))
    order = top_order(means, K)
    sched = Schedule(n, N, K, eps, delta, value_range, ())
    return BoundedMEResult(alive[order], means[order], total, sweeps, sched)
