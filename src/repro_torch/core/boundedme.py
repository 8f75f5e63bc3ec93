"""Reference BoundedME (Algorithm 1) — exact per-arm semantics (from
``repro.core.boundedme``).

The paper-faithful implementation used to validate Theorem 1 and as the
correctness oracle for the blocked path (`boundedme_torch`).  A loop over
rounds on the host whose every reduction runs on the reward matrix's own
device; the rewards are presented as a matrix in *oracle order*: pulling
arm ``i`` for the ``t``-th time returns ``R[i, t-1]``.

* For MIPS, build ``R`` with :func:`reward_matrix` (a shared random
  coordinate permutation per query = uniform sampling without
  replacement).
* For the paper's adversarial experiment (Fig. 1), pass rows sorted
  descending (1-rewards returned before 0-rewards).

Only *consumed* entries count toward the reported sample complexity.

Arithmetic, as in the JAX package: each round sums its new rewards in
R's own dtype and accumulates them into float64 sums.  Ties at a round's
cut keep the lowest arm index (the survivors are kept in index order and
selected by a stable descending sort), as the fused cascade's round ends
do; the JAX package leaves that choice to ``np.argpartition``.

Operands: a tensor is worked on its own device unless ``device`` names
another; anything else goes to ``device``, the card by default
(`resolve_device` raises where there is none).  Results are tensors on
that device; the cost counters are Python ints.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.boundedme_torch import resolve_device
from repro_torch.core.schedule import Schedule, make_schedule

__all__ = ["BoundedMEResult", "bounded_me", "reward_matrix", "as_operand",
           "top_order", "true_div"]


@dataclasses.dataclass
class BoundedMEResult:
    topk: torch.Tensor          # (K,) int64 arm indices, best-first by mean
    means: torch.Tensor         # (K,) empirical means at termination
    total_pulls: int            # consumed rewards (the sample complexity)
    rounds: int
    schedule: Schedule


def as_operand(x, device=None) -> torch.Tensor:
    """``x`` as a tensor of its own dtype: a tensor stays on its own
    device unless ``device`` names another; anything else goes to
    ``device`` (the card when None)."""
    if isinstance(x, torch.Tensor):
        dev = x.device if device is None else resolve_device(device)
    else:
        dev = resolve_device("cuda" if device is None else device)
    return torch.as_tensor(x).to(dev)


def top_order(x: torch.Tensor, k: int) -> torch.Tensor:
    """Positions of the ``k`` largest entries of ``x``, best first; ties
    keep the lower position (a stable descending sort)."""
    return torch.sort(x, descending=True, stable=True).indices[:k]


def true_div(x: torch.Tensor, d) -> torch.Tensor:
    """``x / d`` divided, not multiplied by ``1 / d``: PyTorch divides a
    CUDA tensor by a Python number as a multiply by its reciprocal, which
    would put the card's means an ulp off the CPU's (and off the exact
    means of Fig. 1's integer sums)."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def reward_matrix(V, q, perm=None, *,
                  generator: Optional[torch.Generator] = None,
                  device=None) -> torch.Tensor:
    """MIPS reward lists in oracle order: a shared random coordinate order.

    Sharing one permutation across arms keeps each arm's pulls a uniform
    without-replacement sample (the guarantee never uses cross-arm
    independence).  ``perm`` is the ``(N,)`` coordinate permutation, in
    place of the JAX package's ``rng``; without it one is drawn from
    ``generator`` (default seeded 0, so repeated calls agree).
    """
    V = as_operand(V, device)
    q = as_operand(q, V.device)
    if perm is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        perm = torch.randperm(V.shape[1], generator=generator)
    perm = torch.as_tensor(perm, dtype=torch.int64).to(V.device)
    return V[:, perm] * q[perm][None, :]


def bounded_me(R, K: int = 1, eps: float = 0.1, delta: float = 0.05,
               value_range: float = 1.0,
               schedule: Optional[Schedule] = None, *,
               device=None) -> BoundedMEResult:
    """Run Algorithm 1 on reward matrix ``R`` (n, N) given in oracle order."""
    R = as_operand(R, device)
    n, N = R.shape
    if schedule is None:
        schedule = make_schedule(n, N, K=K, eps=eps, delta=delta,
                                 value_range=value_range)
    K = schedule.K
    if not schedule.rounds:  # K >= n: return everything
        means = R.mean(dim=1)
        order = top_order(means, K)
        return BoundedMEResult(order, means[order], 0, 0, schedule)

    alive = torch.arange(n, device=R.device)
    sums = torch.zeros(n, dtype=torch.float64, device=R.device)
    t_prev = 0
    total = 0
    for rnd in schedule.rounds:
        if rnd.t_new > 0:
            sums[alive] += R[alive, t_prev:rnd.t_cum].sum(dim=1)
            total += alive.numel() * rnd.t_new
        t_prev = rnd.t_cum
        means = true_div(sums[alive], max(1, t_prev))
        # keep the n_keep arms with the highest empirical means, in index
        # order (so the next cut's ties also fall to the lowest index)
        alive = alive[top_order(means, rnd.n_keep)].sort().values
    final_means = true_div(sums[alive], max(1, t_prev))
    order = top_order(final_means, K)
    return BoundedMEResult(alive[order], final_means[order], total,
                           len(schedule.rounds), schedule)
