"""Concentration bounds (a copy of ``repro.core.bounds``; the port imports
nothing of the JAX package).

Concentration bounds for sampling *without replacement* from a finite list.

This module is the statistical heart of the paper: Corollary 2.5 of
Bardenet & Maillard (2015) and the closed-form sample size ``m(u)`` derived
from it (Lemma 1 / Lemma 3 in the paper).  It also ships the classical
(i.i.d.) Hoeffding and LIL sample sizes used by the bandit baselines so the
sample-complexity win of the without-replacement bound is measurable.

Everything here is plain python/numpy on scalars: these quantities are
*static* (they depend only on n, N, K, eps, delta), are computed at trace
time, and parameterize the shapes of the fused CUDA cascade.
"""

from __future__ import annotations

import math
from typing import Optional

__all__ = [
    "rho_m",
    "u_term",
    "m_required",
    "deviation_bound",
    "bernstein_radius",
    "m_required_eb",
    "coord_radius",
    "coord_m_required",
    "hoeffding_required",
    "lil_required",
    "quantization_error",
    "KAPPA_EB",
]

# additive-term constant of the empirical Bernstein–Serfling inequality
# (Bardenet & Maillard 2015, Theorem 3): kappa = 7/3 + 3/sqrt(2)
KAPPA_EB = 7.0 / 3.0 + 3.0 / math.sqrt(2.0)


def rho_m(m: int, N: int) -> float:
    """The variance-reduction factor for sampling without replacement.

    ``rho_m = min{1 - (m-1)/N, (1 - m/N)(1 + 1/m)}``  (Eq. 3 of the paper).
    As ``m → N`` this goes to 0: once the whole list is seen, the empirical
    mean is exact.  The i.i.d. Hoeffding bound corresponds to ``rho_m = 1``.

    Clamped at the boundary: any ``m >= N`` returns exactly 0.0 (the
    without-replacement variance of a fully observed list is zero), so
    callers never have to cap ``m`` themselves.
    """
    if m < 1:
        raise ValueError(f"m must be >= 1, got {m}")
    if N <= 1:
        raise ValueError(f"N must be > 1, got {N}")
    if m >= N:
        return 0.0
    return min(1.0 - (m - 1.0) / N, (1.0 - m / N) * (1.0 + 1.0 / m))


def u_term(eps: float, delta: float, value_range: float = 1.0) -> float:
    """``u = log(1/delta)/2 * (b-a)^2 / eps^2``  (Lemma 1).

    Returns ``inf`` (instead of raising ``OverflowError``) when the ratio
    overflows the float range — `m_required` clamps that to full coverage.
    """
    if not 0.0 < eps:
        raise ValueError(f"eps must be > 0, got {eps}")
    if not 0.0 < delta < 1.0:
        raise ValueError(f"delta must be in (0,1), got {delta}")
    try:
        return 0.5 * math.log(1.0 / delta) * (value_range / eps) ** 2
    except OverflowError:
        return math.inf


def m_required(eps: float, delta: float, N: int, value_range: float = 1.0) -> int:
    """Minimal without-replacement sample size for an ``(eps, delta)`` estimate.

    ``m(u) = min{ (u+1)/(1+u/N), (u + u/N)/(1+u/N) }`` (Eq. 4/6), with
    ``u = u_term(eps, delta, value_range)``.  Always ``<= N`` — the defining
    property that makes BoundedME never slower than exhaustive search.

    Edge behavior at full coverage: as ``eps -> 0`` the required ``u``
    overflows to ``inf`` and the Eq. 4 ratio degenerates to ``inf/inf``
    (pre-PR-5 this raised from ``ceil(nan)``); any non-finite ``u`` now
    clamps straight to ``N`` — at ``m = N`` the without-replacement
    variance is exactly zero (`rho_m` returns 0), so full coverage
    satisfies every ``eps > 0``.
    """
    if N <= 1:
        return 1
    u = u_term(eps, delta, value_range)
    if not math.isfinite(u):
        return N          # eps so small the sample size saturates the list
    if u <= 0.0:
        return 1
    m1 = (u + 1.0) / (1.0 + u / N)
    m2 = (u + u / N) / (1.0 + u / N)
    m = min(m1, m2)
    return max(1, min(N, int(math.ceil(m))))


def deviation_bound(m: int, N: int, delta: float, value_range: float = 1.0) -> float:
    """One-sided deviation eps(m, delta) from Corollary 1 (Eq. 2).

    ``P[ mean_hat - mean <= (b-a) sqrt(rho_m log(1/delta) / (2m)) ] >= 1-delta``.
    Useful for anytime confidence intervals on partially computed inner
    products (the "knob" of Motivation II, inverted).
    """
    if m >= N:
        return 0.0
    return value_range * math.sqrt(rho_m(m, N) * math.log(1.0 / delta) / (2.0 * m))


def bernstein_radius(m: int, N: int, delta: float, value_range: float = 1.0,
                     std: float = 0.0) -> float:
    """Two-sided empirical Bernstein–Serfling deviation radius.

    Bardenet & Maillard (2015), Theorem 3: when sampling ``m`` of ``N``
    values without replacement, with probability at least ``1 - delta``

        |mean_hat - mean| <= std_hat sqrt(2 rho_m log(5/delta) / m)
                             + kappa (b-a) log(5/delta) / m,

    with ``kappa = 7/3 + 3/sqrt(2)`` (`KAPPA_EB`) and ``std_hat`` the
    *empirical* (population-normalized, i.e. divide-by-m) standard
    deviation of the observed values.  This is the variance-aware radius
    family behind ``make_schedule(bound='bernstein')``: on low-variance
    reward lists the ``sqrt(Vhat)`` term collapses and the radius is
    dominated by the O(1/m) additive term, far below the Hoeffding radius
    at the same ``m`` — which is what lets the adaptive cascade certify
    easy queries rounds earlier (DESIGN.md §12).

    Returns exactly 0.0 for ``m >= N`` (full coverage: the empirical mean
    is the mean).  ``std`` is the empirical standard deviation observed so
    far; pass ``value_range / 2`` for the a-priori worst case.
    """
    if m < 1:
        raise ValueError(f"m must be >= 1, got {m}")
    if not 0.0 < delta < 1.0:
        raise ValueError(f"delta must be in (0,1), got {delta}")
    if std < 0.0:
        raise ValueError(f"std must be >= 0, got {std}")
    if m >= N:
        return 0.0
    lg = math.log(5.0 / delta)
    return (std * math.sqrt(2.0 * rho_m(m, N) * lg / m)
            + KAPPA_EB * value_range * lg / m)


def m_required_eb(eps: float, delta: float, N: int, value_range: float = 1.0,
                  std: Optional[float] = None) -> int:
    """Minimal sample size under the empirical-Bernstein–Serfling radius.

    The smallest ``m`` with ``bernstein_radius(m, N, delta, value_range,
    std) <= eps``, found by binary search (the radius is nonincreasing in
    ``m``: both ``rho_m / m`` and ``1/m`` shrink).  ``std`` defaults to the
    worst case ``value_range / 2``.  Like `m_required` this is clamped to
    ``[1, N]`` — full coverage (``m = N``, radius exactly 0) satisfies any
    ``eps > 0``, so the search always terminates and never relies on the
    caller to cap.
    """
    if not 0.0 < eps:
        raise ValueError(f"eps must be > 0, got {eps}")
    if N <= 1:
        return 1
    if std is None:
        std = value_range / 2.0
    lo, hi = 1, N
    while lo < hi:
        mid = (lo + hi) // 2
        if bernstein_radius(mid, N, delta, value_range, std) <= eps:
            hi = mid
        else:
            lo = mid + 1
    return lo


def coord_radius(m: int, d_blocks: int, delta: float, value_range: float = 1.0,
                 quant_err: float = 0.0) -> float:
    """Deviation radius of the coordinate-sampling estimator (BanditMIPS).

    The coordinate pull mode estimates each inner product ``<q, v_i>`` by
    sampling ``m`` of the ``d_blocks`` feature blocks *without replacement*
    under a shared per-query permutation; each observed block-mean is an
    unbiased reward whose per-observation range is ``value_range`` (the
    a-priori bound on a per-coordinate product, or the block-mean range
    under CLT calibration).  The radius is therefore the same
    Hoeffding–Serfling family as the row estimator — `deviation_bound` —
    but over the *feature-block* population ``N = d_blocks`` instead of
    the row-tile population, which is what makes the certified pull cost
    independent of the number of arms and sublinear in d.

    With quantized (int8) rewards each observation's range is widened by
    ``2 * quant_err`` (the rounding perturbation enters on both ends of
    the per-observation interval); the *deterministic* bias itself is
    budgeted by `coord_m_required` (``dev = eps - quant_err``), matching
    the ``Schedule.eps_effective`` accounting of the row estimator, so
    ``coord_radius(m, N, d, v, qe) == coord_radius(m, N, d, v + 2*qe, 0)``
    identically.

    Returns exactly 0.0 for ``m >= d_blocks`` (full coverage: the
    empirical block-mean is the inner product).  Monotone nonincreasing
    in ``m``.
    """
    if quant_err < 0.0:
        raise ValueError(f"quant_err must be >= 0, got {quant_err}")
    if m >= d_blocks:
        return 0.0
    return deviation_bound(m, d_blocks, delta, value_range + 2.0 * quant_err)


def coord_m_required(eps: float, delta: float, d_blocks: int,
                     value_range: float = 1.0, quant_err: float = 0.0) -> int:
    """Minimal coordinate-block sample count for an ``(eps, delta)`` estimate.

    Inverts `coord_radius`: the smallest ``m`` with
    ``coord_radius(m, d_blocks, delta, value_range, quant_err) <= eps``.
    The deterministic quantization bias is subtracted from the budget
    first (``dev = eps - quant_err``); if the bias alone exhausts the
    budget the only valid answer is full coverage ``m = d_blocks``
    (sampling cannot reduce a deterministic bias).  Like `m_required`,
    non-finite intermediate terms as ``eps → 0`` clamp to full coverage
    rather than raising — ``m = d_blocks`` has zero sampling error, so
    full coverage satisfies every ``eps >= quant_err``.  Always in
    ``[1, d_blocks]``.
    """
    if not 0.0 < eps:
        raise ValueError(f"eps must be > 0, got {eps}")
    if quant_err < 0.0:
        raise ValueError(f"quant_err must be >= 0, got {quant_err}")
    if d_blocks <= 1:
        return 1
    dev = eps - quant_err
    if dev <= 0.0:
        return d_blocks
    return m_required(dev, delta, d_blocks, value_range + 2.0 * quant_err)


def quantization_error(value_range: float, bits: int = 8) -> float:
    """Worst-case per-coordinate product error of symmetric quantization.

    With ``Q = 2^(bits-1) - 1`` levels per sign (127 for int8), symmetric
    round-to-nearest quantization ``v_hat = round(v / s_v)`` with
    ``s_v = v_max / Q`` (and likewise for the query) perturbs each
    per-coordinate product ``x = q_j * v_ij`` by at most

        |x - s_q s_v q_hat v_hat|
            <= q_max * s_v/2 + (v_max + s_v/2) * s_q/2
            <= q_max v_max * (1/Q + 1/(4 Q^2)).

    The a-priori product range bound feeding the schedule is
    ``value_range >= 2 q_max v_max`` (see `default_value_range`), so the
    returned bound is ``(value_range / 2) * (1/Q + 1/(4 Q^2))`` — the
    deterministic bias budget the quantized cascade's confidence radii
    must absorb (DESIGN.md §10).  Per-tile scales are never larger than
    the global ones, so this bound holds for tile-wise quantization too.
    """
    if value_range <= 0.0:
        raise ValueError(f"value_range must be > 0, got {value_range}")
    if bits < 2:
        raise ValueError(f"bits must be >= 2, got {bits}")
    q = float(2 ** (bits - 1) - 1)
    return (value_range / 2.0) * (1.0 / q + 1.0 / (4.0 * q * q))


def hoeffding_required(eps: float, delta: float, value_range: float = 1.0) -> int:
    """Classical i.i.d. Hoeffding sample size (no finite-population help).

    ``m >= (b-a)^2 log(1/delta) / (2 eps^2)`` — unbounded as eps → 0.
    """
    u = u_term(eps, delta, value_range)
    return max(1, int(math.ceil(u)))


def lil_required(eps: float, delta: float, value_range: float = 1.0) -> int:
    """Law-of-iterated-logarithm style sample size (Jamieson et al. 2014).

    Conservative closed form: ``m ~ (2/eps^2) (1+sqrt(e)) log(log(..)/delta)``.
    Included only as a baseline comparator for benchmarks.
    """
    c = (1.0 + math.sqrt(math.e)) * 2.0
    u = c * (value_range / eps) ** 2
    inner = max(math.e, math.log(max(math.e, u)) / delta)
    return max(1, int(math.ceil(u * math.log(inner))))
