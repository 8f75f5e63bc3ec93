"""Static elimination schedules for BoundedME (a copy of
``repro.core.schedule``; the port imports nothing of the JAX package).

The key systems observation (DESIGN.md §3): lines 7-11 of Algorithm 1
reference only (|S_l|, K, eps_l, delta_l, N) — never the data.  Given (n, N,
K, eps, delta) the entire round structure (survivor counts, cumulative pull
counts) is therefore *data independent* and can be computed on the host once
per plan.  The fused CUDA kernel walks it as a fixed program of pulls and
eliminations.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import numpy as np

from repro_torch.core import bounds

__all__ = ["Round", "Schedule", "FlatSchedule", "make_schedule",
           "flatten_schedule", "cert_coeffs", "pulls_through_round",
           "SLOT_MASK", "END_BIT", "PULL_BIT"]

# bit-packing of the per-step word handed to the fused kernel (one int32
# per step instead of a wide row)
SLOT_MASK = (1 << 29) - 1   # survivor-slot index (n_tiles << 2^29 always)
END_BIT = 1 << 29           # eliminate after this step
PULL_BIT = 1 << 30          # step performs a pull (0 on saturated rounds)


@dataclasses.dataclass(frozen=True)
class Round:
    """One elimination round of Algorithm 1 (static view)."""

    index: int          # l (1-based)
    n_arms: int         # |S_l| at the start of the round
    n_keep: int         # |S_{l+1}| = K + floor((|S_l|-K)/2)
    t_cum: int          # t_l: cumulative pulls per surviving arm
    t_new: int          # t_l - t_{l-1}: pulls issued this round
    eps_l: float
    delta_l: float


@dataclasses.dataclass(frozen=True)
class Schedule:
    """The full static pull/elimination plan."""

    n: int              # number of arms (a tile count on the blocked path)
    N: int              # reward-list length (may be a block count)
    K: int
    eps: float
    delta: float
    value_range: float
    rounds: Tuple[Round, ...]  # tuple => hashable => usable as a cache key
    quant_err: float = 0.0     # per-reward bias absorbed by the bounds (§10)
    bound: str = "hoeffding"   # radius family: 'hoeffding' | 'bernstein'
    pull_mode: str = "row"     # reward stream: 'row' | 'coord' (DESIGN.md §14)
    pull_width: int = 1        # coordinates touched per pull (honest cost)

    @property
    def total_pulls(self) -> int:
        """Exact sample complexity (sum over rounds of survivors x new pulls)."""
        return sum(r.n_arms * r.t_new for r in self.rounds)

    @property
    def total_coords(self) -> int:
        """Honest cross-mode cost: coordinates touched, not pulls issued.

        A 'row'-mode pull and a 'coord'-mode pull are different units of
        work — a row pull reads ``pull_width`` = block coordinates of one
        arm tile, a coord pull reads ``pull_width`` = coord_block of them.
        ``total_pulls`` alone would make narrow pulls look free;
        ``total_coords = total_pulls * pull_width`` is the width-weighted
        count that `BlockedPlan.total_multiplies` and the hybrid
        dispatcher compare across pull modes (DESIGN.md §14).
        """
        return self.total_pulls * self.pull_width

    @property
    def naive_pulls(self) -> int:
        """Pulls of the exhaustive baseline: every arm's full reward list."""
        return self.n * self.N

    @property
    def speedup(self) -> float:
        """Pull-count speedup over exhaustive search (>= 1 by Corollary 2)."""
        return self.naive_pulls / max(1, self.total_pulls)

    @property
    def final_pulls(self) -> int:
        """Cumulative pulls per arm surviving to the last round (t_L)."""
        return self.rounds[-1].t_cum if self.rounds else 0

    @property
    def eps_effective(self) -> float:
        """The honest end-to-end suboptimality bound under ``quant_err``.

        Rounds whose per-round budget absorbs the quantization bias
        (``eps_l / 2 > quant_err``) stay eps_l-correct; rounds where it
        cannot are driven to full coverage, where the only remaining error
        is the bias of the two compared estimates, ``<= 2 * quant_err``.
        Summing the per-round errors gives

            eps_eff = eps + sum_{l : eps_l <= 2 quant_err}
                                  (2 quant_err - eps_l)

        which collapses to ``eps`` as ``quant_err -> 0`` (DESIGN.md §10).
        """
        if self.quant_err <= 0.0:
            return self.eps
        penalty = sum(max(0.0, 2.0 * self.quant_err - r.eps_l)
                      for r in self.rounds)
        return self.eps + penalty


@dataclasses.dataclass(frozen=True)
class FlatSchedule:
    """The schedule unrolled to one row per kernel step (DESIGN.md §3).

    The fused cascade kernel runs the entire multi-round pull program as a
    single launch; it reads these arrays to tell, at every step, which
    survivor slot to pull, which position of the block permutation to read,
    and whether an elimination happens after the step.  Everything here is
    host-side numpy computed once per plan.

    Step layout per round: blocks outermost, survivor slots innermost, so a
    given arm tile accumulates its coordinate blocks in permutation order.
    The CUDA kernel and the plain PyTorch version both rely on this: each
    tile's accumulator receives its own pulls in that order.
    Rounds whose pull budget is already saturated (``t_new == 0``) still
    eliminate, so they emit one no-pull step carrying the round-end flag.

    With ``final_coverage=True`` extra pull steps are appended that complete
    every final survivor to full coverage (``t -> N``): the final scores are
    then *exact* inner products, the single-dispatch analogue of the
    ``final_exact`` rescore on the unfused path.
    """

    slot: np.ndarray      # (S,) int32  survivor-slot pulled this step
    bpos: np.ndarray      # (S,) int32  index into the block permutation
    is_pull: np.ndarray   # (S,) int32  0 on no-op steps (saturated rounds)
    is_end: np.ndarray    # (S,) int32  1 => eliminate after this step
    t_cum: np.ndarray     # (S,) int32  cumulative pulls of the current round
    n_surv: np.ndarray    # (S,) int32  survivors during this step's round
    n_keep: np.ndarray    # (S,) int32  survivors kept at the elimination
    t_final: int          # pulls per survivor entering the final top-K
    n_final: int          # survivor count entering the final top-K

    @property
    def n_steps(self) -> int:
        """Total kernel steps (pull + no-op elimination steps)."""
        return int(self.slot.shape[0])

    def stacked(self) -> np.ndarray:
        """(S, 7) int32 view — handy for oracles and debugging."""
        return np.stack([self.slot, self.bpos, self.is_pull, self.is_end,
                         self.t_cum, self.n_surv, self.n_keep],
                        axis=1).astype(np.int32)

    def packed(self) -> Tuple[np.ndarray, np.ndarray]:
        """Compact kernel operands.

        Returns ``(slotcode (S,), rounds_meta (n_rounds+1, 3))``: the
        per-step word packs slot | PULL_BIT | END_BIT; the per-round rows
        are ``(t_cum, n_surv, n_keep)`` consumed in order at end-flagged
        steps (the kernel keeps a round cursor).  The pad row keeps
        the array non-empty for schedules with no elimination rounds.
        """
        code = (self.slot.astype(np.int64)
                | self.is_pull.astype(np.int64) * PULL_BIT
                | self.is_end.astype(np.int64) * END_BIT)
        ends = np.nonzero(self.is_end)[0]
        meta = np.stack([self.t_cum[ends], self.n_surv[ends],
                         self.n_keep[ends]], axis=1).reshape(-1, 3)
        meta = np.concatenate([meta, np.zeros((1, 3), np.int64)], axis=0)
        return code.astype(np.int32), meta.astype(np.int32)


def flatten_schedule(sched: Schedule, *,
                     final_coverage: bool = False) -> FlatSchedule:
    """Unroll ``sched`` into the per-step arrays of :class:`FlatSchedule`."""
    slot: List[int] = []
    bpos: List[int] = []
    is_pull: List[int] = []
    is_end: List[int] = []
    t_cum: List[int] = []
    n_surv: List[int] = []
    n_keep: List[int] = []

    def emit(s, p, pull, end, t, T, k):
        slot.append(s); bpos.append(p); is_pull.append(pull)
        is_end.append(end); t_cum.append(t); n_surv.append(T); n_keep.append(k)

    t_prev = 0
    for r in sched.rounds:
        if r.t_new == 0:
            emit(0, 0, 0, 1, r.t_cum, r.n_arms, r.n_keep)
        else:
            for p in range(t_prev, r.t_cum):
                for s in range(r.n_arms):
                    last = (p == r.t_cum - 1) and (s == r.n_arms - 1)
                    emit(s, p, 1, 1 if last else 0, r.t_cum, r.n_arms,
                         r.n_keep)
        t_prev = r.t_cum

    n_final = sched.rounds[-1].n_keep if sched.rounds else sched.n
    t_final = t_prev
    if final_coverage and t_prev < sched.N:
        for p in range(t_prev, sched.N):
            for s in range(n_final):
                emit(s, p, 1, 0, sched.N, n_final, n_final)
        t_final = sched.N
    if not slot:  # degenerate: no rounds, no coverage — one no-op step so
        emit(0, 0, 0, 0, 0, n_final, n_final)  # the kernel still finalizes

    return FlatSchedule(
        slot=np.asarray(slot, np.int32), bpos=np.asarray(bpos, np.int32),
        is_pull=np.asarray(is_pull, np.int32),
        is_end=np.asarray(is_end, np.int32),
        t_cum=np.asarray(t_cum, np.int32),
        n_surv=np.asarray(n_surv, np.int32),
        n_keep=np.asarray(n_keep, np.int32),
        t_final=t_final, n_final=n_final)


def cert_coeffs(sched: Schedule) -> np.ndarray:
    """Per-round certification-radius coefficients for adaptive early exit.

    Returns ``(n_rounds + 1, 2) float32`` rows ``(a_l, b_l)`` (one pad row
    so the array is never empty, mirroring `FlatSchedule.packed`): at the
    end of round ``l`` every surviving arm's confidence radius on the
    block-mean reward scale is

        r_i = a_l * sqrt(max(Vhat_i, 0)) + b_l

    with ``Vhat_i`` the arm's empirical (divide-by-m) reward variance.
    The kernel and both jnp fallbacks evaluate exactly this expression at
    round boundaries and certify a query — freezing its remaining pulls —
    when the top-K arms' lower bounds clear every other survivor's upper
    bound (DESIGN.md §12).

    Budget accounting (why early exit preserves the union bound):

      * ``bound='hoeffding'`` — ``a_l = 0`` and ``b_l`` is the
        Hoeffding–Serfling `deviation_bound` at the round's cumulative
        pulls and the *same* per-arm-per-side budget `_round_pulls` sized
        the round with: certification reads the very events the schedule
        already paid for, so it adds zero failure probability.
      * ``bound='bernstein'`` — ``(a_l, b_l)`` come from the two-sided
        empirical Bernstein–Serfling radius (`bounds.bernstein_radius`) at
        the per-arm budget `_round_pulls` reserved for it (the sizing half
        ran at ``delta_eff / 2``).

    Both families add the schedule's ``quant_err`` to ``b_l`` — on the
    int8 path the certification radii absorb the deterministic
    quantization bias exactly as the sizing radii do (the *eps_effective*
    calibration of DESIGN.md §10), and the width is computed on the
    quantized reward range ``value_range + 2 quant_err``.
    """
    rng_w = sched.value_range + 2.0 * sched.quant_err
    rows = []
    for r in sched.rounds:
        gap = r.n_arms - sched.K
        # delta_eff is the PER-SIDE sizing budget of `_round_pulls`: the
        # per-arm round budget is beta = 2 * delta_eff.  Accounting:
        #   hoeffding  — sizing spends beta (two sides at delta_eff each)
        #                and certification re-reads those same events;
        #   bernstein  — sizing ran at delta_eff/2 per side (beta/2 total),
        #                so the two-sided EB event below may spend the
        #                remaining beta/2 = delta_eff.  Totals stay <= beta.
        delta_eff = r.delta_l * (gap // 2 + 1) / (2.0 * gap)
        m = r.t_cum
        if sched.bound == "bernstein":
            if m >= sched.N:
                a = b = 0.0
            else:
                lg = math.log(5.0 / delta_eff)
                a = math.sqrt(2.0 * bounds.rho_m(m, sched.N) * lg / m)
                b = bounds.KAPPA_EB * rng_w * lg / m
        else:
            a = 0.0
            b = bounds.deviation_bound(m, sched.N, delta_eff, rng_w)
        rows.append((a, b + sched.quant_err))
    rows.append((0.0, 0.0))                      # pad row, never indexed
    return np.asarray(rows, np.float32)


def pulls_through_round(sched: Schedule) -> np.ndarray:
    """Cumulative *executed* pull count after each possible exit round.

    ``out[r]`` for ``r in [0, n_rounds]`` is the total number of
    (arm, block) pulls the cascade has issued once ``rounds_used == r``
    rounds have run: ``out[0] = 0`` and ``out[n_rounds] ==
    Schedule.total_pulls``.  This is the lookup `benchmarks/bench_adaptive`
    and the serve engine use to convert a per-query ``rounds_used`` into
    the paper's sample-complexity metric.
    """
    out = [0]
    for r in sched.rounds:
        out.append(out[-1] + r.n_arms * r.t_new)
    return np.asarray(out, np.int64)


def _round_pulls(n_l: int, K: int, eps_l: float, delta_l: float, N: int,
                 value_range: float, quant_err: float = 0.0,
                 bound: str = "hoeffding") -> int:
    """t_l of Algorithm 1, line 7 (expanded per the Lemma 4 proof).

    Each arm needs an (eps_l/2, delta'_l/2)-accurate estimate where
    ``delta'_l = delta_l (floor((n_l-K)/2)+1) / (n_l-K)`` is the per-arm
    budget and the factor 2 covers the two one-sided deviation events.

    With ``quant_err > 0`` (the int8 sampling path, DESIGN.md §10) each
    estimate additionally carries a deterministic bias of at most
    ``quant_err``, so the *sampling* deviation target shrinks to
    ``eps_l/2 - quant_err`` and the reward range widens by ``2 quant_err``
    (the quantized reward list's range).  Rounds whose budget cannot absorb
    the bias (``eps_l/2 <= quant_err``) are driven to full coverage
    (``t_l = N``), leaving only the bias; `Schedule.eps_effective` accounts
    for those.

    With ``bound='bernstein'`` (DESIGN.md §12) half of each arm's round
    budget is reserved for the per-round empirical-Bernstein certification
    events of the adaptive early-exit path, so the sizing confidence drops
    to ``delta_eff / 2`` (slightly more pulls per round); the Hoeffding
    default reuses the sizing events for certification and reserves
    nothing.
    """
    gap = n_l - K
    if gap <= 0:
        return 0
    delta_eff = delta_l * (gap // 2 + 1) / (2.0 * gap)
    if bound == "bernstein":
        delta_eff /= 2.0   # the other half funds the EB certification
    dev = eps_l / 2.0 - quant_err
    if dev <= 0.0:
        return N          # sampling cannot absorb the bias: full coverage
    # deviation eps_l/2 (minus the bias budget), confidence delta_eff
    return bounds.m_required(dev, delta_eff, N,
                             value_range + 2.0 * quant_err)


def make_schedule(n: int, N: int, K: int = 1, eps: float = 0.1,
                  delta: float = 0.05, value_range: float = 1.0,
                  quant_err: float = 0.0,
                  bound: str = "hoeffding",
                  pull_mode: str = "row",
                  pull_width: int = 1) -> Schedule:
    """Build the static round plan of Algorithm 1.

    eps_1 = eps/4, delta_1 = delta/2; eps_{l+1} = 3/4 eps_l,
    delta_{l+1} = delta_l/2; each round keeps K + floor((|S_l|-K)/2) arms.
    Cumulative pull counts are clamped to be nondecreasing and <= N.
    ``quant_err`` widens every round's pull count so a per-reward bias of
    that size (low-precision sampling arithmetic) is absorbed into the
    confidence radii (see `_round_pulls` and DESIGN.md §10).

    ``pull_mode`` records which reward stream the schedule prices
    (DESIGN.md §14) and ``pull_width`` how many coordinates one pull
    touches, feeding `Schedule.total_coords`:

      * 'row' (default) — rewards are block-means of whole feature blocks
        per arm tile; ``N`` is the feature-block count at the row block
        width (typically ``min(512, d)``).
      * 'coord' — the BanditMIPS coordinate estimator: rewards are means
        of *narrow* feature blocks sampled without replacement under a
        shared per-query permutation, so ``N = d_blocks = ceil(d /
        coord_block)`` is larger and each pull is cheaper.  The round
        structure is identical — the Hoeffding–Serfling / Bernstein
        machinery only sees the population size ``N`` — which is why the
        whole kernel path is reused unchanged.

    The composite 'hybrid' mode is *not* a schedule-level concept: it is
    resolved to 'row' or 'coord' by ``make_plan`` (which prices both
    candidate plans and keeps the cheaper; see
    `repro_torch.core.boundedme_torch.choose_pull_mode`), so passing it here
    raises.

    ``bound`` selects the radius family the adaptive early-exit path uses
    to certify queries at round boundaries (`cert_coeffs`, DESIGN.md §12):

      * 'hoeffding' (default) — certification reuses the schedule's own
        Hoeffding–Serfling sizing events at no extra delta cost; the round
        plan is *identical* to the non-adaptive one.
      * 'bernstein' — certification uses the variance-aware empirical
        Bernstein–Serfling radius (`bounds.bernstein_radius`, with running
        mean/M2 accumulators carried per surviving tile at run time);
        those are new events, so each round's sizing confidence is halved
        to reserve budget for them (slightly more pulls per round, much
        earlier certification on low-variance data).
    """
    if n < 1 or N < 1:
        raise ValueError(f"need n,N >= 1, got n={n} N={N}")
    if quant_err < 0.0:
        raise ValueError(f"quant_err must be >= 0, got {quant_err}")
    if bound not in ("hoeffding", "bernstein"):
        raise ValueError(f"unknown bound {bound!r} "
                         f"(expected 'hoeffding' or 'bernstein')")
    if pull_mode == "hybrid":
        raise ValueError(
            "pull_mode='hybrid' is resolved by make_plan (it prices both "
            "candidate plans via choose_pull_mode); make_schedule only "
            "accepts the concrete modes 'row' and 'coord'")
    if pull_mode not in ("row", "coord"):
        raise ValueError(f"unknown pull_mode {pull_mode!r} "
                         f"(expected 'row' or 'coord')")
    if pull_width < 1:
        raise ValueError(f"pull_width must be >= 1, got {pull_width}")
    if K >= n:
        return Schedule(n, N, K, eps, delta, value_range, (), quant_err,
                        bound, pull_mode, pull_width)
    rounds: List[Round] = []
    n_l, eps_l, delta_l, t_prev, l = n, eps / 4.0, delta / 2.0, 0, 1
    while n_l > K:
        t_l = _round_pulls(n_l, K, eps_l, delta_l, N, value_range, quant_err,
                           bound)
        t_l = min(N, max(t_l, t_prev))  # nondecreasing, saturates at N
        n_keep = K + (n_l - K) // 2
        rounds.append(Round(index=l, n_arms=n_l, n_keep=n_keep, t_cum=t_l,
                            t_new=t_l - t_prev, eps_l=eps_l, delta_l=delta_l))
        n_l, t_prev, l = n_keep, t_l, l + 1
        eps_l, delta_l = 0.75 * eps_l, 0.5 * delta_l
    return Schedule(n, N, K, eps, delta, value_range, tuple(rounds),
                    quant_err, bound, pull_mode, pull_width)
