"""BoundedME on the card: blocked pulls, tile elimination, static schedule.

The PyTorch counterpart of ``repro.core.boundedme_jax``.  The elimination
schedule is data-independent (`repro_torch.core.schedule`), so it is
computed on the host once per plan, and the whole cascade of a query
batch — every pull round, every tile elimination, the final top-K — runs
as ONE `repro_torch.kernels.ops.fused_cascade_batched` dispatch: the
hand-written CUDA kernel for CUDA tensors, its plain PyTorch version for
CPU tensors.

Adaptations versus the paper's per-arm algorithm (as in the JAX package):
  * a pull = one coordinate *block* of ``block`` (default 512) entries of
    an arm tile; the without-replacement bound applies with N -> N//block
    and block-mean rewards;
  * arms are eliminated in *tiles* of ``tile`` (default 8) rows ranked by
    the tile-max empirical mean;
  * one shared random block permutation per query batch.  Torch cannot
    reproduce ``jax.random``, so the permutation is an explicit argument
    here: callers draw it (the serving engine from a seeded
    ``torch.Generator``) or hand in the JAX package's.

This slice ports the fp32, non-adaptive decode path.  The quantized
tiers (int8, int4, pq) and adaptive early exit raise
``NotImplementedError``; ROADMAP.md lists them.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import bounds
from repro_torch.core.schedule import Schedule, flatten_schedule, make_schedule
from repro_torch.kernels import ops

__all__ = ["BlockedPlan", "make_plan", "choose_pull_mode", "resolve_device",
           "tile_table", "schedule_operands", "decode_tiled",
           "bounded_me_decode"]


@dataclasses.dataclass(frozen=True)
class BlockedPlan:
    """Static geometry + schedule for the blocked path."""

    n: int              # true number of arms
    N: int              # true vector dimension
    K: int
    tile: int           # arm-tile rows (elimination granularity)
    block: int          # coordinate-block width (pull granularity)
    n_tiles: int        # padded arm tiles
    n_blocks: int       # padded coordinate blocks
    schedule: Schedule  # over (n_tiles "arms", n_blocks "rewards", K_tiles)
    precision: str = "fp32"   # sampling arithmetic:
    #                           'fp32' | 'int8' | 'int4' | 'pq' (§10)
    pull_mode: str = "row"    # resolved reward stream: 'row' | 'coord' (§14)
    pq_subdims: int = 8       # pq subspace width w (codes per row = block/w)
    pq_codes: int = 16        # pq codebook size (uint8 codes, <= 256)

    @property
    def k_tiles(self) -> int:
        """Arm tiles that must survive to the final round: min(n_tiles, K).

        In the worst case each of the top-K arms sits in its own tile, so
        min(n_tiles, K) tiles must survive to the end (ceil(K/tile) would
        lose winners under adversarial placement).
        """
        return min(self.n_tiles, self.K)

    @property
    def k_out_cap(self) -> int:
        """Widest final extraction the cascade supports (`k_out` upper bound).

        The final top-K scans the ``n_final`` surviving tiles, i.e.
        ``n_final * tile`` candidate rows; no more than that many candidates
        exist to extract (padding rows included — callers mask those).
        """
        n_final = (self.schedule.rounds[-1].n_keep if self.schedule.rounds
                   else self.n_tiles)
        return n_final * self.tile

    @property
    def quant_err(self) -> float:
        """Per-block-mean quantization bias the schedule absorbs (0 = fp32)."""
        return self.schedule.quant_err

    @property
    def eps_effective(self) -> float:
        """Honest end-to-end eps bound incl. quantization (== eps at fp32).

        See `Schedule.eps_effective` and DESIGN.md §10: rounds whose
        budget absorbs the int8 bias stay eps_l-correct; saturated rounds
        contribute at most ``2 * quant_err`` each.
        """
        return self.schedule.eps_effective

    @property
    def total_multiplies(self) -> int:
        """FLOP-level sample complexity of the blocked schedule."""
        per_pull = self.tile * self.block
        return self.schedule.total_pulls * per_pull

    @property
    def naive_multiplies(self) -> int:
        """FLOPs of the exhaustive (n x N) matvec baseline."""
        return self.n * self.N

    @property
    def speedup(self) -> float:
        """FLOP-level speedup of the blocked schedule over exhaustive."""
        return self.naive_multiplies / max(1, self.total_multiplies)


def choose_pull_mode(row_plan: BlockedPlan, coord_plan: BlockedPlan, *,
                     row_margin: float = 0.10) -> str:
    """The hybrid dispatcher's decision rule (DESIGN.md §14, TUNING.md).

    Given the two fully priced candidate plans for the same
    ``(n, d, K, eps, delta)`` query geometry, returns ``'row'`` or
    ``'coord'`` — whichever plan's certified ``total_multiplies`` (the
    width-weighted cost `Schedule.total_coords` times the arm-tile rows)
    is cheaper.  Row pulls are wider tile-dots with better hardware
    utilization per multiply, so row mode is preferred whenever it is
    within ``row_margin`` (default 10%) of the coordinate plan; coord
    mode must beat row by more than the margin to win.  By construction
    the hybrid plan is therefore never more than ``row_margin`` worse
    than the better single mode — in multiplies, before hardware
    effects that favor the row shape further.
    """
    if not 0.0 <= row_margin:
        raise ValueError(f"row_margin must be >= 0, got {row_margin}")
    row_cost = row_plan.total_multiplies
    coord_cost = coord_plan.total_multiplies
    return "row" if row_cost <= coord_cost * (1.0 + row_margin) else "coord"


def make_plan(n: int, N: int, K: int = 1, eps: float = 0.1, delta: float = 0.05,
              value_range: float = 1.0, tile: int = 8, block: int = 512,
              range_mode: str = "clt",
              precision: str = "fp32",
              bound: str = "hoeffding",
              pull_mode: str = "row",
              coord_block: int = 128,
              quant_err: Optional[float] = None,
              pq_subdims: int = 8,
              pq_codes: int = 16) -> BlockedPlan:
    """Build the static plan.

    pull_mode:
      * 'row' (default) — pulls sample whole feature blocks of width
        ``min(block, N)`` per arm tile; per-pull cost grows with d until
        the block cap.
      * 'coord' — the BanditMIPS coordinate estimator (DESIGN.md §14):
        pulls sample *narrow* feature blocks of width ``min(coord_block,
        N)`` without replacement under a shared per-query permutation,
        so the schedule's reward population is ``n_blocks = ceil(N /
        coord_block)`` and the certified pull cost becomes sublinear in
        d.  Same kernel, same bounds — only the block geometry changes.
      * 'hybrid' — prices BOTH candidate plans and returns the cheaper
        by `choose_pull_mode` (row preferred within a 10% multiply
        margin, since row pulls are wider tile-dots); the returned
        plan's ``pull_mode`` is the resolved concrete mode.

    range_mode:
      * 'exact' — block means are bounded by the per-coordinate product range
        (strictly valid, maximally conservative: blocking buys no statistical
        tightening, only hardware efficiency);
      * 'clt' (default) — block means of ``block`` weakly-dependent products
        concentrate ~ range/sqrt(block); the (eps, delta) knob is then
        calibrated on this tighter effective range.  This is a modeling
        assumption (same spirit as the paper's rewards-in-[0,1] assumption)
        and is validated empirically by the fig-1 harness.

    precision:
      * 'fp32' (default) — sampling rounds pull fp32 tiles;
      * 'int8' — sampling rounds pull int8-quantized tiles and the
        schedule's confidence radii are widened by the worst-case
        quantization bias (`bounds.quantization_error`, scaled like the
        value range under ``range_mode``), so the (eps, delta) calibration
        survives quantization (DESIGN.md §10).  Final candidates are
        rescored in fp32 whenever ``final_exact=True``.
      * 'int4' — nibble-packed tiles (half the int8 bytes per pull) under
        the 15-level worst-case bias by default; ``block`` must be even.
      * 'pq' — per-subspace product quantization (``block / pq_subdims``
        bytes per row per pull).  No closed-form bias exists, so a
        **measured** ``quant_err`` is REQUIRED — pass the output of
        `measured_plan_quant_err`, or build the plan with
        `make_measured_plan` which calibrates it for you.

    quant_err:
      Explicit per-pull bias bound on the block-mean scale (what
      `measured_quant_err` returns).  When given it feeds
      ``make_schedule(quant_err=...)`` as-is — NO ``range_mode`` rescale,
      the measurement already lives on the block-mean scale — and
      overrides the tier's worst-case default.  The measured-vs-worst-case
      trade is DESIGN.md §10: measured bounds are far tighter (so rounds
      keep their full deviation budget) but only as representative as the
      calibration queries; the safety factor covers the gap.

    bound:
      * 'hoeffding' (default) — the adaptive path certifies early exit
        with the schedule's own Hoeffding–Serfling radii (zero extra delta
        cost; the round plan is identical to the non-adaptive one);
      * 'bernstein' — certification uses the variance-aware empirical
        Bernstein–Serfling radii with per-tile running mean/M2
        accumulators (`repro.core.schedule.cert_coeffs`, DESIGN.md §12).
    """
    if pull_mode == "hybrid":
        kwargs = dict(K=K, eps=eps, delta=delta, value_range=value_range,
                      tile=tile, range_mode=range_mode, precision=precision,
                      bound=bound, coord_block=coord_block,
                      quant_err=quant_err, pq_subdims=pq_subdims,
                      pq_codes=pq_codes)
        row_plan = make_plan(n, N, block=block, pull_mode="row", **kwargs)
        coord_plan = make_plan(n, N, block=block, pull_mode="coord", **kwargs)
        winner = choose_pull_mode(row_plan, coord_plan)
        return row_plan if winner == "row" else coord_plan
    if pull_mode == "coord":
        if coord_block < 1:
            raise ValueError(f"coord_block must be >= 1, got {coord_block}")
        block = coord_block       # narrow feature tiles: N becomes d_blocks
    elif pull_mode != "row":
        raise ValueError(f"unknown pull_mode {pull_mode!r} "
                         f"(expected 'row', 'coord' or 'hybrid')")
    block = min(block, N)
    tile = min(tile, n)
    n_tiles = -(-n // tile)
    n_blocks = -(-N // block)
    k_tiles = min(n_tiles, K)
    if precision not in ("fp32", "int8", "int4", "pq"):
        raise ValueError(f"unknown precision {precision!r} "
                         f"(expected 'fp32', 'int8', 'int4' or 'pq')")
    if precision == "int4" and block % 2 != 0:
        raise ValueError(f"precision='int4' needs an even pull width to "
                         f"nibble-pack, got block={block}")
    if precision == "pq":
        if not 1 <= pq_subdims or block % pq_subdims != 0:
            raise ValueError(f"precision='pq' needs pull width divisible "
                             f"by pq_subdims, got block={block}, "
                             f"pq_subdims={pq_subdims}")
        if not 1 <= pq_codes <= 256:
            raise ValueError(f"pq_codes must be in [1, 256], got {pq_codes}")
        if quant_err is None:
            raise ValueError(
                "precision='pq' has no closed-form error bound: pass "
                "quant_err=measured_plan_quant_err(V, precision='pq', ...) "
                "or build the plan with make_measured_plan(V, ...)")
    if quant_err is not None:
        if quant_err < 0:
            raise ValueError(f"quant_err must be >= 0, got {quant_err}")
        qerr = float(quant_err)  # measured, already on the block-mean scale
    elif precision in ("int8", "int4"):
        qerr = bounds.quantization_error(value_range,
                                         bits=8 if precision == "int8" else 4)
    else:
        qerr = 0.0
    if range_mode == "clt":
        eff_range = value_range / math.sqrt(block)
        if quant_err is None:
            qerr = qerr / math.sqrt(block)   # the bias concentrates like the
            # products themselves: rounding errors are weakly dependent across
            # the block, so the block-mean bias shrinks ~ 1/sqrt(block) under
            # the same modeling assumption as eff_range.  A measured qerr is
            # NOT rescaled: it is already a block-mean quantity.
    elif range_mode == "exact":
        eff_range = value_range
    else:
        raise ValueError(f"unknown range_mode {range_mode!r}")
    sched = make_schedule(n_tiles, n_blocks, K=k_tiles, eps=eps, delta=delta,
                          value_range=eff_range, quant_err=qerr, bound=bound,
                          pull_mode=pull_mode, pull_width=block)
    return BlockedPlan(n=n, N=N, K=K, tile=tile, block=block, n_tiles=n_tiles,
                       n_blocks=n_blocks, schedule=sched, precision=precision,
                       pull_mode=pull_mode, pq_subdims=pq_subdims,
                       pq_codes=pq_codes)


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; raises when CUDA is asked for
    but absent (entry points default to ``"cuda"`` and run on the CPU only
    when the caller asks)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the plain PyTorch version on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _check_fp32_decode(plan: BlockedPlan) -> None:
    if plan.precision != "fp32":
        raise NotImplementedError(
            f"precision={plan.precision!r} is not ported yet: the int8, "
            f"int4 and pq tiers of the fused cascade are ROADMAP queue 2 "
            f"item 1 (and queue 1 item 3(c)); only 'fp32' runs")


def _pad_operands(V: Optional[torch.Tensor], Q: Optional[torch.Tensor],
                  plan: BlockedPlan
                  ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Zero-pad the table to (n_tiles*tile, n_blocks*block) and the
    queries to n_blocks*block columns; either may be None.

    Zero coordinate padding rescales every arm's blocked mean by the same
    N/(n_blocks*block) factor — the top-K ranking is unchanged.  Zero arm
    padding is masked out of every ranking via ``n_valid``.
    """
    c_pad = plan.n_blocks * plan.block - plan.N
    if V is not None:
        n_pad = plan.n_tiles * plan.tile - V.shape[0]
        if n_pad or c_pad:
            V = torch.nn.functional.pad(V, (0, c_pad, 0, n_pad))
    if Q is not None and c_pad:
        Q = torch.nn.functional.pad(Q, (0, c_pad))
    return V, Q


def _tile_major(V: torch.Tensor, plan: BlockedPlan) -> torch.Tensor:
    """(n_tiles*R, n_blocks*C) -> contiguous (n_tiles, n_blocks, R, C)."""
    R, C = plan.tile, plan.block
    return (V.reshape(plan.n_tiles, R, plan.n_blocks, C)
            .permute(0, 2, 1, 3).contiguous())


def tile_table(V, plan: BlockedPlan, device="cuda") -> torch.Tensor:
    """The (n, N) table padded and re-laid tile-major on ``device``.

    A static table is re-laid once and reused by every dispatch
    (`repro_torch.launch.engine.CascadeExecutor` does so).
    """
    dev = resolve_device(device)
    V = torch.as_tensor(V, dtype=torch.float32).to(dev)
    if V.shape != (plan.n, plan.N):
        raise ValueError(f"table shape {tuple(V.shape)} != plan's "
                         f"{(plan.n, plan.N)}")
    Vp, _ = _pad_operands(V, None, plan)
    return _tile_major(Vp, plan)


@functools.lru_cache(maxsize=32)
def schedule_operands(sched: Schedule, final_coverage: bool,
                       device: torch.device):
    """Device copies of the flat schedule, built once per (plan, device).

    Returns ``(slotcode (S,) int32, rounds_meta (n_rounds + 1, 3) int32,
    bpos (S,) int64, t_final, n_final)``; a batch's pull columns are
    ``perm[bpos]``.
    """
    flat = flatten_schedule(sched, final_coverage=final_coverage)
    slotcode, rmeta = flat.packed()
    return (torch.as_tensor(slotcode, device=device),
            torch.as_tensor(rmeta, device=device),
            torch.as_tensor(flat.bpos.astype(np.int64), device=device),
            flat.t_final, flat.n_final)


def _check_perm(perm, n_blocks: int, device: torch.device) -> torch.Tensor:
    p = torch.as_tensor(perm)
    host = p.detach().cpu().numpy()
    if host.shape != (n_blocks,) or not np.array_equal(np.sort(host),
                                                       np.arange(n_blocks)):
        raise ValueError(f"perm must be a permutation of range({n_blocks}), "
                         f"got shape {tuple(host.shape)}")
    return p.to(device=device, dtype=torch.int64)


def _fused_call(V4: torch.Tensor, Qb: torch.Tensor, perm: torch.Tensor, *,
                plan: BlockedPlan, final_exact: bool, k_out: int,
                n_valid: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch the whole cascade as exactly one fused-cascade launch.

    ``final_exact`` appends coverage steps that complete every final
    survivor to all ``n_blocks`` columns, so the returned block means are
    exact.  All queries of the batch share ``perm``.
    """
    slotcode, rmeta, bpos, t_final, n_final = schedule_operands(
        plan.schedule, bool(final_exact), V4.device)
    cols = perm[bpos].to(torch.int32).expand(Qb.shape[0], -1).contiguous()
    return ops.fused_cascade_batched(
        V4, Qb, slotcode, rmeta, cols, n_arms=plan.n, K=plan.K,
        t_final=t_final, n_final=n_final, k_out=k_out, n_valid=n_valid)


def decode_tiled(V4: torch.Tensor, Q, perm, *, plan: BlockedPlan,
                 final_exact: bool = True, k_out: Optional[int] = None,
                 n_valid: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`bounded_me_decode` on a table already laid out by `tile_table`.

    Runs on ``V4``'s device; ``Q`` and ``perm`` are moved there.
    """
    _check_fp32_decode(plan)
    if k_out is None:
        k_out = plan.K
    if not plan.K <= k_out <= plan.k_out_cap:
        raise ValueError(f"k_out={k_out} outside [K={plan.K}, "
                         f"k_out_cap={plan.k_out_cap}]")
    n_valid = plan.n if n_valid is None else int(n_valid)
    dev = V4.device
    Q = torch.as_tensor(Q, dtype=torch.float32).to(dev)
    if Q.dim() != 2 or Q.shape[1] != plan.N:
        raise ValueError(f"Q must be (B, {plan.N}), got {tuple(Q.shape)}")
    _, Qp = _pad_operands(None, Q, plan)
    Qb = Qp.reshape(Q.shape[0], plan.n_blocks, plan.block).contiguous()
    perm = _check_perm(perm, plan.n_blocks, dev)
    ids, vals = _fused_call(V4, Qb, perm, plan=plan, final_exact=final_exact,
                            k_out=k_out, n_valid=n_valid)
    # undo the zero-padding rescale so scores estimate (q . v)/N
    scale = torch.tensor((plan.n_blocks * plan.block) / plan.N,
                         dtype=torch.float32, device=dev)
    return ids, vals * scale


def bounded_me_decode(V, Q, perm, *, plan: BlockedPlan,
                      final_exact: bool = True, k_out: Optional[int] = None,
                      n_valid: Optional[int] = None, adaptive: bool = False,
                      device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched-decode BoundedME: one dispatch for a whole (B, N) batch.

    The serving hot path.  All queries share the block permutation
    ``perm``, an ``(n_blocks,)`` integer permutation of
    ``range(plan.n_blocks)``; survivor sets and eliminations stay fully
    per-query.

    Args:
      V: (n, N) item/arm matrix (rows are arms).
      Q: (B, N) query batch.
      perm: the shared block permutation (explicit: torch cannot
        reproduce ``jax.random.permutation``).
      plan: static :class:`BlockedPlan` from :func:`make_plan`; must match
        ``V``'s (n, N).  Only ``precision='fp32'`` is ported.
      final_exact: complete every final survivor to full coverage inside
        the cascade, so returned scores are exact mean products (q . v)/N
        instead of block-mean estimates.
      k_out: candidates returned per query (default ``plan.K``), with
        ``plan.K <= k_out <= plan.k_out_cap``.
      n_valid: rows >= n_valid never win a ranking (default ``plan.n``).
      adaptive: not ported yet (ROADMAP queue 1 item 3(d)); raises.
      device: where the cascade runs.  The default ``"cuda"`` launches
        the CUDA kernel and raises when there is no card; ``"cpu"`` runs
        the plain PyTorch version.

    Returns:
      ``(ids (B, k_out) int32, scores (B, k_out) float32)`` sorted by
      descending score.  Entries past the live rows carry ``-inf`` scores.
    """
    if adaptive:
        raise NotImplementedError("adaptive early exit is not ported yet "
                                  "(ROADMAP queue 1 item 3(d))")
    _check_fp32_decode(plan)
    V4 = tile_table(V, plan, device)
    return decode_tiled(V4, Q, perm, plan=plan, final_exact=final_exact,
                        k_out=k_out, n_valid=n_valid)
