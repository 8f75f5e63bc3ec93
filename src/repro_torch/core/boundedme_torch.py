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
  * one random block permutation per query batch (`bounded_me_decode`)
    or per query (`bounded_me_blocked`, `bounded_me_batched`).  Torch
    cannot reproduce ``jax.random``, so permutations are explicit
    arguments here: callers hand them in (the tests hand in the JAX
    package's) or they are drawn from a seeded ``torch.Generator``
    (`draw_perms`).

Every entry runs every tier of the JAX package: fp32, int8 and int4
(quantized table cells, int8 queries), pq (codes against a per-block
codebook, f32 queries), each with or without adaptive early exit.  On
the quantized tiers and with early exit the returned scores are made
exact by an fp32 rescore of the candidates, as in the JAX package.  The
single-query entry `bounded_me_blocked` runs its cascade as one
`repro_torch.kernels.ops.fused_cascade` dispatch; the batched entries as
one `fused_cascade_batched` dispatch.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import weakref
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import bounds
from repro_torch.core.quantize import (measured_quant_err, pq_encode,
                                       pq_train, quantize_blocks,
                                       quantize_tiles, quantize_tiles_int4)
from repro_torch.core.schedule import (Schedule, cert_coeffs,
                                       flatten_schedule, make_schedule)
from repro_torch.kernels import ops
from repro_torch.obs.trace import span

__all__ = ["BlockedPlan", "make_plan", "choose_pull_mode", "resolve_device",
           "as_kept", "tile_table", "quantize_table",
           "measured_plan_quant_err",
           "make_measured_plan", "schedule_operands", "cert_operand",
           "decode_operands", "decode_tiled", "bounded_me_decode",
           "outside_simulated_ranks",
           "draw_perms", "bounded_me_blocked", "bounded_me_batched"]


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


#: float types a table or a query batch keeps; any other is cast to float32
_KEPT_DTYPES = (torch.float32, torch.bfloat16)


def as_kept(x, device) -> torch.Tensor:
    """``x`` as a tensor on ``device``, in its own type when that is
    float32 or bfloat16 (as the JAX package keeps a table's or a hidden
    state's dtype), else float32."""
    x = torch.as_tensor(x)
    if x.dtype not in _KEPT_DTYPES:
        x = x.to(torch.float32)
    return x.to(device)


def tile_table(V, plan: BlockedPlan, device="cuda") -> torch.Tensor:
    """The (n, N) table padded and re-laid tile-major on ``device``.

    A float32 or bfloat16 table keeps its type (the fp32 tier pulls a
    bf16 table's 2-byte cells, widened exactly); any other is cast to
    float32.  A static table is re-laid once and reused by every dispatch
    (`repro_torch.launch.engine.CascadeExecutor` does so).
    """
    dev = resolve_device(device)
    V = as_kept(V, dev)
    if V.shape != (plan.n, plan.N):
        raise ValueError(f"table shape {tuple(V.shape)} != plan's "
                         f"{(plan.n, plan.N)}")
    Vp, _ = _pad_operands(V, None, plan)
    return _tile_major(Vp, plan)


def quantize_table(V4: torch.Tensor, plan: BlockedPlan) -> Tuple:
    """The plan's table artifacts ``(Vq, vaux)`` from a `tile_table` table.

    ``(V8, vscale)`` for int8, ``(P4 packed, vscale)`` for int4,
    ``(codes, codebook)`` for pq (codebook trained by the deterministic
    `pq_train`, so repeated calls agree).  A static table is quantized
    once and handed to every dispatch (``quantized=``); per-cell
    quantization makes that equal to quantizing at every call.
    """
    if plan.precision == "int8":
        return quantize_tiles(V4)
    if plan.precision == "int4":
        return quantize_tiles_int4(V4)
    if plan.precision == "pq":
        cb = pq_train(V4, n_codes=plan.pq_codes, subdims=plan.pq_subdims)
        return pq_encode(V4, cb), cb
    raise ValueError(f"no table quantizer for precision {plan.precision!r}")


def measured_plan_quant_err(V, *, precision: str, tile: int = 8,
                            block: int = 512, pq_subdims: int = 8,
                            pq_codes: int = 16, n_queries: int = 32,
                            seed: int = 0, safety: float = 2.0,
                            queries=None, device="cuda") -> float:
    """Calibrate the measured per-pull error bound for a (table, geometry).

    Pads and tiles ``V`` as the cascade will (``block`` is the effective
    pull width: pass ``coord_block`` when calibrating a coord plan),
    builds the tier's artifacts and returns
    `repro_torch.core.quantize.measured_quant_err` over the calibration
    queries — ``queries`` (n_q, n_blocks, block) when given, else
    ``n_queries`` standard-normal draws from ``seed`` (not the JAX
    package's draws).  The result is the ``quant_err=`` that `make_plan`
    feeds to ``make_schedule``.
    """
    dev = resolve_device(device)
    V = torch.as_tensor(V, dtype=torch.float32).to(dev)
    n, N = V.shape
    block = min(block, N)
    if precision == "int4" and block % 2 != 0:
        raise ValueError(f"precision='int4' needs an even pull width, "
                         f"got block={block}")
    if precision == "pq" and block % pq_subdims != 0:
        raise ValueError(f"precision='pq' needs pull width divisible by "
                         f"pq_subdims, got block={block}, "
                         f"pq_subdims={pq_subdims}")
    if precision not in ("int8", "int4", "pq"):
        raise ValueError(f"no measured error model for precision "
                         f"{precision!r} (expected 'int8', 'int4' or 'pq')")
    # geometry-only fp32 plan: same padding and tiling as the real one
    geo = make_plan(n, N, tile=tile, block=block, precision="fp32")
    V4 = tile_table(V, geo, dev)
    quant = quantize_table(V4, dataclasses.replace(
        geo, precision=precision, pq_subdims=pq_subdims, pq_codes=pq_codes))
    return measured_quant_err(V4, quant, precision=precision,
                              queries=queries, n_queries=n_queries,
                              seed=seed, safety=safety)


def make_measured_plan(V, K: int = 1, eps: float = 0.1, delta: float = 0.05,
                       value_range: float = 1.0, tile: int = 8,
                       block: int = 512, range_mode: str = "clt",
                       precision: str = "pq", bound: str = "hoeffding",
                       pull_mode: str = "row", coord_block: int = 128,
                       pq_subdims: int = 8, pq_codes: int = 16,
                       n_queries: int = 32, seed: int = 0,
                       safety: float = 2.0, device="cuda") -> BlockedPlan:
    """`make_plan` with a measured (not worst-case) quantization bias.

    Calibrates `measured_plan_quant_err` on ``V`` at the plan's pull
    width and passes it as ``quant_err``.  ``pull_mode='hybrid'``
    measures at each candidate width, prices both plans with their own
    bound and keeps the `choose_pull_mode` winner.
    """
    n, N = V.shape
    if precision == "fp32":
        raise ValueError("precision='fp32' has no quantization error to "
                         "measure; use make_plan")
    kwargs = dict(K=K, eps=eps, delta=delta, value_range=value_range,
                  tile=tile, block=block, range_mode=range_mode,
                  precision=precision, bound=bound, coord_block=coord_block,
                  pq_subdims=pq_subdims, pq_codes=pq_codes)
    if pull_mode == "hybrid":
        mkwargs = dict(kwargs, n_queries=n_queries, seed=seed,
                       safety=safety, device=device)
        row_plan = make_measured_plan(V, pull_mode="row", **mkwargs)
        coord_plan = make_measured_plan(V, pull_mode="coord", **mkwargs)
        winner = choose_pull_mode(row_plan, coord_plan)
        return row_plan if winner == "row" else coord_plan
    width = coord_block if pull_mode == "coord" else block
    qerr = measured_plan_quant_err(V, precision=precision, tile=tile,
                                   block=width, pq_subdims=pq_subdims,
                                   pq_codes=pq_codes, n_queries=n_queries,
                                   seed=seed, safety=safety, device=device)
    return make_plan(n, N, pull_mode=pull_mode, quant_err=qerr, **kwargs)


def _in_fake_mode() -> bool:
    """Whether a ``FakeTensorMode`` is active (the dry run): tensors made
    now are fake, and no value may be read or kept past the trace."""
    return torch._C._get_dispatch_mode(
        torch._C._TorchDispatchModeKey.FAKE) is not None


def outside_simulated_ranks():
    """The context in which ops run once, on plain tensors, even where the
    ranks of a mesh are simulated (``LocalTensorMode`` switched off):
    for constants that a process caches and every rank shares, and for
    seeded draws (under ``LocalTensorMode`` each rank would draw its
    own)."""
    if not torch.distributed.is_available():
        return contextlib.nullcontext()
    from torch.distributed._local_tensor import (
        maybe_disable_local_tensor_mode)
    return maybe_disable_local_tensor_mode()


def _shared_constants(build):
    """``build`` cached per arguments, its tensors made outside simulated
    ranks; under a fake mode built anew and never kept (a fake tensor
    must not outlive its trace)."""
    cached = functools.lru_cache(maxsize=32)(build)

    @functools.wraps(build)
    def get(*args):
        if _in_fake_mode():
            return build(*args)
        with outside_simulated_ranks():
            return cached(*args)
    get.cache_clear, get.cache_info = cached.cache_clear, cached.cache_info
    return get


@_shared_constants
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


@_shared_constants
def cert_operand(sched: Schedule, device: torch.device) -> torch.Tensor:
    """Device copy of `cert_coeffs`, built once per (plan, device)."""
    return torch.as_tensor(cert_coeffs(sched), dtype=torch.float32,
                           device=device)


# id(perm) -> (its weakref, its version) of every perm known to be one:
# checked here once, or drawn by `draw_perms`
_PERMS: dict = {}


def _known_perm(p: torch.Tensor) -> bool:
    seen = _PERMS.get(id(p))
    return seen is not None and seen[0]() is p and seen[1] == p._version


def _remember_perm(p: torch.Tensor) -> None:
    for k in [k for k, v in _PERMS.items() if v[0]() is None]:
        del _PERMS[k]
    _PERMS[id(p)] = (weakref.ref(p), p._version)


def _check_perm(perm, n_blocks: int, device: torch.device) -> torch.Tensor:
    """``perm`` as int64 on ``device``: one permutation of
    ``range(n_blocks)`` or a ``(B, n_blocks)`` stack of them.  Its values
    are read on the host once per tensor (and again after an in-place
    write); a perm `draw_perms` made, or a fake one, only by shape.  Span
    ``cascade.perm``, counting its host reads (``host_reads``)."""
    with span("cascade.perm") as sp:
        p = torch.as_tensor(perm)
        shape_ok = p.dim() in (1, 2) and p.shape[-1] == n_blocks
        if shape_ok and not (_in_fake_mode() or _known_perm(p)):
            sp.count("host_reads", 1)
            host = p.detach().cpu().numpy()
            shape_ok = bool((np.sort(host, axis=-1)
                             == np.arange(n_blocks)).all())
            if shape_ok:
                _remember_perm(p)
        if not shape_ok:
            raise ValueError(f"perm must be a permutation of "
                             f"range({n_blocks}) or a (B, {n_blocks}) stack "
                             f"of them, got shape {tuple(p.shape)}")
        return p.to(device=device, dtype=torch.int64)


def draw_perms(n_blocks: int, B: Optional[int] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Block permutations from ``generator`` (default: a CPU generator
    seeded 0, so calls without one repeat): ``(n_blocks,)``, or ``(B,
    n_blocks)`` with one ``torch.randperm`` per query, drawn in order.
    Drawn once for all simulated ranks (each would draw its own), and
    known to be permutations: `_check_perm` reads none of them."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    with outside_simulated_ranks():
        if B is None:
            p = torch.randperm(n_blocks, generator=generator)
        else:
            p = torch.stack([torch.randperm(n_blocks, generator=generator)
                             for _ in range(B)])
    if not _in_fake_mode():
        _remember_perm(p)
    return p


def decode_operands(plan: BlockedPlan, *, final_exact: bool,
                    adaptive: bool, device: torch.device):
    """Device copies of what every dispatch of ``plan`` reads besides the
    table and the queries, built once per (plan, device) and cached.

    Returns ``(slotcode, rounds_meta, bpos, t_final, n_final, cert)``
    (`schedule_operands`; ``cert`` is `cert_operand` with ``adaptive``,
    else None).  ``final_exact`` appends coverage steps that complete
    every final survivor to all ``n_blocks`` columns — on the fp32 tier
    without early exit only: elsewhere the caller's fp32 rescore of the
    candidates makes the scores exact and the schedule stays at its
    sampling pulls.
    """
    cover = final_exact and plan.precision == "fp32" and not adaptive
    return (*schedule_operands(plan.schedule, bool(cover), device),
            cert_operand(plan.schedule, device) if adaptive else None)


def _fused_call(Vq: torch.Tensor, Qin: torch.Tensor, perm: torch.Tensor, *,
                plan: BlockedPlan, final_exact: bool, batched: bool = True,
                k_out: Optional[int] = None, n_valid: Optional[int] = None,
                vscale=None, qscale=None, codebook=None,
                adaptive: bool = False):
    """Dispatch the whole cascade as exactly one fused-cascade launch.

    ``batched``: ``Qin (B, n_blocks, C)`` through `fused_cascade_batched`,
    with one ``perm (n_blocks,)`` shared by the batch — its cols are that
    one row expanded over the batch, which the kernel reads once in round
    1 — or per-query ``perm (B, n_blocks)``; else one query ``Qin (n_blocks,
    C)`` and ``perm (n_blocks,)`` through `fused_cascade`.  See
    `decode_operands` for what ``final_exact`` does inside the cascade.
    Span ``cascade.launch``.
    """
    with span("cascade.launch"):
        slotcode, rmeta, bpos, t_final, n_final, cert = decode_operands(
            plan, final_exact=final_exact, adaptive=adaptive,
            device=Vq.device)
        cols = perm[..., bpos].to(torch.int32).contiguous()
        if batched and cols.dim() == 1:
            cols = cols.expand(Qin.shape[0], -1)
        fn = ops.fused_cascade_batched if batched else ops.fused_cascade
        return fn(Vq, Qin, slotcode, rmeta, cols, n_arms=plan.n,
                  K=plan.K, t_final=t_final, n_final=n_final, k_out=k_out,
                  n_valid=n_valid, vscale=vscale, qscale=qscale,
                  codebook=codebook, packed_int4=plan.precision == "int4",
                  cert=cert, k_cert=plan.K,
                  track_var=adaptive and plan.schedule.bound == "bernstein")


def _rescore_rows(V4: torch.Tensor, Qp: torch.Tensor, ids: torch.Tensor,
                  n_valid: int, plan: BlockedPlan, batched: bool = True
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact fp32 rescore + descending re-sort of cascade candidates.

    Gathers each candidate's padded row from the tile-major table and
    dots it with the zero-padded query in f32 (a bf16 row or query is
    widened exactly), so the product equals the unpadded one and
    dividing by the true ``N`` lands on (q . v)/N.
    Rows at or past ``n_valid`` are pinned to -inf and never re-enter
    the top-K; ties keep the cascade's order.  ``batched``: ``ids (B,
    k)`` and ``Qp (B, Np)``; else ``ids (k,)`` and ``Qp (Np,)``.
    """
    if not batched:
        ids, vals = _rescore_rows(V4, Qp[None], ids[None], n_valid, plan)
        return ids[0], vals[0]
    R = plan.tile
    safe = ids.long().clamp(0, V4.shape[0] * R - 1)
    rows = V4[safe // R, :, safe % R, :]                 # (B, k, nb, C)
    scores = torch.einsum("bkc,bc->bk", rows.reshape(*ids.shape, -1).float(),
                          Qp.float())
    scores = torch.where(ids < n_valid, scores / float(plan.N),
                         torch.full_like(scores, -torch.inf))
    vals, pos = torch.sort(scores, dim=1, descending=True, stable=True)
    return torch.gather(ids, 1, pos), vals


def _check_quantized(quantized, V4: torch.Tensor, plan: BlockedPlan
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    if plan.precision == "fp32":
        raise ValueError("pre-quantized operands need a quantized plan "
                         "(precision 'int8', 'int4' or 'pq')")
    Vq, vaux = (torch.as_tensor(t).to(V4.device) for t in quantized)
    if tuple(Vq.shape[:3]) != tuple(V4.shape[:3]):
        raise ValueError(f"quantized table shape {tuple(Vq.shape)} does "
                         f"not match the tiled table {tuple(V4.shape)}")
    return Vq.contiguous(), vaux.contiguous()


def _run_tiled(V4: torch.Tensor, Qp: torch.Tensor, perm, *,
               plan: BlockedPlan, batched: bool, final_exact: bool,
               k_out: int, n_valid: int, quantized=None,
               adaptive: bool = False):
    """The cascade on a `tile_table` table and zero-padded queries ``Qp``
    (``(B, Np)`` batched, ``(Np,)`` for one query), all on ``V4``'s
    device: quantize (table unless ``quantized`` is given; queries
    always, in their own type: bf16 queries get bf16-rounded scales, as
    in the JAX package), one fused dispatch on f32 queries for the fp32
    and pq tiers, then the fp32 rescore or the padding rescale."""
    perm = _check_perm(perm, plan.n_blocks, V4.device)
    if perm.dim() == 2 and (not batched or perm.shape[0] != Qp.shape[0]):
        raise ValueError(f"per-query perms {tuple(perm.shape)} need a "
                         f"batch of {perm.shape[0]} queries")
    return cascade_tiled(V4, Qp, perm, plan=plan, batched=batched,
                         final_exact=final_exact, k_out=k_out,
                         n_valid=n_valid, quantized=quantized,
                         adaptive=adaptive)


def cascade_tiled(V4: torch.Tensor, Qp: torch.Tensor, perm: torch.Tensor, *,
                  plan: BlockedPlan, batched: bool, final_exact: bool,
                  k_out: int, n_valid: int, quantized=None,
                  adaptive: bool = False):
    """`_run_tiled` past its checks: ``Qp`` and a checked int64 ``perm``
    (`_check_perm`) already on ``V4``'s device.  Nothing here waits for
    the device, so a caller may issue it on several devices (or several
    times on one) before it synchronizes
    (`repro_torch.distributed.sharding.sharded_decode_tiled`).  The
    rescore or the padding rescale runs in the span ``cascade.rescale``."""
    Qb = Qp.reshape(*Qp.shape[:-1], plan.n_blocks, plan.block).contiguous()
    quantized_plan = plan.precision != "fp32"
    if quantized is not None:
        Vq, vaux = _check_quantized(quantized, V4, plan)
    elif quantized_plan:
        Vq, vaux = quantize_table(V4, plan)
    kw = dict(plan=plan, final_exact=final_exact, batched=batched,
              k_out=k_out, n_valid=n_valid, adaptive=adaptive)
    if plan.precision == "pq":          # pq queries stay f32 (LUT walk)
        out = _fused_call(Vq, Qb.float(), perm, codebook=vaux, **kw)
    elif quantized_plan:
        Q8, qscale = quantize_blocks(Qb)    # per query block
        out = _fused_call(Vq, Q8, perm, vscale=vaux, qscale=qscale, **kw)
    else:
        out = _fused_call(V4, Qb.float(), perm, **kw)
    ids, vals = out[0], out[1]
    with span("cascade.rescale"):
        if final_exact and (quantized_plan or adaptive):
            ids, vals = _rescore_rows(V4, Qp, ids, n_valid, plan, batched)
        else:
            # undo the zero-padding rescale so scores estimate (q . v)/N
            # (an f32 multiply by the f32-rounded factor; a scalar needs no
            # copy to the card, which would wait for it)
            vals = vals * float(np.float32((plan.n_blocks * plan.block)
                                           / plan.N))
    return (ids, vals, out[2]) if adaptive else (ids, vals)


def decode_tiled(V4: torch.Tensor, Q, perm, *, plan: BlockedPlan,
                 final_exact: bool = True, k_out: Optional[int] = None,
                 n_valid: Optional[int] = None, quantized=None,
                 adaptive: bool = False):
    """`bounded_me_decode` on a table already laid out by `tile_table`.

    Runs on ``V4``'s device; ``Q``, ``perm`` and ``quantized`` are moved
    there.  ``Q`` keeps a float32 or bfloat16 type (a model's bf16
    hidden states: quantized as bf16, widened exactly for the fp32
    tier).  ``perm`` is one ``(n_blocks,)`` permutation shared by the
    batch or ``(B, n_blocks)``, one per query.  On a quantized plan
    without ``quantized`` the table is quantized here, at every call
    (`quantize_table`).  The queries' copy and padding run in the span
    ``cascade.queries``.
    """
    k_out = plan.K if k_out is None else int(k_out)
    if not plan.K <= k_out <= plan.k_out_cap:
        raise ValueError(f"k_out={k_out} outside [K={plan.K}, "
                         f"k_out_cap={plan.k_out_cap}]")
    n_valid = plan.n if n_valid is None else int(n_valid)
    with span("cascade.queries"):
        Q = as_kept(Q, V4.device)
        if Q.dim() != 2 or Q.shape[1] != plan.N:
            raise ValueError(f"Q must be (B, {plan.N}), got "
                             f"{tuple(Q.shape)}")
        _, Qp = _pad_operands(None, Q, plan)
    return _run_tiled(V4, Qp, perm, plan=plan, batched=True,
                      final_exact=final_exact, k_out=k_out, n_valid=n_valid,
                      quantized=quantized, adaptive=adaptive)


def bounded_me_decode(V, Q, perm, *, plan: BlockedPlan,
                      final_exact: bool = True, k_out: Optional[int] = None,
                      n_valid: Optional[int] = None, quantized=None,
                      adaptive: bool = False, device="cuda"):
    """Batched-decode BoundedME: one dispatch for a whole (B, N) batch.

    The serving hot path.  All queries share the block permutation
    ``perm``, an ``(n_blocks,)`` integer permutation of
    ``range(plan.n_blocks)``; survivor sets and eliminations stay fully
    per-query.  The (eps, delta) guarantee and the pull budget are the
    plan's.

    Args:
      V: (n, N) item/arm matrix (rows are arms).
      Q: (B, N) query batch.
      perm: the shared block permutation (explicit: torch cannot
        reproduce ``jax.random.permutation``).
      plan: static :class:`BlockedPlan` from :func:`make_plan`; must match
        ``V``'s (n, N).  Its ``precision`` picks the pull tier: 'fp32',
        'int8' and 'int4' (int8 queries, W4A8 for int4), or 'pq' (f32
        queries against a per-block codebook).
      final_exact: make the returned scores exact mean products (q . v)/N
        instead of block-mean estimates — by in-cascade coverage on the
        fp32 tier, by an fp32 rescore of the ``k_out`` candidates on the
        quantized tiers and with ``adaptive``.
      k_out: candidates returned per query (default ``plan.K``), with
        ``plan.K <= k_out <= plan.k_out_cap``.
      n_valid: rows >= n_valid never win a ranking (default ``plan.n``).
      quantized: optional table artifacts matching the plan's tier —
        ``(V8, vscale)`` for int8, ``(P4, vscale)`` nibble-packed for int4,
        ``(codes, codebook)`` for pq, in the tile-major layout of
        `quantize_table` (the JAX package's, through
        `repro_torch.convert.quantized_from_jax`).  Without them the
        table is quantized in the call.  Queries are quantized per call.
      adaptive: certify early exit per query at round ends under the
        plan's ``bound`` radius family; a certified query's remaining
        pulls are skipped and a third output reports its rounds.
      device: where the cascade runs.  The default ``"cuda"`` launches
        the CUDA kernel and raises when there is no card; ``"cpu"`` runs
        the plain PyTorch version.

    Returns:
      ``(ids (B, k_out) int32, scores (B, k_out) float32)`` sorted by
      descending score, and with ``adaptive`` also ``rounds_used (B,)
      int32``.  Entries past the live rows carry ``-inf`` scores.
    """
    V4 = tile_table(V, plan, device)
    return decode_tiled(V4, Q, perm, plan=plan, final_exact=final_exact,
                        k_out=k_out, n_valid=n_valid, quantized=quantized,
                        adaptive=adaptive)


def _run_blocked(V, q, perm, *, plan: BlockedPlan, final_exact: bool,
                 adaptive: bool, device):
    """One query through `fused_cascade` (``boundedme_jax._run_blocked``
    in its ``use_pallas`` form): ``(ids (K,), scores (K,))``, with
    ``adaptive`` also a scalar ``rounds_used``."""
    V4 = tile_table(V, plan, device)
    q = torch.as_tensor(q, dtype=torch.float32).to(V4.device)
    if q.shape != (plan.N,):
        raise ValueError(f"q must be ({plan.N},), got {tuple(q.shape)}")
    _, qp = _pad_operands(None, q, plan)
    return _run_tiled(V4, qp, perm, plan=plan, batched=False,
                      final_exact=final_exact, k_out=plan.K, n_valid=plan.n,
                      adaptive=adaptive)


def bounded_me_blocked(V, q, perm=None, *, K: int = 1, eps: float = 0.1,
                       delta: float = 0.05, value_range: float = 1.0,
                       tile: int = 8, block: int = 512,
                       final_exact: bool = False, precision: str = "fp32",
                       adaptive: bool = False, bound: str = "hoeffding",
                       pull_mode: str = "row", coord_block: int = 128,
                       quant_err: Optional[float] = None,
                       pq_subdims: int = 8, pq_codes: int = 16,
                       plan: Optional[BlockedPlan] = None,
                       generator: Optional[torch.Generator] = None,
                       device="cuda"):
    """Top-K MIPS over rows of ``V`` for one query ``q`` (N,).

    Returns ``(ids (K,), scores (K,), plan)`` where scores estimate
    ``(q . v)/N``; with ``adaptive`` ``(ids, scores, rounds_used,
    plan)``.  The whole cascade is one `fused_cascade` dispatch: the
    CUDA kernel on the card, its plain version with ``device="cpu"``.
    Knobs as in ``repro.core.boundedme_jax.bounded_me_blocked``:
    ``precision`` 'fp32' | 'int8' | 'int4' | 'pq' (table and query
    quantized in the call; 'pq' with ``quant_err=None`` calibrates the
    plan on ``V`` by `make_measured_plan`), ``pull_mode`` 'row' |
    'coord' | 'hybrid', ``bound`` for ``adaptive`` early exit;
    ``final_exact`` makes the returned scores exact.  ``plan``, when
    given, wins over the knobs.  ``perm``, the block permutation
    (``(plan.n_blocks,)``), takes the place of the JAX package's key;
    without it one is drawn from ``generator`` (`draw_perms`).
    """
    dev = resolve_device(device)
    if plan is None:
        n, N = V.shape
        kwargs = dict(K=K, eps=eps, delta=delta, value_range=value_range,
                      tile=tile, block=block, precision=precision,
                      bound=bound, pull_mode=pull_mode,
                      coord_block=coord_block, pq_subdims=pq_subdims,
                      pq_codes=pq_codes)
        if precision == "pq" and quant_err is None:
            plan = make_measured_plan(V, device=dev, **kwargs)
        else:
            plan = make_plan(n, N, quant_err=quant_err, **kwargs)
    if perm is None:
        perm = draw_perms(plan.n_blocks, generator=generator)
    out = _run_blocked(V, q, perm, plan=plan, final_exact=final_exact,
                       adaptive=adaptive, device=dev)
    return (*out, plan)


def bounded_me_batched(V, Q, perms=None, *, plan: BlockedPlan,
                       final_exact: bool = False, adaptive: bool = False,
                       generator: Optional[torch.Generator] = None,
                       device="cuda"):
    """BoundedME over a batch of queries ``Q`` (B, N) with per-query block
    permutations ``perms`` (B, n_blocks), as one `fused_cascade_batched`
    dispatch.

    Results equal a loop of `bounded_me_blocked` calls with the same
    perms; `bounded_me_decode` is the serving form with one permutation
    shared by the batch.  Without ``perms`` they are drawn from
    ``generator`` (`draw_perms`).  Returns ``(ids (B, K), scores (B,
    K))``, with ``adaptive`` also ``rounds_used (B,)``.
    """
    V4 = tile_table(V, plan, device)
    Q = torch.as_tensor(Q, dtype=torch.float32)
    if perms is None:
        perms = draw_perms(plan.n_blocks, Q.shape[0], generator)
    if torch.as_tensor(perms).dim() != 2:
        raise ValueError(f"perms must be (B, {plan.n_blocks})")
    return decode_tiled(V4, Q, perms, plan=plan, final_exact=final_exact,
                        adaptive=adaptive)
