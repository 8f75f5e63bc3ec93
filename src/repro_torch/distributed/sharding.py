"""The serving mesh, the sharded decode engine and per-dispatch lane
accounting of the port.

The PyTorch counterpart of the serving half of
``repro.distributed.sharding``: `make_shard_plan`,
`sharded_bounded_me_decode` and `dispatch_lane_stats`.  The training
half (``logical_mesh``, ``shard``, ``spec_of``, ``named_sharding``,
``shard_map_compat``) waits for multi-card training and model sharding
(ROADMAP.md queue 1 item 7).

**One controller over a list of devices.**  The JAX package runs each
shard's body under ``shard_map`` from one Python process and gathers the
candidates with ``all_gather``.  The port does the same in one process:
a `Mesh` is an ordered tuple of devices under the axis name ``"model"``;
`sharded_decode_tiled` issues one fused-cascade launch per shard, each
on its shard's device under `device_guard` (the kernel reads the current
card's SM count and launches on its current stream), all of them before
anything waits for a device, so shards on different cards overlap.  The
candidates — O(shards * k_out) numbers per query — are then copied to
``mesh.devices[0]`` and merged there.  A mesh may repeat a device: the
counterpart of XLA's forced host device count, with which the tests run
S shards on the CPU and ``chip_smoke.py`` on one card.

Why the global (eps, delta) guarantee holds (DESIGN.md §7): the shard
owning the global optimum returns a candidate within eps of it with
probability >= 1 - delta / shards (each shard's plan runs at ``delta /
shards``, a union bound), and the scores entering the merge are exact
inner products, so the cross-shard argmax adds no estimation error.  The
merge keeps the lower position first on ties, as ``jax.lax.top_k`` does
(positions shard-major, then each shard's own order): a stable
descending sort, where ``torch.topk`` promises no order for ties.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.boundedme_torch import (BlockedPlan, _check_perm,
                                              _pad_operands, as_kept,
                                              cascade_tiled, make_plan,
                                              quantize_table, resolve_device)
from repro_torch.core.schedule import pulls_through_round

__all__ = ["Mesh", "device_guard", "make_shard_plan", "shard_valid_counts",
           "quantize_shards", "stage_batch", "merge_topk",
           "sharded_decode_tiled",
           "sharded_bounded_me_decode", "dispatch_lane_stats"]


class Mesh:
    """A one-axis serving mesh: an ordered tuple of devices.

    Its one axis is ``"model"``: ``shape["model"]`` is the shard count
    and ``devices[s]`` holds shard s.  Devices are all CUDA or all CPU
    and may repeat (S logical shards on one card, or on the CPU in the
    tests); a CUDA device without an index is the current card.
    `repro_torch.launch.mesh.make_serving_mesh` builds one over the
    cards there are.
    """

    axis_names = ("model",)

    def __init__(self, devices: Sequence):
        devs = []
        for d in devices:
            d = resolve_device(d)
            if d.type == "cuda" and d.index is None:
                d = torch.device("cuda", torch.cuda.current_device())
            devs.append(d)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in devs}) != 1:
            raise ValueError(f"mesh devices must be all CUDA or all CPU, "
                             f"got {[str(d) for d in devs]}")
        self.devices = tuple(devs)

    @property
    def shape(self) -> dict:
        """``{"model": shards}``, as a JAX mesh's ``shape``."""
        return {"model": len(self.devices)}

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


def _check_axis(model_axis: str) -> None:
    """The JAX signature's ``model_axis``: the port's mesh has the one
    axis ``"model"``."""
    if model_axis != "model":
        raise ValueError(f"model_axis must be 'model', the port's one mesh "
                         f"axis; got {model_axis!r}")


def device_guard(device: torch.device):
    """The context one shard's launch runs in: its card made current (the
    kernel wrappers also make their operands' card current, and check it
    before the C entry), nothing to switch on the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def dispatch_lane_stats(rounds_used, *, schedule, lanes: int,
                        filled: int) -> dict:
    """Per-dispatch lane accounting for one fused-cascade launch.

    A dispatch always runs ``lanes`` kernel lanes; ``filled`` of them
    carry real queries (the rest are padding the scheduler could not
    backfill in time).  ``rounds_used`` is the adaptive early-exit
    round per lane — ``(B,)`` single-device or ``(B, shards)`` sharded
    (each shard certifies independently; a lane's executed pulls are its
    per-shard mean) — or None on non-adaptive dispatches (every lane
    runs the full schedule).

    Returns a plain dict: ``occupancy`` (filled lanes), ``lane_util``
    (filled / lanes), ``executed_pull_frac`` (pulls actually executed by
    the *filled* lanes, as a fraction of the schedule's full pull
    budget — 1.0 when non-adaptive), and ``wasted_lane_frac`` (the pull
    budget burned on padding lanes).  Schedulers aggregate these per
    dispatch; they are the kernel-side half of the runtime's
    ``stats()["lanes"]`` block.
    """
    lanes = max(1, int(lanes))
    filled = max(0, min(int(filled), lanes))
    if rounds_used is None or filled == 0:
        frac = 1.0
    else:
        r = np.asarray(rounds_used)[:filled]
        if r.ndim == 1:
            r = r[:, None]          # unify: (filled, shards)
        pulls = np.asarray(pulls_through_round(schedule), np.float64)
        total = max(1.0, float(pulls[-1]))
        idx = np.clip(r.astype(np.int64), 0, len(pulls) - 1)
        frac = float(pulls[idx].mean() / total)
    return {
        "occupancy": filled,
        "lane_util": filled / lanes,
        "executed_pull_frac": frac,
        "wasted_lane_frac": (lanes - filled) / lanes,
    }


def make_shard_plan(n: int, N: int, n_shards: int, *, K: int = 1,
                    eps: float = 0.05, delta: float = 0.05,
                    value_range: float = 4.0, tile: int = 8,
                    block: int = 512, precision: str = "fp32",
                    bound: str = "hoeffding", pull_mode: str = "row",
                    coord_block: int = 128,
                    quant_err: Optional[float] = None,
                    pq_subdims: int = 8, pq_codes: int = 16):
    """Shard-local `BlockedPlan` + padding geometry for a row-sharded table.

    Splits an (n, N) table into ``n_shards`` row shards of ``n_local =
    ceil(n / n_shards)`` rows (the last shard padded with ``n_pad =
    n_shards * n_local - n`` zero rows), and calibrates each shard's
    cascade at ``delta / n_shards`` (a union bound over shards) with K
    capped at ``n_local``.  Rows past a shard's live count are masked
    inside its cascade (``n_valid``), so no shard-local K inflation is
    needed.  ``k_out`` asks each shard for one candidate beyond its top-K
    where the plan allows, so the merge can report each candidate's gap
    over its shard's best non-returned survivor.  Quantization, pq
    codebooks, certification (``bound``) and the pull mode are all
    shard-local; merge scores stay exact.

    Returns ``(plan, n_local, n_pad, k_out)``, as the JAX package's.
    """
    if not 1 <= n_shards:
        raise ValueError(f"need n_shards >= 1, got {n_shards}")
    if not 1 <= K <= n:
        raise ValueError(f"need 1 <= K <= n, got K={K} n={n}")
    n_local = -(-n // n_shards)
    n_pad = n_shards * n_local - n
    K_local = min(K, n_local)
    plan = make_plan(n_local, N, K=K_local, eps=eps, delta=delta / n_shards,
                     value_range=value_range, tile=tile, block=block,
                     precision=precision, bound=bound, pull_mode=pull_mode,
                     coord_block=coord_block, quant_err=quant_err,
                     pq_subdims=pq_subdims, pq_codes=pq_codes)
    k_out = max(K_local, min(K_local + 1, plan.k_out_cap, n_local))
    return plan, n_local, n_pad, k_out


def shard_valid_counts(n_valid, n_shards: int, n_local: int) -> np.ndarray:
    """Per-shard live-row counts ``(n_shards,)`` int64: a global prefix
    bound ``n_valid`` (rows past it are padding, e.g. a padded vocab) as
    the prefix it leaves in each shard, or a per-shard vector (a
    `repro_torch.store.ShardedTableStore`'s `n_valid_vector`) as given."""
    nv = np.asarray(n_valid.cpu() if isinstance(n_valid, torch.Tensor)
                    else n_valid, np.int64)
    if nv.ndim == 1:
        if nv.shape != (n_shards,):
            raise ValueError(f"per-shard n_valid must be ({n_shards},), "
                             f"got {nv.shape}")
        return nv.copy()
    return np.clip(int(nv) - np.arange(n_shards, dtype=np.int64) * n_local,
                   0, n_local)


def stage_batch(Q: torch.Tensor, perm, mesh: Mesh, plan: BlockedPlan
                ) -> dict:
    """``{device: (Qp, perm)}``: the query batch zero-padded to the
    plan's width and the checked block permutation(s) on every device of
    the mesh, staged before the first launch (a copy to a card waits for
    its stream, so none may come between launches)."""
    host_perm = _check_perm(perm, plan.n_blocks, torch.device("cpu"))
    staged = {}
    for dev in dict.fromkeys(mesh.devices):
        _, Qp = _pad_operands(None, as_kept(Q, dev), plan)
        staged[dev] = (Qp, host_perm.to(dev))
    return staged


def quantize_shards(shards: List[torch.Tensor], plan: BlockedPlan):
    """Each shard's tier artifacts at ``plan``'s geometry, over its own
    rows (pq: a codebook trained on them), on its device; None on
    fp32."""
    if plan.precision == "fp32":
        return None
    return [quantize_table(V4, plan) for V4 in shards]


def merge_topk(ids: torch.Tensor, scores: torch.Tensor, K: int, *rest):
    """The global top-K of ``(B, M)`` candidates in shard-major order:
    ``(ids, scores, *rest)`` gathered at the K best scores, the lower
    position first on ties (a stable descending sort, as
    ``jax.lax.top_k`` orders them)."""
    vals, pos = torch.sort(scores, dim=1, descending=True, stable=True)
    pos = pos[:, :K]
    return (torch.gather(ids, 1, pos), vals[:, :K],
            *(torch.gather(r, 1, pos) for r in rest))


def _exact_scores(V4: torch.Tensor, Qp: torch.Tensor, ids: torch.Tensor,
                  plan: BlockedPlan) -> torch.Tensor:
    """(q . v) / N of each candidate row, in the candidates' order: the
    row gathered from the tile-major table (zero-padded columns add
    nothing) and dotted with the zero-padded query in f32."""
    R = plan.tile
    safe = ids.long().clamp(0, plan.n - 1)
    rows = V4[safe // R, :, safe % R, :]
    return torch.einsum("bkc,bc->bk", rows.reshape(*ids.shape, -1).float(),
                        Qp.float()) / float(plan.N)


def sharded_decode_tiled(shards: List[torch.Tensor], Q, perm, *, mesh: Mesh,
                         plan: BlockedPlan, K: int, k_out: int, n_valid,
                         final_exact: bool = True, quantized=None,
                         adaptive: bool = False,
                         return_candidates: bool = False):
    """`sharded_bounded_me_decode` on a table already sharded and laid
    out (`repro_torch.distributed.specs.serving_table_sharding`, or a
    `ShardedTableStore`'s `tiled_shards`).

    ``shards[s]`` is shard s's tile-major table on ``mesh.devices[s]``
    (``plan`` is the shard plan: ``plan.n`` rows per shard), ``n_valid``
    its live counts (`shard_valid_counts`), ``quantized[s]`` its tier
    artifacts at the plan's geometry (`quantize_table`) or None to
    quantize in the call.  One fused-cascade launch per shard, each under
    its device's `device_guard`; the query batch and the block
    permutation are staged on every device first, and nothing waits for
    a device until every shard's launch is issued.  Returns the JAX
    package's tuple, on ``mesh.devices[0]``.
    """
    S = len(mesh.devices)
    if len(shards) != S:
        raise ValueError(f"{len(shards)} shard tables for a mesh of {S}")
    if quantized is not None and len(quantized) != S:
        raise ValueError(f"{len(quantized)} quantized shards for {S}")
    nv = shard_valid_counts(n_valid, S, plan.n)
    Q = torch.as_tensor(Q)
    if Q.dim() != 2 or Q.shape[1] != plan.N:
        raise ValueError(f"Q must be (B, {plan.N}), got {tuple(Q.shape)}")
    staged = stage_batch(Q, perm, mesh, plan)
    per_shard = []
    for s, (dev, V4) in enumerate(zip(mesh.devices, shards)):
        if V4.device != dev:
            raise ValueError(f"shard {s} lies on {V4.device}, the mesh "
                             f"places it on {dev}")
        Qp, perm_d = staged[dev]
        with device_guard(dev):
            out = cascade_tiled(
                V4, Qp, perm_d, plan=plan, batched=True,
                final_exact=final_exact, k_out=k_out, n_valid=int(nv[s]),
                quantized=None if quantized is None else quantized[s],
                adaptive=adaptive)
            ids, scores = out[0], out[1]
            if not final_exact:
                # merge decisions compare exact inner products, never
                # block-mean estimates
                scores = _exact_scores(V4, Qp, ids, plan)
            if k_out > plan.K:
                # margin over the shard's best non-returned survivor
                gaps = scores - scores[:, k_out - 1:k_out]
            else:
                gaps = torch.full_like(scores, torch.inf)
            # a shard with fewer than k_out live rows emits fillers
            scores = torch.where(ids < int(nv[s]), scores,
                                 torch.full_like(scores, -torch.inf))
            rounds = (out[2] if adaptive else
                      torch.zeros(ids.shape[0], dtype=torch.int32,
                                  device=dev))
            per_shard.append((ids + s * plan.n, scores, gaps, rounds))
    home = mesh.devices[0]
    all_ids, all_sc, all_gap, all_rnd = (
        torch.stack([part[j].to(home) for part in per_shard], dim=1)
        for j in range(4))                         # (B, S, k_out), (B, S)
    B = all_ids.shape[0]
    ids, vals, gaps = merge_topk(all_ids.reshape(B, -1),
                                 all_sc.reshape(B, -1), K,
                                 all_gap.reshape(B, -1))
    out = [ids, vals, gaps]
    if adaptive:
        out.append(all_rnd)
    if return_candidates:
        out.append({"ids": all_ids, "scores": all_sc, "gaps": all_gap})
    return tuple(out)


def sharded_bounded_me_decode(table, Q, perm, *, mesh: Mesh, K: int = 1,
                              model_axis: str = "model", batch_axes=None,
                              n_valid=None, eps: float = 0.05,
                              delta: float = 0.05, value_range: float = 4.0,
                              tile: int = 8, block: int = 512,
                              final_exact: bool = True,
                              precision: str = "fp32",
                              adaptive: bool = False,
                              bound: str = "hoeffding",
                              pull_mode: str = "row",
                              coord_block: int = 128,
                              quant_err: Optional[float] = None,
                              pq_subdims: int = 8, pq_codes: int = 16,
                              return_candidates: bool = False):
    """Multi-device batched-decode MIPS: per-shard fused cascade + exact
    merge.

    The item table ``table`` (n, N) is split into row shards over the
    mesh (`make_shard_plan`: ragged tables zero-padded to ``shards *
    ceil(n / shards)`` rows), each laid out tile-major on its device and,
    on a quantized tier, quantized over its own rows (pq: a codebook
    trained on them).  Each shard runs `bounded_me_decode` on its rows —
    ``k_out`` candidates, its own live count and ``adaptive`` — under the
    one block permutation ``perm`` (``(n_blocks,)``, shared by the batch
    and every shard, in place of the JAX package's key); then the global
    top-K of the exact candidate scores is taken on ``mesh.devices[0]``.

    Args:
      table: (n, N) float table (float32 or bfloat16 kept), any device.
      Q: (B, N) query batch.
      perm: the shared block permutation.
      mesh: the `Mesh`.  ``model_axis`` must be ``"model"`` and
        ``batch_axes`` None (the JAX signature): the port's mesh has the
        one row axis, and the batch is replicated as in the JAX
        package's serving path.
      n_valid: real rows of a padded table (default n), or a per-shard
        ``(shards,)`` vector of live counts; rows past it are masked
        inside each shard's cascade.
      eps / delta / value_range / tile / block / precision / bound /
      pull_mode / coord_block / quant_err / pq_subdims / pq_codes: as in
        `make_shard_plan` ('pq' needs an explicit ``quant_err``).
      final_exact: exact candidate scores from the cascade (coverage on
        fp32, the fp32 rescore elsewhere); with False each shard's
        candidates are rescored exactly before the merge instead.
      adaptive: per-query early exit, certified shard-locally.
      return_candidates: also return the per-shard candidates.

    Returns:
      ``(ids (B, K) int32, scores (B, K) float32, gaps (B, K) float32)``:
      global row ids, exact mean products (q . v)/N, and each
      candidate's margin over its shard's best non-returned survivor
      (+inf when the shard plan returns only K).  With ``adaptive`` a
      ``rounds_used (B, shards) int32`` follows; with
      ``return_candidates`` last a dict of ``ids`` / ``scores`` /
      ``gaps``, each ``(B, shards, k_out)``.
    """
    from repro_torch.distributed.specs import serving_table_sharding

    _check_axis(model_axis)
    if batch_axes is not None:
        raise ValueError("batch_axes must be None: the port's serving mesh "
                         "has only the row axis")
    n, N = table.shape
    S = len(mesh.devices)
    plan, n_local, _, k_out = make_shard_plan(
        n, N, S, K=K, eps=eps, delta=delta, value_range=value_range,
        tile=tile, block=block, precision=precision, bound=bound,
        pull_mode=pull_mode, coord_block=coord_block, quant_err=quant_err,
        pq_subdims=pq_subdims, pq_codes=pq_codes)
    shards = serving_table_sharding(table, mesh, plan)
    return sharded_decode_tiled(
        shards, Q, perm, mesh=mesh, plan=plan, K=K, k_out=k_out,
        n_valid=n if n_valid is None else n_valid,
        final_exact=final_exact, quantized=quantize_shards(shards, plan),
        adaptive=adaptive,
        return_candidates=return_candidates)
