"""The serving mesh, the sharded decode engine and per-dispatch lane
accounting of the port.

The PyTorch counterpart of ``repro.distributed.sharding``: its serving
half (`make_shard_plan`, `sharded_bounded_me_decode`,
`dispatch_lane_stats`) over the serving `Mesh`, and its training half
(`LOGICAL_RULES`, `logical_mesh`, `current_mesh`, `spec_of`, `shard`,
`named_sharding`, `shard_map_compat`) over a training mesh, a
``torch.distributed.device_mesh.DeviceMesh`` with the JAX mesh's axis
names (`repro_torch.launch.mesh.make_local_mesh`,
``make_production_mesh``).

**Training: logical axes over a DeviceMesh.**  Model code annotates
activations with logical axes (``shard(x, "batch", "seq", "heads",
None)``); `logical_mesh` binds a mesh and the logical -> mesh-axis
rules, and without one every annotation is the identity, so the same
code runs on one device and on a (2, 16, 16) mesh.  A JAX
``PartitionSpec`` is a `PartitionSpec` here too (one entry per tensor
dimension: None, a mesh-axis name, or a tuple of names, a 1-tuple
normalized to its name as JAX does), and `placements` turns one into
DTensor placements: mesh dimension i is ``Shard(d)`` where tensor
dimension d's entry names it, else ``Replicate()``.  A dimension split
over two mesh axes (``"batch"`` on ``("pod", "data")``) is split
row-major, the first axis outermost, as JAX splits it; DTensor's
default order over mesh dimensions is that one when the names come in
the mesh's order, and another order raises.  ``with_sharding_constraint``
becomes ``DTensor.redistribute`` (`shard`), ``shard_map`` becomes
``local_map`` with explicit collectives inside (`shard_map_compat`).
A partial sum of a 16-bit float type is reduced in f32 and rounded once
(`redistribute`, `widen`), as XLA compiles the JAX package's bf16
reductions.

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

**Over a DeviceMesh.**  `sharded_bounded_me_decode` and
`repro_torch.core.mips.sharded_mips_topk` also take a training mesh, a
``DeviceMesh``, with the JAX signature whole: ``model_axis`` names the
row axis, ``batch_axes`` the axes the query batch is split over.  The
work runs under ``local_map`` (`shard_map_compat`) as the JAX package's
runs under ``shard_map``: each rank lays out and quantizes its own row
shard (`mesh_table_shards`), runs the fused cascade on it with its own
live count and its rank's global row offset, and the candidates are
all-gathered over ``model_axis`` (one collective of O(B * shards *
k_out) words) and merged on every rank (`sharded_decode_mesh`).  The
same code runs on real ranks (one per card, NCCL; gloo on the CPU), on
ranks simulated under ``LocalTensorMode`` (the kernel operator runs once
per rank on that rank's tensors; a live count that differs per rank is
a per-rank int) and under the dry run's fake tensors (the operator's
fake implementation).

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
import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.boundedme_torch import (BlockedPlan, _check_perm,
                                              _pad_operands, as_kept,
                                              cascade_tiled, make_plan,
                                              outside_simulated_ranks,
                                              quantize_table, resolve_device,
                                              tile_table)
from repro_torch.core.schedule import pulls_through_round

__all__ = ["LOGICAL_RULES", "PartitionSpec", "P", "AbstractMesh",
           "axis_sizes", "logical_mesh", "current_mesh", "rebinder",
           "spec_of",
           "placements", "redistribute", "fan_out", "widen", "shard",
           "named_sharding", "shard_map_compat",
           "dtensor_context", "outside_simulated_ranks", "is_dtensor",
           "Mesh",
           "device_guard", "make_shard_plan", "shard_valid_counts",
           "quantize_shards", "stage_batch", "merge_topk",
           "sharded_decode_tiled", "sharded_bounded_me_decode",
           "dispatch_lane_stats", "is_device_mesh", "rank_along",
           "gather_over", "MeshShards", "mesh_table_shards",
           "sharded_decode_mesh", "merge_gathered"]


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
    """The JAX signature's ``model_axis`` on the serving `Mesh`, whose one
    axis is ``"model"`` (a ``DeviceMesh`` names its own axes)."""
    if model_axis != "model":
        raise ValueError(f"model_axis must be 'model', the serving Mesh's "
                         f"one axis; got {model_axis!r}")


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
      mesh: the serving `Mesh` (``model_axis`` must be ``"model"`` and
        ``batch_axes`` None: it has the one row axis, and the batch is
        replicated as in the JAX package's serving path), or a
        ``DeviceMesh``: the rows split over ``model_axis`` and the batch
        over ``batch_axes`` (a mesh axis, a tuple of them, or None for a
        replicated batch; B must divide), the work under ``local_map``
        (`sharded_decode_mesh`), the results DTensors.
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

    n, N = table.shape
    if is_device_mesh(mesh):
        S = axis_sizes(mesh)[model_axis]
    else:
        _check_axis(model_axis)
        if batch_axes is not None:
            raise ValueError("batch_axes must be None on the serving Mesh: "
                             "it has only the row axis (a DeviceMesh takes "
                             "them)")
        S = len(mesh.devices)
    plan, _, _, k_out = make_shard_plan(
        n, N, S, K=K, eps=eps, delta=delta, value_range=value_range,
        tile=tile, block=block, precision=precision, bound=bound,
        pull_mode=pull_mode, coord_block=coord_block, quant_err=quant_err,
        pq_subdims=pq_subdims, pq_codes=pq_codes)
    if is_device_mesh(mesh):
        shards = mesh_table_shards(table, mesh, plan, k_out=k_out,
                                   model_axis=model_axis)
        return sharded_decode_mesh(
            shards, Q, perm, K=K, n_valid=n if n_valid is None else n_valid,
            batch_axes=batch_axes, final_exact=final_exact,
            adaptive=adaptive, return_candidates=return_candidates)
    shards = serving_table_sharding(table, mesh, plan)
    return sharded_decode_tiled(
        shards, Q, perm, mesh=mesh, plan=plan, K=K, k_out=k_out,
        n_valid=n if n_valid is None else n_valid,
        final_exact=final_exact, quantized=quantize_shards(shards, plan),
        adaptive=adaptive,
        return_candidates=return_candidates)


# ---------------------------------------------------------------------------
# The sharded decode over a DeviceMesh (the JAX package's shard_map form)
# ---------------------------------------------------------------------------

def is_device_mesh(mesh) -> bool:
    """Whether ``mesh`` is a ``DeviceMesh`` (named axes over ranks), not
    the serving `Mesh` or an `AbstractMesh`."""
    return getattr(mesh, "mesh_dim_names", None) is not None


def rank_along(mesh, axis: str):
    """This rank's coordinate along ``axis`` (``jax.lax.axis_index``): an
    int, or under ``LocalTensorMode`` an int that holds each simulated
    rank's own."""
    return mesh.get_local_rank(axis)


def gather_over(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``t`` of every rank along ``axis`` stacked on a new leading dim,
    rank order (``jax.lax.all_gather`` at axis 0): one all-gather."""
    from torch.distributed import _functional_collectives as funcol
    gather = getattr(funcol, "all_gather_single", None) \
        or funcol.all_gather_tensor
    n = axis_sizes(mesh)[axis]
    out = gather(t.contiguous(), 0,
                 (mesh, list(mesh.mesh_dim_names).index(axis)))
    if isinstance(out, funcol.AsyncCollectiveTensor):
        out = out.wait()
    return out.reshape(n, *t.shape)


def merge_gathered(mesh, model_axis: str, K: int, ids, scores, *rest):
    """The exact cross-shard merge of one rank's ``(B_loc, k)`` candidates
    (global ids, scores, then ``rest``: int32 or float32, ``(B_loc, k)``
    or ``(B_loc,)``): every rank's all-gathered over ``model_axis`` in one
    collective (ints carried bit for bit in float32 words), then the top
    ``K`` by `merge_topk`.  Returns ``(ids, vals, [rest[0] at the top
    K,] (B_loc, S, ...) gathered parts in the inputs' order)``."""
    B = ids.shape[0]
    parts = [ids, scores, *rest]
    cols = [p if p.dim() == 2 else p[:, None] for p in parts]
    words = torch.cat([c.view(torch.float32) if c.dtype == torch.int32
                       else c for c in cols], dim=1)
    g = gather_over(words, mesh, model_axis).transpose(0, 1)  # (B, S, W)
    out, at = [], 0
    for p, c in zip(parts, cols):
        w = g[..., at:at + c.shape[1]].contiguous()
        if p.dtype == torch.int32:
            w = w.view(torch.int32)
        out.append(w if p.dim() == 2 else w[..., 0])
        at += c.shape[1]
    top = merge_topk(out[0].reshape(B, -1), out[1].reshape(B, -1), K,
                     *(r.reshape(B, -1) for r in out[2:3]))
    return (*top, out)


@dataclasses.dataclass
class MeshShards:
    """A table's row shards over a ``DeviceMesh``, each laid out by its
    own rank: ``V4`` is a DTensor whose local tensor on a rank is that
    rank's tile-major shard (split over ``model_axis``, replicated over
    the other axes), ``quantized`` the tier artifacts as DTensors of the
    same split (a pq codebook is each rank's own, stacked), ``plan`` the
    shard plan and ``k_out`` the candidates a shard returns."""

    plan: BlockedPlan
    mesh: object
    model_axis: str
    V4: torch.Tensor
    quantized: Optional[tuple]
    k_out: int

    @property
    def shards(self) -> int:
        """The number of row shards: the size of ``model_axis`` (1 when
        the mesh does not split the rows)."""
        return axis_sizes(self.mesh)[self.model_axis]


def mesh_table_shards(table, mesh, plan: BlockedPlan, *, k_out: int,
                      model_axis: str = "model") -> MeshShards:
    """Lay out each rank's row shard of an ``(n, N)`` table once.

    ``plan`` is the shard plan (`make_shard_plan`: ``plan.n`` rows a
    shard).  A plain table is zero-padded to ``shards * plan.n`` rows and
    each rank cuts its shard from its own copy (no collective); a DTensor
    table (a model's vocab table placed by ``param_pspecs``) must split
    evenly and is redistributed to rows over ``model_axis``, where it is
    not already.  Each rank then lays out and, on a quantized tier,
    quantizes its own rows (pq: a codebook trained on them) under
    ``local_map``."""
    from torch.distributed.tensor import distribute_tensor
    S = axis_sizes(mesh)[model_axis]
    n, N = table.shape
    if N != plan.N or n > S * plan.n:
        raise ValueError(f"plan of {plan.n} rows x {plan.N} cannot shard a "
                         f"({n}, {N}) table {S} ways")
    rows = PartitionSpec(model_axis, None)
    if not is_dtensor(table):
        t = as_kept(table, _mesh_device(mesh))
        if n < S * plan.n:
            t = torch.nn.functional.pad(t, (0, 0, 0, S * plan.n - n))
        table = distribute_tensor(t, mesh, placements(mesh, rows),
                                  src_data_rank=None)
    elif n != S * plan.n:
        raise ValueError(f"a DTensor table of {n} rows must split evenly "
                         f"into {S} shards of {plan.n}")

    def lay(t_l):
        V4 = tile_table(t_l, plan, t_l.device)
        if plan.precision == "fp32":
            return V4
        return (V4, *quantize_table(V4, plan))

    tiles = PartitionSpec(model_axis, None, None, None)
    if plan.precision == "fp32":
        outs = tiles
    else:
        aux = (tiles if plan.precision == "pq"
               else PartitionSpec(model_axis, None))
        outs = (tiles, tiles, aux)
    got = shard_map_compat(lay, mesh=mesh, in_specs=(rows,),
                           out_specs=outs)(table)
    V4, quant = (got, None) if plan.precision == "fp32" \
        else (got[0], tuple(got[1:]))
    return MeshShards(plan, mesh, model_axis, V4, quant, int(k_out))


def _live_count(n_valid, r, n_local: int):
    """A rank's live rows from a global prefix bound ``n_valid`` (an int,
    or a per-rank int under ``LocalTensorMode``)."""
    return torch.sym_max(0, torch.sym_min(n_valid - r * n_local, n_local))


def _mesh_device(mesh) -> torch.device:
    """The device of this process's rank of a ``DeviceMesh`` (the current
    card on a CUDA mesh)."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _batch_input(x, mesh, spec: "PartitionSpec"):
    """``x`` as a DTensor on ``mesh``: a plain tensor placed by ``spec``,
    each rank cutting its part from its own copy; a DTensor as it is
    (``local_map`` redistributes it)."""
    if is_dtensor(x):
        return x
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(torch.as_tensor(x).to(_mesh_device(mesh)),
                             mesh, placements(mesh, spec),
                             src_data_rank=None)


def sharded_decode_mesh(shards: MeshShards, Q, perm, *, K: int, n_valid,
                        batch_axes=None, final_exact: bool = True,
                        adaptive: bool = False,
                        return_candidates: bool = False):
    """`sharded_bounded_me_decode` over a ``DeviceMesh`` on a table laid
    out by `mesh_table_shards`.

    Under ``local_map`` each rank pads its ``(B_loc, N)`` queries (the
    batch split over ``batch_axes``), runs `cascade_tiled` on its shard
    with ``shards.k_out`` candidates and its own live count (from a
    global prefix ``n_valid``, or a per-shard ``(shards,)`` vector),
    rescores them exactly where ``final_exact`` is off, offsets the ids
    by its rank along the row axis, computes each candidate's gap over
    its shard's best non-returned survivor and sets fillers to -inf, as
    ``repro.distributed.sharding`` does; `merge_gathered` then
    all-gathers the candidates over the row axis and takes the top K.
    ``perm`` is one ``(n_blocks,)`` permutation shared by the batch and
    every rank (checked on the host once, `_check_perm`; a fake one by
    shape only).  Returns the JAX package's tuple as DTensors: the batch
    over ``batch_axes``, replicated over the row axis.
    """
    plan, mesh, axis = shards.plan, shards.mesh, shards.model_axis
    S, n_local, k_out = shards.shards, plan.n, shards.k_out
    perm = _check_perm(perm, plan.n_blocks, torch.device("cpu"))
    qspec = PartitionSpec(batch_axes, None)
    Q = Q if is_dtensor(Q) else torch.as_tensor(Q)
    if Q.dim() != 2 or Q.shape[1] != plan.N:
        raise ValueError(f"Q must be (B, {plan.N}), got {tuple(Q.shape)}")
    args = [shards.V4, _batch_input(Q, mesh, qspec)]
    specs = [PartitionSpec(axis, None, None, None), qspec]
    vector = is_dtensor(n_valid) or np.ndim(
        n_valid.cpu() if isinstance(n_valid, torch.Tensor) else n_valid) == 1
    if vector:
        if not is_dtensor(n_valid):
            n_valid = torch.as_tensor(shard_valid_counts(n_valid, S,
                                                         n_local))
        args.append(_batch_input(n_valid, mesh, PartitionSpec(axis)))
        specs.append(PartitionSpec(axis))
    else:
        n_valid = int(n_valid)
    if shards.quantized is not None:
        args += list(shards.quantized)
        specs += [PartitionSpec(axis, *(None,) * (t.dim() - 1))
                  for t in shards.quantized]

    def local(V4_l, Q_l, *rest):
        r = rank_along(mesh, axis)
        if vector:
            nv, rest = rest[0][0].item(), rest[1:]
        else:
            nv = _live_count(n_valid, r, n_local)
        _, Qp = _pad_operands(None, as_kept(Q_l, V4_l.device), plan)
        out = cascade_tiled(
            V4_l, Qp, perm.to(V4_l.device), plan=plan, batched=True,
            final_exact=final_exact, k_out=k_out, n_valid=nv,
            quantized=tuple(rest) if rest else None, adaptive=adaptive)
        ids, scores = out[0], out[1]
        if not final_exact:
            # merge decisions compare exact inner products, never
            # block-mean estimates
            scores = _exact_scores(V4_l, Qp, ids, plan)
        if k_out > plan.K:
            # margin over the shard's best non-returned survivor
            gaps = scores - scores[:, k_out - 1:k_out]
        else:
            gaps = torch.full_like(scores, torch.inf)
        # a shard with fewer than k_out live rows emits fillers
        scores = torch.where(ids < nv, scores,
                             torch.full_like(scores, -torch.inf))
        rounds = (out[2] if adaptive else
                  torch.zeros(ids.shape[0], dtype=torch.int32,
                              device=ids.device))
        top_ids, vals, top_gaps, (c_ids, c_sc, c_gap, c_rnd) = \
            merge_gathered(mesh, axis, K, ids + r * n_local, scores, gaps,
                           rounds)
        return top_ids, vals, top_gaps, c_rnd, c_ids, c_sc, c_gap

    three = PartitionSpec(batch_axes, None, None)
    ids, vals, gaps, rounds, c_ids, c_sc, c_gap = shard_map_compat(
        local, mesh=mesh, in_specs=tuple(specs),
        out_specs=(qspec, qspec, qspec, qspec, three, three, three))(*args)
    out = [ids, vals, gaps]
    if adaptive:
        out.append(rounds)
    if return_candidates:
        out.append({"ids": c_ids, "scores": c_sc, "gaps": c_gap})
    return tuple(out)


# ---------------------------------------------------------------------------
# Training: logical axes, specs and placements over a DeviceMesh
# ---------------------------------------------------------------------------

AxisBinding = Union[str, Tuple[str, ...], None]

#: the default logical axis -> mesh axis binding of the production meshes
LOGICAL_RULES: Dict[str, AxisBinding] = {
    "batch": ("pod", "data"),   # 'pod' dropped on single-pod meshes
    "vocab": "model",
    "heads": "model",
    "kv_heads": None,           # GQA kv counts rarely divide the model axis
    "ff": "model",
    "experts": "model",
    "expert_cap": None,
    "kvseq": "model",           # sequence-sharded KV cache at decode
    "seq": None,
    "embed": None,
    "state": None,
    "dinner": "model",          # mamba inner dim (bound per config)
}


class PartitionSpec(tuple):
    """A JAX ``PartitionSpec``: one entry per tensor dimension, None
    (replicated), a mesh-axis name, or a tuple of names (the dimension
    split over those axes, the first outermost).  A 1-tuple is its name
    and an empty tuple None, as JAX normalizes them."""

    def __new__(cls, *parts):
        norm = []
        for p in parts:
            if isinstance(p, (tuple, list)):
                p = tuple(p)
                p = p[0] if len(p) == 1 else (p or None)
            norm.append(p)
        return super().__new__(cls, norm)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class AbstractMesh:
    """Axis names and sizes without devices or ranks (JAX's
    ``AbstractMesh``): what `repro_torch.distributed.specs` needs to
    decide a spec.  ``shape`` is ``{name: size}``, as a JAX mesh's."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        if len(shape) != len(axis_names):
            raise ValueError(f"{len(shape)} sizes for axes {axis_names}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` (its ``mesh_dim_names``),
    an `AbstractMesh` or the serving `Mesh`."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, (int(s) for s in mesh.shape)))
    return dict(mesh.shape)


class _Ctx(threading.local):
    mesh = None
    rules: Dict[str, AxisBinding] = {}


_CTX = _Ctx()


@contextlib.contextmanager
def logical_mesh(mesh, rules: Optional[Dict[str, AxisBinding]] = None):
    """Bind a mesh and the logical rules (`LOGICAL_RULES` updated by
    ``rules``) for `shard`, `spec_of` and the model code, in this thread.
    Bindings to axes the mesh lacks are dropped ('pod' on one pod)."""
    names = tuple(axis_sizes(mesh))

    def keep(b: AxisBinding) -> AxisBinding:
        if b is None:
            return None
        if isinstance(b, str):
            return b if b in names else None
        kept = tuple(a for a in b if a in names)
        return kept or None

    merged = dict(LOGICAL_RULES)
    merged.update(rules or {})
    prev = (_CTX.mesh, _CTX.rules)
    _CTX.mesh, _CTX.rules = mesh, {k: keep(v) for k, v in merged.items()}
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev


def current_mesh():
    """The mesh bound by the innermost `logical_mesh`, or None."""
    return _CTX.mesh


def rebinder():
    """A factory of contexts that bind this thread's mesh and rules again
    (`contextlib.nullcontext` without a mesh): for work that runs later
    in another thread, such as activation checkpointing's recompute in
    the autograd engine's device thread."""
    mesh, rules = _CTX.mesh, dict(_CTX.rules)
    if mesh is None:
        return contextlib.nullcontext
    return lambda: logical_mesh(mesh, rules)


def spec_of(*logical_axes: Optional[str]) -> PartitionSpec:
    """The logical axes as a `PartitionSpec` under the bound rules.  A
    mesh axis appears at most once: where two logical axes bind it
    ('experts' and 'ff' on 'model'), the first keeps it and the later
    ones are replicated over it."""
    used: set = set()
    out = []
    for a in logical_axes:
        b = _CTX.rules.get(a) if a else None
        if b is None:
            out.append(None)
            continue
        bt = tuple(x for x in ((b,) if isinstance(b, str) else b)
                   if x not in used)
        used.update(bt)
        out.append(bt or None)
    return PartitionSpec(*out)


def placements(mesh, spec: Sequence) -> tuple:
    """DTensor placements of ``spec`` on a ``DeviceMesh``: mesh dimension
    i is ``Shard(d)`` where entry d names its axis, else ``Replicate()``.
    Raises on an axis the mesh lacks, on one named twice, and on a tuple
    entry whose axes are not in the mesh's order (DTensor splits a
    dimension over several mesh dimensions in the mesh's order, JAX in
    the tuple's: the two agree only then)."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    where: Dict[str, int] = {}
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        for a in axes:
            if a not in names:
                raise ValueError(f"{spec} names axis {a!r}; the mesh has "
                                 f"{names}")
            if a in where:
                raise ValueError(f"{spec} uses mesh axis {a!r} twice")
            where[a] = d
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"{spec} splits dimension {d} over {axes}, "
                             f"not in the mesh's order {names}")
    return tuple(Shard(where[n]) if n in where else Replicate()
                 for n in names)


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (False where torch has no
    ``torch.distributed``)."""
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


#: the float types whose partial sums are reduced in f32 (`redistribute`)
_WIDENED = (torch.bfloat16, torch.float16)


def _recast(x, dtype):
    """The DTensor ``x`` with each rank's local tensor cast to ``dtype``
    and its placements kept: a partial sum stays one, of the cast
    parts."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(x.to_local().to(dtype), x.device_mesh,
                              x.placements, run_check=False, shape=x.shape,
                              stride=x.stride())


def _reduce(x, mesh, pl):
    """``x.redistribute(mesh, pl)`` under the rule of `redistribute`,
    without autograd."""
    if x.dtype in _WIDENED and any(p.is_partial() and p != q
                                   for p, q in zip(x.placements, pl)):
        return _recast(_recast(x, torch.float32).redistribute(mesh, pl),
                       x.dtype)
    return x.redistribute(mesh, pl)


class _Constrain(torch.autograd.Function):
    """A redistribution and its transpose: the value redistributed to
    ``pl`` and its gradient to ``grad_pl``, both by `_reduce`."""

    @staticmethod
    def forward(ctx, x, mesh, pl, grad_pl):
        ctx.mesh, ctx.grad_pl = mesh, grad_pl
        return _reduce(x, mesh, pl)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.mesh, ctx.grad_pl), None, None, None


def redistribute(x, mesh, pl, grad_pl=None):
    """``x.redistribute(mesh, pl)`` under the port's rule for partial
    sums, its gradient redistributed to ``grad_pl`` (default ``pl``: JAX
    transposes ``with_sharding_constraint`` to the same constraint on
    the cotangent, where DTensor alone would carry a partial-sum
    gradient on) under the same rule.

    The rule: a partial sum of a 16-bit float type (bf16, f16) is
    reduced in f32 — each rank's part cast to f32, the parts reduced in
    f32 (all-reduce or reduce-scatter), the result cast back once.  That
    is the program XLA compiles the JAX package's bf16 ``psum`` and
    GSPMD's partial sums to (an f32 all-reduce between two converts),
    and an f32 sum depends only on the order of the ranks, where a
    16-bit one rounds at each add.  Every reduction of a partial result
    in the port goes through here; an f32 tensor is redistributed as it
    is."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Constrain.apply(x, mesh, pl,
                                tuple(pl if grad_pl is None else grad_pl))
    return _reduce(x, mesh, pl)


class _FanOut(torch.autograd.Function):
    """``n`` uses of ``x``, their gradients summed by `fan_out`'s rule."""

    @staticmethod
    def forward(ctx, x, n):
        ctx.dtype, ctx.mesh, ctx.pl = x.dtype, x.device_mesh, x.placements
        return tuple(x.view_as(x) for _ in range(n))

    @staticmethod
    def backward(ctx, *gs):
        sums = {}
        for g in gs:
            if g is not None:
                pl, g = tuple(g.placements), _recast(g, torch.float32)
                sums[pl] = sums[pl] + g if pl in sums else g
        total = None
        for part in sums.values():
            part = _reduce(part, ctx.mesh, ctx.pl)
            total = part if total is None else total + part
        return (None if total is None else _recast(total, ctx.dtype)), None


def fan_out(x, n: int):
    """``x`` once for each of ``n`` uses (the products of one input with
    several weights), their gradients summed here rather than by
    autograd: in f32, the parts of one placement added, each such sum
    reduced onto ``x``'s placements under `redistribute`'s rule, the
    total rounded once to ``x``'s type.  Where some uses' gradients are
    partial sums and others whole (a query projection split over 'model'
    beside key and value heads that are not), DTensor would otherwise
    reduce the partial one in 16 bits to add them, on some torch
    versions.  Any tensor but a 16-bit DTensor being differentiated
    comes back ``n`` times as it is."""
    if (is_dtensor(x) and x.dtype in _WIDENED and x.requires_grad
            and torch.is_grad_enabled()):
        return _FanOut.apply(x, n)
    return (x,) * n


def widen(x):
    """``x`` in f32 for an f32 product (the JAX package's
    ``preferred_element_type=float32``).  The gradient of a 16-bit
    DTensor parameter is reduced across ranks in f32 onto the
    parameter's placements (`redistribute` of the cast, its forward a
    no-op) before the cast's one rounding to ``x``'s type, as XLA
    reduces the f32 output of the transposed product; autograd alone
    would round each rank's part first.  Any other tensor is cast as it
    is."""
    t = x.to(torch.float32)
    if is_dtensor(t) and x.dtype in _WIDENED and t.requires_grad:
        return redistribute(t, t.device_mesh, t.placements)
    return t


def shard(x, *logical_axes: Optional[str]):
    """``with_sharding_constraint``: ``x`` redistributed to the logical
    axes' placements when a mesh is bound and ``x`` is a DTensor (its
    gradient too), the identity otherwise.  Raises when the axes do not
    match ``x``'s rank, as the JAX package does whenever a mesh is
    bound.  A dimension its mesh axes do not divide (``long_500k``'s one
    decode token over 'data') stays whole where GSPMD would pad it: an
    uneven DTensor split has no rule in most ops."""
    mesh = _CTX.mesh
    if mesh is None:
        return x
    if len(logical_axes) != x.ndim:
        raise ValueError(f"{len(logical_axes)} axes for rank-{x.ndim} array")
    if not is_dtensor(x):
        return x
    sizes = axis_sizes(mesh)
    spec = [None if e is not None and x.shape[d] % int(np.prod(
        [sizes[a] for a in ((e,) if isinstance(e, str) else e)])) else e
        for d, e in enumerate(spec_of(*logical_axes))]
    return redistribute(x, mesh, placements(mesh, spec))


def named_sharding(*logical_axes: Optional[str]):
    """``(mesh, placements)`` of the logical axes on the bound mesh (the
    JAX ``NamedSharding``); raises without `logical_mesh`."""
    if _CTX.mesh is None:
        raise RuntimeError("no mesh bound: use logical_mesh")
    return _CTX.mesh, placements(_CTX.mesh, spec_of(*logical_axes))


def shard_map_compat(f, *, mesh, in_specs, out_specs):
    """``shard_map`` as ``local_map``: ``f`` runs on each rank's local
    tensors.  A spec is a `PartitionSpec` or, where a result is a partial
    sum (a JAX ``psum`` left to the caller, so that autograd carries it),
    a sequence of DTensor placements; ``out_specs`` is one spec or a
    tuple of them, as ``f`` returns one tensor or a tuple."""
    from torch.distributed.tensor.experimental import local_map

    def to_pl(spec):        # a list: local_map reads a tuple as several
        if spec is None:
            return None
        if isinstance(spec, PartitionSpec):
            return list(placements(mesh, spec))
        return list(spec)

    one = isinstance(out_specs, PartitionSpec) or not any(
        isinstance(s, (tuple, list)) for s in out_specs)
    outs = (to_pl(out_specs) if one
            else tuple(to_pl(s) for s in out_specs))
    ins = tuple(to_pl(s) for s in in_specs)
    # an input replicated over a mesh dimension that another input is
    # split over gets a different gradient on each rank of it: a partial
    # sum (JAX's shard_map sums the cotangent of an unmapped input)
    from torch.distributed.tensor import Partial, Replicate
    split = {i for pl in ins if pl for i, p in enumerate(pl)
             if p.is_shard()}
    grads = tuple(None if pl is None else [
        Partial() if i in split and isinstance(p, Replicate) else p
        for i, p in enumerate(pl)] for pl in ins)
    mapped = local_map(f, out_placements=outs, in_placements=ins,
                       in_grad_placements=grads, device_mesh=mesh,
                       redistribute_inputs=True)

    def placed(x, pl, gpl):
        # a 16-bit input whose gradient is a partial sum (where ``grads``
        # says so) or that local_map would redistribute is placed here:
        # its gradient is reduced onto its placements in f32 (FSDP's
        # weights gathered over 'data' get an f32 reduce-scatter), where
        # local_map and DTensor would reduce it in 16 bits
        if pl is None or not is_dtensor(x) or x.dtype not in _WIDENED \
                or (tuple(x.placements) == tuple(pl)
                    and not any(p.is_partial() for p in gpl)):
            return x
        return redistribute(x, mesh, pl, grad_pl=[
            Replicate() if p.is_partial() else p for p in x.placements])

    def call(*args, **kwargs):
        return mapped(*(placed(x, pl, gpl) for x, pl, gpl
                        in zip(args, ins, grads, strict=True)), **kwargs)

    return call


@contextlib.contextmanager
def dtensor_context(*tensors):
    """Where any of ``tensors`` is a DTensor, the context in which plain
    tensors meet DTensors as replicated ones (``implicit_replication``:
    positions, masks, the schedule's scalars, as JAX broadcasts an
    unsharded constant); else a no-op.  Nested uses keep it on until the
    outermost one exits (``implicit_replication`` itself switches it off
    at any exit, under a backward pass still to come)."""
    if not any(is_dtensor(t) for t in tensors):
        yield
        return
    from torch.distributed.tensor import DTensor
    disp = DTensor._op_dispatcher
    prev = disp._allow_implicit_replication
    disp._allow_implicit_replication = True
    try:
        yield
    finally:
        disp._allow_implicit_replication = prev
