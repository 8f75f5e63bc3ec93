"""Public MIPS / NNS API of the port (from ``repro.core.mips``).

``mips_topk`` is the user-facing entry point: zero preprocessing, explicit
(eps, delta) suboptimality knob.  It runs on the card by default (one
`repro_torch.kernels.ops.fused_cascade` launch per call) and on the CPU,
through the kernel's plain PyTorch version, with ``device="cpu"``.
``sharded_mips_topk`` serves a batch over a row-sharded table (one
batched launch per shard and a top-K merge), over the serving `Mesh` or
a ``DeviceMesh`` (under ``local_map``, as the JAX package's runs under
``shard_map``); the serving engine's
multi-device path, ``sharded_bounded_me_decode``, is re-exported here
from `repro_torch.distributed.sharding`, as in the JAX package.
"""

from __future__ import annotations

import math
import weakref
from typing import Optional, Tuple

import torch

from repro_torch.core.boundedme_torch import (BlockedPlan, _check_perm,
                                              _pad_operands,
                                              bounded_me_blocked,
                                              cascade_tiled, make_plan,
                                              quantize_table, resolve_device,
                                              tile_table)
from repro_torch.distributed.sharding import (PartitionSpec, _batch_input,
                                              _check_axis, axis_sizes,
                                              device_guard, is_device_mesh,
                                              merge_gathered, merge_topk,
                                              mesh_table_shards, rank_along,
                                              shard_map_compat,
                                              sharded_bounded_me_decode,
                                              stage_batch)

__all__ = ["mips_topk", "nns_topk", "sharded_mips_topk", "exact_topk",
           "sharded_bounded_me_decode", "default_value_range",
           "table_abs_max"]


def exact_topk(V: torch.Tensor, q: torch.Tensor, K: int = 1
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exhaustive baseline: full matvec + top-K.  Scores are (q.v)/N.
    Operands of two float types meet in the wider one (a bf16 table and
    an f32 query: an f32 product), as in the JAX package."""
    dt = torch.promote_types(V.dtype, q.dtype)
    scores = (V.to(dt) @ q.to(dt)).to(torch.float32) / V.shape[1]
    vals, ids = torch.topk(scores, K)
    return ids, vals


class _TableMaxCache:
    """Host-side cache of max|V| per table object.

    The product-range bound needs an O(nN) reduction over the table, so
    it is computed once per table.  Keyed by ``id(table)`` with a weakref
    guard against id reuse, as in the JAX package.  Torch tensors, unlike
    JAX arrays, change in place, so an entry also holds the tensor's
    version counter (``_version``, bumped by every in-place write) and a
    table edited since is reduced again.  A table that cannot be weakly
    referenced is held strongly, so the dict is evicted FIFO past
    ``_CAP`` tables.
    """

    _CAP = 16

    def __init__(self):
        self._entries = {}

    def get(self, V) -> float:
        key = id(V)
        version = getattr(V, "_version", None)
        hit = self._entries.get(key)
        if hit is not None:
            ref, seen, vmax = hit
            if ref() is not None and seen == version:
                return vmax
            del self._entries[key]
        vmax = float(torch.as_tensor(V).abs().max())
        try:
            ref = weakref.ref(V)
        except TypeError:                    # non-weakref-able table type
            ref = (lambda strong=V: strong)  # strong ref; FIFO-evicted
        if len(self._entries) >= self._CAP:
            self._entries.pop(next(iter(self._entries)))
        self._entries[key] = (ref, version, vmax)
        return vmax


_TABLE_MAX = _TableMaxCache()


def table_abs_max(V) -> float:
    """max|V_ij| as a host float, computed once per table (and again
    after an in-place edit) and cached."""
    return _TABLE_MAX.get(V)


def default_value_range(V, q) -> float:
    """Conservative data-derived product range 2 max|q| max|V|.

    The per-table reduction is cached host-side; the per-query max is
    O(N).  Hot-path callers should pass an explicit ``value_range``.
    """
    qmax = float(torch.as_tensor(q).abs().max())
    return max(2.0 * qmax * table_abs_max(V), 1e-12)


def mips_topk(V, q, K: int = 1, *, method: str = "boundedme",
              eps: float = 0.05, delta: float = 0.05,
              value_range: Optional[float] = None, perm=None,
              generator: Optional[torch.Generator] = None, tile: int = 8,
              block: int = 512, final_exact: bool = False,
              precision: str = "fp32", adaptive: bool = False,
              bound: str = "hoeffding", pull_mode: str = "row",
              coord_block: int = 128, quant_err: Optional[float] = None,
              pq_subdims: int = 8, pq_codes: int = 16, device="cuda"):
    """Top-K maximum inner product search over the rows of ``V``.

    Zero preprocessing: ``V`` can be swapped or edited between calls with
    no index rebuild; the per-table max of the default ``value_range`` is
    the only cached state.

    Args:
      V: (n, N) float table, rows are arms.  q: (N,) float query.
      K: number of results, 1 <= K <= n.
      method: 'boundedme' (the paper's bandit) or 'exact' (full matvec
        and top-K; ignores every knob below).
      eps / delta: returned arms are eps-optimal on the mean-product
        scale (q . v)/N with probability >= 1 - delta, at block-mean
        granularity.
      value_range: a-priori bound on per-coordinate products; defaults
        to `default_value_range`.
      perm: the block permutation, ``(n_blocks,)``, in place of the JAX
        package's key; without it one is drawn from ``generator``
        (default seeded 0, so repeated calls agree).
      tile / block / final_exact / precision / adaptive / bound /
      pull_mode / coord_block / quant_err / pq_subdims / pq_codes: as in
        ``repro.core.mips.mips_topk``; see `bounded_me_blocked`.  As
        there, the adaptive ``rounds_used`` is dropped here.
      device: ``"cuda"`` (default) runs the CUDA kernel and raises
        without a card; ``"cpu"`` runs the plain PyTorch version.

    Returns:
      ``(ids (K,) int32, scores (K,) float32)`` on ``device``; scores
      estimate (q . v)/N (exact with ``final_exact``).

    Raises:
      ValueError: unknown ``method``.
    """
    dev = resolve_device(device)
    if method == "exact":
        V = torch.as_tensor(V, dtype=torch.float32).to(dev)
        return exact_topk(V, torch.as_tensor(q, dtype=torch.float32).to(dev),
                          K)
    if method != "boundedme":
        raise ValueError(f"unknown method {method!r}")
    if value_range is None:
        value_range = default_value_range(V, q)
    out = bounded_me_blocked(
        V, q, perm, K=K, eps=eps, delta=delta, value_range=value_range,
        tile=tile, block=block, final_exact=final_exact,
        precision=precision, adaptive=adaptive, bound=bound,
        pull_mode=pull_mode, coord_block=coord_block, quant_err=quant_err,
        pq_subdims=pq_subdims, pq_codes=pq_codes, generator=generator,
        device=dev)
    return out[0], out[1]


def nns_topk(V, q, K: int = 1, **kw):
    """Nearest-neighbour search via the paper's reduction
    f(i, j) = -(q_j - v_ij)^2.

    -|q - v|^2 = 2 q.v - |v|^2 - |q|^2, so the search runs as MIPS over
    rows [sqrt(2) v_i, -|v_i|^2] against the query [sqrt(2) q, 1]: one
    extra coordinate.  Keywords as in `mips_topk`; the augmented table
    is built on ``device``.
    """
    dev = resolve_device(kw.get("device", "cuda"))
    V = torch.as_tensor(V, dtype=torch.float32).to(dev)
    q = torch.as_tensor(q, dtype=torch.float32).to(dev)
    root2 = torch.tensor(math.sqrt(2.0), dtype=torch.float32, device=dev)
    aug_V = torch.cat([root2 * V, -(V * V).sum(dim=1, keepdim=True)], dim=1)
    aug_q = torch.cat([root2 * q, torch.ones(1, dtype=q.dtype, device=dev)])
    return mips_topk(aug_V, aug_q, K, **kw)


def sharded_mips_topk(table, queries, perms, K: int, *, mesh,
                      model_axis: str = "model", batch_axes=None,
                      n_valid: Optional[int] = None,
                      plan: Optional[BlockedPlan] = None, eps: float = 0.05,
                      delta: float = 0.05, value_range: float = 4.0,
                      tile: int = 8, block: int = 512,
                      final_exact: bool = True, precision: str = "fp32",
                      pull_mode: str = "row", coord_block: int = 128,
                      quant_err: Optional[float] = None,
                      pq_subdims: int = 8, pq_codes: int = 16):
    """Batched MIPS over a row-sharded table: shard-local bandits, K-merge.

    ``table`` (n, N) is split into ``shards`` row blocks of n / shards
    (n must divide evenly; `sharded_bounded_me_decode` serves ragged
    tables), one per device of ``mesh``.  Every shard runs the same
    static plan on its rows (delta split across shards by union bound;
    a quantized shard quantizes its own rows) for the whole batch in ONE
    batched fused-cascade launch with per-query permutations, then the
    global top-K of the shards' K winners is taken on
    ``mesh.devices[0]`` — lower position first on ties, as
    ``jax.lax.top_k``.

    Args:
      table: (n, N) float arm matrix.  queries: (B, N) query batch.
      perms: (B, n_blocks) per-query block permutations, in place of the
        JAX package's per-query keys.
      K / eps / delta / value_range / tile / block / final_exact /
        precision / pull_mode / coord_block / quant_err / pq_subdims /
        pq_codes: as in `mips_topk` ('pq' needs ``quant_err`` or a
        ``plan``); ``plan``, when given, is the shard plan.
      mesh: the serving `repro_torch.distributed.sharding.Mesh`
        (``model_axis`` must be ``"model"`` and ``batch_axes`` None: the
        batch is replicated), or a ``DeviceMesh``: rows over
        ``model_axis``, queries and perms over ``batch_axes``, each rank
        laying out its own rows and the K-merge after one all-gather of
        its winners over ``model_axis``; the results are then DTensors.
      n_valid: real row count when ``table`` carries padding rows (e.g. a
        padded vocab); padding is masked out of the merge.

    Returns:
      ``(ids (B, K) int32, scores (B, K) float32)``.
    """
    if is_device_mesh(mesh):
        return _mesh_mips_topk(table, queries, perms, K, mesh=mesh,
                               model_axis=model_axis, batch_axes=batch_axes,
                               n_valid=n_valid, plan=plan,
                               final_exact=final_exact, eps=eps,
                               delta=delta, value_range=value_range,
                               tile=tile, block=block, precision=precision,
                               pull_mode=pull_mode, coord_block=coord_block,
                               quant_err=quant_err, pq_subdims=pq_subdims,
                               pq_codes=pq_codes)
    _check_axis(model_axis)
    if batch_axes is not None:
        raise ValueError("batch_axes must be None on the serving Mesh: it "
                         "has only the row axis (a DeviceMesh takes them)")
    S = len(mesh.devices)
    n, N = table.shape
    if n % S != 0:
        raise ValueError(f"{n} rows do not split evenly over {S} shards; "
                         f"use sharded_bounded_me_decode for a ragged table")
    n_local = n // S
    if plan is None:
        plan = make_plan(n_local, N, K=K, eps=eps, delta=delta / S,
                         value_range=value_range, tile=tile, block=block,
                         precision=precision, pull_mode=pull_mode,
                         coord_block=coord_block, quant_err=quant_err,
                         pq_subdims=pq_subdims, pq_codes=pq_codes)
    table = torch.as_tensor(table)
    Q = torch.as_tensor(queries, dtype=torch.float32)
    if torch.as_tensor(perms).shape != (Q.shape[0], plan.n_blocks):
        raise ValueError(f"perms must be ({Q.shape[0]}, {plan.n_blocks})")
    # table shards, their artifacts, queries and perms all staged before
    # the first launch, which nothing then waits for
    shards = []
    for s, dev in enumerate(mesh.devices):
        V4 = tile_table(table[s * n_local:(s + 1) * n_local], plan, dev)
        shards.append((V4, quantize_table(V4, plan)
                       if plan.precision != "fp32" else None))
    batch = stage_batch(Q, perms, mesh, plan)
    parts = []
    for s, dev in enumerate(mesh.devices):
        (V4, quant), (Qp, perm_d) = shards[s], batch[dev]
        with device_guard(dev):
            ids, scores = cascade_tiled(
                V4, Qp, perm_d, plan=plan, batched=True,
                final_exact=final_exact, k_out=plan.K, n_valid=plan.n,
                quantized=quant)
            gids = ids + s * n_local
            if n_valid is not None and n_valid < n:
                # vocab-padding rows (zeros) must never win the merge
                scores = torch.where(gids < n_valid, scores,
                                     torch.full_like(scores, -torch.inf))
            parts.append((gids, scores))
    home = mesh.devices[0]
    return merge_topk(torch.cat([p[0].to(home) for p in parts], dim=1),
                      torch.cat([p[1].to(home) for p in parts], dim=1), K)


def _mesh_mips_topk(table, queries, perms, K: int, *, mesh, model_axis,
                    batch_axes, n_valid, plan, final_exact: bool,
                    **plan_knobs):
    """`sharded_mips_topk` over a ``DeviceMesh``, the JAX package's
    ``shard_map`` body under ``local_map``: each rank's batched cascade
    on its rows with its queries' perms, its winners' global ids (the
    padding rows past ``n_valid`` at -inf), the all-gather over
    ``model_axis`` and the top K."""
    S = axis_sizes(mesh)[model_axis]
    n, N = table.shape
    if n % S != 0:
        raise ValueError(f"{n} rows do not split evenly over {S} shards; "
                         f"use sharded_bounded_me_decode for a ragged table")
    n_local = n // S
    if plan is None:
        plan = make_plan(n_local, N, K=K, **dict(
            plan_knobs, delta=plan_knobs["delta"] / S))
    shards = mesh_table_shards(table, mesh, plan, k_out=plan.K,
                               model_axis=model_axis)
    B = queries.shape[0]
    perms = _check_perm(perms, plan.n_blocks, torch.device("cpu"))
    if tuple(perms.shape) != (B, plan.n_blocks):
        raise ValueError(f"perms must be ({B}, {plan.n_blocks})")
    bspec = PartitionSpec(batch_axes, None)
    args = [shards.V4, _batch_input(torch.as_tensor(queries,
                                                    dtype=torch.float32),
                                    mesh, bspec),
            _batch_input(perms, mesh, bspec), *(shards.quantized or ())]
    specs = [PartitionSpec(model_axis, None, None, None), bspec, bspec]
    specs += [PartitionSpec(model_axis, *(None,) * (t.dim() - 1))
              for t in shards.quantized or ()]

    def local(V4_l, Q_l, P_l, *quant):
        _, Qp = _pad_operands(None, Q_l, plan)
        ids, scores = cascade_tiled(
            V4_l, Qp, P_l, plan=plan, batched=True,
            final_exact=final_exact, k_out=plan.K, n_valid=plan.n,
            quantized=quant or None)
        gids = ids + rank_along(mesh, model_axis) * n_local
        if n_valid is not None and n_valid < n:
            # vocab-padding rows (zeros) must never win the merge
            scores = torch.where(gids < n_valid, scores,
                                 torch.full_like(scores, -torch.inf))
        top_ids, vals, _ = merge_gathered(mesh, model_axis, K, gids, scores)
        return top_ids, vals

    return shard_map_compat(local, mesh=mesh, in_specs=tuple(specs),
                            out_specs=(bspec, bspec))(*args)
