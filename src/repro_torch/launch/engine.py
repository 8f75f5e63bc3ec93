"""Serving engine internals of the port: executor, micro-batch engine and
continuous-batching runtime.

The PyTorch counterpart of ``repro.launch.engine`` on one device (the
admission/policy half lives in
`repro_torch.launch.admission`, fault injection in
`repro_torch.launch.faults`):

  * :class:`CascadeExecutor` — owns the table (a static one re-laid
    tile-major once, and on the int8, int4 and pq tiers quantized once;
    a store's read in place), the calibrated (eps, delta) plan and the
    cached schedule operands; `dispatch` serves a padded lane buffer with
    ONE fused-cascade launch and returns host arrays plus the measured
    seconds.
  * :class:`MIPSServeEngine` — the micro-batching request loop over one
    executor: batch/deadline triggers, `QuantizedLRU`, sampled recall.
  * :class:`ServeRuntime` — the continuous-batching runtime: a bounded
    priority queue (`AdmissionController`) feeds fixed kernel lanes that
    are refilled between dispatches, a `DegradationLadder` of executors
    (one per eps rung) relaxes eps toward a floor under pressure before
    anything is refused, and every dispatch runs under
    `dispatch_with_retries` with poison quarantine; every request ends
    as a typed `ServeResult`.

The table is a static tensor or array, or a live
`repro_torch.store.DynamicTableStore`: the engines drain its staged
mutations between dispatches, and every executor reads its tiled table
and shadow in place.  With ``mesh`` (a `repro_torch.distributed.
sharding.Mesh`) the table is row-sharded over the mesh's devices — a
static table once at construction, a `repro_torch.store.
ShardedTableStore` read in place — and each dispatch is one fused-cascade
launch per shard plus the exact cross-shard merge
(`repro_torch.distributed.sharding.sharded_decode_tiled`).  The engine
and the runtime draw each dispatch's block permutation from a
``torch.Generator`` seeded from ``(seed, dispatch sequence)``
(`seeded_perm`); ``perm_source`` replaces that draw (tests inject the
JAX package's permutations through it).
"""

from __future__ import annotations

import collections
import dataclasses
import struct
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.boundedme_torch import (as_kept, decode_operands,
                                              decode_tiled, make_plan,
                                              measured_plan_quant_err,
                                              quantize_table, resolve_device,
                                              tile_table)
from repro_torch.core.mips import exact_topk, table_abs_max
from repro_torch.core.schedule import pulls_through_round
from repro_torch.distributed.sharding import (dispatch_lane_stats,
                                              make_shard_plan,
                                              quantize_shards,
                                              shard_valid_counts,
                                              sharded_decode_tiled)
from repro_torch.distributed.specs import serving_table_sharding
from repro_torch.launch.admission import (AdmissionController,
                                          DegradationLadder, PriorityClass,
                                          ServeResult, Ticket)
from repro_torch.obs.metrics import (PULL_FRAC_BUCKETS, MetricsRegistry,
                                     summarize_latencies)
from repro_torch.obs.trace import span
from repro_torch.store import (DynamicTableStore, ShardedTableStore,
                               StoreFlushError)

__all__ = ["QuantizedLRU", "CascadeExecutor", "MIPSServeEngine",
           "ServeRuntime", "DispatchFailed", "dispatch_with_retries",
           "seeded_perm"]


class DispatchFailed(RuntimeError):
    """A dispatch exhausted its retry budget (`dispatch_with_retries`).

    Carries the last ``cause`` exception, the number of ``retries``
    burned and the accumulated virtual ``backoff`` seconds so the
    caller can fail the batch with honest accounting.
    """

    def __init__(self, cause: Exception, retries: int, backoff: float):
        super().__init__(f"dispatch failed after {retries} retries: {cause}")
        self.cause = cause
        self.retries = retries
        self.backoff = backoff


def dispatch_with_retries(ex, Qbuf, perm, *, didx: int, injector=None,
                          max_retries: int = 2,
                          retry_backoff_s: float = 1e-3,
                          on_error=None, on_retry=None):
    """One executor dispatch under the runtime's fault contract.

    Runs ``ex.dispatch(Qbuf, perm)`` with exponential-backoff retries,
    consulting the deterministic fault ``injector`` (attempt-level
    injected errors, post-success latency spikes); every retry of one
    ``didx`` reuses its ``perm``.  ``on_error(exc, attempt, injected)``
    fires per failing attempt, ``on_retry(attempt, backoff)`` per retry
    decision — both before the backoff grows.  Returns ``(ids, scores,
    rounds, dt, retries, backoff, spike)`` where ``dt`` already includes
    the injected ``spike`` and accumulated ``backoff`` (virtual seconds);
    raises `DispatchFailed` past ``max_retries``.  Every exception is
    caught by design: a caller that must tell a real fault from an
    injected one compares its error count with the injector's.
    """
    attempt = 0
    backoff = 0.0
    while True:
        injected = (injector.dispatch_error(didx, attempt)
                    if injector is not None else None)
        try:
            if injected is not None:
                raise injected
            ids, scores, rounds, dt = ex.dispatch(Qbuf, perm)
            break
        except Exception as e:
            if on_error is not None:
                on_error(e, attempt, injected is not None)
            if attempt >= max_retries:
                raise DispatchFailed(e, attempt, backoff) from e
            if on_retry is not None:
                on_retry(attempt, backoff)
            backoff += retry_backoff_s * (2.0 ** attempt)
            attempt += 1
    spike = injector.latency_s(didx) if injector is not None else 0.0
    return ids, scores, rounds, dt + spike + backoff, attempt, backoff, spike


class QuantizedLRU:
    """LRU result cache keyed on quantized queries.

    Keys are the bytes of ``round(q / resolution)`` (int64): any two
    queries within ``resolution`` per coordinate share a cache line, which
    is exactly the granularity at which an (eps, delta)-approximate answer
    is reusable.  ``resolution=0`` disables quantization sharing (exact
    byte equality only).  Capacity 0 disables the cache entirely.
    """

    def __init__(self, capacity: int, resolution: float = 1e-3):
        self.capacity = int(capacity)
        self.resolution = float(resolution)
        self._od: "collections.OrderedDict[bytes, object]" = \
            collections.OrderedDict()
        self.hits = 0
        self.misses = 0
        self.invalidations = 0

    def key(self, q: np.ndarray) -> bytes:
        """Quantize a (N,) query to its cache key."""
        if self.resolution > 0:
            return np.round(np.asarray(q, np.float32)
                            / self.resolution).astype(np.int64).tobytes()
        return np.asarray(q, np.float32).tobytes()   # exact bytes only

    def get(self, key: bytes):
        """Return the cached value or None; counts the hit/miss."""
        hit = self._od.get(key)
        if hit is None:
            self.misses += 1
            return None
        self._od.move_to_end(key)
        self.hits += 1
        return hit

    def put(self, key: bytes, value) -> None:
        """Insert/update; evicts the least-recently-used past capacity."""
        if self.capacity <= 0:
            return
        self._od[key] = value
        self._od.move_to_end(key)
        while len(self._od) > self.capacity:
            self._od.popitem(last=False)

    def invalidate(self) -> None:
        """Drop every entry (a table version bump makes cached answers
        stale).  Hit/miss counters survive; ``invalidations`` counts the
        calls.  The engines also salt their keys with the table version.
        """
        self._od.clear()
        self.invalidations += 1

    def __len__(self) -> int:
        return len(self._od)


@dataclasses.dataclass
class _Pending:
    req_id: int
    q: np.ndarray
    t_submit: float
    cache_key: Optional[bytes]


class CascadeExecutor:
    """The executor layer: one calibrated (eps, delta) dispatch path.

    Owns the item table — a static table, re-laid tile-major on
    ``device`` once, or a live `repro_torch.store.DynamicTableStore`,
    whose tiled table and shadow every dispatch reads in place — plus
    the `make_plan` calibration for exactly one eps point.  On the int8,
    int4 and pq tiers a static table is quantized once here; a store
    maintains its own shadow.  pq calibrates its measured ``quant_err``
    on the served table unless one is given (re-measured at every
    rebuild).  Schedulers (`MIPSServeEngine`, `ServeRuntime`) own queues,
    caches and results; the executor serves a full lane buffer:

      * `dispatch` runs one fused-cascade launch over a padded ``(lanes,
        N)`` query buffer (one per shard under a mesh) and returns host
        arrays plus the measured seconds (ending in
        ``torch.cuda.synchronize()`` on the card);
      * `sync_store` re-derives the plan when the store's capacity or
        monotonic value range outgrows the calibrated bound (counted in
        ``n_recalibrations``);
      * `recall_of` rescoring a query exhaustively against the live
        table; `external_ids` mapping served slots to the store's ids.

    **Sharded serving** (``mesh``, DESIGN.md §7): the plan is the shard
    plan of `make_shard_plan` and each dispatch runs
    `sharded_decode_tiled`.  A static table is padded and split into row
    shards once, each laid out tile-major (and on a quantized tier
    quantized over its own rows) on its device; a `ShardedTableStore`'s
    shards are read in place, with the codes the store keeps at the
    plan's geometry (`ShardedTableStore.shard_operands`: one copy per
    store version, shared by every rung, bitwise a fresh quantization of
    each shard's current rows).  A mesh needs a static table or a
    `ShardedTableStore`; ``coord`` and ``hybrid`` serve every tier there.

    A `ServeRuntime` holds one executor per degradation-ladder rung; on
    a store they all read the store's tiled tables.
    """

    def __init__(self, table, *, K: int = 1, eps: float = 0.1,
                 delta: float = 0.1, value_range: Optional[float] = None,
                 qmax_hint: float = 1.0, tile: int = 8, block: int = 512,
                 mesh=None, n_valid: Optional[int] = None,
                 precision: str = "fp32", range_slack: float = 1.0,
                 adaptive: bool = False,
                 bound: str = "hoeffding", pull_mode: str = "row",
                 coord_block: int = 128, quant_err: Optional[float] = None,
                 pq_subdims: int = 8, pq_codes: int = 16,
                 metrics: Optional[MetricsRegistry] = None,
                 metrics_labels: Optional[Dict[str, str]] = None,
                 device="cuda"):
        self.store = (table if isinstance(table, (DynamicTableStore,
                                                  ShardedTableStore))
                      else None)
        if self.store is None and not isinstance(table, (torch.Tensor,
                                                          np.ndarray)):
            raise TypeError(f"table must be a tensor, an array, a "
                            f"DynamicTableStore or a ShardedTableStore, "
                            f"got {type(table).__name__}")
        self._qmax_hint = float(qmax_hint)
        self._range_slack = float(range_slack)
        if isinstance(self.store, ShardedTableStore):
            if mesh is not None and mesh is not self.store.mesh:
                raise ValueError("mesh differs from the store's mesh")
            mesh = self.store.mesh
        elif self.store is not None and mesh is not None:
            raise ValueError("serving a mesh needs a ShardedTableStore")
        self.mesh = mesh
        if self.store is not None:
            store = self.store
            if n_valid is not None:
                raise ValueError("n_valid is store-managed")
            self.device = (mesh.devices[0] if mesh is not None
                           else store.device)
            # the store owns the kernel geometry (its shadow and the
            # executor's plan must agree tile for tile)
            tile, block = store.tile, store.block
            if store.precision != "fp32":
                precision = store.precision
                if store.precision == "pq":
                    pq_subdims = store.pq_subdims
                    pq_codes = store.pq_codes
            n, N = store.capacity_rows, store.N
            # clamp to the store's observed range as sync_store does on
            # growth: a churned executor and a fresh executor on the
            # store's snapshot then calibrate identical plans
            floor = 2.0 * self._qmax_hint * max(store.value_abs_max, 1e-30)
            value_range = (floor if value_range is None
                           else max(float(value_range), floor))
            if store.precision != "fp32" and pull_mode != "row":
                # the shadow's cells are fixed at the store's block width;
                # a coord (or coord-resolvable hybrid) plan re-blocks the
                # feature axis, which the shadow cannot serve
                raise ValueError(
                    f"pull_mode={pull_mode!r} is incompatible with a "
                    f"single-device {store.precision} store shadow (its "
                    f"quantization cells are fixed at the store's block "
                    f"width); use pull_mode='row', an fp32 store, or a "
                    f"ShardedTableStore")
        else:
            self.device = (mesh.devices[0] if mesh is not None
                           else resolve_device(device))
            # a bf16 table stays bf16 (its tiled copy too), as the JAX
            # executor serves a bf16 model's embedding in its own dtype
            self._table = as_kept(table, self.device)
            n, N = self._table.shape
            if value_range is None:
                # a-priori product-range bound: callers who know their
                # query norms should pass an explicit value_range instead
                value_range = 2.0 * self._qmax_hint * table_abs_max(
                    self._table)
        self.n, self.N, self.K = n, N, K
        self.eps, self.delta = float(eps), float(delta)
        self.adaptive = bool(adaptive)
        self._tile, self._block = int(tile), min(int(block), N)
        self._precision, self._bound = precision, bound
        self._pull_mode, self._coord_block = pull_mode, int(coord_block)
        self._quant_err = quant_err
        self._pq_subdims, self._pq_codes = int(pq_subdims), int(pq_codes)
        self._build(float(value_range))
        if self.store is None:
            self._nv = n if n_valid is None else int(n_valid)
            if mesh is None:
                self._V4 = tile_table(self._table, self.plan, self.device)
                self._quant = (quantize_table(self._V4, self.plan)
                               if self.plan.precision != "fp32" else None)
            else:
                # padded and split once; no unsharded tiled copy is kept
                self._shards = serving_table_sharding(self._table, mesh,
                                                      self.plan)
                self._shard_quant = quantize_shards(self._shards, self.plan)
        elif mesh is not None:
            # the store's operands at this plan's geometry, built now and
            # at every flush, not in a dispatch
            self.store.shard_operands(self.plan)
        # the store's table re-laid at a coord plan's pull width, keyed
        # on the store's (version, capacity); fp32 stores only
        self._relaid = (None, None)
        # cascade_* metrics: one labeled row per executor identity, so the
        # runtime's rung executors (a "rung" label via metrics_labels)
        # share metric families without colliding
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        lbl = {"precision": str(precision), "pull_mode": str(pull_mode),
               "eps": f"{self.eps:.6g}"}
        lbl.update({str(k): str(v) for k, v in (metrics_labels or {}).items()})
        self._mlabels = lbl
        keys = tuple(lbl)
        self._c_dispatch = self.metrics.counter(
            "cascade_dispatches_total",
            "Fused-cascade kernel launches (includes warmup).", keys)
        self._c_recal = self.metrics.counter(
            "cascade_recalibrations_total",
            "Plan re-derivations triggered by store growth.", keys)
        self._h_dispatch = self.metrics.histogram(
            "cascade_dispatch_ms",
            "Measured blocking compute time per dispatch (ms).", keys)
        self._c_dispatch.seed(**lbl)
        self._c_recal.seed(**lbl)

    def _build(self, value_range: float) -> None:
        """(Re)build the plan and its schedule operands for a value range.

        Called once at construction and again only when `sync_store`
        observes the store's capacity or monotonic value range outgrowing
        the calibrated bound.  A pq plan without an explicit
        ``quant_err`` re-measures it on the served table (the whole
        table, on a mesh too).  Under a mesh the plan is the shard plan.
        """
        self._plan_value_range = float(value_range)
        tile, block = self._tile, self._block
        quant_err = self._quant_err
        if self._precision == "pq" and quant_err is None:
            # pq has no a-priori worst-case model: calibrate a measured
            # per-pull bound on the served table; a hybrid plan prices two
            # pull widths with different codebooks, so take the max
            V_cal = (self.store.device_table() if self.store is not None
                     else self._table)
            widths = {"row": (block,), "coord": (self._coord_block,),
                      "hybrid": (block, self._coord_block)}[self._pull_mode]
            quant_err = max(measured_plan_quant_err(
                V_cal, precision="pq", tile=tile, block=w,
                pq_subdims=self._pq_subdims, pq_codes=self._pq_codes,
                device=self.device) for w in widths)
        kw = dict(K=self.K, eps=self.eps, delta=self.delta,
                  value_range=value_range, tile=tile, block=block,
                  precision=self._precision, bound=self._bound,
                  pull_mode=self._pull_mode, coord_block=self._coord_block,
                  quant_err=quant_err, pq_subdims=self._pq_subdims,
                  pq_codes=self._pq_codes)
        if self.mesh is None:
            self.plan = make_plan(self.n, self.N, **kw)
            devices = (self.device,)
        else:
            self.plan, _, _, self._k_out = make_shard_plan(
                self.n, self.N, len(self.mesh.devices), **kw)
            devices = tuple(dict.fromkeys(self.mesh.devices))
        # the schedule operands every dispatch reads: built now, not in
        # the first request's dispatch
        for dev in devices:
            decode_operands(self.plan, final_exact=True,
                            adaptive=self.adaptive, device=dev)

    @property
    def n_dispatches(self) -> int:
        """Dispatches served (registry-backed)."""
        return int(self._c_dispatch.get(**self._mlabels))

    @property
    def n_recalibrations(self) -> int:
        """Plan re-derivations triggered by the store (registry-backed)."""
        return int(self._c_recal.get(**self._mlabels))

    @property
    def plan_value_range(self) -> float:
        """The value range the current plan was calibrated at."""
        return self._plan_value_range

    @property
    def tiled_table(self) -> torch.Tensor:
        """The tile-major table every dispatch reads: the store's own
        (re-laid at the plan's pull width when that differs from the
        store's block), or the static table's copy.  One device only:
        a mesh's are `shard_operands`."""
        if self.mesh is not None:
            raise ValueError("a sharded executor's tables are per shard; "
                             "see shard_operands()")
        store = self.store
        if store is None:
            return self._V4
        if self.plan.block == store.block:
            return store.tiled_table()
        key = (store.version, store.capacity_rows)
        if self._relaid[0] != key:
            self._relaid = (None, None)      # free before the new copy
            self._relaid = (key, tile_table(store.device_table(), self.plan,
                                            self.device))
        return self._relaid[1]

    def shard_operands(self):
        """``(shards, quantized, n_valid)`` a sharded dispatch reads: each
        shard's tile-major table on its device, its tier artifacts (None
        on fp32) and the per-shard live counts: a static table's shards,
        or a `ShardedTableStore`'s (`ShardedTableStore.shard_operands`)."""
        store = self.store
        if store is None:
            return self._shards, self._shard_quant, shard_valid_counts(
                self._nv, len(self._shards), self.plan.n)
        shards, quant = store.shard_operands(self.plan)
        return shards, quant, store.n_valid_vector()

    @property
    def n_valid(self) -> int:
        """Rows at or past this index never win a ranking (a store's
        live-row count; one device)."""
        return self.store.n_live if self.store is not None else self._nv

    @property
    def quantized(self):
        """The table artifacts every dispatch reads on a quantized tier
        (`quantize_table` layout; a store's shadow), else None (one
        device: a mesh's are `shard_operands`)."""
        if self.mesh is not None:
            raise ValueError("a sharded executor's artifacts are per "
                             "shard; see shard_operands()")
        if self.store is not None:
            return self.store.quantized()
        return self._quant

    def sync_store(self) -> int:
        """Re-derive the plan if the store outgrew it; returns rebuilds.

        Capacity growth (``grow()``) rebuilds the plan at the new row
        count; monotonic value-range growth past the calibrated bound
        re-derives the schedule at ``range * range_slack`` (a slack above
        1 buys headroom, so a growing corpus recalibrates O(log growth)
        times, not per update).  Both are
        counted in ``n_recalibrations``.  No-op without a store.
        """
        store = self.store
        if store is None:
            return 0
        rebuilt = 0
        if store.capacity_rows != self.n:
            self.n = store.capacity_rows
            self._build(self._plan_value_range)
            rebuilt += 1
        needed = 2.0 * self._qmax_hint * store.value_abs_max
        if needed > self._plan_value_range:
            self._build(needed * self._range_slack)
            rebuilt += 1
        if rebuilt:
            self._c_recal.inc(rebuilt, **self._mlabels)
        return rebuilt

    def _synchronize(self) -> None:
        devices = self.mesh.devices if self.mesh is not None else (
            self.device,)
        for dev in dict.fromkeys(devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def dispatch(self, Qbuf: np.ndarray, perm) -> Tuple[
            np.ndarray, np.ndarray, Optional[np.ndarray], float]:
        """Serve one padded (lanes, N) buffer: a single kernel launch, or
        under a mesh one per shard and the exact merge.

        ``perm`` is the batch's shared block permutation.  Returns ``(ids,
        scores, rounds_used, seconds)``, the first three as host arrays
        (``rounds_used`` is None unless adaptive, ``(B,)`` on one device
        and ``(B, shards)`` under a mesh; ids are table slots, see
        `external_ids`); ``seconds`` is the measured blocking time, which
        virtual-clock loops add to their clock.  Spans (`repro_torch.obs.
        trace.span`): ``executor.dispatch`` with ``executor.sync`` and
        ``executor.d2h``.
        """
        with span("executor.dispatch"):
            t0 = time.perf_counter()
            if self.mesh is None:
                out = decode_tiled(self.tiled_table, Qbuf, perm,
                                   plan=self.plan, final_exact=True,
                                   n_valid=self.n_valid,
                                   quantized=self.quantized,
                                   adaptive=self.adaptive)
            else:
                shards, quant, nv = self.shard_operands()
                out = sharded_decode_tiled(
                    shards, Qbuf, perm, mesh=self.mesh, plan=self.plan,
                    K=self.K, k_out=self._k_out, n_valid=nv,
                    final_exact=True, quantized=quant,
                    adaptive=self.adaptive)
                out = (out[0], out[1], out[3]) if self.adaptive else out[:2]
            with span("executor.sync"):
                self._synchronize()
            dt = time.perf_counter() - t0
            self._c_dispatch.inc(**self._mlabels)
            self._h_dispatch.observe(dt * 1e3, **self._mlabels)
            with span("executor.d2h"):
                rounds = out[2].cpu().numpy() if self.adaptive else None
                return out[0].cpu().numpy(), out[1].cpu().numpy(), rounds, dt

    def recall_of(self, q: np.ndarray, got_slots: np.ndarray) -> float:
        """Exact-top-K overlap of a served answer: an exhaustive rescore
        of the live rows (a store's host mirror, as the JAX package's
        executor does; a static table on the executor's device, its
        padding rows masked)."""
        if self.store is not None:
            s = self.store.host_table() @ q
            s[~self.store.live_mask()] = -np.inf
            exact = np.argpartition(-s, self.K - 1)[:self.K]
        else:
            exact, _ = exact_topk(self._table[:self._nv],
                                  torch.from_numpy(q).to(self.device),
                                  self.K)
            exact = exact.tolist()
        return len(set(list(exact)) & set(got_slots.tolist())) / self.K

    def external_ids(self, slots: np.ndarray) -> np.ndarray:
        """Map served slots to the store's stable external ids (a copy of
        the slots on a static table)."""
        if self.store is not None:
            return self.store.external_ids(slots)
        return slots.copy()


def seeded_perm(seed: int, batch_seq: int, n_blocks: int) -> torch.Tensor:
    """The block permutation of flush ``batch_seq`` under ``seed``."""
    state = np.random.SeedSequence([int(seed), int(batch_seq)])
    g = torch.Generator(device="cpu")
    g.manual_seed(int(state.generate_state(1, np.uint64)[0] >> np.uint64(1)))
    return torch.randperm(n_blocks, generator=g)


class MIPSServeEngine:
    """Micro-batching MIPS request loop over an item table.

    Requests (`submit`) are answered from the LRU when a quantized-equal
    query was served recently; otherwise they queue until either
    ``batch_size`` requests are waiting or the oldest has aged past
    ``deadline_ms`` (`poll` applies both triggers), then the whole
    micro-batch is served by ONE fused-cascade dispatch through a
    `CascadeExecutor`.  Results arrive via `result` as ``(ids (K,),
    scores (K,))`` numpy arrays.

    ``recall_sample_rate`` > 0 additionally rescoring a random fraction of
    requests exhaustively on the host and folds top-K recall into `stats`.
    ``perm_source(batch_seq) -> perm`` replaces the engine's own seeded
    permutation draw (`seeded_perm`).

    **Live corpora** (DESIGN.md §11): ``table`` may be a
    `repro_torch.store.DynamicTableStore` (or, with its ``mesh``, a
    `ShardedTableStore`).  The engine then serves the store's capacity
    table with ``n_valid = n_live`` (per shard) at every flush;
    staged mutations are drained by `apply_updates` — called at every
    `submit`, `poll` and `drain`, i.e. between micro-batch flushes —
    which also bumps the engine's table version (salting and
    invalidating the LRU so no stale answer survives) and re-derives the
    plan only when the store's capacity or monotonic value range
    outgrows it.  Returned ids are the store's stable external ids; the
    engine adopts the store's geometry, tier and metrics.  The engine is
    not thread-safe; drive it from one loop.
    """

    def __init__(self, table, *, K: int = 1, eps: float = 0.1,
                 delta: float = 0.1, value_range: Optional[float] = None,
                 qmax_hint: float = 1.0, tile: int = 8, block: int = 512,
                 batch_size: int = 8, deadline_ms: float = 2.0,
                 cache_entries: int = 512, cache_resolution: float = 1e-3,
                 mesh=None, n_valid: Optional[int] = None,
                 recall_sample_rate: float = 0.0,
                 precision: str = "fp32", adaptive: bool = False,
                 bound: str = "hoeffding", pull_mode: str = "row",
                 coord_block: int = 128, quant_err: Optional[float] = None,
                 pq_subdims: int = 8, pq_codes: int = 16, seed: int = 0,
                 metrics: Optional[MetricsRegistry] = None,
                 perm_source: Optional[Callable[[int], object]] = None,
                 device="cuda"):
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._exec = CascadeExecutor(
            table, K=K, eps=eps, delta=delta, value_range=value_range,
            qmax_hint=qmax_hint, tile=tile, block=block, mesh=mesh,
            n_valid=n_valid, precision=precision, adaptive=adaptive,
            bound=bound, pull_mode=pull_mode, coord_block=coord_block,
            quant_err=quant_err, pq_subdims=pq_subdims, pq_codes=pq_codes,
            metrics=self.metrics, device=device)
        self.K = K
        self._adaptive = bool(adaptive)
        self._bound = bound
        self.batch_size = int(batch_size)
        self.deadline_s = float(deadline_ms) * 1e-3
        self._seed = int(seed)
        n_blocks = self.plan.n_blocks
        self._perm_source = (perm_source if perm_source is not None else
                             (lambda s: seeded_perm(self._seed, s, n_blocks)))
        self.cache = QuantizedLRU(cache_entries, cache_resolution)
        self._store = self._exec.store
        #: table version salting the LRU keys (the store's)
        self._version = 0 if self._store is None else self._store.version
        self._pending: List[_Pending] = []
        self._results: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self._next_id = 0
        self._recall_rate = float(recall_sample_rate)
        self._recall_rng = np.random.default_rng(seed)
        self._lat: List[float] = []
        self._recalls: List[float] = []
        self._rounds: List[int] = []   # adaptive: per-query exit rounds
        if self._store is not None:
            self.metrics.adopt(self._store.metrics)
        self._c_requests = self.metrics.counter(
            "serve_requests_total", "Requests submitted.")
        self._c_cache_hits = self.metrics.counter(
            "serve_cache_hits_total", "Requests answered from the LRU.")
        self._c_batches = self.metrics.counter(
            "serve_batches_total", "Micro-batch flushes by trigger.",
            ("trigger",))
        self._c_batches.seed(trigger="full")
        self._c_batches.seed(trigger="deadline")
        self._c_update_rows = self.metrics.counter(
            "serve_update_rows_total", "Store mutations applied.")
        self._c_update_flushes = self.metrics.counter(
            "serve_update_flushes_total", "Store flush_updates calls.")
        self._h_latency = self.metrics.histogram(
            "serve_latency_ms", "Per-request latency (ms), cache hits at 0.")
        self._h_occupancy = self.metrics.histogram(
            "serve_batch_occupancy", "Filled lanes per micro-batch flush.",
            buckets=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0))
        self.metrics.gauge(
            "serve_pending", "Requests accepted but not yet served.",
        ).set_fn(lambda: len(self._pending))
        self.metrics.gauge(
            "serve_cache_entries", "Live LRU cache entries.",
        ).set_fn(lambda: len(self.cache))
        #: plain dispatch sequence for the permutation draw — deliberately
        #: NOT registry-backed so metric wiring can never perturb sampling
        self._batch_seq = 0
        self._update_time_s = 0.0
        self._occupancy: List[int] = []

    @property
    def n_requests(self) -> int:
        """Requests submitted (registry-backed)."""
        return int(self._c_requests.total())

    @property
    def n_cache_hits(self) -> int:
        """Cache-answered requests (registry-backed)."""
        return int(self._c_cache_hits.total())

    @property
    def n_updates(self) -> int:
        """Store mutations applied (registry-backed)."""
        return int(self._c_update_rows.total())

    @property
    def n_update_flushes(self) -> int:
        """Store flush_updates calls (registry-backed)."""
        return int(self._c_update_flushes.total())

    @property
    def n_recalibrations(self) -> int:
        """Plan re-derivations observed (executor-owned)."""
        return self._exec.n_recalibrations

    @property
    def n_batches(self) -> int:
        """Micro-batch flushes, all triggers (registry-backed)."""
        return int(self._c_batches.total())

    @property
    def n_full_flushes(self) -> int:
        """Flushes triggered by a full batch (registry-backed)."""
        return int(self._c_batches.get(trigger="full"))

    @property
    def n_deadline_flushes(self) -> int:
        """Flushes triggered by the batch deadline (registry-backed)."""
        return int(self._c_batches.get(trigger="deadline"))

    @property
    def n(self) -> int:
        """Rows of the served table (a store's capacity)."""
        return self._exec.n

    @property
    def N(self) -> int:
        """Query/item dimensionality."""
        return self._exec.N

    @property
    def plan(self):
        """The executor's calibrated BlockedPlan."""
        return self._exec.plan

    @property
    def executor(self) -> CascadeExecutor:
        """The executor serving this engine's flushes."""
        return self._exec

    @property
    def store(self):
        """The served store (a `DynamicTableStore` or a
        `ShardedTableStore`), or None on a static table."""
        return self._store

    @property
    def pending_count(self) -> int:
        """Requests accepted but not yet served (excludes cache hits)."""
        return len(self._pending)

    def submit(self, q, now: Optional[float] = None) -> int:
        """Accept one (N,) query; returns its request id.

        Cache hits complete immediately (latency 0); misses queue for the
        next micro-batch.  ``now`` (seconds, any monotonic origin) defaults
        to wall clock — pass a virtual clock for simulation.  Staged store
        mutations are drained first: a query submitted after an upsert is
        never answered from a pre-upsert cache line or table.  Spans:
        ``engine.submit`` with ``engine.submit.cache`` (the LRU key and
        lookup).
        """
        with span("engine.submit"):
            q = np.asarray(q, np.float32)
            if q.shape != (self.N,):
                raise ValueError(f"query shape {q.shape} != ({self.N},)")
            self.apply_updates()
            now = time.perf_counter() if now is None else now
            rid = self._next_id
            self._next_id += 1
            self._c_requests.inc()
            # lookups are salted with the current (table version, K)
            with span("engine.submit.cache"):
                ck = self.cache.key(q) if self.cache.capacity > 0 else None
                hit = (self.cache.get(self._salted(ck)) if ck is not None
                       else None)
            if hit is not None:
                self._results[rid] = hit
                self._c_cache_hits.inc()
                self._lat.append(0.0)
                self._h_latency.observe(0.0)
                return rid
            self._pending.append(_Pending(rid, q, now, ck))
            return rid

    def _salted(self, base_key: bytes) -> bytes:
        """Prefix an LRU base key with the live (version, K) salt."""
        return struct.pack("<qi", self._version, self.K) + base_key

    def poll(self, now: Optional[float] = None) -> Tuple[List[int], float]:
        """Flush micro-batches whose trigger fired; returns (ids, busy_s).

        Triggers: ``batch_size`` requests waiting (full flush), or the
        oldest pending request older than the batch deadline (deadline
        flush).  ``busy_s`` is the wall time spent in compute, so virtual-
        clock drivers can advance time by it.  Staged store mutations are
        drained first (`apply_updates`).  Span: ``engine.poll``, each
        flush inside it an ``engine.flush``.
        """
        with span("engine.poll"):
            now = time.perf_counter() if now is None else now
            self.apply_updates()
            done: List[int] = []
            busy = 0.0
            while self._pending:
                full = len(self._pending) >= self.batch_size
                aged = now - self._pending[0].t_submit >= self.deadline_s
                if not (full or aged):
                    break
                self._c_batches.inc(trigger="full" if full else "deadline")
                ids, dt = self._flush(now + busy)
                done.extend(ids)
                busy += dt
            return done, busy

    def drain(self, now: Optional[float] = None) -> Tuple[List[int], float]:
        """Flush everything pending regardless of triggers (shutdown);
        drains staged store mutations first, like `poll`."""
        now = time.perf_counter() if now is None else now
        self.apply_updates()
        done: List[int] = []
        busy = 0.0
        while self._pending:
            self._c_batches.inc(trigger="deadline")
            ids, dt = self._flush(now + busy)
            done.extend(ids)
            busy += dt
        return done, busy

    def result(self, req_id: int):
        """Pop the (ids, scores) result for a completed request, or None
        (span ``engine.result``)."""
        with span("engine.result"):
            return self._results.pop(req_id, None)

    def apply_updates(self) -> int:
        """Drain the store's staged mutations; returns rows applied.

        Runs between micro-batch flushes, so in-flight queries never
        observe a half-applied burst.  On a version change (staged
        mutations, or `grow` / `refresh_codebook` out of band) the LRU is
        invalidated and its salt bumped; then the executor re-derives its
        plan if the store's capacity or value range outgrew it (counted
        in ``stats()["updates"]["recalibrations"]``).  Sampled recall
        reads the store's host mirror, always current, so no recall
        state goes stale.  No-op without a store.
        """
        store = self._store
        if store is None:
            return 0
        applied = 0
        if store.pending_updates:
            t0 = time.perf_counter()
            info = store.flush_updates()
            applied = info["applied"]
            self._c_update_rows.inc(applied)
            self._c_update_flushes.inc()
            self._update_time_s += time.perf_counter() - t0
        if store.version != self._version:
            self._version = store.version
            self.cache.invalidate()
        self._exec.sync_store()
        return applied

    def _flush(self, now: float) -> Tuple[List[int], float]:
        """Serve the first ``batch_size`` pending requests in one dispatch
        and file their results (spans ``engine.flush``, with
        ``engine.flush.pack`` for the lane buffer and ``engine.flush.file``
        for the results, LRU puts and latency bookkeeping)."""
        with span("engine.flush"):
            with span("engine.flush.pack"):
                batch = self._pending[:self.batch_size]
                self._pending = self._pending[len(batch):]
                Qbuf = np.zeros((self.batch_size, self.N), np.float32)
                for i, p in enumerate(batch):
                    Qbuf[i] = p.q
            perm = self._perm_source(self._batch_seq)
            ids, scores, rounds, dt = self._exec.dispatch(Qbuf, perm)
            with span("engine.flush.file"):
                return self._file(batch, ids, scores, rounds, now, dt), dt

    def _file(self, batch: List[_Pending], ids: np.ndarray,
              scores: np.ndarray, rounds: Optional[np.ndarray], now: float,
              dt: float) -> List[int]:
        """File a dispatch's answers: results, LRU puts, latency, recall
        and occupancy bookkeeping; returns the answered request ids."""
        ids = ids[:len(batch)]
        scores = scores[:len(batch)]
        if rounds is not None:
            # (B,) on one device, (B, shards) sharded: every shard's exit
            # round of the real batch rows
            self._rounds.extend(rounds[:len(batch)].reshape(-1).tolist())
        self._batch_seq += 1
        self._occupancy.append(len(batch))
        self._h_occupancy.observe(len(batch))
        done = []
        for i, p in enumerate(batch):
            # a store's stable external ids, never raw slots (a slot's
            # occupant changes across swap-deletes)
            res = (self._exec.external_ids(ids[i]), scores[i].copy())
            self._results[p.req_id] = res
            if p.cache_key is not None:
                # salted at put time: a result filed under the live version
                self.cache.put(self._salted(p.cache_key), res)
            self._lat.append((now - p.t_submit) + dt)
            self._h_latency.observe(((now - p.t_submit) + dt) * 1e3)
            if (self._recall_rate > 0.0
                    and self._recall_rng.random() < self._recall_rate):
                self._recalls.append(self._exec.recall_of(p.q, ids[i]))
            done.append(p.req_id)
        if len(self._lat) > 100_000:       # bound the stats memory
            self._lat = self._lat[-10_000:]
        if len(self._occupancy) > 100_000:
            self._occupancy = self._occupancy[-10_000:]
        if len(self._recalls) > 100_000:
            self._recalls = self._recalls[-10_000:]
        if len(self._rounds) > 100_000:
            self._rounds = self._rounds[-10_000:]
        return done

    def _adaptive_stats(self) -> dict:
        """Early-exit telemetry: rounds_used histogram + mean pull frac."""
        out = {"enabled": self._adaptive, "bound": self._bound}
        if not self._adaptive:
            return out
        hist: Dict[int, int] = {}
        for r in self._rounds:
            hist[int(r)] = hist.get(int(r), 0) + 1
        pulls = pulls_through_round(self.plan.schedule)
        total = max(1, int(pulls[-1]))
        samples = max(1, len(self._rounds))
        mean_pulls = sum(int(pulls[min(r, len(pulls) - 1)]) * c
                         for r, c in hist.items()) / samples
        out.update({
            "samples": len(self._rounds),
            "rounds_hist": {str(k): v for k, v in sorted(hist.items())},
            "mean_rounds": (float(np.mean(self._rounds))
                            if self._rounds else 0.0),
            "mean_pull_frac": mean_pulls / total,
        })
        return out

    def stats(self) -> dict:
        """Per-request latency/recall counters as a plain dict.

        latency_ms percentiles include cache hits (latency 0); recall is
        over the sampled fraction only (``nan`` when nothing was sampled).
        """
        occ = np.asarray(self._occupancy, np.float64)
        return {
            "requests": self.n_requests,
            "completed": self.n_requests - len(self._pending),
            "pending": len(self._pending),
            "batches": self.n_batches,
            "full_flushes": self.n_full_flushes,
            "deadline_flushes": self.n_deadline_flushes,
            "mean_batch_occupancy": float(occ.mean()) if occ.size else 0.0,
            "cache": {"hits": self.cache.hits, "misses": self.cache.misses,
                      "entries": len(self.cache),
                      "hit_rate": (self.cache.hits
                                   / max(1, self.cache.hits
                                         + self.cache.misses))},
            "latency_ms": summarize_latencies(
                self._lat, keys=("mean", "p50", "p95", "max")),
            "recall": {"samples": len(self._recalls),
                       "mean": (float(np.mean(self._recalls))
                                if self._recalls else float("nan"))},
            "plan": {"rounds": len(self.plan.schedule.rounds),
                     "pull_speedup": self.plan.schedule.speedup},
            "adaptive": self._adaptive_stats(),
            "updates": {
                "applied": self.n_updates,
                "update_flushes": self.n_update_flushes,
                "recalibrations": self.n_recalibrations,
                "version": self._version,
                "cache_invalidations": self.cache.invalidations,
                "rows_per_s": (self.n_updates / self._update_time_s
                               if self._update_time_s > 0 else 0.0)},
            **({"store": self._store.stats()}
               if self._store is not None else {}),
        }


class ServeRuntime:
    """Continuous-batching serving runtime with admission + degradation.

    The port of ``repro.launch.engine.ServeRuntime``, over a static
    table or a `repro_torch.store.DynamicTableStore`, or sharded over a
    ``mesh`` (a static table or a `ShardedTableStore`).  Three layers:

      * **admission** (`AdmissionController`): every `submit` is
        validated (poison NaN/Inf/wrong-dim queries are rejected at the
        door), checked against the quarantine, and enqueued into a
        bounded priority queue — a full queue refuses with a typed
        ``overloaded`` result or displaces lower-priority sheddable work;
      * **scheduler** (this class): `poll` assembles dispatch batches in
        (priority, FIFO) order onto ``lanes`` fixed kernel lanes and is
        *work-conserving* — while the executor is busy, freed lanes are
        refilled from the queue between dispatches instead of waiting
        out the batch deadline.  Requests queued past their class
        deadline are shed (typed ``overloaded``/``deadline``);
      * **executor** (`CascadeExecutor`, one per degradation rung, each
        dispatch one fused-cascade launch): under queue pressure the
        `DegradationLadder` relaxes eps toward ``eps_floor`` — each
        response records the ``eps_served`` it met, degraded responses
        are never written to the full-quality cache, and only when the
        ladder is exhausted does admission refuse outright.  Dispatch
        runs under `dispatch_with_retries`; a micro-batch that keeps
        failing is failed *alone* (typed ``failed`` results +
        fingerprint quarantine) and the runtime keeps serving.

    A store-backed runtime drains staged mutations between dispatches
    like `MIPSServeEngine` (every rung executor reads the store's one
    tiled table); a failing flush (`StoreFlushError`) leaves the staged
    ops intact, is counted and recorded, and is retried at the next poll
    while serving goes on on the current table.

    Dispatch ``didx`` serves its batch under the block permutation
    ``perm_source(didx, n_blocks)`` (default `seeded_perm` from
    ``seed``), ``n_blocks`` of the chosen rung's own plan: under
    ``pull_mode="hybrid"`` rungs may resolve different modes.
    `stats()` exports p50/p95/p99 latency, queue depth/peak, outcome and
    shed/reject/retry/degraded counters, per-rung eps_served counts and
    per-dispatch lane accounting, with the reference's keys in its
    order.  Drive it like the engine: ``submit(q, now=...)`` /
    ``poll(now=...)`` / ``result(rid)`` — traffic never raises.
    """

    def __init__(self, table, *, K: int = 1, eps: float = 0.1,
                 delta: float = 0.1, eps_floor: Optional[float] = None,
                 degrade_rungs: int = 3, degrade_start: float = 0.5,
                 lanes: int = 8, batch_wait_ms: float = 2.0,
                 queue_capacity: int = 64,
                 classes: Optional[Dict[str, PriorityClass]] = None,
                 default_class: str = "default",
                 max_retries: int = 2, retry_backoff_ms: float = 1.0,
                 dispatch_timeout_ms: Optional[float] = None,
                 fault_injector=None,
                 cache_entries: int = 512, cache_resolution: float = 1e-3,
                 recall_sample_rate: float = 0.0,
                 value_range: Optional[float] = None,
                 qmax_hint: float = 1.0, tile: int = 8, block: int = 512,
                 mesh=None, n_valid: Optional[int] = None,
                 precision: str = "fp32", adaptive: bool = False,
                 bound: str = "hoeffding", pull_mode: str = "row",
                 coord_block: int = 128, quant_err: Optional[float] = None,
                 pq_subdims: int = 8, pq_codes: int = 16, seed: int = 0,
                 metrics: Optional[MetricsRegistry] = None,
                 tracer=None, flight=None,
                 perm_source: Optional[Callable[[int, int], object]] = None,
                 device="cuda"):
        if batch_wait_ms <= 0:
            raise ValueError(f"batch_wait_ms must be > 0, "
                             f"got {batch_wait_ms}")
        if lanes < 1:
            raise ValueError(f"lanes must be >= 1, got {lanes}")
        if max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {max_retries}")
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        #: optional `repro_torch.obs.SpanTracer` / `FlightRecorder`; None
        #: disables that pillar entirely
        self.tracer = tracer
        self.flight = flight
        self.ladder = DegradationLadder(eps, eps_floor, rungs=degrade_rungs,
                                        start=degrade_start)
        if isinstance(table, DynamicTableStore):
            dev = table.device
        elif isinstance(table, ShardedTableStore):
            dev = table.mesh.devices[0]
        else:
            dev = (mesh.devices[0] if mesh is not None
                   else resolve_device(device))
        if isinstance(table, np.ndarray):
            # one device copy shared by every rung (each still re-lays
            # its own tiled, and on quantized tiers quantized, table; a
            # store's rungs all read the store's)
            table = torch.as_tensor(table, dtype=torch.float32).to(dev)
        self._rung_execs = [CascadeExecutor(
            table, K=K, eps=e, delta=delta, value_range=value_range,
            qmax_hint=qmax_hint, tile=tile, block=block, mesh=mesh,
            n_valid=n_valid, precision=precision, adaptive=adaptive,
            bound=bound, pull_mode=pull_mode, coord_block=coord_block,
            quant_err=quant_err, pq_subdims=pq_subdims, pq_codes=pq_codes,
            metrics=self.metrics, metrics_labels={"rung": str(i)},
            device=dev)
            for i, e in enumerate(self.ladder.eps_values)]
        ex0 = self._rung_execs[0]
        self.K = K
        self.lanes = int(lanes)
        self.batch_wait_s = float(batch_wait_ms) * 1e-3
        self._eps, self._delta = float(eps), float(delta)
        self.max_retries = int(max_retries)
        self.retry_backoff_s = float(retry_backoff_ms) * 1e-3
        self.dispatch_timeout_s = (None if dispatch_timeout_ms is None
                                   else float(dispatch_timeout_ms) * 1e-3)
        self.admission = AdmissionController(
            ex0.N, queue_capacity=queue_capacity, classes=classes,
            default_class=default_class, metrics=self.metrics)
        self.injector = fault_injector
        self._store = ex0.store
        if fault_injector is not None:
            self.metrics.adopt(fault_injector.metrics)
        if fault_injector is not None and self._store is not None:
            fault_injector.attach(self._store)
        if self._store is not None:
            self.metrics.adopt(self._store.metrics)
        #: table version salting the LRU keys (the store's; constant on
        #: a static table)
        self._version = 0 if self._store is None else self._store.version
        self._seed = int(seed)
        self._perm_source = (perm_source if perm_source is not None else
                             (lambda didx, nb: seeded_perm(self._seed, didx,
                                                           nb)))
        self.cache = QuantizedLRU(cache_entries, cache_resolution)
        self._results: Dict[int, ServeResult] = {}
        self._next_id = 0
        self._recall_rate = float(recall_sample_rate)
        self._recall_rng = np.random.default_rng(seed)
        self._lat: List[float] = []
        self._occupancy: List[int] = []
        self._pull_fracs: List[float] = []
        self._recalls: List[float] = []
        self._c_requests = self.metrics.counter(
            "serve_requests_total", "Requests submitted, by class.",
            ("priority_class",))
        self._c_outcomes = self.metrics.counter(
            "serve_outcomes_total",
            "Terminal request outcomes (the typed ServeResult statuses).",
            ("outcome",))
        for s in ("ok", "degraded", "rejected", "overloaded", "failed"):
            self._c_outcomes.seed(outcome=s)
        self._c_class = self.metrics.counter(
            "serve_class_events_total",
            "Per-priority-class accounting events.",
            ("priority_class", "event"))
        self._c_rung = self.metrics.counter(
            "serve_rung_served_total",
            "Requests answered per degradation-ladder rung.", ("rung",))
        for i in range(self.ladder.n_rungs):
            self._c_rung.seed(rung=str(i))
        self._c_cache_hits = self.metrics.counter(
            "serve_cache_hits_total", "Requests answered from the LRU.")
        self._c_dispatches = self.metrics.counter(
            "serve_dispatches_total",
            "Batch dispatches, by lane occupancy.", ("filled",))
        self._c_dispatches.seed(filled="full")
        self._c_dispatches.seed(filled="partial")
        self._c_retries = self.metrics.counter(
            "serve_retries_total", "Dispatch retry attempts.")
        self._c_dispatch_errors = self.metrics.counter(
            "serve_dispatch_errors_total",
            "Dispatch attempts that raised (injected or real).")
        self._c_failed_batches = self.metrics.counter(
            "serve_failed_batches_total",
            "Micro-batches failed past the retry budget.")
        self._c_slow = self.metrics.counter(
            "serve_slow_dispatches_total",
            "Dispatches exceeding dispatch_timeout_ms.")
        self._c_flush_failures = self.metrics.counter(
            "serve_store_flush_failures_total",
            "Store flushes failed by StoreFlushError (retried later).")
        self._c_update_errors = self.metrics.counter(
            "serve_update_errors_total",
            "Store flushes that raised a non-flush error.")
        self._c_update_rows = self.metrics.counter(
            "serve_update_rows_total", "Store mutations applied.")
        self._h_latency = self.metrics.histogram(
            "serve_latency_ms",
            "Answered-request latency (ms), by outcome.", ("outcome",))
        self._h_queue_wait = self.metrics.histogram(
            "serve_queue_wait_ms",
            "Submit-to-dispatch queue wait (ms) of dispatched requests.")
        self._h_occupancy = self.metrics.histogram(
            "serve_batch_occupancy", "Filled lanes per dispatch.",
            buckets=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0))
        self._h_pull_frac = self.metrics.histogram(
            "serve_pull_frac",
            "Executed pull fraction per dispatch (pulls / budget).",
            buckets=PULL_FRAC_BUCKETS)
        self.metrics.gauge(
            "serve_cache_entries", "Live LRU cache entries.",
        ).set_fn(lambda: len(self.cache))
        #: plain dispatch sequence for the permutation draw — deliberately
        #: NOT registry-backed so metric wiring can never perturb sampling
        self._dispatch_seq = 0
        self._seen_refreshes = (0 if self._store is None
                                else getattr(self._store,
                                             "codebook_refreshes", 0))

    # ---- counter surface (registry-backed) -------------------------------

    @property
    def outcomes(self) -> Dict[str, int]:
        """Terminal outcome counts keyed by status (registry-backed)."""
        return {s: int(self._c_outcomes.get(outcome=s))
                for s in ("ok", "degraded", "rejected", "overloaded",
                          "failed")}

    @property
    def rung_served(self) -> List[int]:
        """Requests answered per ladder rung (registry-backed)."""
        return [int(self._c_rung.get(rung=str(i)))
                for i in range(self.ladder.n_rungs)]

    @property
    def per_class(self) -> Dict[str, Dict[str, int]]:
        """Per-class event counts, classes in first-seen order
        (registry-backed)."""
        out: Dict[str, Dict[str, int]] = {}
        for labels, value in self._c_class.rows():
            cls = labels["priority_class"]
            out.setdefault(cls, {})[labels["event"]] = int(value)
        return out

    @property
    def n_requests(self) -> int:
        """Requests submitted (registry-backed)."""
        return int(self._c_requests.total())

    @property
    def n_cache_hits(self) -> int:
        """Cache-answered requests (registry-backed)."""
        return int(self._c_cache_hits.total())

    @property
    def n_dispatches(self) -> int:
        """Batch dispatches issued (registry-backed)."""
        return int(self._c_dispatches.total())

    @property
    def n_full_dispatches(self) -> int:
        """Dispatches with every lane filled (registry-backed)."""
        return int(self._c_dispatches.get(filled="full"))

    @property
    def n_retries(self) -> int:
        """Dispatch retry attempts (registry-backed)."""
        return int(self._c_retries.total())

    @property
    def n_dispatch_errors(self) -> int:
        """Dispatch attempts that raised (registry-backed)."""
        return int(self._c_dispatch_errors.total())

    @property
    def n_failed_batches(self) -> int:
        """Micro-batches failed past retries (registry-backed)."""
        return int(self._c_failed_batches.total())

    @property
    def n_slow_dispatches(self) -> int:
        """Dispatches past the timeout (registry-backed)."""
        return int(self._c_slow.total())

    @property
    def store(self):
        """The served store (a `DynamicTableStore` or a
        `ShardedTableStore`), or None on a static table."""
        return self._store

    @property
    def n_flush_failures(self) -> int:
        """Store flush failures (registry-backed; 0 without a store)."""
        return int(self._c_flush_failures.total())

    @property
    def n_update_errors(self) -> int:
        """Store update errors (registry-backed; 0 without a store)."""
        return int(self._c_update_errors.total())

    @property
    def n_updates(self) -> int:
        """Store mutations applied (registry-backed; 0 without a store)."""
        return int(self._c_update_rows.total())

    # ---- compat surface for simulate_stream ------------------------------

    @property
    def N(self) -> int:
        """Query dimensionality (executor-owned)."""
        return self._rung_execs[0].N

    @property
    def n(self) -> int:
        """Rows of the served table, a store's capacity (executor-owned)."""
        return self._rung_execs[0].n

    @property
    def plan(self):
        """The full-quality (rung 0) executor's calibrated plan."""
        return self._rung_execs[0].plan

    @property
    def executors(self) -> List[CascadeExecutor]:
        """The rung executors, rung 0 (full quality) first."""
        return list(self._rung_execs)

    @property
    def deadline_s(self) -> float:
        """Batch-assembly wait in seconds (simulate_stream drain step)."""
        return self.batch_wait_s

    @property
    def pending_count(self) -> int:
        """Requests admitted but not yet dispatched (the queue depth)."""
        return self.admission.depth

    # ---- request path -----------------------------------------------------

    def _class_counter(self, cls: str, key: str) -> None:
        # seed the full event set on a class's first touch so the
        # per-class dict keeps its fixed key order
        for ev in ("requests", "answered", "degraded", "shed"):
            self._c_class.seed(priority_class=cls, event=ev)
        self._c_class.inc(priority_class=cls, event=key)

    def _finish(self, rid: int, res: ServeResult,
                t: Optional[float] = None) -> None:
        self._results[rid] = res
        self._c_outcomes.inc(outcome=res.status)
        if res.answered:
            self._class_counter(res.cls, "answered")
            if res.status == "degraded":
                self._class_counter(res.cls, "degraded")
            self._lat.append(res.latency_s)
            self._h_latency.observe(res.latency_s * 1e3,
                                    outcome=res.status)
            if len(self._lat) > 100_000:
                self._lat = self._lat[-10_000:]
        elif res.status in ("overloaded", "failed"):
            self._class_counter(res.cls, "shed")
        if self.tracer is not None and t is not None:
            self.tracer.request_end(
                rid, t, res.status,
                **({"reason": res.reason} if res.reason else {}))
        if self.flight is not None and res.status == "failed":
            self.flight.record("request_failed", t, rid=rid,
                               cls=res.cls, reason=res.reason)

    def _salted(self, base_key: bytes) -> bytes:
        """Prefix an LRU base key with the live (version, K) salt."""
        return struct.pack("<qi", self._version, self.K) + base_key

    def submit(self, q, now: Optional[float] = None,
               cls: Optional[str] = None) -> int:
        """Accept one query; always returns a request id, never raises.

        The query runs the admission pipeline: poison validation ->
        quarantine -> cache (full-quality hits answer immediately at
        eps_served = eps) -> bounded priority queue.  Refused requests
        get their typed `ServeResult` immediately; admitted ones resolve
        at a later `poll`/`drain`.  ``cls`` names a configured
        `PriorityClass` (None = default).
        """
        now = time.perf_counter() if now is None else now
        rid = self._next_id
        self._next_id += 1
        pcls = self.admission.resolve_class(cls)
        self._c_requests.inc(priority_class=pcls.name)
        self._class_counter(pcls.name, "requests")
        if self.tracer is not None:
            self.tracer.request_begin(rid, now, priority_class=pcls.name)
        self.apply_updates(now)
        arr, reason = self.admission.validate(q)
        if arr is None:
            self.admission.count_poison()
            if self.tracer is not None:
                self.tracer.instant(rid, "rejected", now, reason=reason)
            if self.flight is not None:
                self.flight.record("rejected_poison", now, rid=rid,
                                   reason=reason)
            self._finish(rid, ServeResult(status="rejected", cls=pcls.name,
                                          reason=reason), t=now)
            return rid
        ck = self.cache.key(arr) if self.cache.capacity > 0 else None
        if ck is not None:
            hit = self.cache.get(self._salted(ck))
            if hit is not None:
                ids, scores = hit
                self._c_cache_hits.inc()
                if self.tracer is not None:
                    self.tracer.instant(rid, "cache_hit", now)
                self._finish(rid, ServeResult(
                    status="ok", ids=ids, scores=scores,
                    eps_served=self._eps, delta_served=self._delta,
                    cls=pcls.name, cached=True), t=now)
                return rid
        ticket = Ticket(rid, arr, pcls, now, now + pcls.deadline_s, ck,
                        self.admission.fingerprint(arr))
        verdict, displaced = self.admission.admit(ticket)
        for victim, vres in displaced:
            vres.latency_s = now - victim.t_submit
            if self.tracer is not None:
                self.tracer.instant(victim.req_id, "displaced", now,
                                    by=rid)
            if self.flight is not None:
                self.flight.record("displacement", now,
                                   rid=victim.req_id, by=rid,
                                   cls=victim.cls.name)
            self._finish(victim.req_id, vres, t=now)
        if verdict is not None:
            if self.tracer is not None:
                self.tracer.instant(rid, verdict.status, now,
                                    reason=verdict.reason or "")
            if self.flight is not None:
                self.flight.record("refused", now, rid=rid,
                                   status=verdict.status,
                                   reason=verdict.reason)
            self._finish(rid, verdict, t=now)
        else:
            if self.tracer is not None:
                self.tracer.instant(rid, "admitted", now,
                                    depth=self.admission.depth)
            if self.flight is not None:
                self.flight.record("admitted", now, rid=rid,
                                   cls=pcls.name,
                                   depth=self.admission.depth)
        return rid

    def result(self, req_id: int) -> Optional[ServeResult]:
        """Pop the typed `ServeResult` for a finished request, or None."""
        return self._results.pop(req_id, None)

    def warmup(self) -> float:
        """Build every rung's kernel off the serving clock; returns s.

        Dispatches one all-zeros lane buffer through each ladder rung
        under the identity permutation, so a fresh process builds and
        loads the kernel *before* traffic: on a virtual-clock driver an
        un-warmed runtime charges its first dispatch the whole build,
        which expires every queued deadline and reads as a (spurious)
        overload.  The runtime's counters and stats are untouched (the
        executor-level ``cascade_*`` metrics do count warmup dispatches).
        """
        t0 = time.perf_counter()
        Qbuf = np.zeros((self.lanes, self.N), np.float32)
        for ex in self._rung_execs:
            ex.dispatch(Qbuf, np.arange(ex.plan.n_blocks))
        return time.perf_counter() - t0

    def apply_updates(self, now: Optional[float] = None) -> int:
        """Drain staged store mutations fault-tolerantly; returns applied.

        Like `MIPSServeEngine.apply_updates` (a version change invalidates
        and re-salts the LRU; capacity or value-range growth rebuilds
        every rung's plan, recorded as a ``recalibration`` flight event),
        with one robustness addition: a `StoreFlushError` from the
        store's fault hook — or any other flush exception — is *counted*
        (``stats()["faults"]["store_flush_failures"]`` /
        ``update_errors``) and recorded, and serving goes on on the
        current table; a failed flush's staged ops stay staged and retry
        at the next poll.  ``now`` (optional virtual-clock time) only
        timestamps the flight-recorder events.  No-op without a store.
        """
        store = self._store
        if store is None:
            return 0
        applied = 0
        if store.pending_updates:
            try:
                info = store.flush_updates()
                applied = info["applied"]
                self._c_update_rows.inc(applied)
            except StoreFlushError as e:
                # staged ops intact: keep serving the current table and
                # retry the flush at the next poll
                self._c_flush_failures.inc()
                if self.flight is not None:
                    self.flight.record("store_flush_error", now,
                                       error=str(e),
                                       pending=store.pending_updates)
                    self.flight.dump("store_flush_error", now)
            except Exception as e:
                # a bad mutation (unknown delete, capacity exhausted): the
                # store dropped it and kept its successors
                self._c_update_errors.inc()
                if self.flight is not None:
                    self.flight.record("store_update_error", now,
                                       error=str(e))
        if store.version != self._version:
            self._version = store.version
            self.cache.invalidate()
        rebuilt = 0
        for ex in self._rung_execs:
            rebuilt += ex.sync_store()
        if rebuilt and self.flight is not None:
            self.flight.record("recalibration", now, rebuilds=rebuilt,
                               version=store.version)
        refreshes = getattr(store, "codebook_refreshes", 0)
        if refreshes != self._seen_refreshes:
            self._seen_refreshes = refreshes
            if self.flight is not None:
                self.flight.record("codebook_refresh", now,
                                   refreshes=refreshes,
                                   version=store.version)
        return applied

    # ---- scheduler ---------------------------------------------------------

    def poll(self, now: Optional[float] = None) -> Tuple[List[int], float]:
        """Run the continuous-batching scheduler; returns (ids, busy_s).

        Dispatch triggers: ``lanes`` requests queued (full dispatch), the
        oldest queued request aged past ``batch_wait_ms``, or — the
        continuous-batching rule — the executor already ran this poll
        (work conservation: anything still queued waited through that
        dispatch, so freed lanes are refilled immediately instead of
        re-waiting the batch deadline).  Expired-deadline tickets are
        shed during batch assembly.  ``busy_s`` is virtual compute time
        (measured + injected + retry backoff) for virtual-clock drivers.
        """
        now = time.perf_counter() if now is None else now
        self.apply_updates(now)
        done: List[int] = []
        busy = 0.0
        while self.admission.depth:
            t = now + busy
            oldest = self.admission.oldest_submit()
            full = self.admission.depth >= self.lanes
            aged = (oldest is not None
                    and t - oldest >= self.batch_wait_s)
            if not (full or aged or busy > 0.0):
                break
            batch, expired = self.admission.take(t, self.lanes)
            for tk, res in expired:
                if self.flight is not None:
                    self.flight.record("deadline_expired", t,
                                       rid=tk.req_id, cls=tk.cls.name)
                self._finish(tk.req_id, res, t=t)
                done.append(tk.req_id)
            if not batch:
                continue
            served, dt = self._dispatch(batch, t)
            done.extend(served)
            busy += dt
        return done, busy

    def drain(self, now: Optional[float] = None) -> Tuple[List[int], float]:
        """Serve everything queued regardless of triggers or deadlines."""
        now = time.perf_counter() if now is None else now
        self.apply_updates(now)
        done: List[int] = []
        busy = 0.0
        while self.admission.depth:
            batch, _ = self.admission.take(now + busy, self.lanes,
                                           expire=False)
            if not batch:
                break
            served, dt = self._dispatch(batch, now + busy)
            done.extend(served)
            busy += dt
        return done, busy

    # ---- dispatch ----------------------------------------------------------

    def _fail_batch(self, batch: List[Ticket], t: float, exc: Exception,
                    retries: int, backoff: float) -> List[int]:
        """Fail ONE micro-batch (typed results + quarantine), runtime lives.

        Every ticket gets a ``failed`` `ServeResult` carrying the
        exception text, and its fingerprint is quarantined so identical
        resubmissions are refused at admission instead of re-breaking
        dispatches.  The next poll dispatches the next batch normally.
        """
        self._c_failed_batches.inc()
        reason = f"dispatch failed after {retries} retries: {exc}"
        for tk in batch:
            self.admission.add_quarantine(tk.fingerprint,
                                          "dispatch failure")
            if self.flight is not None:
                self.flight.record("quarantine_add", t + backoff,
                                   rid=tk.req_id,
                                   fingerprint=repr(tk.fingerprint))
            self._finish(tk.req_id, ServeResult(
                status="failed", cls=tk.cls.name, reason=reason,
                latency_s=(t + backoff) - tk.t_submit, retries=retries),
                t=t + backoff)
        if self.flight is not None:
            # one dump per failed batch: the ring now holds the whole
            # failure context (injections, retries, quarantines)
            self.flight.dump("request_failed", t + backoff)
        return [tk.req_id for tk in batch]

    def _dispatch(self, batch: List[Ticket],
                  t: float) -> Tuple[List[int], float]:
        # rung from overload pressure at assembly, the max of two signals:
        # queue depth (the taken batch counts: it was queue content a
        # moment ago) and *urgency* — the fraction of its deadline budget
        # the most-delayed batch member has already burned.  Depth alone
        # misses overload under tight deadlines (requests expire before
        # the queue builds); urgency alone misses it when deadlines are
        # infinite.  Either saturating climbs the ladder.
        load = (self.admission.depth + len(batch)) \
            / self.admission.queue_capacity
        urgency = 0.0
        for tk in batch:
            budget = tk.t_deadline - tk.t_submit
            if np.isfinite(budget) and budget > 0:
                urgency = max(urgency, (t - tk.t_submit) / budget)
        rung = self.ladder.rung(max(load, urgency))
        ex = self._rung_execs[rung]
        Qbuf = np.zeros((self.lanes, self.N), np.float32)
        for i, tk in enumerate(batch):
            Qbuf[i] = tk.q
        # drawn on the plain dispatch sequence, NOT a registry counter:
        # permutations must be invariant to observability wiring
        didx = self._dispatch_seq
        perm = self._perm_source(didx, ex.plan.n_blocks)
        self._dispatch_seq += 1
        self._c_dispatches.inc(
            filled="full" if len(batch) == self.lanes else "partial")

        def on_error(e, attempt, injected):
            self._c_dispatch_errors.inc()
            if self.flight is not None:
                self.flight.record(
                    "fault_dispatch_error", t, didx=didx,
                    attempt=attempt, injected=injected, error=str(e))

        def on_retry(attempt, backoff):
            self._c_retries.inc()
            if self.tracer is not None:
                for tk in batch:
                    self.tracer.instant(tk.req_id, "retry",
                                        t + backoff, attempt=attempt,
                                        didx=didx)

        try:
            ids, scores, rounds, dt, attempt, backoff, spike = \
                dispatch_with_retries(
                    ex, Qbuf, perm, didx=didx, injector=self.injector,
                    max_retries=self.max_retries,
                    retry_backoff_s=self.retry_backoff_s,
                    on_error=on_error, on_retry=on_retry)
        except DispatchFailed as df:
            return self._fail_batch(batch, t, df.cause, df.retries,
                                    df.backoff), df.backoff
        if spike > 0.0 and self.flight is not None:
            self.flight.record("fault_latency", t, didx=didx,
                               spike_ms=spike * 1e3)
        if (self.dispatch_timeout_s is not None
                and dt > self.dispatch_timeout_s):
            self._c_slow.inc()
        ids = ids[:len(batch)]
        scores = scores[:len(batch)]
        self._occupancy.append(len(batch))
        self._h_occupancy.observe(len(batch))
        lane = dispatch_lane_stats(
            None if rounds is None else rounds[:len(batch)],
            schedule=ex.plan.schedule, lanes=self.lanes,
            filled=len(batch))
        self._pull_fracs.append(lane["executed_pull_frac"])
        self._h_pull_frac.observe(lane["executed_pull_frac"])
        eps_r = self.ladder.eps_values[rung]
        self._c_rung.inc(len(batch), rung=str(rung))
        if self.tracer is not None:
            args = {"didx": didx, "rung": rung, "eps_served": eps_r,
                    "occupancy": len(batch), "retries": attempt,
                    "pull_frac": lane["executed_pull_frac"]}
            if spike > 0.0:
                args["injected_ms"] = spike * 1e3
            if rounds is not None:
                args["rounds_used"] = float(
                    np.mean(rounds[:len(batch)]))
            self.tracer.global_span(f"dispatch {didx}", t, t + dt, **args)
        done = []
        for i, tk in enumerate(batch):
            out_ids = ex.external_ids(ids[i])
            self._h_queue_wait.observe((t - tk.t_submit) * 1e3)
            if self.tracer is not None:
                self.tracer.span(tk.req_id, "queued", tk.t_submit, t,
                                 didx=didx)
                self.tracer.span(tk.req_id, "serve", t, t + dt,
                                 rung=rung, eps_served=eps_r,
                                 retries=attempt, didx=didx)
            res = ServeResult(
                status="ok" if rung == 0 else "degraded",
                ids=out_ids, scores=scores[i].copy(),
                eps_served=eps_r, delta_served=self._delta,
                cls=tk.cls.name, latency_s=(t + dt) - tk.t_submit,
                retries=attempt)
            self._finish(tk.req_id, res, t=t + dt)
            # only full-quality answers are cacheable: a degraded
            # (eps_served > eps) result must never be replayed to a
            # later query as if it met the contract eps
            if rung == 0 and tk.cache_key is not None:
                self.cache.put(self._salted(tk.cache_key),
                               (out_ids, scores[i].copy()))
            if (self._recall_rate > 0.0
                    and self._recall_rng.random() < self._recall_rate):
                self._recalls.append(ex.recall_of(tk.q, ids[i]))
            done.append(tk.req_id)
        for buf_name in ("_occupancy", "_pull_fracs", "_recalls"):
            buf = getattr(self, buf_name)
            if len(buf) > 100_000:
                setattr(self, buf_name, buf[-10_000:])
        return done, dt

    # ---- observability -----------------------------------------------------

    def stats(self) -> dict:
        """Runtime telemetry: tail latency, queue, outcomes, faults.

        ``latency_ms`` (p50/p95/p99) covers *answered* requests (cache
        hits at 0); shed/rejected/failed requests are visible in
        ``outcomes`` and ``admission`` instead.  ``degradation`` reports
        the eps ladder and how many responses each rung served (the
        ``eps_served`` counts);
        ``lanes`` aggregates per-dispatch lane accounting (occupancy +
        executed pull fraction); ``faults`` reconciles retries / failed
        batches (+ the injector's own schedule when attached).  Keys and
        their order are the reference's.
        """
        occ = np.asarray(self._occupancy, np.float64)
        answered = self.outcomes["ok"] + self.outcomes["degraded"]
        out = {
            "requests": self.n_requests,
            "completed": self.n_requests - self.admission.depth,
            "pending": self.admission.depth,
            "answered": answered,
            "availability": answered / max(1, self.n_requests),
            "dispatches": self.n_dispatches,
            "full_dispatches": self.n_full_dispatches,
            "cache": {"hits": self.cache.hits,
                      "misses": self.cache.misses,
                      "entries": len(self.cache),
                      "hit_rate": (self.cache.hits
                                   / max(1, self.cache.hits
                                         + self.cache.misses))},
            "latency_ms": summarize_latencies(self._lat),
            "queue": self.admission.stats(),
            "outcomes": dict(self.outcomes),
            "classes": {k: dict(v) for k, v in self.per_class.items()},
            "degradation": {
                "eps": self._eps,
                "eps_floor": self.ladder.eps_floor,
                "rungs": list(self.ladder.eps_values),
                "served_per_rung": list(self.rung_served),
                "degraded": self.outcomes["degraded"],
            },
            "lanes": {
                "lanes": self.lanes,
                "mean_occupancy": float(occ.mean()) if occ.size else 0.0,
                "mean_lane_util": (float(occ.mean()) / self.lanes
                                   if occ.size else 0.0),
                "mean_executed_pull_frac": (
                    float(np.mean(self._pull_fracs))
                    if self._pull_fracs else 1.0),
            },
            "faults": {
                "retries": self.n_retries,
                "dispatch_errors": self.n_dispatch_errors,
                "failed_batches": self.n_failed_batches,
                "slow_dispatches": self.n_slow_dispatches,
                "store_flush_failures": self.n_flush_failures,
                "update_errors": self.n_update_errors,
            },
            "recall": {"samples": len(self._recalls),
                       "mean": (float(np.mean(self._recalls))
                                if self._recalls else float("nan"))},
            "plan": {"rounds": len(self.plan.schedule.rounds),
                     "pull_speedup": self.plan.schedule.speedup},
            "updates": {"applied": self.n_updates,
                        "version": self._version,
                        "recalibrations": sum(
                            ex.n_recalibrations
                            for ex in self._rung_execs)},
        }
        if self.injector is not None:
            out["faults"]["injected"] = self.injector.stats()
        if self._store is not None:
            out["store"] = self._store.stats()
        return out
