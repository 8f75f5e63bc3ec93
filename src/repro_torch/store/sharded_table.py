"""Sharded dynamic table store over the serving mesh (DESIGN.md §11).

The PyTorch counterpart of ``repro.store.sharded_table``.
:class:`ShardedTableStore` extends the `DynamicTableStore` contract to
sharded serving: the capacity is split into per-shard slot pools of
``cap_local`` rows, every shard keeps its own dense live prefix, and the
store exports the per-shard ``n_valid`` vector that
`repro_torch.distributed.sharding.sharded_decode_tiled` masks with inside
each shard's cascade.  The exact cross-shard merge is untouched: a shard
whose live count just changed contributes exactly its live rows.

Updates route by id, as in the JAX package: a known id overwrites in
place on its owning shard; a new id appends to the shard with the most
free slots (the lowest index on ties), so shards stay balanced and no row
ever migrates between shards.  Deletes swap-fill within the owning
shard's region.

What differs from the JAX package is the device layout (as for
`DynamicTableStore`): each shard's slot pool lives on its own mesh device
in the kernel's tile-major layout ``(cap_local / tile, n_blocks, tile,
block)`` f32 (`tiled_shards`), and a flush writes each touched row in
place into its owning shard's buffer only — one host-to-device copy and
one scatter per touched shard.  The host mirror (page-locked on a card)
and the slot/id maps are numpy.

The store is fp32 (``precision='fp32'``), as in the JAX package, whose
sharded quantized paths quantize each shard at the plan's geometry over
its own rows in every dispatch.  The port quantizes once per store
version instead: `shard_operands` keeps each shard's codes at every
geometry an executor serves (shared by a runtime's rungs), and
`flush_updates` rebuilds them, so no dispatch quantizes.  They are
bitwise a fresh quantization of each shard's current rows.
`device_bytes` counts them; `resident_bytes`, the tenancy budget's unit,
does not, as the JAX store's counts only its f32 capacity buffer.  A
sharded table is never paged (tenancy pins it).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.boundedme_torch import BlockedPlan, tile_table
from repro_torch.distributed.sharding import quantize_shards
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.store.dynamic_table import _BUILD_CHUNK_TILES, _host_rows

__all__ = ["ShardedTableStore"]


class ShardedTableStore:
    """Mutable, versioned item table row-sharded over the serving mesh.

    Per-shard slot pools of ``cap_local`` rows (the global capacity split
    evenly and rounded up to a ``tile`` multiple per shard); live rows are
    a dense prefix of every shard region, exported as the per-shard
    ``n_valid`` vector (`n_valid_vector`).  New ids append to the shard
    with the most free capacity; deletes swap-fill within their shard.
    Monotonic ``version`` and ``value_abs_max`` follow the
    `DynamicTableStore` contract.  A query's answer is the exact top-K
    merge of the shards' candidates (`merge_topk`).

    Args:
      table: optional (n0, N) initial rows (an array, or a tensor on any
        device), distributed contiguously and evenly across shards —
        shard s takes the next ``n0 // S`` rows (one more for the first
        ``n0 % S`` shards) — unless ``shard_counts`` gives each shard's
        count.
      mesh: the serving `repro_torch.distributed.sharding.Mesh`.
      dim: N when ``table`` is None.
      capacity / capacity_slack / tile / block / ids: as in
        `DynamicTableStore` (capacity is global; each shard gets
        ``cap_local = round_up(ceil(capacity / shards), tile)`` rows).
      shard_counts: optional ``(S,)`` initial rows per shard, in order;
        with the rows and ids of `snapshot` (and ``capacity =
        capacity_rows``) a fresh store reproduces this store's slot map
        and buffers bytewise.
    """

    def __init__(self, table=None, *, mesh, dim: Optional[int] = None,
                 capacity: Optional[int] = None,
                 capacity_slack: float = 1.5, tile: int = 8,
                 block: int = 512, ids=None, shard_counts=None):
        if table is None:
            if dim is None:
                raise ValueError("need `table` or `dim`")
            init = np.zeros((0, int(dim)), np.float32)
        elif isinstance(table, torch.Tensor):
            init = table.detach()
        else:
            init = np.asarray(table, np.float32)
        if init.ndim != 2:
            raise ValueError(f"table must be 2D, got {tuple(init.shape)}")
        n0, N = init.shape
        self.mesh = mesh
        self.n_shards = len(mesh.devices)
        S = self.n_shards
        if capacity is None:
            capacity = max(n0, int(np.ceil(n0 * float(capacity_slack))))
        capacity = max(int(capacity), n0, S)
        self.tile = int(tile)
        self.block = min(int(block), N)
        self.N = N
        per_shard = -(-capacity // S)
        self.cap_local = -(-per_shard // self.tile) * self.tile
        self.capacity_rows = S * self.cap_local
        self.n_blocks = -(-N // self.block)
        self._col_pad = self.n_blocks * self.block - N
        self.precision = "fp32"

        self._host = _host_rows(mesh.devices[0], self.capacity_rows, N)
        self._slot_ids = np.full(self.capacity_rows, -1, np.int64)
        self._id2slot: Dict[int, int] = {}
        self._n_live = np.zeros(S, np.int64)
        if ids is None:
            ids = np.arange(n0, dtype=np.int64)
        else:
            ids = np.asarray(ids, np.int64)
            if ids.shape != (n0,) or len(set(ids.tolist())) != n0:
                raise ValueError("ids must be unique and match table rows")
        if shard_counts is None:
            counts = [n0 // S + (1 if s < n0 % S else 0) for s in range(S)]
        else:
            counts = [int(c) for c in shard_counts]
            if len(counts) != S or sum(counts) != n0 or min(counts) < 0:
                raise ValueError(f"shard_counts {counts} must be {S} "
                                 f"counts summing to {n0}")
        if max(counts, default=0) > self.cap_local:
            raise ValueError("initial table exceeds per-shard capacity")
        host = torch.from_numpy(self._host)
        vmax = 0.0
        row = 0
        for s, c in enumerate(counts):
            base = s * self.cap_local
            part = init[row:row + c]
            if isinstance(part, torch.Tensor):
                host[base:base + c] = part       # one copy (a DMA from a card)
                if c:
                    vmax = max(vmax, float(part.float().abs().max()))
            else:
                self._host[base:base + c] = part
                vmax = max(vmax, float(np.abs(part).max(initial=0.0)))
            self._slot_ids[base:base + c] = ids[row:row + c]
            for j in range(c):
                self._id2slot[int(ids[row + j])] = base + j
            self._n_live[s] = c
            row += c
        self._next_id = int(ids.max()) + 1 if n0 else 0

        self.version = 0
        self._vmax = vmax
        self._staged: List[Tuple[str, int, Optional[np.ndarray]]] = []
        #: optional zero-arg callable run at the top of `flush_updates`;
        #: may raise `StoreFlushError` to fail the flush with every staged
        #: op intact (fault injection surface, DESIGN.md §13)
        self.fault_hook = None
        #: private `repro_torch.obs.metrics` registry (the `store_*`
        #: families of the JAX package's sharded store)
        self.metrics = MetricsRegistry()
        self._c_upserts = self.metrics.counter(
            "store_upserts_total", "Applied row upserts.")
        self._c_deletes = self.metrics.counter(
            "store_deletes_total", "Applied row deletes.")
        self._c_rows_written = self.metrics.counter(
            "store_rows_written_total", "Donated device row writes.")
        self._c_flush_failures = self.metrics.counter(
            "store_flush_failures_total",
            "flush_updates calls failed by the fault hook.")
        self.metrics.gauge(
            "store_live_rows", "Live rows summed over shards.",
        ).set_fn(lambda: self.n_live)
        self.metrics.gauge(
            "store_capacity_rows", "Preallocated row capacity (global).",
        ).set_fn(lambda: self.capacity_rows)
        self.metrics.gauge(
            "store_version", "Monotonic mutation version.",
        ).set_fn(lambda: self.version)
        self.metrics.gauge(
            "store_pending_updates", "Staged, not yet flushed mutations.",
        ).set_fn(lambda: len(self._staged))
        self.metrics.gauge(
            "store_value_abs_max",
            "Monotone max |v| over all applied rows.",
        ).set_fn(lambda: self._vmax)

        self._V4 = [self._upload(s) for s in range(S)]
        #: geometry -> (version, plan, (shards, quantized)): the operands
        #: of every geometry `shard_operands` was asked for
        self._operands: Dict[tuple, tuple] = {}

    # ---- counter surface (registry-backed) -------------------------------

    @property
    def n_upserts(self) -> int:
        """Applied row upserts (registry-backed)."""
        return int(self._c_upserts.total())

    @property
    def n_deletes(self) -> int:
        """Applied row deletes (registry-backed)."""
        return int(self._c_deletes.total())

    @property
    def rows_written(self) -> int:
        """Device row writes (registry-backed)."""
        return int(self._c_rows_written.total())

    @property
    def n_flush_failures(self) -> int:
        """Flushes failed by the fault hook (registry-backed)."""
        return int(self._c_flush_failures.total())

    # ---- device buffers ---------------------------------------------------

    def _upload(self, s: int) -> torch.Tensor:
        """Shard ``s``'s tile-major table on its device, from the host
        mirror, a chunk of tiles at a time."""
        R, dev = self.tile, self.mesh.devices[s]
        n_tiles = self.cap_local // R
        base = s * self.cap_local
        V4 = torch.empty((n_tiles, self.n_blocks, R, self.block),
                         dtype=torch.float32, device=dev)
        for lo in range(0, n_tiles, _BUILD_CHUNK_TILES):
            hi = min(lo + _BUILD_CHUNK_TILES, n_tiles)
            V = torch.from_numpy(
                self._host[base + lo * R:base + hi * R]).to(dev)
            if self._col_pad:
                V = torch.nn.functional.pad(V, (0, self._col_pad))
            V4[lo:hi] = V.reshape(hi - lo, R, self.n_blocks,
                                  self.block).permute(0, 2, 1, 3)
        return V4

    def _write_rows(self, slots) -> None:
        """Copy the host rows of ``slots`` into their shards' tiled tables
        in place: per touched shard, one host-to-device copy and one
        scatter, on that shard's device only."""
        s_all = np.fromiter(sorted(slots), np.int64, len(slots))
        owner = s_all // self.cap_local
        for s in np.unique(owner).tolist():
            sl = s_all[owner == s]
            dev = self.mesh.devices[s]
            rows = torch.from_numpy(self._host[sl]).to(dev)
            if self._col_pad:
                rows = torch.nn.functional.pad(rows, (0, self._col_pad))
            local = torch.from_numpy(sl - s * self.cap_local).to(dev)
            self._V4[s][local // self.tile, :, local % self.tile, :] = \
                rows.view(len(sl), self.n_blocks, self.block)

    def _synchronize(self) -> None:
        for dev in dict.fromkeys(self.mesh.devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    # ---- read side -------------------------------------------------------

    @property
    def n_live(self) -> int:
        """Total live rows across all shards."""
        return int(self._n_live.sum())

    @property
    def free_rows(self) -> int:
        """Free slots summed over every shard's suffix pool."""
        return self.capacity_rows - self.n_live

    @property
    def pending_updates(self) -> int:
        """Mutations staged but not yet applied by `flush_updates`."""
        return len(self._staged)

    @property
    def value_abs_max(self) -> float:
        """Monotonic max|v| over every row ever applied."""
        return self._vmax

    def n_valid_vector(self) -> np.ndarray:
        """Per-shard live counts (shards,): the cascade's validity bounds."""
        return self._n_live.astype(np.int32).copy()

    def tiled_shards(self) -> List[torch.Tensor]:
        """Each shard's (cap_local / tile, n_blocks, tile, block) f32 table
        on its device (columns zero-padded to ``n_blocks * block``), what
        every dispatch reads, updated in place by every flush."""
        return list(self._V4)

    def shard_operands(self, plan: BlockedPlan):
        """``(shards, quantized)`` that a dispatch at ``plan``'s geometry
        reads: each shard's tile-major table (`tiled_shards`, or a copy
        re-laid at a coord plan's pull width) and its tier artifacts at
        the plan's geometry (`quantize_shards`; None on fp32).

        Built once per store version and geometry, and shared by every
        executor at that geometry (a runtime's rungs differ only in
        eps).  `flush_updates` rebuilds each geometry asked for so far,
        so a dispatch after a flush finds them built.
        """
        if plan.tile != self.tile or plan.N != self.N:
            raise ValueError(f"plan geometry (tile {plan.tile}, N {plan.N})"
                             f" differs from the store's ({self.tile}, "
                             f"{self.N})")
        if plan.precision == "fp32" and plan.block == self.block:
            return self.tiled_shards(), None
        key = (plan.precision, plan.block, plan.pq_subdims, plan.pq_codes)
        hit = self._operands.get(key)
        if hit is None or hit[0] != self.version:
            self._operands.pop(key, None)    # free the old copies first
            hit = (self.version, plan, self._build_operands(plan))
            self._operands[key] = hit
        return hit[2]

    def _build_operands(self, plan: BlockedPlan):
        shards = self.tiled_shards()
        if plan.block != self.block:
            shards = [tile_table(V4.permute(0, 2, 1, 3)
                                 .reshape(self.cap_local, -1)[:, :self.N],
                                 plan, dev)
                      for dev, V4 in zip(self.mesh.devices, shards)]
        return shards, quantize_shards(shards, plan)

    def _refresh_operands(self) -> None:
        """Rebuild every cached geometry's operands at this version."""
        for key in list(self._operands):
            self.shard_operands(self._operands[key][1])

    def device_table(self) -> torch.Tensor:
        """The (capacity_rows, N) table row-major on ``mesh.devices[0]``
        (every shard's live prefix + zero slack, in shard order).

        Built from the tiled shards at each call — a full copy, for tests
        and cold paths; the serving path reads `tiled_shards`.
        """
        home = self.mesh.devices[0]
        return torch.cat([
            V4.permute(0, 2, 1, 3).reshape(self.cap_local, -1)[:, :self.N]
            .to(home) for V4 in self._V4])

    def host_table(self) -> np.ndarray:
        """Host mirror (read-only view; always in sync with the device)."""
        v = self._host.view()
        v.flags.writeable = False
        return v

    def external_ids(self, slots) -> np.ndarray:
        """Map global row indices (slots) to external ids (-1 = dead)."""
        slots = np.asarray(slots)
        return self._slot_ids[np.clip(slots, 0, self.capacity_rows - 1)]

    def live_ids(self) -> np.ndarray:
        """External ids of all live rows, in global slot order."""
        return self._slot_ids[self._slot_ids >= 0].copy()

    def live_mask(self) -> np.ndarray:
        """Boolean (capacity_rows,) mask of live slots (dense per shard)."""
        return self._slot_ids >= 0

    def snapshot(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``(rows, ids, shard_counts)`` copies of the live rows in global
        slot order: ``ShardedTableStore(rows, ids=ids, shard_counts=
        shard_counts, capacity=capacity_rows, ...)`` on the same mesh
        reproduces this store's slot map and buffers bytewise."""
        live = self.live_mask()
        return (self._host[live].copy(), self._slot_ids[live].copy(),
                self._n_live.copy())

    def _cached(self):
        for _, _, (shards, quant) in self._operands.values():
            if shards[0] is not self._V4[0]:
                yield from shards                  # a re-laid copy
            for art in quant or ():
                yield from art

    def resident_bytes(self) -> int:
        """Device bytes this table pins, summed over shards, in the JAX
        package's unit: the (capacity_rows, N) f32 capacity buffer alone
        (the JAX store quantizes per dispatch and keeps no codes).  The
        tenancy registry counts them against its budget but never pages
        a sharded table.  `device_bytes` is what the store really holds,
        the cached quantized shards of `shard_operands` included."""
        return self.capacity_rows * self.N * 4

    def device_bytes(self) -> int:
        """Bytes the store really holds on its devices: the tiled shards
        (columns zero-padded to whole blocks) and every cached
        `shard_operands` copy."""
        return sum(t.numel() * t.element_size()
                   for t in (*self._V4, *self._cached()))

    # ---- write side (staged) --------------------------------------------

    def upsert(self, ext_id: int, row) -> None:
        """Stage insert-or-overwrite; new ids route to the emptiest shard."""
        row = np.asarray(row, np.float32)
        if row.shape != (self.N,):
            raise ValueError(f"row shape {row.shape} != ({self.N},)")
        ext_id = int(ext_id)
        if ext_id < 0:
            raise ValueError(f"ids must be >= 0, got {ext_id}")
        self._next_id = max(self._next_id, ext_id + 1)
        self._staged.append(("upsert", ext_id, row.copy()))

    def append(self, row) -> int:
        """Stage an insert under a fresh auto-assigned id; returns the id."""
        ext_id = self._next_id
        self.upsert(ext_id, row)
        return ext_id

    def delete(self, ext_id: int) -> None:
        """Stage removal; swap-fills within the owning shard's region."""
        self._staged.append(("delete", int(ext_id), None))

    # ---- apply -----------------------------------------------------------

    def _route(self) -> int:
        free = self.cap_local - self._n_live
        s = int(np.argmax(free))
        if free[s] <= 0:
            raise RuntimeError(
                f"store full: {self.n_live}/{self.capacity_rows} rows live "
                f"across {self.n_shards} shards; provision more capacity")
        return s

    def _apply_upsert(self, ext_id: int, row: np.ndarray,
                      touched: set) -> None:
        slot = self._id2slot.get(ext_id)
        if slot is None:
            s = self._route()
            slot = s * self.cap_local + int(self._n_live[s])
            self._id2slot[ext_id] = slot
            self._slot_ids[slot] = ext_id
            self._n_live[s] += 1
        self._host[slot] = row
        self._c_rows_written.inc()
        touched.add(slot)
        self._vmax = max(self._vmax, float(np.abs(row).max(initial=0.0)))
        self._c_upserts.inc()
        self.version += 1

    def _apply_delete(self, ext_id: int, touched: set) -> None:
        slot = self._id2slot.pop(ext_id, None)
        if slot is None:
            raise KeyError(f"delete of unknown id {ext_id}")
        s = slot // self.cap_local
        last = s * self.cap_local + int(self._n_live[s]) - 1
        if slot != last:
            moved = self._slot_ids[last]
            self._host[slot] = self._host[last]
            self._c_rows_written.inc()
            self._slot_ids[slot] = moved
            self._id2slot[int(moved)] = slot
            touched.add(slot)
        self._host[last] = 0.0
        self._c_rows_written.inc()
        self._slot_ids[last] = -1
        touched.add(last)
        self._n_live[s] -= 1
        self._c_deletes.inc()
        self.version += 1

    def flush_updates(self) -> dict:
        """Apply staged mutations in order; returns ``{"applied",
        "version", "requantized_tiles", "seconds"}`` (the tile counter is
        always 0: no shadow is kept here).

        Each op updates the host mirror and the slot maps; then the
        touched rows are written in place into their shards' buffers.  A
        failing op (unknown delete, every shard full) is dropped, its
        successors stay staged, and the buffers still take everything
        applied before the error re-raises.  An installed ``fault_hook``
        runs first and may raise `StoreFlushError` with the staged queue
        untouched.
        """
        t0 = time.perf_counter()
        if self.fault_hook is not None:
            try:
                self.fault_hook()
            except Exception:
                # nothing taken yet: every staged op survives for retry
                self._c_flush_failures.inc()
                raise
        touched: set = set()
        applied = 0
        staged, self._staged = self._staged, []
        try:
            for op, ext_id, row in staged:
                if op == "upsert":
                    self._apply_upsert(ext_id, row, touched)
                else:
                    self._apply_delete(ext_id, touched)
                applied += 1
        except Exception:
            self._staged = staged[applied + 1:] + self._staged
            raise
        finally:
            if touched:
                self._write_rows(touched)
                self._refresh_operands()
            if applied:
                self._synchronize()
        return {"applied": applied, "version": self.version,
                "requantized_tiles": 0,
                "seconds": time.perf_counter() - t0}

    # ---- observability ---------------------------------------------------

    def stats(self) -> dict:
        """Counters: per-shard occupancy, version, churn totals."""
        return {"n_live": self.n_live, "capacity_rows": self.capacity_rows,
                "cap_local": self.cap_local, "n_shards": self.n_shards,
                "per_shard_live": self._n_live.tolist(),
                "utilization": self.n_live / max(1, self.capacity_rows),
                "version": self.version, "upserts": self.n_upserts,
                "deletes": self.n_deletes, "rows_written": self.rows_written,
                "value_abs_max": self._vmax,
                "pending": len(self._staged)}
