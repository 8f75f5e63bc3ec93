"""Multi-tenant, multi-table serving of the port on one device (DESIGN.md
§16).

The PyTorch counterpart of ``repro.launch.tenancy``.  The paper's
no-preprocessing claim is what makes per-tenant tables cheap: BoundedME
needs no index build, so a corpus is one store construction and one
calibrated plan.  Three parts, as in the JAX package:

  * :class:`TenantConfig` — one tenant's serving contract ((eps, delta)
    with an optional degradation floor, tier, bound family, pull mode,
    priority and deadline, queue capacity, DRR weight, store capacity,
    pinning).
  * :class:`TableRegistry` — the **table manager**: named
    `repro_torch.store.DynamicTableStore` instances on one device (and
    pinned `ShardedTableStore`s over a mesh) under a device byte budget.  Cold tables are paged out least-recently-served
    first, so registering a tenant never runs the card out of memory: it
    fits after evictions or is refused with a typed :class:`TenancyError`.
    Pinned and in-flight tables are never evicted.  The registry also
    owns the bounded **executor cache**: each tenant's ladder of
    `repro_torch.launch.engine.CascadeExecutor` rungs, keyed on (tenant,
    store identity and residency generation, capacity, codebook
    refreshes), so `grow()`, `refresh_codebook()` and a page-in each
    rebuild it, and value-range growth recalibrates on acquire
    (`CascadeExecutor.sync_store`).
  * :class:`MultiTenantRuntime` — the **scheduler**: per-tenant admission
    queues, ladders, caches and dispatch sequences, and deficit-round-
    robin batch assembly across tenants, so a flood from one tenant only
    fills its own queue and a hot tenant cannot starve the rest.  A
    tenant's answers are bitwise a dedicated `ServeRuntime`'s with the
    same config, seed and batches: dispatch ``didx`` of tenant ``t`` runs
    under ``perm_source(t, didx, n_blocks)``, by default
    ``seeded_perm(config.seed, didx, n_blocks)`` — the draw a dedicated
    runtime built with ``seed=config.seed`` makes.

What differs from the JAX package is paging.  Eviction frees the store's
device buffers and keeps its host side (`DynamicTableStore.page_out`); a
page-in lays the page-locked host mirror out on the card again and
re-encodes the shadow there (`page_in`), bytewise the buffers before
eviction — one DMA of the table and no host copy of its rows, where the
JAX package rebuilds the store from a `page_state` image.  The budget
counts each store's `resident_bytes`, in the JAX package's unit (an
``(capacity_rows, N)`` f32 table plus the shadow; the tiled table's
zero-padded columns, where ``N`` is not a whole number of blocks, lie
outside it, as does the re-laid copy an fp32 store served in ``coord``
mode keeps per executor, ROADMAP.md queue 1 item 4).  A sharded tenant
(``register(..., mesh=)``, a `repro_torch.store.ShardedTableStore`) is
counted against the budget and pinned: per-shard slot pools are never
paged out, as in the JAX package.

Observability: every ``serve_*`` family carries a ``tenant`` label, spans
are annotated with the tenant at `request_begin`, and the flight recorder
logs registration, eviction, page-in, executor rebuild and table
unavailable events.  Store registries are **not** adopted: their gauges'
closures would keep a paged-out store reachable from the metrics, and two
stores' ``store_*`` rows would collide; per-tenant store stats surface
through ``stats()["tenants"]``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import struct
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.boundedme_torch import resolve_device
from repro_torch.distributed.sharding import dispatch_lane_stats
from repro_torch.launch.admission import (AdmissionController,
                                          DeficitRoundRobin,
                                          DegradationLadder, PriorityClass,
                                          ServeResult, Ticket)
from repro_torch.launch.engine import (CascadeExecutor, DispatchFailed,
                                       QuantizedLRU, dispatch_with_retries,
                                       seeded_perm)
from repro_torch.obs.metrics import (PULL_FRAC_BUCKETS, MetricsRegistry,
                                     summarize_latencies)
from repro_torch.store import (DynamicTableStore, ShardedTableStore,
                               StoreFlushError)

__all__ = ["TenancyError", "TenantConfig", "TableRegistry",
           "MultiTenantRuntime"]

_PRECISIONS = ("fp32", "int8", "int4", "pq")


class TenancyError(RuntimeError):
    """Typed refusal from the table registry.

    Raised instead of letting the card run out of memory: a registration
    that cannot fit inside the byte budget even after evicting every
    evictable table, an eviction of a pinned or in-flight table, or an
    operation on an unknown tenant.  The pool's resident state is
    unchanged when this raises.
    """


@dataclasses.dataclass(frozen=True)
class TenantConfig:
    """One tenant's serving contract and placement policy.

    The serving knobs mirror `repro_torch.launch.engine.ServeRuntime`'s
    constructor — a tenant served through `MultiTenantRuntime` under this
    config gets answers bit-identical to a dedicated runtime's built with
    the same arguments and seed.  ``weight`` scales the tenant's deficit-round-
    robin share, ``priority`` / ``deadline_ms`` define its one priority
    class, ``queue_capacity`` bounds its private admission queue,
    ``capacity`` provisions its store and ``pinned`` exempts its table
    from eviction.
    """

    # serving contract
    K: int = 1
    eps: float = 0.1
    delta: float = 0.1
    eps_floor: Optional[float] = None
    degrade_rungs: int = 3
    degrade_start: float = 0.5
    precision: str = "fp32"
    bound: str = "hoeffding"
    pull_mode: str = "row"
    coord_block: int = 128
    quant_err: Optional[float] = None
    pq_subdims: int = 8
    pq_codes: int = 16
    adaptive: bool = False
    value_range: Optional[float] = None
    qmax_hint: float = 1.0
    range_slack: float = 1.0
    tile: int = 8
    block: int = 512
    # per-tenant cache
    cache_entries: int = 512
    cache_resolution: float = 1e-3
    # placement / scheduling policy
    weight: float = 1.0
    priority: int = 1
    deadline_ms: float = 50.0
    queue_capacity: int = 64
    capacity: Optional[int] = None
    pinned: bool = False
    seed: int = 0

    def __post_init__(self):
        if self.precision not in _PRECISIONS:
            raise ValueError(f"unknown precision {self.precision!r} "
                             f"(expected one of {_PRECISIONS})")
        if self.eps <= 0:
            raise ValueError(f"eps must be > 0, got {self.eps}")
        if not 0.0 < self.delta < 1.0:
            raise ValueError(f"delta must be in (0, 1), got {self.delta}")
        if self.weight <= 0:
            raise ValueError(f"weight must be > 0, got {self.weight}")
        if self.queue_capacity < 1:
            raise ValueError(f"queue_capacity must be >= 1, "
                             f"got {self.queue_capacity}")

    def ladder(self) -> DegradationLadder:
        """This tenant's degradation ladder (eps -> eps_floor rungs)."""
        return DegradationLadder(self.eps, self.eps_floor,
                                 rungs=self.degrade_rungs,
                                 start=self.degrade_start)

    def priority_classes(self) -> Dict[str, PriorityClass]:
        """The tenant's single admission class, from priority/deadline."""
        return {"default": PriorityClass("default", priority=self.priority,
                                         deadline_ms=self.deadline_ms)}


@dataclasses.dataclass
class _TableEntry:
    """Registry-internal record of one tenant's table (the store object
    lives on through evictions; only its device buffers come and go)."""

    name: str
    config: TenantConfig
    store: object
    nbytes: int
    pinned: bool
    last_serve: int
    sharded: bool = False
    in_flight: bool = False
    page_ins: int = 0
    exec_salt: Optional[tuple] = None

    @property
    def resident(self) -> bool:
        return self.sharded or self.store.resident


class TableRegistry:
    """Byte-budgeted registry of named tenant tables + executor cache.

    The table-manager layer (DESIGN.md §16).  `register` builds (or
    adopts) a store per tenant on ``device`` and admits it against
    ``byte_budget`` (device bytes, `DynamicTableStore.resident_bytes`),
    evicting cold tables least-recently-served first — registration fits
    or raises a typed `TenancyError`.  `executors` hands out each
    tenant's ladder of `CascadeExecutor` rungs from a bounded LRU cache
    whose key is salted with (store identity and residency generation,
    ``capacity_rows``, ``codebook_refreshes``): `grow()`,
    `refresh_codebook()` and a page-in each miss and rebuild (a pq
    rebuild re-measures ``quant_err`` against the new codebook), while
    value-range growth recalibrates on acquire.  A rebuild warms every
    rung with one dispatch off the serving clock (``warm_on_build``).

    Invariants: resident bytes never exceed ``byte_budget`` (a pinned
    table's growth is the one override, recorded on the flight
    recorder); pinned and in-flight tables are never evicted; evictions
    pick the least-recently-served evictable table; a paged table comes
    back bytewise.  Not thread-safe; drive it from the runtime's loop.
    """

    def __init__(self, *, byte_budget: Optional[int] = None,
                 max_executors: int = 8, lanes: int = 8,
                 warm_on_build: bool = True,
                 metrics: Optional[MetricsRegistry] = None,
                 flight=None, device="cuda"):
        if max_executors < 1:
            raise ValueError(f"max_executors must be >= 1, "
                             f"got {max_executors}")
        if lanes < 1:
            raise ValueError(f"lanes must be >= 1, got {lanes}")
        self.device = resolve_device(device)
        self.byte_budget = None if byte_budget is None else int(byte_budget)
        self.max_executors = int(max_executors)
        self.lanes = int(lanes)
        self.warm_on_build = bool(warm_on_build)
        self.flight = flight
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._entries: "OrderedDict[str, _TableEntry]" = OrderedDict()
        self._exec_cache: "OrderedDict[tuple, list]" = OrderedDict()
        self._serve_clock = 0
        m = self.metrics
        self._c_registrations = m.counter(
            "tenancy_registrations_total", "Tenant tables registered.",
            ("tenant",))
        self._c_evictions = m.counter(
            "tenancy_evictions_total",
            "Tables paged out of device memory.", ("tenant",))
        self._c_page_ins = m.counter(
            "tenancy_page_ins_total",
            "Tables paged back into device memory.", ("tenant",))
        self._c_exec_builds = m.counter(
            "tenancy_executor_builds_total",
            "Executor-ladder (re)builds, by cause.", ("tenant", "cause"))
        self._h_page_in = m.histogram(
            "tenancy_page_in_ms", "Page-in (store rebuild) cost (ms).")
        self._h_warm = m.histogram(
            "tenancy_warm_ms",
            "Off-clock warm cost per executor-ladder build (ms).")
        m.gauge("tenancy_resident_bytes",
                "Device bytes of resident tenant tables.",
                ).set_fn(self.resident_bytes)
        m.gauge("tenancy_byte_budget", "Configured device byte budget.",
                ).set_fn(lambda: (-1 if self.byte_budget is None
                                  else self.byte_budget))
        m.gauge("tenancy_tables_resident", "Tables currently resident.",
                ).set_fn(lambda: sum(1 for e in self._entries.values()
                                     if e.resident))
        m.gauge("tenancy_executor_cache_entries",
                "Cached executor ladders.",
                ).set_fn(lambda: len(self._exec_cache))

    # ---- introspection ----------------------------------------------------

    def tenants(self) -> List[str]:
        """Registered tenant names, in registration order."""
        return list(self._entries)

    def config(self, name: str) -> TenantConfig:
        """A tenant's config."""
        return self._entry(name).config

    def is_resident(self, name: str) -> bool:
        """True iff the tenant's table is on the device right now."""
        return self._entry(name).resident

    def is_pinned(self, name: str) -> bool:
        """True iff the tenant's table is exempt from eviction."""
        return self._entry(name).pinned

    def table_bytes(self, name: str) -> int:
        """Device bytes the tenant's table occupies when resident."""
        return self._entry(name).nbytes

    def resident_bytes(self) -> int:
        """Total device bytes of currently-resident tables."""
        return sum(e.nbytes for e in self._entries.values() if e.resident)

    def store(self, name: str):
        """The tenant's live store, or None while paged out (use
        `ensure_resident` to page in)."""
        entry = self._entry(name)
        return entry.store if entry.resident else None

    def lru_order(self) -> List[str]:
        """Evictable resident tenants, least-recently-served first."""
        evictable = [e for e in self._entries.values()
                     if self._evictable(e)]
        return [e.name for e in sorted(evictable,
                                       key=lambda e: e.last_serve)]

    def _entry(self, name: str) -> _TableEntry:
        try:
            return self._entries[name]
        except KeyError:
            raise TenancyError(f"unknown tenant {name!r}; registered: "
                               f"{sorted(self._entries)}") from None

    # ---- registration / residency -----------------------------------------

    def register(self, name: str, table, config: Optional[TenantConfig]
                 = None, *, mesh=None):
        """Admit a new tenant table under the byte budget; returns it.

        ``table`` may be raw (n, N) rows (an array, or a tensor on any
        device: a store is built on the registry's device with the
        config's geometry, tier and capacity), or an existing
        `DynamicTableStore` on that device or `ShardedTableStore` to
        adopt.  ``mesh`` builds a `ShardedTableStore` over the mesh's
        devices (fp32; the tenant's executors quantize each shard at its
        tier); sharded tables are pinned.  If admitting the table would
        exceed ``byte_budget``, cold evictable tables are paged out
        least-recently-served first; when even that cannot make room the
        registration is refused with `TenancyError` and the pool is left
        as it was: registering a tenant never OOMs the budget.
        """
        if name in self._entries:
            raise TenancyError(f"tenant {name!r} already registered")
        config = config if config is not None else TenantConfig()
        if isinstance(table, ShardedTableStore):
            store = table
        elif mesh is not None:
            store = ShardedTableStore(
                table, mesh=mesh, capacity=config.capacity,
                tile=config.tile, block=config.block)
        elif isinstance(table, DynamicTableStore):
            store = table
            if store.device != self.device or not store.resident:
                raise ValueError(
                    f"tenant {name!r}: the store lives on {store.device}"
                    f"{'' if store.resident else ' (paged out)'}; the "
                    f"registry serves resident stores on {self.device}")
        else:
            store = DynamicTableStore(
                table, capacity=config.capacity, tile=config.tile,
                block=config.block, precision=config.precision,
                pq_subdims=config.pq_subdims, pq_codes=config.pq_codes,
                device=self.device)
        nbytes = int(store.resident_bytes())
        if self.byte_budget is not None and nbytes > self.byte_budget:
            raise TenancyError(
                f"tenant {name!r} needs {nbytes} bytes > budget "
                f"{self.byte_budget}: table cannot fit even alone")
        self._make_room(nbytes)
        self._serve_clock += 1
        sharded = isinstance(store, ShardedTableStore)
        entry = _TableEntry(name=name, config=config, store=store,
                            nbytes=nbytes,
                            pinned=bool(config.pinned) or sharded,
                            last_serve=self._serve_clock, sharded=sharded)
        self._entries[name] = entry
        self._c_registrations.inc(tenant=name)
        if self.flight is not None:
            self.flight.record("tenant_registered", None, tenant=name,
                               bytes=nbytes, pinned=entry.pinned,
                               sharded=sharded,
                               resident_bytes=self.resident_bytes())
        return store

    def remove(self, name: str) -> None:
        """Drop a tenant entirely (store and cached executors)."""
        entry = self._entry(name)
        if entry.in_flight:
            raise TenancyError(f"tenant {name!r} is in flight")
        self._drop_executors(name)
        del self._entries[name]

    def _evictable(self, entry: _TableEntry) -> bool:
        return (entry.resident and not entry.pinned and not entry.in_flight
                and not entry.sharded)

    def _make_room(self, incoming: int) -> None:
        """Page out LRU evictable tables until ``incoming`` bytes fit."""
        if self.byte_budget is None:
            return
        while self.resident_bytes() + incoming > self.byte_budget:
            order = self.lru_order()
            if not order:
                raise TenancyError(
                    f"cannot make room for {incoming} bytes: "
                    f"{self.resident_bytes()} resident, every table "
                    f"pinned or in flight (budget {self.byte_budget})")
            self.evict(order[0])

    def evict(self, name: str) -> None:
        """Page one table out of device memory (refuses pinned, in-flight
        and sharded tables with `TenancyError`).

        The tenant's cached executors are dropped first, then the store
        frees its device buffers (`DynamicTableStore.page_out`): no
        reference to them is left, so the card's allocated bytes fall by
        the table's.  The host side keeps rows, ids, version, value
        range, the pq codebook and staged mutations; the next serve's
        page-in rebuilds the buffers bit-identical (bytewise).
        """
        entry = self._entry(name)
        if not entry.resident:
            return
        if entry.sharded:
            raise TenancyError(f"tenant {name!r} is sharded (auto-pinned: "
                               f"per-shard slot pools have no page image)")
        if entry.pinned:
            raise TenancyError(f"tenant {name!r} is pinned; unpin before "
                               f"evicting")
        if entry.in_flight:
            raise TenancyError(f"tenant {name!r} is in flight")
        self._drop_executors(name)
        entry.store.page_out()
        self._c_evictions.inc(tenant=name)
        if self.flight is not None:
            self.flight.record("tenant_evicted", None, tenant=name,
                               bytes=entry.nbytes,
                               resident_bytes=self.resident_bytes())

    def _reaccount(self, entry: _TableEntry) -> None:
        """Refresh one resident table's byte accounting and rebalance.

        ``grow()`` happens on the store, outside the registry — the next
        acquire lands here and trues up ``entry.nbytes``.  If growth
        pushed the pool over budget, colder evictable tables are paged
        out first; when nothing else is evictable the grown table itself
        is paged back out and the acquire refused with `TenancyError` —
        unless it is pinned, the one operator action allowed to override
        the budget (kept resident, surfaced on the flight recorder).
        """
        if not entry.resident:
            return
        nb = int(entry.store.resident_bytes())
        if nb == entry.nbytes:
            return
        entry.nbytes = nb
        if self.byte_budget is None:
            return
        guard = entry.in_flight
        entry.in_flight = True
        try:
            self._make_room(0)
            return
        except TenancyError:
            pass
        finally:
            entry.in_flight = guard
        if entry.pinned:
            if self.flight is not None:
                self.flight.record("budget_overridden", None,
                                   tenant=entry.name, bytes=nb,
                                   budget=self.byte_budget)
            return
        entry.in_flight = False
        try:
            self.evict(entry.name)
        finally:
            entry.in_flight = guard
        raise TenancyError(
            f"tenant {entry.name!r} grew to {nb} bytes and nothing else "
            f"is evictable (budget {self.byte_budget}); paged back out")

    def ensure_resident(self, name: str) -> float:
        """Page the tenant's table in if needed; returns page-in seconds.

        Page-in may itself evict colder tables to fit the budget (the
        in-flight flag keeps the paging tenant from being its own
        victim); the seconds cover those evictions and the page-in up to
        its closing synchronize.  A resident table is re-accounted
        against the budget instead (its store may have grown since the
        last acquire — see `_reaccount`).
        """
        entry = self._entry(name)
        if entry.resident:
            self._reaccount(entry)
            return 0.0
        t0 = time.perf_counter()
        guard = entry.in_flight
        entry.in_flight = True
        try:
            self._make_room(entry.nbytes)
            entry.store.page_in()
        finally:
            entry.in_flight = guard
        entry.page_ins += 1
        dt = time.perf_counter() - t0
        self._c_page_ins.inc(tenant=name)
        self._h_page_in.observe(dt * 1e3)
        if self.flight is not None:
            self.flight.record("tenant_paged_in", None, tenant=name,
                               bytes=entry.nbytes, seconds=dt,
                               resident_bytes=self.resident_bytes())
        return dt

    def pin(self, name: str) -> None:
        """Exempt a tenant's table from LRU eviction."""
        self._entry(name).pinned = True

    def unpin(self, name: str) -> None:
        """Make a tenant's table evictable again (a sharded table stays
        pinned, as in the JAX package: it has no page image).

        If pinned growth had pushed the pool past the budget (the
        override `_reaccount` allows), releasing a pin rebalances at
        once: evictable tables are paged out LRU-first until the budget
        holds again.
        """
        entry = self._entry(name)
        if entry.sharded:
            return
        entry.pinned = False
        if self.byte_budget is not None:
            try:
                self._make_room(0)
            except TenancyError:
                pass    # remaining overage is all pinned growth

    def touch(self, name: str) -> None:
        """Record a serve for LRU purposes (freshest = last evicted)."""
        self._serve_clock += 1
        self._entry(name).last_serve = self._serve_clock

    @contextlib.contextmanager
    def serving(self, name: str):
        """Mark a tenant in-flight for the duration of a dispatch:
        in-flight tables are never chosen as eviction victims."""
        entry = self._entry(name)
        entry.in_flight = True
        try:
            yield entry
        finally:
            entry.in_flight = False

    # ---- executor cache ---------------------------------------------------

    def _salt(self, entry: _TableEntry) -> tuple:
        store = entry.store
        return ((id(store), entry.page_ins), store.capacity_rows,
                getattr(store, "codebook_refreshes", 0))

    def _drop_executors(self, name: str) -> None:
        for key in [k for k in self._exec_cache if k[0] == name]:
            del self._exec_cache[key]

    def executors(self, name: str) -> Tuple[List[CascadeExecutor], float]:
        """The tenant's degradation-ladder executors, cache- and
        residency-managed; returns ``(executors, page_in_seconds)``.

        Ensures the table is resident (paging it in if evicted) and
        touches its LRU stamp.  The cache key is salted with the store's
        identity and residency generation, ``capacity_rows`` and
        ``codebook_refreshes`` — so `grow()`, `refresh_codebook()` and a
        page-in each miss and rebuild.  On a hit, `CascadeExecutor.
        sync_store` still runs per rung, recalibrating in place when the
        store's monotonic value range outgrew the plan.  The cache holds
        at most ``max_executors`` ladders, LRU-evicted.
        """
        page_s = self.ensure_resident(name)
        entry = self._entry(name)
        self.touch(name)
        salt = self._salt(entry)
        key = (name, salt)
        execs = self._exec_cache.get(key)
        if execs is not None:
            self._exec_cache.move_to_end(key)
            for ex in execs:
                ex.sync_store()
            return execs, page_s
        cause = "new"
        if entry.exec_salt is not None:
            old = entry.exec_salt
            # residency first: a page-in rebuilds the device buffers, so
            # refresh / capacity deltas only count within one residency
            if salt[0] != old[0]:
                cause = "page_in"
            elif salt[2] != old[2]:
                cause = "codebook_refresh"
            elif salt[1] != old[1]:
                cause = "grow"
            else:
                cause = "cache_evicted"
        self._drop_executors(name)
        cfg = entry.config
        execs = [CascadeExecutor(
            entry.store, K=cfg.K, eps=e, delta=cfg.delta,
            value_range=cfg.value_range, qmax_hint=cfg.qmax_hint,
            tile=cfg.tile, block=cfg.block, precision=cfg.precision,
            range_slack=cfg.range_slack, adaptive=cfg.adaptive,
            bound=cfg.bound, pull_mode=cfg.pull_mode,
            coord_block=cfg.coord_block, quant_err=cfg.quant_err,
            pq_subdims=cfg.pq_subdims, pq_codes=cfg.pq_codes,
            metrics=self.metrics,
            metrics_labels={"tenant": name, "rung": str(i)},
            device=self.device)
            for i, e in enumerate(cfg.ladder().eps_values)]
        entry.exec_salt = salt
        self._exec_cache[key] = execs
        self._c_exec_builds.inc(tenant=name, cause=cause)
        warm_s = 0.0
        if self.warm_on_build:
            # one dispatch per rung off the serving clock, like
            # ServeRuntime.warmup: otherwise the first dispatch after a
            # rebuild is charged its first-call set-up and reads as an
            # overload
            t0 = time.perf_counter()
            Qz = np.zeros((self.lanes, entry.store.N), np.float32)
            for ex in execs:
                ex.dispatch(Qz, np.arange(ex.plan.n_blocks))
            warm_s = time.perf_counter() - t0
            self._h_warm.observe(warm_s * 1e3)
        if self.flight is not None and cause != "new":
            self.flight.record("executor_rebuild", None, tenant=name,
                               cause=cause, warm_ms=warm_s * 1e3)
        while len(self._exec_cache) > self.max_executors:
            self._exec_cache.popitem(last=False)
        return execs, page_s

    def executor_cache_size(self) -> int:
        """Cached executor ladders (bounded by ``max_executors``)."""
        return len(self._exec_cache)

    def executor_builds(self, name: str) -> Dict[str, int]:
        """Per-cause ladder (re)build counts for one tenant."""
        out: Dict[str, int] = {}
        for labels, value in self._c_exec_builds.rows():
            if labels["tenant"] == name:
                out[labels["cause"]] = int(value)
        return out

    def stats(self) -> dict:
        """Registry telemetry: budget, residency, per-tenant placement
        (the JAX package's keys)."""
        return {
            "byte_budget": self.byte_budget,
            "resident_bytes": self.resident_bytes(),
            "tables": len(self._entries),
            "tables_resident": sum(1 for e in self._entries.values()
                                   if e.resident),
            "executor_cache_entries": len(self._exec_cache),
            "evictions": int(self._c_evictions.total()),
            "page_ins": int(self._c_page_ins.total()),
            "tenants": {e.name: {
                "resident": e.resident,
                "bytes": e.nbytes,
                "pinned": e.pinned,
                "sharded": e.sharded,
                "last_serve": e.last_serve,
                "executor_builds": self.executor_builds(e.name),
            } for e in self._entries.values()},
        }


class _TenantState:
    """Runtime-internal per-tenant serving state.

    Mirrors a dedicated `ServeRuntime`'s internals — own admission queue,
    ladder, result cache and dispatch sequence — so serving through the
    multi-tenant scheduler is bitwise a dedicated runtime given the same
    config, seed and batch composition.
    """

    def __init__(self, name: str, config: TenantConfig, dim: int,
                 store_version: int, refreshes: int):
        self.name = name
        self.config = config
        self.ladder = config.ladder()
        # private metrics registry: per-tenant AdmissionControllers must
        # not share gauge rows (set_fn would be overwritten); per-tenant
        # queue stats surface via stats()["tenants"] instead
        self.admission = AdmissionController(
            dim, queue_capacity=config.queue_capacity,
            classes=config.priority_classes(),
            metrics=MetricsRegistry())
        self.cache = QuantizedLRU(config.cache_entries,
                                  config.cache_resolution)
        self.dispatch_seq = 0
        self.version = store_version
        self.seen_refreshes = refreshes
        self.lat: List[float] = []
        self.requests = 0
        self.outcomes = {s: 0 for s in ("ok", "degraded", "rejected",
                                        "overloaded", "failed")}

    def salted(self, base_key: bytes) -> bytes:
        return struct.pack("<qi", self.version, self.config.K) + base_key


class MultiTenantRuntime:
    """Fair cross-tenant continuous-batching scheduler (DESIGN.md §16).

    Drives many tenants' tables through one device: requests carry a
    ``tenant`` at `submit`, land in that tenant's *private* admission
    queue (a poison flood or overload from one tenant can only fill its
    own bounded queue), and `poll` assembles per-tenant micro-batches
    under deficit-round-robin: each round every backlogged tenant's
    deficit grows by ``lanes * weight`` and it may dispatch up to it, so
    with every tenant backlogged each gets about one full dispatch per
    round whatever the arrival skew, no backlogged tenant starves, and
    idle tenants cost nothing.  That is the tenants' isolation: one
    tenant's load delays another's by at most a round.
    Executors come from the `TableRegistry`'s bounded cache; acquiring
    them pages an evicted table back in (its seconds are charged to the
    dispatch's virtual busy time), and the in-flight guard keeps the
    serving table off the eviction list.

    Per-tenant results are bit-identical to a dedicated `ServeRuntime`'s
    with the
    same `TenantConfig`, seed and batch composition: dispatch ``didx`` of
    tenant ``t`` serves under ``perm_source(t, didx, n_blocks)`` (default
    ``seeded_perm(config.seed, didx, n_blocks)``, the dedicated runtime's
    draw; tests inject the JAX package's permutations), and runs under
    the same retry and fault machinery (`dispatch_with_retries`).
    Warm-ups run under the identity permutation and never advance a
    tenant's dispatch sequence.  Every request ends as a typed
    `ServeResult` with ``tenant`` set; traffic never raises.

    ``stats()`` keeps the single-runtime top-level shape aggregated
    across tenants — stream drivers and ``--check-outcomes`` work
    unchanged — plus ``tenants`` (per-tenant breakdowns) and
    ``registry`` (residency and eviction telemetry), the JAX package's
    keys in its order.
    """

    def __init__(self, registry: TableRegistry, *,
                 batch_wait_ms: float = 2.0, max_retries: int = 2,
                 retry_backoff_ms: float = 1.0,
                 dispatch_timeout_ms: Optional[float] = None,
                 fault_injector=None, recall_sample_rate: float = 0.0,
                 drr_cap_rounds: float = 2.0, seed: int = 0,
                 metrics: Optional[MetricsRegistry] = None,
                 tracer=None, flight=None,
                 perm_source: Optional[Callable[[str, int, int],
                                                object]] = None):
        if batch_wait_ms <= 0:
            raise ValueError(f"batch_wait_ms must be > 0, "
                             f"got {batch_wait_ms}")
        if max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {max_retries}")
        self.registry = registry
        self.lanes = registry.lanes
        self.batch_wait_s = float(batch_wait_ms) * 1e-3
        self.max_retries = int(max_retries)
        self.retry_backoff_s = float(retry_backoff_ms) * 1e-3
        self.dispatch_timeout_s = (None if dispatch_timeout_ms is None
                                   else float(dispatch_timeout_ms) * 1e-3)
        self.injector = fault_injector
        self.metrics = metrics if metrics is not None else registry.metrics
        if self.metrics is not registry.metrics:
            self.metrics.adopt(registry.metrics)
        if fault_injector is not None:
            self.metrics.adopt(fault_injector.metrics)
        self.tracer = tracer
        self.flight = flight if flight is not None else registry.flight
        self._perm_source = (perm_source if perm_source is not None else
                             (lambda t, didx, nb: seeded_perm(
                                 self.registry.config(t).seed, didx, nb)))
        self.drr = DeficitRoundRobin(self.lanes, cap_rounds=drr_cap_rounds)
        self._states: Dict[str, _TenantState] = {}
        self._results: Dict[int, ServeResult] = {}
        self._next_id = 0
        self._recall_rate = float(recall_sample_rate)
        self._recall_rng = np.random.default_rng(seed)
        self._recalls: List[float] = []
        self._lat: List[float] = []
        self._occupancy: List[int] = []
        self._pull_fracs: List[float] = []
        m = self.metrics
        self._c_requests = m.counter(
            "serve_requests_total", "Requests submitted, by tenant/class.",
            ("tenant", "priority_class"))
        self._c_outcomes = m.counter(
            "serve_outcomes_total",
            "Terminal request outcomes, by tenant.", ("tenant", "outcome"))
        self._c_cache_hits = m.counter(
            "serve_cache_hits_total",
            "Requests answered from a tenant LRU.", ("tenant",))
        self._c_dispatches = m.counter(
            "serve_dispatches_total",
            "Batch dispatches, by tenant and lane occupancy.",
            ("tenant", "filled"))
        self._c_retries = m.counter(
            "serve_retries_total", "Dispatch retry attempts.", ("tenant",))
        self._c_dispatch_errors = m.counter(
            "serve_dispatch_errors_total",
            "Dispatch attempts that raised (injected or real).",
            ("tenant",))
        self._c_failed_batches = m.counter(
            "serve_failed_batches_total",
            "Micro-batches failed past the retry budget.", ("tenant",))
        self._c_slow = m.counter(
            "serve_slow_dispatches_total",
            "Dispatches exceeding dispatch_timeout_ms.", ("tenant",))
        self._c_flush_failures = m.counter(
            "serve_store_flush_failures_total",
            "Store flushes failed by StoreFlushError (retried later).",
            ("tenant",))
        self._c_update_errors = m.counter(
            "serve_update_errors_total",
            "Store flushes that raised a non-flush error.", ("tenant",))
        self._c_update_rows = m.counter(
            "serve_update_rows_total", "Store mutations applied.",
            ("tenant",))
        self._c_rung = m.counter(
            "serve_rung_served_total",
            "Requests answered per tenant ladder rung.",
            ("tenant", "rung"))
        self._h_latency = m.histogram(
            "serve_latency_ms",
            "Answered-request latency (ms), by tenant and outcome.",
            ("tenant", "outcome"))
        self._h_queue_wait = m.histogram(
            "serve_queue_wait_ms",
            "Submit-to-dispatch queue wait (ms) of dispatched requests.",
            ("tenant",))
        self._h_occupancy = m.histogram(
            "serve_batch_occupancy", "Filled lanes per dispatch.",
            ("tenant",),
            buckets=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0))
        self._h_pull_frac = m.histogram(
            "serve_pull_frac",
            "Executed pull fraction per dispatch (pulls / budget).",
            ("tenant",), buckets=PULL_FRAC_BUCKETS)

    # ---- tenant state -----------------------------------------------------

    def _state(self, name: str) -> _TenantState:
        st = self._states.get(name)
        if st is None:
            cfg = self.registry.config(name)
            # a paged-out store still knows its width, version and
            # refreshes (its host side stays)
            store = self.registry._entry(name).store
            st = _TenantState(name, cfg, store.N, store.version,
                              getattr(store, "codebook_refreshes", 0))
            self._states[name] = st
            self.drr.add_flow(name, cfg.weight)
            for s in st.outcomes:
                self._c_outcomes.seed(tenant=name, outcome=s)
            for i in range(st.ladder.n_rungs):
                self._c_rung.seed(tenant=name, rung=str(i))
        return st

    # ---- compat surface for stream drivers --------------------------------

    @property
    def deadline_s(self) -> float:
        """Batch-assembly wait in seconds (simulate_stream drain step)."""
        return self.batch_wait_s

    @property
    def pending_count(self) -> int:
        """Requests admitted but not yet dispatched, over all tenants."""
        return sum(st.admission.depth for st in self._states.values())

    def result(self, req_id: int) -> Optional[ServeResult]:
        """Pop the typed `ServeResult` for a finished request, or None."""
        return self._results.pop(req_id, None)

    def warmup(self) -> float:
        """Build and warm every registered tenant's ladder off the
        serving clock (one identity-permutation dispatch per rung, which
        advances no dispatch sequence); returns wall seconds.  With a
        byte budget, tenants warmed later may page earlier ones out."""
        t0 = time.perf_counter()
        for name in self.registry.tenants():
            self._state(name)
            execs, _ = self.registry.executors(name)
            Qbuf = np.zeros((self.lanes, execs[0].N), np.float32)
            for ex in execs:
                ex.dispatch(Qbuf, np.arange(ex.plan.n_blocks))
        return time.perf_counter() - t0

    # ---- request path -----------------------------------------------------

    def _finish(self, st: _TenantState, rid: int, res: ServeResult,
                t: Optional[float] = None) -> None:
        res.tenant = st.name
        self._results[rid] = res
        st.outcomes[res.status] += 1
        self._c_outcomes.inc(tenant=st.name, outcome=res.status)
        if res.answered:
            st.lat.append(res.latency_s)
            self._lat.append(res.latency_s)
            self._h_latency.observe(res.latency_s * 1e3, tenant=st.name,
                                    outcome=res.status)
            if len(self._lat) > 100_000:
                self._lat = self._lat[-10_000:]
            if len(st.lat) > 100_000:
                st.lat = st.lat[-10_000:]
        if self.tracer is not None and t is not None:
            self.tracer.request_end(
                rid, t, res.status,
                **({"reason": res.reason} if res.reason else {}))
        if self.flight is not None and res.status == "failed":
            self.flight.record("request_failed", t, rid=rid,
                               tenant=st.name, reason=res.reason)

    def submit(self, q, *, tenant: str, now: Optional[float] = None,
               cls: Optional[str] = None) -> int:
        """Accept one query for a tenant; always returns a request id.

        The tenant must be registered (`TenancyError` otherwise — a
        routing bug, not traffic).  The query itself never raises: it
        runs the tenant's private admission pipeline (poison validation
        -> quarantine -> version-salted cache -> bounded queue) exactly
        like a dedicated `ServeRuntime.submit`.
        """
        now = time.perf_counter() if now is None else now
        st = self._state(tenant)
        rid = self._next_id
        self._next_id += 1
        pcls = st.admission.resolve_class(cls)
        st.requests += 1
        self._c_requests.inc(tenant=tenant, priority_class=pcls.name)
        if self.tracer is not None:
            self.tracer.request_begin(rid, now, tenant=tenant,
                                      priority_class=pcls.name)
        self.apply_updates(tenant, now)
        arr, reason = st.admission.validate(q)
        if arr is None:
            st.admission.count_poison()
            if self.tracer is not None:
                self.tracer.instant(rid, "rejected", now, reason=reason)
            if self.flight is not None:
                self.flight.record("rejected_poison", now, rid=rid,
                                   tenant=tenant, reason=reason)
            self._finish(st, rid, ServeResult(status="rejected",
                                              reason=reason), t=now)
            return rid
        ck = st.cache.key(arr) if st.cache.capacity > 0 else None
        if ck is not None:
            hit = st.cache.get(st.salted(ck))
            if hit is not None:
                ids, scores = hit
                self._c_cache_hits.inc(tenant=tenant)
                if self.tracer is not None:
                    self.tracer.instant(rid, "cache_hit", now)
                self._finish(st, rid, ServeResult(
                    status="ok", ids=ids, scores=scores,
                    eps_served=st.config.eps, delta_served=st.config.delta,
                    cached=True), t=now)
                return rid
        ticket = Ticket(rid, arr, pcls, now, now + pcls.deadline_s, ck,
                        st.admission.fingerprint(arr))
        verdict, displaced = st.admission.admit(ticket)
        for victim, vres in displaced:
            vres.latency_s = now - victim.t_submit
            if self.tracer is not None:
                self.tracer.instant(victim.req_id, "displaced", now, by=rid)
            if self.flight is not None:
                self.flight.record("displacement", now, rid=victim.req_id,
                                   by=rid, tenant=tenant)
            self._finish(st, victim.req_id, vres, t=now)
        if verdict is not None:
            if self.tracer is not None:
                self.tracer.instant(rid, verdict.status, now,
                                    reason=verdict.reason or "")
            if self.flight is not None:
                self.flight.record("refused", now, rid=rid, tenant=tenant,
                                   status=verdict.status,
                                   reason=verdict.reason)
            self._finish(st, rid, verdict, t=now)
        else:
            if self.tracer is not None:
                self.tracer.instant(rid, "admitted", now,
                                    depth=st.admission.depth)
            if self.flight is not None:
                self.flight.record("admitted", now, rid=rid, tenant=tenant,
                                   depth=st.admission.depth)
        return rid

    # ---- updates ----------------------------------------------------------

    def apply_updates(self, tenant: str,
                      now: Optional[float] = None) -> int:
        """Drain one tenant's staged store mutations fault-tolerantly.

        Same contract as `ServeRuntime.apply_updates` (flush failures
        counted and retried, a version bump invalidates the tenant's
        cache); executor recalibration is the registry's job (the salted
        cache key + `sync_store` on acquire).  No-op while the tenant's
        table is paged out — staged mutations stay on the store's host
        side and flush after page-in.
        """
        store = self.registry.store(tenant)
        if store is None:
            return 0
        st = self._state(tenant)
        if self.injector is not None and store.fault_hook is None:
            self.injector.attach(store)
        applied = 0
        if store.pending_updates:
            try:
                info = store.flush_updates()
                applied = info["applied"]
                self._c_update_rows.inc(applied, tenant=tenant)
            except StoreFlushError as e:
                self._c_flush_failures.inc(tenant=tenant)
                if self.flight is not None:
                    self.flight.record("store_flush_error", now,
                                       tenant=tenant, error=str(e),
                                       pending=store.pending_updates)
                    self.flight.dump("store_flush_error", now)
            except Exception as e:
                self._c_update_errors.inc(tenant=tenant)
                if self.flight is not None:
                    self.flight.record("store_update_error", now,
                                       tenant=tenant, error=str(e))
        if store.version != st.version:
            st.version = store.version
            st.cache.invalidate()
        refreshes = getattr(store, "codebook_refreshes", 0)
        if refreshes != st.seen_refreshes:
            st.seen_refreshes = refreshes
            if self.flight is not None:
                self.flight.record("codebook_refresh", now, tenant=tenant,
                                   refreshes=refreshes,
                                   version=store.version)
        return applied

    # ---- scheduler --------------------------------------------------------

    def poll(self, now: Optional[float] = None) -> Tuple[List[int], float]:
        """Run one deficit-round-robin scheduling pass over all tenants.

        Per tenant, the `ServeRuntime` dispatch triggers apply (full
        batch queued, oldest request aged past ``batch_wait_ms``, or the
        executor already ran this poll); across tenants, DRR meters how
        many requests each backlogged tenant may dispatch per round, so
        arrival skew cannot become service skew.  Returns ``(finished
        request ids, virtual busy seconds)``.
        """
        now = time.perf_counter() if now is None else now
        for name in self.registry.tenants():
            self.apply_updates(name, now)
        done: List[int] = []
        busy = 0.0
        progress = True
        while progress:
            progress = False
            backlogged = {name: st.admission.depth > 0
                          for name, st in self._states.items()}
            if not any(backlogged.values()):
                break
            self.drr.start_round(backlogged)
            for name in self.drr.flows():
                st = self._states.get(name)
                if st is None:
                    continue
                while st.admission.depth:
                    t = now + busy
                    oldest = st.admission.oldest_submit()
                    full = st.admission.depth >= self.lanes
                    aged = (oldest is not None
                            and t - oldest >= self.batch_wait_s)
                    if not (full or aged or busy > 0.0):
                        break
                    allow = self.drr.allowance(name)
                    if allow < 1:
                        break
                    batch, expired = st.admission.take(
                        t, min(self.lanes, allow))
                    for tk, res in expired:
                        if self.flight is not None:
                            self.flight.record("deadline_expired", t,
                                               rid=tk.req_id, tenant=name)
                        self._finish(st, tk.req_id, res, t=t)
                        done.append(tk.req_id)
                    if not batch:
                        if not expired:
                            break
                        continue
                    self.drr.consume(name, len(batch))
                    served, dt = self._dispatch(st, batch, t)
                    done.extend(served)
                    busy += dt
                    progress = True
                if st.admission.depth == 0:
                    self.drr.reset(name)
            self.drr.rotate()
        return done, busy

    def drain(self, now: Optional[float] = None) -> Tuple[List[int], float]:
        """Serve everything queued, tenant by tenant, ignoring triggers
        and deadlines (shutdown semantics, like `ServeRuntime.drain`).

        Each tenant drains in (priority, FIFO) order — its batch
        compositions and dispatch sequence are a dedicated runtime's.
        """
        now = time.perf_counter() if now is None else now
        done: List[int] = []
        busy = 0.0
        for name in self.registry.tenants():
            self.apply_updates(name, now)
            st = self._states.get(name)
            if st is None:
                continue
            while st.admission.depth:
                batch, _ = st.admission.take(now + busy, self.lanes,
                                             expire=False)
                if not batch:
                    break
                served, dt = self._dispatch(st, batch, now + busy)
                done.extend(served)
                busy += dt
        return done, busy

    # ---- dispatch ---------------------------------------------------------

    def _fail_batch(self, st: _TenantState, batch: List[Ticket], t: float,
                    exc: Exception, retries: int,
                    backoff: float) -> List[int]:
        self._c_failed_batches.inc(tenant=st.name)
        reason = f"dispatch failed after {retries} retries: {exc}"
        for tk in batch:
            st.admission.add_quarantine(tk.fingerprint, "dispatch failure")
            if self.flight is not None:
                self.flight.record("quarantine_add", t + backoff,
                                   rid=tk.req_id, tenant=st.name,
                                   fingerprint=repr(tk.fingerprint))
            self._finish(st, tk.req_id, ServeResult(
                status="failed", reason=reason,
                latency_s=(t + backoff) - tk.t_submit, retries=retries),
                t=t + backoff)
        if self.flight is not None:
            self.flight.dump("request_failed", t + backoff)
        return [tk.req_id for tk in batch]

    def _dispatch(self, st: _TenantState, batch: List[Ticket],
                  t: float) -> Tuple[List[int], float]:
        name = st.name
        load = ((st.admission.depth + len(batch))
                / st.admission.queue_capacity)
        urgency = 0.0
        for tk in batch:
            budget = tk.t_deadline - tk.t_submit
            if np.isfinite(budget) and budget > 0:
                urgency = max(urgency, (t - tk.t_submit) / budget)
        rung = st.ladder.rung(max(load, urgency))
        with self.registry.serving(name):
            try:
                execs, page_s = self.registry.executors(name)
            except TenancyError as e:
                # residency refusal (the table grew past what the budget
                # can rebalance): typed failed results, no quarantine —
                # the queries were fine, the table was not
                self._c_failed_batches.inc(tenant=name)
                if self.flight is not None:
                    self.flight.record("table_unavailable", t,
                                       tenant=name, error=str(e))
                for tk in batch:
                    self._finish(st, tk.req_id, ServeResult(
                        status="failed",
                        reason=f"table unavailable: {e}",
                        latency_s=t - tk.t_submit), t=t)
                return [tk.req_id for tk in batch], 0.0
            ex = execs[rung]
            Qbuf = np.zeros((self.lanes, ex.N), np.float32)
            for i, tk in enumerate(batch):
                Qbuf[i] = tk.q
            # the tenant's own dispatch sequence, exactly as a dedicated
            # runtime draws it
            didx = st.dispatch_seq
            perm = self._perm_source(name, didx, ex.plan.n_blocks)
            st.dispatch_seq += 1
            self._c_dispatches.inc(
                tenant=name,
                filled="full" if len(batch) == self.lanes else "partial")

            def on_error(e, attempt, injected):
                self._c_dispatch_errors.inc(tenant=name)
                if self.flight is not None:
                    self.flight.record(
                        "fault_dispatch_error", t, tenant=name, didx=didx,
                        attempt=attempt, injected=injected, error=str(e))

            def on_retry(attempt, backoff):
                self._c_retries.inc(tenant=name)
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
                return (self._fail_batch(st, batch, t, df.cause,
                                         df.retries, df.backoff),
                        page_s + df.backoff)
        if spike > 0.0 and self.flight is not None:
            self.flight.record("fault_latency", t, tenant=name, didx=didx,
                               spike_ms=spike * 1e3)
        # page-in is real serving cost: charge it to this dispatch's
        # virtual busy time so eviction thrash is visible in latency
        dt += page_s
        if (self.dispatch_timeout_s is not None
                and dt > self.dispatch_timeout_s):
            self._c_slow.inc(tenant=name)
        ids = ids[:len(batch)]
        scores = scores[:len(batch)]
        self._occupancy.append(len(batch))
        self._h_occupancy.observe(len(batch), tenant=name)
        lane = dispatch_lane_stats(
            None if rounds is None else rounds[:len(batch)],
            schedule=ex.plan.schedule, lanes=self.lanes,
            filled=len(batch))
        self._pull_fracs.append(lane["executed_pull_frac"])
        self._h_pull_frac.observe(lane["executed_pull_frac"], tenant=name)
        eps_r = st.ladder.eps_values[rung]
        self._c_rung.inc(len(batch), tenant=name, rung=str(rung))
        if self.tracer is not None:
            args = {"tenant": name, "didx": didx, "rung": rung,
                    "eps_served": eps_r, "occupancy": len(batch),
                    "retries": attempt,
                    "pull_frac": lane["executed_pull_frac"]}
            if page_s > 0.0:
                args["page_in_ms"] = page_s * 1e3
            self.tracer.global_span(f"dispatch {name}/{didx}", t, t + dt,
                                    **args)
        done = []
        for i, tk in enumerate(batch):
            out_ids = ex.external_ids(ids[i])
            self._h_queue_wait.observe((t - tk.t_submit) * 1e3,
                                       tenant=name)
            if self.tracer is not None:
                self.tracer.span(tk.req_id, "queued", tk.t_submit, t,
                                 didx=didx)
                self.tracer.span(tk.req_id, "serve", t, t + dt,
                                 rung=rung, eps_served=eps_r,
                                 retries=attempt, didx=didx)
            res = ServeResult(
                status="ok" if rung == 0 else "degraded",
                ids=out_ids, scores=scores[i].copy(),
                eps_served=eps_r, delta_served=st.config.delta,
                latency_s=(t + dt) - tk.t_submit, retries=attempt)
            self._finish(st, tk.req_id, res, t=t + dt)
            if rung == 0 and tk.cache_key is not None:
                st.cache.put(st.salted(tk.cache_key),
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

    # ---- observability ----------------------------------------------------

    def stats(self) -> dict:
        """Aggregate + per-tenant telemetry.

        The top level keeps the dedicated runtime's shape (``requests`` /
        ``completed`` / ``pending`` / ``outcomes`` / ``latency_ms`` /
        ``lanes`` / ``faults`` / ``recall``) aggregated over tenants, so
        stream drivers and outcome gates work unchanged; ``tenants`` maps
        each tenant to its requests / outcomes / latency / queue / store
        breakdown and ``registry`` carries residency, eviction and
        executor-cache telemetry.  Keys and order are the JAX package's.
        """
        occ = np.asarray(self._occupancy, np.float64)
        states = self._states
        requests = sum(st.requests for st in states.values())
        outcomes = {s: sum(st.outcomes[s] for st in states.values())
                    for s in ("ok", "degraded", "rejected", "overloaded",
                              "failed")}
        pending = self.pending_count
        answered = outcomes["ok"] + outcomes["degraded"]
        registry = self.registry.stats()
        per_tenant = {}
        for name, st in states.items():
            store = self.registry.store(name)
            per_tenant[name] = {
                "requests": st.requests,
                "outcomes": dict(st.outcomes),
                "latency_ms": summarize_latencies(st.lat),
                "queue": st.admission.stats(),
                "weight": st.config.weight,
                "eps": st.config.eps,
                "precision": st.config.precision,
                "cache": {"hits": st.cache.hits,
                          "misses": st.cache.misses,
                          "entries": len(st.cache)},
                "placement": registry["tenants"].get(name, {}),
            }
            if store is not None:
                per_tenant[name]["store"] = store.stats()
        out = {
            "requests": requests,
            "completed": requests - pending,
            "pending": pending,
            "answered": answered,
            "availability": answered / max(1, requests),
            "dispatches": int(self._c_dispatches.total()),
            "outcomes": outcomes,
            "latency_ms": summarize_latencies(self._lat),
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
                "retries": int(self._c_retries.total()),
                "dispatch_errors": int(self._c_dispatch_errors.total()),
                "failed_batches": int(self._c_failed_batches.total()),
                "slow_dispatches": int(self._c_slow.total()),
                "store_flush_failures": int(
                    self._c_flush_failures.total()),
                "update_errors": int(self._c_update_errors.total()),
            },
            "recall": {"samples": len(self._recalls),
                       "mean": (float(np.mean(self._recalls))
                                if self._recalls else float("nan"))},
            "tenants": per_tenant,
            "registry": registry,
        }
        if self.injector is not None:
            out["faults"]["injected"] = self.injector.stats()
        return out
