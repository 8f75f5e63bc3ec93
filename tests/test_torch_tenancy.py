"""The port's multi-tenant serving (`repro_torch.launch.tenancy`) against
the JAX package's, mirroring ``tests/test_tenancy.py`` class by class.

Harness: both packages' `CascadeExecutor.dispatch` report a fixed ``DT``
in place of their measured seconds, and a page-in a fixed ``PAGE_S``
(measured times differ between the packages and would move rungs,
expiry and DRR turns), and the port's runtime takes the reference's own
permutations through ``perm_source``: tenant ``t``'s dispatch ``didx``
runs under ``jax.random.permutation(fold_in(PRNGKey(seed_t), didx),
n_blocks)``.  The JAX package runs as its own tests run it on the CPU
(the jnp fallback).  Held equal under that harness: every request's
status, reason, tenant, eps / delta served, latency, retries, cache flag
and ids; ``stats()`` with its key order (a store paged in by the JAX
registry restarts its churn counters, the port's keeps them: those
counters are compared only for tables never evicted); the metrics
registry but its measured histograms; the span tracer's export; the
flight recorder's events but their measured seconds.  Executor rebuilds
are compared per tenant in sum, not by cause: the JAX registry salts its
cache with ``id(store)``, and a store rebuilt at a freed store's address
(CPython reuses ids) reads there as ``cache_evicted`` where it was a
page-in; the port salts with a residency generation, and its causes are
held on their own (every page-in rebuilds once, as ``page_in``).

Scores: served scores are the exact fp32 rescore of the final candidates
on every tier, summed in another order by each package — rtol 1e-5, atol
1e-6 * max|score|, as ``tests/test_torch_runtime.py`` states; between the
port's multi-tenant runtime and a dedicated port `ServeRuntime` (same
config, seed and batches) ids and scores are bitwise.

Residency: the port evicts by freeing a store's device buffers and
pages in by laying its host mirror out again (`DynamicTableStore.
page_out` / `page_in`); the buffers after a round trip are bytewise the
buffers before it, and a JAX ``page_state`` image loads into the port's
registry through `store_from_jax`.  ``resident_bytes`` of both packages
are held equal side by side, in the JAX package's unit, whether or not
the feature axis fills whole blocks: the port's zero-padded columns, and
the codes a quantized sharded store caches, count in ``device_bytes``
only.  ``register(..., mesh=)`` builds a pinned sharded tenant, as in
the JAX package: held on a mesh of CPU devices, and beside two paging
tenants against the JAX registry, whose sharded store's device write is
stubbed as in ``tests/test_torch_sharded_store.py``.
"""

import json
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import repro.store.sharded_table as jax_sharded
from repro.launch.admission import DeficitRoundRobin as JaxDRR
from repro.launch.engine import CascadeExecutor as JaxExecutor
from repro.launch.faults import FaultInjector as JaxInjector
from repro.launch.tenancy import MultiTenantRuntime as JaxMT
from repro.launch.tenancy import TableRegistry as JaxRegistry
from repro.launch.tenancy import TenancyError as JaxTenancyError
from repro.launch.tenancy import TenantConfig as JaxConfig
from repro.obs import FlightRecorder as JaxFlight
from repro.obs import SpanTracer as JaxTracer
from repro.store import DynamicTableStore as JaxStore
from repro_torch.convert import store_from_jax
from repro_torch.launch.admission import DeficitRoundRobin, PriorityClass
from repro_torch.launch.engine import CascadeExecutor, ServeRuntime
from repro_torch.launch.faults import FaultInjector
from repro_torch.launch.tenancy import (MultiTenantRuntime, TableRegistry,
                                        TenancyError, TenantConfig)
from repro_torch.obs import FlightRecorder, SpanTracer
from repro_torch.distributed.sharding import Mesh
from repro_torch.store import DynamicTableStore, ShardedTableStore
from test_torch_runtime import _keys, _same

DIM = 96
LANES = 4
DT = 6e-4           # the fixed dispatch seconds of both packages
PAGE_S = 3e-3       # the fixed page-in seconds of both packages
TIERS = ["fp32", "int8", "int4", "pq"]


def _table(rows, seed, scale=1.0, dim=DIM):
    rng = np.random.default_rng(seed)
    return (scale * rng.normal(size=(rows, dim)) / np.sqrt(dim)
            ).astype(np.float32)


def _lru_script(seed, dim=DIM, block=512, precision="fp32"):
    """Drive both registries through one seeded script of registrations,
    serves, pins, unpins and evictions under a budget of about three
    tables; their decisions, residency and stats must agree."""
    rng = np.random.default_rng(seed)
    sizes = {n: int(rng.integers(40, 120)) for n in "abcdef"}
    kw = dict(K=1, eps=2.0, block=block, precision=precision)
    one = DynamicTableStore(_table(64, 0, dim=dim), block=block,
                            precision=precision,
                            device="cpu").resident_bytes()
    budget = int(3.1 * one)
    jreg = JaxRegistry(byte_budget=budget, lanes=LANES,
                       warm_on_build=False)
    treg = TableRegistry(byte_budget=budget, lanes=LANES,
                         warm_on_build=False, device="cpu")
    log = {"jax": [], "port": []}
    for name in "abcdef":
        table = _table(sizes[name], ord(name), dim=dim)
        outs = []
        for reg, err in ((jreg, JaxTenancyError),
                         (treg, TenancyError)):
            try:
                reg.register(name, table,
                             (JaxConfig if reg is jreg
                              else TenantConfig)(**kw))
                outs.append("ok")
            except err:
                outs.append("refused")
        assert outs[0] == outs[1]
    for step in range(40):
        name = "abcdef"[int(rng.integers(0, 6))]
        op = rng.random()
        for reg, key, err in ((jreg, "jax", JaxTenancyError),
                              (treg, "port", TenancyError)):
            if name not in reg.tenants():
                continue
            try:
                if op < 0.7:
                    reg.executors(name)
                elif op < 0.8:
                    reg.pin(name)
                elif op < 0.9:
                    reg.unpin(name)
                else:
                    reg.evict(name)
                res = "ok"
            except err:
                res = "refused"
            assert reg.resident_bytes() <= budget
            log[key].append((step, res, [reg.is_resident(n)
                                         for n in reg.tenants()]))
    assert log["port"] == log["jax"]
    for key in ("evictions", "page_ins", "resident_bytes", "tables",
                "tables_resident"):
        assert treg.stats()[key] == jreg.stats()[key], key


def _queries(n, seed):
    rng = np.random.default_rng(1000 + seed)
    return rng.normal(size=(n, DIM)).astype(np.float32)


def _jax_perm_of(configs):
    def perm(tenant, didx, n_blocks):
        key = jax.random.fold_in(
            jax.random.PRNGKey(configs[tenant].seed), didx)
        return np.array(jax.random.permutation(key, n_blocks))
    return perm


@pytest.fixture
def fixed_clock(monkeypatch):
    """Both packages' dispatches report ``DT``, page-ins ``PAGE_S``."""
    for cls in (JaxExecutor, CascadeExecutor):
        def dispatch(self, Qbuf, key, real=cls.dispatch):
            ids, scores, rounds, _ = real(self, Qbuf, key)
            return ids, scores, rounds, DT
        monkeypatch.setattr(cls, "dispatch", dispatch)
    for cls in (JaxRegistry, TableRegistry):
        def ensure_resident(self, name, real=cls.ensure_resident):
            return PAGE_S if real(self, name) > 0.0 else 0.0
        monkeypatch.setattr(cls, "ensure_resident", ensure_resident)


def _pair(tables, configs, *, budget=None, faults=None, **kw):
    """The reference and the port multi-tenant runtime over the same
    tenants (registered in this order), each with a tracer and a flight
    recorder; the port takes the reference's permutations."""
    jreg = JaxRegistry(byte_budget=budget, lanes=LANES,
                       flight=JaxFlight(capacity=512))
    treg = TableRegistry(byte_budget=budget, lanes=LANES,
                         flight=FlightRecorder(capacity=512), device="cpu")
    for name, cfg in configs.items():
        jreg.register(name, tables[name], JaxConfig(**cfg))
        treg.register(name, tables[name], TenantConfig(**cfg))
    jmt = JaxMT(jreg, batch_wait_ms=1.0,
                fault_injector=None if faults is None
                else JaxInjector(7, **faults),
                tracer=JaxTracer(max_requests=256, seed=0), **kw)
    tcfg = {n: TenantConfig(**c) for n, c in configs.items()}
    tmt = MultiTenantRuntime(
        treg, batch_wait_ms=1.0,
        fault_injector=None if faults is None else FaultInjector(7, **faults),
        tracer=SpanTracer(max_requests=256, seed=0),
        perm_source=_jax_perm_of(tcfg), **kw)
    return jmt, tmt


def _unmeasured(events):
    """Flight events without their measured seconds and rebuild causes."""
    out = []
    for e in events:
        e = dict(e)
        for k in ("seconds", "warm_ms", "cause"):
            e.pop(k, None)
        out.append(e)
    return out


def _builds_in_sum(stats):
    for tenants in (stats["registry"]["tenants"],
                    *(t["placement"] for t in stats["tenants"].values())):
        for place in (tenants.values() if "resident" not in tenants
                      else [tenants]):
            if isinstance(place["executor_builds"], dict):
                place["executor_builds"] = sum(
                    place["executor_builds"].values())
    return stats


def _per_tenant(metric):
    out = {}
    for row in metric["values"]:
        t = row["labels"]["tenant"]
        out[t] = out.get(t, 0.0) + row["value"]
    return out


def _strip_store_counters(stats, paged):
    for name in paged:
        st = stats["tenants"].get(name, {}).get("store")
        if st is not None:
            for k in ("upserts", "deletes", "rows_written",
                      "tiles_requantized", "codebook_refreshes",
                      "flush_failures"):
                st.pop(k)
    return stats


def _hold(jmt, tmt, n):
    """Every result, stats(), metrics, trace and flight events equal."""
    statuses = set()
    for rid in range(n):
        j, t = jmt.result(rid), tmt.result(rid)
        assert j is not None and t is not None, rid
        assert (t.status, t.reason, t.tenant, t.eps_served, t.delta_served,
                t.latency_s, t.retries, t.cached) == (
            j.status, j.reason, j.tenant, j.eps_served, j.delta_served,
            j.latency_s, j.retries, j.cached), rid
        statuses.add(t.status)
        if j.answered:
            np.testing.assert_array_equal(t.ids, np.asarray(j.ids))
            np.testing.assert_allclose(
                t.scores, j.scores, rtol=1e-5,
                atol=1e-6 * float(np.abs(j.scores).max()))
    paged = [name for name in tmt.registry.tenants()
             if tmt.registry.stats()["tenants"][name]["executor_builds"]
             .get("page_in")]
    for name in tmt.registry.tenants():     # the port's causes, on their own
        # every page-in rebuilds, as "page_in" — but one that precedes the
        # tenant's first ladder, which is "new"
        builds = tmt.registry.executor_builds(name)
        page_ins = int(tmt.registry._c_page_ins.get(tenant=name))
        assert builds.get("page_in", 0) in (page_ins, page_ins - 1), \
            (name, builds, page_ins)
        assert "cache_evicted" not in builds, (name, builds)
    js = _builds_in_sum(_strip_store_counters(jmt.stats(), paged))
    ts = _builds_in_sum(_strip_store_counters(tmt.stats(), paged))
    assert _keys(ts) == _keys(js)
    assert _same(ts, js)
    jm, tm = jmt.metrics.snapshot(), tmt.metrics.snapshot()
    assert [m["name"] for m in tm["metrics"]] == \
        [m["name"] for m in jm["metrics"]]
    for a, b in zip(tm["metrics"], jm["metrics"]):
        if a["name"] == "tenancy_executor_builds_total":
            assert _per_tenant(a) == _per_tenant(b)
        elif a["name"] not in ("cascade_dispatch_ms", "tenancy_page_in_ms",
                               "tenancy_warm_ms"):     # measured seconds
            assert a == b, a["name"]
    assert json.dumps(tmt.tracer.export()) == json.dumps(jmt.tracer.export())
    assert _unmeasured(tmt.flight.events()) == \
        _unmeasured(jmt.flight.events())
    return statuses, ts


def _dedicated(table, cfg: TenantConfig, queries, *, batch_wait_ms=1.0):
    """A dedicated port runtime over a store of the same rows, serving
    the same contract with the same seed."""
    rt = ServeRuntime(
        DynamicTableStore(table, tile=cfg.tile, block=cfg.block,
                          precision=cfg.precision, pq_subdims=cfg.pq_subdims,
                          pq_codes=cfg.pq_codes, device="cpu"),
        K=cfg.K, eps=cfg.eps, delta=cfg.delta, eps_floor=cfg.eps_floor,
        degrade_rungs=cfg.degrade_rungs, degrade_start=cfg.degrade_start,
        lanes=LANES, batch_wait_ms=batch_wait_ms,
        queue_capacity=cfg.queue_capacity,
        classes={"default": PriorityClass("default", priority=cfg.priority,
                                          deadline_ms=cfg.deadline_ms)},
        pull_mode=cfg.pull_mode, cache_entries=cfg.cache_entries,
        cache_resolution=cfg.cache_resolution, seed=cfg.seed, device="cpu")
    rt.warmup()
    rids = [rt.submit(q, now=float(i) * 0.01)
            for i, q in enumerate(queries)]
    rt.drain(now=10.0)
    return [rt.result(r) for r in rids]


def _buffers(store):
    bufs = {"tiled": store.tiled_table().clone()}
    if store.quantized() is not None:
        bufs.update(zip(("codes", "aux"),
                        (t.clone() for t in store.quantized())))
    return bufs


# ---- bit identity ---------------------------------------------------------


class TestBitIdentity:
    @pytest.mark.parametrize("precision", TIERS)
    def test_answers_match_dedicated_runtimes(self, precision):
        """Two tenants (fp32 and ``precision``) through one port
        MultiTenantRuntime == two dedicated port ServeRuntimes, bitwise."""
        cfg_a = TenantConfig(K=3, eps=1.2, delta=0.2, deadline_ms=0.0,
                             seed=11)
        cfg_b = TenantConfig(K=2, eps=2.0, delta=0.2, precision=precision,
                             deadline_ms=0.0, seed=22,
                             quant_err=0.05 if precision == "pq" else None)
        TA, TB = _table(96, 0), _table(80, 1)
        QA, QB = _queries(10, 0), _queries(10, 1)
        ref = {"a": _dedicated(TA, cfg_a, QA), "b": _dedicated(TB, cfg_b, QB)}
        reg = TableRegistry(lanes=LANES, device="cpu")
        reg.register("a", TA, cfg_a)
        reg.register("b", TB, cfg_b)
        mt = MultiTenantRuntime(reg, batch_wait_ms=1.0)
        mt.warmup()
        rids = []
        for i in range(10):
            rids.append((mt.submit(QA[i], tenant="a", now=i * 0.01),
                         ref["a"][i], "a"))
            rids.append((mt.submit(QB[i], tenant="b", now=i * 0.01),
                         ref["b"][i], "b"))
        mt.drain(now=10.0)
        for rid, want, name in rids:
            got = mt.result(rid)
            assert got.tenant == name and got.status == want.status
            np.testing.assert_array_equal(got.ids, want.ids)
            np.testing.assert_array_equal(got.scores, want.scores)

    @pytest.mark.parametrize("precision", ["fp32", "int8", "int4"])
    def test_answers_match_jax_runtime(self, precision, fixed_clock):
        """The same two tenants through both packages' multi-tenant
        runtimes, with the reference's permutations."""
        configs = {"a": dict(K=3, eps=1.2, delta=0.2, deadline_ms=0.0,
                             seed=11),
                   "b": dict(K=2, eps=2.0, delta=0.2, precision=precision,
                             deadline_ms=0.0, seed=22)}
        tables = {"a": _table(96, 0), "b": _table(80, 1)}
        jmt, tmt = _pair(tables, configs)
        QA, QB = _queries(10, 0), _queries(10, 1)
        for mt in (jmt, tmt):
            mt.warmup()
            for i in range(10):
                mt.submit(QA[i], tenant="a", now=i * 0.01)
                mt.submit(QB[i], tenant="b", now=i * 0.01)
            mt.drain(now=10.0)
        statuses, st = _hold(jmt, tmt, 20)
        assert statuses == {"ok"} and st["dispatches"] == 6

    def test_cache_hits_are_tenant_private(self):
        """The same query to two tenants must not cross-serve from the
        other tenant's LRU."""
        cfg = TenantConfig(K=2, eps=1.5, delta=0.2, deadline_ms=0.0)
        reg = TableRegistry(lanes=LANES, device="cpu")
        reg.register("a", _table(64, 3), cfg)
        reg.register("b", _table(64, 4), cfg)
        mt = MultiTenantRuntime(reg, batch_wait_ms=1.0)
        mt.warmup()
        q = _queries(1, 9)[0]
        ra1 = mt.submit(q, tenant="a", now=0.0)
        mt.drain(now=1.0)
        first = mt.result(ra1)
        ra2 = mt.submit(q, tenant="a", now=2.0)
        rb = mt.submit(q, tenant="b", now=2.0)
        mt.drain(now=3.0)
        hit, fresh = mt.result(ra2), mt.result(rb)
        assert hit.cached and not fresh.cached
        np.testing.assert_array_equal(hit.ids, first.ids)
        assert not np.array_equal(np.sort(fresh.scores),
                                  np.sort(first.scores))

    def test_default_perms_are_the_dedicated_draw(self):
        """Without ``perm_source`` tenant ``t``'s dispatch ``didx`` runs
        under ``seeded_perm(config.seed, didx, n_blocks)``, and warm-ups
        (registry rebuilds and `warmup`) advance no dispatch sequence."""
        reg = TableRegistry(lanes=LANES, device="cpu")
        reg.register("a", _table(64, 5, dim=128),
                     TenantConfig(K=2, eps=1.5, deadline_ms=0.0, seed=9,
                                  block=32))
        mt = MultiTenantRuntime(reg, batch_wait_ms=1.0)
        mt.warmup()
        mt.warmup()
        seen = []
        for ex in reg.executors("a")[0]:
            real = ex.dispatch

            def rec(Qbuf, perm, real=real):
                seen.append(np.asarray(perm))
                return real(Qbuf, perm)
            ex.dispatch = rec
        rng = np.random.default_rng(3)
        for i in range(9):
            mt.submit(rng.normal(size=128).astype(np.float32), tenant="a",
                      now=0.0)
        mt.drain(now=1.0)
        from repro_torch.launch.engine import seeded_perm
        assert len(seen) == 3
        for didx, perm in enumerate(seen):
            np.testing.assert_array_equal(perm,
                                          seeded_perm(9, didx, 4).numpy())


# ---- flood isolation --------------------------------------------------------


class TestFloodIsolation:
    def _serve_b(self, mt, flood: bool):
        mt.warmup()
        QB = _queries(12, 2)
        flood_q = _queries(1, 3)[0]
        poison = np.full(DIM, np.nan, np.float32)
        b_rids, t = [], 0.0
        for i in range(12):
            if flood:
                for j in range(12):
                    if j < 6:
                        mt.submit(poison, tenant="a", now=t)
                    mt.submit(flood_q + np.float32(i + j), tenant="a",
                              now=t)
            b_rids.append(mt.submit(QB[i], tenant="b", now=t))
            _, busy = mt.poll(now=t + 0.0015)
            t += 0.004 + busy
        mt.drain(now=t + 1.0)
        return b_rids

    CONFIGS = {"a": dict(K=2, eps=1.5, delta=0.2, deadline_ms=5.0,
                         queue_capacity=8, seed=1),
               "b": dict(K=2, eps=1.5, delta=0.2, deadline_ms=0.0, seed=2)}

    def _port(self):
        reg = TableRegistry(lanes=LANES, device="cpu")
        reg.register("a", _table(64, 5), TenantConfig(**self.CONFIGS["a"]))
        reg.register("b", _table(64, 6), TenantConfig(**self.CONFIGS["b"]))
        return MultiTenantRuntime(reg, batch_wait_ms=1.0)

    def test_poison_overload_flood_leaves_b_bit_identical(self,
                                                          fixed_clock):
        quiet_mt, flood_mt = self._port(), self._port()
        quiet = [quiet_mt.result(r) for r in self._serve_b(quiet_mt, False)]
        flooded = [flood_mt.result(r) for r in self._serve_b(flood_mt, True)]
        stats = flood_mt.stats()
        a = stats["tenants"]["a"]["outcomes"]
        assert a["rejected"] > 0 and a["overloaded"] > 0
        for q, f in zip(quiet, flooded):
            assert q.answered and f.answered
            np.testing.assert_array_equal(q.ids, f.ids)
            np.testing.assert_array_equal(q.scores, f.scores)
        b = stats["tenants"]["b"]
        assert b["outcomes"]["ok"] + b["outcomes"]["degraded"] == 12
        assert b["latency_ms"]["p99"] < 250.0

    def test_flood_matches_jax_runtime(self, fixed_clock):
        """The flood run, every request of both tenants, in both
        packages."""
        tables = {"a": _table(64, 5), "b": _table(64, 6)}
        jmt, tmt = _pair(tables, self.CONFIGS)
        for mt in (jmt, tmt):
            self._serve_b(mt, True)
        statuses, st = _hold(jmt, tmt, tmt._next_id)
        assert {"ok", "rejected", "overloaded"} <= statuses
        assert st["tenants"]["a"]["queue"]["rejected_poison"] == 72


# ---- residency --------------------------------------------------------------


def _mutated_store(precision, device="cpu"):
    rows = _table(64, 7)
    store = DynamicTableStore(rows, precision=precision, pq_subdims=8,
                              block=32, device=device)
    store.upsert(3, rows[5])
    store.flush_updates()
    if precision == "pq":
        store.refresh_codebook()
    store.append(rows[0] * 0.5)          # staged, not flushed: must
    store.upsert(7, rows[9])             # survive the page round trip
    return store


class TestResidency:
    @pytest.mark.parametrize("precision", TIERS)
    def test_eviction_pagein_roundtrip_bytewise(self, precision):
        """Evict + page-in frees every device buffer and brings back the
        tiled table and shadow bytewise, with rows, ids, version,
        codebook and staged mutations; answers before == after."""
        store = _mutated_store(precision)
        cfg = TenantConfig(K=2, eps=2.0, delta=0.2, precision=precision,
                           deadline_ms=0.0, block=32,
                           quant_err=0.05 if precision == "pq" else None)
        reg = TableRegistry(lanes=LANES, device="cpu")
        reg.register("t", store, cfg)
        execs, _ = reg.executors("t")
        Qb = np.zeros((LANES, DIM), np.float32)
        Qb[0] = _queries(1, 4)[0]
        perm = np.arange(execs[0].plan.n_blocks)[::-1].copy()
        ids0, sc0, _, _ = execs[0].dispatch(Qb, perm)
        nbytes = store.resident_bytes()
        before = dict(bufs=_buffers(store), version=store.version,
                      staged=list(store._staged), snap=store.snapshot(),
                      host=store.host_table().copy(), vmax=store.value_abs_max)
        reg.evict("t")
        assert not reg.is_resident("t") and reg.store("t") is None
        assert store.resident_bytes() == 0 and store.tiled_table() is None
        assert reg.resident_bytes() == 0 and reg.table_bytes("t") == nbytes
        assert reg.executor_cache_size() == 0
        assert reg.ensure_resident("t") > 0.0
        assert reg.store("t") is store and store.resident_bytes() == nbytes
        for name, buf in _buffers(store).items():
            assert torch.equal(buf, before["bufs"][name]), name
        assert store.version == before["version"]
        assert store._staged == before["staged"]
        assert store.value_abs_max == before["vmax"]
        np.testing.assert_array_equal(store.host_table(), before["host"])
        for a, b in zip(store.snapshot(), before["snap"]):
            np.testing.assert_array_equal(a, b)
        execs2, _ = reg.executors("t")
        assert execs2[0] is not execs[0]
        ids1, sc1, _, _ = execs2[0].dispatch(Qb, perm)
        np.testing.assert_array_equal(ids0, ids1)
        np.testing.assert_array_equal(sc0, sc1)
        assert reg.executor_builds("t") == {"new": 1, "page_in": 1}
        store.flush_updates()                # staged ops flush after it
        assert store.pending_updates == 0

    def test_paged_out_store_refuses_device_work(self):
        store = _mutated_store("int8")
        store.page_out()
        store.append(np.ones(DIM, np.float32))     # staging goes on
        for call in (store.flush_updates, lambda: store.grow(256)):
            with pytest.raises(RuntimeError, match="paged out"):
                call()
        assert store.pending_updates == 3
        store.page_in()
        assert store.flush_updates()["applied"] == 3

    @pytest.mark.parametrize("precision", TIERS)
    def test_jax_page_image_loads_into_the_registry(self, precision):
        """A tenant the JAX registry paged out: its ``page_state`` image
        becomes a port store (`store_from_jax`) that the port's registry
        serves, evicts and pages in bytewise, answering as the JAX
        registry's paged-in executors do."""
        rows = _table(64, 8)
        jst = JaxStore(rows, precision=precision, pq_subdims=8, block=32)
        jst.upsert(3, rows[5])
        jst.flush_updates()
        jst.append(rows[0] * 0.5)
        kw = dict(K=2, eps=2.0, delta=0.2, precision=precision,
                  deadline_ms=0.0, block=32,
                  quant_err=0.05 if precision == "pq" else None)
        jreg = JaxRegistry(lanes=LANES)
        jreg.register("t", jst, JaxConfig(**kw))
        jreg.evict("t")
        image = dict(jreg._entry("t").page)
        if image["codebook"] is not None:
            image["codebook"] = np.asarray(image["codebook"])
        treg = TableRegistry(lanes=LANES, device="cpu")
        tst = treg.register("t", store_from_jax(image, device="cpu"),
                            TenantConfig(**kw))
        assert tst.pending_updates == 1 and tst.version == jst.version
        bufs = _buffers(tst)
        treg.evict("t")
        treg.ensure_resident("t")
        for name, buf in _buffers(tst).items():
            assert torch.equal(buf, bufs[name]), name
        Qb = np.zeros((LANES, DIM), np.float32)
        Qb[:2] = _queries(2, 5)
        jex, _ = jreg.executors("t")
        tex, _ = treg.executors("t")
        key = jax.random.PRNGKey(3)
        perm = np.array(jax.random.permutation(key, tex[0].plan.n_blocks))
        jids, jsc, _, _ = jex[0].dispatch(Qb, key)
        tids, tsc, _, _ = tex[0].dispatch(Qb, perm)
        np.testing.assert_array_equal(tids[:2], np.asarray(jids)[:2])
        np.testing.assert_allclose(tsc[:2], np.asarray(jsc)[:2], rtol=1e-5,
                                   atol=1e-6 * float(np.abs(jsc).max()))

    def test_budget_never_exceeded_and_typed_refusal(self):
        one = DynamicTableStore(_table(64, 8), device="cpu").resident_bytes()
        reg = TableRegistry(byte_budget=int(2.4 * one), lanes=LANES,
                            device="cpu")
        reg.register("a", _table(64, 8))
        reg.register("b", _table(64, 9))
        reg.register("c", _table(64, 10))   # must evict, not overrun
        assert reg.resident_bytes() <= reg.byte_budget
        assert [reg.is_resident(n) for n in ("a", "b", "c")] \
            == [False, True, True]
        reg.pin("b")
        with pytest.raises(TenancyError):
            reg.evict("b")
        with reg.serving("c"):
            with pytest.raises(TenancyError):
                reg.evict("c")
            with pytest.raises(TenancyError):
                reg.register("d", _table(64, 11))
        assert reg.tenants() == ["a", "b", "c"]
        assert reg.resident_bytes() <= reg.byte_budget
        with pytest.raises(TenancyError, match="cannot fit even alone"):
            reg.register("huge", _table(4096, 12))
        with pytest.raises(TenancyError, match="unknown tenant"):
            reg.executors("nobody")
        with pytest.raises(TenancyError, match="already registered"):
            reg.register("a", _table(64, 8))

    @pytest.mark.parametrize("seed", [0, 1])
    def test_lru_decisions_match_jax_registry(self, seed):
        """A seeded script of registrations, serves (executors), pins and
        evictions under a budget: both registries page the same tables
        in and out, and resident bytes never pass the budget."""
        _lru_script(seed)

    @pytest.mark.parametrize("precision", ["fp32", "int8"])
    @pytest.mark.parametrize("seed", [0, 1])
    def test_lru_decisions_match_jax_registry_on_padded_blocks(
            self, seed, precision):
        """The same script where ``dim`` is not a whole number of blocks
        (100 over 64): the port's tiled tables hold zero-padded columns,
        which its budget does not charge (the JAX package's unit), so both
        registries evict and page in at the same points."""
        _lru_script(seed, dim=100, block=64, precision=precision)

    @pytest.mark.parametrize("precision", TIERS)
    @pytest.mark.parametrize("dim,block", [(128, 64), (100, 64)])
    def test_resident_bytes_side_by_side(self, precision, dim, block):
        """Both packages' ``resident_bytes`` on the same rows are equal at
        every ``(dim, block)``: the budget's unit is the JAX package's
        ``(capacity_rows, dim)`` f32 table plus the shadow.  Where ``dim``
        is not a whole number of blocks the port's tiled table also holds
        zero-padded columns, ``capacity_rows * (n_blocks * block - dim) *
        4`` bytes, which `device_bytes` counts."""
        rows = _table(192, 3, dim=dim)
        kw = dict(block=block, precision=precision, pq_subdims=8)
        jst = JaxStore(rows, **kw)
        tst = DynamicTableStore(rows, device="cpu", **kw)
        assert tst.resident_bytes() == jst.resident_bytes()
        pad = -(-dim // block) * block - dim
        extra = tst.capacity_rows * pad * 4
        assert tst.device_bytes() == tst.resident_bytes() + extra
        assert (extra == 0) == (dim % block == 0)
        tst.page_out()
        assert tst.resident_bytes() == tst.device_bytes() == 0

    @pytest.mark.parametrize("precision", ["int8", "int4"])
    def test_lru_beside_a_pinned_quantized_sharded_tenant(
            self, precision, monkeypatch):
        """A pinned quantized sharded tenant beside two paging tenants
        under a budget of it plus one table and a fifth: both registries
        evict the same tables in the same order.  The JAX registry's
        sharded store keeps its host bookkeeping, its device write
        stubbed (``tests/test_torch_sharded_store.py``); only the port
        serves the sharded tenant, whose executors cache the shards'
        codes, which its budget does not charge (the JAX unit)."""
        monkeypatch.setattr(jax_sharded, "serving_table_sharding",
                            lambda mesh, axis="model": None)
        monkeypatch.setattr(jax_sharded.ShardedTableStore, "_dev_write",
                            lambda self, row, slot: None)
        one = DynamicTableStore(_table(64, 0), device="cpu").resident_bytes()
        kw = dict(K=2, eps=2.0)
        sharded = _table(64, 1)
        jreg = JaxRegistry(byte_budget=1, lanes=LANES, warm_on_build=False)
        treg = TableRegistry(byte_budget=1, lanes=LANES,
                             warm_on_build=False, device="cpu")
        s_bytes = ShardedTableStore(sharded,
                                    mesh=Mesh(["cpu"] * 2)).resident_bytes()
        for reg in (jreg, treg):
            reg.byte_budget = s_bytes + int(1.2 * one)
        jreg.register("s", sharded, JaxConfig(precision=precision, **kw),
                      mesh=SimpleNamespace(shape={"model": 2}))
        treg.register("s", sharded, TenantConfig(precision=precision, **kw),
                      mesh=Mesh(["cpu"] * 2))
        store = treg.store("s")
        assert treg.table_bytes("s") == jreg.table_bytes("s") == s_bytes
        log = {"jax": [], "port": []}
        script = ["+a", "+b", "s", "a", "b", "a", "s", "a", "b", "b", "a"]
        for op in script:
            for reg, key in ((jreg, "jax"), (treg, "port")):
                if op == "s":
                    if reg is treg:      # the port builds the shards' codes
                        reg.executors("s")
                        assert store.device_bytes() > s_bytes
                    continue
                if op.startswith("+"):
                    reg.register(op[1], _table(64, ord(op[1])),
                                 (JaxConfig if reg is jreg
                                  else TenantConfig)(**kw))
                else:
                    reg.executors(op)
                assert reg.resident_bytes() <= reg.byte_budget
                log[key].append((op, [reg.is_resident(n)
                                      for n in reg.tenants()],
                                 reg.lru_order()))
        assert log["port"] == log["jax"]
        assert treg.table_bytes("s") == jreg.table_bytes("s") == s_bytes
        for key in ("evictions", "page_ins", "resident_bytes", "tables",
                    "tables_resident"):
            assert treg.stats()[key] == jreg.stats()[key], key
        assert treg.stats()["evictions"] == 6

    def test_mesh_registers_a_pinned_sharded_tenant(self):
        """``register(..., mesh=)`` builds a `ShardedTableStore` (formerly
        refused): counted against the budget in the JAX package's unit,
        pinned, never evicted (`evict` raises, `unpin` leaves it pinned,
        as in the JAX package), reported ``sharded``; its executors serve
        over the mesh at the tenant's tier beside a paging tenant."""
        one = DynamicTableStore(_table(64, 0), device="cpu").resident_bytes()
        reg = TableRegistry(byte_budget=int(2.5 * one), lanes=LANES,
                            device="cpu")
        mesh = Mesh(["cpu"] * 2)
        store = reg.register("s", _table(64, 1), TenantConfig(
            K=2, eps=2.0, precision="int8"), mesh=mesh)
        assert isinstance(store, ShardedTableStore) and store.mesh is mesh
        assert reg.table_bytes("s") == store.resident_bytes() \
            == store.capacity_rows * DIM * 4
        assert reg.is_pinned("s") and reg.stats()["tenants"]["s"]["sharded"]
        with pytest.raises(TenancyError, match="sharded"):
            reg.evict("s")
        reg.unpin("s")
        assert reg.is_pinned("s") and reg.is_resident("s")
        reg.register("a", _table(64, 2), TenantConfig(K=2, eps=2.0))
        reg.register("b", _table(64, 3), TenantConfig(K=2, eps=2.0))
        assert reg.is_resident("s") and not reg.is_resident("a")
        assert reg.lru_order() == ["b"]
        execs, page_s = reg.executors("s")
        assert page_s == 0.0 and all(ex.mesh is mesh for ex in execs)
        ids, scores, _, _ = execs[0].dispatch(_queries(LANES, 5),
                                              np.arange(
                                                  execs[0].plan.n_blocks))
        assert ids.shape == (LANES, 2) and (ids < 64 * 2).all()
        assert reg.resident_bytes() <= reg.byte_budget

    @pytest.mark.parametrize("precision", ["fp32", "int8"])
    def test_evicting_stream_matches_jax_runtime(self, precision,
                                                 fixed_clock):
        """Three tenants under a budget of two tables, faults on: the
        stream pages tables out and in, in both packages alike."""
        one = DynamicTableStore(_table(64, 0), device="cpu").resident_bytes()
        configs = {n: dict(K=2, eps=1.5, delta=0.2, deadline_ms=4.0,
                           queue_capacity=6, precision=precision,
                           eps_floor=3.0, seed=30 + i)
                   for i, n in enumerate(("a", "b", "c"))}
        tables = {n: _table(64, 40 + i) for i, n in enumerate("abc")}
        jmt, tmt = _pair(tables, configs, budget=int(2.2 * one),
                         faults=dict(error_rate=0.2, latency_rate=0.1,
                                     latency_ms=2.0))
        rng = np.random.default_rng(4)
        qs = rng.normal(size=(60, DIM)).astype(np.float32)
        who = rng.integers(0, 3, 60)
        for mt in (jmt, tmt):
            mt.warmup()
            t = 0.0
            for i in range(60):
                mt.submit(qs[i], tenant="abc"[who[i]], now=t)
                if i % 3 == 2:
                    _, busy = mt.poll(now=t + 5e-4)
                    t += busy
                t += 3e-4
            mt.drain(now=t + 1.0)
        statuses, st = _hold(jmt, tmt, 60)
        assert st["registry"]["page_ins"] > 0
        assert st["registry"]["evictions"] > 0
        assert st["faults"]["retries"] > 0
        assert {"ok", "degraded"} <= statuses


# ---- fairness ---------------------------------------------------------------


class TestFairness:
    @pytest.mark.parametrize("cls", [JaxDRR, DeficitRoundRobin])
    def test_drr_unit_weighted_shares(self, cls):
        drr = cls(4)
        for n, w in (("a", 1.0), ("b", 1.0), ("c", 2.0)):
            drr.add_flow(n, w)
        served = {n: 0 for n in "abc"}
        backlog = {n: 10_000 for n in "abc"}
        for _ in range(100):
            drr.start_round({n: backlog[n] > 0 for n in "abc"})
            for n in drr.flows():
                while drr.allowance(n) >= 1 and backlog[n] > 0:
                    take = min(4, drr.allowance(n), backlog[n])
                    drr.consume(n, take)
                    served[n] += take
                    backlog[n] -= take
            drr.rotate()
        assert served["a"] == served["b"]
        assert abs(served["c"] / served["a"] - 2.0) < 0.05

    @pytest.mark.parametrize("cls", [JaxDRR, DeficitRoundRobin])
    def test_drr_idle_flow_cannot_hoard_deficit(self, cls):
        drr = cls(4, cap_rounds=2.0)
        drr.add_flow("idle")
        for _ in range(50):
            drr.start_round({"idle": True})
        assert drr.allowance("idle") <= 8
        drr.reset("idle")
        assert drr.allowance("idle") == 0

    def _hot(self, mt):
        mt.warmup()
        rng = np.random.default_rng(42)
        t = 0.0
        for _ in range(15):
            for _ in range(12):
                mt.submit(rng.normal(size=DIM).astype(np.float32),
                          tenant="hot", now=t)
            mt.submit(rng.normal(size=DIM).astype(np.float32),
                      tenant="c1", now=t)
            mt.submit(rng.normal(size=DIM).astype(np.float32),
                      tenant="c2", now=t)
            _, busy = mt.poll(now=t + 0.0015)
            t += 0.004 + busy
        mt.drain(now=t + 1.0)
        return mt.stats()["tenants"]

    CONFIGS = {name: dict(K=2, eps=1.5, delta=0.2, deadline_ms=100.0,
                          queue_capacity=8, seed=seed)
               for name, seed in (("hot", 20), ("c1", 21), ("c2", 22))}

    def test_hot_tenant_throttled_not_starving(self, fixed_clock):
        reg = TableRegistry(lanes=LANES, device="cpu")
        for name, cfg in self.CONFIGS.items():
            reg.register(name, _table(64, cfg["seed"]), TenantConfig(**cfg))
        s = self._hot(MultiTenantRuntime(reg, batch_wait_ms=1.0))

        def answered(n):
            return s[n]["outcomes"]["ok"] + s[n]["outcomes"]["degraded"]

        assert answered("c1") == 15 and answered("c2") == 15
        assert answered("hot") >= 30
        assert s["hot"]["outcomes"]["overloaded"] > 0
        assert s["c1"]["outcomes"]["overloaded"] == 0
        assert s["c2"]["outcomes"]["overloaded"] == 0
        for n in ("hot", "c1", "c2"):
            assert sum(s[n]["outcomes"].values()) == s[n]["requests"]

    def test_hot_tenant_matches_jax_runtime(self, fixed_clock):
        tables = {n: _table(64, c["seed"]) for n, c in self.CONFIGS.items()}
        jmt, tmt = _pair(tables, self.CONFIGS)
        for mt in (jmt, tmt):
            self._hot(mt)
        _hold(jmt, tmt, tmt._next_id)


# ---- executor-cache coherence -----------------------------------------------


class TestExecutorCacheCoherence:
    def _fresh_answer(self, store, cfg, q):
        ex = CascadeExecutor(store, K=cfg.K, eps=cfg.eps, delta=cfg.delta,
                             precision=cfg.precision,
                             pq_subdims=cfg.pq_subdims,
                             pq_codes=cfg.pq_codes, device="cpu")
        Qb = np.zeros((LANES, DIM), np.float32)
        Qb[0] = q
        ids, sc, _, _ = ex.dispatch(Qb, np.arange(ex.plan.n_blocks))
        return ids[0], sc[0]

    def test_refresh_codebook_invalidates(self):
        rows = _table(64, 30)
        store = DynamicTableStore(rows, precision="pq", pq_subdims=8,
                                  device="cpu")
        cfg = TenantConfig(K=2, eps=2.0, delta=0.2, precision="pq",
                           deadline_ms=0.0)
        reg = TableRegistry(lanes=LANES, device="cpu")
        reg.register("t", store, cfg)
        e0 = reg.executors("t")[0][0]
        for i in range(32):
            store.upsert(i, (rows[i] * 3.0).astype(np.float32))
        store.flush_updates()
        store.refresh_codebook()
        execs, _ = reg.executors("t")
        assert execs[0] is not e0, "stale executor served after retrain"
        assert reg.executor_builds("t").get("codebook_refresh") == 1
        q = _queries(1, 31)[0]
        Qb = np.zeros((LANES, DIM), np.float32)
        Qb[0] = q
        got_ids, got_sc, _, _ = execs[0].dispatch(
            Qb, np.arange(execs[0].plan.n_blocks))
        ref_ids, ref_sc = self._fresh_answer(store, cfg, q)
        np.testing.assert_array_equal(got_ids[0], ref_ids)
        np.testing.assert_array_equal(got_sc[0], ref_sc)

    def test_grow_invalidates(self):
        store = DynamicTableStore(_table(64, 32), capacity=72, device="cpu")
        reg = TableRegistry(lanes=LANES, device="cpu")
        reg.register("t", store, TenantConfig(K=2, eps=1.5, delta=0.2,
                                              deadline_ms=0.0))
        e0 = reg.executors("t")[0][0]
        store.grow(256)
        execs, _ = reg.executors("t")
        assert execs[0] is not e0
        assert execs[0].n == store.capacity_rows
        assert reg.executor_builds("t").get("grow") == 1
        assert reg.table_bytes("t") == store.resident_bytes()

    def test_cache_bounded_and_rebuilds_after_lru_eviction(self):
        reg = TableRegistry(lanes=LANES, max_executors=2, device="cpu")
        for name, seed in (("a", 40), ("b", 41), ("c", 42)):
            reg.register(name, _table(48, seed),
                         TenantConfig(K=1, eps=2.0, delta=0.3,
                                      deadline_ms=0.0))
        for name in ("a", "b", "c"):
            reg.executors(name)
            assert reg.executor_cache_size() <= 2
        reg.executors("a")
        assert reg.executor_builds("a").get("cache_evicted") == 1
        assert reg.executor_cache_size() <= 2

    def test_runtime_serves_fresh_answers_across_grow(self):
        store = DynamicTableStore(_table(48, 50), capacity=56, device="cpu")
        reg = TableRegistry(lanes=LANES, device="cpu")
        reg.register("t", store, TenantConfig(K=2, eps=1.5, delta=0.2,
                                              deadline_ms=0.0, seed=5))
        mt = MultiTenantRuntime(reg, batch_wait_ms=1.0)
        mt.warmup()
        r1 = mt.submit(_queries(1, 51)[0], tenant="t", now=0.0)
        mt.drain(now=1.0)
        assert mt.result(r1).answered
        store.grow(128)
        big = _table(1, 52)[0] * 10.0
        store.append(big)
        r2 = mt.submit(big, tenant="t", now=2.0)
        mt.drain(now=3.0)
        res = mt.result(r2)
        assert res.answered
        assert int(store.live_ids().max()) in res.ids

    def test_range_slack_buys_headroom(self):
        """Value-range growth recalibrates the cached ladder in place at
        ``needed * range_slack``, as the JAX executor does; growth inside
        that headroom recalibrates nothing."""
        store = DynamicTableStore(_table(64, 70), device="cpu")
        reg = TableRegistry(lanes=LANES, device="cpu")
        reg.register("t", store, TenantConfig(K=2, eps=1.5,
                                              range_slack=2.0))
        ex = reg.executors("t")[0][0]
        store.append(_table(1, 71)[0] * 40.0)
        store.flush_updates()
        assert reg.executors("t")[0][0] is ex and ex.n_recalibrations == 1
        needed = 2.0 * store.value_abs_max
        assert ex.plan_value_range == needed * 2.0
        store.append(_table(1, 72)[0] * 60.0)
        store.flush_updates()
        reg.executors("t")
        assert 2.0 * store.value_abs_max <= ex.plan_value_range
        assert ex.n_recalibrations == 1

    def test_growth_past_the_budget(self):
        """A table grown past what the budget can rebalance is paged back
        out and its batch fails typed (``table unavailable``); a pinned
        one stays resident over the budget (recorded) until unpinned."""
        one = DynamicTableStore(_table(64, 0), device="cpu").resident_bytes()
        flight = FlightRecorder(capacity=64)
        reg = TableRegistry(byte_budget=int(1.5 * one), lanes=LANES,
                            flight=flight, device="cpu")
        store = reg.register("t", _table(64, 60),
                             TenantConfig(K=2, eps=1.5, deadline_ms=0.0))
        mt = MultiTenantRuntime(reg, batch_wait_ms=1.0)
        mt.warmup()
        store.grow(400)
        rid = mt.submit(_queries(1, 61)[0], tenant="t", now=0.0)
        mt.drain(now=1.0)
        res = mt.result(rid)
        assert res.status == "failed" and "table unavailable" in res.reason
        assert not reg.is_resident("t")
        assert reg.resident_bytes() == 0
        assert [e["kind"] for e in flight.events()].count(
            "table_unavailable") == 1
        pinned = reg.register("p", _table(64, 62),
                              TenantConfig(K=1, eps=2.0, pinned=True))
        pinned.grow(400)
        reg.executors("p")
        assert reg.is_resident("p")
        assert reg.resident_bytes() > reg.byte_budget
        assert any(e["kind"] == "budget_overridden"
                   for e in flight.events())
        reg.unpin("p")
        assert not reg.is_resident("p") and reg.resident_bytes() == 0


# ---- configs --------------------------------------------------------------


@pytest.mark.parametrize("kw,fragment", [
    (dict(precision="int2"), "unknown precision"),
    (dict(eps=0.0), "eps must be > 0"),
    (dict(delta=1.0), "delta must be in"),
    (dict(weight=0.0), "weight must be > 0"),
    (dict(queue_capacity=0), "queue_capacity must be >= 1")])
def test_tenant_config_refusals_match_jax_package(kw, fragment):
    for cls in (JaxConfig, TenantConfig):
        with pytest.raises(ValueError, match=fragment):
            cls(**kw)


def test_tenant_config_fields_ladder_and_class_match_jax_package():
    from dataclasses import fields
    assert [(f.name, f.default) for f in fields(TenantConfig)] == \
        [(f.name, f.default) for f in fields(JaxConfig)]
    kw = dict(eps=0.2, eps_floor=0.9, degrade_rungs=4, degrade_start=0.3,
              priority=2, deadline_ms=7.0)
    j, t = JaxConfig(**kw), TenantConfig(**kw)
    assert t.ladder().eps_values == j.ladder().eps_values
    assert vars(t.priority_classes()["default"]) == \
        vars(j.priority_classes()["default"])
