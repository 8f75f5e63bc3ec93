"""The port's `DynamicTableStore` and its serving hooks against the JAX
package's.

* **Store parity.**  The same initial rows (192 x 128, block 64) and the
  same seeded mutation script (upserts, delete + append pairs, appends;
  64 ops in 8 bursts) go through both stores, per tier.  After every
  burst, held bytewise: the host mirror, the slot/id maps, ``version``,
  ``value_abs_max``, ``stats()`` and the ``store_*`` metrics; the port's
  tiled table against the JAX store's ``_tile_major_dev()``; the int8 /
  int4 codes and the pq codes (the JAX codebook carried in through
  `store_from_jax`: the two packages' ``pq_train`` agree only to rtol
  1e-5).  The int8 / int4 scales are held bytewise against the JAX
  package's ``quantize_tiles`` on the JAX store's table, and to 1 ulp
  against the JAX store's own: its jitted quantizer divides by 127 (or
  7) as a multiply by the reciprocal, the drift ROADMAP.md queue 3
  records.
* **Decode over both stores** with the reference's permutation and
  ``use_pallas=False``: ids equal; scores to rtol 1e-5 and atol 1e-6 *
  max|score| on every tier (the rescore sums in another order, and the
  JAX int tiers sit an ulp off their oracle on jax 0.9.0).
* The single-device cases of ``tests/test_store.py`` in the port's terms:
  the zero-recompilation test becomes "no buffer reallocated (same
  ``data_ptr()``), no new `schedule_operands` build, no recalibration".
* Page round trips, and a JAX page image through `store_from_jax`.
* A store-backed `ServeRuntime` under churn and injected flush faults
  against the JAX runtime on `tests/test_torch_runtime.py`'s fixed-``DT``
  harness (flight events ``store_flush_error`` and ``recalibration``
  included), and the CPU end-to-end ``--dynamic`` CLI run.
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantize as jq
from repro.core.boundedme_jax import bounded_me_decode as jax_decode
from repro.core.boundedme_jax import make_plan as jax_make_plan
from repro.launch import serve as jserve
from repro.launch.admission import PriorityClass as JaxClass
from repro.launch.engine import MIPSServeEngine as JaxEngine
from repro.launch.engine import ServeRuntime as JaxRuntime
from repro.launch.faults import FaultInjector as JaxInjector
from repro.obs import FlightRecorder as JaxFlight
from repro.obs import SpanTracer as JaxTracer
from repro.store import DynamicTableStore as JaxStore
from repro_torch.convert import store_from_jax
from repro_torch.core.boundedme_torch import (decode_tiled, make_plan,
                                              schedule_operands)
from repro_torch.launch import serve
from repro_torch.launch.admission import PriorityClass
from repro_torch.launch.engine import MIPSServeEngine, ServeRuntime
from repro_torch.launch.faults import FaultInjector
from repro_torch.obs import FlightRecorder, SpanTracer
from repro_torch.store import DynamicTableStore, StoreFlushError
from test_torch_runtime import _classes, _fix_dt, _hold, _jax_perm

ROOT = Path(__file__).resolve().parents[1]
N_ROWS, DIM, K, BLOCK = 192, 128, 3, 64
TIERS = ["fp32", "int8", "int4", "pq"]


def _rows(seed=0, n=N_ROWS, scale=1.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.normal(size=(n, DIM))).astype(np.float32)


def _stores(precision, rows=None, **kw):
    """The JAX store and the port's on the same rows: pq carries the JAX
    codebook (and so the same codes) across through `store_from_jax`."""
    rows = _rows() if rows is None else rows
    kw = dict(block=BLOCK, capacity_slack=1.6, precision=precision, **kw)
    jst = JaxStore(rows, **kw)
    if precision == "pq":
        return jst, store_from_jax(_page_np(jst), device="cpu")
    return jst, DynamicTableStore(rows, device="cpu", **kw)


def _page_np(jst):
    page = jst.page_state()
    if page["codebook"] is not None:
        page["codebook"] = np.asarray(page["codebook"])
    return page


def _mutate(stores, rng, step, protect=(), scale=1.0):
    """One op of the mutation script, staged on every store alike."""
    live = [i for i in stores[0].live_ids().tolist() if i not in protect]
    row = (scale * rng.normal(size=DIM)).astype(np.float32)
    if step % 3 == 0:
        tgt = int(rng.choice(live))
        for st in stores:
            st.upsert(tgt, row)
    elif step % 3 == 1 and stores[0].free_rows > 0:
        victim = int(rng.choice(live))
        for st in stores:
            st.delete(victim)
            st.append(row)
    else:
        for st in stores:
            st.append(row)


def _assert_store_equal(jst, tst):
    np.testing.assert_array_equal(tst.host_table(), jst.host_table())
    np.testing.assert_array_equal(tst._slot_ids, jst._slot_ids)
    assert tst._id2slot == jst._id2slot
    assert (tst.version, tst.value_abs_max, tst._next_id) == (
        jst.version, jst.value_abs_max, jst._next_id)
    assert tst.stats() == jst.stats()
    assert tst.metrics.snapshot() == jst.metrics.snapshot()
    V4 = np.asarray(jst._tile_major_dev())
    np.testing.assert_array_equal(tst.tiled_table().numpy(), V4)
    np.testing.assert_array_equal(tst.device_table().numpy(),
                                  np.asarray(jst.device_table()))
    if tst.precision == "fp32":
        assert tst.quantized() is None and jst.quantized() is None
        return
    (tq_, taux), (jq_, jaux) = tst.quantized(), jst.quantized()
    np.testing.assert_array_equal(tq_.numpy(), np.asarray(jq_))
    if tst.precision == "pq":
        np.testing.assert_array_equal(taux.numpy(), np.asarray(jaux))
        return
    fresh = (jq.quantize_tiles if tst.precision == "int8"
             else jq.quantize_tiles_int4)(jnp.asarray(V4))
    np.testing.assert_array_equal(tq_.numpy(), np.asarray(fresh[0]))
    np.testing.assert_array_equal(taux.numpy(), np.asarray(fresh[1]))
    np.testing.assert_array_max_ulp(taux.numpy(), np.asarray(jaux),
                                    maxulp=1)


@pytest.mark.parametrize("precision", TIERS)
def test_store_matches_jax_store_after_every_burst(precision):
    jst, tst = _stores(precision)
    _assert_store_equal(jst, tst)
    rng = np.random.default_rng(1)
    for burst in range(8):
        for step in range(8):
            _mutate((jst, tst), rng, 8 * burst + step)
        assert tst.pending_updates == jst.pending_updates
        jinfo, tinfo = jst.flush_updates(), tst.flush_updates()
        for key in ("applied", "version", "requantized_tiles"):
            assert tinfo[key] == jinfo[key], key
        _assert_store_equal(jst, tst)
    assert tst.stats()["deletes"] > 0 and tst.n_live > N_ROWS


@pytest.mark.parametrize("final_exact", [True, False])
@pytest.mark.parametrize("precision", TIERS)
def test_decode_over_both_stores_matches(precision, final_exact):
    jst, tst = _stores(precision)
    rng = np.random.default_rng(2)
    for step in range(20):
        _mutate((jst, tst), rng, step)
    jst.flush_updates()
    tst.flush_updates()
    kw = dict(K=K, eps=1e-3, delta=0.05, value_range=16.0, block=BLOCK,
              precision=precision,
              quant_err=0.05 if precision == "pq" else None)
    jplan = jax_make_plan(jst.capacity_rows, DIM, **kw)
    plan = make_plan(tst.capacity_rows, DIM, **kw)
    Q = rng.normal(size=(3, DIM)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    perm = np.array(jax.random.permutation(key, plan.n_blocks))
    jids, jvals = jax_decode(jst.device_table(), Q, key, plan=jplan,
                             final_exact=final_exact, use_pallas=False,
                             n_valid=np.int32(jst.n_live),
                             quantized=jst.quantized())
    ids, vals = decode_tiled(tst.tiled_table(), Q, torch.from_numpy(perm),
                             plan=plan, final_exact=final_exact,
                             n_valid=tst.n_live, quantized=tst.quantized())
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    jvals = np.asarray(jvals)
    np.testing.assert_allclose(vals.numpy(), jvals, rtol=1e-5,
                               atol=1e-6 * float(np.abs(jvals).max()))


# ---- the JAX package's single-device store cases, in the port's terms ------

def _engine(store, **kw):
    kw.setdefault("K", K)
    kw.setdefault("eps", 1e-4)
    kw.setdefault("delta", 0.05)
    kw.setdefault("value_range", 16.0)
    kw.setdefault("batch_size", 2)
    kw.setdefault("deadline_ms", 1.0)
    return MIPSServeEngine(store, device="cpu", **kw)


def _query(eng, q):
    rid = eng.submit(q, now=float(eng.n_requests))
    eng.drain(now=float(eng.n_requests))
    return eng.result(rid)


def _masked_truth(store, q, k=K):
    s = store.host_table() @ q
    s[~store.live_mask()] = -np.inf
    slots = np.argsort(-s)[:k]
    return store.external_ids(slots), s[slots]


def test_roundtrip_and_dense_prefix():
    st = DynamicTableStore(_rows(), block=BLOCK, capacity_slack=1.5,
                           device="cpu")
    assert st.capacity_rows % st.tile == 0
    assert st.capacity_rows >= int(np.ceil(N_ROWS * 1.5))
    assert st.n_live == N_ROWS and st.version == 0
    row = np.random.default_rng(1).normal(size=DIM).astype(np.float32)
    new_id = st.append(row)
    st.upsert(7, 2 * row)
    st.delete(3)                       # interior: swap-filled from the tail
    assert st.pending_updates == 3
    info = st.flush_updates()
    assert info["applied"] == 3 and st.version == 3
    mask = st.live_mask()
    assert mask[:st.n_live].all() and not mask[st.n_live:].any()
    np.testing.assert_array_equal(st.host_table()[st.n_live:], 0.0)
    np.testing.assert_array_equal(st.host_table(), st.device_table().numpy())
    np.testing.assert_array_equal(st.host_table()[st._id2slot[new_id]], row)
    np.testing.assert_array_equal(st.host_table()[st._id2slot[7]], 2 * row)
    assert 3 not in set(st.live_ids().tolist())
    assert st.free_rows == st.capacity_rows - st.n_live
    assert st.resident_bytes() == st.tiled_table().numel() * 4


@pytest.mark.parametrize("precision", TIERS)
def test_snapshot_rebuild_is_bytewise(precision):
    st = DynamicTableStore(_rows(), block=BLOCK, precision=precision,
                           device="cpu")
    rng = np.random.default_rng(3)
    for step in range(9):
        _mutate((st,), rng, step)
    st.flush_updates()
    rows, ids = st.snapshot()
    fresh = DynamicTableStore(
        rows, ids=ids, capacity=st.capacity_rows, block=BLOCK,
        precision=precision, device="cpu",
        codebook=st.codebook() if precision == "pq" else None)
    np.testing.assert_array_equal(st.host_table(), fresh.host_table())
    np.testing.assert_array_equal(st.live_ids(), fresh.live_ids())
    assert torch.equal(st.tiled_table(), fresh.tiled_table())
    if precision != "fp32":
        for a, b in zip(st.quantized(), fresh.quantized()):
            assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["overflow", "unknown_delete", "bad_shape",
                                  "bad_id", "bad_precision"])
def test_store_refusals_match_jax_package(case):
    for cls, kw in ((JaxStore, {}), (DynamicTableStore, {"device": "cpu"})):
        if case == "bad_precision":
            with pytest.raises(ValueError, match="unknown precision"):
                cls(_rows(n=8), precision="int2", **kw)
            continue
        st = cls(_rows(n=8), capacity=8, block=BLOCK, **kw)
        if case == "overflow":
            st.append(np.zeros(DIM, np.float32))
            with pytest.raises(RuntimeError, match="store full"):
                st.flush_updates()
        elif case == "unknown_delete":
            st.delete(123)
            with pytest.raises(KeyError, match="unknown id"):
                st.flush_updates()
        elif case == "bad_shape":
            with pytest.raises(ValueError, match="row shape"):
                st.upsert(0, np.zeros(DIM + 1, np.float32))
        else:
            with pytest.raises(ValueError, match="ids must be >= 0"):
                st.upsert(-1, np.zeros(DIM, np.float32))


@pytest.mark.parametrize("precision", ["int8", "pq"])
def test_failed_flush_is_not_torn(precision):
    """A failing mid-batch op drops only itself: its successor stays
    staged and the shadow stays in sync with what applied."""
    st = DynamicTableStore(_rows(), block=BLOCK, precision=precision,
                           device="cpu")
    st.upsert(0, np.ones(DIM, np.float32))
    st.delete(12345)                      # unknown: fails at apply
    st.upsert(1, 2 * np.ones(DIM, np.float32))
    with pytest.raises(KeyError, match="unknown id"):
        st.flush_updates()
    assert st.pending_updates == 1 and st.version == 1
    np.testing.assert_array_equal(st.host_table(), st.device_table().numpy())
    st.flush_updates()
    assert np.all(st.host_table()[st._id2slot[1]] == 2.0)
    rows, ids = st.snapshot()
    fresh = DynamicTableStore(
        rows, ids=ids, capacity=st.capacity_rows, block=BLOCK,
        precision=precision, device="cpu",
        codebook=st.codebook() if precision == "pq" else None)
    assert torch.equal(st.tiled_table(), fresh.tiled_table())
    for a, b in zip(st.quantized(), fresh.quantized()):
        assert torch.equal(a, b)


def test_fault_hook_fails_a_flush_before_anything_is_taken():
    st = DynamicTableStore(_rows(), block=BLOCK, device="cpu")
    st.upsert(0, np.ones(DIM, np.float32))
    st.delete(5)

    def hook():
        raise StoreFlushError("barrier down")
    st.fault_hook = hook
    before = st.host_table().copy()
    with pytest.raises(StoreFlushError, match="barrier down"):
        st.flush_updates()
    assert st.pending_updates == 2 and st.version == 0
    assert st.n_flush_failures == 1
    np.testing.assert_array_equal(st.host_table(), before)
    st.fault_hook = None
    assert st.flush_updates()["applied"] == 2


@pytest.mark.parametrize("precision", ["int8", "int4", "pq"])
def test_quantized_shadow_rejects_non_row_pull_mode(precision):
    st = DynamicTableStore(_rows(), block=BLOCK, precision=precision,
                           device="cpu")
    for mode in ("coord", "hybrid"):
        with pytest.raises(ValueError, match="store shadow"):
            _engine(st, pull_mode=mode, coord_block=16)
    ids, _ = _query(_engine(st), np.ones(DIM, np.float32))
    assert ids.shape == (K,)


def test_fp32_store_serves_coord_mode_like_the_jax_package():
    """An fp32 store serves a coord plan (its table re-laid at the plan's
    pull width, refreshed on a version change) as the JAX engine does."""
    rows = _rows(scale=0.2)
    jst, tst = _stores("fp32", rows=rows)
    kw = dict(K=K, eps=0.05, delta=0.1, value_range=4.0, batch_size=2,
              deadline_ms=1.0, pull_mode="coord", coord_block=16, seed=3)
    jeng = JaxEngine(jst, use_pallas=False, **kw)
    teng = MIPSServeEngine(tst, device="cpu", perm_source=lambda s: np.array(
        jax.random.permutation(jax.random.fold_in(jax.random.PRNGKey(3), s),
                               jeng.plan.n_blocks)), **kw)
    assert teng.plan.pull_mode == jeng.plan.pull_mode == "coord"
    rng = np.random.default_rng(4)
    for step in range(6):
        _mutate((jst, tst), rng, step, scale=0.2)
        q = rng.normal(size=DIM).astype(np.float32)
        (ji, js), (ti, ts) = _query(jeng, q), _query(teng, q)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(ts, js, rtol=1e-5,
                                   atol=1e-6 * float(np.abs(js).max()))


def test_refresh_codebook_is_the_one_recalibrating_mutation():
    rng = np.random.default_rng(8)
    st = DynamicTableStore(_rows(), block=BLOCK, precision="pq",
                           device="cpu")
    cb0 = st.codebook().clone()
    for i in range(6):                     # drift the row distribution
        st.upsert(i, (3.0 * rng.normal(size=DIM)).astype(np.float32))
    st.flush_updates()
    assert torch.equal(st.codebook(), cb0)
    v0 = st.version
    info = st.refresh_codebook()
    assert info["refreshes"] == st.codebook_refreshes == 1
    assert st.version == v0 + 1
    assert not torch.equal(st.codebook(), cb0)
    rows, ids = st.snapshot()
    fresh = DynamicTableStore(rows, ids=ids, capacity=st.capacity_rows,
                              block=BLOCK, precision="pq", device="cpu")
    for a, b in zip(st.quantized(), fresh.quantized()):
        assert torch.equal(a, b)
    with pytest.raises(RuntimeError, match="pq"):
        DynamicTableStore(_rows(n=8), block=BLOCK, precision="int8",
                          device="cpu").refresh_codebook()


@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_engine_survives_grow(precision):
    rng = np.random.default_rng(7)
    st = DynamicTableStore(_rows(n=24), capacity=24, block=BLOCK,
                           precision=precision, device="cpu")
    eng = _engine(st)
    q = rng.normal(size=DIM).astype(np.float32)
    _query(eng, q)
    st.grow(64)                           # out-of-band shape change
    assert st.capacity_rows == 64
    winner = st.append((9.0 * q / np.linalg.norm(q)).astype(np.float32))
    ids, _ = _query(eng, q)               # the engine rebuilds its plan
    assert eng.n == st.capacity_rows == 64
    assert winner in ids.tolist()
    assert eng.stats()["updates"]["recalibrations"] >= 1
    for _ in range(20):
        st.append(np.zeros(DIM, np.float32))
    st.flush_updates()
    assert st.n_live == 45


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_deleted_ids_never_returned(seed):
    """All-negative rows: a zeroed tombstone (score 0) would beat every
    live arm, so only the cascade's prefix mask keeps dead ids out."""
    rng = np.random.default_rng(seed)
    V = -np.abs(rng.normal(size=(96, DIM))).astype(np.float32)
    st = DynamicTableStore(V, block=BLOCK, capacity_slack=2.0, device="cpu")
    eng = _engine(st, recall_sample_rate=1.0)
    dead = set()
    for step in range(12):
        live = st.live_ids()
        op = rng.integers(0, 3)
        if op == 0 and live.size > K + 4:
            victim = int(rng.choice(live))
            st.delete(victim)
            dead.add(victim)
        elif op == 1 and st.free_rows > 0:
            st.append(-np.abs(rng.normal(size=DIM)).astype(np.float32))
        else:
            st.upsert(int(rng.choice(live)),
                      -np.abs(rng.normal(size=DIM)).astype(np.float32))
        q = np.abs(rng.normal(size=DIM)).astype(np.float32)
        ids, _ = _query(eng, q)
        got = set(ids.tolist())
        assert not (got & dead), f"dead id returned at step {step}"
        assert got == set(_masked_truth(st, q)[0].tolist())
    assert eng.stats()["recall"]["mean"] == 1.0


@pytest.mark.parametrize("precision", TIERS)
def test_engine_matches_fresh_engine_after_burst(precision):
    rng = np.random.default_rng(4)
    st = DynamicTableStore(_rows(scale=0.2), block=BLOCK, capacity_slack=1.6,
                           precision=precision, device="cpu")
    ekw = {"quant_err": 0.05} if precision == "pq" else {}
    perm = lambda s: np.random.default_rng(s).permutation(2)  # noqa: E731
    eng = _engine(st, eps=1e-3, perm_source=perm, **ekw)
    qs = rng.normal(size=(3, DIM)).astype(np.float32)
    planted = []
    for b, q in enumerate(qs):            # planted winners, wide margins
        unit = q / np.linalg.norm(q)
        for j in range(K):
            st.upsert(17 * b + 5 * j + 1,
                      ((4.0 + 0.5 * j) * unit).astype(np.float32))
            planted.append(17 * b + 5 * j + 1)
    for step in range(4):
        _mutate((st,), rng, step, protect=planted, scale=0.2)
        st.flush_updates()
        rows, ids = st.snapshot()
        fresh_store = DynamicTableStore(
            rows, ids=ids, capacity=st.capacity_rows, block=BLOCK,
            precision=precision, device="cpu",
            codebook=st.codebook() if precision == "pq" else None)
        fresh = _engine(fresh_store, eps=1e-3, perm_source=perm, **ekw)
        for q in qs:
            ia, sa = _query(eng, q)
            ib, sb = _query(fresh, q)
            np.testing.assert_array_equal(ia, ib)
            np.testing.assert_array_equal(sa, sb)


@pytest.mark.parametrize("precision", TIERS)
def test_mutation_stream_reallocates_and_rebuilds_nothing(precision):
    rng = np.random.default_rng(5)
    st = DynamicTableStore(_rows(), block=BLOCK, capacity_slack=2.0,
                           precision=precision, device="cpu")
    eng = _engine(st, eps=1e-3, **({"quant_err": 0.05}
                                   if precision == "pq" else {}))
    st.upsert(0, rng.normal(size=DIM).astype(np.float32))
    st.delete(1)
    st.append(rng.normal(size=DIM).astype(np.float32))
    _query(eng, rng.normal(size=DIM).astype(np.float32))
    bufs = [st.tiled_table()] + list(st.quantized() or ())
    ptrs = [b.data_ptr() for b in bufs]
    builds = schedule_operands.cache_info().misses
    for step in range(24):
        live = st.live_ids()
        if step % 3 == 0:
            st.upsert(int(rng.choice(live)),
                      rng.normal(size=DIM).astype(np.float32))
        elif step % 3 == 1 and st.free_rows > 0:
            st.delete(int(rng.choice(live)))
            st.append(rng.normal(size=DIM).astype(np.float32))
        else:
            st.append(rng.normal(size=DIM).astype(np.float32))
        _query(eng, rng.normal(size=DIM).astype(np.float32))
    now = [st.tiled_table()] + list(st.quantized() or ())
    assert [b.data_ptr() for b in now] == ptrs
    assert schedule_operands.cache_info().misses == builds
    assert eng.stats()["updates"]["recalibrations"] == 0
    assert eng.stats()["updates"]["applied"] == st.n_upserts + st.n_deletes


def test_value_range_growth_recalibrates_once():
    rng = np.random.default_rng(6)
    st = DynamicTableStore(_rows(), block=BLOCK, capacity_slack=1.5,
                           device="cpu")
    eng = _engine(st, value_range=None, recall_sample_rate=1.0)
    vr0 = eng.executor.plan_value_range
    q = rng.normal(size=DIM).astype(np.float32)
    gid = st.append((40.0 * q / np.linalg.norm(q)).astype(np.float32))
    ids, _ = _query(eng, q)
    assert gid in ids.tolist()
    assert eng.stats()["updates"]["recalibrations"] == 1
    assert eng.executor.plan_value_range > vr0
    st.upsert(0, rng.normal(size=DIM).astype(np.float32))
    _query(eng, q)                       # in range: no second rebuild
    assert eng.stats()["updates"]["recalibrations"] == 1
    assert eng.stats()["recall"]["mean"] == 1.0


# ---- page round trips ------------------------------------------------------

@pytest.mark.parametrize("precision", TIERS)
def test_page_state_round_trips(precision):
    st = DynamicTableStore(_rows(), block=BLOCK, precision=precision,
                           device="cpu")
    rng = np.random.default_rng(9)
    for step in range(7):
        _mutate((st,), rng, step)
    st.flush_updates()
    st.upsert(3, np.ones(DIM, np.float32))   # staged, carried verbatim
    st.delete(4)
    page = st.page_state()
    back = DynamicTableStore.from_page(page, device="cpu")
    assert (back.version, back.value_abs_max, back._next_id,
            back.pending_updates) == (st.version, st.value_abs_max,
                                      st._next_id, 2)
    assert torch.equal(back.tiled_table(), st.tiled_table())
    if precision != "fp32":
        for a, b in zip(back.quantized(), st.quantized()):
            assert torch.equal(a, b)
    back.flush_updates()
    st.flush_updates()
    np.testing.assert_array_equal(back.host_table(), st.host_table())


@pytest.mark.parametrize("precision", TIERS)
def test_jax_page_image_loads_through_store_from_jax(precision):
    jst = JaxStore(_rows(), block=BLOCK, precision=precision)
    rng = np.random.default_rng(10)
    for step in range(7):
        _mutate((jst,), rng, step)
    jst.flush_updates()
    jst.upsert(2, np.full(DIM, 0.5, np.float32))
    jst.delete(6)
    tst = store_from_jax(_page_np(jst), device="cpu")
    assert tst.pending_updates == 2
    jst.flush_updates()
    tst.flush_updates()
    _assert_store_equal_but_counters(jst, tst)


def _assert_store_equal_but_counters(jst, tst):
    np.testing.assert_array_equal(tst.host_table(), jst.host_table())
    np.testing.assert_array_equal(tst._slot_ids, jst._slot_ids)
    assert (tst.version, tst.value_abs_max) == (jst.version,
                                                jst.value_abs_max)
    np.testing.assert_array_equal(tst.tiled_table().numpy(),
                                  np.asarray(jst._tile_major_dev()))
    if tst.precision != "fp32":
        np.testing.assert_array_equal(tst.quantized()[0].numpy(),
                                      np.asarray(jst.quantized()[0]))


@pytest.mark.parametrize("field,value,error", [
    ("rows", np.zeros((4, DIM), np.float64), TypeError),
    ("ids", np.arange(4, dtype=np.int32), TypeError),
    ("version", "3", TypeError),
    ("codebook", np.zeros((2, 8, 16, 8), np.float32), ValueError),
    ("staged", [("move", 1, None)], ValueError)])
def test_store_from_jax_checks_its_input(field, value, error):
    page = _page_np(JaxStore(_rows(n=4), block=BLOCK))
    page[field] = value
    with pytest.raises(error):
        store_from_jax(page, device="cpu")
    page = _page_np(JaxStore(_rows(n=4), block=BLOCK))
    del page["next_id"]
    with pytest.raises(ValueError, match="lacks"):
        store_from_jax(page, device="cpu")


# ---- the store-backed runtime under churn ----------------------------------

def _runtime_pair(precision, adaptive=False, bound="hoeffding"):
    """Both runtimes on their store, a fixed DT each, flush faults on."""
    rows = _rows(scale=0.05)
    jst, tst = _stores(precision, rows=rows)
    common = dict(K=4, eps=0.3, delta=0.1, eps_floor=1.2, degrade_rungs=3,
                  lanes=4, batch_wait_ms=1.0, queue_capacity=6,
                  max_retries=1, retry_backoff_ms=0.5, cache_entries=8,
                  recall_sample_rate=0.5, precision=precision,
                  adaptive=adaptive, bound=bound,
                  quant_err=2e-4 if precision == "pq" else None, seed=3)
    inj = dict(latency_rate=0.2, latency_ms=2.0, error_rate=0.2,
               persistent_rate=0.5, flush_failure_rate=0.3)
    jrt = JaxRuntime(jst, use_pallas=False, classes=_classes(JaxClass),
                     fault_injector=JaxInjector(5, **inj),
                     tracer=JaxTracer(max_requests=128, seed=0),
                     flight=JaxFlight(capacity=512), **common)
    trt = ServeRuntime(tst, classes=_classes(PriorityClass),
                       fault_injector=FaultInjector(5, **inj),
                       tracer=SpanTracer(max_requests=128, seed=0),
                       flight=FlightRecorder(capacity=512),
                       perm_source=_jax_perm, **common)
    _fix_dt(jrt._rung_execs)
    _fix_dt(trt.executors)
    return (jrt, jst), (trt, tst)


def _churned(rt, store, qs) -> int:
    """Traffic with a mutation staged before most arrivals, a planted
    winner (value-range growth) halfway, and idle repeats."""
    rt.warmup()
    rng = np.random.default_rng(11)
    names = ("default", "batch", "interactive")
    t = 0.0
    for i in range(36):
        if i == 18:
            q = qs[19]
            store.append((1.5 * q / np.linalg.norm(q)).astype(np.float32))
        elif i % 4:
            _mutate((store,), rng, i, scale=0.05)
        rt.submit(qs[i], now=t, cls=names[i % 3])
        rt.poll(now=t + 4e-4)
        t += 5e-4
    rt.drain(now=t + 1e-3)
    t += 1.0
    for i in range(12):                     # idle: repeats under churn
        if i % 6 == 0:
            _mutate((store,), rng, i, scale=0.05)
        rt.submit(qs[i % 3], now=t)
        rt.poll(now=t + 2e-3)
        t += 5e-3
    rt.drain(now=t + 1.0)
    return rt.n_requests


@pytest.mark.parametrize("precision,adaptive,bound", [
    ("fp32", False, "hoeffding"), ("int8", False, "hoeffding"),
    ("int4", False, "hoeffding"), ("pq", False, "hoeffding"),
    ("int8", True, "bernstein")])
def test_store_runtime_under_churn_matches_jax_runtime(precision, adaptive,
                                                      bound):
    (jrt, jst), (trt, tst) = _runtime_pair(precision, adaptive, bound)
    qs = np.random.default_rng(12).normal(size=(40, DIM)).astype(np.float32)
    n = _churned(jrt, jst, qs)
    assert _churned(trt, tst, qs) == n
    _, st = _hold(jrt, trt, n)
    kinds = {e["kind"] for e in trt.flight.events()}
    assert {"store_flush_error", "recalibration"} <= kinds
    assert st["faults"]["store_flush_failures"] == \
        st["faults"]["injected"]["flush_failures"] > 0
    assert st["faults"]["update_errors"] == 0
    assert st["updates"]["recalibrations"] == 3      # one per rung
    assert st["store"]["n_live"] == tst.n_live and tst.pending_updates == 0
    assert st["cache"]["hits"] > 0
    _assert_store_equal_but_counters(jst, tst)


def test_runtime_counts_a_bad_mutation_and_serves_on():
    st = DynamicTableStore(_rows(), block=BLOCK, device="cpu")
    rt = ServeRuntime(st, K=K, lanes=2, value_range=16.0)
    st.delete(99999)
    st.upsert(0, np.ones(DIM, np.float32))
    assert rt.apply_updates(0.0) == 0 and rt.n_update_errors == 1
    assert rt.n_updates == 0 and st.pending_updates == 1
    assert rt.apply_updates(1.0) == 1 and rt.n_updates == 1
    rid = rt.submit(np.ones(DIM, np.float32), now=2.0)
    rt.drain(now=2.0)
    assert rt.result(rid).answered and rt.n_update_errors == 1
    assert rt.stats()["updates"]["version"] == 1


def test_churn_stream_matches_jax_package():
    """`make_churn` stages the JAX CLI's mutations, draw for draw."""
    jst, tst = _stores("fp32")
    eng = type("E", (), {"N": DIM})()
    jc = jserve._make_churn(jst, 0.5, jst.value_abs_max)
    tc = serve.make_churn(tst, 0.5, tst.value_abs_max)
    for i in range(40):
        jc(eng, i)
        tc(eng, i)
        assert len(tst._staged) == len(jst._staged)
        if i % 8 == 7:
            jst.flush_updates()
            tst.flush_updates()
    jst.flush_updates()
    tst.flush_updates()
    _assert_store_equal(jst, tst)
    assert tst.stats()["deletes"] > 0


CLI_CHECKS = [
    (["--churn-rate", "0.2"], "--dynamic"),
    (["--dynamic", "--churn-rate", "1.5"], "[0, 1]"),
    (["--dynamic", "--precision", "int8", "--pull-mode", "coord"],
     "incompatible"),
    (["--runtime", "--inject-flush-rate", "0.2"], "--dynamic"),
    (["--dynamic", "--inject-flush-rate", "0.2"], "--runtime")]


@pytest.mark.parametrize("argv,fragment", CLI_CHECKS)
def test_cli_store_checks_match_jax_package(argv, fragment, capsys):
    full = ["--arch", "qwen1.5-0.5b", "--loop", *argv]
    with pytest.raises(SystemExit):
        serve.parse_args(full)
    assert fragment in capsys.readouterr().err
    ap = jserve._build_parser()
    with pytest.raises(SystemExit):
        jserve._validate_args(ap, ap.parse_args(full))
    assert fragment in capsys.readouterr().err


def test_cli_dynamic_runtime_end_to_end(tmp_path, capsys):
    paths = {k: tmp_path / f"{k}.{ext}" for k, ext in
             (("metrics", "prom"), ("trace", "json"), ("flight", "json"))}
    serve.main(["--arch", "qwen1.5-0.5b", "--smoke", "--loop", "--runtime",
                "--dynamic", "--churn-rate", "0.25", "--inject-flush-rate",
                "0.2", "--device", "cpu", "--requests", "48",
                "--eps-floor", "0.4", "--check-outcomes",
                "--metrics-out", str(paths["metrics"]),
                "--trace-out", str(paths["trace"]),
                "--flight-recorder-path", str(paths["flight"])])
    out = capsys.readouterr().out
    assert "dynamic=True churn=0.25" in out and "[check] OK" in out
    stats = json.loads(out[out.index("{"):out.index("[check]")])
    assert sum(stats["outcomes"].values()) == stats["requests"] == 48
    assert stats["updates"]["applied"] > 0
    assert stats["faults"]["store_flush_failures"] == \
        stats["faults"]["injected"]["flush_failures"] > 0
    assert stats["store"]["capacity_rows"] >= 1.5 * stats["store"]["n_live"]
    assert "store_flush_failures_total" in paths["metrics"].read_text()
    run = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "check_obs_artifacts.py"),
         "--metrics", str(paths["metrics"]), "--trace", str(paths["trace"]),
         "--flight", str(paths["flight"])],
        capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stdout + run.stderr


def test_cli_dynamic_loop_serves_external_ids(capsys):
    args = serve.parse_args(["--arch", "qwen1.5-0.5b", "--smoke", "--loop",
                             "--dynamic", "--churn-rate", "0.5",
                             "--precision", "int8", "--device", "cpu",
                             "--requests", "32", "--recall-rate", "1.0"])
    engine, qs = serve.build_loop(args)
    stats = serve.serve_stream(args, engine, qs)
    assert stats["completed"] == 32 and stats["updates"]["applied"] > 0
    assert stats["store"]["tiles_requantized"] > 0
    live = set(engine.store.live_ids().tolist())
    for rid in range(32):
        ids, _ = engine.result(rid)
        assert len(set(ids.tolist())) == args.topk
    assert live and stats["recall"]["samples"] > 0
