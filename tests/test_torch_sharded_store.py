"""The port's `ShardedTableStore` against the JAX package's, on the CPU.

The JAX store's device write fails on the installed jax
(``ShardingTypeError``, ROADMAP.md queue 3), so its oracle is its
host-side bookkeeping: inside these tests only, its mesh is a stand-in
with the shard count, its placement a plain ``device_put`` and its
``_dev_write`` a no-op.  Both stores take the same seeded script of
upserts, deletes and appends, op for op; after every flush the host
mirror, slot ids, id map, per-shard live counts and stats must be equal,
and the port's tiled shards must hold exactly its host mirror.  Nothing
of the JAX package changes.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro.store.sharded_table as jax_sharded
from repro_torch.core import boundedme_torch as bt
from repro_torch.distributed.sharding import Mesh, sharded_decode_tiled
from repro_torch.launch.engine import CascadeExecutor, ServeRuntime
from repro_torch.launch.faults import FaultInjector
from repro_torch.store import (DynamicTableStore, ShardedTableStore,
                               StoreFlushError)

DIM = 100          # not a whole number of 64-wide blocks


def _rows(n, seed=0, dim=DIM):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, dim)).astype(np.float32)


@pytest.fixture
def jax_store(monkeypatch):
    """A factory of JAX `ShardedTableStore`s whose bookkeeping runs and
    whose device writes do nothing."""
    monkeypatch.setattr(jax_sharded, "serving_table_sharding",
                        lambda mesh, axis="model": None)
    monkeypatch.setattr(jax_sharded.ShardedTableStore, "_dev_write",
                        lambda self, row, slot: self._c_rows_written.inc())

    def make(rows, S, **kw):
        mesh = SimpleNamespace(shape={"model": S})
        return jax_sharded.ShardedTableStore(rows, mesh=mesh, **kw)
    return make


def _tiled_rows(st: ShardedTableStore) -> np.ndarray:
    return st.device_table().numpy()


def _same(jst, tst):
    np.testing.assert_array_equal(tst.host_table(), jst.host_table())
    np.testing.assert_array_equal(tst._slot_ids, jst._slot_ids)
    assert tst._id2slot == jst._id2slot
    np.testing.assert_array_equal(tst.n_valid_vector(), jst.n_valid_vector())
    np.testing.assert_array_equal(tst.live_ids(), jst.live_ids())
    np.testing.assert_array_equal(tst.live_mask(), jst.live_mask())
    assert tst.stats() == jst.stats()
    assert (tst.n_live, tst.free_rows, tst.version, tst.value_abs_max,
            tst.pending_updates) == (jst.n_live, jst.free_rows, jst.version,
                                     jst.value_abs_max, jst.pending_updates)
    # every shard's tiled buffer holds its slice of the host mirror
    np.testing.assert_array_equal(_tiled_rows(tst), tst.host_table())


def _script(stores, rng, n_ops, unknown_delete=False):
    """The same staged ops on every store: upserts of live and new ids,
    delete + append pairs, appends, optionally an unknown delete."""
    for _ in range(n_ops):
        row = rng.normal(size=DIM).astype(np.float32)
        live = stores[0].live_ids()
        r = rng.random()
        if r < 0.4 and live.size:
            tgt = int(rng.choice(live))
            for st in stores:
                st.upsert(tgt, row)
        elif r < 0.7 and live.size:
            gone = int(rng.choice(live))
            for st in stores:
                st.delete(gone)
                st.append(row)
        else:
            for st in stores:
                st.append(row)
    if unknown_delete:
        for st in stores:
            st.delete(10 ** 6)


@pytest.mark.parametrize("S,n0,capacity", [(2, 61, None), (3, 100, None),
                                           (3, 10, 24)])
def test_slot_map_matches_jax_op_for_op(jax_store, S, n0, capacity):
    rng = np.random.default_rng(S + n0)
    rows = _rows(n0, seed=S)
    kw = dict(capacity=capacity, tile=8, block=64)
    jst = jax_store(rows, S, **kw)
    tst = ShardedTableStore(rows, mesh=Mesh(["cpu"] * S), **kw)
    assert (tst.cap_local, tst.capacity_rows) == (jst.cap_local,
                                                  jst.capacity_rows)
    assert tst.resident_bytes() == tst.capacity_rows * DIM * 4
    assert tst.device_bytes() == tst.capacity_rows * 128 * 4
    _same(jst, tst)
    for burst in range(8):
        _script([jst, tst], rng, 12, unknown_delete=burst == 3)
        outs = []
        for st in (jst, tst):
            try:
                outs.append(st.flush_updates()["applied"])
            except (KeyError, RuntimeError) as e:
                outs.append(type(e).__name__)
        assert outs[0] == outs[1]
        _same(jst, tst)
    # past capacity: the route raises in both, and the rest stays staged
    free = tst.free_rows
    for st in (jst, tst):
        for _ in range(free + 2):
            st.append(np.ones(DIM, np.float32))
        st.delete(int(st.live_ids()[0]))
        with pytest.raises(RuntimeError, match="store full"):
            st.flush_updates()
    _same(jst, tst)
    np.testing.assert_array_equal(tst.external_ids([0, 1, 10 ** 6]),
                                  jst.external_ids([0, 1, 10 ** 6]))


def test_snapshot_rebuilds_a_bytewise_fresh_store():
    """After churn, a fresh store over the same live ids, rows and shard
    counts holds the same slot map and bytewise the same tiled shards."""
    rng = np.random.default_rng(3)
    mesh = Mesh(["cpu"] * 3)
    st = ShardedTableStore(_rows(90), mesh=mesh, block=64)
    for _ in range(6):
        _script([st], rng, 10)
        st.flush_updates()
    rows, ids, counts = st.snapshot()
    fresh = ShardedTableStore(rows, ids=ids, shard_counts=counts,
                              capacity=st.capacity_rows, mesh=mesh, block=64)
    np.testing.assert_array_equal(fresh._slot_ids, st._slot_ids)
    np.testing.assert_array_equal(fresh.host_table(), st.host_table())
    for a, b in zip(fresh.tiled_shards(), st.tiled_shards()):
        assert torch.equal(a, b)
    assert fresh.value_abs_max <= st.value_abs_max
    with pytest.raises(ValueError, match="shard_counts"):
        ShardedTableStore(rows, ids=ids, shard_counts=counts[:2], mesh=mesh)


def test_flush_fault_keeps_every_op_staged():
    """An injected flush failure (`FaultInjector.attach` on the sharded
    store) takes nothing; the retry applies everything."""
    st = ShardedTableStore(_rows(40), mesh=Mesh(["cpu"] * 2), block=64)
    inj = FaultInjector(0, flush_failure_rate=1.0)
    inj.attach(st)
    st.upsert(3, np.zeros(DIM, np.float32))
    st.append(np.ones(DIM, np.float32))
    before = st.host_table().copy()
    with pytest.raises(StoreFlushError):
        st.flush_updates()
    assert st.pending_updates == 2 and st.n_flush_failures == 1
    np.testing.assert_array_equal(st.host_table(), before)
    st.fault_hook = None
    assert st.flush_updates()["applied"] == 2 and st.n_live == 41


@pytest.mark.parametrize("precision", ["fp32", "int8", "int4", "pq"])
def test_executor_reads_the_store_in_place(precision):
    """A store-backed sharded executor dispatches over the store's own
    shards (the fp32 shards read in place; a quantized tier's codes kept
    by the store at the plan's geometry, one copy per version shared by
    every executor there, rebuilt by each flush, bitwise a fresh
    quantization of each shard's rows and counted in ``device_bytes``,
    not in ``resident_bytes``, the JAX unit), with the store's per-shard
    live counts."""
    mesh = Mesh(["cpu"] * 2)
    st = ShardedTableStore(_rows(120, seed=1), mesh=mesh, block=64)
    table_bytes = st.capacity_rows * DIM * 4
    kw = dict(K=3, precision=precision, device="cpu",
              quant_err=1e-3 if precision == "pq" else None)
    ex = CascadeExecutor(st, eps=0.5, **kw)
    assert ex.mesh is mesh and ex.plan.n == st.cap_local
    Q = _rows(4, seed=9)
    perm = bt.draw_perms(ex.plan.n_blocks)
    shards, quant, nv = ex.shard_operands()

    def fresh(q):
        for V4, art in zip(st.tiled_shards(), q):
            for a, b in zip(art, bt.quantize_table(V4, ex.plan)):
                assert torch.equal(a, b)

    if precision == "fp32":
        assert all(a is b for a, b in zip(shards, st.tiled_shards()))
        assert quant is None and st.resident_bytes() == table_bytes
    else:
        # a second executor (another rung's eps) shares the one copy
        other = CascadeExecutor(st, eps=0.8, **kw)
        assert other.shard_operands()[1] is quant
        assert ex.shard_operands()[1] is quant       # cached per version
        fresh(quant)
        codes = sum(t.numel() * t.element_size() for art in quant
                    for t in art)
        assert st.resident_bytes() == table_bytes
        assert st.device_bytes() == st.capacity_rows * 128 * 4 + codes
    np.testing.assert_array_equal(nv, st.n_valid_vector())
    st.delete(0)
    st.flush_updates()
    if quant is not None:
        # the flush rebuilt the codes: no dispatch builds them
        assert st._operands[next(iter(st._operands))][0] == st.version
        quant = ex.shard_operands()[1]
        assert other.shard_operands()[1] is quant
        fresh(quant)
    ids, scores, _, _ = ex.dispatch(Q, perm)
    want = sharded_decode_tiled(
        st.tiled_shards(), Q, perm, mesh=mesh, plan=ex.plan, K=3,
        k_out=ex._k_out, n_valid=st.n_valid_vector(),
        quantized=ex.shard_operands()[1])
    np.testing.assert_array_equal(ids, want[0].numpy())
    np.testing.assert_array_equal(scores, want[1].numpy())
    live = set(np.flatnonzero(st.live_mask()).tolist())
    assert set(ids.ravel().tolist()) <= live


@pytest.mark.parametrize("precision", ["fp32", "int8", "int4", "pq"])
@pytest.mark.parametrize("S,n0,dim", [(2, 61, DIM), (3, 100, 128)])
def test_resident_bytes_side_by_side(jax_store, precision, S, n0, dim):
    """``resident_bytes`` equals the JAX store's (its f32 capacity
    buffer) before and after an executor of any tier caches the shards'
    codes, and after a flush grows nothing; `device_bytes` holds what
    the port keeps besides."""
    rows = _rows(n0, seed=S, dim=dim)
    jst = jax_store(rows, S, block=64)
    tst = ShardedTableStore(rows, mesh=Mesh(["cpu"] * S), block=64)
    assert tst.resident_bytes() == jst.resident_bytes()
    ex = CascadeExecutor(tst, K=2, eps=0.5, precision=precision,
                         device="cpu",
                         quant_err=1e-3 if precision == "pq" else None)
    quant = ex.shard_operands()[1]
    codes = sum(t.numel() * t.element_size() for art in quant or ()
                for t in art)
    assert (codes > 0) == (precision != "fp32")
    assert tst.resident_bytes() == jst.resident_bytes()
    assert tst.device_bytes() == sum(
        t.numel() * 4 for t in tst.tiled_shards()) + codes
    for st in (jst, tst):
        st.delete(int(st.live_ids()[0]))
        st.flush_updates()
    ex.shard_operands()
    assert tst.resident_bytes() == jst.resident_bytes()


def test_coord_executors_share_one_relaid_copy():
    """Coord plans on a sharded store read one copy re-laid at their pull
    width, shared by every executor at that width, rebuilt by each flush;
    `device_bytes` counts it, `resident_bytes` (the JAX unit) does not."""
    mesh = Mesh(["cpu"] * 2)
    st = ShardedTableStore(_rows(120, seed=2), mesh=mesh, block=64)
    kw = dict(K=3, pull_mode="coord", coord_block=32, device="cpu")
    a = CascadeExecutor(st, eps=0.5, **kw)
    b = CascadeExecutor(st, eps=0.9, **kw)
    shards = a.shard_operands()[0]
    assert b.shard_operands()[0] is shards
    assert shards[0].shape[-1] == 32 and shards[0] is not st.tiled_shards()[0]
    relaid = sum(t.numel() * 4 for t in shards)
    assert st.resident_bytes() == st.capacity_rows * DIM * 4
    assert st.device_bytes() == st.capacity_rows * 128 * 4 + relaid
    st.delete(3)
    st.flush_updates()
    fresh = a.shard_operands()[0]
    assert fresh is not shards and b.shard_operands()[0] is fresh
    for V4, R4 in zip(st.tiled_shards(), fresh):
        rows = V4.permute(0, 2, 1, 3).reshape(st.cap_local, -1)[:, :DIM]
        assert torch.equal(R4, bt.tile_table(rows, a.plan, "cpu"))


def test_mesh_and_store_must_agree():
    mesh = Mesh(["cpu"] * 2)
    st = ShardedTableStore(_rows(40), mesh=mesh, block=64)
    with pytest.raises(ValueError, match="mesh differs"):
        CascadeExecutor(st, mesh=Mesh(["cpu"] * 2), device="cpu")
    with pytest.raises(ValueError, match="store-managed"):
        CascadeExecutor(st, n_valid=3, device="cpu")
    with pytest.raises(ValueError, match="needs a ShardedTableStore"):
        CascadeExecutor(DynamicTableStore(_rows(40), device="cpu"),
                        mesh=mesh, device="cpu")


def test_runtime_over_the_store_under_churn_and_flush_faults():
    """`ServeRuntime` drains the sharded store between dispatches under
    injected flush failures; every dispatch answers live slots with the
    exact scores of the table as it stood."""
    mesh = Mesh(["cpu"] * 3)
    st = ShardedTableStore(_rows(150, seed=4), mesh=mesh, block=64)
    rt = ServeRuntime(st, K=3, eps=0.5, eps_floor=1.0, lanes=4,
                      precision="int8", adaptive=True,
                      fault_injector=FaultInjector(1,
                                                   flush_failure_rate=0.3),
                      device="cpu")
    records = []
    for ex in rt.executors:
        def recording(Qbuf, perm, real=ex.dispatch):
            out = real(Qbuf, perm)
            records.append((Qbuf.copy(), st.host_table().copy(),
                            st.live_mask().copy(), out))
            return out
        ex.dispatch = recording
    rng = np.random.default_rng(6)
    for i, q in enumerate(_rows(40, seed=7)):
        _script([st], rng, 1)
        rt.submit(q, now=i * 1e-4)
        rt.poll(now=i * 1e-4)
    rt.drain(now=1.0)
    s = rt.stats()
    assert s["faults"]["store_flush_failures"] == \
        s["faults"]["injected"]["flush_failures"] > 0
    assert s["store"]["n_shards"] == 3 and s["updates"]["applied"] > 0
    assert s["outcomes"]["ok"] + s["outcomes"]["degraded"] == 40
    assert len(records) > 0
    for Qbuf, host, live, (ids, scores, rounds, _) in records:
        assert live[ids].all() and rounds.shape == (4, 3)
        exact = np.einsum("bkn,bn->bk", host[ids].astype(np.float64),
                          Qbuf.astype(np.float64)) / DIM
        np.testing.assert_allclose(scores, exact, rtol=1e-4, atol=1e-6)
