"""The port's `DynamicTableStore` on the card.

Every test is marked ``cuda`` and skips without a card.  This file
imports only the port, so it runs where JAX is not installed.  The store
runs no kernel of its own: its writes and re-encodes are PyTorch ops, and
on the card they must give what they give on the CPU — the fp32 table
and the int8 / int4 shadow bytewise (maxima, one true division, round
half to even) — while the pq codes are held bytewise against a fresh
store built on the card from the snapshot (one encode shape for every
path).  A store-backed engine's flushes launch the fused cascade over
the store's own buffers.  Paging on the card: the host mirror is
page-locked, a page-out frees exactly the store's ``device_bytes`` of
allocated card memory, a page-in brings every buffer back bytewise, and
the tenancy registry's eviction frees the table's bytes while its
page-in serves the same answers.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.launch.engine import MIPSServeEngine
from repro_torch.launch.tenancy import TableRegistry, TenantConfig
from repro_torch.store import DynamicTableStore

pytestmark = pytest.mark.cuda

N_ROWS, DIM, BLOCK = 1000, 256, 128


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _script(stores, rng, n_ops):
    for k in range(n_ops):
        row = rng.normal(size=DIM).astype(np.float32)
        live = stores[0].live_ids()
        for st in stores:
            if k % 3 == 0:
                st.upsert(int(live[k % live.size]), row)
            elif k % 3 == 1:
                st.delete(int(live[(7 * k) % live.size]))
                st.append(row)
            else:
                st.append(row)


def _buffers(st):
    return [st.tiled_table(), *(st.quantized() or ())]


@pytest.mark.parametrize("precision", ["fp32", "int8", "int4"])
def test_card_store_equals_cpu_store_bytewise(card, precision):
    rows = np.random.default_rng(0).normal(size=(N_ROWS, DIM)).astype(
        np.float32)
    kw = dict(block=BLOCK, capacity_slack=1.5, precision=precision)
    gpu = DynamicTableStore(rows, device=card, **kw)
    cpu = DynamicTableStore(rows, device="cpu", **kw)
    ptrs = [b.data_ptr() for b in _buffers(gpu)]
    rng = np.random.default_rng(1)
    for _ in range(6):
        _script((gpu, cpu), rng, 10)
        assert gpu.flush_updates()["applied"] == \
            cpu.flush_updates()["applied"]
        for a, b in zip(_buffers(gpu), _buffers(cpu)):
            assert torch.equal(a.cpu(), b)
        np.testing.assert_array_equal(gpu.host_table(), cpu.host_table())
    assert [b.data_ptr() for b in _buffers(gpu)] == ptrs


def test_card_pq_store_equals_fresh_card_store(card):
    rows = np.random.default_rng(2).normal(size=(N_ROWS, DIM)).astype(
        np.float32)
    kw = dict(block=BLOCK, precision="pq", pq_subdims=8, device=card)
    st = DynamicTableStore(rows, capacity_slack=1.5, **kw)
    rng = np.random.default_rng(3)
    for _ in range(4):
        _script((st,), rng, 9)
        st.flush_updates()
        snap, ids = st.snapshot()
        fresh = DynamicTableStore(snap, ids=ids, capacity=st.capacity_rows,
                                  codebook=st.codebook(), **kw)
        for a, b in zip(_buffers(st), _buffers(fresh)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_card_store_engine_launches_over_the_store(card, precision):
    rng = np.random.default_rng(4)
    rows = (0.05 * rng.normal(size=(N_ROWS, DIM))).astype(np.float32)
    st = DynamicTableStore(rows, block=BLOCK, precision=precision,
                           device=card)
    eng = MIPSServeEngine(st, K=4, eps=0.1, delta=0.1, batch_size=2,
                          value_range=4.0)
    q = rng.normal(size=DIM).astype(np.float32)
    winner = st.append((2.0 * q / np.linalg.norm(q)).astype(np.float32))
    ops.reset_launch_counts()
    rid = eng.submit(q, now=0.0)
    eng.drain(now=0.0)
    ids, scores = eng.result(rid)
    assert ids[0] == winner
    assert ops.launch_counts()[f"fused_cascade_batched[{precision}]"] == 1
    exact = (st.host_table()[st._id2slot[winner]].astype(np.float64)
             @ q.astype(np.float64)) / DIM
    np.testing.assert_allclose(scores[0], exact, rtol=1e-4)


@pytest.mark.parametrize("precision", ["fp32", "int8", "int4", "pq"])
def test_card_page_round_trip_is_bytewise(card, precision):
    rng = np.random.default_rng(5)
    rows = rng.normal(size=(N_ROWS, DIM)).astype(np.float32)
    st = DynamicTableStore(rows, block=BLOCK, precision=precision,
                           pq_subdims=8, device=card)
    _script([st], rng, 30)
    st.flush_updates()
    _script([st], rng, 6)                 # staged across the round trip
    assert torch.from_numpy(st._host).is_pinned()
    before = [b.clone() for b in _buffers(st)]
    nbytes = st.device_bytes()
    assert nbytes == sum(b.numel() * b.element_size() for b in before)
    assert st.resident_bytes() == nbytes        # DIM is whole blocks
    torch.cuda.synchronize()
    alloc = torch.cuda.memory_allocated()
    st.page_out()
    torch.cuda.synchronize()
    assert alloc - torch.cuda.memory_allocated() >= nbytes
    assert st.device_bytes() == 0 and st.pending_updates > 0
    st.page_in()
    assert st.device_bytes() == nbytes
    for got, want in zip(_buffers(st), before):
        assert got.device.type == "cuda" and torch.equal(got, want)
    st.flush_updates()
    fresh = DynamicTableStore(*st.snapshot()[:1], ids=st.live_ids(),
                              capacity=st.capacity_rows, block=BLOCK,
                              precision=precision, pq_subdims=8,
                              codebook=st.codebook(), device=card)
    for got, want in zip(_buffers(st), _buffers(fresh)):
        assert torch.equal(got, want)


def test_card_registry_eviction_frees_the_table(card):
    rng = np.random.default_rng(6)
    reg = TableRegistry(lanes=4, device=card)
    cfg = TenantConfig(K=4, eps=0.1, delta=0.1, block=BLOCK,
                       precision="int8")
    st = reg.register("a", rng.normal(size=(N_ROWS, DIM)).astype(
        np.float32), cfg)
    execs, _ = reg.executors("a")
    Q = rng.normal(size=(4, DIM)).astype(np.float32)
    perm = np.arange(execs[0].plan.n_blocks)
    ids0, sc0, _, _ = execs[0].dispatch(Q, perm)
    del execs
    torch.cuda.synchronize()
    alloc = torch.cuda.memory_allocated()
    reg.evict("a")
    torch.cuda.synchronize()
    assert alloc - torch.cuda.memory_allocated() >= reg.table_bytes("a")
    assert not st.resident and reg.resident_bytes() == 0
    ops.reset_launch_counts()
    execs, page_s = reg.executors("a")
    assert page_s > 0.0 and reg.executor_builds("a") == {"new": 1,
                                                         "page_in": 1}
    ids1, sc1, _, _ = execs[0].dispatch(Q, perm)
    np.testing.assert_array_equal(ids0, ids1)
    np.testing.assert_array_equal(sc0, sc1)
    # the rebuild warms its one rung (no eps floor), then one dispatch
    assert ops.launch_counts()["fused_cascade_batched[int8]"] == 2
