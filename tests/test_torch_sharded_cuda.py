"""Sharded serving on the card (``cuda`` marker; skips without one).

A mesh that repeats ``cuda:0`` holds every tier of the sharded decode
against its per-shard plain versions (the same shard tables, artifacts,
perm and live counts, merged by the same rule): ids equal, the int8 and
int4 scores and ``rounds_used (B, S)`` bitwise, fp32 and pq to rtol
1e-5; kernel 1 launches once per shard.  The sharded store written on
the card is bytewise the same store on the CPU after every flush.  A
one-device call on a card that is not the current one launches there
and answers as on the current card.  The cases that need two cards skip
unless they find them.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import boundedme_torch as bt
from repro_torch.distributed.sharding import (Mesh, make_shard_plan,
                                              shard_valid_counts,
                                              sharded_decode_tiled)
from repro_torch.distributed.specs import serving_table_sharding
from repro_torch.kernels import ops, ref
from repro_torch.launch.engine import CascadeExecutor
from repro_torch.store import ShardedTableStore

pytestmark = pytest.mark.cuda

N_ROWS, DIM, BLOCK = 1003, 256, 128


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _plain(monkeypatch):
    """Send CUDA tensors to the plain versions for the reference."""
    monkeypatch.setattr(ops, "fused_cascade_batched_cuda",
                        ref.fused_cascade_batched_ref)


def _rows(n=N_ROWS, seed=0):
    return (0.02 * np.random.default_rng(seed).normal(size=(n, DIM))
            ).astype(np.float32)


@pytest.mark.parametrize("S", [3, 4])
@pytest.mark.parametrize("precision,adaptive", [
    ("fp32", False), ("int8", False), ("int4", False), ("pq", False),
    ("fp32", True), ("int8", True)])
def test_card_sharded_decode_matches_plain_per_shard(card, precision,
                                                     adaptive, S,
                                                     monkeypatch):
    V = _rows()
    Q = np.random.default_rng(1).normal(size=(4, DIM)).astype(np.float32)
    kw = dict(K=4, eps=0.3, delta=0.1, block=BLOCK, precision=precision,
              value_range=2.0 * float(np.abs(V).max()),
              bound="bernstein" if adaptive else "hoeffding",
              quant_err=1e-3 if precision == "pq" else None)
    mesh = Mesh([card] * S)
    plan, n_local, _, k_out = make_shard_plan(N_ROWS, DIM, S, **kw)
    shards = serving_table_sharding(V, mesh, plan)
    quant = (None if precision == "fp32"
             else [bt.quantize_table(V4, plan) for V4 in shards])
    nv = shard_valid_counts(N_ROWS - 11, S, n_local)
    perm = bt.draw_perms(plan.n_blocks)
    args = dict(mesh=mesh, plan=plan, K=4, k_out=k_out, n_valid=nv,
                quantized=quant, adaptive=adaptive, return_candidates=True)
    ops.reset_launch_counts()
    got = sharded_decode_tiled(shards, Q, perm, **args)
    assert ops.launch_counts()["fused_cascade_batched"] == S
    _plain(monkeypatch)
    want = sharded_decode_tiled(shards, Q, perm, **args)
    bitwise = precision in ("int8", "int4")
    assert torch.equal(got[0].cpu(), want[0].cpu())
    if adaptive:
        assert torch.equal(got[3].cpu(), want[3].cpu())
    for g, w in ((got[1], want[1]), (got[-1]["scores"], want[-1]["scores"])):
        g, w = g.cpu(), w.cpu()
        if bitwise:
            assert torch.equal(g, w)
        else:
            fin = torch.isfinite(w)
            assert torch.equal(torch.isfinite(g), fin)
            torch.testing.assert_close(g[fin], w[fin], rtol=1e-5, atol=0)


@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_card_sharded_store_equals_cpu_store(card, precision):
    """Churn on a sharded store on the card and on the CPU: bytewise the
    same shards after every flush; an executor over the card store
    launches once per shard and answers live slots."""
    rows = _rows(600)
    gpu = ShardedTableStore(rows, mesh=Mesh([card] * 3), block=BLOCK)
    cpu = ShardedTableStore(rows, mesh=Mesh(["cpu"] * 3), block=BLOCK)
    ex = CascadeExecutor(gpu, K=3, eps=0.5, precision=precision)
    rng = np.random.default_rng(2)
    for burst in range(5):
        for k in range(12):
            row = rng.normal(size=DIM).astype(np.float32)
            live = cpu.live_ids()
            for st in (gpu, cpu):
                if k % 3 == 0:
                    st.upsert(int(live[k % live.size]), row)
                elif k % 3 == 1:
                    st.delete(int(live[(5 * k) % live.size]))
                    st.append(row)
                else:
                    st.append(row)
        assert gpu.flush_updates()["applied"] == \
            cpu.flush_updates()["applied"]
        for a, b in zip(gpu.tiled_shards(), cpu.tiled_shards()):
            assert a.device.type == "cuda" and torch.equal(a.cpu(), b)
        np.testing.assert_array_equal(gpu.n_valid_vector(),
                                      cpu.n_valid_vector())
        ops.reset_launch_counts()
        ids, _, _, _ = ex.dispatch(_rows(4, seed=burst),
                                   bt.draw_perms(ex.plan.n_blocks))
        assert ops.launch_counts()["fused_cascade_batched"] == 3
        assert gpu.live_mask()[ids].all()


def test_card_decode_on_another_card_matches_the_current_one(card):
    """`decode_tiled` on a card that is not the current one launches on
    that card (its wrapper makes it current) and answers bitwise as on
    the current card; the current card stays current."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    other = torch.device("cuda", 1 - card.index)
    V = _rows(64)
    plan = bt.make_plan(64, DIM, K=2, block=BLOCK)
    perm = bt.draw_perms(plan.n_blocks)
    ops.reset_launch_counts()
    there = bt.decode_tiled(bt.tile_table(V, plan, other), V[:2], perm,
                            plan=plan)
    here = bt.decode_tiled(bt.tile_table(V, plan, card), V[:2], perm,
                           plan=plan)
    assert ops.launch_counts()["fused_cascade_batched"] == 2
    assert torch.cuda.current_device() == card.index
    assert there[0].device == other
    for a, b in zip(there, here):
        assert torch.equal(a.cpu(), b.cpu())


def test_card_two_cards_shard_and_match_one_card(card):
    """Shards on two cards, each launched under its own card's guard,
    answer bitwise as the same shards on one card."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    V = _rows()
    Q = np.random.default_rng(3).normal(size=(4, DIM)).astype(np.float32)
    perm = bt.draw_perms(-(-DIM // BLOCK))
    kw = dict(K=4, eps=0.3, delta=0.1, block=BLOCK, value_range=1.0)
    from repro_torch.distributed.sharding import sharded_bounded_me_decode
    two = sharded_bounded_me_decode(
        V, Q, perm, mesh=Mesh([torch.device("cuda", 0),
                               torch.device("cuda", 1)]), **kw)
    one = sharded_bounded_me_decode(V, Q, perm, mesh=Mesh([card] * 2), **kw)
    for a, b in zip(two, one):
        assert torch.equal(a.cpu(), b.cpu())
