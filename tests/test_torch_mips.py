"""The port's single-query and per-query-key library API against the JAX
package's.

``mips_topk``, ``nns_topk``, ``bounded_me_blocked`` and
``bounded_me_batched`` of the port run on the CPU (the plain PyTorch
versions of the fused cascade) and are held against the same functions
of the JAX package, in both of its forms: ``use_pallas=True`` (its
single-query or batched Pallas kernel, interpret mode) and
``use_pallas=False`` (its ``lax.scan`` fallback).  Both get the same
table, query and block permutation: the port takes ``perm =
jax.random.permutation(key, n_blocks)`` explicitly, the JAX package draws
it from ``key``.

Ids must be equal on every tier and pull mode; adaptive ``rounds_used``
equal.  Scores agree to rtol 1e-5 and atol 1e-6 * max|score|: fp32 sums
taken in another order, and on the JAX side XLA on the CPU fuses
multiply-adds (ROADMAP.md queue 3).  Without ``final_exact`` the int8 and
int4 scores are bitwise the numpy oracle's (`repro.kernels.ref.
fused_cascade_ref`) times the padding rescale.  ``nns_topk`` scores are
held to the same tolerance: its |v|^2 column sums in another order.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import boundedme_jax as bj
from repro.core import mips as jmips
from repro.core.schedule import flatten_schedule
from repro.data import synthetic as jsynth
from repro.kernels.ref import fused_cascade_ref as oracle
from repro_torch.core import boundedme_torch as bt
from repro_torch.core import mips
from repro_torch.core import quantize as tq
from repro_torch.data import synthetic
from repro_torch.kernels import ops

N_ROWS, N_COLS = 301, 700      # ragged: n % 8 != 0, N % block != 0


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    scale = float(np.abs(want[fin]).max())
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5,
                               atol=1e-6 * scale)


def _data(n=N_ROWS, N=N_COLS, seed=3, B=None):
    rng = np.random.default_rng(seed)
    V = (0.02 * rng.normal(size=(n, N))).astype(np.float32)
    q = rng.normal(size=(N,) if B is None else (B, N)).astype(np.float32)
    return V, q


def _perm(key, n_blocks):
    return torch.from_numpy(np.array(jax.random.permutation(key, n_blocks)))


def _knobs(V, q, precision, mode, **extra):
    vr = 2.0 * float(np.abs(V).max()) * float(np.abs(q).max())
    return dict(K=4, eps=0.3, delta=0.1, value_range=vr, block=128,
                pull_mode=mode, coord_block=64, precision=precision,
                quant_err=1e-3 if precision == "pq" else None, **extra)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("final_exact", [True, False])
@pytest.mark.parametrize("mode", ["row", "coord"])
@pytest.mark.parametrize("precision", ["fp32", "int8", "int4", "pq"])
def test_bounded_me_blocked_matches_jax(precision, mode, final_exact,
                                        use_pallas):
    V, q = _data()
    kw = _knobs(V, q, precision, mode, final_exact=final_exact)
    key = jax.random.PRNGKey(7)
    jids, jvals, jplan = bj.bounded_me_blocked(V, q, key,
                                               use_pallas=use_pallas, **kw)
    ids, vals, plan = bt.bounded_me_blocked(
        V, q, _perm(key, jplan.n_blocks), device="cpu", **kw)
    assert (plan.n_blocks, plan.block, plan.pull_mode) == (
        jplan.n_blocks, jplan.block, jplan.pull_mode)
    assert [dataclasses.astuple(r) for r in plan.schedule.rounds] == [
        dataclasses.astuple(r) for r in jplan.schedule.rounds]
    assert ids.dtype == torch.int32 and ids.shape == vals.shape == (4,)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    _close(vals.numpy(), jvals)
    exact = V[ids.numpy()].astype(np.float64) @ q.astype(np.float64) / \
        V.shape[1]
    if final_exact:
        np.testing.assert_allclose(vals.numpy(), exact, rtol=1e-4, atol=1e-7)
    elif precision in ("int8", "int4"):
        # bitwise the numpy oracle's scores times the padding rescale
        V4 = bt.tile_table(V, plan, "cpu")
        Vq, vscale = (tq.quantize_tiles_int4(V4) if precision == "int4"
                      else tq.quantize_tiles(V4))
        _, qp = bt._pad_operands(None, torch.from_numpy(q), plan)
        q8, qscale = tq.quantize_blocks(qp.reshape(plan.n_blocks,
                                                   plan.block))
        flat = flatten_schedule(jplan.schedule)
        cols = _perm(key, plan.n_blocks).numpy()[flat.bpos]
        _, ovals = oracle(Vq.numpy(), q8.numpy(), flat, cols,
                          n_arms=plan.n, K=4, vscale=vscale.numpy(),
                          qscale=qscale.numpy(),
                          packed_int4=precision == "int4")
        scale = np.float32(plan.n_blocks * plan.block / plan.N)
        np.testing.assert_array_equal(vals.numpy(), ovals * scale)


@pytest.mark.parametrize("bound", ["hoeffding", "bernstein"])
@pytest.mark.parametrize("precision", ["fp32", "int8"])
@pytest.mark.parametrize("mode", ["row", "coord"])
def test_bounded_me_blocked_adaptive_matches_jax(mode, precision, bound):
    rng = np.random.default_rng(11)
    V = rng.normal(size=(203, 300)).astype(np.float32)
    q = rng.normal(size=300).astype(np.float32)
    V[rng.choice(203, 3, replace=False)] += 0.6 * q     # certifiable
    kw = dict(K=3, eps=4.0, delta=0.1, value_range=8.0, block=64,
              pull_mode=mode, coord_block=32, precision=precision,
              bound=bound, adaptive=True, final_exact=True)
    key = jax.random.PRNGKey(5)
    for use_pallas in (False, True):
        jids, jvals, jrused, jplan = bj.bounded_me_blocked(
            V, q, key, use_pallas=use_pallas, **kw)
        ids, vals, rused, plan = bt.bounded_me_blocked(
            V, q, _perm(key, jplan.n_blocks), device="cpu", **kw)
        assert rused.dtype == torch.int32 and rused.shape == ()
        assert int(rused) == int(jrused)
        assert 1 <= int(rused) <= len(plan.schedule.rounds)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
        _close(vals.numpy(), jvals)


@pytest.mark.parametrize("n,N,K", [(301, 700, 4), (2000, 4096, 5)])
def test_hybrid_pull_mode_matches_jax(n, N, K):
    V, q = _data(n, N, seed=n)
    kw = dict(_knobs(V, q, "fp32", "hybrid"), K=K, final_exact=True)
    key = jax.random.PRNGKey(1)
    jids, jvals, jplan = bj.bounded_me_blocked(V, q, key, **kw)
    ids, vals, plan = bt.bounded_me_blocked(
        V, q, _perm(key, jplan.n_blocks), device="cpu", **kw)
    assert plan.pull_mode == jplan.pull_mode
    assert plan.block == jplan.block
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    _close(vals.numpy(), jvals)


def test_pq_without_quant_err_calibrates_on_the_table():
    V, q = _data(160, 256, seed=2)
    kw = dict(K=3, eps=0.3, delta=0.1, value_range=1.0, block=64,
              precision="pq", final_exact=True)
    ids, vals, plan = bt.bounded_me_blocked(V, q, device="cpu", **kw)
    want = bt.measured_plan_quant_err(V, precision="pq", block=64,
                                      device="cpu")
    assert plan.quant_err == want > 0
    exact = V[ids.numpy()].astype(np.float64) @ q.astype(np.float64) / 256
    np.testing.assert_allclose(vals.numpy(), exact, rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("final_exact", [True, False])
@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_mips_topk_matches_jax(precision, final_exact):
    V, q = _data()
    kw = dict(K=4, eps=0.3, delta=0.1, block=128, precision=precision,
              final_exact=final_exact)
    jids, jvals = jmips.mips_topk(V, q, use_pallas=True, **kw)
    # the JAX package's default key is PRNGKey(0)
    n_blocks = -(-N_COLS // 128)
    ids, vals = mips.mips_topk(V, q, perm=_perm(jax.random.PRNGKey(0),
                                                n_blocks),
                               device="cpu", **kw)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    _close(vals.numpy(), jvals)
    # without a perm the port draws one from a generator seeded 0
    again = mips.mips_topk(V, q, device="cpu", **kw)
    g = torch.Generator().manual_seed(0)
    drawn = mips.mips_topk(V, q, device="cpu", perm=torch.randperm(
        n_blocks, generator=g), **kw)
    assert all(torch.equal(a, b) for a, b in zip(again, drawn))


def test_mips_topk_exact_and_unknown_method():
    V, q = _data()
    jids, jvals = jmips.mips_topk(V, q, 5, method="exact")
    ids, vals = mips.mips_topk(V, q, 5, method="exact", device="cpu")
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    _close(vals.numpy(), jvals)
    with pytest.raises(ValueError, match="unknown method"):
        mips.mips_topk(V, q, method="lsh", device="cpu")
    with pytest.raises(ValueError, match="unknown method"):
        jmips.mips_topk(V, q, method="lsh")


@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_nns_topk_matches_jax(precision):
    rng = np.random.default_rng(4)
    V = rng.normal(size=(203, 300)).astype(np.float32)
    q = (V[17] + 0.1 * rng.normal(size=300)).astype(np.float32)
    kw = dict(K=3, eps=0.3, delta=0.1, block=64, precision=precision,
              final_exact=True)
    jids, jvals = jmips.nns_topk(V, q, use_pallas=False, **kw)
    n_blocks = -(-301 // 64)          # the augmented width N + 1
    ids, vals = mips.nns_topk(V, q, perm=_perm(jax.random.PRNGKey(0),
                                               n_blocks),
                              device="cpu", **kw)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    _close(vals.numpy(), jvals)
    assert int(ids[0]) == 17
    d2 = ((V.astype(np.float64) - q) ** 2).sum(1)
    assert int(ids[0]) == int(np.argmin(d2))


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("precision", ["fp32", "int8", "int4", "pq"])
def test_bounded_me_batched_matches_jax_and_single_calls(precision,
                                                         use_pallas):
    V, Q = _data(B=3)
    kw = _knobs(V, Q, precision, "row")
    jplan = bj.make_plan(*V.shape, **kw)
    plan = bt.make_plan(*V.shape, **kw)
    keys = jax.random.split(jax.random.PRNGKey(9), 3)
    perms = torch.stack([_perm(k, plan.n_blocks) for k in keys])
    jids, jvals = bj.bounded_me_batched(V, Q, keys, plan=jplan,
                                        final_exact=True,
                                        use_pallas=use_pallas)
    before = ops.launch_counts()
    ids, vals = bt.bounded_me_batched(V, Q, perms, plan=plan,
                                      final_exact=True, device="cpu")
    assert ops.launch_counts() == before       # the plain version ran
    assert ids.shape == vals.shape == (3, 4)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    _close(vals.numpy(), jvals)
    for b in range(3):
        sids, svals, _ = bt.bounded_me_blocked(V, Q[b], perms[b], plan=plan,
                                               final_exact=True,
                                               device="cpu")
        assert torch.equal(sids, ids[b])
        _close(svals.numpy(), vals[b].numpy())


def test_bounded_me_batched_adaptive_and_drawn_perms():
    rng = np.random.default_rng(12)
    V = rng.normal(size=(203, 300)).astype(np.float32)
    Q = rng.normal(size=(4, 300)).astype(np.float32)
    for b, strength in enumerate([0.0, 0.3, 0.6, 1.5]):
        V[rng.choice(203, 3, replace=False)] += strength * Q[b]
    kw = dict(K=3, eps=4.0, delta=0.1, value_range=8.0, block=64,
              bound="bernstein")
    jplan, plan = bj.make_plan(203, 300, **kw), bt.make_plan(203, 300, **kw)
    keys = jax.random.split(jax.random.PRNGKey(2), 4)
    perms = torch.stack([_perm(k, plan.n_blocks) for k in keys])
    jids, _, jrused = bj.bounded_me_batched(V, Q, keys, plan=jplan,
                                            final_exact=True, adaptive=True)
    ids, vals, rused = bt.bounded_me_batched(V, Q, perms, plan=plan,
                                             final_exact=True,
                                             adaptive=True, device="cpu")
    np.testing.assert_array_equal(rused.numpy(), np.asarray(jrused))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    # without perms: one randperm per query from a generator seeded 0
    g = torch.Generator().manual_seed(0)
    drawn = torch.stack([torch.randperm(plan.n_blocks, generator=g)
                         for _ in range(4)])
    a = bt.bounded_me_batched(V, Q, plan=plan, device="cpu")
    b = bt.bounded_me_batched(V, Q, drawn, plan=plan, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError, match="perms must be"):
        bt.bounded_me_batched(V, Q, perms[0], plan=plan, device="cpu")
    with pytest.raises(ValueError, match="per-query perms"):
        bt.bounded_me_batched(V, Q, perms[:2], plan=plan, device="cpu")
    bad = perms.clone()
    bad[1, 0] = bad[1, 1]
    with pytest.raises(ValueError, match="permutation"):
        bt.bounded_me_batched(V, Q, bad, plan=plan, device="cpu")


def test_default_value_range_and_table_max_cache():
    V, q = _data()
    want = jmips.default_value_range(V, q)
    assert mips.default_value_range(V, q) == want
    T = torch.from_numpy(V.copy())
    assert mips.default_value_range(T, torch.from_numpy(q)) == want
    vmax = mips.table_abs_max(T)
    # a repeat call is served from the cache: a write that bypasses the
    # version counter is not seen ...
    T.data.mul_(2.0)
    assert mips.table_abs_max(T) == vmax
    # ... and an in-place edit of the table is
    T.mul_(0.5)
    T[0, 0] = 7.0
    assert mips.table_abs_max(T) == 7.0
    assert mips.default_value_range(T, torch.ones(N_COLS)) == 14.0


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    V, q = _data(64, 32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mips.mips_topk(V, q)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mips.mips_topk(V, q, method="exact")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mips.nns_topk(V, q)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bt.bounded_me_blocked(V, q)
    plan = bt.make_plan(64, 32, K=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bt.bounded_me_batched(V, q[None], plan=plan)


@pytest.mark.parametrize("name,args", [
    ("gaussian_dataset", (50, 33)), ("uniform_dataset", (50, 33)),
    ("adversarial_dataset", (20, 40)), ("mf_dataset", (64, 48))])
@pytest.mark.parametrize("seed", [0, 5])
def test_synthetic_generators_bitwise(name, args, seed):
    got = getattr(synthetic, name)(*args, seed=seed)
    want = getattr(jsynth, name)(*args, seed=seed)
    for g, w in zip(*(x if isinstance(x, tuple) else (x,)
                      for x in (got, want))):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
