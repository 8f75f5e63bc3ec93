"""The port's `bounded_me_decode` against the JAX package's, end to end.

Both get the same table, queries, plan and block permutation: the port
takes ``perm = jax.random.permutation(key, n_blocks)`` explicitly, the
JAX package draws it from ``key``.  The JAX side runs its jnp fallback
and its Pallas kernel (interpret mode); the port runs on the CPU, i.e.
its plain PyTorch cascade, with ``final_exact=True`` as the serving
engine calls it.  Ids must be equal; scores agree to rtol 1e-5 and atol
1e-6 * max|score| (fp32 sums in another order — the JAX package's own
fallback sums final scores in one exact rescore, its kernel by coverage
pulls).

The quantized tiers (int8, int4, pq) and adaptive early exit (hoeffding
and bernstein, on fp32 and int8) are held the same way — ids equal,
``rounds_used`` equal, scores to the fp32 tolerance (on the JAX side XLA
on the CPU fuses multiply-adds and divides by reciprocals, ROADMAP.md
queue 3) and bitwise to the numpy oracle on int8 — and the rescored
scores of ``final_exact`` are the exact mean products.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import boundedme_jax as bj
from repro.core.boundedme_jax import bounded_me_decode as jax_decode
from repro.core.boundedme_jax import make_plan as jax_make_plan
from repro.core.schedule import flatten_schedule
from repro.kernels import ops as jax_ops
from repro.kernels.ref import fused_cascade_ref
from repro_torch.convert import quantized_from_jax
from repro_torch.core import boundedme_torch as bt
from repro_torch.core import quantize as tq
from repro_torch.core.boundedme_torch import bounded_me_decode, make_plan
from repro_torch.kernels import ops


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_array_equal(got[~fin], want[~fin])
    scale = float(np.abs(want[fin]).max())
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5,
                               atol=1e-6 * scale)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("mode,n,N,K,n_valid", [
    ("row", 301, 700, 4, 290),
    ("coord", 301, 700, 4, 290),
    ("row", 1024, 256, 8, 1024),
    ("coord", 517, 384, 3, 500),
])
def test_decode_matches_jax(mode, n, N, K, n_valid, use_pallas):
    rng = np.random.default_rng(n + N)
    V = (0.02 * rng.normal(size=(n, N))).astype(np.float32)
    Q = rng.normal(size=(4, N)).astype(np.float32)
    kw = dict(K=K, eps=0.3, delta=0.1, value_range=2.0 * float(
        np.abs(V).max()), block=128, pull_mode=mode, coord_block=64)
    jplan, plan = jax_make_plan(n, N, **kw), make_plan(n, N, **kw)
    key = jax.random.PRNGKey(7)
    perm = np.array(jax.random.permutation(key, plan.n_blocks))
    jids, jvals = jax_decode(V, Q, key, plan=jplan, use_pallas=use_pallas,
                             n_valid=n_valid)
    ids, vals = bounded_me_decode(V, Q, torch.from_numpy(perm), plan=plan,
                                  n_valid=n_valid, device="cpu")
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    _close(vals.numpy(), jvals)
    # final_exact: the scores are the exact mean products of the ids
    exact = np.einsum("bkn,bn->bk", V[ids.numpy()].astype(np.float64),
                      Q.astype(np.float64)) / N
    np.testing.assert_allclose(vals.numpy(), exact, rtol=1e-4, atol=1e-7)


# ---- quantized tiers ------------------------------------------------------

def _artifacts(V, jplan):
    """The JAX package's table artifacts of a quantized plan."""
    Vp, _ = bj._pad_operands(jnp.asarray(V), jnp.zeros((V.shape[1],)),
                             jplan)
    return bj._quantize_table(bj._tile_major(Vp, jplan), jplan)


@pytest.mark.parametrize("final_exact", [True, False])
@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("precision", ["int8", "int4", "pq"])
@pytest.mark.parametrize("mode", ["row", "coord"])
def test_decode_tiers_match_jax(mode, precision, use_pallas, final_exact):
    """int8 and int4 quantize the table themselves (bitwise the JAX
    package's codes); pq gets the JAX package's codebook and codes
    through `quantized_from_jax`, and both plans the same quant_err."""
    n, N, K, n_valid = 301, 700, 4, 290
    rng = np.random.default_rng(n + N)
    V = (0.02 * rng.normal(size=(n, N))).astype(np.float32)
    Q = rng.normal(size=(4, N)).astype(np.float32)
    kw = dict(K=K, eps=0.3, delta=0.1, value_range=2.0 * float(
        np.abs(V).max()), block=128, pull_mode=mode, coord_block=64,
        precision=precision, quant_err=1e-3 if precision == "pq" else None)
    jplan, plan = jax_make_plan(n, N, **kw), make_plan(n, N, **kw)
    quant = _artifacts(V, jplan) if precision == "pq" else None
    key = jax.random.PRNGKey(7)
    perm = np.array(jax.random.permutation(key, plan.n_blocks))
    jids, jvals = jax_decode(V, Q, key, plan=jplan, use_pallas=use_pallas,
                             n_valid=n_valid, k_out=6, quantized=quant,
                             final_exact=final_exact)
    ids, vals = bounded_me_decode(
        V, Q, torch.from_numpy(perm), plan=plan, n_valid=n_valid, k_out=6,
        final_exact=final_exact, device="cpu",
        quantized=None if quant is None else quantized_from_jax(
            [np.asarray(a) for a in quant], precision))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    _close(vals.numpy(), jvals)
    if final_exact:   # the fp32 rescore makes the scores exact
        exact = np.einsum("bkn,bn->bk", V[ids.numpy()].astype(np.float64),
                          Q.astype(np.float64)) / N
        np.testing.assert_allclose(vals.numpy(), exact, rtol=1e-4,
                                   atol=1e-7)


# ---- adaptive early exit ------------------------------------------------

# (n, N, K, block, mode, n_valid, k_out, B): planted rows make queries
# certify at different rounds — across the grid every round from the
# first to none at all (rounds_used == n_rounds) occurs
ADAPTIVE_CASES = [
    (400, 512, 3, 64, "coord", 390, 5, 4),
    (203, 300, 3, 64, "row", 190, 5, 4),
    (203, 300, 3, 64, "coord", 203, 3, 4),
    (96, 512, 5, 64, "row", 3, 7, 2),          # 3 live rows < k_out
]


def _planted(n, N, B, seed):
    rng = np.random.default_rng(seed)
    V = rng.normal(size=(n, N)).astype(np.float32)
    Q = rng.normal(size=(B, N)).astype(np.float32)
    for b, strength in enumerate([0.0, 0.3, 0.6, 1.5][:B]):
        V[rng.choice(n, 3, replace=False)] += strength * Q[b]
    return V, Q


def _adaptive_plans(n, N, K, block, mode, precision, bound):
    kw = dict(K=K, eps=4.0, delta=0.1, value_range=8.0, block=block,
              pull_mode=mode, coord_block=32, precision=precision,
              bound=bound)
    return jax_make_plan(n, N, **kw), make_plan(n, N, **kw)


@pytest.mark.parametrize("bound", ["hoeffding", "bernstein"])
@pytest.mark.parametrize("precision", ["fp32", "int8"])
@pytest.mark.parametrize("n,N,K,block,mode,n_valid,k_out,B", ADAPTIVE_CASES)
def test_adaptive_cascade_matches_jax_kernel_and_oracle(
        n, N, K, block, mode, n_valid, k_out, B, precision, bound):
    """The plain cascade with early exit on the very operands of the JAX
    package's interpret-mode kernel and its numpy oracle: rounds_used and
    ids equal; scores bitwise the oracle's on int8 (fp32 tolerance
    against the kernel, see tests/test_torch_cascade.py), within the fp32
    tolerance on fp32."""
    V, Q = _planted(n, N, B, seed=n + K)
    jplan, plan = _adaptive_plans(n, N, K, block, mode, precision, bound)
    perm = torch.from_numpy(np.array(jax.random.permutation(
        jax.random.PRNGKey(n), plan.n_blocks)))
    V4 = bt.tile_table(V, plan, "cpu")
    _, Qp = bt._pad_operands(None, torch.from_numpy(Q), plan)
    Qb = Qp.reshape(B, plan.n_blocks, plan.block).contiguous()
    slotcode, rmeta, bpos, t_final, n_final = bt.schedule_operands(
        plan.schedule, False, torch.device("cpu"))
    cols = perm[bpos].to(torch.int32).expand(B, -1).contiguous()
    cert = bt.cert_operand(plan.schedule, torch.device("cpu"))
    tkw = {}
    if precision == "int8":
        V4, vscale = tq.quantize_tiles(V4)
        Qb, qscale = tq.quantize_blocks(Qb)
        tkw = dict(vscale=vscale, qscale=qscale)
    kw = dict(n_arms=plan.n, K=plan.K, t_final=t_final, n_final=n_final,
              k_out=k_out, n_valid=n_valid, k_cert=plan.K,
              track_var=bound == "bernstein")
    args = (V4, Qb, slotcode, rmeta, cols)
    ids, vals, rused = ops.fused_cascade_batched(*args, cert=cert, **kw,
                                                 **tkw)
    J = lambda t: jnp.asarray(t.numpy())   # noqa: E731
    jids, jvals, jrused = jax_ops.fused_cascade_batched(
        *(J(t) for t in args), cert=J(cert), **kw,
        **{k: J(v) for k, v in tkw.items()})
    np.testing.assert_array_equal(rused.numpy(), np.asarray(jrused))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    _close(vals.numpy(), jvals)
    flat = flatten_schedule(jplan.schedule)
    for b in range(B):
        okw = {k: (v[b] if k == "qscale" else v).numpy()
               for k, v in tkw.items()}
        oids, ovals, orused = fused_cascade_ref(
            V4.numpy(), Qb[b].numpy(), flat, cols[b].numpy(),
            n_arms=plan.n, K=k_out, n_valid=n_valid, cert=cert.numpy(),
            k_cert=plan.K, **okw)
        assert int(rused[b]) == orused
        np.testing.assert_array_equal(ids[b].numpy(), oids)
        if precision == "int8":
            np.testing.assert_array_equal(vals[b].numpy(), ovals)
        else:
            _close(vals[b].numpy(), ovals)
    assert all(1 <= r <= len(plan.schedule.rounds) for r in rused.tolist())


@pytest.mark.parametrize("bound", ["hoeffding", "bernstein"])
@pytest.mark.parametrize("precision", ["fp32", "int8"])
@pytest.mark.parametrize("n,N,K,block,mode,n_valid,k_out,B",
                         ADAPTIVE_CASES[:2])
def test_adaptive_decode_matches_jax_fallback(
        n, N, K, block, mode, n_valid, k_out, B, precision, bound):
    V, Q = _planted(n, N, B, seed=n + K)
    jplan, plan = _adaptive_plans(n, N, K, block, mode, precision, bound)
    key = jax.random.PRNGKey(n)
    perm = np.array(jax.random.permutation(key, plan.n_blocks))
    jids, jvals, jrused = jax_decode(V, Q, key, plan=jplan,
                                     use_pallas=False, n_valid=n_valid,
                                     k_out=k_out, adaptive=True)
    ids, vals, rused = bounded_me_decode(V, Q, perm, plan=plan,
                                         n_valid=n_valid, k_out=k_out,
                                         adaptive=True, device="cpu")
    assert rused.dtype == torch.int32 and rused.shape == (B,)
    np.testing.assert_array_equal(rused.numpy(), np.asarray(jrused))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    _close(vals.numpy(), jvals)
    live = np.isfinite(vals.numpy())
    exact = np.einsum("bkn,bn->bk", V[ids.numpy()].astype(np.float64),
                      Q.astype(np.float64)) / N
    np.testing.assert_allclose(vals.numpy()[live], exact[live], rtol=1e-4,
                               atol=1e-7)
