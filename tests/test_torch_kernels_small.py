"""Plain versions of the single-query cascade, the gathered tile-dot and
the blocked matvec against the JAX package's kernels.

On CPU tensors the port's entry points `repro_torch.kernels.ops.
fused_cascade`, `gather_block_dot` and `blocked_matvec` run the plain
PyTorch versions.  On the same operands they must reproduce the JAX
package's Pallas kernels (interpret mode on the CPU) and its oracles
(`repro.kernels.ref`):

  * single-query cascade, every tier, row and coord mode, ``k_out > K``
    and fewer live rows than ``k_out``: ids equal to the interpret-mode
    kernel and to the numpy oracle; int8 and int4 scores bitwise equal to
    the oracle (every float op one IEEE operation in both; the JAX
    kernel fuses multiply-adds on the CPU, ROADMAP.md queue 3), fp32 and
    pq scores to rtol 1e-5 and atol 1e-6 * max|score| (sums in another
    order); adaptive ``rounds_used`` equal.  It is also bitwise a batch
    of one through the batched plain version.
  * gathered tile-dot and blocked matvec, f32 and bf16: within rtol 1e-5
    and atol 1e-5 * max|out| of the interpret-mode kernels — the products
    are exact in f32 (bf16 widened), only the order of the sums within a
    block or slab differs, and both add blocks and slabs in order — and
    the indivisible-shape ``ValueError`` where the JAX kernel raises it.

The CUDA kernels themselves run only on the card
(``tests/test_torch_kernel_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.boundedme_jax import make_plan as jax_make_plan
from repro.core.schedule import flatten_schedule
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.kernels.blocked_matvec import blocked_matvec_pallas
from repro.kernels.gather_dot import gather_block_dot_pallas
from repro.kernels.ref import fused_cascade_ref as oracle
from repro_torch.core import boundedme_torch as bt
from repro_torch.core import quantize as tq
from repro_torch.kernels import blocked_matvec as bmv
from repro_torch.kernels import fused_cascade as fc
from repro_torch.kernels import gather_dot as gd
from repro_torch.kernels import ops, ref

# (n, N, K, block, mode, n_valid, k_out, final_coverage, duplicate rows)
CASES = [
    (203, 300, 3, 64, "row", 190, 5, True, False),     # n_valid < n
    (203, 300, 3, 64, "coord", 203, 3, False, False),  # coord mode
    (96, 512, 5, 64, "row", 3, 7, False, False),       # 3 live < k_out
    (160, 256, 4, 64, "row", 160, 8, True, True),      # ties, k_out > K
]


def _close(got, want, rtol=1e-5, atol_scale=1e-6):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_array_equal(got[~fin], want[~fin])
    scale = float(np.abs(want[fin]).max()) if fin.any() else 0.0
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol,
                               atol=atol_scale * scale)


def _single_operands(n, N, K, block, mode, cover, dup, tier, seed,
                     bound="hoeffding", eps=0.5):
    """One query's cascade operands, built and quantized by the port:
    ``(args, kw, jplan, plan)``."""
    rng = np.random.default_rng(seed)
    V = rng.normal(size=(n, N)).astype(np.float32)
    if dup:              # exact ties between rows of different tiles
        V[n // 2:n // 2 + 10] = V[:10]
    q = rng.normal(size=N).astype(np.float32)
    if bound != "hoeffding" or eps > 1:      # planted winners certify
        V[rng.choice(n, 3, replace=False)] += 0.6 * q
    pkw = dict(K=K, eps=eps, delta=0.1, value_range=8.0, block=block,
               pull_mode=mode, coord_block=32, bound=bound)
    jplan, plan = jax_make_plan(n, N, **pkw), bt.make_plan(n, N, **pkw)
    V4 = bt.tile_table(V, plan, "cpu")
    _, qp = bt._pad_operands(None, torch.from_numpy(q), plan)
    qb = qp.reshape(plan.n_blocks, plan.block).contiguous()
    slotcode, rmeta, bpos, t_final, n_final = bt.schedule_operands(
        plan.schedule, cover, torch.device("cpu"))
    perm = torch.from_numpy(np.array(jax.random.permutation(
        jax.random.PRNGKey(n), plan.n_blocks)))
    cols = perm[bpos].to(torch.int32).contiguous()
    kw = dict(n_arms=plan.n, K=plan.K, t_final=t_final, n_final=n_final)
    if tier == "pq":
        cb = tq.pq_train(V4, n_codes=16, subdims=8)
        V4, kw["codebook"] = tq.pq_encode(V4, cb), cb
    elif tier in ("int8", "int4"):
        V4, kw["vscale"] = (tq.quantize_tiles_int4(V4) if tier == "int4"
                            else tq.quantize_tiles(V4))
        qb, kw["qscale"] = tq.quantize_blocks(qb)
        kw["packed_int4"] = tier == "int4"
    return (V4, qb, slotcode, rmeta, cols), kw, jplan, plan


def _jax(t):
    return jnp.asarray(t.numpy()) if torch.is_tensor(t) else t


def _oracle_kw(kw):
    return {k: (v.numpy() if torch.is_tensor(v) else v)
            for k, v in kw.items()
            if k in ("vscale", "qscale", "codebook", "packed_int4")}


@pytest.mark.parametrize("tier", ["fp32", "int8", "int4", "pq"])
@pytest.mark.parametrize("n,N,K,block,mode,n_valid,k_out,cover,dup", CASES)
def test_single_cascade_matches_jax_kernel_and_oracle(
        tier, n, N, K, block, mode, n_valid, k_out, cover, dup):
    args, kw, jplan, _ = _single_operands(n, N, K, block, mode, cover, dup,
                                          tier, seed=n + K)
    ids, vals = ops.fused_cascade(*args, k_out=k_out, n_valid=n_valid, **kw)
    assert ids.dtype == torch.int32 and vals.dtype == torch.float32
    assert ids.shape == vals.shape == (k_out,)

    jids, jvals = jax_ops.fused_cascade(
        *(_jax(t) for t in args), k_out=k_out, n_valid=n_valid,
        **{k: _jax(v) for k, v in kw.items()})
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    _close(vals.numpy(), jvals)

    flat = flatten_schedule(jplan.schedule, final_coverage=cover)
    oids, ovals = oracle(args[0].numpy(), args[1].numpy(), flat,
                         args[4].numpy(), n_arms=n, K=k_out,
                         n_valid=n_valid, **_oracle_kw(kw))
    np.testing.assert_array_equal(ids.numpy(), oids)
    if tier in ("int8", "int4"):
        np.testing.assert_array_equal(vals.numpy(), ovals)
    else:
        _close(vals.numpy(), ovals)

    # the single-query form is a batch of one, bit for bit
    bkw = dict(kw, qscale=kw["qscale"][None]) if "qscale" in kw else kw
    bids, bvals = ops.fused_cascade_batched(
        args[0], args[1][None], args[2], args[3], args[4][None],
        k_out=k_out, n_valid=n_valid, **bkw)
    assert torch.equal(bids[0], ids) and torch.equal(bvals[0], vals)
    live = ids[torch.isfinite(vals)]
    assert len(set(ids.tolist())) == k_out
    assert all(i < n_valid for i in live.tolist())
    assert int(torch.isfinite(vals).sum()) == min(k_out, n_valid)


@pytest.mark.parametrize("bound", ["hoeffding", "bernstein"])
@pytest.mark.parametrize("tier", ["fp32", "int8"])
@pytest.mark.parametrize("n,N,mode,n_valid,k_out", [
    (400, 512, "coord", 390, 5), (203, 300, "row", 190, 5),
    (96, 512, "row", 3, 7)])
def test_single_cascade_adaptive_matches_jax_kernel_and_oracle(
        tier, bound, n, N, mode, n_valid, k_out):
    args, kw, jplan, plan = _single_operands(
        n, N, 3, 64, mode, False, False, tier, seed=n, bound=bound,
        eps=4.0)
    cert = bt.cert_operand(plan.schedule, torch.device("cpu"))
    akw = dict(kw, k_out=k_out, n_valid=n_valid, k_cert=3,
               track_var=bound == "bernstein")
    ids, vals, rused = ops.fused_cascade(*args, cert=cert, **akw)
    assert rused.dtype == torch.int32 and rused.shape == ()
    jids, jvals, jrused = jax_ops.fused_cascade(
        *(_jax(t) for t in args), cert=_jax(cert),
        **{k: _jax(v) for k, v in akw.items()})
    assert int(rused) == int(jrused)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    _close(vals.numpy(), jvals)
    flat = flatten_schedule(jplan.schedule)
    oids, ovals, orused = oracle(
        args[0].numpy(), args[1].numpy(), flat, args[4].numpy(), n_arms=n,
        K=k_out, n_valid=n_valid, cert=cert.numpy(), k_cert=3,
        **_oracle_kw(kw))
    assert int(rused) == orused
    np.testing.assert_array_equal(ids.numpy(), oids)
    if tier == "int8":
        np.testing.assert_array_equal(vals.numpy(), ovals)
    else:
        _close(vals.numpy(), ovals)
    assert 1 <= int(rused) <= len(plan.schedule.rounds)


def _torch(x, dtype):
    """A JAX or numpy array as a CPU tensor of ``dtype`` (bf16 through
    f32, which holds every bf16 value exactly)."""
    return torch.from_numpy(np.array(x, np.float32)).to(dtype)


@pytest.mark.parametrize("R,C", [(8, 128), (8, 512), (4, 256), (16, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_block_dot_matches_jax(R, C, dtype):
    rng = np.random.default_rng(1)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    V4 = jnp.asarray(rng.normal(size=(12, 10, R, C)), jdt)
    idx = jnp.asarray(rng.permutation(12)[:5], jnp.int32)
    cols = jnp.asarray(rng.permutation(10)[:4], jnp.int32)
    qsel = jnp.asarray(rng.normal(size=(4, C)), jdt)
    out = ops.gather_block_dot(_torch(V4, tdt), torch.from_numpy(
        np.array(idx)), torch.from_numpy(np.array(cols)), _torch(qsel, tdt))
    assert out.dtype == torch.float32 and out.shape == (5, R)
    for want in (gather_block_dot_pallas(V4, idx, cols, qsel,
                                         interpret=True),
                 jax_ref.gather_block_dot_ref(V4, idx, cols, qsel)):
        _close(out.numpy(), want, atol_scale=1e-5)


def test_gather_block_dot_duplicates_and_single_tile():
    rng = np.random.default_rng(0)
    V4 = jnp.asarray(rng.normal(size=(4, 4, 8, 128)), jnp.float32)
    idx = jnp.asarray([2, 2, 0], jnp.int32)
    cols = jnp.asarray([1, 1], jnp.int32)       # a block pulled twice
    qsel = jnp.asarray(rng.normal(size=(2, 128)), jnp.float32)
    args = [torch.from_numpy(np.array(a)) for a in (V4, idx, cols, qsel)]
    out = ops.gather_block_dot(*args)
    _close(out.numpy(), gather_block_dot_pallas(V4, idx, cols, qsel,
                                                interpret=True),
           atol_scale=1e-5)
    assert torch.equal(out[0], out[1])
    one = ops.gather_block_dot(args[0], args[1][:1], args[2][:1],
                               torch.ones(1, 128))
    _close(one.numpy(), np.asarray(V4[2, 1].sum(-1))[None],
           atol_scale=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bad_idx,bad_cols", [
    ([-1], None), ([6], None), ([-1, 6, 99], None), ([], [1, 4, 0]),
    ([], [1, -1, 0]), ([6], [7, 0, 3])])
def test_gather_block_dot_out_of_range_gives_nan_rows(dtype, bad_idx,
                                                      bad_cols):
    """The plain version follows the card kernel's rule: NaN for a row
    whose ``idx`` is outside ``[0, n_tiles)``, every row NaN when a
    ``cols`` entry is outside ``[0, n_blocks)``; the other rows equal
    the call without the bad entries (the JAX interpret kernel clamps
    instead, so it is no oracle here)."""
    g = torch.Generator().manual_seed(11)
    tdt = getattr(torch, dtype)
    V4 = torch.randn(6, 4, 8, 64, generator=g).to(tdt)
    qsel = torch.randn(3, 64, generator=g).to(tdt)
    good = [0, 5, 2]
    idx = torch.tensor(good[:1] + bad_idx + good[1:], dtype=torch.int32)
    cols = torch.tensor([1, 0, 3] if bad_cols is None else bad_cols,
                        dtype=torch.int32)
    out = ops.gather_block_dot(V4, idx, cols, qsel)
    bad = torch.tensor([False] + [True] * len(bad_idx) + [False, False])
    if bad_cols is not None:
        assert bool(out.isnan().all())
        return
    assert bool(out[bad].isnan().all()) and not bool(out[~bad].isnan().any())
    want = ops.gather_block_dot(V4, torch.tensor(good, dtype=torch.int32),
                                cols, qsel)
    assert torch.equal(out[~bad], want)


@pytest.mark.parametrize("n,d,tn,td", [(512, 1024, 256, 512),
                                       (256, 512, 128, 128),
                                       (1024, 2048, 256, 1024)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_blocked_matvec_matches_jax(n, d, tn, td, dtype):
    rng = np.random.default_rng(2)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    W = jnp.asarray(rng.normal(size=(n, d)), jdt)
    q = jnp.asarray(rng.normal(size=d), jdt)
    out = ops.blocked_matvec(_torch(W, tdt), _torch(q, tdt), tile_n=tn,
                             tile_d=td)
    assert out.dtype == torch.float32 and out.shape == (n,)
    for want in (blocked_matvec_pallas(W, q, tile_n=tn, tile_d=td,
                                       interpret=True),
                 jax_ref.blocked_matvec_ref(W, q)):
        _close(out.numpy(), want, atol_scale=1e-5)


@pytest.mark.parametrize("n,d,tn,td", [
    (100, 512, 64, 512), (100, 512, 256, 512), (512, 1000, 256, 512),
    (512, 1024, 256, 300), (96, 64, 32, 64), (5, 7, 256, 512)])
def test_blocked_matvec_raises_where_jax_raises(n, d, tn, td):
    W, q = np.zeros((n, d), np.float32), np.zeros(d, np.float32)
    try:
        blocked_matvec_pallas(jnp.asarray(W), jnp.asarray(q), tile_n=tn,
                              tile_d=td, interpret=True)
        jax_raised = False
    except ValueError:
        jax_raised = True
    if jax_raised:
        with pytest.raises(ValueError, match="not divisible"):
            ops.blocked_matvec(torch.from_numpy(W), torch.from_numpy(q),
                               tile_n=tn, tile_d=td)
    else:
        out = ops.blocked_matvec(torch.from_numpy(W), torch.from_numpy(q),
                                 tile_n=tn, tile_d=td)
        assert out.shape == (n,)
    assert jax_raised == bool(n % min(tn, n) or d % min(td, d))


def test_wrappers_route_by_device_and_check_operands():
    counts = ops.launch_counts()
    for name in ("gather_block_dot", "blocked_matvec", "fused_cascade"):
        assert name in counts
    for tier in fc.TIERS:
        assert f"fused_cascade[{tier}]" in counts
        assert f"fused_cascade[{tier}+adaptive]" in counts
    V4 = torch.zeros(3, 2, 8, 16)
    idx, cols = torch.zeros(2, dtype=torch.long), torch.zeros(
        1, dtype=torch.long)
    q = torch.zeros(1, 16)
    before = ops.launch_counts()
    ops.gather_block_dot(V4, idx, cols, q)          # plain version
    ops.blocked_matvec(torch.zeros(8, 16), torch.zeros(16))
    assert ops.launch_counts() == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        gd.gather_block_dot_cuda(V4, idx, cols, q)
    with pytest.raises(ValueError, match="CUDA tensors"):
        bmv.blocked_matvec_cuda(torch.zeros(8, 16), torch.zeros(16))
    args, kw, _, _ = _single_operands(96, 128, 2, 64, "row", False, False,
                                      "fp32", seed=0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fc.fused_cascade_cuda(*args, **kw)
    with pytest.raises(TypeError, match="bfloat16"):
        ops.gather_block_dot(V4, idx, cols, q.double())
    with pytest.raises(TypeError, match="integer"):
        ref.gather_block_dot_ref(V4, idx.float(), cols, q)
    with pytest.raises(ValueError, match="qsel shape"):
        ops.gather_block_dot(V4, idx, cols, torch.zeros(2, 16))
    with pytest.raises(TypeError, match="bfloat16"):
        ops.blocked_matvec(torch.zeros(8, 16), torch.zeros(16).bfloat16())
    with pytest.raises(ValueError, match=r"\(n, d\)"):
        ops.blocked_matvec(torch.zeros(8, 16), torch.zeros(8))
    with pytest.raises(ValueError, match="qb must be"):
        ref.fused_cascade_ref(args[0], args[1][None], *args[2:], **kw)
