"""The port's fused cascade against the JAX package's three references.

On CPU tensors `repro_torch.kernels.ops.fused_cascade_batched` runs the
plain PyTorch version.  On the same V4/Qb/slotcode/rounds_meta/cols it
must reproduce:

  * the JAX package's Pallas kernel (`repro.kernels.ops.
    fused_cascade_batched`, interpret mode on the CPU);
  * the JAX package's jnp fallback (``bounded_me_decode(use_pallas=
    False)``), against the port's own ``bounded_me_decode``;
  * per query, the numpy oracle `repro.kernels.ref.fused_cascade_ref`.

Ids must be equal.  Scores agree to rtol 1e-5 and atol 1e-6 * max|score|:
fp32 sums taken in another order differ in the last bits, and the JAX
package's own interpret and fallback paths already differ by up to
1.2e-6 relative on the installed jax.

The quantized tiers run on the same operands (the port's quantizers,
bitwise equal to the JAX package's — tests/test_torch_quantize.py).
int8 and int4 scores are bitwise equal to the numpy oracle, which does
every float op as one IEEE operation, as the port does.  Against the JAX
package's interpret-mode kernel they are held to the fp32 tolerance
above: XLA on the CPU (installed jax 0.9.0) contracts ``acc + raw * s``
into one fused multiply-add and divides by a constant as a multiply by
its reciprocal, so that kernel is itself up to an ulp off its own
oracle (ROADMAP.md queue 3).  pq scores are held to the same tolerance
everywhere: the reference sums its LUT products and lookups in another
order.

The CUDA kernel itself runs only on the card:
``tests/test_torch_kernel_cuda.py`` holds it against the plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.boundedme_jax import bounded_me_decode as jax_decode
from repro.core.boundedme_jax import make_plan as jax_make_plan
from repro.core.schedule import flatten_schedule
from repro.kernels import ops as jax_ops
from repro.kernels.ref import fused_cascade_ref
from repro_torch.core import boundedme_torch as bt
from repro_torch.core import quantize as tq
from repro_torch.kernels import fused_cascade as fc
from repro_torch.kernels import ops

# (n, N, K, block, mode, n_valid, k_out, final_coverage, B, duplicate rows)
CASES = [
    (203, 300, 3, 64, "row", 190, 5, True, 3, False),     # n_valid < n
    (203, 300, 3, 64, "coord", 203, 3, False, 3, False),  # coord mode
    (96, 512, 5, 64, "row", 3, 7, False, 2, False),       # 3 live < k_out
    (160, 256, 4, 64, "row", 160, 8, True, 2, True),      # ties, k_out > K
    (200, 200, 2, 64, "coord", 150, 6, False, 2, True),   # ties, coord
    (64, 96, 64, 64, "row", 64, 64, False, 2, False),     # K >= n: no rounds
]


def _inputs(n, N, B, dup, seed):
    rng = np.random.default_rng(seed)
    V = rng.normal(size=(n, N)).astype(np.float32)
    if dup:              # exact ties between rows of different tiles
        V[n // 2:n // 2 + 10] = V[:10]
    Q = rng.normal(size=(B, N)).astype(np.float32)
    return V, Q


def _plans(n, N, K, block, mode):
    kw = dict(K=K, eps=0.5, delta=0.1, value_range=8.0, block=block,
              pull_mode=mode, coord_block=32)
    return jax_make_plan(n, N, **kw), bt.make_plan(n, N, **kw)


def _port_operands(V, Q, plan, perm, final_coverage):
    """The port's kernel operands, built by the port's own helpers."""
    V4 = bt.tile_table(V, plan, "cpu")
    _, Qp = bt._pad_operands(None, torch.from_numpy(Q), plan)
    Qb = Qp.reshape(Q.shape[0], plan.n_blocks, plan.block).contiguous()
    slotcode, rmeta, bpos, t_final, n_final = bt.schedule_operands(
        plan.schedule, final_coverage, torch.device("cpu"))
    cols = torch.as_tensor(perm)[bpos].to(torch.int32).expand(
        Q.shape[0], -1).contiguous()
    kw = dict(n_arms=plan.n, K=plan.K, t_final=t_final, n_final=n_final)
    return (V4, Qb, slotcode, rmeta, cols), kw


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_array_equal(got[~fin], want[~fin])
    scale = float(np.abs(want[fin]).max()) if fin.any() else 0.0
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5,
                               atol=1e-6 * scale)


@pytest.mark.parametrize("n,N,K,block,mode,n_valid,k_out,cover,B,dup", CASES)
def test_plain_cascade_matches_jax_kernel_and_oracle(
        n, N, K, block, mode, n_valid, k_out, cover, B, dup):
    V, Q = _inputs(n, N, B, dup, seed=n + K)
    jplan, plan = _plans(n, N, K, block, mode)
    perm = np.asarray(jax.random.permutation(jax.random.PRNGKey(n),
                                             plan.n_blocks))
    args, kw = _port_operands(V, Q, plan, np.array(perm), cover)
    ids, vals = ops.fused_cascade_batched(*args, k_out=k_out,
                                          n_valid=n_valid, **kw)
    assert ids.dtype == torch.int32 and vals.dtype == torch.float32
    assert ids.shape == vals.shape == (B, k_out)

    # the JAX Pallas kernel (interpret mode) on the very same operands
    V4, Qb, slotcode, rmeta, cols = (jnp.asarray(t.numpy()) for t in args)
    jids, jvals = jax_ops.fused_cascade_batched(
        V4, Qb, slotcode, rmeta, cols, k_out=k_out, n_valid=n_valid, **kw)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    _close(vals.numpy(), jvals)

    # the numpy oracle, one query at a time
    flat = flatten_schedule(jplan.schedule, final_coverage=cover)
    for b in range(B):
        oids, ovals = fused_cascade_ref(
            args[0].numpy(), args[1][b].numpy(), flat, args[4][b].numpy(),
            n_arms=plan.n, K=k_out, n_valid=n_valid)
        np.testing.assert_array_equal(ids[b].numpy(), oids)
        _close(vals[b].numpy(), ovals)

    # live candidates are distinct and valid; filler rows carry -inf
    for b in range(B):
        live = ids[b][torch.isfinite(vals[b])]
        assert len(set(ids[b].tolist())) == k_out
        assert all(i < n_valid for i in live.tolist())
        assert torch.isfinite(vals[b]).sum() == min(k_out, n_valid)


@pytest.mark.parametrize("n,N,K,block,mode,n_valid,k_out,cover,B,dup", CASES)
def test_port_decode_matches_jax_fallback(
        n, N, K, block, mode, n_valid, k_out, cover, B, dup):
    V, Q = _inputs(n, N, B, dup, seed=n + K)
    jplan, plan = _plans(n, N, K, block, mode)
    key = jax.random.PRNGKey(n)
    perm = np.array(jax.random.permutation(key, plan.n_blocks))
    jids, jvals = jax_decode(V, Q, key, plan=jplan, final_exact=False,
                             use_pallas=False, k_out=k_out, n_valid=n_valid)
    ids, vals = bt.bounded_me_decode(V, Q, perm, plan=plan,
                                     final_exact=False, k_out=k_out,
                                     n_valid=n_valid, device="cpu")
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    _close(vals.numpy(), jvals)


def test_entry_point_routes_by_device():
    V, Q = _inputs(96, 128, 2, False, seed=0)
    _, plan = _plans(96, 128, 2, 64, "row")
    args, kw = _port_operands(V, Q, plan, np.arange(plan.n_blocks), True)
    assert ops.on_cuda(*args) is False
    before = fc.launch_counts()["fused_cascade_batched"]
    ops.fused_cascade_batched(*args, **kw)          # plain version
    assert fc.launch_counts()["fused_cascade_batched"] == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        fc.fused_cascade_batched_cuda(*args, **kw)
    with pytest.raises(ValueError, match="all be on CUDA or all on the CPU"):
        ops.on_cuda(args[0], torch.empty(1, device="meta"))


def test_decode_refuses_unported_tiers_and_bad_perms():
    V, Q = _inputs(96, 128, 2, False, seed=1)
    kw = dict(K=2, eps=0.5, delta=0.1, value_range=8.0, block=64)
    perm = np.arange(2)
    plan = bt.make_plan(96, 128, **kw)
    V4 = bt.tile_table(V, plan, "cpu")
    int8 = tq.quantize_tiles(V4)
    # every tier of the JAX package is ported; what stays refused is a
    # table artifact that does not fit the plan
    with pytest.raises(ValueError, match="quantized plan"):
        bt.bounded_me_decode(V, Q, perm, plan=plan, quantized=int8,
                             device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        bt.bounded_me_decode(V, Q, perm, device="cpu", quantized=(
            int8[0][:1], int8[1][:1]), plan=bt.make_plan(
                96, 128, precision="int8", **kw))
    with pytest.raises(ValueError, match="pq_subdims"):
        bt.make_plan(96, 128, precision="pq", quant_err=0.1, pq_subdims=5,
                     **kw)
    for bad in (np.array([0, 0]), np.arange(3)):
        with pytest.raises(ValueError, match="permutation"):
            bt.bounded_me_decode(V, Q, bad, plan=plan, device="cpu")
    with pytest.raises(ValueError, match="k_out"):
        bt.bounded_me_decode(V, Q, perm, plan=plan, k_out=plan.k_out_cap + 1,
                             device="cpu")


def _tier_operands(V4, Qb, tier):
    """The kernel's table and query operands of a tier, quantized by the
    port, and the matching keywords."""
    if tier == "pq":
        cb = tq.pq_train(V4, n_codes=16, subdims=8)
        return tq.pq_encode(V4, cb), Qb, dict(codebook=cb)
    Vq, vscale = (tq.quantize_tiles_int4(V4) if tier == "int4"
                  else tq.quantize_tiles(V4))
    Q8, qscale = tq.quantize_blocks(Qb)
    return Vq, Q8, dict(vscale=vscale, qscale=qscale,
                        packed_int4=tier == "int4")


@pytest.mark.parametrize("tier", ["int8", "int4", "pq"])
@pytest.mark.parametrize("n,N,K,block,mode,n_valid,k_out,cover,B,dup",
                         [CASES[i] for i in (0, 1, 2, 4)])
def test_plain_cascade_tiers_match_jax_kernel_and_oracle(
        tier, n, N, K, block, mode, n_valid, k_out, cover, B, dup):
    V, Q = _inputs(n, N, B, dup, seed=n + K)
    jplan, plan = _plans(n, N, K, block, mode)
    perm = np.asarray(jax.random.permutation(jax.random.PRNGKey(n),
                                             plan.n_blocks))
    (V4, Qb, slotcode, rmeta, cols), kw = _port_operands(
        V, Q, plan, np.array(perm), cover)
    Vq, Qin, tkw = _tier_operands(V4, Qb, tier)
    args = (Vq, Qin, slotcode, rmeta, cols)
    ids, vals = ops.fused_cascade_batched(*args, k_out=k_out,
                                          n_valid=n_valid, **kw, **tkw)
    assert ids.shape == vals.shape == (B, k_out)

    jargs = [jnp.asarray(t.numpy()) for t in args]
    jtkw = {k: (jnp.asarray(v.numpy()) if torch.is_tensor(v) else v)
            for k, v in tkw.items()}
    jids, jvals = jax_ops.fused_cascade_batched(
        *jargs, k_out=k_out, n_valid=n_valid, **kw, **jtkw)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    _close(vals.numpy(), jvals)

    flat = flatten_schedule(jplan.schedule, final_coverage=cover)
    for b in range(B):
        okw = {k: (v[b].numpy() if k == "qscale" else
                   v.numpy() if torch.is_tensor(v) else v)
               for k, v in tkw.items()}
        oids, ovals = fused_cascade_ref(
            Vq.numpy(), Qin[b].numpy(), flat, cols[b].numpy(),
            n_arms=plan.n, K=k_out, n_valid=n_valid, **okw)
        np.testing.assert_array_equal(ids[b].numpy(), oids)
        if tier == "pq":
            _close(vals[b].numpy(), ovals)
        else:
            np.testing.assert_array_equal(vals[b].numpy(), ovals)
    for b in range(B):
        assert len(set(ids[b].tolist())) == k_out
        assert torch.isfinite(vals[b]).sum() == min(k_out, n_valid)


def test_wrapper_counts_launches_per_tier_and_checks_tiers():
    counts = fc.launch_counts()
    assert "fused_cascade_batched" in counts
    for tier in fc.TIERS:
        assert f"fused_cascade_batched[{tier}]" in counts
        assert f"fused_cascade_batched[{tier}+adaptive]" in counts
    V4 = torch.zeros((2, 1, 8, 16))
    cb = torch.zeros((1, 2, 4, 8))
    assert fc.resolve_tier(16, None, None, None, False) == ("fp32", 16)
    assert fc.resolve_tier(8, V4, V4, None, True) == ("int4", 16)
    assert fc.resolve_tier(2, None, None, cb, False) == ("pq", 16)
    with pytest.raises(ValueError, match="together"):
        fc.resolve_tier(16, V4, None, None, False)
    with pytest.raises(ValueError, match="excludes"):
        fc.resolve_tier(2, V4, V4, cb, False)
    with pytest.raises(ValueError, match="W4A8"):
        fc.resolve_tier(8, None, None, None, True)
