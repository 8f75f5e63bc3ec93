"""The port's CUDA kernels against their plain PyTorch versions.

The kernel has no CPU mode, so every test here is marked ``cuda`` and
skips without a card; on one it builds the kernel and compares.  This
file imports only the port, so it runs where JAX is not installed.

Ids must be equal; fp32 scores agree to rtol 1e-5 and atol 1e-6 *
max|score| (the kernel's fp32 dot sums in another order than the plain
version's ``einsum``).  The int8 and int4 tiers are bitwise equal (exact
integer dots, then the same rounded float ops), and so are the adaptive
``rounds_used``; pq scores are held to the fp32 tolerance.  The
single-query cascade is held the same way and, bit for bit, against a
B = 1 launch of the batched entry.  The batched entry given one cols row
expanded over the batch (its shared round-1 read) is bitwise the same
launch on a contiguous copy; both entries launch one CTA per SM (read back
from the kernel) and refuse a schedule off the flat layout.  The
gathered tile-dot and the blocked
matvec agree with their plain versions to rtol 1e-5 and atol 1e-5 *
max|out| in f32 and bf16: the products are exact in f32 and only the
order of the sums within a block or slab differs.  The fp32 tier on a
bf16 table is bitwise the fp32 launch on the table widened to f32.  The
chain sum (the gradient of a 16-bit bias) is bitwise its plain version
in bf16 and f16: the same adds in the same order, each rounded once.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import boundedme_torch as bt
from repro_torch.core import quantize as tq
from repro_torch.kernels import fused_cascade as fc
from repro_torch.kernels import ops

pytestmark = pytest.mark.cuda

# (n, N, K, block, mode, tile, n_valid, k_out, final_coverage, B)
CASES = [
    (203, 300, 3, 64, "row", 8, 190, 5, True, 3),        # generic pull
    (203, 300, 3, 64, "coord", 8, 203, 3, False, 3),
    (96, 512, 5, 64, "row", 8, 3, 7, False, 2),          # 3 live < k_out
    (1000, 256, 4, 128, "coord", 8, 990, 4, True, 4),    # float4, C=128
    (4000, 1024, 4, 512, "row", 8, 3990, 8, True, 4),    # float4, C=512
    (5000, 768, 4, 256, "row", 8, 5000, 4, True, 4),     # float4, C=256
    (777, 200, 2, 64, "row", 4, 700, 3, True, 2),        # R=4
    (64, 96, 64, 64, "row", 8, 64, 64, False, 2),        # no rounds
    (40, 64, 2, 32, "row", 8, 37, 3, True, 2),           # 5 tiles < CTAs
    (203, 300, 3, 64, "row", 8, 190, 5, True, 150),      # B > CTAs
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _operands(n, N, K, block, mode, tile, cover, B, seed,
              bound="hoeffding"):
    rng = np.random.default_rng(seed)
    V = rng.normal(size=(n, N)).astype(np.float32)
    V[n // 2:n // 2 + 10] = V[:10]           # exact ties across tiles
    Q = torch.from_numpy(rng.normal(size=(B, N)).astype(np.float32))
    plan = bt.make_plan(n, N, K=K, eps=0.5, delta=0.1, value_range=8.0,
                        block=block, tile=tile, pull_mode=mode,
                        coord_block=32 if block < 128 else 128, bound=bound)
    V4 = bt.tile_table(V, plan, "cpu")
    _, Qp = bt._pad_operands(None, Q, plan)
    Qb = Qp.reshape(B, plan.n_blocks, plan.block).contiguous()
    slotcode, rmeta, bpos, t_final, n_final = bt.schedule_operands(
        plan.schedule, cover, torch.device("cpu"))
    perm = torch.from_numpy(rng.permutation(plan.n_blocks))
    cols = perm[bpos].to(torch.int32).expand(B, -1).contiguous()
    kw = dict(n_arms=plan.n, K=plan.K, t_final=t_final, n_final=n_final)
    return (V4, Qb, slotcode, rmeta, cols), kw


@pytest.mark.parametrize("n,N,K,block,mode,tile,n_valid,k_out,cover,B",
                         CASES)
def test_kernel_matches_plain_version(card, n, N, K, block, mode, tile,
                                      n_valid, k_out, cover, B):
    args, kw = _operands(n, N, K, block, mode, tile, cover, B, seed=n)
    before = fc.launch_counts()["fused_cascade_batched"]
    ids, vals = ops.fused_cascade_batched(*(t.to(card) for t in args),
                                          k_out=k_out, n_valid=n_valid, **kw)
    torch.cuda.synchronize()
    assert fc.launch_counts()["fused_cascade_batched"] == before + 1
    pids, pvals = ops.fused_cascade_batched(*args, k_out=k_out,
                                            n_valid=n_valid, **kw)
    np.testing.assert_array_equal(ids.cpu().numpy(), pids.numpy())
    got, want = vals.cpu().numpy(), pvals.numpy()
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5,
                               atol=1e-6 * float(np.abs(want[fin]).max()))


def test_kernel_wrapper_checks_operands(card):
    args, kw = _operands(203, 300, 3, 64, "row", 8, True, 2, seed=0)
    dev = [t.to(card) for t in args]
    with pytest.raises(TypeError, match="float32"):
        fc.fused_cascade_batched_cuda(dev[0].double(), *dev[1:], **kw)
    with pytest.raises(ValueError, match="contiguous"):
        fc.fused_cascade_batched_cuda(
            dev[0], dev[1].transpose(1, 2).contiguous().transpose(1, 2),
            *dev[2:], **kw)
    with pytest.raises(ValueError, match="k_out"):
        fc.fused_cascade_batched_cuda(*dev, k_out=10 ** 6, **kw)
    with pytest.raises(ValueError, match="is on cpu"):
        fc.fused_cascade_batched_cuda(dev[0], args[1], *dev[2:], **kw)


def _tier(args, tier, bound=None):
    """The tier's operands (port quantizers) and keywords; with ``bound``
    also the adaptive ones."""
    V4, Qb, slotcode, rmeta, cols = args
    kw = {}
    if tier == "pq":
        cb = tq.pq_train(V4, n_codes=16, subdims=8)
        V4, kw = tq.pq_encode(V4, cb), dict(codebook=cb)
    elif tier in ("int8", "int4"):
        V4, vscale = (tq.quantize_tiles_int4(V4) if tier == "int4"
                      else tq.quantize_tiles(V4))
        Qb, qscale = tq.quantize_blocks(Qb)
        kw = dict(vscale=vscale, qscale=qscale, packed_int4=tier == "int4")
    return (V4, Qb, slotcode, rmeta, cols), kw


@pytest.mark.parametrize("tier", ["int8", "int4", "pq"])
@pytest.mark.parametrize("n,N,K,block,mode,tile,n_valid,k_out,cover,B",
                         [CASES[i] for i in (0, 1, 2, 3, 4, 6, 8, 9)])
def test_kernel_tiers_match_plain_version(card, tier, n, N, K, block, mode,
                                          tile, n_valid, k_out, cover, B):
    args, kw = _operands(n, N, K, block, mode, tile, cover, B, seed=n)
    args, tkw = _tier(args, tier)
    name = f"fused_cascade_batched[{tier}]"
    before = fc.launch_counts()[name]
    ids, vals = ops.fused_cascade_batched(
        *(t.to(card) for t in args), k_out=k_out, n_valid=n_valid, **kw,
        **{k: (v.to(card) if torch.is_tensor(v) else v)
           for k, v in tkw.items()})
    torch.cuda.synchronize()
    assert fc.launch_counts()[name] == before + 1
    pids, pvals = ops.fused_cascade_batched(*args, k_out=k_out,
                                            n_valid=n_valid, **kw, **tkw)
    np.testing.assert_array_equal(ids.cpu().numpy(), pids.numpy())
    got, want = vals.cpu().numpy(), pvals.numpy()
    if tier == "pq":
        fin = np.isfinite(want)
        np.testing.assert_array_equal(np.isfinite(got), fin)
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5,
                                   atol=1e-6 * float(np.abs(want[fin]).max()))
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bound", ["hoeffding", "bernstein"])
@pytest.mark.parametrize("tier", ["fp32", "int8", "int4", "pq"])
@pytest.mark.parametrize("n,N,mode,n_valid,k_out", [
    (400, 512, "coord", 390, 5), (203, 300, "row", 190, 5),
    (96, 512, "row", 3, 7)])
def test_kernel_adaptive_matches_plain_version(card, tier, bound, n, N,
                                               mode, n_valid, k_out):
    rng = np.random.default_rng(n)
    V = rng.normal(size=(n, N)).astype(np.float32)
    Q = rng.normal(size=(4, N)).astype(np.float32)
    for b, strength in enumerate([0.0, 0.3, 0.6, 1.5]):
        V[rng.choice(n, 3, replace=False)] += strength * Q[b]
    plan = bt.make_plan(n, N, K=3, eps=4.0, delta=0.1, value_range=8.0,
                        block=64, pull_mode=mode, coord_block=32,
                        bound=bound)
    V4 = bt.tile_table(V, plan, "cpu")
    Qb = bt._pad_operands(None, torch.from_numpy(Q), plan)[1].reshape(
        4, plan.n_blocks, plan.block).contiguous()
    slotcode, rmeta, bpos, t_final, n_final = bt.schedule_operands(
        plan.schedule, False, torch.device("cpu"))
    perm = torch.from_numpy(rng.permutation(plan.n_blocks))
    cols = perm[bpos].to(torch.int32).expand(4, -1).contiguous()
    args, tkw = _tier((V4, Qb, slotcode, rmeta, cols), tier)
    kw = dict(n_arms=n, K=3, t_final=t_final, n_final=n_final, k_out=k_out,
              n_valid=n_valid, k_cert=3, track_var=bound == "bernstein",
              **tkw)
    cert = bt.cert_operand(plan.schedule, torch.device("cpu"))
    name = f"fused_cascade_batched[{tier}+adaptive]"
    before = fc.launch_counts()[name]
    ids, vals, rused = ops.fused_cascade_batched(
        *(t.to(card) for t in args), cert=cert.to(card),
        **{k: (v.to(card) if torch.is_tensor(v) else v)
           for k, v in kw.items()})
    torch.cuda.synchronize()
    assert fc.launch_counts()[name] == before + 1
    pids, pvals, prused = ops.fused_cascade_batched(*args, cert=cert, **kw)
    np.testing.assert_array_equal(rused.cpu().numpy(), prused.numpy())
    np.testing.assert_array_equal(ids.cpu().numpy(), pids.numpy())
    got, want = vals.cpu().numpy(), pvals.numpy()
    if tier in ("int8", "int4"):
        np.testing.assert_array_equal(got, want)
    else:
        fin = np.isfinite(want)
        np.testing.assert_array_equal(np.isfinite(got), fin)
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5,
                                   atol=1e-6 * float(np.abs(want[fin]).max()))


def test_kernel_wrapper_checks_tier_operands(card):
    args, kw = _operands(203, 300, 3, 64, "row", 8, True, 2, seed=0)
    (V8, Q8, *rest), tkw = _tier(args, "int8")
    dev = [t.to(card) for t in (V8, Q8, *rest)]
    vs, qs = tkw["vscale"].to(card), tkw["qscale"].to(card)
    with pytest.raises(ValueError, match="qscale shape"):
        fc.fused_cascade_batched_cuda(*dev, vscale=vs, qscale=qs[:1], **kw)
    with pytest.raises(TypeError, match="int8"):
        fc.fused_cascade_batched_cuda(args[0].to(card), *dev[1:], vscale=vs,
                                      qscale=qs, **kw)
    with pytest.raises(ValueError, match="track_var needs cert"):
        fc.fused_cascade_batched_cuda(*dev, vscale=vs, qscale=qs,
                                      track_var=True, **kw)


@pytest.mark.parametrize("case", [8, 9, 4])      # 5 tiles, B = 150, C = 512
def test_launch_uses_every_sm(card, case):
    """The grid each entry ran with, read back from the kernel's own
    gridDim: one CTA per SM, whatever the table or the batch."""
    n, N, K, block, mode, tile, n_valid, k_out, cover, B = CASES[case]
    args, kw = _operands(n, N, K, block, mode, tile, cover, B, seed=n)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    ctas, capacity = fc.launch_grid(card)
    assert ctas == sms and capacity >= 19200   # the qwen1.5-0.5b tiles
    V4, Qb, slotcode, rmeta, cols = (t.to(card) for t in args)
    fc.launched_grid(card)
    fc.fused_cascade_batched_cuda(V4, Qb, slotcode, rmeta, cols,
                                  k_out=k_out, n_valid=n_valid, **kw)
    assert fc.launched_grid(card) == sms
    assert fc.launched_grid(card) == 0         # read once, then cleared
    fc.fused_cascade_cuda(V4, Qb[0].contiguous(), slotcode, rmeta,
                          cols[0].contiguous(), k_out=k_out, n_valid=n_valid,
                          **kw)
    assert fc.launched_grid(card) == sms


def _plan_of(n, N, K, block, mode, bound="hoeffding"):
    """The plan `_operands` builds, for its cert operand."""
    return bt.make_plan(n, N, K=K, eps=0.5, delta=0.1, value_range=8.0,
                        block=block, tile=8, pull_mode=mode,
                        coord_block=32 if block < 128 else 128, bound=bound)


@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("tier", ["fp32", "int8", "int4", "pq"])
@pytest.mark.parametrize("n,N,block,mode", [(4000, 1024, 512, "row"),
                                            (1000, 256, 128, "coord"),
                                            (203, 300, 64, "row")])
def test_shared_cols_is_bitwise_the_same_launch(card, tier, adaptive, n, N,
                                                block, mode):
    args, kw = _operands(n, N, 4, block, mode, 8, not adaptive, 4, seed=7)
    args, tkw = _tier(args, tier)
    kw = dict(kw, k_out=5, n_valid=n - 7, **tkw)
    if adaptive:
        plan = _plan_of(n, N, 4, block, mode, "bernstein")
        kw.update(cert=bt.cert_operand(plan.schedule, torch.device("cpu")),
                  k_cert=4, track_var=True)
    (V4, Qb, slotcode, rmeta, cols), dkw = _on(card, args, kw)
    off = fc.fused_cascade_batched_cuda(V4, Qb, slotcode, rmeta, cols, **dkw)
    on = fc.fused_cascade_batched_cuda(V4, Qb, slotcode, rmeta,    # stride 0
                                       cols[:1].expand(cols.shape[0], -1),
                                       **dkw)
    torch.cuda.synchronize()
    assert len(on) == len(off)
    for a, b in zip(on, off):
        assert torch.equal(a, b)


def test_shared_cols_only_for_one_expanded_row(card):
    """Cols with equal rows in a copy, or unequal rows, take the per-query
    read; both agree with the plain version, and the copy is bitwise the
    expanded row's launch."""
    args, kw = _operands(203, 300, 3, 64, "row", 8, True, 3, seed=0)
    kw = dict(kw, k_out=5, n_valid=190)
    V4, Qb, slotcode, rmeta, cols = args
    plan = _plan_of(203, 300, 3, 64, "row")
    bpos = bt.schedule_operands(plan.schedule, True, torch.device("cpu"))[2]
    mixed = cols.clone()
    mixed[1] = torch.from_numpy(np.random.default_rng(3).permutation(
        plan.n_blocks))[bpos].to(torch.int32)
    assert not torch.equal(mixed[1], mixed[0])
    for c in (cols, mixed):
        want = ops.fused_cascade_batched(V4, Qb, slotcode, rmeta, c, **kw)
        dev = [t.to(card) for t in (V4, Qb, slotcode, rmeta, c)]
        got = ops.fused_cascade_batched(*dev, **kw)
        np.testing.assert_array_equal(got[0].cpu().numpy(), want[0].numpy())
        np.testing.assert_allclose(got[1].cpu().numpy(), want[1].numpy(),
                                   rtol=1e-5, atol=1e-6 * float(
                                       want[1].abs().max()))
    dev = [t.to(card) for t in args]
    one = ops.fused_cascade_batched(*dev[:4], dev[4][:1].expand(3, -1), **kw)
    for a, b in zip(one, ops.fused_cascade_batched(*dev, **kw)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("tier", ["fp32", "int8"])
def test_adaptive_batch_mixes_round_one_exits_and_full_runs(card, tier):
    n, N = 400, 4096
    rng = np.random.default_rng(11)
    V = rng.normal(size=(n, N)).astype(np.float32)
    Q = rng.normal(size=(4, N)).astype(np.float32)
    V[:3] += 0.6 * Q[0]              # queries 0 and 2 have clear winners,
    V[200:203] += 0.6 * Q[2]         # queries 1 and 3 none
    plan = bt.make_plan(n, N, K=3, eps=1.0, delta=0.1, value_range=8.0,
                        block=64, pull_mode="row")
    V4 = bt.tile_table(V, plan, "cpu")
    Qb = bt._pad_operands(None, torch.from_numpy(Q), plan)[1].reshape(
        4, plan.n_blocks, plan.block).contiguous()
    slotcode, rmeta, bpos, t_final, n_final = bt.schedule_operands(
        plan.schedule, False, torch.device("cpu"))
    cols = torch.from_numpy(rng.permutation(plan.n_blocks))[bpos].to(
        torch.int32).expand(4, -1).contiguous()
    args, tkw = _tier((V4, Qb, slotcode, rmeta, cols), tier)
    kw = dict(n_arms=n, K=3, t_final=t_final, n_final=n_final, k_out=5,
              n_valid=390, k_cert=3, **tkw,
              cert=bt.cert_operand(plan.schedule, torch.device("cpu")))
    want = ops.fused_cascade_batched(*args, **kw)
    n_rounds = len(plan.schedule.rounds)
    assert want[2].tolist() == [1, n_rounds, 1, n_rounds]
    dargs, dkw = _on(card, args, kw)
    got = ops.fused_cascade_batched(*dargs, **dkw)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got[2].cpu().numpy(), want[2].numpy())
    np.testing.assert_array_equal(got[0].cpu().numpy(), want[0].numpy())
    g, w = got[1].cpu().numpy(), want[1].numpy()
    if tier == "int8":
        np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_allclose(g, w, rtol=1e-5,
                                   atol=1e-6 * float(np.abs(w).max()))


@pytest.mark.parametrize("tier", ["fp32", "int8", "pq"])
def test_schedule_off_the_flat_layout_is_refused(card, tier):
    """Slots reversed within every column of every round: the kernel walks
    the flat layout without reading the steps' slots, so both entries
    must refuse such a schedule before they launch, and take it once it
    is laid out again."""
    from repro_torch.core.schedule import SLOT_MASK
    n, N, K, block, mode = 400, 4096, 3, 64, "coord"     # 5 rounds pull
    args, kw = _operands(n, N, K, block, mode, 8, False, 3, seed=9)
    args, tkw = _tier(args, tier)
    plan = _plan_of(n, N, K, block, mode)
    code = args[2].numpy().copy()
    pos, t_prev = 0, 0
    for r in plan.schedule.rounds:
        if r.t_cum > t_prev:
            for p in range(r.t_cum - t_prev):
                seg = slice(pos + p * r.n_arms, pos + (p + 1) * r.n_arms)
                code[seg] = ((code[seg] & ~SLOT_MASK)
                             | (r.n_arms - 1 - (code[seg] & SLOT_MASK)))
            pos += (r.t_cum - t_prev) * r.n_arms
        else:
            pos += 1
        t_prev = r.t_cum
    assert not np.array_equal(code, args[2].numpy())
    kw = dict(kw, k_out=4, n_valid=n - 5, **tkw)
    (V4, Qb, slotcode, rmeta, cols), dkw = _on(card, args, kw)
    off = torch.from_numpy(code).to(card)
    before = fc.launch_counts()
    with pytest.raises(ValueError, match="flatten_schedule"):
        ops.fused_cascade_batched(V4, Qb, off, rmeta, cols, **dkw)
    skw = {k: (v[0].contiguous() if k == "qscale" else v)
           for k, v in dkw.items()}
    with pytest.raises(ValueError, match="flatten_schedule"):
        ops.fused_cascade(V4, Qb[0].contiguous(), off, rmeta,
                          cols[0].contiguous(), **skw)
    assert fc.launch_counts() == before
    off.copy_(slotcode)            # laid out again: the same tensor passes
    got = ops.fused_cascade_batched(V4, Qb, off, rmeta, cols, **dkw)
    want = ops.fused_cascade_batched(V4, Qb, slotcode, rmeta, cols, **dkw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_round_end_keys_past_shared_memory(card):
    """A table with more tiles than a CTA's shared memory holds keys for:
    the round ends run in the keys workspace, with the same results."""
    _, capacity = fc.launch_grid(card)
    n_tiles = capacity + 500
    n, N = 8 * n_tiles, 64
    g = torch.Generator().manual_seed(5)
    V = torch.randn(n, N, generator=g)
    Q = torch.randn(2, N, generator=g)
    plan = bt.make_plan(n, N, K=4, eps=0.5, delta=0.1, value_range=8.0,
                        block=32, pull_mode="row")
    V4 = bt.tile_table(V, plan, card)
    Qb = Q.reshape(2, plan.n_blocks, plan.block).to(card)
    slotcode, rmeta, bpos, t_final, n_final = bt.schedule_operands(
        plan.schedule, True, card)
    cols = bpos.to(torch.int32).expand(2, -1).contiguous()
    kw = dict(n_arms=n, K=4, t_final=t_final, n_final=n_final, k_out=6,
              n_valid=n - 3)
    got = fc.fused_cascade_batched_cuda(V4, Qb, slotcode, rmeta, cols, **kw)
    want = ops.ref.fused_cascade_batched_ref(V4, Qb, slotcode, rmeta, cols,
                                             **kw)
    torch.cuda.synchronize()
    assert plan.n_tiles > capacity
    np.testing.assert_array_equal(got[0].cpu().numpy(),
                                  want[0].cpu().numpy())
    np.testing.assert_allclose(got[1].cpu().numpy(), want[1].cpu().numpy(),
                               rtol=1e-5, atol=1e-6 * float(
                                   want[1].abs().max()))


# ---- the single-query cascade, the gathered tile-dot, the matvec ----------

def _single(args, tkw):
    """Query 0 of a batched case as single-query operands."""
    V4, Qb, slotcode, rmeta, cols = args
    skw = {k: (v[0].contiguous() if k == "qscale" else v)
           for k, v in tkw.items()}
    return (V4, Qb[0].contiguous(), slotcode, rmeta,
            cols[0].contiguous()), skw


def _on(card, args, kw):
    return ([t.to(card) for t in args],
            {k: (v.to(card) if torch.is_tensor(v) else v)
             for k, v in kw.items()})


@pytest.mark.parametrize("bound", [None, "hoeffding", "bernstein"])
@pytest.mark.parametrize("tier", ["fp32", "int8", "int4", "pq"])
@pytest.mark.parametrize("n,N,K,block,mode,tile,n_valid,k_out,cover,B",
                         [CASES[i] for i in (0, 1, 2, 4, 8)])
def test_single_query_kernel_matches_plain_and_batch_of_one(
        card, tier, bound, n, N, K, block, mode, tile, n_valid, k_out, cover,
        B):
    args, kw = _operands(n, N, K, block, mode, tile,
                         cover and bound is None, B, seed=n,
                         bound=bound or "hoeffding")
    args, tkw = _tier(args, tier)
    args, tkw = _single(args, tkw)
    kw = dict(kw, k_out=k_out, n_valid=n_valid, **tkw)
    if bound is not None:
        plan = bt.make_plan(n, N, K=K, eps=0.5, delta=0.1, value_range=8.0,
                            block=block, tile=tile, pull_mode=mode,
                            coord_block=32 if block < 128 else 128,
                            bound=bound)
        kw.update(cert=bt.cert_operand(plan.schedule, torch.device("cpu")),
                  k_cert=K, track_var=bound == "bernstein")
    dargs, dkw = _on(card, args, kw)
    name = f"fused_cascade[{tier}{'' if bound is None else '+adaptive'}]"
    before = fc.launch_counts()
    got = ops.fused_cascade(*dargs, **dkw)
    torch.cuda.synchronize()
    after = fc.launch_counts()
    assert after[name] == before[name] + 1
    assert after["fused_cascade"] == before["fused_cascade"] + 1
    assert after["fused_cascade_batched"] == before["fused_cascade_batched"]
    want = ops.fused_cascade(*args, **kw)
    assert got[0].shape == (k_out,)
    if bound is not None:
        assert got[2].shape == () and int(got[2]) == int(want[2])
    np.testing.assert_array_equal(got[0].cpu().numpy(), want[0].numpy())
    g, w = got[1].cpu().numpy(), want[1].numpy()
    if tier in ("int8", "int4"):
        np.testing.assert_array_equal(g, w)
    else:
        fin = np.isfinite(w)
        np.testing.assert_array_equal(np.isfinite(g), fin)
        np.testing.assert_allclose(g[fin], w[fin], rtol=1e-5,
                                   atol=1e-6 * float(np.abs(w[fin]).max()))
    # bit for bit a B = 1 launch of the batched entry
    bkw = dict(dkw, qscale=dkw["qscale"][None]) if "qscale" in dkw else dkw
    batch = fc.fused_cascade_batched_cuda(
        dargs[0], dargs[1][None], dargs[2], dargs[3], dargs[4][None], **bkw)
    for a, b in zip(got, batch):
        assert torch.equal(a, b[0])


@pytest.mark.parametrize("bound", [None, "hoeffding", "bernstein"])
@pytest.mark.parametrize("n,N,K,block,mode,tile,n_valid,k_out,cover,B",
                         [CASES[i] for i in (0, 1, 2, 3, 4, 5, 6, 9)])
def test_bf16_table_is_bitwise_the_widened_f32_launch(
        card, bound, n, N, K, block, mode, tile, n_valid, k_out, cover, B):
    """The fp32 tier on a bf16 table (a bf16 model's vocab head): bitwise
    the fp32 launch on the table widened to f32, in row and coord mode
    (float4 and scalar pulls), with and without early exit; agrees with
    the plain version on the same bf16 operands; one ``[bf16]`` launch;
    the single-query entry bitwise a B = 1 batched launch."""
    args, kw = _operands(n, N, K, block, mode, tile,
                         cover and bound is None, B, seed=n,
                         bound=bound or "hoeffding")
    b16 = (args[0].bfloat16(), *args[1:])
    f32 = (b16[0].float(), *args[1:])
    kw = dict(kw, k_out=k_out, n_valid=n_valid)
    if bound is not None:
        plan = bt.make_plan(n, N, K=K, eps=0.5, delta=0.1, value_range=8.0,
                            block=block, tile=tile, pull_mode=mode,
                            coord_block=32 if block < 128 else 128,
                            bound=bound)
        kw.update(cert=bt.cert_operand(plan.schedule, torch.device("cpu")),
                  k_cert=K, track_var=bound == "bernstein")
    dargs, dkw = _on(card, b16, kw)
    name = f"fused_cascade_batched[bf16{'' if bound is None else '+adaptive'}]"
    before = fc.launch_counts()
    got = ops.fused_cascade_batched(*dargs, **dkw)
    torch.cuda.synchronize()
    after = fc.launch_counts()
    assert after[name] == before[name] + 1
    assert after["fused_cascade_batched"] == \
        before["fused_cascade_batched"] + 1
    wide = fc.fused_cascade_batched_cuda(*(t.to(card) for t in f32), **dkw)
    for a, b in zip(got, wide):
        assert torch.equal(a, b)
    want = ops.fused_cascade_batched(*b16, **kw)     # the plain version
    if bound is not None:
        np.testing.assert_array_equal(got[2].cpu().numpy(), want[2].numpy())
    np.testing.assert_array_equal(got[0].cpu().numpy(), want[0].numpy())
    g, w = got[1].cpu().numpy(), want[1].numpy()
    fin = np.isfinite(w)
    np.testing.assert_array_equal(np.isfinite(g), fin)
    np.testing.assert_allclose(g[fin], w[fin], rtol=1e-5,
                               atol=1e-6 * float(np.abs(w[fin]).max()))
    one = fc.fused_cascade_cuda(dargs[0], dargs[1][0].contiguous(),
                                *dargs[2:4], dargs[4][0].contiguous(),
                                **dkw)
    batch = fc.fused_cascade_batched_cuda(dargs[0], dargs[1][:1],
                                          *dargs[2:4], dargs[4][:1], **dkw)
    for a, b in zip(one, batch):
        assert torch.equal(a, b[0])


def test_bf16_table_needs_f32_queries(card):
    """The bf16 instantiation pulls a bf16 table against f32 queries: the
    host widens a bf16 hidden state first; bf16 or int8 queries are
    refused, and nothing launches."""
    args, kw = _operands(203, 300, 3, 64, "row", 8, True, 2, seed=0)
    V4, Qb, *rest = (t.to(card) for t in args)
    before = fc.launch_counts()
    for q in (Qb.bfloat16(), Qb.to(torch.int8), Qb.double()):
        with pytest.raises(TypeError, match="float32"):
            fc.fused_cascade_batched_cuda(V4.bfloat16(), q, *rest, **kw)
    assert fc.launch_counts() == before


def _grid_of(module, device, dtype, geo, work):
    """The grid a launch must run with: one CTA per chunk of work, at most
    every resident slot of the card (SMs x CTAs per SM for its shared
    memory)."""
    from repro_torch.kernels import blocked_matvec as bmv
    sms, per_sm = module.occupancy(device, bmv.DTYPES.index(dtype),
                                   geo.bulk, geo.smem)
    return min(geo.chunks(work), sms * per_sm)


def _branch(nbytes: int, ptr: int) -> str:
    """The bulk-copy rule: 16-byte-aligned data and unit bytes."""
    return "bulk" if nbytes % 16 == 0 and ptr % 16 == 0 else "ldg"


# T = 20 < SMs, T = 257 and 33 not multiples of the grid, dt = 1, a
# 32 KB cell (two 16 KB stages' worth), C * 2 bytes % 16 != 0 in bf16
@pytest.mark.parametrize("R,C,T,dt", [(8, 512, 300, 2), (8, 128, 257, 8),
                                      (4, 256, 33, 3), (16, 100, 20, 5),
                                      (8, 128, 20, 8), (8, 128, 301, 1),
                                      (16, 512, 50, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_block_dot_kernel_matches_plain(card, R, C, T, dt, dtype):
    from repro_torch.kernels import gather_dot as gd
    from repro_torch.kernels import stream
    g = torch.Generator().manual_seed(R * C + T)
    V4 = torch.randn(40, 9, R, C, generator=g).to(dtype)
    idx = torch.randint(0, 40, (T,), generator=g)       # repeats included
    cols = torch.randint(0, 9, (dt,), generator=g)
    qsel = torch.randn(dt, C, generator=g).to(dtype)
    dev = [t.to(card) for t in (V4, idx, cols, qsel)]
    branch = _branch(C * V4.element_size(), dev[0].data_ptr())
    name = f"gather_block_dot[{branch}]"
    before = ops.launch_counts()
    gd.launched_grid(card)
    out = ops.gather_block_dot(*dev)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["gather_block_dot"] == before["gather_block_dot"] + 1
    assert after[name] == before[name] + 1
    geo = stream.gather_stream(R, C, V4.element_size(), dt,
                               dev[0].data_ptr())
    assert gd.launched_grid(card) == _grid_of(gd, dev[0].device, dtype, geo,
                                              T)
    want = ops.gather_block_dot(V4, idx, cols, qsel)
    assert out.dtype == torch.float32 and out.shape == (T, R)
    np.testing.assert_allclose(out.cpu().numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))


# n = 64 < SMs, n = 300 and 768 not multiples of the grid, one slab
# (dt = 1), a row of 64 KB (f32) or 32 KB (bf16) beyond one stage, and
# slabs of 40 or 20 bytes (not a multiple of 16)
@pytest.mark.parametrize("n,d,tn,td", [(1024, 1024, 256, 512),
                                       (768, 640, 256, 128),
                                       (300, 96, 100, 96), (64, 30, 32, 10),
                                       (64, 1024, 64, 512),
                                       (1000, 512, 200, 512),
                                       (40, 16384, 40, 512)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_blocked_matvec_kernel_matches_plain(card, n, d, tn, td, dtype):
    from repro_torch.kernels import blocked_matvec as bmv
    from repro_torch.kernels import stream
    g = torch.Generator().manual_seed(n + d)
    W = torch.randn(n, d, generator=g).to(dtype)
    q = torch.randn(d, generator=g).to(dtype)
    Wd, qd = W.to(card), q.to(card)
    branch = _branch(td * W.element_size(), Wd.data_ptr())
    name = f"blocked_matvec[{branch}]"
    before = ops.launch_counts()
    bmv.launched_grid(card)
    out = ops.blocked_matvec(Wd, qd, tile_n=tn, tile_d=td)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["blocked_matvec"] == before["blocked_matvec"] + 1
    assert after[name] == before[name] + 1
    geo = stream.matvec_stream(d, td, W.element_size(), Wd.data_ptr())
    assert bmv.launched_grid(card) == _grid_of(bmv, Wd.device, dtype, geo, n)
    want = ops.blocked_matvec(W, q, tile_n=tn, tile_d=td)
    assert out.dtype == torch.float32 and out.shape == (n,)
    np.testing.assert_allclose(out.cpu().numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("kernel", ["gather_block_dot", "blocked_matvec"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unaligned_operands_take_the_ldg_branch(card, kernel, dtype):
    """A table whose data starts 4 or 2 bytes past a 16-byte boundary (a
    storage offset) cannot be bulk-copied: the same kernel's plain-load
    branch runs and agrees with the plain version."""
    g = torch.Generator().manual_seed(7)
    if kernel == "gather_block_dot":
        shape, numel = (12, 5, 8, 128), 12 * 5 * 8 * 128
        flat = torch.randn(numel + 1, generator=g).to(dtype).to(card)
        args = (flat[1:].view(shape),
                torch.randint(0, 12, (70,), generator=g).to(card),
                torch.randint(0, 5, (4,), generator=g).to(card),
                torch.randn(4, 128, generator=g).to(dtype).to(card))
        run = ops.gather_block_dot
    else:
        flat = torch.randn(256 * 512 + 1, generator=g).to(dtype).to(card)
        args = (flat[1:].view(256, 512),
                torch.randn(512, generator=g).to(dtype).to(card))
        run = ops.blocked_matvec
    assert args[0].data_ptr() % 16 != 0
    before = ops.launch_counts()
    out = run(*args)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after[f"{kernel}[ldg]"] == before[f"{kernel}[ldg]"] + 1
    assert after[f"{kernel}[bulk]"] == before[f"{kernel}[bulk]"]
    want = run(*(t.cpu() for t in args))
    np.testing.assert_allclose(out.cpu().numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("aligned", [True, False])
def test_gather_out_of_range_indices_give_nan_rows(card, aligned):
    """idx or cols entries out of range (negative or too large) give NaN
    rows on either branch, no copy from a wild address; the other rows
    agree with the plain version."""
    g = torch.Generator().manual_seed(11)
    flat = torch.randn(6 * 4 * 8 * 64 + 1, generator=g).to(card)
    V4 = (flat[:-1] if aligned else flat[1:]).view(6, 4, 8, 64)
    qsel = torch.randn(3, 64, generator=g).to(card)
    idx = torch.tensor([0, 6, 5, -1, 2], dtype=torch.int32, device=card)
    cols = torch.tensor([1, 0, 3], dtype=torch.int32, device=card)
    out = ops.gather_block_dot(V4, idx, cols, qsel)
    torch.cuda.synchronize()
    bad = torch.tensor([False, True, False, True, False])
    assert bool(out[bad.to(card)].isnan().all())
    ok = torch.tensor([0, 2, 4])
    want = ops.gather_block_dot(V4.cpu(), idx.cpu()[ok], cols.cpu(),
                                qsel.cpu())
    np.testing.assert_allclose(out.cpu()[ok].numpy(), want.numpy(),
                               rtol=1e-5, atol=1e-5 * float(
                                   want.abs().max()))
    out = ops.gather_block_dot(V4, idx[ok.to(card)], torch.tensor(
        [1, 4, 0], dtype=torch.int32, device=card), qsel)
    assert bool(out.isnan().all())           # column 4 of 4 blocks


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("where", ["idx", "cols"])
def test_gather_stages_wholly_out_of_range_give_nan_rows(card, aligned,
                                                         where):
    """Stages in which every cell is out of range expect no bytes, so their
    ring slot is released by the producer's arrive alone: their tiles'
    rows are NaN, and the tiles of the stages around them (more chunks
    than CTAs, so a CTA reuses its slots) agree with the plain version.
    With every ``cols`` entry out of range, every row is NaN."""
    from repro_torch.kernels import stream
    g = torch.Generator().manual_seed(13)
    flat = torch.randn(6 * 4 * 8 * 64 + 1, generator=g).to(card)
    V4 = (flat[:-1] if aligned else flat[1:]).view(6, 4, 8, 64)
    qsel = torch.randn(3, 64, generator=g).to(card)
    geo = stream.gather_stream(8, 64, 4, 3, V4.data_ptr())
    assert geo.bulk == aligned
    T = 600 * geo.chunk                       # more chunks than CTAs
    idx = torch.randint(0, 6, (T,), generator=g, dtype=torch.int32)
    cols = torch.tensor([1, 0, 3], dtype=torch.int32)
    # every third chunk's tiles wholly out of range, alternately -1 and 6
    chunk_of = torch.arange(T) // geo.chunk
    bad = chunk_of % 3 == 1
    idx[bad] = torch.where(chunk_of[bad] % 2 == 0, -1, 6).to(torch.int32)
    if where == "cols":
        cols = torch.tensor([4, -1, 7], dtype=torch.int32)
        bad = torch.ones(T, dtype=torch.bool)
    out = ops.gather_block_dot(V4, idx.to(card), cols.to(card), qsel)
    torch.cuda.synchronize()
    out = out.cpu()
    assert bool(out[bad].isnan().all())
    if where == "idx":
        want = ops.gather_block_dot(V4.cpu(), idx[~bad], cols, qsel.cpu())
        np.testing.assert_allclose(out[~bad].numpy(), want.numpy(),
                                   rtol=1e-5,
                                   atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_qwen_geometry_takes_bulk_branch(card, dtype):
    """Both kernels at the qwen1.5-0.5b table's full geometry: the
    (153600, 1024) matvec and the (19200, 2, 8, 512) row and
    (19200, 8, 8, 128) coord gathers take the bulk branch with a grid of
    min(work, SMs x CTAs per SM) and agree with their plain versions."""
    from repro_torch.kernels import blocked_matvec as bmv
    from repro_torch.kernels import gather_dot as gd
    from repro_torch.kernels import ref, stream
    g = torch.Generator(device=card).manual_seed(3)
    table = (0.02 * torch.randn(153600, 1024, generator=g, device=card)
             ).to(dtype)
    q = torch.randn(1024, generator=g, device=card).to(dtype)
    before = ops.launch_counts()
    out = ops.blocked_matvec(table, q)
    geo = stream.matvec_stream(1024, 512, table.element_size(),
                               table.data_ptr())
    assert geo.bulk
    assert bmv.launched_grid(card) == _grid_of(bmv, table.device, dtype,
                                               geo, 153600)
    want = ref.blocked_matvec_ref(table, q)
    torch.testing.assert_close(out, want, rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))
    for R, C in ((8, 512), (8, 128)):
        V4 = table.view(19200, R, 1024 // C, C).transpose(1, 2).contiguous()
        idx = torch.arange(19200, dtype=torch.int32, device=card)
        cols = torch.randperm(1024 // C, generator=g, device=card).to(
            torch.int32)
        qsel = q.view(-1, C)[cols.long()].contiguous()
        out = ops.gather_block_dot(V4, idx, cols, qsel)
        geo = stream.gather_stream(R, C, V4.element_size(), 1024 // C,
                                   V4.data_ptr())
        assert geo.bulk
        assert gd.launched_grid(card) == _grid_of(gd, V4.device, dtype, geo,
                                                  19200)
        want = ref.gather_block_dot_ref(V4, idx, cols, qsel)
        torch.testing.assert_close(out, want, rtol=1e-5,
                                   atol=1e-5 * float(want.abs().max()))
        del V4
    after = ops.launch_counts()
    assert after["blocked_matvec[bulk]"] == before["blocked_matvec[bulk]"] + 1
    assert (after["gather_block_dot[bulk]"]
            == before["gather_block_dot[bulk]"] + 2)


def test_new_wrappers_check_operands(card):
    from repro_torch.kernels import blocked_matvec as bmv
    from repro_torch.kernels import gather_dot as gd
    V4 = torch.zeros(4, 3, 8, 64, device=card)
    idx = torch.zeros(2, dtype=torch.int32, device=card)
    cols = torch.zeros(1, dtype=torch.int32, device=card)
    q = torch.zeros(1, 64, device=card)
    before = ops.launch_counts()
    with pytest.raises(TypeError, match="bfloat16"):
        gd.gather_block_dot_cuda(V4, idx, cols, q.bfloat16())
    with pytest.raises(ValueError, match="is on cpu"):
        gd.gather_block_dot_cuda(V4, idx.cpu(), cols, q)
    with pytest.raises(ValueError, match="contiguous"):
        gd.gather_block_dot_cuda(V4.transpose(2, 3).contiguous()
                                 .transpose(2, 3), idx, cols, q)
    with pytest.raises(ValueError, match="not divisible"):
        bmv.blocked_matvec_cuda(torch.zeros(100, 512, device=card),
                                torch.zeros(512, device=card), tile_n=64)
    with pytest.raises(ValueError, match="is on cpu"):
        bmv.blocked_matvec_cuda(torch.zeros(64, 32, device=card),
                                torch.zeros(32))
    args, kw = _operands(203, 300, 3, 64, "row", 8, True, 1, seed=0)
    dev = [t.to(card) for t in args]
    with pytest.raises(ValueError, match="qb must be"):
        fc.fused_cascade_cuda(*dev, **kw)
    with pytest.raises(ValueError, match="cols must be"):
        fc.fused_cascade_cuda(dev[0], dev[1][0], *dev[2:], **kw)
    assert ops.launch_counts() == before
    # out-of-range gather indices give NaN rows, never a stray read
    bad = torch.tensor([1, 9], dtype=torch.int32, device=card)
    out = gd.gather_block_dot_cuda(V4, bad, cols, q)
    torch.cuda.synchronize()
    assert not bool(out[0].isnan().any()) and bool(out[1].isnan().all())


# (leading dims, W): rows 1, a chain, XLA's windows (one and two passes),
# widths off a warp, four leading dims, mamba2-130m's ``D`` (two windowed
# dimensions)
CHAIN_SHAPES = [((1,), 1024), ((32,), 128), ((8, 128), 1024),
                ((8, 128), 4096), ((2, 16), 1000), ((4096,), 33),
                ((3, 45, 2, 5), 77), ((0,), 64), ((8, 128, 64), 24)]


@pytest.mark.parametrize("lead,W", CHAIN_SHAPES)
def test_chain_sum_kernel_bitwise_plain_version(card, lead, W):
    """The chain-sum kernel bitwise its plain version, one launch per pass
    of XLA's CPU order; a non-contiguous input is made contiguous by the
    entry point and refused by the wrapper; an f16 input is refused."""
    from repro_torch.kernels import chain_sum as cs
    from repro_torch.kernels import ref
    rng = np.random.default_rng(len(lead) * W)
    g = torch.from_numpy(rng.normal(size=(*lead, W)).astype(
        np.float32)).to(torch.bfloat16)
    want = ref.chain_sum_ref(g)
    ops.reset_launch_counts()
    got = ops.chain_sum(g.to(card))
    torch.cuda.synchronize()
    assert ops.launch_counts()["chain_sum"] == len(cs.passes(lead))
    assert got.dtype == torch.bfloat16 and got.shape == (W,)
    assert torch.equal(got.cpu(), want)
    with pytest.raises(TypeError, match="bfloat16"):
        cs.chain_sum_cuda(g.to(card, torch.float16))
    if len(lead) == 1 and lead[0] > 1:
        gt = g.to(card).t()                 # (W, rows) strided
        assert torch.equal(ops.chain_sum(gt).cpu(),
                           ref.chain_sum_ref(gt.cpu().contiguous()))
        with pytest.raises(ValueError, match="contiguous"):
            cs.chain_sum_cuda(gt)
