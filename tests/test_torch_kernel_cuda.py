"""The CUDA fused-cascade kernel against its plain PyTorch version.

The kernel has no CPU mode, so every test here is marked ``cuda`` and
skips without a card; on one it builds the kernel and compares.  This
file imports only the port, so it runs where JAX is not installed.

Ids must be equal; scores agree to rtol 1e-5 and atol 1e-6 * max|score|
(the kernel's fp32 dot sums in another order than the plain version's
``einsum``).
"""

import numpy as np
import pytest
import torch

from repro_torch.core import boundedme_torch as bt
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
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _operands(n, N, K, block, mode, tile, cover, B, seed):
    rng = np.random.default_rng(seed)
    V = rng.normal(size=(n, N)).astype(np.float32)
    V[n // 2:n // 2 + 10] = V[:10]           # exact ties across tiles
    Q = torch.from_numpy(rng.normal(size=(B, N)).astype(np.float32))
    plan = bt.make_plan(n, N, K=K, eps=0.5, delta=0.1, value_range=8.0,
                        block=block, tile=tile, pull_mode=mode,
                        coord_block=32 if block < 128 else 128)
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
