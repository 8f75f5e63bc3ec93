"""How `_fused_call` hands a batch's columns to the batched cascade.

With one block permutation for the whole batch (the engine's decode
path) it must pass that one cols row expanded over the batch (stride 0,
never a copy): the CUDA kernel reads round 1 once for the batch exactly
when cols have that form.  Per-query perms give contiguous per-query
rows, and the single-query entry gets one row.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import boundedme_torch as bt
from repro_torch.kernels import ops


def _plan_and_batch(n=203, N=300, B=3, mode="row", seed=0):
    rng = np.random.default_rng(seed)
    V = torch.from_numpy(rng.normal(size=(n, N)).astype(np.float32))
    Q = torch.from_numpy(rng.normal(size=(B, N)).astype(np.float32))
    plan = bt.make_plan(n, N, K=3, eps=0.5, delta=0.1, value_range=8.0,
                        block=64, pull_mode=mode, coord_block=32)
    return V, Q, plan


def _capture(monkeypatch):
    """Replace the batched and single entries by stand-ins that record
    their cols, then run the real entries (the plain route on these CPU
    tensors)."""
    seen = []
    real_batched, real_single = ops.fused_cascade_batched, ops.fused_cascade

    def batched(*args, **kw):
        seen.append(("batched", args[4]))
        return real_batched(*args, **kw)

    def single(*args, **kw):
        seen.append(("single", args[4]))
        return real_single(*args, **kw)
    monkeypatch.setattr(bt.ops, "fused_cascade_batched", batched)
    monkeypatch.setattr(bt.ops, "fused_cascade", single)
    return seen


@pytest.mark.parametrize("mode", ["row", "coord"])
def test_fused_call_expands_a_shared_perm(monkeypatch, mode):
    V, Q, plan = _plan_and_batch(mode=mode)
    seen = _capture(monkeypatch)
    perm = bt.draw_perms(plan.n_blocks)
    bt.bounded_me_decode(V, Q, perm, plan=plan, final_exact=False,
                         device="cpu")
    (kind, cols), = seen
    assert kind == "batched" and cols.shape[0] == Q.shape[0]
    assert cols.stride(0) == 0 and cols.stride(1) == 1


@pytest.mark.parametrize("mode", ["row", "coord"])
def test_fused_call_passes_per_query_perms_contiguous(monkeypatch, mode):
    V, Q, plan = _plan_and_batch(mode=mode)
    seen = _capture(monkeypatch)
    perms = bt.draw_perms(plan.n_blocks, Q.shape[0])
    bt.bounded_me_batched(V, Q, perms, plan=plan, final_exact=False,
                          device="cpu")
    (kind, cols), = seen
    assert kind == "batched" and cols.is_contiguous()
    assert cols.shape[0] == Q.shape[0] and cols.stride(0) > 0
    assert not bool((cols == cols[:1]).all())


def test_single_query_call_passes_one_row(monkeypatch):
    V, Q, plan = _plan_and_batch()
    seen = _capture(monkeypatch)
    bt.bounded_me_blocked(V, Q[0], bt.draw_perms(plan.n_blocks), plan=plan,
                          final_exact=False, device="cpu")
    (kind, cols), = seen
    assert kind == "single" and cols.dim() == 1 and cols.is_contiguous()
