"""The fused-cascade kernel's refusal of schedules off the flat layout.

The CUDA kernel walks each round's steps from ``rounds_meta`` alone
(``flatten_schedule``'s column-major, slot-minor layout) and never reads
a step's slot or round-end bit, so its wrapper checks the layout on the
host first (`check_layout`).  Every schedule the port builds must pass,
and a schedule whose slots, round ends or pulls lie elsewhere must be
refused.  The check runs on CPU tensors as on CUDA ones.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import boundedme_torch as bt
from repro_torch.core.schedule import END_BIT, PULL_BIT, SLOT_MASK
from repro_torch.kernels.fused_cascade import check_layout

CPU = torch.device("cpu")


def _schedule(n=400, N=4096, K=3, block=64, mode="coord", cover=False):
    plan = bt.make_plan(n, N, K=K, eps=0.5, delta=0.1, value_range=8.0,
                        block=block, pull_mode=mode,
                        coord_block=32 if block < 128 else 128)
    slotcode, rmeta, _, _, n_final = bt.schedule_operands(
        plan.schedule, cover, CPU)
    return plan, slotcode, rmeta, n_final


@pytest.mark.parametrize("n,N,K,block,mode,cover", [
    (400, 4096, 3, 64, "coord", False),
    (203, 300, 3, 64, "row", True),
    (1000, 256, 4, 128, "coord", True),
    (64, 96, 64, 64, "row", False),           # no rounds: one no-op step
    (64, 96, 64, 64, "row", True),            # no rounds, coverage only
])
def test_flat_schedules_pass(n, N, K, block, mode, cover):
    _, slotcode, rmeta, n_final = _schedule(n, N, K, block, mode, cover)
    check_layout(slotcode, rmeta, n_final)
    check_layout(slotcode, rmeta, n_final)    # a second time, from the cache


def _reverse_slots(code, plan):
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


def _move_first_end(code, plan):
    i = int(np.nonzero(code & END_BIT)[0][0])
    code[i] &= ~END_BIT
    code[i - 1] |= END_BIT


def _pull_in_a_saturated_round(code, plan):
    idle = np.nonzero((code & (PULL_BIT | END_BIT)) == END_BIT)[0]
    assert idle.size, "the plan has a round that pulls nothing"
    code[idle[0]] |= PULL_BIT


@pytest.mark.parametrize("mutate", [_reverse_slots, _move_first_end])
def test_schedules_off_the_layout_are_refused(mutate):
    plan, slotcode, rmeta, n_final = _schedule()
    code = slotcode.numpy().copy()
    mutate(code, plan)
    assert not np.array_equal(code, slotcode.numpy())
    with pytest.raises(ValueError, match="flatten_schedule"):
        check_layout(torch.from_numpy(code), rmeta, n_final)


def test_a_pull_in_a_saturated_round_is_refused():
    plan, slotcode, rmeta, n_final = _schedule(203, 300, 3, 64, "row")
    code = slotcode.numpy().copy()
    _pull_in_a_saturated_round(code, plan)
    with pytest.raises(ValueError, match="flatten_schedule"):
        check_layout(torch.from_numpy(code), rmeta, n_final)


def test_rounds_past_the_schedule_are_refused():
    _, slotcode, rmeta, n_final = _schedule()
    with pytest.raises(ValueError, match="flatten_schedule"):
        check_layout(slotcode[:-1000].clone(), rmeta, n_final)


def test_an_edit_in_place_is_checked_again():
    plan, slotcode, rmeta, n_final = _schedule()
    code = slotcode.clone()
    check_layout(code, rmeta, n_final)
    code[0] ^= 1                              # slot 0 becomes slot 1
    with pytest.raises(ValueError, match="flatten_schedule"):
        check_layout(code, rmeta, n_final)
