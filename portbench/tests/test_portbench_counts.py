"""The yardstick's counts at small shapes on the CPU: kernel 1's cells
against a brute-force walk of the plan's flat schedule, and the decode
step's FLOPs against ``torch.utils.flop_counter`` over the reference."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import counts, reference, weights
from repro_torch.core.boundedme_torch import make_plan
from repro_torch.core.schedule import flatten_schedule


def _walk(plan, lanes, survivors):
    """Distinct (tile, block) cells the flat schedule pulls for the
    batch: ``survivors(lane, round, n_arms)`` names each lane's tiles in
    a round (round 0: every tile), under one shared permutation."""
    flat = flatten_schedule(plan.schedule, final_coverage=True)
    perm = np.random.default_rng(0).permutation(plan.n_blocks)
    cells = set()
    for lane in range(lanes):
        rnd, tiles = 0, list(range(plan.n_tiles))
        for s, p, pull, end, n_surv in zip(flat.slot, flat.bpos,
                                           flat.is_pull, flat.is_end,
                                           flat.n_surv):
            if n_surv != len(tiles):
                rnd += 1
                tiles = survivors(lane, rnd, int(n_surv))
            if pull:
                cells.add((tiles[s], int(perm[p])))
    return len(cells)


PLANS = [dict(n=300, N=256, K=3, eps=0.1, delta=0.1, value_range=0.05,
              tile=8, block=32),
         dict(n=1000, N=512, K=10, eps=0.2, delta=0.1, value_range=0.3,
              tile=8, block=64)]


@pytest.mark.parametrize("kw", PLANS)
@pytest.mark.parametrize("lanes", [1, 4])
def test_cascade_cells_against_the_schedule(kw, lanes):
    plan = make_plan(**kw)
    assert sum(1 for r in plan.schedule.rounds if r.t_new) >= 3

    def spread(lane, rnd, n):          # lanes' survivors as disjoint as
        return [(lane * n + i) % plan.n_tiles for i in range(n)]

    rng = np.random.default_rng(lanes)

    def random(lane, rnd, n):
        return list(rng.choice(plan.n_tiles, n, replace=False))

    formula = counts.cascade_cells(plan, lanes)
    assert _walk(plan, lanes, spread) == formula
    assert _walk(plan, lanes, random) <= formula
    flops = counts.cascade_flops(plan, lanes)
    pulls = flatten_schedule(plan.schedule, final_coverage=True).is_pull.sum()
    assert flops == 2 * lanes * int(pulls) * plan.tile * plan.block
    b = counts.cascade_bytes(plan, lanes, table_itemsize=2)
    assert b == (formula * plan.tile * plan.block * 2
                 + lanes * plan.n_blocks * plan.block * 4 + lanes * plan.K * 8)


def test_roofline_takes_the_larger_bound():
    peaks = counts.H100_SXM
    t_bytes = 3.35e9 / peaks["hbm_bytes_per_s"]
    assert counts.roofline_pct(3.35e9, 0, 2 * t_bytes) == pytest.approx(50)
    assert counts.roofline_pct(1, 989e9, 1e-3) == pytest.approx(100)


def test_decode_flops_against_the_reference_ops():
    widths = {"d": 32, "n_heads": 4, "n_kv_heads": 2, "head_dim": 8,
              "d_ff": 48, "n_layers": 2, "vocab_rows": 64, "vocab": 64,
              "norm_eps": 1e-6, "rope_theta": 1e4, "tied": False}
    w = weights.dense_weights(widths, 3, "cpu", torch.float32)
    S = 7
    tokens = torch.arange(S)[None] % 64
    # one chunk of S queries: each position's scores and values are taken
    # over all S keys (the mask does not skip work), S tokens at context S
    with FlopCounterMode(display=False) as fc:
        h = reference.dense_hidden(w, widths, tokens, chunk=S)
        reference.head_logits(h, w["unembed"], widths["vocab"])
    want = S * counts.decode_token_flops(
        d=32, n_heads=4, n_kv_heads=2, head_dim=8, d_ff=48, n_layers=2,
        vocab=64, context=S)
    assert fc.get_total_flops() == want
