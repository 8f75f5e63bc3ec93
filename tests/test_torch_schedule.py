"""The port's plan math is exactly the JAX package's.

`repro_torch.core.bounds`/`schedule` are copies and
`repro_torch.core.boundedme_torch.make_plan` a port of the reference's;
every derived quantity — round structure, flat schedule, packed kernel
operands, certification coefficients, cumulative pulls — must be equal,
not close: the kernel's control flow is built from them.
"""

import dataclasses

import numpy as np
import pytest

from repro.core import boundedme_jax as jref
from repro.core import schedule as sref
from repro_torch.core import boundedme_torch as tport
from repro_torch.core import schedule as sport

# (n, N, K, eps, delta, bound, quant_err): ragged n (n % 8 != 0), N not a
# multiple of the block, K > tile, saturated rounds, K >= n
SCHEDULES = [
    (50, 40, 2, 0.2, 0.1, "hoeffding", 0.0),
    (400, 4, 1, 0.05, 0.1, "hoeffding", 0.0),
    (7, 100, 3, 0.4, 0.05, "bernstein", 0.0),
    (64, 64, 8, 0.1, 0.1, "hoeffding", 0.01),
    (1001, 37, 5, 0.3, 0.2, "bernstein", 0.002),
    (8, 16, 8, 0.1, 0.1, "hoeffding", 0.0),
    (19200, 2, 4, 0.1, 0.1, "hoeffding", 0.0),
]

# (n, N, K, eps, delta, bound, pull_mode, block, tile)
PLANS = [
    (203, 300, 3, 0.5, 0.1, "hoeffding", "row", 64, 8),
    (203, 300, 3, 0.5, 0.1, "hoeffding", "coord", 64, 8),
    (203, 300, 3, 0.5, 0.1, "hoeffding", "hybrid", 64, 8),
    (1000, 1000, 10, 0.1, 0.05, "bernstein", "row", 512, 8),
    (1000, 1000, 10, 0.1, 0.05, "bernstein", "coord", 512, 8),
    (1000, 1000, 10, 0.1, 0.05, "hoeffding", "hybrid", 512, 4),
    (777, 200, 2, 0.3, 0.2, "hoeffding", "row", 64, 4),
    (151936, 1024, 4, 0.1, 0.1, "hoeffding", "row", 512, 8),
    (153600, 1024, 4, 0.1, 0.1, "hoeffding", "coord", 512, 8),
    (153600, 1024, 4, 0.1, 0.1, "hoeffding", "hybrid", 512, 8),
    (50, 4096, 1, 0.05, 0.01, "bernstein", "coord", 512, 8),
    (5, 3, 7, 0.2, 0.1, "hoeffding", "row", 512, 8),
]


def _assert_same_schedule(a, b):
    assert dataclasses.astuple(a) == dataclasses.astuple(b)
    assert a.total_pulls == b.total_pulls
    assert a.total_coords == b.total_coords
    assert a.speedup == b.speedup
    assert a.eps_effective == b.eps_effective
    for final_coverage in (False, True):
        fa = sref.flatten_schedule(a, final_coverage=final_coverage)
        fb = sport.flatten_schedule(b, final_coverage=final_coverage)
        np.testing.assert_array_equal(fa.stacked(), fb.stacked())
        assert (fa.t_final, fa.n_final) == (fb.t_final, fb.n_final)
        for x, y in zip(fa.packed(), fb.packed()):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    ca, cb = sref.cert_coeffs(a), sport.cert_coeffs(b)
    assert ca.dtype == cb.dtype
    np.testing.assert_array_equal(ca, cb)
    np.testing.assert_array_equal(sref.pulls_through_round(a),
                                  sport.pulls_through_round(b))


@pytest.mark.parametrize("n,N,K,eps,delta,bound,quant_err", SCHEDULES)
def test_make_schedule_equal(n, N, K, eps, delta, bound, quant_err):
    kw = dict(K=K, eps=eps, delta=delta, value_range=0.7,
              quant_err=quant_err, bound=bound)
    _assert_same_schedule(sref.make_schedule(n, N, **kw),
                          sport.make_schedule(n, N, **kw))


@pytest.mark.parametrize("n,N,K,eps,delta,bound,mode,block,tile", PLANS)
def test_make_plan_equal(n, N, K, eps, delta, bound, mode, block, tile):
    kw = dict(K=K, eps=eps, delta=delta, value_range=0.24, tile=tile,
              block=block, bound=bound, pull_mode=mode, coord_block=128)
    a, b = jref.make_plan(n, N, **kw), tport.make_plan(n, N, **kw)
    assert dataclasses.astuple(a) == dataclasses.astuple(b)
    assert (a.k_tiles, a.k_out_cap, a.total_multiplies, a.speedup,
            a.eps_effective) == (b.k_tiles, b.k_out_cap, b.total_multiplies,
                                 b.speedup, b.eps_effective)
    _assert_same_schedule(a.schedule, b.schedule)


@pytest.mark.parametrize("precision,quant_err", [("int8", None),
                                                 ("int4", None),
                                                 ("pq", 0.003)])
def test_quantized_plans_equal(precision, quant_err):
    """Plan math covers every tier, though only fp32 decodes so far."""
    kw = dict(K=4, eps=0.2, delta=0.1, value_range=0.5, block=128,
              precision=precision, quant_err=quant_err)
    a, b = jref.make_plan(2000, 512, **kw), tport.make_plan(2000, 512, **kw)
    assert dataclasses.astuple(a) == dataclasses.astuple(b)
    _assert_same_schedule(a.schedule, b.schedule)


def test_choose_pull_mode_equal():
    for n, N in ((1000, 1000), (50, 4096), (153600, 1024)):
        kw = dict(K=4, eps=0.1, delta=0.1, value_range=0.24)
        rows = (jref.make_plan(n, N, pull_mode="row", **kw),
                tport.make_plan(n, N, pull_mode="row", **kw))
        coords = (jref.make_plan(n, N, pull_mode="coord", **kw),
                  tport.make_plan(n, N, pull_mode="coord", **kw))
        for margin in (0.0, 0.1, 1.0):
            assert (jref.choose_pull_mode(rows[0], coords[0],
                                          row_margin=margin)
                    == tport.choose_pull_mode(rows[1], coords[1],
                                              row_margin=margin))


def test_qwen_row_plan_pulls_whole_table_in_round_one():
    """At qwen1.5-0.5b width and the serve defaults, round 1 already pulls
    both blocks of every tile: later rounds are no-op eliminations and the
    plan's speedup is 1.0.  Coord mode's later rounds do pull."""
    row = tport.make_plan(153600, 1024, K=4, eps=0.1, delta=0.1,
                          value_range=0.24)
    assert (row.n_tiles, row.n_blocks, len(row.schedule.rounds)) == (
        19200, 2, 15)
    assert row.schedule.rounds[0].t_cum == row.n_blocks
    assert row.schedule.speedup == 1.0
    coord = tport.make_plan(153600, 1024, K=4, eps=0.1, delta=0.1,
                            value_range=0.24, pull_mode="coord")
    assert [r.t_cum for r in coord.schedule.rounds[:4]] == [4, 6, 7, 8]


def test_schedule_rejects_bad_arguments():
    for kw in (dict(bound="nope"), dict(pull_mode="hybrid"),
               dict(quant_err=-1.0)):
        with pytest.raises(ValueError):
            sport.make_schedule(10, 10, **kw)
    with pytest.raises(ValueError):
        tport.make_plan(10, 10, pull_mode="diagonal")
    with pytest.raises(ValueError):
        tport.make_plan(10, 10, precision="pq")      # pq needs quant_err
