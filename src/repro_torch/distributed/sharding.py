"""Per-dispatch lane accounting of the fused cascade.

A copy of ``dispatch_lane_stats`` from ``repro.distributed.sharding`` on
the port's `repro_torch.core.schedule.pulls_through_round`.  The sharded
decode (``make_shard_plan``, ``sharded_bounded_me_decode``) is not ported
yet (ROADMAP.md queue 1 item 6).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.schedule import pulls_through_round

__all__ = ["dispatch_lane_stats"]


def dispatch_lane_stats(rounds_used, *, schedule, lanes: int,
                        filled: int) -> dict:
    """Per-dispatch lane accounting for one fused-cascade launch.

    A dispatch always runs ``lanes`` kernel lanes; ``filled`` of them
    carry real queries (the rest are padding the scheduler could not
    backfill in time).  ``rounds_used`` is the adaptive early-exit
    round per lane — ``(B,)`` single-device or ``(B, shards)`` sharded
    (each shard certifies independently; a lane's executed pulls are its
    per-shard mean) — or None on non-adaptive dispatches (every lane
    runs the full schedule).

    Returns a plain dict: ``occupancy`` (filled lanes), ``lane_util``
    (filled / lanes), ``executed_pull_frac`` (pulls actually executed by
    the *filled* lanes, as a fraction of the schedule's full pull
    budget — 1.0 when non-adaptive), and ``wasted_lane_frac`` (the pull
    budget burned on padding lanes).  Schedulers aggregate these per
    dispatch; they are the kernel-side half of the runtime's
    ``stats()["lanes"]`` block.
    """
    lanes = max(1, int(lanes))
    filled = max(0, min(int(filled), lanes))
    if rounds_used is None or filled == 0:
        frac = 1.0
    else:
        r = np.asarray(rounds_used)[:filled]
        if r.ndim == 1:
            r = r[:, None]          # unify: (filled, shards)
        pulls = np.asarray(pulls_through_round(schedule), np.float64)
        total = max(1.0, float(pulls[-1]))
        idx = np.clip(r.astype(np.int64), 0, len(pulls) - 1)
        frac = float(pulls[idx].mean() / total)
    return {
        "occupancy": filled,
        "lane_util": filled / lanes,
        "executed_pull_frac": frac,
        "wasted_lane_frac": (lanes - filled) / lanes,
    }
