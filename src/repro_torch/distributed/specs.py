"""Placement of a served table over the serving mesh.

The PyTorch counterpart of ``serving_table_sharding`` in
``repro.distributed.specs``.  Where the JAX package returns a
``NamedSharding`` and ``device_put`` moves the table, the port places
the table itself: padded to ``shards * n_local`` rows, split into row
shards, and each shard laid out tile-major once on its device.  The
parameter, batch and cache specs wait for multi-card training
(ROADMAP.md queue 1 item 7).
"""

from __future__ import annotations

from typing import List

import torch

from repro_torch.core.boundedme_torch import BlockedPlan, tile_table

__all__ = ["serving_table_sharding"]


def serving_table_sharding(table, mesh, plan: BlockedPlan
                           ) -> List[torch.Tensor]:
    """The row shards of an (n, N) table, one per mesh device.

    ``plan`` is the shard plan (`repro_torch.distributed.sharding.
    make_shard_plan`): shard s holds rows ``[s * plan.n, (s + 1) *
    plan.n)``, zero rows past n, laid out by `tile_table` on
    ``mesh.devices[s]`` in the table's own type (float32 or bfloat16).
    Only one shard's rows are in flight at a time, so no device ever
    holds the whole table twice.
    """
    table = torch.as_tensor(table)
    n, N = table.shape
    S = len(mesh.devices)
    n_local = plan.n
    if plan.N != N or S * n_local < n:
        raise ValueError(f"plan of {n_local} rows x {plan.N} cannot shard a "
                         f"({n}, {N}) table {S} ways")
    out = []
    for s, dev in enumerate(mesh.devices):
        rows = table[s * n_local:min(n, (s + 1) * n_local)]
        if rows.shape[0] < n_local:           # ragged: pad the last shards
            rows = torch.nn.functional.pad(
                rows.to(dev), (0, 0, 0, n_local - rows.shape[0]))
        out.append(tile_table(rows, plan, dev))
    return out
