"""Live-corpus table stores of the port (``repro.store``): upserts,
deletes and appends in O(rows touched), no rebuild.

  * `DynamicTableStore` — one device: capacity slack, a dense live
    prefix, dirty-tile shadow maintenance, paging;
  * `ShardedTableStore` — the same contract over a serving mesh:
    per-shard slot pools and the per-shard ``n_valid`` vector the
    sharded cascade masks with.

Both expose ``fault_hook``, run at the top of ``flush_updates``, which
may raise `StoreFlushError` before any staged mutation is taken.
"""

from repro_torch.store.dynamic_table import DynamicTableStore, StoreFlushError
from repro_torch.store.sharded_table import ShardedTableStore

__all__ = ["DynamicTableStore", "ShardedTableStore", "StoreFlushError"]
