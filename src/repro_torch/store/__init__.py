"""Live-corpus table stores of the port (``repro.store``'s single-device
store): upserts, deletes and appends in O(rows touched), no rebuild."""

from repro_torch.store.dynamic_table import DynamicTableStore, StoreFlushError

__all__ = ["DynamicTableStore", "StoreFlushError"]
