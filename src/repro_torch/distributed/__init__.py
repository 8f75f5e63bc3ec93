"""Multi-device serving of the port (``repro.distributed``): the serving
mesh, the sharded decode and its table placement, and the per-dispatch
lane accounting.  Model-parameter sharding waits for multi-card
training (ROADMAP.md queue 1 item 7)."""
