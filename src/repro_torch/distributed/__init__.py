"""Multi-device serving of the port (``repro.distributed``): only the
per-dispatch lane accounting so far; the sharded decode is ROADMAP.md
queue 1 item 6."""
