"""Fault-tolerant checkpoints of the port (``repro.checkpoint``)."""
