"""Deterministic synthetic data of the port (``repro.data``)."""
