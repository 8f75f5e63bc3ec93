"""The optimizer of the port (``repro.optim``)."""
