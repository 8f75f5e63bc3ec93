"""Core BoundedME algorithm of the PyTorch port (see `boundedme_torch`)."""
