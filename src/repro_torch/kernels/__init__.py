"""Hand-written CUDA kernels of the port, their plain PyTorch versions and
the entry points that choose between them (`ops`)."""
