"""PyTorch + CUDA port of the BoundedME MIPS system (``repro``).

The package mirrors the layout of ``src/repro/`` and imports nothing of
it, nor JAX: the modules it needs from the JAX package (bounds, schedule,
configs, metrics) are kept here as copies.  Its entry points run on a
CUDA card by default and on the CPU only when the caller passes
``device="cpu"``.
"""
