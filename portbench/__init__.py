"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 portbench/run.py --workload NAME --seed N --seconds S --trace
0|1`` runs one cell of ``BENCHMARK.json`` on the card (`harness`).  The
yardstick lives here: the traffic (``traffic/``, read by the entries in
``drivers/``), the configurations (``configs/``), the per-layer readers
(``metrics/``), the peaks and counts (`counts`), the plain reference
(`reference`) and the limits that decide ``correct`` (``limits/``).
Nothing here imports the JAX package or JAX.
"""
