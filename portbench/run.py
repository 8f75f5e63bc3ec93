#!/usr/bin/env python3
"""Run one cell of the port's benchmark on the card and print one JSON line.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout.  ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics and the device's
busy time from a ``torch.profiler`` window after the timed one.  Exits
with a code other than 0, printing no result, without the CUDA devices
the cell asks for.  See ``portbench/harness.py``.
"""

import time

T_TOP = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".portbench_cache"
# every cache the program or its libraries keep lives at a fixed path
# inside the checkout, so the second run of a cell there builds nothing:
# Python's bytecode of every module imported from here on too, which an
# installation without it would otherwise compile from source each run
sys.pycache_prefix = str(CACHE / "pycache")
sys.dont_write_bytecode = False
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[var] = str(CACHE / sub)
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t_top=T_TOP))
