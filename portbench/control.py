#!/usr/bin/env python3
"""The controls of ``correct``: for each seed, one short run of a cell
and, on the same sample, the reference computed one precision below the
configuration's in the program's place (TF32 for the float32 serving
cell, float8 e4m3 products for the bf16 decode cell), and where the
driver plants one, a fault's answer read the same way.  Prints one JSON
line a seed with the program's numbers, the control's, the fault's and
the limits.

    python3 portbench/control.py --workload NAME --seconds S --seeds N [N ...]

The benchmark's own runs never run a control.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import harness  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    cell = harness.find_cell(a.workload)
    driver = harness.load_module(cell.driver, "portbench_driver")
    for seed in a.seeds:
        t = time.perf_counter()
        out = driver.run(harness.Run(cell=cell, seed=seed,
                                     seconds=a.seconds, trace=False,
                                     device="cuda:0"),
                         control=True)
        print(json.dumps({
            "workload": a.workload, "seed": seed,
            "program": {k: c["value"] for k, c in out["checks"].items()},
            "control": out["control"], "fault": out.get("fault"),
            "limits": {k: c["limit"] for k, c in out["checks"].items()},
            "info": out["info"], "seconds": time.perf_counter() - t}),
            flush=True)
        del out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
