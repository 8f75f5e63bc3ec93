#!/usr/bin/env python3
"""Where a decode step's time goes on the card, for one arch.

    python3 tools/torch_decode_profile.py ARCH [--layers N] [--prompt-len P]

Runs the decode demo itself (`repro_torch.launch.serve.run_decode_demo`,
the default serve mode) at full width in bf16 on the card with the bandit
head (eps = delta = 0.1), weights from seed 0 and depth cut to
``--layers``: once with 2 tokens to build the model and the head and warm
up, then with 8 tokens under ``torch.profiler`` (CPU and CUDA
activities), where each decode step records the program's own host span
``decode_step`` (`repro_torch.obs.trace.span`, which has no device-side
mirror).  The demo ends its prefill in ``torch.cuda.synchronize()``
before its first decode step, and its decode loop in another after its
last: the CUDA kernels that start from the first step's span to the end
of that second synchronization are the decode steps'.  Prints one JSON
line: the demo's own ms per token (host clock, under the profiler),
device-busy ms per step (the union of the decode kernels' intervals) and
the device's idle share, CUDA kernel launches per step, and the top
kernels by device time with their shares.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

STEPS = 8


def busy_us(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("arch")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--prompt-len", type=int, default=16)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import serve

    def demo_args(tokens: int):
        return serve.parse_args(["--arch", a.arch, "--mips", "boundedme",
                                 "--prompt-len", str(a.prompt_len),
                                 "--tokens", str(tokens)])

    cfg = serve.decode_config(demo_args(STEPS))
    if a.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=a.layers)
    model = serve.run_decode_demo(demo_args(2), cfg=cfg)["model"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = serve.run_decode_demo(demo_args(STEPS), cfg=cfg, model=model)
    events = prof.events()
    spans = [e.time_range for e in events if e.name == "decode_step"
             and e.device_type == torch.autograd.DeviceType.CPU]
    if len(spans) != STEPS:
        raise SystemExit(f"{len(spans)} decode_step spans for {STEPS} steps")
    t0, last = min(r.start for r in spans), max(r.end for r in spans)
    t1 = min((e.time_range.end for e in events
              if e.name == "cudaDeviceSynchronize"
              and e.time_range.start >= last), default=None)
    if t1 is None:
        raise SystemExit("no torch.cuda.synchronize() after the last step")
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and t0 <= e.time_range.start < t1]
    if any(e.name == "decode_step" for e in kernels):
        raise SystemExit("the decode_step span has a device-side mirror")
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_ms = busy_us((e.time_range.start, e.time_range.end)
                      for e in kernels) / 1e3 / STEPS
    total = sum(by_name.values()) or 1.0
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    print(json.dumps({
        "arch": cfg.name, "layers": cfg.n_layers, "mips": cfg.mips_mode,
        "device": torch.cuda.get_device_name(0), "steps": STEPS,
        "ms_per_step": res["ms_per_token"],
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": 1 - busy_ms / res["ms_per_token"],
        "kernel_launches_per_step": len(kernels) / STEPS,
        "top_kernels": [{"name": k[:90], "ms_per_step": v / 1e3 / STEPS,
                         "share": v / total} for k, v in top]}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
