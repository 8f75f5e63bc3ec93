#!/usr/bin/env python3
"""Where a training step's time goes on the card, for one arch.

    python3 tools/torch_train_profile.py ARCH [--layers N] [--batch B]
        [--seq S]

Builds the model at full width in its type on the card (weights from
seed 0, depth cut to ``--layers``) with the trainer's optimizer state,
runs 3 `train_step`s on `LMStream` batches to warm up, then 4 more under
``torch.profiler`` (CPU and CUDA activities), each in a
``record_function`` span and ended by ``torch.cuda.synchronize()``, with
the forward (`loss_fn`) and the AdamW update (`apply_updates`) in spans
of their own; the backward pass is the rest of the step.  The CUDA
kernels that start from the first step's span to the end of the last
synchronization are the steps'.  Prints one JSON line: ms per step (host
clock from the first span's start to the last synchronization), the host
ms of the forward and the update spans per step, device-busy ms per
step (the union of the kernels' intervals) and the device's idle share,
CUDA kernel launches per step, and the top kernels by device time with
their shares.
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
sys.path.insert(0, str(ROOT / "tools"))

WARMUP, STEPS = 3, 4


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("arch")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile, record_function
    from torch_decode_profile import busy_us
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import LMStream
    from repro_torch.models import steps
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import AdamWConfig, init_opt

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(a.arch)
    if a.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=a.layers)
    model = build_model(cfg, seed=0, device="cuda")
    opt = init_opt(dict(model.named_parameters()))
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=3, total_steps=16)
    stream = LMStream(cfg.vocab, batch=a.batch, seq=a.seq, seed=0)

    def batch(i):
        return {k: torch.from_numpy(v).cuda()
                for k, v in stream.batch_at(i).items()}

    for i in range(WARMUP):
        model, opt, _ = steps.train_step(model, opt, batch(i), cfg, opt_cfg)
    torch.cuda.synchronize()
    real = {"loss_fn": steps.loss_fn, "apply_updates": steps.apply_updates}

    def spanned(name):
        def fn(*args, **kw):
            with record_function(name):
                return real[name](*args, **kw)
        return fn

    batches = [batch(WARMUP + i) for i in range(STEPS)]
    steps.loss_fn, steps.apply_updates = (spanned("loss_fn"),
                                          spanned("apply_updates"))
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for b in batches:
                with record_function("train_step"):
                    model, opt, _ = steps.train_step(model, opt, b, cfg,
                                                     opt_cfg)
                torch.cuda.synchronize()
    finally:
        steps.loss_fn, steps.apply_updates = (real["loss_fn"],
                                              real["apply_updates"])
    events = prof.events()
    cpu = torch.autograd.DeviceType.CPU

    def spans(name):
        return [e.time_range for e in events
                if e.name == name and e.device_type == cpu]
    step_spans = spans("train_step")
    if len(step_spans) != STEPS:
        raise SystemExit(f"{len(step_spans)} train_step spans for {STEPS}")
    t0, last = (min(r.start for r in step_spans),
                max(r.end for r in step_spans))
    t1 = min((e.time_range.end for e in events
              if e.name == "cudaDeviceSynchronize"
              and e.time_range.start >= last), default=None)
    if t1 is None:
        raise SystemExit("no torch.cuda.synchronize() after the last step")
    names = ("train_step", "loss_fn", "apply_updates")
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.name not in names          # the spans' device mirrors
               and t0 <= e.time_range.start < t1]
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    step_ms = (t1 - t0) / 1e3 / STEPS
    busy_ms = busy_us((e.time_range.start, e.time_range.end)
                      for e in kernels) / 1e3 / STEPS
    host = {n: sum(r.elapsed_us() for r in spans(n)) / 1e3 / STEPS
            for n in ("loss_fn", "apply_updates")}
    total = sum(by_name.values()) or 1.0
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    print(json.dumps({
        "arch": cfg.name, "layers": cfg.n_layers, "dtype": cfg.dtype,
        "remat": cfg.remat, "batch": a.batch, "seq": a.seq,
        "device": torch.cuda.get_device_name(0), "steps": STEPS,
        "ms_per_step": step_ms,
        "host_ms_per_step": {"forward (loss_fn)": host["loss_fn"],
                             "update (apply_updates)":
                                 host["apply_updates"]},
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": 1 - busy_ms / step_ms,
        "kernel_launches_per_step": len(kernels) / STEPS,
        "top_kernels": [{"name": k[:90], "ms_per_step": v / 1e3 / STEPS,
                         "share": v / total} for k, v in top]}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
