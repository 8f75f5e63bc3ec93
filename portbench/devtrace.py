"""Reading the device's time from a ``torch.profiler`` trace.

The traced part of a run sits inside one ``record_function`` span,
``SPAN``, that ends in ``torch.cuda.synchronize()``: the device
operations that start inside the span are the traced window's, and the
span's length is the window.  Busy time is the union of their intervals
(as ``tools/torch_decode_profile.py`` takes it).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

SPAN = "portbench_window"

#: characters kept of a device operation's name in a breakdown (a
#: template instance's name runs to thousands)
NAME_CHARS = 160


def traced():
    """A profiler (CPU and CUDA activities) whose window the caller marks
    with `window`."""
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def window():
    """The span that marks the traced window."""
    from torch.profiler import record_function
    return record_function(SPAN)


def union_us(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def _merged(intervals) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def summarize(prof) -> Optional[Dict]:
    """``{"window_s", "busy_s", "ops": [(name, start_us, end_us)],
    "device_ops", "idle_gaps"}`` of the traced window, or None when the
    trace holds no window span."""
    events = prof.events()
    cpu = torch.autograd.DeviceType.CPU
    spans = [e.time_range for e in events
             if e.name == SPAN and e.device_type == cpu]
    if not spans:
        return None
    t0 = min(r.start for r in spans)
    t1 = max(r.end for r in spans)
    ops = [(e.name, e.time_range.start, min(e.time_range.end, t1))
           for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA
           and e.name != SPAN and t0 <= e.time_range.start < t1]
    by_name: Dict[str, float] = {}
    for name, a, b in ops:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    busy = union_us((a, b) for _, a, b in ops)
    merged = _merged((a, b) for _, a, b in ops)
    edges = [t0] + [x for ab in merged for x in ab] + [t1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:10]
    host = sorted(((e.time_range.start, e.time_range.end, e.name)
                   for e in events
                   if e.device_type == cpu and e.name != SPAN
                   and e.time_range.end > t0 and e.time_range.start < t1))
    idle = []
    for length, start in gaps:
        mid = start + length / 2
        inner = [(b - a, n) for a, b, n in host if a <= mid <= b]
        idle.append([min(inner)[1] if inner else "Python, in no traced op",
                     length / 1e6])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": (t1 - t0) / 1e6, "busy_s": busy / 1e6, "ops": ops,
            "device_ops": [[n[:NAME_CHARS], v / 1e6] for n, v in top],
            "idle_gaps": idle}


def kernel_seconds(summary: Dict, needle: str) -> Tuple[float, int]:
    """Device seconds and launches of the operations whose name holds
    ``needle``."""
    hits = [(b - a) for name, a, b in summary["ops"] if needle in name]
    return sum(hits) / 1e6, len(hits)


def card() -> Dict[str, str]:
    """The card's name and power limit as ``nvidia-smi`` reads them
    (empty where it cannot be run)."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return {}
    name, limit = (x.strip() for x in out[0].split(",", 1))
    return {"name": name, "power_limit": limit}


def idle_pct(summary: Optional[Dict]) -> Optional[float]:
    """Share (%) of the traced window in which no device operation ran."""
    if summary is None or summary["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])
