"""The program's own span aggregates of the traced window
(`repro_torch.obs.trace.span_stats`: spans record only while a profiler
records, and the traced window is the run's only profile).  None
where the program records no spans."""

from typing import Dict, Optional


def stats() -> Optional[Dict[str, dict]]:
    """``span_stats()`` of the program, or None where it has none or
    recorded nothing."""
    try:
        from repro_torch.obs import trace
    except ImportError:
        return None
    read = getattr(trace, "span_stats", None)
    return (read() or None) if read is not None else None
