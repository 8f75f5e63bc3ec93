"""Host ms of the executor's dispatch less its wait for the card: the
traced window's ``executor.dispatch`` spans' host seconds less those of
their ``executor.sync`` children, over the dispatches (the query copy,
permutation, launch, rescale and D2H copies)."""

from portbench.metrics import _spans


def read(r):
    s = _spans.stats() if r.get("kind") == "serve" else None
    if not s or "executor.dispatch" not in s:
        return None
    d = s["executor.dispatch"]
    sync = s.get("executor.sync", {"host_s": 0.0})["host_s"]
    return 1e3 * (d["host_s"] - sync) / d["count"]
