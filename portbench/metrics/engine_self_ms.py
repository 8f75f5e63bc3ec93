"""Host ms per answered request of the serving engine's own work: the
host self seconds of every ``engine.*`` span of the traced window (its
dispatches, ``executor.dispatch`` children, left out) over the count of
``engine.result``."""

from portbench.metrics import _spans


def read(r):
    s = _spans.stats() if r.get("kind") == "serve" else None
    if not s or not s.get("engine.result", {}).get("count"):
        return None
    own = sum(a["self_s"] for name, a in s.items()
              if name.startswith("engine."))
    return 1e3 * own / s["engine.result"]["count"]
