"""Share (%) of the traced decode window with no device operation
running (`portbench.devtrace.idle_pct`)."""

from portbench import devtrace


def read(r):
    return devtrace.idle_pct(r["trace"]) if r.get("kind") == "decode" else None
