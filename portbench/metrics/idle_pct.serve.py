"""Share (%) of the traced serving window with no device operation
running (`portbench.devtrace.idle_pct`)."""

from portbench import devtrace


def read(r):
    return devtrace.idle_pct(r["trace"]) if r.get("kind") == "serve" else None
