"""Device ms per traced decode step of every device operation other than
kernel 1: the model body's eager ops, cuBLAS and copies."""

from portbench import devtrace


def read(r):
    if r.get("kind") != "decode" or r.get("trace") is None \
            or not r["traced_steps"]:
        return None
    head, _ = devtrace.kernel_seconds(r["trace"], "cascade_kernel")
    every, n = devtrace.kernel_seconds(r["trace"], "")
    return 1e3 * (every - head) / r["traced_steps"] if n else None
