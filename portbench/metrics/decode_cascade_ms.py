"""Device ms per traced decode step of the head's launches of kernel 1
(operations named ``cascade_kernel``)."""

from portbench import devtrace


def read(r):
    if r.get("kind") != "decode" or r.get("trace") is None \
            or not r["traced_steps"]:
        return None
    seconds, launches = devtrace.kernel_seconds(r["trace"], "cascade_kernel")
    return 1e3 * seconds / r["traced_steps"] if launches else None
