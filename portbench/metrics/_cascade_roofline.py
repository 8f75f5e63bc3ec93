"""Kernel 1's share of its roofline in a traced window: the least time
the H100 could take for one launch (`portbench.counts.cascade_bytes` at
3.35 TB/s against `cascade_flops` at the f32 peak, the larger) over the
mean device time of the launches named ``cascade_kernel``."""

from portbench import counts, devtrace


def share(r, kind):
    if r.get("kind") != kind or r.get("trace") is None:
        return None
    seconds, launches = devtrace.kernel_seconds(r["trace"], "cascade_kernel")
    if not launches or seconds <= 0:
        return None
    plan, lanes = r["plan"], r["lanes"]
    return counts.roofline_pct(
        counts.cascade_bytes(plan, lanes, table_itemsize=r["table_itemsize"]),
        counts.cascade_flops(plan, lanes), seconds / launches,
        flops_key="f32_flops_per_s")
