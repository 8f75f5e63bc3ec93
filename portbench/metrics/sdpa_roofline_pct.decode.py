"""The decode attention's share (%) of its roofline: the least time the
H100 needs to read the key and value bytes the traced steps attend to
(the ``kv_bytes`` counter of the ``layer.attention.sdpa`` spans, at
`portbench.counts.H100_SXM`'s 3.35 TB/s) over the spans' device seconds,
a ratio of sums."""

from portbench import counts
from portbench.metrics import _spans


def read(r):
    if r.get("kind") != "decode" or not r.get("traced_steps"):
        return None
    s = _spans.stats()
    a = (s or {}).get("layer.attention.sdpa")
    if not a or not a["device_s"] or not a["counters"].get("kv_bytes"):
        return None
    least = a["counters"]["kv_bytes"] / counts.H100_SXM["hbm_bytes_per_s"]
    return 100.0 * least / a["device_s"]
