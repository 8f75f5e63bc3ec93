"""Device ms per traced decode step of the attention's softmax product
over the KV cache: the device seconds of the ``layer.attention.sdpa``
spans (their stream's time between each span's edges) over the traced
steps."""

from portbench.metrics import _spans


def read(r):
    if r.get("kind") != "decode" or not r.get("traced_steps"):
        return None
    s = _spans.stats()
    a = (s or {}).get("layer.attention.sdpa")
    if not a or not a["device_s"]:
        return None
    return 1e3 * a["device_s"] / r["traced_steps"]
