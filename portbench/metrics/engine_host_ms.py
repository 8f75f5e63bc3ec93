"""Host ms per answered request spent inside the engine's calls
(``submit``, ``poll``, ``result``, timed by the closed loop) and outside
its dispatches (the executor's ``cascade_dispatch_ms`` histogram), over
the timed window."""


def read(r):
    if r.get("kind") != "serve" or not r["answered"]:
        return None
    host_s = r["engine_s"] - r["dispatch_ms_sum"] / 1e3
    return 1e3 * host_s / r["answered"]
