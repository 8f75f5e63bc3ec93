"""Mean ms of the executor's dispatches in the timed window: the sum of
its ``cascade_dispatch_ms`` histogram over its count (each a host clock
that ends in ``torch.cuda.synchronize()``)."""


def read(r):
    if r.get("kind") != "serve" or not r["dispatches"]:
        return None
    return r["dispatch_ms_sum"] / r["dispatches"]
