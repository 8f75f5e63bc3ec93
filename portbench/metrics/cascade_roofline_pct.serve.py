"""Kernel 1's roofline share (%) in the serving cells
(`_cascade_roofline`)."""

from portbench.metrics._cascade_roofline import share


def read(r):
    return share(r, "serve")
