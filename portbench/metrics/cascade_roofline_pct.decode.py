"""Kernel 1's roofline share (%) as the decode step's head
(`_cascade_roofline`)."""

from portbench.metrics._cascade_roofline import share


def read(r):
    return share(r, "decode")
