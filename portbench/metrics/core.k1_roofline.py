"""K1's share of its roofline: its least time on the traced span's inputs
(``roofline.k1``, at the ticks the traffic's ``k1_samples`` name) over its
mean device time a call in the traced span."""
from portbench.roofline.k1 import share_pct


def read(run):
    return share_pct(run)
