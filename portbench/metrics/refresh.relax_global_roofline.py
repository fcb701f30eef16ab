"""The relax's share of its roofline where the global form runs (K6): its
least time on each traced refresh's inputs (``roofline.relax``) over the
global kernel's mean device time a call in the traced span."""
from portbench.roofline.relax import share_pct


def read(run):
    return share_pct(run, "pr_global_kernel")
