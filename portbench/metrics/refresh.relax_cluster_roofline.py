"""The relax's share of its roofline where the cluster form runs (K3):
its least time on each traced refresh's inputs (``roofline.relax``) over
the cluster kernel's mean device time a call in the traced span."""
from portbench.roofline.relax import share_pct


def read(run):
    return share_pct(run, "pr_cluster_kernel")
