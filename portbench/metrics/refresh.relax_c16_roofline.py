"""The relax's share of its roofline where the cluster form runs with 16
blocks a cluster (Grid256x256's 65,536 rows): its least time on each
traced refresh's inputs (``roofline.relax``, the same count whatever form
computes it) over the cluster kernel's mean device time a call in the
traced span."""
from portbench.roofline.relax import share_pct


def read(run):
    return share_pct(run, "pr_cluster_kernel")
