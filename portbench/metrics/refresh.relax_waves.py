"""The mean waves of a cluster launch of the relax: its tiles over the
clusters the card holds at once, from the program's counters
(``routing.bellman_ford.CLUSTER_WAVES`` over ``CLUSTER_LAUNCHES``, every
launch of the process: the table init's, the warm-up's and the window's,
one shape each).  None where no cluster launch ran or the program keeps
no such counter."""
import sys


def read(run):
    bf = sys.modules.get("tarl_tpu_torch.routing.bellman_ford")
    launches = getattr(bf, "CLUSTER_LAUNCHES", 0)
    waves = getattr(bf, "CLUSTER_WAVES", None)
    if not launches or waves is None:
        return None
    return waves / launches
