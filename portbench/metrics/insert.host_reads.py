"""Host reads a tick by the program's ``insert.*`` sites
(``core.sync.host_read``: one a pass of each loop) over the traced device
span's ticks, counted from the program's read spans."""
from portbench.spans import reads_per_tick


def read(run):
    return reads_per_tick(run, "insert")
