"""Host milliseconds a refresh in the program's ``refresh`` span, mean over
the traced device span's refreshes, on the host clock the program stamps
its spans with."""
from portbench.spans import per


def read(run):
    return per(run, "refresh", "wall_ns")
