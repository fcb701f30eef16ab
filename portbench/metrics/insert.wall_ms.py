"""Host milliseconds a tick in the program's ``insert`` span, the insert
(the windowed or backlog insert, its host reads among them): its self
time (its length less its child phases'), mean over the traced device
span's ticks, on the host clock the program stamps its spans with."""
from portbench.spans import per


def read(run):
    return per(run, "insert", "wall_ns")
