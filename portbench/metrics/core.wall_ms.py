"""Host milliseconds a tick in the program's ``core`` span, the core (K1,
the tail push and head pop, the clock and the metrics): its self time
(its length less its child phases'), mean over the traced device span's
ticks, on the host clock the program stamps its spans with."""
from portbench.spans import per


def read(run):
    return per(run, "core", "wall_ns")
