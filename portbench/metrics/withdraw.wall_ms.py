"""Host milliseconds a tick in the program's ``withdraw`` span, the
withdraw (the scan, the arrival stamps, the escalation passes): its self
time (its length less its child phases'), mean over the traced device
span's ticks, on the host clock the program stamps its spans with."""
from portbench.spans import per


def read(run):
    return per(run, "withdraw", "wall_ns")
