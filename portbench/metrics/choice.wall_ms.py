"""Host milliseconds a tick in the program's ``choice`` span, the choice
(the policy's choice or the lookup; the refresh left out): its self time
(its length less its child phases'), mean over the traced device span's
ticks, on the host clock the program stamps its spans with."""
from portbench.spans import per


def read(run):
    return per(run, "choice", "wall_ns")
