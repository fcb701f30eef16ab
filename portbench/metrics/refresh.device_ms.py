"""Device milliseconds a refresh of the operations launched inside the
program's ``refresh`` span (the costs, the warm start, the relax and its
next roads, the slot table), over the traced device span's refreshes: each
operation under the innermost phase span open at its launch
(``portbench.spans``)."""
from portbench.spans import per


def read(run):
    return per(run, "refresh", "device_ns")
