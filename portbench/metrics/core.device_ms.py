"""Device milliseconds a tick of the operations launched inside the
program's ``core`` span, the core (K1, the tail push and head pop, the
clock and the metrics), over the traced device span: each operation
under the innermost phase span open at its launch (``portbench.spans``),
the phase's own and not its children's."""
from portbench.spans import per


def read(run):
    return per(run, "core", "device_ns")
