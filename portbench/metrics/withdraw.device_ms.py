"""Device milliseconds a tick of the operations launched inside the
program's ``withdraw`` span, the withdraw (the scan, the arrival stamps,
the escalation passes), over the traced device span: each operation
under the innermost phase span open at its launch (``portbench.spans``),
the phase's own and not its children's."""
from portbench.spans import per


def read(run):
    return per(run, "withdraw", "device_ns")
