"""Device milliseconds a tick of the operations launched inside the
program's ``insert`` span, the insert (the windowed or backlog insert,
its host reads among them), over the traced device span: each operation
under the innermost phase span open at its launch (``portbench.spans``),
the phase's own and not its children's."""
from portbench.spans import per


def read(run):
    return per(run, "insert", "device_ns")
