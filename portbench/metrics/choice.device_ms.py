"""Device milliseconds a tick of the operations launched inside the
program's ``choice`` span, the choice (the policy's choice or the
lookup; the refresh left out), over the traced device span: each
operation under the innermost phase span open at its launch
(``portbench.spans``), the phase's own and not its children's."""
from portbench.spans import per


def read(run):
    return per(run, "choice", "device_ns")
