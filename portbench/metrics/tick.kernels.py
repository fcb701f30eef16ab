"""Device kernels and memsets a tick over the traced device span."""
from portbench.trace import is_launch


def read(run):
    if run.trace is None or not run.trace["device"]:
        return None
    launches = sum(1 for *_, act in run.trace["device"] if is_launch(act))
    return launches / run.trace["ticks"]
