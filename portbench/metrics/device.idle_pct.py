"""The share of the traced device span in which no operation ran on the
device: 1 - (the union of device activity intervals) / (the span's wall
seconds)."""


def read(run):
    if run.trace is None or not run.trace["device"]:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
