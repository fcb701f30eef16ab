"""Milliseconds a tick in which some operation ran on the device, over the
traced device span: the union of device activity intervals over the span's
ticks.  The host's speed barely moves it, so it is the steadier yardstick
of device work beside the host-paced rate."""


def read(run):
    if run.trace is None or not run.trace["device"]:
        return None
    return 1e3 * run.trace["busy_s"] / run.trace["ticks"]
