"""Milliseconds a tick between the CUDA events recorded on the stream just
before and just after the host calls the policy's ``choice`` (the random
draw and its Gumbel-max), over the window's ticks.  The events mark when
the host reached them unless the device was still busy, so on a device
idle most of the tick this is paced by the host's launches, not a device
time."""


def read(run):
    if run.marked != "choice" or not run.callable_ms:
        return None
    return sum(run.callable_ms) / len(run.callable_ms)
