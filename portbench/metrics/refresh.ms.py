"""Milliseconds a refresh between the CUDA events recorded on the stream
just before and just after the host calls the policy's ``refresh`` (the
costs, the warm start, the relax and its next roads, the slot table), over
the window's refreshes.  Paced by the host's launches where the device is
idle, as ``choice.ms``; the relax's device time is its roofline's
business."""


def read(run):
    if not run.refresh_ms:
        return None
    return sum(run.refresh_ms) / len(run.refresh_ms)
