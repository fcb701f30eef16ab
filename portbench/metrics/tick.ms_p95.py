"""The 95th percentile of the window's tick times, in milliseconds.  A
tick runs from the CUDA event recorded as the host calls the once-a-tick
callable to the next such event; on a device idle most of the tick the
events fire as the host reaches them, so the tail is the host's."""
import numpy as np


def read(run):
    if not run.tick_ms:
        return None
    return float(np.percentile(run.tick_ms, 95))
