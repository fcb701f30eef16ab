"""The 95th percentile of the program's ``tick`` spans over the traced
device span's ticks (200 at 1,200-tick replays: 10 beyond it), in
milliseconds: the tick's length as the program stamps it, with nothing of
the harness's marks or the gaps between ticks."""
import numpy as np

from portbench.spans import tick_ms


def read(run):
    ms = tick_ms(run)
    return None if not ms else float(np.percentile(ms, 95))
