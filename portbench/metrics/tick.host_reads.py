"""Host reads of device values a tick over the window (the program's
``core.sync.HOST_READS``): each one waits for the device."""


def read(run):
    return run.host_reads_per_tick
