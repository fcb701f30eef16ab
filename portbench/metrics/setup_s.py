"""Seconds from the process's start to the window's first tick: imports,
generation, the network build, the initial state with its routing table,
the warm-up."""


def read(run):
    return run.setup_s
