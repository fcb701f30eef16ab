"""Seconds of ``network.build_network`` (the tables and the renumbering
search) on the host clock, synchronised."""


def read(run):
    return run.network_s
