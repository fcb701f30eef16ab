"""Host reads of device values, counted, each named by its site.

The reference's data-dependent ``lax.while_loop``s (frontier appends, the
backlog drain, withdraw escalation) become Python loops whose conditions
are read on the host: on a CUDA tensor each read waits for the device.
Every such read goes through :func:`host_read`, which counts it, so a run
can report its syncs per tick — the number a CUDA-graph capture of the tick
would have to remove.  While spans are on
(:mod:`~tarl_tpu_torch.utils.timers`) each read is also a span named by
the loop that reads, its ``site``, whose length is the host's wait; a pass
of a loop costs one read.  The sites of the tick: ``insert.window`` (the
windowed insert's passes), ``insert.frontier`` (the backlog's frontier
appends), ``insert.drain`` (the backlog drain) and ``withdraw.escalate``;
elsewhere a site names its module.
"""
from __future__ import annotations

import torch

from ..utils.timers import span

HOST_READS = 0


def host_read(*values: torch.Tensor, site: str) -> list:
    """The Python values of 0-d tensors, fetched in one transfer; ``site``
    names the loop that reads."""
    global HOST_READS
    HOST_READS += 1
    with span(site):
        return torch.stack([v.to(torch.int64) for v in values]).tolist()


def reset() -> None:
    global HOST_READS
    HOST_READS = 0
