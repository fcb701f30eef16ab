"""Host reads of device values, counted.

The reference's data-dependent ``lax.while_loop``s (frontier appends, the
backlog drain, withdraw escalation) become Python loops whose conditions
are read on the host: on a CUDA tensor each read waits for the device.
Every such read goes through :func:`host_read`, which counts it, so a run
can report its syncs per tick — the number a CUDA-graph capture of the tick
would have to remove.
"""
from __future__ import annotations

import torch

HOST_READS = 0


def host_read(*values: torch.Tensor) -> list:
    """The Python values of 0-d tensors, fetched in one transfer."""
    global HOST_READS
    HOST_READS += 1
    return torch.stack([v.to(torch.int64) for v in values]).tolist()


def reset() -> None:
    global HOST_READS
    HOST_READS = 0
