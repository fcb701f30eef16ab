"""The device mesh of the batched trainer (ports ``tarl_tpu/parallel/
mesh.py``: ``make_mesh``).

A mesh of ``dp x sp`` devices: ``dp`` data parallel over the environment
replicas, ``sp`` the update batch's second axis.  The reference builds a
``jax.sharding.Mesh``; here it is a small record of the shape and the
devices, over the cards ``torch.cuda.device_count()`` sees, or the CPU as
one device.  A mesh never asks for more devices than exist.
"""
from __future__ import annotations

import torch

from ..device import resolve_device


class DeviceMesh:
    """``shape = {"dp": dp, "sp": sp}`` and its ``dp * sp`` ``devices``,
    row-major over ``(dp, sp)``."""

    def __init__(self, devices: list, dp: int, sp: int):
        self.devices = list(devices)
        self.shape = {"dp": dp, "sp": sp}


def _devices(device) -> list:
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [torch.device("cpu")]
    if dev.type != "cuda":
        raise ValueError(f"no mesh over {dev.type} devices")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: int | None = None, *, dp: int | None = None,
              sp: int | None = None, device=None) -> DeviceMesh:
    """A ``("dp", "sp")`` mesh over the first ``n_devices`` devices of
    ``device``'s kind (``None``: every card; ``"cpu"``: the CPU, one
    device).  Defaults as the reference's: every device, ``sp = 2`` when
    the count is even and at least 4, else 1, and ``dp = n // sp``.
    Raises where ``n_devices`` exceeds the devices there are, or ``dp *
    sp`` is not ``n_devices``."""
    devices = _devices(device)
    n = n_devices or len(devices)
    if n < 1 or n > len(devices):
        raise ValueError(f"a mesh of {n} devices: {len(devices)} "
                         f"{resolve_device(device).type} device(s) exist")
    if sp is None:
        sp = 2 if (n >= 4 and n % 2 == 0) else 1
    if dp is None:
        dp = n // sp
    if dp * sp != n:
        raise ValueError(f"mesh {dp}x{sp} != {n} devices")
    return DeviceMesh(devices[:n], dp, sp)
