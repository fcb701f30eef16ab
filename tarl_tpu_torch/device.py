"""The port's default device.

Every public function that places tensors takes ``device=None``, which
means the card (``cuda``); a caller that wants the CPU passes
``device="cpu"``, as the CPU tests do.
"""
from __future__ import annotations

import torch


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` is ``cuda``."""
    return torch.device("cuda" if device is None else device)
