"""Checkpoints with ``torch.save`` (ports ``tarl_tpu/rl/checkpoint.py``).

A checkpoint is one file holding ``{"params", "opt_state", "iteration"}``,
as the reference's Orbax directory does, and, where the trainer gives it,
``"rollout"``: the environment, observation and key the next iteration
collects from, so that a resumed run continues the uninterrupted one
exactly.  The file is a pickle: restore only checkpoints this program
wrote.
"""
from __future__ import annotations

import os
from typing import Any, Optional

import torch

from ..device import resolve_device


def save_checkpoint(path: str, params: Any, opt_state: Any, iteration: int,
                    rollout: Any = None) -> None:
    """Write the checkpoint file ``path`` atomically (a temporary file
    beside it, then ``os.replace``; overwrites), making its directory."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    state = {"params": params, "opt_state": opt_state,
             "iteration": int(iteration)}
    if rollout is not None:
        state["rollout"] = rollout
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        torch.save(state, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def restore_checkpoint(path: str,
                       device: torch.device | str | None = None) -> dict:
    """The checkpoint at ``path`` with every tensor on ``device`` (``None``
    is the card)."""
    return torch.load(os.path.abspath(path),
                      map_location=resolve_device(device),
                      weights_only=False)


def latest_checkpoint(root: str) -> Optional[str]:
    """The checkpoint under ``root`` with the highest iteration (files named
    ``ckpt_<iter>``), or ``None``."""
    if not os.path.isdir(root):
        return None
    cands = [d for d in os.listdir(root) if d.startswith("ckpt_")
             and d.split("_", 1)[1].isdigit()]
    if not cands:
        return None
    cands.sort(key=lambda d: int(d.split("_")[1]))
    return os.path.join(root, cands[-1])
