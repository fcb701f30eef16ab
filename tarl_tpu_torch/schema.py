"""Agent-row column map (ports ``tarl_tpu/schema.py``: the
``AgentFeatureHelpers`` map, ``agent_features_matrix`` and
``agents_from_matrix``)."""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device


class AgentFeatureHelpers:
    """Column map of the reference's ``[A, 9]`` agent rows."""

    ORIGIN = 0
    DESTINATION = 1
    DEPARTURE_TIME = 2
    ARRIVAL_TIME = 3
    AGE = 4
    SEX = 5
    EMPLOYMENT_STATUS = 6
    ON_WAY = 7
    DONE = 8

    def __len__(self) -> int:
        return 9


def agents_from_matrix(mat, device: torch.device | str | None = None):
    """Build an :class:`~tarl_tpu_torch.state.AgentState` on ``device`` from
    an ``[A, 9]`` float matrix; ``inserted`` is rebuilt from ON_WAY | DONE."""
    from .state import AgentState

    m = np.asarray(mat, dtype=np.float32)
    device = resolve_device(device)
    h = AgentFeatureHelpers

    def col(c, dtype):
        return torch.as_tensor(
            np.ascontiguousarray(m[:, c]).astype(dtype), device=device
        )

    return AgentState(
        origin=col(h.ORIGIN, np.int32),
        dest=col(h.DESTINATION, np.int32),
        departure=col(h.DEPARTURE_TIME, np.float32),
        arrival=col(h.ARRIVAL_TIME, np.float32),
        age=col(h.AGE, np.float32),
        sex=col(h.SEX, np.float32),
        employed=col(h.EMPLOYMENT_STATUS, np.float32),
        inserted=torch.as_tensor(
            (m[:, h.ON_WAY] > 0) | (m[:, h.DONE] > 0), device=device
        ),
    )


def agent_features_matrix(agents) -> torch.Tensor:
    """The reference's ``[A, 9]`` float32 agent rows, on the agents'
    device."""
    return torch.stack([
        agents.origin.to(torch.float32),
        agents.dest.to(torch.float32),
        agents.departure,
        agents.arrival,
        agents.age,
        agents.sex,
        agents.employed,
        agents.on_way.to(torch.float32),
        agents.done.to(torch.float32),
    ], dim=1)
