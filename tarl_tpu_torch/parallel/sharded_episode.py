"""Population padding for sharded runs (ports ``pad_agents`` of
``tarl_tpu/parallel/sharded_episode.py``; its GSPMD placement,
``shard_sim_state`` and ``run_episode_sharded``, is not ported yet)."""
from __future__ import annotations

import torch

from ..state import AgentState

# Departure of a padding agent: past any horizon, so it never becomes ready.
_PAD_DEPARTURE = 48 * 3600.0


def pad_agents(agents: AgentState, multiple: int) -> AgentState:
    """Append inert agents so that the population divides ``multiple``.
    Padding rows mirror the dummy agent row 0: departure at 48 h, never
    inserted, never done."""
    pad = -agents.num_agents % multiple
    if pad == 0:
        return agents
    fill = {"departure": _PAD_DEPARTURE}
    return AgentState(*(
        torch.cat([col, torch.full((pad,), fill.get(name, 0), dtype=col.dtype,
                                   device=col.device)])
        for name, col in zip(AgentState._fields, agents)
    ))
