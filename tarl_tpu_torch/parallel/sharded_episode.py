"""The sharded episode's entry points (ports ``tarl_tpu/parallel/
sharded_episode.py``: ``pad_agents``, ``shard_sim_state`` and
``run_episode_sharded``).

The reference places the state across its ``("dp", "sp")`` mesh, roads
and agents split over every device, and lets GSPMD partition the plain
``run_episode``.  The port has no GSPMD: its road split is the explicit
road-block episode (:mod:`.shard_map_episode`), so :func:`shard_sim_state`
pads the population to the block count and places the state on the mesh's
device, and :func:`run_episode_sharded` runs
:func:`~.shard_map_episode.run_episode_shard_map` over a road mesh of
``dp * sp`` blocks (or over the :class:`~.shard_map_episode.RoadMesh` it
is given).  The agents stay replicated: every process holds all of them.
"""
from __future__ import annotations

import torch

from ..state import AgentState, SimState
from .mesh import DeviceMesh
from .shard_map_episode import RoadMesh, make_road_mesh, run_episode_shard_map

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


def road_mesh(mesh: DeviceMesh | RoadMesh) -> RoadMesh:
    """The road mesh of ``mesh``: itself, or ``dp * sp`` road blocks on a
    ``DeviceMesh``'s one device.  A ``DeviceMesh`` over several cards
    raises: one process drives one card, so blocks spread over cards take
    a process group (``make_road_mesh(S, group=...)`` in each process)."""
    if isinstance(mesh, RoadMesh):
        return mesh
    if len(mesh.devices) != 1:
        raise NotImplementedError(
            f"a DeviceMesh over {len(mesh.devices)} devices: run one process "
            f"per card with make_road_mesh(S, group=...)")
    return make_road_mesh(mesh.shape["dp"] * mesh.shape["sp"],
                          device=mesh.devices[0])


def _to(x, device):
    """Every tensor of a (nested) named tuple on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to(f, device) for f in x))
    return x


def shard_sim_state(state: SimState, mesh: DeviceMesh | RoadMesh
                    ) -> SimState:
    """``state`` ready for :func:`run_episode_sharded` on ``mesh``: the
    population padded with :func:`pad_agents` to a multiple of the block
    count (the padding agents last in the insertion order) and every field
    on the mesh's device, the card unless the mesh was made on the CPU."""
    rm = road_mesh(mesh)
    agents = pad_agents(state.agents, rm.num_blocks)
    a, padded = state.agents.num_agents, agents.num_agents
    order = state.insert_order
    if padded > a:
        order = torch.cat([order, torch.arange(
            a, padded, dtype=order.dtype, device=order.device)])
    return _to(state._replace(agents=agents, insert_order=order), rm.device)


def run_episode_sharded(state: SimState, network, policy, num_steps: int,
                        mesh: DeviceMesh | RoadMesh, **kw
                        ) -> tuple[SimState, object]:
    """``num_steps`` ticks of :func:`shard_sim_state`'s state over the road
    blocks of ``mesh`` (``run_episode_shard_map``'s keywords pass
    through); the final state (agents padded) and the stacked logs, equal
    to the serial episode's from the padded state."""
    rm = road_mesh(mesh)
    return run_episode_shard_map(shard_sim_state(state, rm), network, policy,
                                 num_steps, rm, **kw)
