"""Column maps and the packed state view (ports ``tarl_tpu/schema.py``:
``FeatureHelpers``, ``AgentFeatureHelpers``, ``ObservationFeatureHelpers``,
``pack_state``, ``agent_features_matrix`` and ``agents_from_matrix``).

The upstream simulator keeps the whole world state in one float matrix
``x[N, 3*Nmax+7]`` per node, whose columns :class:`FeatureHelpers` names.
The port keeps typed ring buffers (:mod:`~tarl_tpu_torch.state`);
:func:`pack_state` materialises the packed matrix from them, for tests that
hold the port against the upstream physics and for interop.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .device import resolve_device


@dataclasses.dataclass(frozen=True)
class FeatureHelpers:
    """Column map of the packed node row, ``width = 3*Nmax + 7`` columns.

    ``NODE_TYPE`` (``3*Nmax + 7``) lies past the width: the upstream map
    declares it and never indexes it, and so must no caller here."""

    Nmax: int = 100

    @property
    def AGENT_POSITION(self) -> slice:
        return slice(0, self.Nmax)

    @property
    def AGENT_TIME_ARRIVAL(self) -> slice:
        return slice(self.Nmax, 2 * self.Nmax)

    @property
    def AGENT_TIME_DEPARTURE(self) -> slice:
        return slice(2 * self.Nmax, 3 * self.Nmax)

    @property
    def MAX_NUMBER_OF_AGENT(self) -> int:
        return 3 * self.Nmax

    @property
    def NUMBER_OF_AGENT(self) -> int:
        return 3 * self.Nmax + 1

    @property
    def FREE_FLOW_TIME_TRAVEL(self) -> int:
        return 3 * self.Nmax + 2

    @property
    def LENGHT_OF_ROAD(self) -> int:  # [sic] the upstream spelling
        return 3 * self.Nmax + 3

    @property
    def MAX_FLOW(self) -> int:
        return 3 * self.Nmax + 4

    @property
    def SELECTED_ROAD(self) -> int:
        return 3 * self.Nmax + 5

    @property
    def ROAD_INDEX(self) -> int:
        return 3 * self.Nmax + 6

    @property
    def NODE_TYPE(self) -> int:  # declared, never indexed
        return 3 * self.Nmax + 7

    HEAD_FIFO: int = 0

    @property
    def HEAD_FIFO_ARRIVAL_TIME(self) -> int:
        return self.Nmax

    @property
    def HEAD_FIFO_DEPARTURE_TIME(self) -> int:
        return 2 * self.Nmax

    CONGESTION_FILE: int = 3

    @property
    def width(self) -> int:
        return 3 * self.Nmax + 7


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


class ObservationFeatureHelpers:
    """Column map of a node's observation: the packed row's last seven
    columns (:func:`~tarl_tpu_torch.rl.observation.node_features`'s
    order), then the head agent's nine agent columns."""

    MAX_NUMBER_OF_AGENT = 0
    NUMBER_OF_AGENT = 1
    FREE_FLOW_TIME_TRAVEL = 2
    LENGHT_OF_ROAD = 3
    MAX_FLOW = 4
    SELECTED_ROAD = 5
    ROAD_INDEX = 6
    ORIGIN = 7
    DESTINATION = 8
    DEPARTURE_TIME = 9
    ARRIVAL_TIME = 10
    AGE = 11
    SEX = 12
    EMPLOYMENT_STATUS = 13
    ON_WAY = 14
    DONE = 15


def pack_state(road_state, network, selected_road) -> torch.Tensor:
    """The packed ``x[N, 3*Nmax+7]`` float32 matrix on the state's device.

    Each road's queue is in logical order (slot 0 the head) and its dead
    slots (past ``count``) are zero.  SRC/DEST rows are zero but for
    ``ROAD_INDEX = -1`` and their ``SELECTED_ROAD``.  Agent ids are carried
    as float32, exact below 2^24.  No host read."""
    ids, arr, dep = road_state.logical_view()
    r, nmax = ids.shape
    dev = ids.device
    h = FeatureHelpers(Nmax=nmax)
    f32 = torch.float32
    live = (torch.arange(nmax, device=dev)[None, :]
            < road_state.count[:, None])
    x = torch.zeros((network.num_nodes, h.width), dtype=f32, device=dev)
    x[:r, h.AGENT_POSITION] = torch.where(live, ids, 0).to(f32)
    x[:r, h.AGENT_TIME_ARRIVAL] = torch.where(live, arr, 0.0)
    x[:r, h.AGENT_TIME_DEPARTURE] = torch.where(live, dep, 0.0)
    x[:r, h.MAX_NUMBER_OF_AGENT] = network.capacity
    x[:r, h.NUMBER_OF_AGENT] = road_state.count.to(f32)
    x[:r, h.FREE_FLOW_TIME_TRAVEL] = network.free_flow
    x[:r, h.LENGHT_OF_ROAD] = network.length
    x[:r, h.MAX_FLOW] = network.max_flow
    x[:, h.SELECTED_ROAD] = selected_road.to(f32)
    x[:r, h.ROAD_INDEX] = torch.arange(r, dtype=f32, device=dev)
    x[r:, h.ROAD_INDEX] = -1.0
    return x


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
