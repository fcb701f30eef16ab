"""The reference's simulation state: per-road FIFO rings, agent columns,
per-SRC backlog queues, metric accumulators and the per-tick carry (a
frozen copy of the program's state types).  ``time``, ``key`` and
``insert_ptr`` are host values; every tensor lives on one device."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class RoadState(NamedTuple):
    """Per-road FIFO queues as ring buffers.  Agent id 0 is the sentinel
    non-agent; popped slots keep stale contents, so head reads are masked by
    ``count > 0``."""

    fifo_ids: torch.Tensor        # int32[R, Nmax]
    fifo_arrival: torch.Tensor    # float32[R, Nmax] — time the agent entered
    fifo_departure: torch.Tensor  # float32[R, Nmax] — earliest time it may leave
    fifo_dest: torch.Tensor       # int32[R, Nmax] — queued agent's DEST node
    head: torch.Tensor            # int32[R] — physical index of logical slot 0
    count: torch.Tensor           # int32[R]

    @property
    def num_roads(self) -> int:
        return self.fifo_ids.shape[0]

    @property
    def nmax(self) -> int:
        return self.fifo_ids.shape[1]

    def _head_read(self, arr: torch.Tensor) -> torch.Tensor:
        """``arr[r, head[r]]`` where ``count[r] > 0``, else 0 — a direct
        gather (the reference's masked row-reduction gives the same
        values)."""
        raw = arr.gather(1, self.head.long()[:, None])[:, 0]
        return torch.where(self.count > 0, raw, torch.zeros_like(raw))

    def head_ids(self) -> torch.Tensor:
        return self._head_read(self.fifo_ids)

    def head_arrival(self) -> torch.Tensor:
        return self._head_read(self.fifo_arrival)

    def head_departure(self) -> torch.Tensor:
        return self._head_read(self.fifo_departure)

    def head_dests(self) -> torch.Tensor:
        return self._head_read(self.fifo_dest)


def init_road_state(num_roads: int, nmax: int,
                    device: torch.device | str = "cpu") -> RoadState:
    device = torch.device(device)
    def z(dtype):
        return torch.zeros((num_roads, nmax), dtype=dtype, device=device)

    return RoadState(
        fifo_ids=z(torch.int32),
        fifo_arrival=z(torch.float32),
        fifo_departure=z(torch.float32),
        fifo_dest=z(torch.int32),
        head=torch.zeros((num_roads,), dtype=torch.int32, device=device),
        count=torch.zeros((num_roads,), dtype=torch.int32, device=device),
    )


class AgentState(NamedTuple):
    """Agent columns.  Row 0 is the dummy agent whose departure lies past
    the horizon; an agent is done once its arrival is stamped (> 0)."""

    origin: torch.Tensor     # int32[A] — SRC node of the origin intersection
    dest: torch.Tensor       # int32[A] — DEST node of the destination
    departure: torch.Tensor  # float32[A]
    arrival: torch.Tensor    # float32[A] — 0 until DONE
    age: torch.Tensor        # float32[A]
    sex: torch.Tensor        # float32[A]
    employed: torch.Tensor   # float32[A]
    inserted: torch.Tensor   # bool[A] — ever placed on the network

    @property
    def num_agents(self) -> int:
        return self.origin.shape[0]


def sort_agents_by_departure(agents: AgentState) -> AgentState:
    """Relabel agents 1..A-1 into nondecreasing departure order (stable);
    the dummy keeps id 0.  The simulation is the unsorted one up to the id
    permutation."""
    dep = agents.departure.cpu().numpy()
    perm = np.concatenate([[0], 1 + np.argsort(dep[1:], kind="stable")])
    idx = torch.as_tensor(perm, device=agents.origin.device)
    return AgentState(*(col[idx] for col in agents))


def init_agent_state(origin, dest, departure, age=None, sex=None,
                     employed=None,
                     device: torch.device | str = "cpu") -> AgentState:
    device = torch.device(device)
    origin = torch.as_tensor(np.asarray(origin, np.int32), device=device)
    n = origin.shape[0]

    def f32(a):
        if a is None:
            return torch.zeros((n,), dtype=torch.float32, device=device)
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return AgentState(
        origin=origin,
        dest=torch.as_tensor(np.asarray(dest, np.int32), device=device),
        departure=f32(departure),
        arrival=f32(None),
        age=f32(age),
        sex=f32(sex),
        employed=f32(employed),
        inserted=torch.zeros((n,), dtype=torch.bool, device=device),
    )


class BacklogState(NamedTuple):
    """Per-SRC ring queues of due insertion candidates, in ascending id
    (= departure) order; see :func:`~tarl_tpu_torch.core.insert.
    insert_agents_backlogged`."""

    qpack: torch.Tensor   # int32[S, Q, 2] — (agent id, DEST node); stale after pop
    qhead: torch.Tensor   # int32[S]
    qcount: torch.Tensor  # int32[S]

    @property
    def qids(self) -> torch.Tensor:
        return self.qpack[..., 0]


def init_backlog_state(capacity: int, num_srcs: int,
                       device: torch.device | str = "cpu"
                       ) -> BacklogState:
    device = torch.device(device)
    return BacklogState(
        qpack=torch.zeros((num_srcs, capacity, 2), dtype=torch.int32,
                          device=device),
        qhead=torch.zeros((num_srcs,), dtype=torch.int32, device=device),
        qcount=torch.zeros((num_srcs,), dtype=torch.int32, device=device),
    )


class MetricState(NamedTuple):
    """On-device metric accumulators."""

    hourly_counts: torch.Tensor    # int32[H, R] — link traversals per hour
    on_way_before: torch.Tensor    # float32[] — previous-tick totals
    done_before: torch.Tensor      # float32[]
    delta_tt_hourly: torch.Tensor  # float32[H, R] — hourly congestion delay


def init_metric_state(num_roads: int, num_hours: int,
                      device: torch.device | str = "cpu") -> MetricState:
    device = torch.device(device)
    return MetricState(
        hourly_counts=torch.zeros((num_hours, num_roads), dtype=torch.int32,
                                  device=device),
        on_way_before=torch.zeros((), dtype=torch.float32, device=device),
        done_before=torch.zeros((), dtype=torch.float32, device=device),
        delta_tt_hourly=torch.zeros((num_hours, num_roads),
                                    dtype=torch.float32, device=device),
    )


class SimState(NamedTuple):
    """Complete per-tick carry (module docstring for the host scalars)."""

    road: RoadState
    agents: AgentState
    selected_road: torch.Tensor   # int32[N] — SELECTED_ROAD per node
    time: float                   # seconds since midnight (float32 values)
    key: tuple[int, int]          # threefry key words (uint32 each)
    metrics: MetricState
    # Routing scratch: the shortest-path policies' packed float32 table
    # (routing.policies), or an int32[1, 1] placeholder without one.
    next_hop: torch.Tensor
    choice_count: int
    insert_order: torch.Tensor    # int32[A] — departure-sorted agent order
    insert_ptr: int
    backlog: BacklogState | None = None
    # int32[R] head destinations of the last shortest-path lookup (None
    # for policies without a table).
    sel_dest: torch.Tensor | None = None


class TickLog(NamedTuple):
    """Per-tick outputs; :func:`~tarl_tpu_torch.core.step.run_episode`
    stacks them along a leading tick axis."""

    departures: torch.Tensor       # float32[]
    arrivals: torch.Tensor         # float32[]
    on_way: torch.Tensor           # float32[]
    time: torch.Tensor             # float32[]
    road_delta_tt: torch.Tensor    # float32[R] or float32[0]
    window_saturated: torch.Tensor  # float32[] — insert overflow monitor
