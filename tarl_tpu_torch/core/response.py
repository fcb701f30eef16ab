"""Response step: confirm accepted transfers and pop upstream heads (ports
``tarl_tpu/core/response.py``: ``confirm_step`` on the plain path, and the
legacy ``response_step``).

The direction step knows which upstream won each road, so the pop mask is
exactly the set of winning upstreams; each upstream wins at most once per
tick because its head proposes to a single selected downstream.

:func:`response_step` keeps the reference simulator's tail == head
confirm, for parity tests only: road u pops where some turn edge u -> v
finds v's tail holding u's head.  It copies on purpose the reference's
documented double fire (``tarl_tpu/core/response.py:6-16``): when an agent
moves u -> v onto an empty v of an opposing pair, the reverse edge v -> u
confirms too, and v pops the agent it just received.  Its per-road max
over the out-edges is ``ops.segment.segment_max`` over ``edge_src``'s
layout, built once per network (``Network.edge_src_layout``): on the card
K10's bare max.
"""
from __future__ import annotations

import torch

from ..network import Network
from ..ops.scatter import scatter_set
from ..ops.segment import segment_max
from ..state import RoadState


def popped_mask(accept: torch.Tensor, win_src: torch.Tensor) -> torch.Tensor:
    """bool[R]: road u pops iff it won some downstream road."""
    r = accept.shape[0]
    popped = torch.zeros(r, dtype=torch.bool, device=accept.device)
    return scatter_set(popped, win_src, True, accept & (win_src < r))


def pop_heads(road: RoadState, popped: torch.Tensor) -> RoadState:
    """Advance the head and shrink the count of every popped road."""
    p = popped.to(torch.int32)
    return road._replace(
        head=torch.remainder(road.head + p, road.nmax).to(torch.int32),
        count=road.count - p,
    )


def confirm_step(road: RoadState, accept: torch.Tensor,
                 win_src: torch.Tensor) -> tuple[RoadState, torch.Tensor]:
    """Pop the head of every road that won a transfer this step.  Returns
    ``(road, popped_mask)``."""
    popped = popped_mask(accept, win_src)
    return pop_heads(road, popped), popped


def response_step(road: RoadState,
                  network: Network) -> tuple[RoadState, torch.Tensor]:
    """The legacy confirm (see the module docstring): ``(road,
    popped_mask)``, ``popped_mask[R]`` the roads whose head popped."""
    u, v = network.edge_src.long(), network.edge_dst.long()
    tail = torch.remainder(road.head + torch.clamp(road.count - 1, min=0),
                           road.nmax)
    tail_id = road.fifo_ids.gather(1, tail.long()[:, None])[:, 0]
    head_id = road.fifo_ids.gather(1, road.head.long()[:, None])[:, 0]
    accepted = ((road.count[u] > 0) & (road.count[v] > 0)
                & (tail_id[v] == head_id[u]))
    popped = segment_max(accepted.to(torch.float32), network.edge_src,
                         network.num_roads, network.edge_src_layout) > 0.0
    return pop_heads(road, popped), popped
