"""Observation extraction (ports ``tarl_tpu/rl/observation.py``).

``node_features`` is the 7-column tail of the reference's packed node row
(MAX_NUMBER_OF_AGENT, NUMBER_OF_AGENT, FREE_FLOW_TIME_TRAVEL,
LENGHT_OF_ROAD, MAX_FLOW, SELECTED_ROAD, ROAD_INDEX); ``agent_index`` is
the FIFO-head agent id per node (0 for SRC/DEST nodes, or each SRC's
earliest pending entrant with ``pending_entrants``).  The reference's
``jax.ops.segment_min``/``segment_sum`` calls here are XLA there too, so
they stay plain PyTorch on every device (``ops.segment.segment_min``,
``index_add_``).
"""
from __future__ import annotations

import torch

from ..config import DEFAULT_PHYSICS, PhysicsConfig
from ..network import Network
from ..ops.segment import segment_min
from ..state import SimState

NUM_OBS = 7
NUM_EXTRA_OBS = 3


def _road_index(network: Network) -> torch.Tensor:
    r, n = network.num_roads, network.num_nodes
    idx = torch.full((n,), -1.0, dtype=torch.float32, device=network.device)
    idx[:r] = torch.arange(r, dtype=torch.float32, device=network.device)
    return idx


def node_features(state: SimState, network: Network,
                  count: torch.Tensor | None = None) -> torch.Tensor:
    """float32[N, 7] in the reference's column order; ``count`` overrides
    ``state.road.count``."""
    r = network.num_roads
    if count is None:
        count = state.road.count
    feats = torch.zeros((network.num_nodes, NUM_OBS), dtype=torch.float32,
                        device=network.device)
    feats[:r, 0] = network.capacity
    feats[:r, 1] = count.to(torch.float32)
    feats[:r, 2] = network.free_flow
    feats[:r, 3] = network.length
    feats[:r, 4] = network.max_flow
    feats[:, 5] = state.selected_road.to(torch.float32)
    feats[:, 6] = _road_index(network)
    return feats


def extra_node_features(
    state: SimState, network: Network,
    physics: PhysicsConfig = DEFAULT_PHYSICS,
    count: torch.Tensor | None = None,
) -> torch.Tensor:
    """float32[N, 3] congestion columns (``RLConfig.extra_obs``): V/C
    occupancy, relative congested delay at the current occupancy, and
    ``log1p`` of each SRC's due agents not yet inserted."""
    r, n = network.num_roads, network.num_nodes
    if count is None:
        count = state.road.count
    count_f = count.to(torch.float32)
    vc = count_f / torch.clamp(network.capacity, min=1.0)
    tc = network.congestion_constant / (
        network.capacity + physics.congestion_softening - count_f)
    delay = (torch.maximum(network.free_flow, tc) - network.free_flow) / (
        torch.clamp(network.free_flow, min=1.0))
    a = state.agents
    waiting = ~a.inserted & ~a.done & (a.departure <= state.time)
    pending = torch.zeros(n, dtype=torch.float32, device=network.device)
    pending.index_add_(0, a.origin.long(), waiting.to(torch.float32))
    feats = torch.zeros((n, NUM_EXTRA_OBS), dtype=torch.float32,
                        device=network.device)
    feats[:r, 0] = vc
    feats[:r, 1] = delay
    feats[:, 2] = torch.log1p(pending)
    return feats


def agent_index(state: SimState, network: Network,
                pending_entrants: bool = False,
                head_ids: torch.Tensor | None = None) -> torch.Tensor:
    """int32[N] FIFO-head agent id per node.  With ``pending_entrants``
    each SRC node shows its earliest-departing agent not yet inserted
    (lowest id among ties) instead of agent 0.  ``head_ids`` overrides
    ``state.road.head_ids()``."""
    r, n = network.num_roads, network.num_nodes
    if head_ids is None:
        head_ids = state.road.head_ids()
    idx = torch.zeros(n, dtype=torch.int32, device=network.device)
    idx[:r] = head_ids
    if not pending_entrants:
        return idx
    a = state.agents
    num = a.num_agents
    waiting = ~a.inserted & ~a.done
    key = torch.where(waiting, a.departure, float("inf"))
    seg_min = segment_min(key, a.origin, n)
    is_min = waiting & (a.departure == seg_min[a.origin.long()])
    ids = torch.arange(num, dtype=torch.int32, device=network.device)
    first = segment_min(torch.where(is_min, ids, num), a.origin, n)
    has = (first < num) & torch.isfinite(seg_min)
    src_rows = torch.arange(n, device=network.device) >= r
    return torch.where(src_rows & has, torch.clamp(first, max=num - 1), idx)


def observe(state: SimState, network: Network,
            pending_entrants: bool = False):
    """``(node_features [N, 7], edge_features [Ef, 1], edge_index [2, Ef],
    agent_index [N])``."""
    ef = network.full_attr.reshape(-1, 1)
    ei = torch.stack([network.full_src, network.full_dst], dim=0)
    return (node_features(state, network), ef, ei,
            agent_index(state, network, pending_entrants))
