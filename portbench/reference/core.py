"""The tick's core (a frozen copy of the program's plain direction step,
confirm and transfers): per downstream road the Gumbel-max winner over its
eligible in-slots (gridlock escape included), the pop of the winning
upstream heads, and the tail push with arrival and departure stamps."""
from __future__ import annotations

import torch

from . import rng
from .config import DEFAULT_PHYSICS, PhysicsConfig
from .network import Network
from .scatter import scatter_set
from .state import RoadState


def free_space_mask(num_roads: int, nmax: int) -> int:
    """Largest free-space value the reference's packed word can hold."""
    return (1 << max((nmax + 1).bit_length(), 1)) - 1


def eligible_slots(
    road: RoadState,
    selected_road: torch.Tensor,
    network: Network,
    time: float,
    physics: PhysicsConfig = DEFAULT_PHYSICS,
) -> torch.Tensor:
    """bool ``[KIN, R]``: in-slot ``k`` of downstream road ``v`` may send
    its upstream's head into ``v`` this tick (the direction step's
    eligibility, gridlock escape included)."""
    r = road.num_roads
    dev = road.count.device
    head_dep = road.head_departure()
    count = road.count
    count_f = count.to(torch.float32)
    cap = network.capacity
    sel = selected_road[:r]
    sel_enc = torch.where((sel >= 0) & (sel < r), sel, r)
    iota = torch.arange(r, dtype=torch.int32, device=dev)
    free_mask = float(free_space_mask(r, road.nmax))
    buf = float(physics.congestion_buffer)

    # Downstream (v) ingredients, shared by all slots.
    space_ok = count_f < cap - buf
    v_free = cap - count_f
    v_has_slot = count_f < cap
    # Upstream (u) ingredients, per road, gathered per slot below.
    dep_ok_u = head_dep <= time
    nonempty_u = count > 0
    stuck_u = (head_dep - time) < -physics.gridlock_patience
    u_free_u = torch.clamp(cap - count_f, 0.0, free_mask).to(
        torch.int32).to(torch.float32)

    u = network.in_src_tab.long()
    nonempty = nonempty_u[u]
    u_free = u_free_u[u]
    wants_v = sel_enc[u] == iota
    mask = dep_ok_u[u] & space_ok & wants_v & nonempty
    mask = mask | (stuck_u[u] & (u_free <= buf) & (u_free <= v_free)
                   & wants_v & nonempty & v_has_slot)
    return mask & network.in_edge_ok


def winners(
    road: RoadState,
    selected_road: torch.Tensor,
    network: Network,
    time: float,
    gumbel: torch.Tensor,
    physics: PhysicsConfig = DEFAULT_PHYSICS,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per downstream road: ``(accept bool, win_src int32 (R = none),
    agent int32, dest int32)``."""
    r = road.num_roads
    dev = road.count.device
    mask = eligible_slots(road, selected_road, network, time, physics)
    neg_inf = torch.tensor(float("-inf"), device=dev)
    best = torch.full((r,), float("-inf"), dtype=torch.float32, device=dev)
    win_slot = torch.zeros((r,), dtype=torch.int64, device=dev)
    accept = torch.zeros((r,), dtype=torch.bool, device=dev)
    for k in range(network.in_src_tab.shape[0]):
        s_k = torch.where(mask[k], network.in_logit_tab[k] + gumbel[k],
                          neg_inf)
        take = s_k > best
        best = torch.where(take, s_k, best)
        win_slot = torch.where(take, k, win_slot)
        accept = accept | take

    src = network.in_src_tab.gather(0, win_slot[None, :])[0]
    src = torch.where(accept, src, r)
    src_c = torch.clamp(src, max=r - 1).long()
    agent = torch.where(accept, road.head_ids()[src_c], 0)
    accept = agent != 0          # sentinel guard
    dest = torch.where(accept, road.head_dests()[src_c], 0)
    win_src = torch.where(accept, src, r).to(torch.int32)
    return accept, win_src, agent, dest


def push_winners(
    road: RoadState,
    network: Network,
    time: float,
    accept: torch.Tensor,
    agent: torch.Tensor,
    dest: torch.Tensor,
    physics: PhysicsConfig = DEFAULT_PHYSICS,
) -> RoadState:
    """Push each accepted winner at its road's tail (slot ``(head + count) %
    Nmax``) with its arrival and departure stamps; ``count`` grows by one."""
    nmax = road.nmax
    count_f = road.count.to(torch.float32)
    slot = torch.remainder(road.head + road.count, nmax).long()
    travel = torch.maximum(
        network.free_flow,
        network.congestion_constant / (
            network.capacity + physics.congestion_softening - count_f),
    )
    hit = (torch.arange(nmax, device=slot.device)[None, :] == slot[:, None]) \
        & accept[:, None]
    return road._replace(
        fifo_ids=torch.where(hit, agent[:, None], road.fifo_ids),
        fifo_arrival=torch.where(
            hit, torch.as_tensor(time, dtype=torch.float32,
                                 device=slot.device),
            road.fifo_arrival),
        fifo_departure=torch.where(hit, (time + travel)[:, None],
                                   road.fifo_departure),
        fifo_dest=torch.where(hit, dest[:, None], road.fifo_dest),
        count=road.count + accept.to(torch.int32),
    )


def road_delta(road: RoadState, network: Network) -> torch.Tensor:
    """Congestion delay of each road's head agent times its out-degree (the
    per-source sum over outgoing turn edges), from the pre-transfer ring."""
    outdeg = network.out_edge_ok.sum(dim=0).to(torch.float32)
    return torch.clamp(
        (road.head_departure() - road.head_arrival()) - network.free_flow,
        min=0.0,
    ) * outdeg


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


def direction_confirm_plain(road: RoadState, selected_road: torch.Tensor,
                            network: Network, time: float, key: rng.Key,
                            physics: PhysicsConfig = DEFAULT_PHYSICS):
    """``(accept, win_src, agent, dest, popped)`` for one tick, the noise
    of in-slot ``k`` of road ``v`` drawn at canonical position ``k*R +
    road_order[v]`` of the tick's direction key."""
    gumbel = rng.gumbel_at_positions(key, rng.direction_positions(network))
    accept, win_src, agent, dest = winners(
        road, selected_road, network, time, gumbel, physics)
    return accept, win_src, agent, dest, popped_mask(accept, win_src)


def apply_transfers(road: RoadState, network: Network, time: float,
                    accept, agent, dest, popped,
                    physics: PhysicsConfig = DEFAULT_PHYSICS,
                    compute_delta: bool = True):
    """Push the winners at their tails, pop the confirmed heads, and the
    congestion-delay row of the pre-transfer heads."""
    delta = (road_delta(road, network) if compute_delta
             else torch.zeros((0,), dtype=torch.float32,
                              device=road.count.device))
    road = push_winners(road, network, time, accept, agent, dest, physics)
    return pop_heads(road, popped), delta
