"""Direction step: propose and accept at most one agent transfer per road
(ports ``tarl_tpu/core/direction.py``, the plain non-roll path).

For each downstream road v and in-slot k (its k-th incoming turn edge, from
upstream u = ``in_src_tab[k, v]``) the transfer is eligible when u's head
has reached its departure time, v has space below ``capacity -
CONGESTION_FILE``, u's head selected v and u is non-empty — or by the
gridlock escape: u's head is stuck past ``gridlock_patience``, u is
effectively full, v is at least as free as u and still has a slot.  The
winner of v is the Gumbel-max over ``in_logit + gumbel`` of its eligible
slots (ascending slot, strict ``>``); the sentinel agent 0 never wins.  The
winner is pushed at v's tail with arrival ``time`` and departure ``time +
max(fftt, cc / (cap + 10 - count))``.

The reference packs u's flags, free space and selection into one int32 so
that each slot costs one TPU gather.  The serial path here reads them
directly but keeps the packed word's integral free-space semantics:
``u_free`` is ``clip(cap - count, 0, free_mask)`` truncated to an integer.
The road-sharded episode's winner (K7) takes the packed word itself
(:func:`pack_upstream`), built from the halo of head summaries.
"""
from __future__ import annotations

import torch

from ..config import DEFAULT_PHYSICS, PhysicsConfig
from ..network import Network
from ..state import RoadState


def free_space_mask(num_roads: int, nmax: int) -> int:
    """Largest free-space value the reference's packed word can hold."""
    return (1 << max((nmax + 1).bit_length(), 1)) - 1


def upstream_pack_layout(num_roads: int, nmax: int) -> tuple[int, int, int]:
    """Bit layout of the packed upstream word: ``(shift_free, shift_sel,
    free_mask)``.  Three flag bits (departure reached, non-empty, stuck past
    the gridlock patience), then the integral free space ``cap - count``
    (``bit_length(Nmax + 1)`` bits), then the selected road
    (``bit_length(R + 1)`` bits; R encodes no or an invalid selection).
    Raises where the word would need more than 31 bits."""
    bits_free = max((nmax + 1).bit_length(), 1)
    bits_sel = max((num_roads + 1).bit_length(), 1)
    if 3 + bits_free + bits_sel > 31:
        raise ValueError(
            f"upstream pack overflow: Nmax={nmax} needs {bits_free} bits and "
            f"R={num_roads} needs {bits_sel}; split the network or widen the "
            "pack word")
    return 3, 3 + bits_free, (1 << bits_free) - 1


def pack_upstream(head_departure, count, cap, sel_enc, time: float,
                  physics: PhysicsConfig, num_roads: int,
                  nmax: int) -> torch.Tensor:
    """One int32 per road of everything the downstream slot loop reads of
    its upstream: the flags, ``clip(cap - count, 0, free_mask)`` truncated
    to an integer, and ``sel_enc`` (int32, R for none), in the layout of
    :func:`upstream_pack_layout`.  Needs integral capacities, as
    ``build_network`` makes them."""
    shift_free, shift_sel, free_mask = upstream_pack_layout(num_roads, nmax)
    i32 = torch.int32
    u_free = torch.clamp(cap - count.to(torch.float32), 0.0, float(free_mask))
    return ((head_departure <= time).to(i32)
            | ((count > 0).to(i32) << 1)
            | (((head_departure - time) < -physics.gridlock_patience)
               .to(i32) << 2)
            | (u_free.to(i32) << shift_free)
            | (sel_enc.to(i32) << shift_sel))


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


def direction_step(
    road: RoadState,
    selected_road: torch.Tensor,
    network: Network,
    time: float,
    gumbel: torch.Tensor,
    physics: PhysicsConfig = DEFAULT_PHYSICS,
    compute_delta: bool = True,
) -> tuple[RoadState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns ``(road, road_delta_tt, accept, win_src)``.  ``gumbel`` is
    the ``[KIN, R]`` matrix of :func:`~tarl_tpu_torch.core.rng.
    direction_gumbel` (the reference draws it inside from a key)."""
    accept, win_src, agent, dest = winners(
        road, selected_road, network, time, gumbel, physics)
    delta = (road_delta(road, network) if compute_delta
             else torch.zeros((0,), dtype=torch.float32,
                              device=road.count.device))
    road = push_winners(road, network, time, accept, agent, dest, physics)
    return road, delta, accept, win_src
