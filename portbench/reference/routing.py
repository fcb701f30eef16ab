"""Route choice (a frozen copy of the program's plain routing code): the
random choice, congested road costs, the plain primal Bellman-Ford relax
with its next-road pass, and the destination-restricted (zoned) primal
shortest-path policy with its periodic refresh and per-tick lookup."""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .config import DEFAULT_PHYSICS, DEFAULT_ROUTING, PhysicsConfig, \
    RoutingConfig
from .insert import host_read
from .rng import choice_gumbel, split

# The program's float32(1e18): exactly representable in float32.
BIG = float(np.float32(1e18))
# A refresh_rate at or above this never refreshes.
_NEVER_REFRESH = 10 ** 9


class Policy(NamedTuple):
    """The program's policy record, with the fields the reference uses."""

    choice: Callable
    entry: Optional[Callable] = None
    entry_lookup: Optional[Callable] = None
    needs_next_hop: bool = False
    table_init: Optional[Callable] = None
    refresh: Optional[Callable] = None
    lookup: Optional[Callable] = None
    periodic_rate: Optional[int] = None
    # ``(cost, anchored warm start)`` of a refresh of a state: the relax's
    # inputs, which the relax roofline's sweep count reads.
    refresh_inputs: Optional[Callable] = None


def random_choice(state, network):
    """Uniform next-road choice for every road and SRC node: Gumbel-max over
    each node's choice slots (ascending slot, strict ``>``); the key is
    split first and the first half written back."""
    key, sub = split(state.key)
    scores = choice_gumbel(sub, network)
    neg_inf = torch.tensor(float("-inf"), device=scores.device)
    best = torch.full((network.num_nodes,), float("-inf"),
                      dtype=torch.float32, device=scores.device)
    sel = state.selected_road
    for k in range(network.choice_dst_tab.shape[0]):
        s_k = torch.where(network.choice_ok[k], scores[k], neg_inf)
        take = s_k > best
        best = torch.where(take, s_k, best)
        sel = torch.where(take, network.choice_dst_tab[k], sel)
    return state._replace(selected_road=sel, key=key), None


def road_costs(road, network, physics: PhysicsConfig = DEFAULT_PHYSICS):
    """Congested traversal cost per road: ``max(fftt, cc / (cap + 10 -
    n))``.  float32[R]."""
    count_f = road.count.to(torch.float32)
    tc = network.congestion_constant / (
        network.capacity + physics.congestion_softening - count_f)
    return torch.maximum(network.free_flow, tc)


def marginal_road_costs(road, network,
                        physics: PhysicsConfig = DEFAULT_PHYSICS):
    """Marginal social cost per road, ``tt(n) + n * dtt/dn``."""
    count_f = road.count.to(torch.float32)
    denom = network.capacity + physics.congestion_softening - count_f
    tt_c = network.congestion_constant / denom
    tt = torch.maximum(network.free_flow, tt_c)
    ext = torch.where(tt_c > network.free_flow,
                      count_f * network.congestion_constant / (denom * denom),
                      0.0)
    return tt + ext


def slot_tables(road_cost, inter_out_road, inter_out_ok, road_to):
    """``(w[I, K], succ[I, K])``: each out-slot's road cost (BIG on padding)
    and the intersection its road leads to."""
    out = inter_out_road.long()
    w = torch.where(inter_out_ok, road_cost[out], BIG)
    return w, road_to[out].long()


def sweep(dist, w, succ):
    """One Jacobi sweep: a slot loop of full-row gathers."""
    new = dist
    for k in range(succ.shape[1]):
        new = torch.minimum(new, w[:, k, None] + dist[succ[:, k]])
    return new


def next_roads(dist, w, succ, inter_out_road):
    best = torch.full_like(dist, BIG)
    road = torch.full_like(dist, -1.0)
    for k in range(succ.shape[1]):
        cand = w[:, k, None] + dist[succ[:, k]]
        take = cand < best
        best = torch.where(take, cand, best)
        road = torch.where(
            take, inter_out_road[:, k].to(torch.float32)[:, None], road)
    return torch.where(best < BIG, road, -1.0)


def relax_next_roads(road_cost, inter_out_road, inter_out_ok, road_to,
                     dist0, max_iters: int | None):
    """``(dist, next_road)``: ``max_iters`` Jacobi sweeps (None: until
    converged, at most ``I - 1``) from the anchored ``dist0``, then the
    out-road of the first slot attaining each minimum (-1.0 where it is not
    below BIG)."""
    i_n = inter_out_road.shape[0]
    iters = i_n - 1 if max_iters is None else int(max_iters)
    w, succ = slot_tables(road_cost, inter_out_road, inter_out_ok, road_to)
    dist = dist0
    for _ in range(iters):
        new = sweep(dist, w, succ)
        if max_iters is None and not host_read(torch.any(new < dist))[0]:
            break
        dist = new
    return dist, next_roads(dist, w, succ, inter_out_road)


def dest_inter(network, dest_nodes) -> torch.Tensor:
    """DEST dual-node index -> intersection ordinal (clamped: the dummy
    agent's dest 0 maps to intersection 0)."""
    return torch.clamp(
        torch.div(dest_nodes - network.num_roads - 1, 2,
                  rounding_mode="floor"),
        0, network.num_intersections - 1)


def src_inter(network, origin_nodes) -> torch.Tensor:
    return torch.clamp(
        torch.div(origin_nodes - network.num_roads, 2,
                  rounding_mode="floor"),
        0, network.num_intersections - 1)


def warm_start(prev_dist, prev_cost, cost) -> torch.Tensor:
    """``min(prev_dist * max(ratio, 1), BIG)`` with ``ratio`` the largest
    per-road cost increase: an upper bound on every new distance."""
    ratio = torch.max(cost / torch.clamp(prev_cost, min=1e-6))
    return torch.clamp(prev_dist * torch.clamp(ratio, min=1.0), max=BIG)


def _set_roads(state, network, sel_roads) -> torch.Tensor:
    return torch.cat([sel_roads, state.selected_road[network.num_roads:]])


def _round4(n: int) -> int:
    return ((n + 3) // 4) * 4


def zone_k_tab(road_tab, network, d_n: int) -> torch.Tensor:
    """The next-road table as int8 out-slot indices per road, the
    destination axis padded with K to a multiple of 4.  int8[R, Dp]."""
    k_n = network.inter_out_road.shape[1]
    if k_n >= 127:
        raise ValueError("int8 slot index: out-degree bound exceeds int8")
    k_i = torch.full(road_tab.shape, k_n, dtype=torch.int8,
                     device=road_tab.device)
    for k in range(k_n - 1, -1, -1):
        m = network.inter_out_ok[:, k, None] & (
            road_tab == network.inter_out_road[:, k].to(torch.float32)[:, None])
        k_i = torch.where(m, k, k_i)
    k_i = torch.where(road_tab < 0.0, k_n, k_i)
    k_tab = k_i[network.road_to.long()]
    dp = _round4(d_n)
    if dp != d_n:
        pad = torch.full((k_tab.shape[0], dp - d_n), k_n, dtype=torch.int8,
                         device=k_tab.device)
        k_tab = torch.cat([k_tab, pad], dim=1)
    return k_tab


def zone_sel(k_tab, dest_i, col_of, network) -> torch.Tensor:
    """Per-road selection from the int8 slot table: the slot in the column
    of each road's head destination, then that slot's road, -1 for the
    sentinel K."""
    rows = torch.arange(k_tab.shape[0], device=k_tab.device)
    k = k_tab[rows, col_of[dest_i.long()].long()]
    out_r = network.inter_out_road[network.road_to.long()]
    sel = torch.full(k.shape, -1, dtype=torch.int32, device=k.device)
    for j in range(out_r.shape[1]):
        sel = torch.where(k == j, out_r[:, j], sel)
    return sel


def zoned_policy(dest_inters, routing: RoutingConfig = DEFAULT_ROUTING,
                 physics: PhysicsConfig = DEFAULT_PHYSICS) -> Policy:
    """The destination-restricted primal shortest-path policy over
    ``dist[I, D]`` tables whose columns are the sorted unique
    ``dest_inters``; the routing scratch is ``dist ++ cost ++ next_road ++``
    the int8 slot table bitcast to float32."""
    dest_np = np.unique(np.asarray(dest_inters, dtype=np.int32))
    d_n = int(dest_np.shape[0])
    dp = _round4(d_n)
    on_device: dict = {}

    def tables(network):
        dev = network.device
        if dev not in on_device:
            col = np.zeros((network.num_intersections,), np.int32)
            col[dest_np] = np.arange(d_n, dtype=np.int32)
            on_device[dev] = (torch.as_tensor(dest_np, device=dev),
                              torch.as_tensor(col, device=dev))
        return on_device[dev]

    def pack(dist, cost, road_tab, network):
        k_tab = zone_k_tab(road_tab, network, d_n)
        return torch.cat([dist.reshape(-1), cost, road_tab.reshape(-1),
                          k_tab.contiguous().view(torch.float32).reshape(-1)])

    def unpack(buf, network):
        i_n, r = network.num_intersections, network.num_roads
        n = i_n * d_n
        return (buf[:n].view(i_n, d_n), buf[n:n + r],
                buf[n + r:2 * n + r].view(i_n, d_n),
                buf[2 * n + r:].view(torch.int8).view(r, dp))

    def anchored(dist0, dest_list):
        anchor = (torch.arange(dist0.shape[0], device=dist0.device)[:, None]
                  == dest_list.long()[None, :])
        return torch.where(anchor, 0.0, dist0)

    def table_init(network):
        dest_list, _ = tables(network)
        cold = torch.full((network.num_intersections, d_n), BIG,
                          device=network.device)
        dist, road = relax_next_roads(
            network.free_flow, network.inter_out_road, network.inter_out_ok,
            network.road_to, anchored(cold, dest_list), None)
        return pack(dist, network.free_flow, road, network)

    road_cost_fn = (marginal_road_costs if routing.cost_mode == "marginal"
                    else road_costs)

    def refresh_inputs(state, network):
        """``(cost, anchored warm start)`` of a refresh of ``state``."""
        dest_list, _ = tables(network)
        cost = road_cost_fn(state.road, network, physics)
        prev_dist, prev_cost, _, _ = unpack(state.next_hop, network)
        return cost, anchored(warm_start(prev_dist, prev_cost, cost),
                              dest_list)

    def refresh(state, network):
        cost, dist0 = refresh_inputs(state, network)
        dist, road = relax_next_roads(
            cost, network.inter_out_road, network.inter_out_ok,
            network.road_to, dist0, routing.max_bf_iters)
        return pack(dist, cost, road, network)

    def lookup(state, network, buf):
        _, col_of = tables(network)
        _, _, _, k_tab = unpack(buf, network)
        dest_i = dest_inter(network, state.road.head_dests())
        sel_roads = zone_sel(k_tab, dest_i, col_of, network)
        return state._replace(selected_road=_set_roads(state, network,
                                                       sel_roads),
                              choice_count=state.choice_count + 1)

    def choice(state, network):
        buf = state.next_hop
        if (routing.refresh_rate < _NEVER_REFRESH
                and state.choice_count % routing.refresh_rate == 0):
            buf = refresh(state, network)
        return lookup(state, network, buf)._replace(next_hop=buf), None

    def entry_lookup(state, network, agent_ids=None):
        _, col_of = tables(network)
        origin, dest = state.agents.origin, state.agents.dest
        if agent_ids is not None:
            origin, dest = origin[agent_ids.long()], dest[agent_ids.long()]
        _, _, road_tab, _ = unpack(state.next_hop, network)
        dcol = col_of[dest_inter(network, dest).long()]
        return road_tab[src_inter(network, origin).long(),
                        dcol.long()].to(torch.int32)

    periodic = {}
    if routing.refresh_rate < _NEVER_REFRESH:
        periodic = {"refresh": refresh, "lookup": lookup,
                    "periodic_rate": int(routing.refresh_rate)}
    return Policy(choice=choice, entry=lambda s, n: entry_lookup(s, n),
                  entry_lookup=entry_lookup, table_init=table_init,
                  refresh_inputs=refresh_inputs, **periodic)


def make_policy(algo: str, routing: RoutingConfig = DEFAULT_ROUTING,
                physics: PhysicsConfig = DEFAULT_PHYSICS,
                dest_inters=None) -> Policy:
    """``"random"``, or ``"dijkstra"`` on the zoned primal backend (the
    only shortest-path form the benchmark's cells drive)."""
    if algo == "random":
        return Policy(choice=random_choice)
    if algo != "dijkstra" or dest_inters is None \
            or routing.backend != "primal" or routing.strict_compat:
        raise ValueError("the reference has the random policy and the zoned "
                         "primal shortest-path policy only")
    return zoned_policy(dest_inters, routing, physics)
