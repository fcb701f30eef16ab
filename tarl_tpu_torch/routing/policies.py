"""Route-choice policies (ports ``tarl_tpu/routing/policies.py``:
``random_choice``, ``ExternalChoice``, the dual shortest-path policy —
``make_shortest_path_choice`` with its ``strict_compat`` branch, and
``shortest_path_entry`` — the primal one —
``make_shortest_path_choice_primal``, ``primal_table_init``,
``primal_entry_lookup`` — and its destination-restricted form,
``make_primal_dest_parts``).

A policy is a function ``choice(state, network) -> (state, entry_road)``
that updates ``state.selected_road`` and optionally returns per-agent entry
roads for insertion.

The dual policy keeps the next-hop table over the dual nodes in
``state.next_hop`` (int32[N, N], rebuilt every ``refresh_rate``-th choice
by :func:`~tarl_tpu_torch.routing.bellman_ford.all_pairs_next_hop_nbr`,
plain PyTorch as in the reference).  The primal policies keep one flat
float32 routing scratch there: ``dist[I, D] ++ cost[R] ++ next_road[I,
D]`` (the destination-restricted form appends its int8 slot table,
bitcast).  Every
``refresh_rate``-th choice rebuilds it from the current congestion with
the relax of :mod:`~tarl_tpu_torch.routing.bellman_ford`, warm-started
from the previous table; every choice sets each road's selection to the
next road toward its head agent's destination.  Lookups read the scratch
through views.

The reference's incremental lookup (``_incremental_sel_roads``, a top_k
compaction over changed head destinations) is bitwise-identical to its
full pass; the port runs the full pass and keeps its effect on the state:
where the state carries ``sel_dest``, each lookup sets it to the head
destinations.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import (
    DEFAULT_PHYSICS,
    DEFAULT_ROUTING,
    PhysicsConfig,
    RoutingConfig,
)
from ..core.rng import choice_gumbel, split
from ..ops.scatter import scatter_set
from .bellman_ford import (
    BIG,
    all_pairs_next_hop,
    all_pairs_next_hop_nbr,
    marginal_node_costs,
    marginal_road_costs,
    node_entry_costs,
    primal_all_pairs_dist,
    primal_next_roads,
    primal_relax_next_roads,
    reference_edge_costs,
    road_costs,
)

# A refresh_rate at or above this never refreshes (free-flow table only).
_NEVER_REFRESH = 10 ** 9


class ExternalChoice(NamedTuple):
    """Apply an externally supplied multi-hot action over the full edges
    (the RL environment's choice): every active edge (u -> v) sets
    ``selected_road[u] = v``.  A valid action activates at most one edge
    per node."""

    action: torch.Tensor  # bool[Ef]

    def __call__(self, state, network):
        act = self.action.to(torch.bool)
        sel = scatter_set(state.selected_road, network.full_src,
                          network.full_dst, act)
        return state._replace(selected_road=sel), None


def random_choice(state, network, gumbel: torch.Tensor | None = None):
    """Uniform next-road choice for every road and SRC node: Gumbel-max over
    each node's choice slots (slot-major ``[KC, N]`` noise, ascending slot,
    strict ``>``).

    The key is split first and the first half written back, as in the
    reference.  ``gumbel`` (optional) replaces the ``[KC, N]`` draw from
    the second half, e.g. with the reference's own matrix in a test."""
    key, sub = split(state.key)
    scores = choice_gumbel(sub, network) if gumbel is None else gumbel
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


def _road_cost_fn(routing: RoutingConfig):
    return (marginal_road_costs if routing.cost_mode == "marginal"
            else road_costs)


def _primal_pack(dist, cost, road) -> torch.Tensor:
    """Flat float32 routing scratch ``dist[I, D] ++ cost[R] ++
    next_road[I, D]`` (road ids exact in float32 below 2^24)."""
    return torch.cat([dist.reshape(-1), cost, road.reshape(-1)])


def _primal_unpack(buf, i_n: int, d_n: int, num_roads: int):
    """``(dist[I, D], cost[R], next_road[I, D])`` as views of ``buf``."""
    n = i_n * d_n
    return (buf[:n].view(i_n, d_n), buf[n:n + num_roads],
            buf[n + num_roads:2 * n + num_roads].view(i_n, d_n))


def primal_buf_size(i_n: int, d_n: int, num_roads: int) -> int:
    """Element count of the packed primal routing scratch."""
    return 2 * i_n * d_n + num_roads


def _road_lookup(road_tab, from_inter, dest_col) -> torch.Tensor:
    """The precomputed best road at ``(from_inter, dest_col)``, int32 (-1
    where unreachable)."""
    return road_tab[from_inter.long(), dest_col.long()].to(torch.int32)


def _dest_inter(network, dest_nodes) -> torch.Tensor:
    """DEST dual-node index -> intersection ordinal (clamped: the dummy
    agent's dest 0 maps to intersection 0)."""
    return torch.clamp(
        torch.div(dest_nodes - network.num_roads - 1, 2,
                  rounding_mode="floor"),
        0, network.num_intersections - 1)


def _src_inter(network, origin_nodes) -> torch.Tensor:
    """SRC dual-node index -> intersection ordinal (clamped)."""
    return torch.clamp(
        torch.div(origin_nodes - network.num_roads, 2,
                  rounding_mode="floor"),
        0, network.num_intersections - 1)


def _warm_start(prev_dist, prev_cost, cost) -> torch.Tensor:
    """``min(prev_dist * max(ratio, 1), BIG)`` with ``ratio`` the largest
    per-road cost increase: an upper bound on every new distance, so the
    relax converges down from it.  A fresh tensor."""
    ratio = torch.max(cost / torch.clamp(prev_cost, min=1e-6))
    return torch.clamp(prev_dist * torch.clamp(ratio, min=1.0), max=BIG)


def _set_roads(state, network, sel_roads) -> torch.Tensor:
    return torch.cat([sel_roads, state.selected_road[network.num_roads:]])


def _host_dijkstra(network) -> np.ndarray:
    """Free-flow all-pairs distances by scipy's Dijkstra, called exactly as
    the reference calls it (``csr_matrix`` sums parallel roads: an upper
    bound, corrected by the first refresh); unreachable -> BIG.
    float32[I, I]."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import dijkstra as host_dijkstra

    i_n = network.num_intersections
    ok = network.inter_out_ok.cpu().numpy()
    out_r = network.inter_out_road.cpu().numpy()
    road_to = network.road_to.cpu().numpy()
    cost = network.free_flow.cpu().numpy()
    mask = ok.ravel()
    src = np.repeat(np.arange(i_n), ok.shape[1])[mask]
    roads = out_r.ravel()[mask]
    graph = csr_matrix((cost[roads], (src, road_to[roads])),
                       shape=(i_n, i_n))
    dist = host_dijkstra(graph, directed=True)
    return np.where(np.isfinite(dist), dist, BIG).astype(np.float32)


def primal_table_init(network, max_iters: int | None = None) -> torch.Tensor:
    """Free-flow primal routing scratch: the all-pairs relax on the device
    while ``I^2 <= 10^6``, scipy's Dijkstra on the host above, then the
    next-road pass on the device.  ``make_policy`` passes ``max_iters=None``
    so that the anchor table is exact."""
    i_n = network.num_intersections
    if i_n * i_n <= 1_000_000:
        dist = primal_all_pairs_dist(
            network.free_flow, network.inter_out_road, network.inter_out_ok,
            network.road_to, max_iters=max_iters)
    else:
        dist = torch.as_tensor(_host_dijkstra(network),
                               device=network.device)
    road = primal_next_roads(dist, network.free_flow, network.inter_out_road,
                             network.inter_out_ok, network.road_to)
    return _primal_pack(dist, network.free_flow, road)


def _choice_from(routing: RoutingConfig, refresh_fn, lookup_fn,
                 never_static: bool = True):
    """``choice = lookup ∘ (refresh every refresh_rate-th call)``, with the
    periodic split attached.  A ``refresh_rate`` of :data:`_NEVER_REFRESH`
    or more never refreshes where ``never_static`` (the primal
    policies); the reference's dual policy has no such rule and refreshes
    at its first call."""

    def choice(state, network):
        buf = state.next_hop
        if ((routing.refresh_rate < _NEVER_REFRESH or not never_static)
                and state.choice_count % routing.refresh_rate == 0):
            buf = refresh_fn(state, network)
        return lookup_fn(state, network, buf)._replace(next_hop=buf), None

    choice.refresh_fn = refresh_fn
    choice.lookup_fn = lookup_fn
    return choice


# --- the dual-graph policy ---------------------------------------------------

def make_shortest_path_choice(routing: RoutingConfig = DEFAULT_ROUTING,
                              physics: PhysicsConfig = DEFAULT_PHYSICS):
    """Shortest-path policy on the dual graph with a periodic refresh of
    the all-pairs next-hop table ``state.next_hop`` (int32[N, N]).

    Default: every ``refresh_rate``-th call rebuilds the table from the
    current congestion (``node_entry_costs``, or ``marginal_node_costs``
    for ``cost_mode="marginal"``) by the uncapped or ``max_bf_iters``-capped
    :func:`~tarl_tpu_torch.routing.bellman_ford.all_pairs_next_hop_nbr`;
    every call sets each road's selection to the next hop toward its head
    agent's destination (and ``sel_dest`` to those destinations where the
    state carries it).  Entrants route through :func:`shortest_path_entry`.

    ``strict_compat``: the refresh runs the edge-list table under
    :func:`~tarl_tpu_torch.routing.bellman_ford.reference_edge_costs`, and
    every one of the N rows routes by its FIFO head (the dummy agent 0 for
    SRC/DEST nodes, so entrants follow the dummy's destination, as in the
    reference simulator).  It has no periodic split."""
    if routing.strict_compat:
        def choice(state, network):
            n, r = network.num_nodes, network.num_roads
            next_hop = state.next_hop
            if state.choice_count % routing.refresh_rate == 0:
                w = reference_edge_costs(state.road, network, physics)
                _, next_hop = all_pairs_next_hop(
                    network.full_src, network.full_dst,
                    torch.zeros(n, dtype=torch.float32,
                                device=w.device), n,
                    max_iters=routing.max_bf_iters, edge_cost=w)
            head_all = torch.zeros(n, dtype=torch.int32,
                                   device=next_hop.device)
            head_all[:r] = state.road.head_ids()
            dests = state.agents.dest[head_all.long()]
            rows = torch.arange(n, device=next_hop.device)
            sel = next_hop[rows, dests.long()].to(torch.int32)
            return state._replace(selected_road=sel, next_hop=next_hop,
                                  choice_count=state.choice_count + 1), None

        return choice

    node_cost_fn = (marginal_node_costs if routing.cost_mode == "marginal"
                    else node_entry_costs)

    def refresh_fn(state, network):
        cost = node_cost_fn(state.road, network, physics)
        _, nh = all_pairs_next_hop_nbr(network.nbr, network.nbr_ok, cost,
                                       max_iters=routing.max_bf_iters)
        return nh

    def lookup_fn(state, network, next_hop):
        # Roads route their head agent toward its destination (the ring's
        # head dest: the dummy agent's dest is 0, as agents.dest[0]).
        dests = state.road.head_dests()
        rows = torch.arange(network.num_roads, device=next_hop.device)
        sel_roads = next_hop[rows, dests.long()].to(torch.int32)
        kw = {} if state.sel_dest is None else {"sel_dest": dests}
        return state._replace(selected_road=_set_roads(state, network,
                                                       sel_roads),
                              choice_count=state.choice_count + 1, **kw)

    return _choice_from(routing, refresh_fn, lookup_fn, never_static=False)


def shortest_path_entry(state, network, agent_ids=None) -> torch.Tensor:
    """Per-agent entry road from the dual next-hop table: ``next_hop[
    origin, dest]``, for the agents ``agent_ids`` where given (O(W) a
    tick)."""
    origin, dest = state.agents.origin, state.agents.dest
    if agent_ids is not None:
        origin, dest = origin[agent_ids.long()], dest[agent_ids.long()]
    return state.next_hop[origin.long(), dest.long()]


def make_shortest_path_choice_primal(
    routing: RoutingConfig = DEFAULT_ROUTING,
    physics: PhysicsConfig = DEFAULT_PHYSICS,
    network=None,
    relax=primal_relax_next_roads,
):
    """Shortest-path policy on the primal (intersection) graph with
    all-pairs tables.  ``relax`` (default the kernel wrapper) computes each
    refresh; pass ``bellman_ford.primal_relax_next_roads_plain`` to run the
    plain version on a CUDA device.  ``network`` is accepted for the
    reference's signature and not needed."""
    del network
    road_cost_fn = _road_cost_fn(routing)

    def refresh_fn(state, network):
        i_n = network.num_intersections
        cost = road_cost_fn(state.road, network, physics)
        prev_dist, prev_cost, _ = _primal_unpack(state.next_hop, i_n, i_n,
                                                 network.num_roads)
        dist0 = _warm_start(prev_dist, prev_cost, cost)
        dist0.diagonal().fill_(0.0)
        dist, road = relax(cost, network.inter_out_road,
                           network.inter_out_ok, network.road_to, dist0,
                           routing.max_bf_iters)
        return _primal_pack(dist, cost, road)

    def lookup_fn(state, network, buf):
        i_n = network.num_intersections
        _, _, road_tab = _primal_unpack(buf, i_n, i_n, network.num_roads)
        dests = state.road.head_dests()
        sel_roads = _road_lookup(road_tab, network.road_to,
                                 _dest_inter(network, dests))
        kw = {} if state.sel_dest is None else {"sel_dest": dests}
        return state._replace(selected_road=_set_roads(state, network,
                                                       sel_roads),
                              choice_count=state.choice_count + 1, **kw)

    return _choice_from(routing, refresh_fn, lookup_fn)


def primal_entry_lookup(state, network, agent_ids=None) -> torch.Tensor:
    """Per-agent entry road from the primal routing scratch: the best road
    from the origin's intersection toward the agent's destination."""
    agents = state.agents
    origin, dest = agents.origin, agents.dest
    if agent_ids is not None:
        origin, dest = origin[agent_ids.long()], dest[agent_ids.long()]
    i_n = network.num_intersections
    _, _, road_tab = _primal_unpack(state.next_hop, i_n, i_n,
                                    network.num_roads)
    return _road_lookup(road_tab, _src_inter(network, origin),
                        _dest_inter(network, dest))


# --- destination-restricted (zoned) tables ---------------------------------

def _round4(n: int) -> int:
    return ((n + 3) // 4) * 4


def _zone_k_tab(road_tab, network, d_n: int) -> torch.Tensor:
    """The next-road table as int8 out-slot indices per ROAD: ``k_tab[r,
    d]`` is the first valid slot k of ``inter_out_road[road_to[r]]`` whose
    road is ``next_road[road_to[r], d]``, K where unreachable.  The
    destination axis is padded with K to a multiple of 4.  int8[R, Dp]."""
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


def _pack_k(k_tab) -> torch.Tensor:
    """int8[R, Dp] -> float32[R, Dp // 4] by reinterpreting the bytes
    (little-endian, as the reference's ``bitcast_convert_type``)."""
    return k_tab.contiguous().view(torch.float32)


def _unpack_k(flat, r: int, dp: int) -> torch.Tensor:
    """float32[R * Dp / 4] -> int8[R, Dp], a view (inverse of
    :func:`_pack_k`)."""
    return flat.view(torch.int8).view(r, dp)


def _zone_onehot_sel(k_tab, dest_i, col_of, network) -> torch.Tensor:
    """Per-road selection from the int8 slot table: the slot in the column
    of each road's head destination (destinations outside the zone list —
    only the dummy agent's — read column 0), then that slot's road of
    ``inter_out_road[road_to]``, -1 for the sentinel K.  The reference
    evaluates the column read as a one-hot compare-and-sum over ``[R,
    Dp]`` to avoid a TPU gather; here it is a gather, with the same
    values."""
    rows = torch.arange(k_tab.shape[0], device=k_tab.device)
    k = k_tab[rows, col_of[dest_i.long()].long()]
    out_r = network.inter_out_road[network.road_to.long()]
    sel = torch.full(k.shape, -1, dtype=torch.int32, device=k.device)
    for j in range(out_r.shape[1]):
        sel = torch.where(k == j, out_r[:, j], sel)
    return sel


def make_primal_dest_parts(dest_inters,
                           routing: RoutingConfig = DEFAULT_ROUTING,
                           physics: PhysicsConfig = DEFAULT_PHYSICS,
                           network=None, relax=primal_relax_next_roads):
    """Destination-restricted primal routing: ``(choice, entry_lookup,
    table_init)`` over ``dist[I, D]`` tables whose columns are the sorted
    unique ``dest_inters``.  Same costs, refresh cadence, warm start and
    tie-breaks as the all-pairs form; the buffer also holds the per-road
    int8 slot table, rebuilt on each refresh, which the per-tick lookup
    reads.  ``relax`` as in :func:`make_shortest_path_choice_primal`."""
    del network
    dest_np = np.unique(np.asarray(dest_inters, dtype=np.int32))
    d_n = int(dest_np.shape[0])
    dp = _round4(d_n)
    on_device: dict = {}

    def tables(network):
        """``(dest_list, col_of)`` on the network's device, made once."""
        dev = network.device
        if dev not in on_device:
            col = np.zeros((network.num_intersections,), np.int32)
            col[dest_np] = np.arange(d_n, dtype=np.int32)
            on_device[dev] = (torch.as_tensor(dest_np, device=dev),
                              torch.as_tensor(col, device=dev))
        return on_device[dev]

    def pack_z(dist, cost, road_tab, network):
        k_tab = _zone_k_tab(road_tab, network, d_n)
        return torch.cat([dist.reshape(-1), cost, road_tab.reshape(-1),
                          _pack_k(k_tab).reshape(-1)])

    def unpack_z(buf, network):
        i_n, r = network.num_intersections, network.num_roads
        n = i_n * d_n
        return (buf[:n].view(i_n, d_n), buf[n:n + r],
                buf[n + r:2 * n + r].view(i_n, d_n),
                _unpack_k(buf[2 * n + r:], r, dp))

    def anchored(dist0, dest_list):
        """``dist0`` with 0 at each column's own destination row."""
        anchor = (torch.arange(dist0.shape[0], device=dist0.device)[:, None]
                  == dest_list.long()[None, :])
        return torch.where(anchor, 0.0, dist0)

    def table_init(network):
        # The uncapped relax and its next roads in one call (one launch
        # where a tiled form takes the shape).
        dest_list, _ = tables(network)
        cold = torch.full((network.num_intersections, d_n), BIG,
                          device=network.device)
        dist, road = primal_relax_next_roads(
            network.free_flow, network.inter_out_road, network.inter_out_ok,
            network.road_to, anchored(cold, dest_list), None)
        return pack_z(dist, network.free_flow, road, network)

    road_cost_fn = _road_cost_fn(routing)

    def refresh_fn(state, network):
        dest_list, _ = tables(network)
        cost = road_cost_fn(state.road, network, physics)
        prev_dist, prev_cost, _, _ = unpack_z(state.next_hop, network)
        dist0 = _warm_start(prev_dist, prev_cost, cost)
        dist, road = relax(cost, network.inter_out_road,
                           network.inter_out_ok, network.road_to,
                           anchored(dist0, dest_list), routing.max_bf_iters)
        return pack_z(dist, cost, road, network)

    def lookup_fn(state, network, buf):
        _, col_of = tables(network)
        _, _, _, k_tab = unpack_z(buf, network)
        dest_i = _dest_inter(network, state.road.head_dests())
        sel_roads = _zone_onehot_sel(k_tab, dest_i, col_of, network)
        return state._replace(selected_road=_set_roads(state, network,
                                                       sel_roads),
                              choice_count=state.choice_count + 1)

    choice = _choice_from(routing, refresh_fn, lookup_fn)

    def entry_lookup(state, network, agent_ids=None):
        _, col_of = tables(network)
        origin, dest = state.agents.origin, state.agents.dest
        if agent_ids is not None:
            origin, dest = origin[agent_ids.long()], dest[agent_ids.long()]
        _, _, road_tab, _ = unpack_z(state.next_hop, network)
        dcol = col_of[_dest_inter(network, dest).long()]
        return _road_lookup(road_tab, _src_inter(network, origin), dcol)

    return choice, entry_lookup, table_init
