"""Static user-equilibrium (and system-optimal) traffic assignment (ports
``tarl_tpu/algorithms/msa.py``: ``MSAResult``, ``build_od_demand``,
``assign_all_or_nothing``, ``solve_msa``, ``solve_frank_wolfe``,
``solve_assignment``, ``run_msa`` and the host oracle ``_dijkstra_host`` /
``run_msa_host``).

Each iteration prices the roads by BPR (or marginal BPR) costs of the
current flows, assigns every OD volume along its shortest path (the
all-pairs next-hop table of :func:`~tarl_tpu_torch.routing.bellman_ford.
all_pairs_next_hop_nbr`, walked by all OD pairs in lockstep) and moves the
flows toward that assignment: by ``1/it`` (MSA) or by the exact bisection
line search of Frank-Wolfe.  Plain PyTorch on the network's device, as the
reference is plain ``jnp``; each iteration reads its stopping test on the
host (one counted read), and the lockstep walk reads every
:data:`~tarl_tpu_torch.routing.bellman_ford.CHECK_EVERY` hops whether an
OD pair is still walking.  The walk stops there, where the reference
takes ``N`` hops: the hops after the last pair arrives add nothing, so
the flows are the same.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import DEFAULT_MSA, MSAConfig
from ..core.sync import host_read
from ..metrics.equilibrium import bpr_cost, bpr_marginal_cost
from ..network import Network
from ..routing.bellman_ford import CHECK_EVERY, all_pairs_next_hop_nbr
from ..state import AgentState

_INF = float("inf")


class MSAResult(NamedTuple):
    flow: torch.Tensor        # float32[R]: the road flows
    gap: torch.Tensor         # float32[]: the last L1 flow change
    iterations: int
    # Frank-Wolfe's relative gap sum(c (f - aux)) / sum(c f) at the final
    # flows (inf for MSA, which tracks the L1 gap only).
    rel_gap: torch.Tensor | float = _INF
    # Whether the solver's own stopping rule held within max_iter.
    converged: bool = False


def build_od_demand(agents: AgentState, num_nodes: int):
    """``(origins, dests, volumes)`` of the unique OD pairs of the trips,
    the dummy row 0 left out, on the agents' device (int32, int32,
    float32)."""
    o = agents.origin[1:].cpu().numpy()
    d = agents.dest[1:].cpu().numpy()
    flat = o.astype(np.int64) * num_nodes + d
    uniq, counts = np.unique(flat, return_counts=True)
    dev = agents.origin.device
    return (torch.as_tensor((uniq // num_nodes).astype(np.int32), device=dev),
            torch.as_tensor((uniq % num_nodes).astype(np.int32), device=dev),
            torch.as_tensor(counts.astype(np.float32), device=dev))


def assign_all_or_nothing(network: Network, road_cost: torch.Tensor,
                          od_o: torch.Tensor, od_d: torch.Tensor,
                          od_vol: torch.Tensor) -> torch.Tensor:
    """Each OD volume added to every road on its current shortest path:
    every pair walks the next-hop table from its origin, one hop a step
    for all pairs at once.  float32[R]."""
    r, n = network.num_roads, network.num_nodes
    cost_nodes = torch.zeros(n, dtype=torch.float32, device=road_cost.device)
    cost_nodes[:r] = road_cost
    _, next_hop = all_pairs_next_hop_nbr(network.nbr, network.nbr_ok,
                                         cost_nodes)
    dest = od_d.long()
    cur = od_o.long()
    flow = torch.zeros(r + 1, dtype=torch.float32, device=road_cost.device)
    for step in range(n):
        nxt = next_hop[cur, dest].long()
        active = (cur != dest) & (nxt >= 0)
        cur = torch.where(active, nxt, cur)
        # Roads entered this hop; R collects the rest and is dropped.
        flow.index_add_(0, torch.where(active & (cur < r), cur, r), od_vol)
        if (step + 1) % CHECK_EVERY == 0 and not host_read(active.any())[0]:
            break
    return flow[:r]


def solve_msa(network: Network, od_o, od_d, od_vol,
              msa: MSAConfig = DEFAULT_MSA,
              system_optimal: bool = False) -> MSAResult:
    """The MSA fixed point over road flows: step ``1/it`` toward the
    all-or-nothing assignment until the L1 flow change falls below
    ``msa.tol`` or ``msa.max_iter`` iterations ran.  ``system_optimal``
    prices marginal BPR costs (the system optimum)."""
    cost_fn = bpr_marginal_cost if system_optimal else bpr_cost
    dev = network.free_flow.device
    it = 0
    flow = torch.zeros(network.num_roads, dtype=torch.float32, device=dev)
    gap = torch.tensor(_INF, device=dev)
    # The comparisons in float32, as the reference's.
    while it < msa.max_iter and host_read(gap >= msa.tol)[0]:
        cost = cost_fn(flow, network.free_flow, network.max_flow, msa)
        aux = assign_all_or_nothing(network, cost, od_o, od_d, od_vol)
        step = torch.tensor(1.0, device=dev) / torch.tensor(
            float(it + 1), device=dev)
        new_flow = flow + step * (aux - flow)
        gap = torch.abs(new_flow - flow).sum()
        flow = new_flow
        it += 1
    return MSAResult(flow=flow, gap=gap, iterations=it,
                     converged=bool(host_read(gap < msa.tol)[0]))


def solve_frank_wolfe(network: Network, od_o, od_d, od_vol,
                      msa: MSAConfig = DEFAULT_MSA,
                      system_optimal: bool = False) -> MSAResult:
    """Frank-Wolfe assignment with an exact line search: from the
    all-or-nothing assignment at empty-network costs, each iteration moves
    toward the all-or-nothing assignment ``aux`` by the ``lam`` that
    minimises the Beckmann objective (``msa.fw_line_search_steps``
    bisections on its monotone derivative ``sum(d c(f + lam d))``), until
    the relative gap ``sum(c (f - aux)) / sum(c f)`` of the iterate it
    stepped from falls below ``msa.rel_gap_tol``.  The result's
    ``rel_gap`` is measured once more on the final flows.
    ``system_optimal`` minimises the total system cost instead (marginal
    costs)."""
    cost_fn = bpr_marginal_cost if system_optimal else bpr_cost
    ff, cap = network.free_flow, network.max_flow
    dev = ff.device
    zeros = torch.zeros(network.num_roads, dtype=torch.float32, device=dev)
    flow = assign_all_or_nothing(network, cost_fn(zeros, ff, cap, msa),
                                 od_o, od_d, od_vol)
    it = 1
    l1 = rel = inf = torch.tensor(_INF, device=dev)
    while it < msa.max_iter and host_read(rel >= msa.rel_gap_tol)[0]:
        cost = cost_fn(flow, ff, cap, msa)
        aux = assign_all_or_nothing(network, cost, od_o, od_d, od_vol)
        d = aux - flow
        total = (cost * flow).sum()
        rel = torch.where(total > 0.0, (cost * (flow - aux)).sum() / total,
                          inf)
        lo = torch.tensor(0.0, device=dev)
        hi = torch.tensor(1.0, device=dev)
        for _ in range(msa.fw_line_search_steps):
            mid = 0.5 * (lo + hi)
            gp = (d * cost_fn(flow + mid * d, ff, cap, msa)).sum()
            lo, hi = torch.where(gp > 0.0, lo, mid), torch.where(
                gp > 0.0, mid, hi)
        lam = 0.5 * (lo + hi)
        new_flow = flow + lam * d
        l1 = torch.abs(new_flow - flow).sum()
        flow = new_flow
        it += 1
    # The loop's gap is the last iterate's before its step: measure the
    # final flows once more.
    cost = cost_fn(flow, ff, cap, msa)
    aux = assign_all_or_nothing(network, cost, od_o, od_d, od_vol)
    total = torch.clamp((cost * flow).sum(), min=1e-9)
    rel_final = (cost * (flow - aux)).sum() / total
    return MSAResult(
        flow=flow, gap=l1, iterations=it, rel_gap=rel_final,
        converged=bool(host_read(rel_final < msa.rel_gap_tol)[0]))


def solve_assignment(network: Network, od_o, od_d, od_vol,
                     msa: MSAConfig = DEFAULT_MSA,
                     system_optimal: bool = False) -> MSAResult:
    """``msa.method``: "fw" (default) or the reference's "msa"."""
    if msa.method == "fw":
        return solve_frank_wolfe(network, od_o, od_d, od_vol, msa=msa,
                                 system_optimal=system_optimal)
    if msa.method == "msa":
        return solve_msa(network, od_o, od_d, od_vol, msa=msa,
                         system_optimal=system_optimal)
    raise ValueError(f"unknown assignment method {msa.method!r}")


def run_msa(network: Network, agents: AgentState,
            msa: MSAConfig = DEFAULT_MSA) -> dict[int, float]:
    """``{road_index: flow}`` of the user equilibrium (``msa.method``)."""
    od_o, od_d, od_vol = build_od_demand(agents, network.num_nodes)
    result = solve_assignment(network, od_o, od_d, od_vol, msa=msa)
    flow = result.flow.cpu().numpy()
    return {int(i): float(flow[i]) for i in range(network.num_roads)}


# --- the host oracle: an independent implementation for cross-checks ---------

def _dijkstra_host(num_nodes, adj, cost, source):
    """Binary-heap Dijkstra over node-entry costs: ``(dist, pred)``."""
    import heapq

    dist = np.full(num_nodes, np.inf)
    pred = np.full(num_nodes, -1, dtype=np.int64)
    dist[source] = 0.0
    heap = [(0.0, source)]
    while heap:
        d, u = heapq.heappop(heap)
        if d > dist[u]:
            continue
        for v in adj[u]:
            nd = d + cost[v]
            if nd < dist[v] - 1e-12:
                dist[v] = nd
                pred[v] = u
                heapq.heappush(heap, (nd, v))
    return dist, pred


def run_msa_host(network: Network, agents: AgentState,
                 msa: MSAConfig = DEFAULT_MSA) -> dict[int, float]:
    """The same assignment in float64 NumPy with heap Dijkstra (MSA's
    ``1/it`` steps, or Frank-Wolfe with the same bisection line search and
    stopping rules): ``{road_index: flow}``."""
    n = network.num_nodes
    num_roads = network.num_roads
    src = network.full_src.cpu().numpy()
    dst = network.full_dst.cpu().numpy()
    adj = [[] for _ in range(n)]
    for u, v in zip(src, dst):
        adj[u].append(int(v))

    free_flow = np.zeros(n)
    capacity = np.full(n, 1e-8)
    free_flow[:num_roads] = network.free_flow.cpu().numpy()
    capacity[:num_roads] = np.maximum(network.max_flow.cpu().numpy(), 1e-8)
    is_road = np.zeros(n, bool)
    is_road[:num_roads] = True

    od_o, od_d, od_vol = (t.cpu().numpy()
                          for t in build_od_demand(agents, n))

    def bpr(flow):
        return np.where(
            is_road,
            free_flow * (1.0 + msa.bpr_alpha
                         * (flow / capacity) ** msa.bpr_beta),
            0.0)

    def aon(cost):
        aux = np.zeros(n)
        for o in np.unique(od_o):
            _, pred = _dijkstra_host(n, adj, cost, int(o))
            for d, vol in zip(od_d[od_o == o], od_vol[od_o == o]):
                node = int(d)
                while node != o and node >= 0:
                    if is_road[node]:
                        aux[node] += vol
                    node = int(pred[node])
        return aux

    flow = np.zeros(n)
    if msa.method == "fw":
        flow = aon(bpr(flow))  # feasible start: AON at empty-network costs
        for _ in range(msa.max_iter - 1):
            cost = bpr(flow)
            aux = aon(cost)
            total = float((cost * flow).sum())
            rel = (float((cost * (flow - aux)).sum()) / total
                   if total > 0 else np.inf)
            if rel < msa.rel_gap_tol:
                break
            d = aux - flow
            lo, hi = 0.0, 1.0
            for _k in range(msa.fw_line_search_steps):
                mid = 0.5 * (lo + hi)
                gp = float((d * bpr(flow + mid * d)).sum())
                if gp > 0.0:
                    hi = mid
                else:
                    lo = mid
            flow = flow + 0.5 * (lo + hi) * d
    else:
        cost = bpr(flow)
        for it in range(1, msa.max_iter + 1):
            aux = aon(cost)
            new_flow = flow + (1.0 / it) * (aux - flow)
            gap = np.abs(new_flow - flow).sum()
            flow = new_flow
            cost = bpr(flow)
            if gap < msa.tol:
                break
    return {int(i): float(flow[i]) for i in range(num_roads)}
