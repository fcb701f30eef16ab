"""Agent withdrawal: pop arrived agents from FIFO heads (ports
``tarl_tpu/core/withdraw.py``).

An agent leaves the network when it sits in the consecutive-from-head run
of agents that have reached their departure time and whose DEST node is the
current road's (``network.road_dest``).  Popping advances ``head``; the
arrival stamp is the one agent-side write.  The reference's top_k
compaction of the stamp scatter is not ported: it is bitwise-neutral and
exists only for TPU scatters.
"""
from __future__ import annotations

import torch

from ..network import Network
from ..ops.scatter import scatter_set
from ..state import AgentState, RoadState
from .sync import host_read


def scan_run(road: RoadState, road_dest, time: float, head, count, k: int):
    """Leading eligible run over the first ``k`` logical slots of each ring
    row, whose road's DEST node is ``road_dest``.  Returns ``(ids [R, k],
    run [R, k] bool, wcount [R] int32)``."""
    nmax = road.nmax
    logical = torch.arange(k, dtype=torch.int64, device=head.device)
    phys = torch.remainder(head.long()[:, None] + logical[None, :], nmax)
    ids = road.fifo_ids.gather(1, phys)
    dep = road.fifo_departure.gather(1, phys)
    dest = road.fifo_dest.gather(1, phys)
    eligible = (
        (dest == road_dest[:, None])
        & (dep <= time)
        & (logical[None, :] < count[:, None])
    )
    run = torch.cummin(eligible.to(torch.int32), dim=1).values.bool()
    return ids, run, run.sum(dim=1, dtype=torch.int32)


def withdraw_agents(
    road: RoadState,
    agents: AgentState,
    network: Network,
    time: float,
    depth: int | None = None,
    escalate: bool = False,
) -> tuple[RoadState, AgentState, torch.Tensor]:
    """Withdraw all consecutive-from-head arrived agents.

    ``depth`` bounds the FIFO slots scanned per road per pass (None = the
    whole queue).  With ``escalate``, further passes run from the advanced
    heads while some road's run hit the bound, which makes any depth
    outcome-identical to the unbounded scan; each pass costs one host read.

    Returns ``(road, agents, withdraw_counts)``; ``withdraw_counts`` is
    int32[R], agents popped per road this tick.
    """
    nmax = road.nmax
    a = agents.num_agents
    k = nmax if depth is None else min(depth, nmax)

    def one_pass(head, count, arrival):
        ids, run, w = scan_run(road, network.road_dest, time, head, count,
                             k)
        # Stamp arrival: one value per tick, so repeated ids cannot occur
        # among the run (each agent sits in one slot) and the set is safe.
        arrival = scatter_set(arrival, ids.reshape(-1), time,
                              run.reshape(-1))
        head = torch.remainder(head + w, nmax).to(torch.int32)
        return head, count - w, arrival, w

    head, count, arrival, wcount = one_pass(road.head, road.count,
                                            agents.arrival)
    if escalate and k < nmax:
        last = wcount
        while host_read(torch.any(last == k), site="withdraw.escalate")[0]:
            head, count, arrival, last = one_pass(head, count, arrival)
            wcount = wcount + last
    return (
        road._replace(head=head, count=count),
        agents._replace(arrival=arrival),
        wcount,
    )
