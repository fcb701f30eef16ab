"""Equilibrium metrics: TSTT, the Nash gap and the price of anarchy (ports
``tarl_tpu/metrics/equilibrium.py``).

* **TSTT** (total system travel time): the realised travel times of DONE
  agents plus the time so far of agents still en route.
* **Nash gap**: the total excess of each DONE agent's experienced travel
  time over the current shortest path of its OD pair under the congested
  costs; ``relative_gap = gap / sum(shortest)``, 0 at a user equilibrium.
* **Price of anarchy**: ``TSTT_UE / TSTT_SO``, the system optimum from
  the same static assignment (:mod:`~tarl_tpu_torch.algorithms.msa`) under
  marginal BPR costs.

Plain PyTorch on the tensors' device, as the reference is plain ``jnp``;
the shortest paths are :func:`~tarl_tpu_torch.routing.bellman_ford.
all_pairs_next_hop_nbr`'s.
"""
from __future__ import annotations

import torch

from ..config import DEFAULT_MSA, DEFAULT_PHYSICS, MSAConfig, PhysicsConfig
from ..network import Network
from ..routing.bellman_ford import all_pairs_next_hop_nbr, node_entry_costs
from ..state import AgentState, RoadState


def tstt(agents: AgentState, time) -> torch.Tensor:
    """Total system travel time in seconds at ``time``."""
    done_tt = torch.where(agents.done, agents.arrival - agents.departure,
                          0.0)
    en_route_tt = torch.where(agents.on_way, time - agents.departure, 0.0)
    return done_tt.sum() + torch.clamp(en_route_tt, min=0.0).sum()


def nash_gap(agents: AgentState, road: RoadState, network: Network,
             physics: PhysicsConfig = DEFAULT_PHYSICS) -> dict:
    """Absolute and relative Nash gap over the DONE agents, against the
    all-pairs shortest paths under the current congested entry costs;
    tensors ``nash_gap``, ``relative_gap`` and ``num_agents``."""
    cost = node_entry_costs(road, network, physics)
    dist, _ = all_pairs_next_hop_nbr(network.nbr, network.nbr_ok, cost)
    shortest = dist[agents.origin.long(), agents.dest.long()]
    experienced = agents.arrival - agents.departure
    valid = agents.done & torch.isfinite(shortest) & (shortest < 1e17)
    excess = torch.where(valid, torch.clamp(experienced - shortest, min=0.0),
                         0.0)
    base = torch.where(valid, shortest, 0.0)
    gap = excess.sum()
    denom = torch.clamp(base.sum(), min=1e-9)
    return {"nash_gap": gap, "relative_gap": gap / denom,
            "num_agents": valid.to(torch.int32).sum()}


def bpr_cost(flow, free_flow, capacity, msa: MSAConfig = DEFAULT_MSA):
    """BPR link cost ``fftt * (1 + alpha * (v / c)^beta)``."""
    ratio = flow / torch.clamp(capacity, min=1e-8)
    return free_flow * (1.0 + msa.bpr_alpha * ratio ** msa.bpr_beta)


def bpr_marginal_cost(flow, free_flow, capacity,
                      msa: MSAConfig = DEFAULT_MSA):
    """Marginal BPR cost ``d(v t(v)) / dv = t(v) + v t'(v)``: each driver
    priced at the delay they impose."""
    ratio = flow / torch.clamp(capacity, min=1e-8)
    return free_flow * (1.0 + msa.bpr_alpha * (1.0 + msa.bpr_beta)
                        * ratio ** msa.bpr_beta)


def tstt_from_flows(flow, free_flow, capacity, msa: MSAConfig = DEFAULT_MSA):
    """TSTT implied by static link flows under BPR costs."""
    return (flow * bpr_cost(flow, free_flow, capacity, msa)).sum()


def price_of_anarchy(tstt_ue, tstt_so) -> torch.Tensor:
    return tstt_ue / torch.clamp(torch.as_tensor(tstt_so), min=1e-9)


def equilibrium_report(agents: AgentState, road: RoadState,
                       network: Network, time, *,
                       msa: MSAConfig = DEFAULT_MSA,
                       physics: PhysicsConfig = DEFAULT_PHYSICS) -> dict:
    """TSTT, the Nash gap and the price of anarchy against the static
    assignment's user equilibrium and system optimum (``msa.method``), as
    Python numbers; warns where an assignment did not converge."""
    from ..algorithms.msa import build_od_demand, solve_assignment

    od_o, od_d, od_vol = build_od_demand(agents, network.num_nodes)
    ue = solve_assignment(network, od_o, od_d, od_vol, msa=msa)
    so = solve_assignment(network, od_o, od_d, od_vol, msa=msa,
                          system_optimal=True)
    t_ue = tstt_from_flows(ue.flow, network.free_flow, network.max_flow, msa)
    t_so = tstt_from_flows(so.flow, network.free_flow, network.max_flow, msa)
    gap = nash_gap(agents, road, network, physics)
    if not (ue.converged and so.converged):
        which = "UE" if not ue.converged else "SO"
        print(f"equilibrium_report: {which} assignment did NOT converge "
              f"within {msa.max_iter} iterations (method={msa.method}); "
              "PoA/Nash figures below are computed from the unconverged "
              "flows")
    return {
        "tstt_simulated": float(tstt(agents, time)),
        "tstt_ue": float(t_ue),
        "tstt_so": float(t_so),
        "price_of_anarchy": float(price_of_anarchy(t_ue, t_so)),
        "nash_gap": float(gap["nash_gap"]),
        "relative_nash_gap": float(gap["relative_gap"]),
        "assignment_method": msa.method,
        "msa_iterations_ue": int(ue.iterations),
        "msa_gap_ue": float(ue.gap),
        "rel_gap_ue": float(ue.rel_gap),
        "rel_gap_so": float(so.rel_gap),
        "converged_ue": bool(ue.converged),
        "converged_so": bool(so.converged),
    }
