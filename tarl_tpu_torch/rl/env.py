"""The RL environment over the simulator (ports ``tarl_tpu/rl/env.py``:
``EnvState``, ``Observation``, ``fifo_potential``, ``env_reset`` and
``env_step``).

A step applies a multi-hot action over the full edges (every active edge
u -> v sets ``selected_road[u] = v``), then runs core -> withdraw ->
insert, the reward, and the event-time clock: time advances by one
timestep only when the occupancy vector is unchanged from the previous
step, and the episode is done past ``rl.episode_end``.  Reward modes
(``RLConfig.reward_mode``): ``on_network``, ``individual``,
``throughput``, ``system`` and ``progress`` (potential-based, with the
free-flow or, with ``congested_potential``, the current congested
distances).

The core is the port's K1 path, as in :func:`~tarl_tpu_torch.core.step.
tick`: ``core`` (default :func:`~tarl_tpu_torch.core.fused_winner.
direction_confirm`) followed by ``apply_transfers``.  The environment's
clock is a float32 0-d tensor on the device: it depends on the occupancy,
and keeping it there lets a rollout run with no host read per step (K1
reads it on the device).  The threefry key is split on the host, as in
the tick, and the core draws its noise from the direction key.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..config import (
    DEFAULT_PHYSICS,
    DEFAULT_RL,
    DEFAULT_SIM,
    PhysicsConfig,
    RLConfig,
    SimConfig,
)
from ..core.fused_winner import apply_transfers, direction_confirm
from ..core.insert import insert_agents, insert_agents_windowed
from ..core.rng import split
from ..core.withdraw import withdraw_agents
from ..network import Network
from ..routing.policies import ExternalChoice
from ..state import MetricState, SimState
from .observation import observe


class EnvState(NamedTuple):
    sim: SimState            # ``sim.time`` is a float32 0-d device tensor
    old_counts: torch.Tensor  # int32[R] — occupancy after the previous step
    done: torch.Tensor        # bool[]
    # Phi(s) for reward_mode="progress" (0.0 otherwise), carried so each
    # state is valued once.
    phi: torch.Tensor         # float32[]


class Observation(NamedTuple):
    node_features: torch.Tensor  # float32[N, 7]
    edge_features: torch.Tensor  # float32[Ef, 1]
    agent_index: torch.Tensor    # int32[N]
    time: torch.Tensor           # float32[1]


def fifo_potential(road, agents, dist_ff: torch.Tensor,
                   free_flow: torch.Tensor) -> torch.Tensor:
    """Phi = sum over queued agents of ``free_flow[r] + dist_ff[r, dest]``
    (the time to finish the current road and the shortest remaining
    distance); the sentinel agent 0 and unreachable pairs count 0."""
    r, nmax = road.fifo_ids.shape
    dev = road.fifo_ids.device
    col = torch.arange(nmax, device=dev)[None, :]
    valid = torch.remainder(col - road.head[:, None], nmax) \
        < road.count[:, None]
    ids = torch.where(valid, road.fifo_ids, 0)
    rows = torch.arange(r, device=dev)[:, None]
    d = dist_ff[rows, agents.dest[ids.long()].long()] + free_flow[:, None]
    d = torch.where(valid & (ids != 0) & (d < 1e17), d, 0.0)
    return torch.sum(d)


def _observe(sim: SimState, network: Network,
             rl: RLConfig = DEFAULT_RL) -> Observation:
    nf, ef, _, ai = observe(sim, network, rl.observe_pending_entrants)
    return Observation(node_features=nf, edge_features=ef, agent_index=ai,
                       time=sim.time.reshape(1))


def _phi(road, agents, network: Network, rl: RLConfig,
         physics: PhysicsConfig, dist_ff) -> torch.Tensor:
    """Phi(s), a pure function of the state."""
    if rl.congested_potential:
        from ..routing.bellman_ford import (
            all_pairs_next_hop_nbr,
            node_entry_costs,
            road_costs,
        )

        dist_tab, _ = all_pairs_next_hop_nbr(
            network.nbr, network.nbr_ok,
            node_entry_costs(road, network, physics))
        own_cost = road_costs(road, network, physics)
    else:
        if dist_ff is None:
            raise ValueError('reward_mode="progress" needs dist_ff')
        dist_tab, own_cost = dist_ff, network.free_flow
    return fifo_potential(road, agents, dist_tab, own_cost)


def env_reset(
    sim_state: SimState,
    network: Network,
    rl: RLConfig = DEFAULT_RL,
    physics: PhysicsConfig = DEFAULT_PHYSICS,
    dist_ff: torch.Tensor | None = None,
) -> tuple[EnvState, Observation]:
    """Rewind to ``rl.episode_start`` with empty queues."""
    from ..core.step import reset_sim_state

    dev = network.device
    sim = reset_sim_state(sim_state, rl.episode_start)
    sim = sim._replace(time=torch.tensor(sim.time, dtype=torch.float32,
                                         device=dev))
    phi0 = (_phi(sim.road, sim.agents, network, rl, physics, dist_ff)
            if rl.reward_mode == "progress"
            else torch.zeros((), dtype=torch.float32, device=dev))
    env = EnvState(sim=sim, old_counts=sim.road.count,
                   done=torch.zeros((), dtype=torch.bool, device=dev),
                   phi=phi0)
    return env, _observe(sim, network, rl)


def env_step(
    env: EnvState,
    action: torch.Tensor,  # bool[Ef] multi-hot over the full edges
    network: Network,
    rl: RLConfig = DEFAULT_RL,
    sim_cfg: SimConfig = DEFAULT_SIM,
    physics: PhysicsConfig = DEFAULT_PHYSICS,
    dist_ff: torch.Tensor | None = None,  # [N, N] for reward_mode="progress"
    core: Callable = direction_confirm,
) -> tuple[EnvState, Observation, torch.Tensor, torch.Tensor, dict]:
    """One transition: ``(env, obs, reward, done, info)``.  ``core`` is
    the winner+confirm function, as in ``tick``."""
    sim = env.sim
    t = sim.time

    # --- choice: apply the action ---
    sim, _ = ExternalChoice(action)(sim, network)
    # Head agents before the core step: the individual reward's candidates
    # (the dummy 0 for empty roads, never DONE).
    last_people = sim.road.head_ids().long()

    # --- core ---
    key, k_dir = split(sim.key)
    accept, _win, agent, dest, popped = core(
        sim.road, sim.selected_road, network, t, k_dir, physics)
    road, road_delta_tt = apply_transfers(
        sim.road, network, t, accept, agent, dest, popped, physics,
        compute_delta=sim_cfg.record_road_optimality_hourly)

    # --- withdraw ---
    road, agents, wcount = withdraw_agents(
        road, sim.agents, network, t, depth=sim_cfg.withdraw_depth,
        escalate=sim_cfg.withdraw_escalate)
    withdrawn = wcount > 0

    # --- insert ---
    insert_ptr = sim.insert_ptr
    if sim_cfg.insert_window is not None:
        road, agents, insert_ptr, _ = insert_agents_windowed(
            road, agents, sim.selected_road, network, t, sim.insert_order,
            sim.insert_ptr, sim_cfg.insert_window, physics,
            sorted_fast=sim_cfg.sorted_population,
            escalate=sim_cfg.insert_escalate)
    else:
        road, agents = insert_agents(road, agents, sim.selected_road,
                                     network, t, physics)

    # --- reward ---
    new_counts = road.count
    arrived = agents.done[last_people]
    travel = agents.arrival[last_people] - agents.departure[last_people]
    individual_reward = torch.sum(torch.where(
        arrived & (travel > 0),
        100.0 * 600.0 / torch.clamp(travel, min=1.0), 0.0))
    phi_after = env.phi
    if rl.reward_mode == "individual":
        reward = individual_reward
    elif rl.reward_mode == "system":
        pending = torch.sum((agents.departure <= t)
                            & ~agents.inserted).to(torch.float32)
        reward = -(torch.sum(road.count).to(torch.float32)
                   + pending) / rl.progress_scale
    elif rl.reward_mode == "throughput":
        reward = torch.sum(wcount).to(torch.float32)
    elif rl.reward_mode == "progress":
        # r = Phi(s) - Phi(s') with s' after the insert, so an entrant's
        # potential is charged up front.
        phi_after = _phi(road, agents, network, rl, physics, dist_ff)
        reward = (env.phi - phi_after) / rl.progress_scale
    else:  # "on_network"
        reward = -torch.sum(new_counts).to(torch.float32)

    # --- event-time clock, on the device ---
    unchanged = torch.all(env.old_counts == new_counts)
    new_time = torch.where(unchanged, t + sim_cfg.timestep, t)
    done = new_time > rl.episode_end

    # --- metric accumulators ---
    hour = torch.clamp((t / 3600.0).to(torch.int32), 0,
                       sim_cfg.num_hours - 1).reshape(1).long()
    m = sim.metrics
    traversals = (withdrawn | popped).to(torch.int32)
    hourly = torch.index_add(m.hourly_counts, 0, hour, traversals[None])
    delta_hourly = m.delta_tt_hourly
    if road_delta_tt.shape[0]:
        delta_hourly = torch.index_add(delta_hourly, 0, hour,
                                       road_delta_tt[None])
    on_way_total = torch.sum(new_counts).to(torch.float32)
    done_total = m.done_before + torch.sum(wcount).to(torch.float32)

    new_sim = sim._replace(
        road=road, agents=agents, time=new_time, key=key,
        insert_ptr=insert_ptr,
        metrics=MetricState(hourly_counts=hourly,
                            on_way_before=on_way_total,
                            done_before=done_total,
                            delta_tt_hourly=delta_hourly))
    new_env = EnvState(sim=new_sim, old_counts=new_counts, done=done,
                       phi=phi_after)
    info = {
        "individual_reward": individual_reward,
        "on_network": on_way_total,
        "arrivals": done_total - m.done_before,
    }
    return new_env, _observe(new_sim, network, rl), reward, done, info
