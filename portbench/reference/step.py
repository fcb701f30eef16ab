"""Tick composition and the episode loops (a frozen copy of the program's
``core/step.py`` with the default core only): insert -> withdraw -> choice
-> core, then the clock and the metrics.  ``after_tick`` (None in the
reference proper) rewrites each tick's state; the control uses it to
store the state in a lower precision."""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .config import DEFAULT_PHYSICS, DEFAULT_SIM, SimConfig
from .core import apply_transfers, direction_confirm_plain
from .insert import (
    insert_agents,
    insert_agents_backlogged,
    insert_agents_windowed,
    reconstruct_inserted,
)
from .network import Network, default_selected_road
from .rng import Key, prng_key, split
from .routing import Policy
from .state import (
    AgentState,
    MetricState,
    SimState,
    TickLog,
    init_backlog_state,
    init_metric_state,
    init_road_state,
)
from .withdraw import withdraw_agents


def init_sim_state(network: Network, agents: AgentState, *,
                   sim: SimConfig = DEFAULT_SIM,
                   policy: Optional[Policy] = None,
                   key: Optional[Key] = None) -> SimState:
    """Fresh state at ``sim.start_time``: empty rings, the policy's routing
    table (or a placeholder), the backlog where ``sim`` asks for one."""
    dev = network.device
    backlog = None
    if sim.insert_backlog is not None:
        if not (sim.sorted_population and sim.insert_window is not None):
            raise ValueError(
                "insert_backlog requires sorted_population and insert_window")
        if policy is not None and (policy.entry is not None
                                   or policy.entry_lookup is not None):
            raise ValueError("insert_backlog requires the selected_road"
                             "[origin] entry rule")
        backlog = init_backlog_state(sim.insert_backlog,
                                     network.num_intersections, dev)
    if policy is not None and policy.table_init is not None:
        next_hop = policy.table_init(network)
    else:
        next_hop = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    sel_dest = None
    if policy is not None and policy.table_init is not None:
        sel_dest = torch.full((network.num_roads,), -1, dtype=torch.int32,
                              device=dev)
    order = np.argsort(agents.departure.cpu().numpy(), kind="stable")
    return SimState(
        road=init_road_state(network.num_roads, network.nmax, dev),
        agents=agents,
        selected_road=default_selected_road(network),
        time=float(np.float32(sim.start_time)),
        key=prng_key(sim.seed) if key is None else key,
        metrics=init_metric_state(network.num_roads, sim.num_hours, dev),
        next_hop=next_hop,
        choice_count=0,
        insert_order=torch.as_tensor(order.astype(np.int32), device=dev),
        insert_ptr=0,
        backlog=backlog,
        sel_dest=sel_dest,
    )


def insert_phase(state, network, policy, sim, physics, lazy_inserted):
    t = state.time
    if sim.insert_window is not None and \
            sim.insert_backlog is not None and state.backlog is not None:
        road, agents, backlog, insert_ptr, saturated = \
            insert_agents_backlogged(
                state.road, state.agents, state.backlog,
                state.selected_road, network, t, state.insert_ptr,
                sim.insert_window, physics, escalate=sim.insert_escalate,
                update_inserted=not lazy_inserted,
            )
        return state._replace(road=road, agents=agents, backlog=backlog,
                              insert_ptr=insert_ptr), saturated
    if sim.insert_window is not None:
        entry_fn = entry_road = None
        if policy.entry_lookup is not None:
            def entry_fn(ids, s=state):
                return policy.entry_lookup(s, network, ids)
        elif policy.entry is not None:
            entry_road = policy.entry(state, network)
        road, agents, insert_ptr, saturated = insert_agents_windowed(
            state.road, state.agents, state.selected_road, network, t,
            state.insert_order, state.insert_ptr, sim.insert_window,
            physics, entry_road=entry_road, entry_lookup=entry_fn,
            sorted_fast=sim.sorted_population, escalate=sim.insert_escalate,
        )
        return state._replace(road=road, agents=agents,
                              insert_ptr=insert_ptr), saturated
    entry_road = (policy.entry(state, network)
                  if policy.entry is not None else None)
    road, agents = insert_agents(
        state.road, state.agents, state.selected_road, network, t,
        physics, entry_road=entry_road,
    )
    return state._replace(road=road, agents=agents), 0.0


def core_phase(state, network, wcount, saturated, sim, physics):
    t = state.time
    dev = state.road.count.device
    key, k_dir = split(state.key)
    want_delta = (sim.record_road_optimality
                  or sim.record_road_optimality_hourly)
    accept, _win, agent, dest, popped = direction_confirm_plain(
        state.road, state.selected_road, network, t, k_dir, physics)
    road, road_delta_tt = apply_transfers(
        state.road, network, t, accept, agent, dest, popped, physics,
        compute_delta=want_delta)

    new_time = t + sim.timestep
    hour = min(max(int(np.float32(t) / np.float32(3600.0)), 0),
               sim.num_hours - 1)
    traversals = ((wcount > 0) | popped).to(torch.int32)
    metrics = state.metrics
    hourly = metrics.hourly_counts.clone()
    hourly[hour] += traversals
    delta_hourly = metrics.delta_tt_hourly
    if sim.record_road_optimality_hourly and road_delta_tt.shape[0]:
        delta_hourly = delta_hourly.clone()
        delta_hourly[hour] += road_delta_tt
    if not sim.record_road_optimality:
        road_delta_tt = torch.zeros((0,), dtype=torch.float32, device=dev)

    on_way_total = road.count.sum().to(torch.float32)
    done_total = metrics.done_before + wcount.sum().to(torch.float32)
    departures = (on_way_total - metrics.on_way_before + done_total
                  - metrics.done_before)
    arrivals = done_total - metrics.done_before
    new_state = state._replace(
        road=road, time=new_time, key=key,
        metrics=MetricState(hourly_counts=hourly,
                            on_way_before=on_way_total,
                            done_before=done_total,
                            delta_tt_hourly=delta_hourly))
    f32 = torch.float32
    log = TickLog(
        departures=departures, arrivals=arrivals, on_way=on_way_total,
        time=torch.tensor(new_time, dtype=f32),
        road_delta_tt=road_delta_tt,
        window_saturated=torch.tensor(saturated, dtype=f32),
    )
    return new_state, log


def tick(state, network, policy, sim=DEFAULT_SIM, physics=DEFAULT_PHYSICS,
         lazy_inserted=False, choice_fn=None):
    state, saturated = insert_phase(state, network, policy, sim, physics,
                                    lazy_inserted)
    road, agents, wcount = withdraw_agents(
        state.road, state.agents, network, state.time,
        depth=sim.withdraw_depth, escalate=sim.withdraw_escalate)
    state = state._replace(road=road, agents=agents)
    state, _ = (choice_fn or policy.choice)(state, network)
    return core_phase(state, network, wcount, saturated, sim, physics)


def stack_logs(logs: list, dev) -> TickLog:
    return TickLog(*(
        torch.stack([getattr(lg, f) for lg in logs]).to(dev) if logs
        else torch.zeros((0,), device=dev)
        for f in TickLog._fields
    ))


def run_episode(state, network, policy, num_steps, sim=DEFAULT_SIM,
                physics=DEFAULT_PHYSICS,
                after_tick: Optional[Callable] = None):
    """``num_steps`` ticks; the final state and the stacked tick logs.  In
    backlog mode the inserted flag is rebuilt once at the end."""
    lazy = sim.insert_backlog is not None and state.backlog is not None
    logs = []
    for _ in range(num_steps):
        state, log = tick(state, network, policy, sim, physics,
                          lazy_inserted=lazy)
        if after_tick is not None:
            state = after_tick(state)
        logs.append(log)
    if lazy:
        state = state._replace(agents=reconstruct_inserted(
            state.agents, state.backlog, state.insert_ptr))
    return state, stack_logs(logs, state.road.count.device)


def run_episode_periodic(state, network, policy, num_steps, sim=DEFAULT_SIM,
                         physics=DEFAULT_PHYSICS,
                         after_tick: Optional[Callable] = None):
    """:func:`run_episode` for a policy with a periodic refresh, as periods
    of ``policy.periodic_rate`` ticks: the first tick of a period refreshes
    the table at its choice phase, the others only look up."""
    rate = policy.periodic_rate
    if not rate or policy.refresh is None or policy.lookup is None:
        raise ValueError("policy carries no periodic refresh/lookup split")
    if num_steps % rate or state.choice_count % rate:
        raise ValueError("num_steps and choice_count must be multiples of "
                         f"periodic_rate={rate}")

    def refresh_choice(s, net):
        buf = policy.refresh(s, net)
        return policy.lookup(s, net, buf)._replace(next_hop=buf), None

    def lookup_choice(s, net):
        return policy.lookup(s, net, s.next_hop), None

    logs = []
    for i in range(num_steps):
        state, log = tick(state, network, policy, sim, physics,
                          choice_fn=refresh_choice if i % rate == 0
                          else lookup_choice)
        if after_tick is not None:
            state = after_tick(state)
        logs.append(log)
    return state, stack_logs(logs, state.road.count.device)
