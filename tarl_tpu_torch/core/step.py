"""Tick composition and the episode loop (ports ``tarl_tpu/core/step.py``:
``Policy``, ``init_sim_state``, ``tick``, ``run_episode`` and
``average_travel_time``).

A tick runs insert -> withdraw -> choice -> core, then advances the clock
and updates the metrics.  The core is :func:`~tarl_tpu_torch.core.
fused_winner.direction_confirm` at every network size (the CUDA kernel on a
CUDA device) followed by the tail push and head pop in PyTorch.  ``run_episode`` is a Python loop
over ticks; the reference's ``lax.scan`` has no counterpart that eager
PyTorch needs.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..config import DEFAULT_PHYSICS, DEFAULT_SIM, PhysicsConfig, SimConfig
from ..network import Network, default_selected_road
from ..state import (
    AgentState,
    MetricState,
    SimState,
    TickLog,
    init_backlog_state,
    init_metric_state,
    init_road_state,
)
from .fused_winner import apply_transfers, direction_confirm
from .insert import insert_agents, insert_agents_backlogged, \
    reconstruct_inserted
from .rng import Key, direction_gumbel, prng_key, split
from .withdraw import withdraw_agents


class Policy(NamedTuple):
    """A route-choice policy: ``choice(state, network) -> (state,
    entry_road | None)``.  Entrants take ``selected_road[origin]``; policies
    with per-agent entry roads come with the shortest-path slice."""

    choice: Callable


def init_sim_state(
    network: Network,
    agents: AgentState,
    *,
    sim: SimConfig = DEFAULT_SIM,
    policy: Optional[Policy] = None,
    key: Optional[Key] = None,
) -> SimState:
    """Fresh :class:`SimState` at ``sim.start_time`` on the network's
    device."""
    dev = network.device
    backlog = None
    if sim.insert_backlog is not None:
        if not (sim.sorted_population and sim.insert_window is not None):
            raise ValueError(
                "insert_backlog requires sorted_population and insert_window")
        backlog = init_backlog_state(sim.insert_backlog,
                                     network.num_intersections, dev)
    order = np.argsort(agents.departure.cpu().numpy(), kind="stable")
    return SimState(
        road=init_road_state(network.num_roads, network.nmax, dev),
        agents=agents,
        selected_road=default_selected_road(network),
        time=float(np.float32(sim.start_time)),
        key=prng_key(sim.seed) if key is None else key,
        metrics=init_metric_state(network.num_roads, sim.num_hours, dev),
        next_hop=torch.zeros((1, 1), dtype=torch.int32, device=dev),
        choice_count=0,
        insert_order=torch.as_tensor(order.astype(np.int32), device=dev),
        insert_ptr=0,
        backlog=backlog,
        sel_dest=None,
    )


def tick(
    state: SimState,
    network: Network,
    policy: Policy,
    sim: SimConfig = DEFAULT_SIM,
    physics: PhysicsConfig = DEFAULT_PHYSICS,
    lazy_inserted: bool = False,
    core: Callable = direction_confirm,
) -> tuple[SimState, TickLog]:
    """One tick: insert -> withdraw -> choice -> core, clock and metrics.

    ``lazy_inserted`` (backlog mode) skips the per-tick inserted-flag
    writes; :func:`run_episode` rebuilds the flag once at the end.
    ``core`` is the winner+confirm function;
    pass :func:`~tarl_tpu_torch.core.fused_winner.direction_confirm_plain`
    to run the plain version on a CUDA device for comparison."""
    if sim.fused_core:
        raise NotImplementedError(
            "fused_core (the TPU-only fused direction+response kernel) is "
            "not ported")
    t = state.time
    dev = state.road.count.device

    # --- insert ---
    insert_ptr = state.insert_ptr
    backlog = state.backlog
    saturated = 0.0
    if sim.insert_window is not None:
        if sim.insert_backlog is None or backlog is None:
            raise NotImplementedError(
                "the windowed insert is not ported; use insert_backlog or "
                "insert_window=None")
        road, agents, backlog, insert_ptr, saturated = \
            insert_agents_backlogged(
                state.road, state.agents, backlog, state.selected_road,
                network, t, state.insert_ptr, sim.insert_window, physics,
                escalate=sim.insert_escalate,
                update_inserted=not lazy_inserted,
            )
    else:
        road, agents = insert_agents(
            state.road, state.agents, state.selected_road, network, t,
            physics,
        )

    # --- withdraw ---
    road, agents, wcount = withdraw_agents(
        road, agents, network, t, depth=sim.withdraw_depth,
        escalate=sim.withdraw_escalate,
    )
    withdrawn = wcount > 0
    state = state._replace(road=road, agents=agents)

    # --- choice ---
    state, _ = policy.choice(state, network)

    # --- core: direction + confirm ---
    key, k_dir = split(state.key)
    want_delta = sim.record_road_optimality or sim.record_road_optimality_hourly
    accept, _win, agent, dest, popped = core(
        road, state.selected_road, network, t,
        direction_gumbel(k_dir, network), physics)
    road, road_delta_tt = apply_transfers(
        road, network, t, accept, agent, dest, popped, physics,
        compute_delta=want_delta,
    )

    # --- clock + metrics ---
    new_time = t + sim.timestep
    hour = min(max(int(np.float32(t) / np.float32(3600.0)), 0),
               sim.num_hours - 1)
    traversals = (withdrawn | popped).to(torch.int32)
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
        road=road,
        agents=agents,
        time=new_time,
        key=key,
        insert_ptr=insert_ptr,
        backlog=backlog,
        metrics=MetricState(
            hourly_counts=hourly,
            on_way_before=on_way_total,
            done_before=done_total,
            delta_tt_hourly=delta_hourly,
        ),
    )
    f32 = torch.float32
    log = TickLog(
        departures=departures,
        arrivals=arrivals,
        on_way=on_way_total,
        time=torch.tensor(new_time, dtype=f32),
        road_delta_tt=road_delta_tt,
        window_saturated=torch.tensor(saturated, dtype=f32),
    )
    return new_state, log


def run_episode(
    state: SimState,
    network: Network,
    policy: Policy,
    num_steps: int,
    sim: SimConfig = DEFAULT_SIM,
    physics: PhysicsConfig = DEFAULT_PHYSICS,
    core: Callable = direction_confirm,
) -> tuple[SimState, TickLog]:
    """Run ``num_steps`` ticks; returns the final state and the per-tick
    logs stacked along a leading axis.  In backlog mode the inserted flag
    is maintained lazily and rebuilt once at the end, as in the reference.
    ``core`` is passed to :func:`tick`."""
    lazy = sim.insert_backlog is not None and state.backlog is not None
    logs = []
    for _ in range(num_steps):
        state, log = tick(state, network, policy, sim, physics,
                          lazy_inserted=lazy, core=core)
        logs.append(log)
    if lazy:
        state = state._replace(agents=reconstruct_inserted(
            state.agents, state.backlog, state.insert_ptr))
    dev = state.road.count.device
    stacked = TickLog(*(
        torch.stack([getattr(lg, f) for lg in logs]).to(dev) if logs
        else torch.zeros((0,), device=dev)
        for f in TickLog._fields
    ))
    return state, stacked


def average_travel_time(agents: AgentState) -> torch.Tensor:
    """Mean realised travel time over DONE agents."""
    done = agents.done
    tt = torch.where(done, agents.arrival - agents.departure, 0.0)
    n = torch.clamp(done.to(torch.float32).sum(), min=1.0)
    return tt.sum() / n
