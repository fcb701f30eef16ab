"""Tick composition and the episode loops (ports ``tarl_tpu/core/step.py``:
``Policy``, ``init_sim_state``, ``reset_sim_state``, ``tick``,
``run_episode``, ``run_episode_periodic`` and ``average_travel_time``).

A tick runs insert -> withdraw -> choice -> core, then advances the clock
and updates the metrics: :func:`insert_phase`, :func:`withdraw_phase`, the
policy's choice and :func:`core_phase`, which the simulator facade's eager
``run()`` also calls one by one, timing each.  The core is
:func:`~tarl_tpu_torch.core.fused_winner.direction_confirm` (the CUDA
kernel K1 on a CUDA device) followed by the tail push and head pop in
PyTorch; with ``SimConfig.fused_core`` and at most 4,096 roads it is
:func:`~tarl_tpu_torch.core.fused_core.fused_core_step` instead (the
eligibility, the logits and the per-downstream Gumbel-max over the turn
edges in one launch of kernel K12).  The episode functions are Python
loops over ticks; the reference's ``lax.scan`` has no counterpart that
eager PyTorch needs.  Each tick, its phases and the periodic refresh open
spans (:mod:`~tarl_tpu_torch.utils.timers`): ``tick``, and under it
``insert``, ``withdraw``, ``choice`` (with ``refresh`` under it) and
``core``.
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
from ..utils.timers import span, spanned
from .fused_core import fused_core_sample, fused_core_step
from .fused_winner import apply_transfers, direction_confirm
from .insert import (
    insert_agents,
    insert_agents_backlogged,
    insert_agents_windowed,
    reconstruct_inserted,
)
from .rng import Key, prng_key, split
from .withdraw import withdraw_agents


class Policy(NamedTuple):
    """A route-choice policy: ``choice(state, network) -> (state,
    entry_road | None)``.

    ``entry(state, network) -> int32[A]`` and ``entry_lookup(state, network,
    agent_ids) -> roads`` give per-agent entry roads (entrants take
    ``selected_road[origin]`` without them); ``needs_next_hop`` asks for the
    dual next-hop table (int32[N, N], the uncapped free-flow
    ``all_pairs_next_hop_nbr`` at init); ``table_init(network)`` builds the
    routing scratch ``state.next_hop`` instead; ``learned`` marks a trained
    neural policy (the reference carries its ``LearnedSpec`` there), whose
    forward the road-sharded episode runs edge-sharded.
    ``refresh(state, network) -> buf``,
    ``lookup(state, network, buf) -> state`` and ``periodic_rate`` split a
    periodic-refresh choice for :func:`run_episode_periodic`; ``choice``
    equals ``lookup`` after a refresh on every ``periodic_rate``-th call."""

    choice: Callable
    entry: Optional[Callable] = None
    entry_lookup: Optional[Callable] = None
    needs_next_hop: bool = False
    table_init: Optional[Callable] = None
    learned: Optional[object] = None
    refresh: Optional[Callable] = None
    lookup: Optional[Callable] = None
    periodic_rate: Optional[int] = None


def init_sim_state(
    network: Network,
    agents: AgentState,
    *,
    sim: SimConfig = DEFAULT_SIM,
    policy: Optional[Policy] = None,
    key: Optional[Key] = None,
    next_hop: Optional[torch.Tensor] = None,
) -> SimState:
    """Fresh :class:`SimState` at ``sim.start_time`` on the network's
    device.  The routing scratch is ``next_hop`` where given, as it is;
    else it comes from ``policy.table_init``, or the free-flow dual table
    where the policy ``needs_next_hop``."""
    dev = network.device
    backlog = None
    if sim.insert_backlog is not None:
        if not (sim.sorted_population and sim.insert_window is not None):
            raise ValueError(
                "insert_backlog requires sorted_population and insert_window")
        if policy is not None and (policy.entry is not None
                                   or policy.entry_lookup is not None):
            raise ValueError(
                "insert_backlog requires the selected_road[origin] entry "
                "rule; this policy supplies per-agent entry roads")
        backlog = init_backlog_state(sim.insert_backlog,
                                     network.num_intersections, dev)
    if next_hop is None:
        if policy is not None and policy.table_init is not None:
            next_hop = policy.table_init(network)
        elif policy is not None and policy.needs_next_hop:
            from ..routing.bellman_ford import all_pairs_next_hop_nbr

            _, next_hop = all_pairs_next_hop_nbr(
                network.nbr, network.nbr_ok, network.entry_cost())
        else:
            next_hop = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    sel_dest = None
    if policy is not None and (policy.needs_next_hop
                               or policy.table_init is not None):
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


def reset_sim_state(state: SimState, start_time) -> SimState:
    """Empty queues, agent progress and metric accumulators, with the clock
    at ``start_time``; selections, key, population order and routing
    scratch are kept."""
    dev = state.road.count.device
    r, nmax = state.road.fifo_ids.shape
    hours = state.metrics.hourly_counts.shape[0]
    backlog = state.backlog
    if backlog is not None:
        s, q, _ = backlog.qpack.shape
        backlog = init_backlog_state(q, s, dev)
    return state._replace(
        road=init_road_state(r, nmax, dev),
        agents=state.agents._replace(
            inserted=torch.zeros_like(state.agents.inserted),
            arrival=torch.zeros_like(state.agents.arrival),
        ),
        time=float(np.float32(start_time)),
        metrics=init_metric_state(r, hours, dev),
        choice_count=0,
        insert_ptr=0,
        backlog=backlog,
        sel_dest=(None if state.sel_dest is None
                  else torch.full_like(state.sel_dest, -1)),
    )


@spanned("insert")
def insert_phase(state: SimState, network: Network, policy: Policy,
                 sim: SimConfig = DEFAULT_SIM,
                 physics: PhysicsConfig = DEFAULT_PHYSICS,
                 lazy_inserted: bool = False) -> tuple[SimState, float]:
    """The tick's insert: the backlog, windowed or whole-population insert
    as ``sim`` asks, with the policy's entry roads (read from
    ``state.next_hop`` as it is before this tick's choice).  Returns the
    state and the window's saturation monitor."""
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


@spanned("withdraw")
def withdraw_phase(state: SimState, network: Network,
                   sim: SimConfig = DEFAULT_SIM
                   ) -> tuple[SimState, torch.Tensor]:
    """The tick's withdraw; returns the state and each road's withdrawals
    (int32[R])."""
    road, agents, wcount = withdraw_agents(
        state.road, state.agents, network, state.time,
        depth=sim.withdraw_depth, escalate=sim.withdraw_escalate,
    )
    return state._replace(road=road, agents=agents), wcount


@spanned("core")
def core_phase(
    state: SimState,
    network: Network,
    wcount: torch.Tensor,
    saturated,
    sim: SimConfig = DEFAULT_SIM,
    physics: PhysicsConfig = DEFAULT_PHYSICS,
    core: Callable = direction_confirm,
    payload: Callable = fused_core_sample,
) -> tuple[SimState, TickLog]:
    """The tick's core (direction winner, confirm, tail push and head pop),
    then the clock and the metrics; ``wcount`` and ``saturated`` come from
    this tick's withdraw and insert.  ``core`` and ``payload`` as in
    :func:`tick`."""
    t = state.time
    dev = state.road.count.device
    road = state.road
    key, k_dir = split(state.key)
    want_delta = (sim.record_road_optimality
                  or sim.record_road_optimality_hourly)
    # The reference's choice on its own chip: the fused core where asked
    # and R <= 4,096 (past that its one-hot tiles overflowed VMEM).
    if sim.fused_core and network.num_roads <= 4096:
        road, popped, road_delta_tt = fused_core_step(
            road, state.selected_road, network, t, k_dir, physics,
            compute_delta=want_delta, payload=payload)
    else:
        accept, _win, agent, dest, popped = core(
            road, state.selected_road, network, t, k_dir, physics)
        road, road_delta_tt = apply_transfers(
            road, network, t, accept, agent, dest, popped, physics,
            compute_delta=want_delta,
        )

    # --- clock + metrics ---
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
        road=road,
        time=new_time,
        key=key,
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


@spanned("tick")
def tick(
    state: SimState,
    network: Network,
    policy: Policy,
    sim: SimConfig = DEFAULT_SIM,
    physics: PhysicsConfig = DEFAULT_PHYSICS,
    lazy_inserted: bool = False,
    core: Callable = direction_confirm,
    choice_fn: Optional[Callable] = None,
    payload: Callable = fused_core_sample,
) -> tuple[SimState, TickLog]:
    """One tick: insert -> withdraw -> choice -> core, clock and metrics.

    ``lazy_inserted`` (backlog mode) skips the per-tick inserted-flag
    writes; :func:`run_episode` rebuilds the flag once at the end.
    ``core`` is the winner+confirm function, given the tick's direction
    key (it draws its own noise); pass :func:`~tarl_tpu_torch.core.
    fused_winner.direction_confirm_plain` to run the plain version on a
    CUDA device for comparison.  ``payload`` is the fused core's edge
    phase (``fused_core`` only); pass :func:`~tarl_tpu_torch.core.
    fused_core.fused_core_sample_plain` the same way.  ``choice_fn`` replaces
    ``policy.choice`` (same signature).  Entry roads read
    ``state.next_hop`` as it was before this tick's choice."""
    state, saturated = insert_phase(state, network, policy, sim, physics,
                                    lazy_inserted)
    state, wcount = withdraw_phase(state, network, sim)
    with span("choice"):
        state, _ = (choice_fn or policy.choice)(state, network)
    return core_phase(state, network, wcount, saturated, sim, physics,
                      core=core, payload=payload)


def run_episode(
    state: SimState,
    network: Network,
    policy: Policy,
    num_steps: int,
    sim: SimConfig = DEFAULT_SIM,
    physics: PhysicsConfig = DEFAULT_PHYSICS,
    core: Callable = direction_confirm,
    payload: Callable = fused_core_sample,
) -> tuple[SimState, TickLog]:
    """Run ``num_steps`` ticks; returns the final state and the per-tick
    logs stacked along a leading axis.  In backlog mode the inserted flag
    is maintained lazily and rebuilt once at the end, as in the reference.
    ``core`` and ``payload`` are passed to :func:`tick`."""
    lazy = sim.insert_backlog is not None and state.backlog is not None
    logs = []
    for _ in range(num_steps):
        state, log = tick(state, network, policy, sim, physics,
                          lazy_inserted=lazy, core=core, payload=payload)
        logs.append(log)
    if lazy:
        state = state._replace(agents=reconstruct_inserted(
            state.agents, state.backlog, state.insert_ptr))
    return state, stack_logs(logs, state.road.count.device)


def stack_logs(logs: list, dev) -> TickLog:
    return TickLog(*(
        torch.stack([getattr(lg, f) for lg in logs]).to(dev) if logs
        else torch.zeros((0,), device=dev)
        for f in TickLog._fields
    ))


def run_episode_periodic(
    state: SimState,
    network: Network,
    policy: Policy,
    num_steps: int,
    sim: SimConfig = DEFAULT_SIM,
    physics: PhysicsConfig = DEFAULT_PHYSICS,
    core: Callable = direction_confirm,
) -> tuple[SimState, TickLog]:
    """:func:`run_episode` for a policy with a periodic refresh, as periods
    of ``policy.periodic_rate`` ticks: the first tick of a period refreshes
    the table at its choice phase (so that tick's insert still routes
    through the previous table, as in :func:`run_episode`), the others only
    look up.  Bitwise equal to :func:`run_episode` when ``num_steps`` and
    ``state.choice_count`` are multiples of the rate."""
    rate = policy.periodic_rate
    if not rate or policy.refresh is None or policy.lookup is None:
        raise ValueError("policy carries no periodic refresh/lookup split")
    if num_steps % rate != 0:
        raise ValueError(
            f"num_steps={num_steps} not a multiple of periodic_rate={rate}")
    if state.choice_count % rate != 0:
        raise ValueError(f"choice_count={state.choice_count} not a multiple "
                         f"of periodic_rate={rate}")

    def refresh_choice(s, net):
        with span("refresh"):
            buf = policy.refresh(s, net)
        return policy.lookup(s, net, buf)._replace(next_hop=buf), None

    def lookup_choice(s, net):
        return policy.lookup(s, net, s.next_hop), None

    logs = []
    for _ in range(num_steps // rate):
        state, log = tick(state, network, policy, sim, physics, core=core,
                          choice_fn=refresh_choice)
        logs.append(log)
        for _ in range(rate - 1):
            state, log = tick(state, network, policy, sim, physics,
                              core=core, choice_fn=lookup_choice)
            logs.append(log)
    return state, stack_logs(logs, state.road.count.device)


def average_travel_time(agents: AgentState) -> torch.Tensor:
    """Mean realised travel time over DONE agents."""
    done = agents.done
    tt = torch.where(done, agents.arrival - agents.departure, 0.0)
    n = torch.clamp(done.to(torch.float32).sum(), min=1.0)
    return tt.sum() / n
