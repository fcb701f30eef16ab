"""The road-sharded episode (ports ``tarl_tpu/parallel/shard_map_episode.py``:
``make_road_mesh`` and ``run_episode_shard_map``).

The roads are split into S contiguous blocks of ``rl = ceil(R / S)`` roads;
the last block is padded with inert rows (capacity 0, no in-edges, DEST -1,
empty rings), which nothing enters, leaves or crosses.  A device holds some
of the blocks (their FIFO rings, their columns of the hourly metrics and of
the in-slot tables; block ``b``'s rows are local rows ``(b - first) * rl``
on) and a copy of everything else: agents, selections, the key, the routing
scratch, the backlog queues.  A tick is the serial tick
(:func:`~tarl_tpu_torch.core.step.tick`) with every read of another block's
rows replaced by a collective of the :class:`RoadMesh`:

* ``all_gather`` of the per-road head summary, the halo (:class:`Halo`),
  twice: before the insert (slots and capacity) and after the withdraw
  (route choice, eligibility, delay row);
* ``all_gather`` of the per-road winners, so that each winning upstream's
  block pops its head;
* ``psum`` of the agent-side writes (the whole-population insert's
  inserted flags, the withdraw's arrivals; an agent sits on one road, so
  the blocks' writes are disjoint) and of the tick's on-way and done counts.

Replicated work runs once per device: the frontier appends, the admission
math, the route choice with its refreshes (K2) and the key schedule.  Each
block writes only its own rows.  The winner of every local road is one
launch of K7 (:func:`~tarl_tpu_torch.core.fused_winner.fused_shard_winner`)
for all of the device's blocks, which draws the tick's direction noise
inside from its key, at the serial tick's addresses: no ``[KIN, R]``
matrix is drawn.  The episode equals the serial one bitwise.

:class:`RoadMesh` holds every block on one device, where its collectives
are a reshape and a sum over the block axis.  Blocks spread over several
cards need the same interface over ``torch.distributed``.

Not ported: the roll plan (``_block_roll_read``), a bitwise-neutral TPU
evaluation of the slot reads, which are direct gathers here; the
``TARL_SHARD_SKIP`` diagnostics; the compiled-episode cache (nothing is
compiled, so its faults R1 and R2 cannot occur).  The learned,
strict-compat and dual shortest-path branches of the choice raise
``NotImplementedError`` until their serial policies are ported.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..config import (
    DEFAULT_PHYSICS,
    DEFAULT_ROUTING,
    DEFAULT_SIM,
    PhysicsConfig,
    RoutingConfig,
    SimConfig,
)
from ..core.direction import (
    pack_upstream,
    push_winners,
    road_delta,
    upstream_pack_layout,
)
from ..core.fused_winner import ShardTables, fused_shard_winner
from ..core.insert import (
    admission,
    backlog_bids,
    backlog_frontier_append,
    drain_backlog,
    insert_agents,
    insert_agents_windowed,
    reconstruct_inserted,
    write_rings,
)
from ..core.response import pop_heads
from ..core.rng import split
from ..core.step import Policy, stack_logs
from ..core.sync import host_read
from ..core.withdraw import scan_run
from ..device import resolve_device
from ..network import Network
from ..ops.scatter import scatter_add, scatter_set
from ..state import MetricState, RoadState, SimState, TickLog


class RoadMesh:
    """``num_blocks`` road blocks, of which the device holds ``held``
    contiguous blocks from block ``first``: here all of them, on
    ``device``.  The tick reads other blocks' rows through
    :meth:`all_gather` and :meth:`psum` only."""

    def __init__(self, num_blocks: int, device=None):
        if num_blocks < 1:
            raise ValueError(f"num_blocks must be positive, got {num_blocks}")
        self.num_blocks = num_blocks
        self.device = resolve_device(device)
        self.first = 0
        self.held = num_blocks

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """``[held, rl, ...]`` rows of the held blocks -> ``[num_blocks *
        rl, ...]``, the rows of every block in block order."""
        return x.reshape(-1, *x.shape[2:])

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """``[held, ...]`` per-block partials -> their sum over all
        blocks."""
        return x.sum(dim=0, dtype=x.dtype)


def make_road_mesh(num_blocks: int, device=None) -> RoadMesh:
    """A mesh of ``num_blocks`` road blocks on ``device`` (``None``: the
    card)."""
    return RoadMesh(num_blocks, device)


class Halo(NamedTuple):
    """The head summary of every road (``[Rp]`` each), as every device
    reads it: head id, arrival and departure, count, head slot and DEST
    node.  Ids stay int32 (exact at any size) where the reference carried
    them as float32.  The ``head_*`` methods and ``count`` read like a
    :class:`~tarl_tpu_torch.state.RoadState`'s, which is what the route
    choice and the delay row read of the roads."""

    ids: torch.Tensor
    arrival: torch.Tensor
    departure: torch.Tensor
    count: torch.Tensor
    head: torch.Tensor
    dests: torch.Tensor

    def head_ids(self) -> torch.Tensor:
        return self.ids

    def head_arrival(self) -> torch.Tensor:
        return self.arrival

    def head_departure(self) -> torch.Tensor:
        return self.departure

    def head_dests(self) -> torch.Tensor:
        return self.dests

    def roads(self, r: int) -> "Halo":
        """The summary of the first ``r`` (real) roads."""
        return Halo(*(f[:r] for f in self))


class _Tables(NamedTuple):
    """The network's per-road columns for the device's blocks (padded
    rows: capacity 0, free flow and congestion constant 1, DEST -1, no
    in-edges).  ``push_winners`` reads the first three as it reads a
    :class:`~tarl_tpu_torch.network.Network`'s."""

    capacity: torch.Tensor
    free_flow: torch.Tensor
    congestion_constant: torch.Tensor
    road_dest: torch.Tensor
    slots: ShardTables            # K7's in-slot columns, checked once


class _Blocks(NamedTuple):
    """What an insert of a sharded tick updates: the device's rings, and
    the global heads and counts (the halo's, counts updated as admissions
    land, alike on every device)."""

    ring: RoadState
    head: torch.Tensor
    count: torch.Tensor


def _check_policy(policy: Policy, routing: RoutingConfig) -> None:
    if routing.strict_compat or policy.needs_next_hop:
        raise NotImplementedError(
            "the strict-compat and dual shortest-path branches of the "
            "sharded choice come with the dual routing backend (slice 7)")
    if policy.learned is not None:
        raise NotImplementedError(
            "the learned policy's branch of the sharded choice comes with "
            "rl/learned_policy.py (slice 6)")


def run_episode_shard_map(
    state: SimState,
    network: Network,
    policy: Policy,
    num_steps: int,
    mesh: RoadMesh,
    sim: SimConfig = DEFAULT_SIM,
    physics: PhysicsConfig = DEFAULT_PHYSICS,
    routing: RoutingConfig = DEFAULT_ROUTING,
    winner: Callable = fused_shard_winner,
) -> tuple[SimState, TickLog]:
    """:func:`~tarl_tpu_torch.core.step.run_episode` over the road blocks
    of ``mesh``: ``num_steps`` ticks from ``state``; returns the final state
    and the stacked tick logs, in global road order, equal to the serial
    run's bitwise.

    ``policy``'s choice runs replicated on the halo, which it reads as it
    reads a :class:`~tarl_tpu_torch.state.RoadState`'s heads and counts:
    the random policy, or a primal shortest-path policy of ``make_policy``
    (all-pairs or destination-restricted); ``routing`` is the configuration
    it was built with.  ``winner`` is the road-block winner; pass
    :func:`~tarl_tpu_torch.core.fused_winner.fused_shard_winner_plain` to
    run the plain version on the card; it takes the tick's direction key
    where the reference's took the blocks' Gumbel columns."""
    _check_policy(policy, routing)
    dev = state.road.count.device
    if dev.type != mesh.device.type or (
            mesh.device.index is not None and dev.index != mesh.device.index):
        raise ValueError(f"the state lies on {dev}, the mesh on "
                         f"{mesh.device}")
    s_blocks = mesh.num_blocks
    r, nmax = network.num_roads, network.nmax
    rp = -(-r // s_blocks) * s_blocks
    rl = rp // s_blocks
    lo, n = mesh.first * rl, mesh.held * rl
    a = state.agents.num_agents
    layout = upstream_pack_layout(r, nmax)
    lazy = sim.insert_backlog is not None and state.backlog is not None
    want_delta = (sim.record_road_optimality
                  or sim.record_road_optimality_hourly)

    def pad(x, fill):
        """``x`` with its leading (road) axis padded to ``rp``."""
        if rp == r:
            return x
        tail = torch.full((rp - r,) + tuple(x.shape[1:]), fill,
                          dtype=x.dtype, device=x.device)
        return torch.cat([x, tail])

    def rows(x, fill):
        """The held blocks' rows of a per-road array."""
        return pad(x, fill)[lo:lo + n]

    def cols(x, fill):
        """The held blocks' columns of a ``[*, R]`` array."""
        return pad(x.t(), fill)[lo:lo + n].t().contiguous()

    capacity = rows(network.capacity, 0.0)
    tables = _Tables(
        capacity=capacity,
        free_flow=rows(network.free_flow, 1.0),
        congestion_constant=rows(network.congestion_constant, 1.0),
        road_dest=rows(network.road_dest, -1),
        slots=ShardTables(
            in_src=cols(network.in_src_tab, 0),
            in_logit=cols(network.in_logit_tab, 0.0),
            in_ok=cols(network.in_edge_ok, False),
            capacity=capacity, road_order=network.road_order),
    )
    cap_p = pad(network.capacity, 0.0)
    owner = torch.arange(n, device=dev) // rl     # held block of a local row

    def halo(ring: RoadState) -> Halo:
        f32, i32 = torch.float32, torch.int32
        local = torch.stack([
            ring.head_ids(), ring.head_arrival().view(i32),
            ring.head_departure().view(i32), ring.count, ring.head,
            ring.head_dests()], dim=1)
        g = mesh.all_gather(local.view(mesh.held, rl, 6)).t().contiguous()
        return Halo(g[0], g[1].view(f32), g[2].view(f32), g[3], g[4], g[5])

    def merge_agents(local_rows, ids, valid) -> torch.Tensor:
        """Agents written by some block: per-block marks of ``ids`` (at
        local ring rows ``local_rows`` where ``valid``), summed by
        ``psum``.  bool[A]."""
        marks = scatter_set(
            torch.zeros(mesh.held * a, dtype=torch.int32, device=dev),
            torch.div(local_rows, rl, rounding_mode="floor") * a + ids, 1,
            valid)
        return mesh.psum(marks.view(mesh.held, a)) > 0

    def admit(blocks, agents, network, time, physics, ids, road_key, dest,
              update_inserted=True, stamp_count=None):
        """``_admit_candidates`` on road blocks: the admission math on the
        global heads and counts, ring writes masked to the held blocks."""
        ok, slot, dep_stamp = admission(blocks.head, blocks.count, network,
                                        time, physics, road_key, nmax,
                                        stamp_count)
        local = road_key.long() - lo
        mine = ok & (local >= 0) & (local < n)
        ring = write_rings(blocks.ring, local, slot, mine, ids, dest,
                           dep_stamp, time)
        count = scatter_add(blocks.count, road_key, ok.to(torch.int32), ok)
        if update_inserted:
            agents = agents._replace(
                inserted=agents.inserted | merge_agents(local, ids, mine))
        return _Blocks(ring, blocks.head, count), agents, ok

    def insert(st: SimState, ring: RoadState, hl: Halo):
        """Returns ``(st, ring, saturated)``."""
        t = st.time
        if lazy:
            backlog = st.backlog
            g_safe, gvalid = backlog_bids(st.selected_road, r,
                                          backlog.qpack.shape[0])
            qpack, qcount, ptr, saturated = backlog_frontier_append(
                backlog.qpack, backlog.qcount, backlog.qhead,
                st.agents.departure, st.agents.origin, st.agents.dest,
                st.insert_ptr, t, num_roads=r, window=sim.insert_window,
                escalate=sim.insert_escalate)
            local = g_safe - lo
            mine = (local >= 0) & (local < n)
            ring, _, qhead, qcount, took = drain_backlog(
                ring, local, mine, hl.head, hl.count, g_safe, gvalid, qpack,
                backlog.qhead, qcount, network, t, physics)
            ring = ring._replace(count=scatter_add(ring.count, local, took,
                                                   mine & (took > 0)))
            return st._replace(
                backlog=backlog._replace(qpack=qpack, qhead=qhead,
                                         qcount=qcount),
                insert_ptr=ptr), ring, saturated
        blocks = _Blocks(ring, hl.head, hl.count)
        ptr, saturated = st.insert_ptr, 0.0
        if sim.insert_window is not None:
            entry_fn = entry_road = None
            if policy.entry_lookup is not None:
                def entry_fn(ids):
                    return policy.entry_lookup(st, network, ids)
            elif policy.entry is not None:
                entry_road = policy.entry(st, network)
            blocks, agents, ptr, saturated = insert_agents_windowed(
                blocks, st.agents, st.selected_road, network, t,
                st.insert_order, st.insert_ptr, sim.insert_window, physics,
                entry_road=entry_road, entry_lookup=entry_fn,
                sorted_fast=sim.sorted_population,
                escalate=sim.insert_escalate, admit=admit)
        else:
            entry_road = (policy.entry(st, network)
                          if policy.entry is not None else None)
            blocks, agents = insert_agents(
                blocks, st.agents, st.selected_road, network, t, physics,
                entry_road=entry_road, admit=admit)
        ring = blocks.ring._replace(count=blocks.count[lo:lo + n])
        return st._replace(agents=agents, insert_ptr=ptr), ring, saturated

    def withdraw(st: SimState, ring: RoadState):
        """Returns ``(st, ring, wcount)``."""
        t = st.time
        k = nmax if sim.withdraw_depth is None else min(sim.withdraw_depth,
                                                        nmax)
        marks = torch.zeros(mesh.held * a, dtype=torch.int32, device=dev)

        def one_pass(head, count, marks):
            ids, run, w = scan_run(ring, tables.road_dest, t, head, count, k)
            marks = scatter_set(marks, (owner[:, None] * a + ids).reshape(-1),
                                1, run.reshape(-1))
            return (torch.remainder(head + w, nmax).to(torch.int32),
                    count - w, marks, w)

        head, count, marks, wcount = one_pass(ring.head, ring.count, marks)
        if sim.withdraw_escalate and k < nmax:
            # Every held block scans again while any of them hit the depth:
            # a pass changes nothing on a block whose runs stopped short.
            last = wcount
            while host_read(torch.any(last == k))[0]:
                head, count, marks, last = one_pass(head, count, marks)
                wcount = wcount + last
        withdrew = mesh.psum(marks.view(mesh.held, a)) > 0
        agents = st.agents._replace(
            arrival=torch.where(withdrew, t, st.agents.arrival))
        return (st._replace(agents=agents),
                ring._replace(head=head, count=count), wcount)

    def tick(st: SimState) -> tuple[SimState, TickLog]:
        t = st.time
        ring = st.road
        st, ring, saturated = insert(st, ring, halo(ring))
        st, ring, wcount = withdraw(st, ring)

        # --- choice, replicated on the halo ---
        hl = halo(ring)
        chosen, _ = policy.choice(st._replace(road=hl.roads(r)), network)
        st = st._replace(selected_road=chosen.selected_road, key=chosen.key,
                         next_hop=chosen.next_hop,
                         choice_count=chosen.choice_count,
                         sel_dest=chosen.sel_dest)

        # --- core: the blocks' winners (K7), tail push, head pop ---
        key, k_dir = split(st.key)
        sel = st.selected_road[:r]
        sel_enc = pad(torch.where((sel >= 0) & (sel < r), sel, r), r)
        pack = pack_upstream(hl.departure, hl.count, cap_p, sel_enc, t,
                             physics, r, nmax)
        accept, win, agent, dest = winner(
            pack, hl.ids, hl.dests, k_dir, tables.slots,
            ring.count.to(torch.float32), lo, rp, physics, layout)
        delta = (road_delta(hl.roads(r), network) if want_delta
                 else torch.zeros((0,), dtype=torch.float32, device=dev))
        ring = push_winners(ring, tables, t, accept, agent, dest, physics)
        winners = mesh.all_gather(win.view(mesh.held, rl))
        popped = scatter_set(torch.zeros(rp, dtype=torch.bool, device=dev),
                             winners, True, winners < rp)[lo:lo + n]
        ring = pop_heads(ring, popped)

        # --- clock + metrics ---
        hour = min(max(int(np.float32(t) / np.float32(3600.0)), 0),
                   sim.num_hours - 1)
        m = st.metrics
        hourly = m.hourly_counts.clone()
        hourly[hour] += ((wcount > 0) | popped).to(torch.int32)
        delta_hourly = m.delta_tt_hourly
        if sim.record_road_optimality_hourly and want_delta:
            delta_hourly = delta_hourly.clone()
            delta_hourly[hour] += rows(delta, 0.0)
        per_block = (mesh.held, rl)
        on_way = mesh.psum(
            ring.count.view(per_block).sum(dim=1).to(torch.float32))
        done = m.done_before + mesh.psum(
            wcount.view(per_block).sum(dim=1).to(torch.float32))
        f32 = torch.float32
        log = TickLog(
            departures=on_way - m.on_way_before + done - m.done_before,
            arrivals=done - m.done_before,
            on_way=on_way,
            time=torch.tensor(t + sim.timestep, dtype=f32),
            road_delta_tt=(delta if sim.record_road_optimality else
                           torch.zeros((0,), dtype=f32, device=dev)),
            window_saturated=torch.tensor(saturated, dtype=f32),
        )
        return st._replace(
            road=ring, time=t + sim.timestep, key=key,
            metrics=MetricState(hourly, on_way, done, delta_hourly),
        ), log

    st = state._replace(
        road=RoadState(*(rows(f, 0) for f in state.road)),
        metrics=state.metrics._replace(
            hourly_counts=cols(state.metrics.hourly_counts, 0),
            delta_tt_hourly=cols(state.metrics.delta_tt_hourly, 0.0)),
    )
    logs = []
    for _ in range(num_steps):
        st, log = tick(st)
        logs.append(log)

    def gather_rows(x):
        return mesh.all_gather(x.reshape(mesh.held, rl, *x.shape[1:]))[:r]

    def gather_cols(x):
        return gather_rows(x.t()).t().contiguous()

    final = st._replace(
        road=RoadState(*(gather_rows(f) for f in st.road)),
        metrics=st.metrics._replace(
            hourly_counts=gather_cols(st.metrics.hourly_counts),
            delta_tt_hourly=gather_cols(st.metrics.delta_tt_hourly)),
    )
    if lazy:
        final = final._replace(agents=reconstruct_inserted(
            final.agents, final.backlog, final.insert_ptr))
    return final, stack_logs(logs, dev)
