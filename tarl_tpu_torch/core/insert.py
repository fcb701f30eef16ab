"""Agent insertion: place due agents onto their entry road (ports
``tarl_tpu/core/insert.py``: ``insert_agents`` with its admission core,
``insert_agents_windowed``, ``backlog_frontier_append``,
``insert_agents_backlogged`` and ``reconstruct_inserted``).

Admission is the reference's: candidates in agent-id order, per road a
capacity prefix of ``capacity - CONGESTION_FILE - count`` agents, ring
slots ``head + count + rank``, arrival stamped ``time`` and departure
``time + max(fftt, cc / (cap + 10 - count_at_tick_start))``.

Not ported: the TPU-only evaluation devices that are bitwise-neutral — the
top_k compaction of the admission scatters, the pairwise rank and count
forms, and the float32 folding of the agent and road tables into one
gather.  Each data-dependent ``while_loop`` of the reference is a Python
loop whose condition costs one host read (:mod:`~tarl_tpu_torch.core.
sync`); the windowed insert reads its pointer advance once per pass.
"""
from __future__ import annotations

import torch

from ..config import DEFAULT_PHYSICS, PhysicsConfig
from ..network import Network
from ..ops.scatter import scatter_add, scatter_set
from ..state import AgentState, BacklogState, RoadState
from .sync import host_read

# Queue entries a drain pass pops per SRC (the reference's default).
POP_WIDTH = 4


def write_rings(road: RoadState, rows, slots, ok, ids, dests, dep_stamp,
                time: float):
    """The four ring writes of an admission at ``(rows, slots)`` where
    ``ok``.  Admitted (row, slot) pairs are distinct: ranks within a road
    are distinct and never exceed the free slots."""
    flat = rows.to(torch.int64) * road.nmax + slots.to(torch.int64)
    return road._replace(
        fifo_ids=scatter_set(road.fifo_ids, flat, ids, ok),
        fifo_arrival=scatter_set(road.fifo_arrival, flat, time, ok),
        fifo_departure=scatter_set(road.fifo_departure, flat, dep_stamp, ok),
        fifo_dest=scatter_set(road.fifo_dest, flat, dests, ok),
    )


def admission(head, count, network: Network, time: float,
              physics: PhysicsConfig, road_key: torch.Tensor, nmax: int,
              stamp_count: torch.Tensor | None = None):
    """Capacity-clipped group admission of candidates bidding ``road_key``
    (int32[K], R = not a candidate) against the ring heads and counts
    ``head`` and ``count`` (int32, indexed by road id); ranks within a road
    are candidate order (a stable sort by road, then the offset from the
    group start).  Returns ``(ok, slot, dep_stamp)`` per candidate.

    ``stamp_count`` replaces the occupancy in the departure stamp: the
    windowed insert's escalation passes stamp with the tick-start count, as
    one whole-population insert would.  Ranks and capacity use ``count``."""
    r = network.num_roads
    k = road_key.shape[0]
    dev = road_key.device

    road_sorted, order = torch.sort(road_key, stable=True)
    pos = torch.arange(k, dtype=torch.int64, device=dev)
    is_start = torch.ones(k, dtype=torch.bool, device=dev)
    is_start[1:] = road_sorted[1:] != road_sorted[:-1]
    group_start = torch.cummax(torch.where(is_start, pos, 0), dim=0).values
    rank_sorted = (pos - group_start).to(torch.int32)
    rank = torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)

    safe = torch.clamp(road_key, max=r - 1).long()
    head_c = head[safe]
    count_before = count[safe]
    cap_c = network.capacity[safe]
    cc_c = network.congestion_constant[safe]
    ff_c = network.free_flow[safe]

    remaining = (
        cap_c - physics.congestion_buffer - count_before.to(torch.float32)
    ).to(torch.int32)
    ok = (road_key < r) & (rank < remaining) & (remaining > 0)
    slot = torch.remainder(head_c + count_before + rank, nmax)

    stamp_c = count_before if stamp_count is None else stamp_count[safe]
    time_congestion = cc_c / (
        cap_c + physics.congestion_softening - stamp_c.to(torch.float32)
    )
    return ok, slot, time + torch.maximum(ff_c, time_congestion)


def _admit_candidates(
    road: RoadState,
    agents: AgentState,
    network: Network,
    time: float,
    physics: PhysicsConfig,
    candidate_ids: torch.Tensor,   # int32[K] agent ids
    road_key: torch.Tensor,        # int32[K] entry road, R = not a candidate
    cand_dest: torch.Tensor,       # int32[K] dest per candidate
    update_inserted: bool = True,
    stamp_count: torch.Tensor | None = None,  # int32[R] tick-start occupancy
) -> tuple[RoadState, AgentState, torch.Tensor]:
    """The :func:`admission` of the candidates into ``road``'s rings.
    Returns ``(road, agents, admitted)`` with ``admitted`` in candidate
    order.  Without ``update_inserted`` the caller sets the flag itself."""
    ok, slot, dep_stamp = admission(road.head, road.count, network, time,
                                    physics, road_key, road.nmax, stamp_count)
    road = write_rings(road, road_key, slot, ok, candidate_ids, cand_dest,
                       dep_stamp, time)
    count = scatter_add(road.count, road_key, ok.to(torch.int32), ok)
    if update_inserted:
        agents = agents._replace(
            inserted=scatter_set(agents.inserted, candidate_ids, True, ok))
    return road._replace(count=count), agents, ok


def insert_agents(
    road: RoadState,
    agents: AgentState,
    selected_road: torch.Tensor,
    network: Network,
    time: float,
    physics: PhysicsConfig = DEFAULT_PHYSICS,
    entry_road: torch.Tensor | None = None,
    admit=_admit_candidates,
) -> tuple[RoadState, AgentState]:
    """Insert every ready agent (departure reached, not yet inserted) whose
    entry road has spare capacity, over the whole population.  The entry
    road is ``entry_road`` (int32[A], e.g. a shortest-path policy's per-agent
    roads) or ``selected_road[origin]``.  ``admit`` places the candidates
    (the signature of ``_admit_candidates``; the road-sharded tick passes
    its block-masked form with its own ``road`` object)."""
    r = network.num_roads
    ready = (agents.departure <= time) & ~agents.inserted
    if entry_road is None:
        entry_road = selected_road[agents.origin.long()]
    valid_road = (entry_road >= 0) & (entry_road < r)
    road_key = torch.where(ready & valid_road, entry_road, r).to(torch.int32)
    candidate_ids = torch.arange(agents.num_agents, dtype=torch.int32,
                                 device=road_key.device)
    road, agents, _ = admit(
        road, agents, network, time, physics, candidate_ids, road_key,
        agents.dest,
    )
    return road, agents


def insert_agents_windowed(
    road: RoadState,
    agents: AgentState,
    selected_road: torch.Tensor,
    network: Network,
    time: float,
    order: torch.Tensor,
    ptr: int,
    window: int,
    physics: PhysicsConfig = DEFAULT_PHYSICS,
    entry_road: torch.Tensor | None = None,
    entry_lookup=None,
    sorted_fast: bool = False,
    escalate: bool = False,
    admit=_admit_candidates,
) -> tuple[RoadState, AgentState, int, float]:
    """Windowed insertion: candidates are the ``window`` agents of the
    departure order from position ``ptr`` (``order[ptr:ptr + W]``, or ids
    ``ptr + 1 ..`` with ``sorted_fast`` on a departure-sorted population).

    Entry roads come from ``entry_lookup(agent_ids)``, else from the full
    ``entry_road[A]``, else ``selected_road[origin]``.  The pointer advances
    past the leading run of settled (inserted) candidates.  Without
    ``escalate`` the overflow monitor reads 1.0 when the window's tail agent
    is already due (due agents may lie beyond the window), else 0.0.  With
    ``escalate`` further passes run at offsets ``ptr + k * W`` while the
    last pass's tail was due; the run then equals a whole-population insert
    bitwise, and the monitor counts the extra passes.  Each pass costs one
    host read (its pointer advance and tail flag).  ``admit`` as in
    :func:`insert_agents`; the stamp snapshot is ``road.count`` at entry.

    Returns ``(road, agents, new_ptr, saturated)``.
    """
    a = agents.num_agents
    w = min(window, a)
    if sorted_fast:
        w = min(w, a - 1)
        limit = a - 1 - w
    else:
        limit = a - w
    dev = road.count.device
    pos_w = torch.arange(w, dtype=torch.int32, device=dev)

    def one_pass(road, inserted, off, stamp_count):
        start = min(off, limit)
        if sorted_fast:
            lo = start + 1
            win_ids = lo + pos_w
            win_dep = agents.departure[lo:lo + w]
            win_origin = agents.origin[lo:lo + w]
            win_dest = agents.dest[lo:lo + w]
            win_inserted = inserted[lo:lo + w]
        else:
            win_ids = order[start:start + w]
            idx = win_ids.long()
            win_dep = agents.departure[idx]
            win_origin = agents.origin[idx]
            win_dest = agents.dest[idx]
            win_inserted = inserted[idx]
        ready = (win_dep <= time) & ~win_inserted
        if entry_lookup is not None:
            win_entry = entry_lookup(win_ids)
        elif entry_road is not None:
            win_entry = entry_road[win_ids.long()]
        else:
            win_entry = selected_road[win_origin.long()]
        valid = (win_entry >= 0) & (win_entry < network.num_roads)
        road_key = torch.where(ready & valid, win_entry,
                               network.num_roads).to(torch.int32)
        road, agents2, admitted = admit(
            road, agents._replace(inserted=inserted), network, time, physics,
            win_ids, road_key, win_dest, update_inserted=not sorted_fast,
            stamp_count=stamp_count)
        settled = win_inserted | admitted
        if sorted_fast:
            inserted = inserted.clone()
            inserted[lo:lo + w] = settled
        else:
            inserted = agents2.inserted
        adv_t = torch.min(torch.where(settled, w, pos_w))
        adv, sat = host_read(adv_t, win_dep[w - 1] <= time,
                             site="insert.window")
        return road, inserted, adv, bool(sat), start

    count0 = road.count            # tick-start occupancy (stamp snapshot)
    road, inserted, adv, sat, start0 = one_pass(road, agents.inserted, ptr,
                                                None)
    if not escalate:
        return (road, agents._replace(inserted=inserted),
                min(start0 + adv, a), float(sat))

    # Further passes while the last window's tail was due and a further
    # window covers new candidates.  The pointer advance chains only across
    # contiguous (unclamped) fully settled windows.
    adv_open, extra, start = adv == w, 0.0, start0
    while sat and start < limit:
        off = start + w
        road, inserted, adv_k, sat, start = one_pass(road, inserted, off,
                                                     count0)
        contiguous = start == off
        if adv_open and contiguous:
            adv += adv_k
        adv_open = adv_open and contiguous and adv_k == w
        extra += 1.0
    return (road, agents._replace(inserted=inserted), min(start0 + adv, a),
            extra)


def backlog_frontier_append(
    qpack: torch.Tensor, qcount: torch.Tensor, qhead: torch.Tensor,
    departure: torch.Tensor, origin: torch.Tensor, dest: torch.Tensor,
    ptr: int, time: float, *, num_roads: int, window: int,
    escalate: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, int, float]:
    """Departure-frontier appends into the per-SRC queues (phase 1 of
    :func:`insert_agents_backlogged`).

    Each pass scans the ``window``-wide id slice past ``ptr`` of the
    departure-sorted population, appends its due prefix to the agents' SRC
    queues in id order, and advances ``ptr`` past what it consumed; with
    ``escalate`` it repeats while a whole slice was consumed.  A due agent
    whose queue is full stops the frontier and counts as one overflow.
    One host read per pass.  Returns ``(qpack, qcount, new_ptr,
    overflow)``.
    """
    s, q, _ = qpack.shape
    a = departure.shape[0]
    f = min(window, a - 1)
    dev = qpack.device
    pos = torch.arange(f, dtype=torch.int64, device=dev)
    earlier = pos[None, :] < pos[:, None]
    overflow = 0.0
    while True:
        lo = min(ptr + 1, a - f)
        skip = ptr + 1 - lo        # clamped-slice prefix already consumed
        ids = (lo + pos).to(torch.int32)
        dep = departure[lo:lo + f]
        o = torch.clamp(
            torch.div(origin[lo:lo + f] - num_roads, 2, rounding_mode="floor"),
            0, s - 1,
        ).long()
        fresh = pos >= skip
        due = (dep <= time) & fresh
        # Append rank among earlier due same-SRC entries of the slice.
        rank = ((o[None, :] == o[:, None]) & due[None, :] & earlier).sum(
            dim=1, dtype=torch.int32)
        qpos = qcount[o] + rank
        roomok = qpos < q
        consumable = ~fresh | (due & roomok)
        adv_t = torch.min(torch.where(consumable, f, pos))
        band = due & roomok & (pos < adv_t)
        col = torch.remainder(qhead[o] + qpos, q).long()
        flat = (o * q + col) * 2
        qpack = scatter_set(qpack, flat, ids, band)
        qpack = scatter_set(qpack, flat + 1, dest[lo:lo + f], band)
        qcount = scatter_add(qcount, o, torch.ones_like(rank), band)
        stall = torch.where(pos == adv_t, due & ~roomok, False).sum()
        adv, due_at_stop = host_read(adv_t, stall, site="insert.frontier")
        overflow += float(due_at_stop)
        ptr = lo - 1 + adv
        if not (escalate and adv == f and ptr < a - 1):
            return qpack, qcount, ptr, overflow


def insert_agents_backlogged(
    road: RoadState,
    agents: AgentState,
    backlog: BacklogState,
    selected_road: torch.Tensor,
    network: Network,
    time: float,
    ptr: int,
    window: int,
    physics: PhysicsConfig = DEFAULT_PHYSICS,
    escalate: bool = True,
    update_inserted: bool = True,
):
    """Exact insertion via per-SRC candidate queues and a departure
    frontier.

    With the entry rule ``entry = selected_road[origin]`` a road is only
    ever bid by its tail SRC node, and all candidates of one SRC bid the
    same road each tick.  So every due agent flows through one ring per SRC
    in ascending id order: the frontier appends due agents, then a drain
    pops ``min(qcount, remaining, POP_WIDTH)`` entries per SRC straight into
    the road FIFOs, repeated while some queue still faces spare capacity
    (one host read per check).  Bitwise-identical to :func:`insert_agents`
    on a departure-sorted population while no queue overflows; ``overflow``
    counts the stalls of this tick.

    Returns ``(road, agents, backlog, new_ptr, overflow)``.
    """
    r = road.num_roads
    g_safe, gvalid = backlog_bids(selected_road, r, backlog.qpack.shape[0])
    qpack, qcount, new_ptr, overflow = backlog_frontier_append(
        backlog.qpack, backlog.qcount, backlog.qhead, agents.departure,
        agents.origin, agents.dest, ptr, time, num_roads=r, window=window,
        escalate=escalate,
    )
    road, inserted, qhead, qcount, total_take = drain_backlog(
        road, g_safe, None, road.head, road.count, g_safe, gvalid, qpack,
        backlog.qhead, qcount, network, time, physics,
        agents.inserted if update_inserted else None)
    count = scatter_add(road.count, g_safe, total_take, total_take > 0)
    road = road._replace(count=count)
    if update_inserted:
        agents = agents._replace(inserted=inserted)
    backlog = backlog._replace(qpack=qpack, qhead=qhead, qcount=qcount)
    return road, agents, backlog, new_ptr, overflow


def backlog_bids(selected_road, num_roads: int, num_srcs: int):
    """Each SRC node's re-bid road (``selected_road`` at SRC nodes R, R + 2,
    ...), 0 where invalid, as int64, and the valid mask."""
    g = selected_road[num_roads:num_roads + 2 * num_srcs:2]
    gvalid = (g >= 0) & (g < num_roads)
    return torch.where(gvalid, g, 0).long(), gvalid


def drain_backlog(road: RoadState, rows, rows_ok, head, count, g_safe,
                  gvalid, qpack, qhead, qcount, network: Network,
                  time: float, physics: PhysicsConfig, inserted=None):
    """The drain of :func:`insert_agents_backlogged`: pop ``min(qcount,
    remaining, POP_WIDTH)`` queue entries per SRC into its road's ring,
    repeated while some queue still faces spare capacity (one host read per
    check).  ``head`` and ``count`` are the heads and tick-start counts by
    road id, ``g_safe`` and ``gvalid`` each SRC's road (:func:`backlog_bids`);
    ``rows`` is the row of ``road``'s rings that holds each SRC's road, and
    where ``rows_ok`` (None: everywhere) is false the road's ring is
    another road block's and nothing is written here.  The ``inserted``
    flags of drained agents are set where given.  Returns ``(road,
    inserted, qhead, qcount, total_take)``; ``road.count`` is left as it
    was, ``total_take`` is what each SRC drained."""
    nmax = road.nmax
    s, q, _ = qpack.shape
    p = POP_WIDTH
    dev = qpack.device
    head_g = head[g_safe]
    c0_s = count[g_safe]
    cap_g = network.capacity[g_safe]
    tt_g = torch.maximum(
        network.free_flow[g_safe],
        network.congestion_constant[g_safe]
        / (cap_g + physics.congestion_softening - c0_s.to(torch.float32)),
    )
    dep_p = (time + tt_g)[:, None].expand(s, p).reshape(-1)
    pcol = torch.arange(p, dtype=torch.int32, device=dev)[None, :]
    rem_cap = (cap_g - physics.congestion_buffer).to(torch.int32)
    rows = rows[:, None].expand(s, p).reshape(-1)
    held = (None if rows_ok is None
            else rows_ok[:, None].expand(s, p).reshape(-1))

    cnt_s = c0_s
    while host_read(torch.any(gvalid & (qcount > 0) & (rem_cap > cnt_s)),
                    site="insert.drain")[0]:
        take = torch.clamp(torch.minimum(qcount, rem_cap - cnt_s), 0, p)
        take = torch.where(gvalid, take, 0)
        phys = torch.remainder(qhead[:, None] + pcol, q).long()
        pk = qpack.gather(1, phys[:, :, None].expand(s, p, 2))
        ids_p = pk[..., 0].reshape(-1)
        active = (pcol < take[:, None]).reshape(-1)
        slot = torch.remainder(head_g[:, None] + cnt_s[:, None] + pcol,
                               nmax).reshape(-1)
        # Drained rows are distinct across SRCs (a road is bid only by its
        # tail SRC), and slots within one SRC are distinct.
        road = write_rings(road, rows, slot,
                           active if held is None else active & held, ids_p,
                           pk[..., 1].reshape(-1), dep_p, time)
        if inserted is not None:
            inserted = scatter_set(inserted, ids_p, True, active)
        cnt_s = cnt_s + take
        qhead = torch.remainder(qhead + take, q).to(torch.int32)
        qcount = qcount - take
    return road, inserted, qhead, qcount, cnt_s - c0_s


def reconstruct_inserted(agents: AgentState, backlog: BacklogState,
                         ptr: int) -> AgentState:
    """Closed form of the inserted flag under backlog insertion:
    ``1 <= i <= ptr`` and ``i`` not waiting in any SRC queue."""
    a = agents.num_agents
    s, q, _ = backlog.qpack.shape
    dev = backlog.qpack.device
    iota = torch.arange(a, dtype=torch.int64, device=dev)
    base = (iota >= 1) & (iota <= ptr)
    qpos = torch.arange(q, dtype=torch.int32, device=dev)[None, :]
    in_ring = (torch.remainder(qpos - backlog.qhead[:, None], q)
               < backlog.qcount[:, None])
    inq = scatter_set(torch.zeros(a, dtype=torch.bool, device=dev),
                      backlog.qids.reshape(-1), True, in_ring.reshape(-1))
    return agents._replace(inserted=base & ~inq)
