"""The road-sharded episode (ports ``tarl_tpu/parallel/shard_map_episode.py``:
``make_road_mesh`` and ``run_episode_shard_map``).

The roads are split into S contiguous blocks of ``rl = ceil(R / S)`` roads;
the last block is padded with inert rows (capacity 0, no in-edges, DEST -1,
empty rings), which nothing enters, leaves or crosses.  A process holds
some of the blocks (their FIFO rings, their columns of the hourly metrics
and of the in-slot tables; block ``b``'s rows are local rows ``(b - first)
* rl`` on) and a copy of everything else: agents, selections, the key, the
routing scratch, the backlog queues.  A tick is the serial tick
(:func:`~tarl_tpu_torch.core.step.tick`) with every read of another block's
rows replaced by a collective of the :class:`RoadMesh`:

* ``all_gather`` of the per-road head summary, the halo (:class:`Halo`),
  twice: before the insert (slots and capacity) and after the withdraw
  (route choice, eligibility, delay row);
* ``all_gather`` of the per-road winners, so that each winning upstream's
  block pops its head;
* ``psum`` of the agent-side writes (the whole-population insert's
  inserted flags, the withdraw's arrivals; an agent sits on one road, so
  the blocks' writes are disjoint) and of the tick's on-way and done counts;
* for a learned policy, ``all_gather`` of the blocks' selections and, for
  an attention net, of each layer's node rows.

Replicated work runs once per process: the frontier appends, the admission
math, the key schedule and the route choice.  The random and the
shortest-path policies (primal, dual and strict-compat) choose replicated
on the halo, which they read as a :class:`~tarl_tpu_torch.state.RoadState`'s
heads and counts: their refreshes take their costs from the halo's counts
under the policy's own ``cost_mode`` and edge-cost form.  A learned policy
(``Policy.learned``) runs edge-sharded: the node context is built
replicated from the halo, the net scores only the out-edge columns of the
held blocks and the virtual SRC/DEST columns, and the blocks' selections
are gathered (:func:`_learned_block_choice`).  Each block writes only its
own rows.  The winner of every local road is one launch of K7
(:func:`~tarl_tpu_torch.core.fused_winner.fused_shard_winner`) for all of
the process's blocks, which draws the tick's direction noise inside from
its key, at the serial tick's addresses: no ``[KIN, R]`` matrix is drawn.
The episode equals the serial one bitwise.

:class:`RoadMesh` holds every block in one process, where its collectives
are a reshape and a sum over the block axis, or spreads them over the
ranks of a ``torch.distributed`` process group.

Not ported: the roll plan (``_block_roll_read``), a bitwise-neutral TPU
evaluation of the slot reads, which are direct gathers here; the
``TARL_SHARD_SKIP`` diagnostics; the compiled-episode cache (nothing is
compiled, so its faults R1 and R2 cannot occur).
"""
from __future__ import annotations

import os
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.distributed as dist
from torch.func import functional_call

from ..config import (
    DEFAULT_PHYSICS,
    DEFAULT_ROUTING,
    DEFAULT_SIM,
    PhysicsConfig,
    RoutingConfig,
    SimConfig,
)
from ..core import rng
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
from ..rl.learned_policy import (
    _slot_argmax,
    full_out_tables,
    rollout_context,
    slot_logits,
)
from ..state import MetricState, RoadState, SimState, TickLog
from .mesh import Ranks


class RoadMesh:
    """``num_blocks`` road blocks, of which this process holds ``held``
    contiguous blocks from block ``first``, on ``device``.  The tick reads
    other blocks' rows through :meth:`all_gather` and :meth:`psum` only.

    Without a ``group`` the process holds every block, and the collectives
    are a reshape and a sum over the block axis.  With a
    ``torch.distributed`` process group of W ranks, rank k holds blocks
    ``[k S/W, (k+1) S/W)`` and the collectives run over the group, in rank
    order, through its :class:`~tarl_tpu_torch.parallel.mesh.Ranks`
    (``ranks``; NCCL on the card, gloo staged through the host).

    Every rank ends each collective with the same bits.  An all-gather
    copies.  The tick's sums are of integers only: the inserted and arrival
    marks (int32 per agent, written by one block each) and the on-way and
    done counts (int32, cast to float32 after the sum, as the serial tick
    casts its own integer sum), so the ring order of a reduction cannot
    change a bit; a bool sums as int32.

    The training paths (``parallel.sharded_ppo``, ``parallel.spatial_ppo``)
    also sum floats: per-block log-prob and entropy partials, the
    ``progress`` potential's block sums and the gradients
    (:meth:`psum_tensors`).  A float sum adds the held blocks in block
    order and then the ranks in the ring's order, which is not the
    one-process order, so those results are held to a tolerance, never
    bitwise.  :meth:`all_gather` and :meth:`psum` carry gradients across
    ranks (:class:`~tarl_tpu_torch.parallel.mesh.Ranks`); in one process
    the reshape and the sum carry them already."""

    def __init__(self, num_blocks: int, device=None, group=None):
        if num_blocks < 1:
            raise ValueError(f"num_blocks must be positive, got {num_blocks}")
        self.num_blocks = num_blocks
        self.group = group
        self.ranks = None
        world, rank = 1, 0
        if group is not None:
            world, rank = dist.get_world_size(group), dist.get_rank(group)
            if num_blocks % world:
                raise ValueError(f"{num_blocks} road blocks do not split "
                                 f"over {world} ranks")
            if device is None:
                local = int(os.environ.get("LOCAL_RANK", rank))
                device = torch.device("cuda", local)
        self.device = resolve_device(device)
        if group is not None:
            self.ranks = Ranks(group, self.device)
        self.rank = rank
        self.held = num_blocks // world
        self.first = rank * self.held

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """``[held, rl, ...]`` rows of the held blocks -> ``[num_blocks *
        rl, ...]``, the rows of every block in block order; differentiable
        across ranks."""
        rows = x.reshape(-1, *x.shape[2:])
        return rows if self.ranks is None else self.ranks.gather(rows)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """``[held, ...]`` per-block partials -> their sum over all
        blocks (a bool sums as int32); differentiable across ranks."""
        dtype = torch.int32 if x.dtype == torch.bool else x.dtype
        total = x.sum(dim=0, dtype=dtype)
        return total if self.ranks is None else self.ranks.sum(total,
                                                                fresh=True)

    def psum_tensors(self, tensors: list) -> list:
        """Each of ``tensors`` (this process's float partials, one dtype)
        summed over the ranks, in one all-reduce; the tensors themselves in
        one process."""
        if self.ranks is None:
            return list(tensors)
        return self.ranks.sum_tensors(tensors)


def make_road_mesh(num_blocks: int, device=None, group=None) -> RoadMesh:
    """A mesh of ``num_blocks`` road blocks (node-column blocks for the
    training paths: ``sharded_ppo.make_node_mesh`` and
    ``spatial_ppo.make_spatial_mesh`` are this function) on ``device``
    (``None``: the card; with a ``group``, ``cuda:<LOCAL_RANK>``, the group
    rank where the environment names none), all held by this process, or
    split over the ranks of the ``torch.distributed`` process ``group``
    (see :class:`RoadMesh`).  Raises where the group's size does not
    divide ``num_blocks``."""
    return RoadMesh(num_blocks, device, group)


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


def _learned_block_choice(spec, network: Network, mesh: RoadMesh,
                          rl: int) -> Callable:
    """The edge-sharded form of ``rl.learned_policy.make_learned_choice``'s
    choice for ``spec``: ``choice(state, halo) -> state``.

    The node context ``x[N, C]`` is built replicated from the halo's counts
    and head ids; the key is split once and one replicated ``[KF, N]``
    Gumbel matrix drawn from its second half (none where deterministic),
    of which each process reads its blocks' columns and the virtual ones.
    The net scores the out-edge columns of the held blocks (padded columns
    clamped to road ``R-1`` and masked) and the virtual SRC/DEST columns
    ``R..N``, which every process computes: the MPNN's per-edge MLP on
    those columns alone (``slot_logits``; every edge row is computed on
    its own), the transformer's slot twin over them with each layer's node
    update joined by an ``all_gather`` of the blocks' rows.  The
    ascending-slot argmax runs on the same columns and the blocks'
    selections are gathered."""
    r, n_nodes = network.num_roads, network.num_nodes
    dev = network.device
    lo, n = mesh.first * rl, mesh.held * rl
    if spec.slot_net is not None:
        ok, dst = spec.slot_tables.out_ok, spec.slot_tables.out_dst
        attr = None
    else:
        ok, dst, attr = full_out_tables(network)
    kf = ok.shape[0]
    held = torch.arange(lo, lo + n, dtype=torch.int32, device=dev)
    cols_blk = torch.clamp(held, max=r - 1)
    real = (held < r)[None, :]
    ok_blk = ok[:, cols_blk.long()] & real
    dst_blk = dst[:, cols_blk.long()]
    virt = torch.arange(r, n_nodes, dtype=torch.int32, device=dev)
    ok_virt, dst_virt = ok[:, r:], dst[:, r:]
    cols_all = torch.cat([cols_blk, virt])

    def sync(h_cols):
        h_blk = mesh.all_gather(h_cols[:n].view(mesh.held, rl, -1))
        return torch.cat([h_blk[:r], h_cols[n:]])

    @torch.no_grad()
    def choice(st: SimState, hl: Halo) -> SimState:
        x = rollout_context(st, network, spec.pending_entrants,
                            count=hl.count[:r], head_ids=hl.ids[:r],
                            extra_obs=spec.extra_obs)
        if spec.slot_net is not None:
            logits = functional_call(spec.slot_net, spec.params,
                                     (x, spec.slot_tables, cols_all),
                                     {"sync": sync})
            l_blk, l_virt = logits[:, :n], logits[:, n:]
        else:
            l_blk = slot_logits(spec, x, network, dst, attr, cols_blk)
            l_virt = slot_logits(spec, x, network, dst, attr, virt)
        key, sub = split(st.key)
        if not spec.deterministic:
            g = rng.gumbel(sub, (kf, n_nodes), dev)
            l_blk = l_blk + g[:, cols_blk.long()]
            l_virt = l_virt + g[:, r:]
        neg_inf = float("-inf")
        prev = st.selected_road[cols_blk.long()]
        sel_blk = _slot_argmax(torch.where(ok_blk, l_blk, neg_inf), dst_blk,
                               prev)
        sel_roads = mesh.all_gather(sel_blk.view(mesh.held, rl))[:r]
        sel_virt = _slot_argmax(torch.where(ok_virt, l_virt, neg_inf),
                                dst_virt, st.selected_road[r:])
        return st._replace(selected_road=torch.cat([sel_roads, sel_virt]),
                           key=key)

    return choice


class RoadBlocks:
    """The roads of ``network`` on the blocks of ``mesh``, and the sections
    of a tick that read across blocks, shared by the sharded episode and
    ``parallel.spatial_ppo``'s rollout.

    ``rp`` roads padded to a multiple of the blocks, ``rl`` rows a block;
    this process holds rows ``[lo, lo + n)``.  Per-road columns of these
    rows are :attr:`tables`; the ring state of the held rows is a
    :class:`~tarl_tpu_torch.state.RoadState` of ``n`` rows, the hourly
    metrics ``[H, n]`` columns."""

    def __init__(self, network: Network, mesh: RoadMesh, num_agents: int):
        s_blocks = mesh.num_blocks
        self.network, self.mesh = network, mesh
        self.r, self.nmax = network.num_roads, network.nmax
        self.rp = -(-self.r // s_blocks) * s_blocks
        self.rl = self.rp // s_blocks
        self.lo, self.n = mesh.first * self.rl, mesh.held * self.rl
        self.a = num_agents
        self.dev = dev = network.device
        self.layout = upstream_pack_layout(self.r, self.nmax)
        capacity = self.rows(network.capacity, 0.0)
        self.tables = _Tables(
            capacity=capacity,
            free_flow=self.rows(network.free_flow, 1.0),
            congestion_constant=self.rows(network.congestion_constant, 1.0),
            road_dest=self.rows(network.road_dest, -1),
            slots=ShardTables(
                in_src=self.cols(network.in_src_tab, 0),
                in_logit=self.cols(network.in_logit_tab, 0.0),
                in_ok=self.cols(network.in_edge_ok, False),
                capacity=capacity, road_order=network.road_order),
        )
        self.cap_p = self.pad(network.capacity, 0.0)
        # The held block of each local row.
        self.owner = torch.arange(self.n, device=dev) // self.rl

    def pad(self, x, fill):
        """``x`` with its leading (road) axis padded to ``rp``."""
        if self.rp == self.r:
            return x
        tail = torch.full((self.rp - self.r,) + tuple(x.shape[1:]), fill,
                          dtype=x.dtype, device=x.device)
        return torch.cat([x, tail])

    def rows(self, x, fill):
        """The held blocks' rows of a per-road array."""
        return self.pad(x, fill)[self.lo:self.lo + self.n]

    def cols(self, x, fill):
        """The held blocks' columns of a ``[*, R]`` array."""
        return self.pad(x.t(), fill)[self.lo:self.lo + self.n].t() \
            .contiguous()

    def gather_rows(self, x):
        """Every real road's rows of a held-rows array."""
        mesh = self.mesh
        return mesh.all_gather(x.reshape(mesh.held, self.rl,
                                         *x.shape[1:]))[:self.r]

    def gather_cols(self, x):
        return self.gather_rows(x.t()).t().contiguous()

    def block_sums(self, x) -> torch.Tensor:
        """int32 ``[held]``: a held-rows int array summed per block."""
        return x.view(self.mesh.held, self.rl).sum(dim=1, dtype=torch.int32)

    def halo(self, ring: RoadState) -> Halo:
        f32, i32 = torch.float32, torch.int32
        local = torch.stack([
            ring.head_ids(), ring.head_arrival().view(i32),
            ring.head_departure().view(i32), ring.count, ring.head,
            ring.head_dests()], dim=1)
        g = self.mesh.all_gather(local.view(self.mesh.held, self.rl, 6)) \
            .t().contiguous()
        return Halo(g[0], g[1].view(f32), g[2].view(f32), g[3], g[4], g[5])

    def merge_agents(self, local_rows, ids, valid) -> torch.Tensor:
        """Agents written by some block: per-block marks of ``ids`` (at
        local ring rows ``local_rows`` where ``valid``), summed by
        ``psum``.  bool[A]."""
        mesh, a = self.mesh, self.a
        marks = scatter_set(
            torch.zeros(mesh.held * a, dtype=torch.int32, device=self.dev),
            torch.div(local_rows, self.rl, rounding_mode="floor") * a + ids,
            1, valid)
        return mesh.psum(marks.view(mesh.held, a)) > 0

    def admit(self, blocks, agents, network, time, physics, ids, road_key,
              dest, update_inserted=True, stamp_count=None):
        """``_admit_candidates`` on road blocks: the admission math on the
        global heads and counts, ring writes masked to the held blocks."""
        ok, slot, dep_stamp = admission(blocks.head, blocks.count, network,
                                        time, physics, road_key, self.nmax,
                                        stamp_count)
        local = road_key.long() - self.lo
        mine = ok & (local >= 0) & (local < self.n)
        ring = write_rings(blocks.ring, local, slot, mine, ids, dest,
                           dep_stamp, time)
        count = scatter_add(blocks.count, road_key, ok.to(torch.int32), ok)
        if update_inserted:
            agents = agents._replace(
                inserted=agents.inserted | self.merge_agents(local, ids,
                                                             mine))
        return _Blocks(ring, blocks.head, count), agents, ok

    def insert(self, agents, ring: RoadState, hl: Halo, selected_road, time,
               physics, entry_road=None):
        """The whole-population insert on the blocks: ``(agents, ring)``,
        the ring's counts the held rows of the global counts."""
        blocks, agents = insert_agents(
            _Blocks(ring, hl.head, hl.count), agents, selected_road,
            self.network, time, physics, entry_road=entry_road,
            admit=self.admit)
        return agents, blocks.ring._replace(
            count=blocks.count[self.lo:self.lo + self.n])

    def withdraw(self, agents, ring: RoadState, time, depth=None,
                 escalate: bool = False):
        """The withdraw on the held rows: ``(agents, ring, wcount)``, the
        arrivals merged over the blocks."""
        mesh, a, nmax = self.mesh, self.a, self.nmax
        k = nmax if depth is None else min(depth, nmax)
        marks = torch.zeros(mesh.held * a, dtype=torch.int32,
                            device=self.dev)

        def one_pass(head, count, marks):
            ids, run, w = scan_run(ring, self.tables.road_dest, time, head,
                                   count, k)
            marks = scatter_set(marks, (self.owner[:, None] * a + ids)
                                .reshape(-1), 1, run.reshape(-1))
            return (torch.remainder(head + w, nmax).to(torch.int32),
                    count - w, marks, w)

        head, count, marks, wcount = one_pass(ring.head, ring.count, marks)
        if escalate and k < nmax:
            # Every held block scans again while any of them hit the depth:
            # a pass changes nothing on a block whose runs stopped short.
            last = wcount
            while host_read(torch.any(last == k),
                            site="parallel.shard_map_episode")[0]:
                head, count, marks, last = one_pass(head, count, marks)
                wcount = wcount + last
        withdrew = mesh.psum(marks.view(mesh.held, a)) > 0
        agents = agents._replace(
            arrival=torch.where(withdrew, time, agents.arrival))
        return agents, ring._replace(head=head, count=count), wcount

    def core(self, ring: RoadState, hl: Halo, selected_road, time, k_dir,
             physics, winner: Callable = fused_shard_winner):
        """The blocks' winners (one ``winner`` call for the held blocks),
        the tail push and the head pop: ``(ring, popped)``, ``popped`` bool
        over the held rows."""
        r, rp, lo, n = self.r, self.rp, self.lo, self.n
        mesh = self.mesh
        sel = selected_road[:r]
        sel_enc = self.pad(torch.where((sel >= 0) & (sel < r), sel, r), r)
        pack = pack_upstream(hl.departure, hl.count, self.cap_p, sel_enc,
                             time, physics, r, self.nmax)
        accept, win, agent, dest = winner(
            pack, hl.ids, hl.dests, k_dir, self.tables.slots,
            ring.count.to(torch.float32), lo, rp, physics, self.layout)
        ring = push_winners(ring, self.tables, time, accept, agent, dest,
                            physics)
        winners = mesh.all_gather(win.view(mesh.held, self.rl))
        popped = scatter_set(torch.zeros(rp, dtype=torch.bool,
                                         device=self.dev),
                             winners, True, winners < rp)[lo:lo + n]
        return pop_heads(ring, popped), popped

    def local_state(self, state: SimState) -> SimState:
        """``state`` with its rings and hourly metrics cut to the held
        rows."""
        return state._replace(
            road=RoadState(*(self.rows(f, 0) for f in state.road)),
            metrics=state.metrics._replace(
                hourly_counts=self.cols(state.metrics.hourly_counts, 0),
                delta_tt_hourly=self.cols(state.metrics.delta_tt_hourly,
                                          0.0)))

    def global_state(self, st: SimState) -> SimState:
        """The inverse of :meth:`local_state`, gathered over the blocks."""
        return st._replace(
            road=RoadState(*(self.gather_rows(f) for f in st.road)),
            metrics=st.metrics._replace(
                hourly_counts=self.gather_cols(st.metrics.hourly_counts),
                delta_tt_hourly=self.gather_cols(
                    st.metrics.delta_tt_hourly)))


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
    run's bitwise (on every rank of a process group).

    A learned ``policy`` (``make_learned_choice``: the MPNN or the
    transformer) chooses edge-sharded; any other choice runs replicated on
    the halo, which it reads as it reads a
    :class:`~tarl_tpu_torch.state.RoadState`'s heads and counts: the random
    policy, or a shortest-path policy of ``make_policy`` (primal all-pairs
    or destination-restricted, dual, strict-compat); ``routing`` is the
    configuration it was built with, and ``strict_compat`` there requires
    the dual backend's policy.  ``winner`` is the road-block winner; pass
    :func:`~tarl_tpu_torch.core.fused_winner.fused_shard_winner_plain` to
    run the plain version on the card; it takes the tick's direction key
    where the reference's took the blocks' Gumbel columns."""
    if routing.strict_compat and not policy.needs_next_hop:
        raise ValueError("strict_compat on road blocks requires the dual "
                         "backend's policy")
    dev = state.road.count.device
    if dev.type != mesh.device.type or (
            mesh.device.index is not None and dev.index != mesh.device.index):
        raise ValueError(f"the state lies on {dev}, the mesh on "
                         f"{mesh.device}")
    kit = RoadBlocks(network, mesh, state.agents.num_agents)
    r, rl, lo, n = kit.r, kit.rl, kit.lo, kit.n
    lazy = sim.insert_backlog is not None and state.backlog is not None
    want_delta = (sim.record_road_optimality
                  or sim.record_road_optimality_hourly)
    learned = (None if policy.learned is None else
               _learned_block_choice(policy.learned, network, mesh, rl))

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
        if sim.insert_window is None:
            entry_road = (policy.entry(st, network)
                          if policy.entry is not None else None)
            agents, ring = kit.insert(st.agents, ring, hl, st.selected_road,
                                      t, physics, entry_road=entry_road)
            return st._replace(agents=agents), ring, 0.0
        entry_fn = entry_road = None
        if policy.entry_lookup is not None:
            def entry_fn(ids):
                return policy.entry_lookup(st, network, ids)
        elif policy.entry is not None:
            entry_road = policy.entry(st, network)
        blocks, agents, ptr, saturated = insert_agents_windowed(
            _Blocks(ring, hl.head, hl.count), st.agents, st.selected_road,
            network, t, st.insert_order, st.insert_ptr, sim.insert_window,
            physics, entry_road=entry_road, entry_lookup=entry_fn,
            sorted_fast=sim.sorted_population, escalate=sim.insert_escalate,
            admit=kit.admit)
        ring = blocks.ring._replace(count=blocks.count[lo:lo + n])
        return st._replace(agents=agents, insert_ptr=ptr), ring, saturated

    def tick(st: SimState) -> tuple[SimState, TickLog]:
        t = st.time
        ring = st.road
        st, ring, saturated = insert(st, ring, kit.halo(ring))
        agents, ring, wcount = kit.withdraw(st.agents, ring, t,
                                            sim.withdraw_depth,
                                            sim.withdraw_escalate)
        st = st._replace(agents=agents)

        # --- choice: edge-sharded (learned) or replicated on the halo ---
        hl = kit.halo(ring)
        if learned is not None:
            st = learned(st, hl)
        else:
            chosen, _ = policy.choice(st._replace(road=hl.roads(r)),
                                      network)
            st = st._replace(selected_road=chosen.selected_road,
                             key=chosen.key, next_hop=chosen.next_hop,
                             choice_count=chosen.choice_count,
                             sel_dest=chosen.sel_dest)

        # --- core: the blocks' winners (K7), tail push, head pop ---
        key, k_dir = split(st.key)
        delta = (road_delta(hl.roads(r), network) if want_delta
                 else torch.zeros((0,), dtype=torch.float32, device=dev))
        ring, popped = kit.core(ring, hl, st.selected_road, t, k_dir,
                                physics, winner)

        # --- clock + metrics ---
        hour = min(max(int(np.float32(t) / np.float32(3600.0)), 0),
                   sim.num_hours - 1)
        m = st.metrics
        hourly = m.hourly_counts.clone()
        hourly[hour] += ((wcount > 0) | popped).to(torch.int32)
        delta_hourly = m.delta_tt_hourly
        if sim.record_road_optimality_hourly and want_delta:
            delta_hourly = delta_hourly.clone()
            delta_hourly[hour] += kit.rows(delta, 0.0)
        f32 = torch.float32
        on_way = mesh.psum(kit.block_sums(ring.count)).to(f32)
        done = m.done_before + mesh.psum(kit.block_sums(wcount)).to(f32)
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

    st = kit.local_state(state)
    logs = []
    for _ in range(num_steps):
        st, log = tick(st)
        logs.append(log)
    final = kit.global_state(st)
    if lazy:
        final = final._replace(agents=reconstruct_inserted(
            final.agents, final.backlog, final.insert_ptr))
    return final, stack_logs(logs, dev)
