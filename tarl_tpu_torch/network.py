"""Static road-network representation, the dual graph (ports
``tarl_tpu/network.py``: ``Network``, the road-renumbering search
(``_turn_edge_pairs``, ``_order_exceptions``, ``polar_rank``,
``hilbert_rank``, ``rcm_rank``, ``roll_friendly_road_order``),
``build_network`` and ``default_selected_road``).

Nodes are roads, then one SRC/DEST node pair per intersection (SRC of
intersection k is ``R + 2k``, DEST ``R + 2k + 1``); edges are allowed turns.
The build is the reference's, array for array, on numpy; the result lives
on one torch device.

The renumbering search fixes the road ids.  From 512 roads up, where the
input (XML link-list) order scatters the turn-edge offsets ``(u - v) mod
R`` and a locality order of the intersections concentrates them, the
build numbers the roads in that order, as the reference does; grids and
other small or well-ordered inputs keep the identity order.  So the road
ids of every report (``node_metrics.csv``, the road-optimality series,
``daily_counts.csv``) are the reference's on every network.  A renumbered
build keeps every slot table's within-column order canonical (by input
position), and the Gumbel streams are addressed by canonical position
(``core.rng``), so an episode is the same whichever order the build
chose.  ``road_order`` maps a road id to its input position.

Not ported, because on a GPU they carry no semantics: the roll plans
(``in_roll_*`` / ``out_roll_*``), which evaluated the in-slot gather as
rotations on the TPU.  The search keeps its acceptance rule, the roll
plan's exception budget (:func:`roll_cost_budget`), because that rule
decides the numbering.  The primal routing tables (``road_to``,
``inter_out_road``, ``inter_out_ok``) and the dual neighbour table
(``nbr``, ``nbr_ok``, read by the all-pairs relaxation of the learned
policy's distance prior) are built as the reference builds them.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ._build import check_tensor
from .config import DEFAULT_PHYSICS, PhysicsConfig
from .device import resolve_device
from .ops.segment import SegmentLayout, segment_layout


@dataclasses.dataclass(frozen=True)
class Network:
    """Immutable dual-graph network on one device.  Shapes: R roads, I
    intersections, N = R + 2*I nodes, E turn edges, Ef full edges, Ec
    choice edges; slot tables are ``[K, R]`` (or ``[KC, N]``), slot k of a
    road being its k-th edge in increasing edge id."""

    num_roads: int
    num_intersections: int
    nmax: int

    # Per-road attributes.
    capacity: torch.Tensor             # float32[R]
    free_flow: torch.Tensor            # float32[R]
    length: torch.Tensor               # float32[R]
    max_flow: torch.Tensor             # float32[R]
    critical_number: torch.Tensor      # float32[R]
    congestion_constant: torch.Tensor  # float32[R]
    road_dest: torch.Tensor            # int32[R] — DEST node of the road's head

    # Turn edges road -> road, full edges (plus SRC->road, road->DEST) and
    # choice edges (full edges whose target is a road).
    edge_src: torch.Tensor             # int32[E]
    edge_dst: torch.Tensor             # int32[E]
    edge_attr: torch.Tensor            # float32[E]
    full_src: torch.Tensor             # int32[Ef]
    full_dst: torch.Tensor             # int32[Ef]
    full_attr: torch.Tensor            # float32[Ef]
    choice_src: torch.Tensor           # int32[Ec]
    choice_dst: torch.Tensor           # int32[Ec]

    # Slot-major turn-edge tables read by the core.
    in_edge_ok: torch.Tensor           # bool[KIN, R]
    in_src_tab: torch.Tensor           # int32[KIN, R] (0-padded)
    in_logit_tab: torch.Tensor         # float32[KIN, R] — log(edge_attr), -inf on padding
    out_edge_ok: torch.Tensor          # bool[KOUT, R]
    out_dst_tab: torch.Tensor          # int32[KOUT, R]
    choice_ok: torch.Tensor            # bool[KC, N]
    choice_dst_tab: torch.Tensor       # int32[KC, N]

    # Padded out-neighbour table over the full edges (slot order = edge
    # order; padding slots hold the node itself and are masked invalid).
    nbr: torch.Tensor                  # int32[N, D]
    nbr_ok: torch.Tensor               # bool[N, D]

    # Primal (intersection) routing graph; slot order is increasing road
    # id, so argmin tie-breaks agree with the reference.
    road_to: torch.Tensor              # int32[R] — intersection at the road's head
    inter_out_road: torch.Tensor       # int32[I, K] — outgoing roads (0-padded)
    inter_out_ok: torch.Tensor         # bool[I, K]

    inter_x: torch.Tensor              # float32[I]
    inter_y: torch.Tensor              # float32[I]

    # Road index -> input (XML link-list) position, and whether that is a
    # non-identity permutation (the renumbering search's order).
    road_order: torch.Tensor           # int32[R]
    renumbered: bool = False

    @property
    def num_nodes(self) -> int:
        return self.num_roads + 2 * self.num_intersections

    @property
    def device(self) -> torch.device:
        return self.capacity.device

    @functools.cached_property
    def edge_layout(self) -> SegmentLayout:
        """The CSR of ``edge_dst`` over the roads (the fused core's
        segments: each road's incoming turn edges), built on first use."""
        return segment_layout(self.edge_dst, self.num_roads)

    @functools.cached_property
    def edge_src_layout(self) -> SegmentLayout:
        """The CSR of ``edge_src`` over the roads (each road's outgoing
        turn edges, the legacy confirm's segments), built on first use."""
        return segment_layout(self.edge_src, self.num_roads)

    @functools.cached_property
    def winner_tables(self) -> tuple[int, ...]:
        """Addresses of the tables the direction winner's kernel (K1)
        reads: ``capacity``, ``in_src_tab``, ``in_logit_tab``,
        ``in_edge_ok`` and ``road_order``.  Checked once, on first use, for
        the dtype, shape and layout the kernel takes (a frozen network's
        tables never change), so that a tick checks only its own
        inputs."""
        r = self.num_roads
        kin = self.in_src_tab.shape[0]
        tables = [
            ("capacity", self.capacity, torch.float32, (r,)),
            ("in_src_tab", self.in_src_tab, torch.int32, (kin, r)),
            ("in_logit_tab", self.in_logit_tab, torch.float32, (kin, r)),
            ("in_edge_ok", self.in_edge_ok, torch.bool, (kin, r)),
            ("road_order", self.road_order, torch.int32, (r,)),
        ]
        for name, t, dtype, shape in tables:
            check_tensor(name, t, dtype, shape, self.device)
        return tuple(t.data_ptr() for _, t, _, _ in tables)

    @functools.cached_property
    def choice_tables(self) -> tuple[int, ...]:
        """Addresses of the tables the random choice's kernel reads:
        ``choice_ok``, ``choice_dst_tab`` and ``road_order``.  Checked once,
        on first use, as :attr:`winner_tables` is."""
        slots = (self.choice_dst_tab.shape[0], self.num_nodes)
        tables = [
            ("choice_ok", self.choice_ok, torch.bool, slots),
            ("choice_dst_tab", self.choice_dst_tab, torch.int32, slots),
            ("road_order", self.road_order, torch.int32, (self.num_roads,)),
        ]
        for name, t, dtype, shape in tables:
            check_tensor(name, t, dtype, shape, self.device)
        return tuple(t.data_ptr() for _, t, _, _ in tables)

    @functools.cached_property
    def core_tables(self) -> tuple[int, ...]:
        """Addresses of the tables the fused core's sampler (K12, fused
        entry) reads: ``capacity``, ``edge_src``, ``edge_attr``, and the
        order and offsets of :attr:`edge_layout` (checked where it is
        built).  Checked once, on first use, as :attr:`winner_tables`
        is."""
        e = self.edge_src.shape[0]
        tables = [
            ("capacity", self.capacity, torch.float32, (self.num_roads,)),
            ("edge_src", self.edge_src, torch.int32, (e,)),
            ("edge_attr", self.edge_attr, torch.float32, (e,)),
        ]
        for name, t, dtype, shape in tables:
            check_tensor(name, t, dtype, shape, self.device)
        return (tuple(t.data_ptr() for _, t, _, _ in tables)
                + self.edge_layout.pointers)

    @property
    def num_turn_edges(self) -> int:
        return self.edge_src.shape[0]

    @property
    def num_full_edges(self) -> int:
        return self.full_src.shape[0]

    def src_node_indices(self) -> torch.Tensor:
        """int32[I]: the SRC node of each intersection, ``R + 2k``."""
        return self.num_roads + 2 * torch.arange(
            self.num_intersections, dtype=torch.int32, device=self.device)

    def dest_node_indices(self) -> torch.Tensor:
        """int32[I]: the DEST node of each intersection, ``R + 2k + 1``."""
        return self.src_node_indices() + 1

    def dense_adjacency(self) -> torch.Tensor:
        """bool[N, N] adjacency over the full edge list (for small networks
        and tests: N^2 bytes)."""
        n = self.num_nodes
        adj = torch.zeros((n, n), dtype=torch.bool, device=self.device)
        adj[self.full_src.long(), self.full_dst.long()] = True
        return adj

    def entry_cost(self) -> torch.Tensor:
        """Free-flow cost of entering each node: ``fftt`` for roads, 0 for
        SRC/DEST nodes.  float32[N]."""
        cost = torch.zeros((self.num_nodes,), dtype=torch.float32,
                           device=self.device)
        cost[:self.num_roads] = self.free_flow
        return cost

    def to(self, device: torch.device | str) -> "Network":
        """The same network with every tensor on ``device``."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        })


def _edge_table(by: np.ndarray, n_rows: int, order_key=None):
    """K-major padded table of edge ids grouped by ``by`` (slot order =
    increasing edge id, or increasing ``order_key[e]`` where given: the
    renumbered build's canonical order)."""
    groups: list[list[int]] = [[] for _ in range(n_rows)]
    for e, g in enumerate(by):
        groups[int(g)].append(e)
    kmax = max(1, max((len(g) for g in groups), default=1))
    tab = np.zeros((kmax, n_rows), dtype=np.int32)
    ok = np.zeros((kmax, n_rows), dtype=bool)
    for g, es in enumerate(groups):
        if order_key is not None:
            es = sorted(es, key=lambda e: order_key[e])
        for s, e in enumerate(es):
            tab[s, g] = e
            ok[s, g] = True
    return tab, ok


# --- the road-renumbering search ---------------------------------------------

# The reference's roll-plan cost model (``tarl_tpu/core/roll_gather.py``):
# an index of the serial gather costs ``_IDX_NS``, a roll bucket
# ``_ROLL_NS``; a plan is accepted while it costs under ``_COST_MARGIN`` of
# the direct gather.  They decide the numbering, so they are kept as they
# are.
_IDX_NS = 7.0
_ROLL_NS = 8000.0
_COST_MARGIN = 0.9
RENUMBER_MIN_ROADS = 512


def roll_cost_budget(num_entries: int, num_buckets: int) -> int:
    """The most exceptions a ``num_buckets``-roll plan of ``num_entries``
    indices may have under the cost model (0 when the rolls alone cost
    more)."""
    budget = (_COST_MARGIN * num_entries
              - num_buckets * (_ROLL_NS / _IDX_NS))
    return max(int(budget), 0)


def _turn_edge_pairs(from_inter, to_inter, num_intersections):
    """Every turn-edge road pair ``(u, v)`` (``head(u) == tail(v)``) as two
    int64 arrays, independent of the road numbering."""
    r = from_inter.shape[0]
    order_by_tail = np.argsort(from_inter, kind="stable")
    cnt_out = np.bincount(from_inter, minlength=num_intersections)
    starts = np.concatenate([[0], np.cumsum(cnt_out)])[:-1]
    deg = cnt_out[to_inter]
    e_u = np.repeat(np.arange(r, dtype=np.int64), deg)
    run_start = np.cumsum(deg) - deg
    within = np.arange(int(deg.sum()), dtype=np.int64) - np.repeat(
        run_start, deg)
    e_v = order_by_tail[np.repeat(starts[to_inter], deg) + within]
    return e_u, e_v


def _order_exceptions(pos, e_u, e_v, num_roads, max_buckets, floor):
    """The turn edges outside the ``max_buckets`` most frequent offsets
    ``(pos[u] - pos[v]) mod R`` of at least ``floor`` edges each, under
    the road order ``pos`` (``pos[input road] = new index``)."""
    off = (pos[e_u] - pos[e_v]) % num_roads
    _, cnts = np.unique(off, return_counts=True)
    cnts = np.sort(cnts)[::-1][:max_buckets]
    cnts = cnts[cnts >= floor]
    return int(off.size - cnts.sum())


def _rank_of(key: np.ndarray) -> np.ndarray:
    rank = np.empty(key.shape[0], np.int64)
    rank[key] = np.arange(key.shape[0])
    return rank


def polar_rank(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Rank nodes by (radius group, angle) around the centroid: the order
    of ring-and-spoke layouts.  Radius groups split the sorted radii at
    gaps wider than 0.1% of the radial range, so that coordinate noise
    within a ring does not split it."""
    cx, cy = x.mean(), y.mean()
    r = np.hypot(x - cx, y - cy)
    th = np.arctan2(y - cy, x - cx)
    rs = np.sort(r)
    thresh = max((rs[-1] - rs[0]) * 1e-3, 1e-9)
    jump = np.nonzero(np.diff(rs) > thresh)[0]
    bounds = rs[jump] + np.diff(rs)[jump] / 2
    rq = np.searchsorted(bounds, r)
    return _rank_of(np.lexsort((th, rq)))


def hilbert_rank(x: np.ndarray, y: np.ndarray, order: int = 10
                 ) -> np.ndarray:
    """Rank nodes by their position on a Hilbert curve over the
    coordinates' bounding box (``2**order`` cells a side): the locality
    order of irregular layouts."""
    n = 1 << order
    span_x = max(float(np.ptp(x)), 1e-12)
    span_y = max(float(np.ptp(y)), 1e-12)
    xi = np.minimum(((x - x.min()) / span_x * n).astype(np.int64), n - 1)
    yi = np.minimum(((y - y.min()) / span_y * n).astype(np.int64), n - 1)
    d = np.zeros_like(xi)
    s = n >> 1
    while s > 0:
        rx = ((xi & s) > 0).astype(np.int64)
        ry = ((yi & s) > 0).astype(np.int64)
        d += s * s * ((3 * rx) ^ ry)
        # Rotate the quadrant: where ry == 0 swap x and y, reflecting them
        # first where rx == 1.
        flip = ry == 0
        xr = np.where(flip & (rx == 1), s - 1 - xi, xi)
        yr = np.where(flip & (rx == 1), s - 1 - yi, yi)
        xi = np.where(flip, yr, xi)
        yi = np.where(flip, xr, yi)
        s >>= 1
    return _rank_of(np.lexsort((np.arange(x.shape[0]), d)))


def rcm_rank(from_inter: np.ndarray, to_inter: np.ndarray,
             num_intersections: int) -> np.ndarray | None:
    """Reverse-Cuthill-McKee rank over the intersection adjacency, the
    order for networks without coordinates; ``None`` without scipy."""
    try:
        from scipy.sparse import coo_matrix
        from scipy.sparse.csgraph import reverse_cuthill_mckee
    except ImportError:
        return None
    i = np.concatenate([from_inter, to_inter]).astype(np.int64)
    j = np.concatenate([to_inter, from_inter]).astype(np.int64)
    adj = coo_matrix((np.ones(i.shape[0], np.int8), (i, j)),
                     shape=(num_intersections, num_intersections)).tocsr()
    return _rank_of(np.asarray(reverse_cuthill_mckee(adj,
                                                     symmetric_mode=True)))


def roll_friendly_road_order(
    from_inter: np.ndarray,
    to_inter: np.ndarray,
    num_intersections: int,
    inter_x: np.ndarray | None,
    inter_y: np.ndarray | None,
    *,
    max_buckets: int = 24,
    max_exc_frac: float = 0.05,
) -> np.ndarray | None:
    """The reference's road renumbering: ``None`` (keep the input order)
    where the input order's turn-edge offsets already concentrate on
    ``max_buckets`` values with at most ``max_exc_frac`` exceptions; else
    the best of the tail-major orders ``lexsort(head rank, tail rank)``
    over the intersection ranks (row- and column-major coordinates,
    :func:`polar_rank`, :func:`hilbert_rank`, :func:`rcm_rank`) whose
    exceptions fit the budget and are below 0.9 of the input order's, as
    an int64 array ``order`` (``order[new index] = input road``); ``None``
    where none qualifies."""
    r = int(from_inter.shape[0])
    e_u, e_v = _turn_edge_pairs(from_inter, to_inter, num_intersections)
    floor = max(64, e_u.size // 512)
    budget = max(max_exc_frac * e_u.size,
                 min(roll_cost_budget(e_u.size, max_buckets),
                     e_u.size // 2))
    id_exc = _order_exceptions(np.arange(r, dtype=np.int64), e_u, e_v, r,
                               max_buckets, floor)
    if id_exc <= max_exc_frac * e_u.size:
        return None

    ranks: list[np.ndarray] = []
    if inter_x is not None and inter_y is not None:
        x = np.asarray(inter_x, np.float64)
        y = np.asarray(inter_y, np.float64)
        if np.ptp(x) > 0 or np.ptp(y) > 0:
            ranks += [_rank_of(np.lexsort((x, y))),
                      _rank_of(np.lexsort((y, x))),
                      polar_rank(x, y), hilbert_rank(x, y)]
    rcm = rcm_rank(from_inter, to_inter, num_intersections)
    if rcm is not None:
        ranks.append(rcm)

    best, best_exc = None, None
    for rank in ranks:
        order = np.lexsort(
            (np.arange(r), rank[to_inter], rank[from_inter])).astype(np.int64)
        pos = np.empty(r, np.int64)
        pos[order] = np.arange(r)
        exc = _order_exceptions(pos, e_u, e_v, r, max_buckets, floor)
        if exc <= budget and (best_exc is None or exc < best_exc):
            best, best_exc = order, exc
    if best is not None and best_exc > 0.9 * id_exc:
        best = None
    return best


def build_network(
    *,
    length: np.ndarray,
    max_flow: np.ndarray,
    free_speed: np.ndarray,
    perm_lanes: np.ndarray,
    from_inter: np.ndarray,
    to_inter: np.ndarray,
    num_intersections: int,
    physics: PhysicsConfig = DEFAULT_PHYSICS,
    inter_x: np.ndarray | None = None,
    inter_y: np.ndarray | None = None,
    device: torch.device | str | None = None,
) -> Network:
    """Construct a :class:`Network` from raw per-link attributes: cell
    capacity ``int(length*lanes/cell) + 1``, ``Nmax = max(capacity) + 1``,
    turn edges with capacity-share weights normalised per upstream link,
    weight-0 SRC->road and road->DEST edges, and the congestion constants.
    From 512 roads up the roads are numbered in the order
    :func:`roll_friendly_road_order` finds, if it finds one."""
    device = resolve_device(device)
    length = np.asarray(length, dtype=np.float64)
    max_flow = np.asarray(max_flow, dtype=np.float64)
    free_speed = np.asarray(free_speed, dtype=np.float64)
    perm_lanes = np.asarray(perm_lanes, dtype=np.float64)
    from_inter = np.asarray(from_inter, dtype=np.int64)
    to_inter = np.asarray(to_inter, dtype=np.int64)
    num_roads = int(length.shape[0])

    # The links as if parsed in the searched order; intersections, SRC and
    # DEST nodes and agents keep their indices.
    road_order = np.arange(num_roads, dtype=np.int64)
    perm = None
    if num_roads >= RENUMBER_MIN_ROADS:
        perm = roll_friendly_road_order(from_inter, to_inter,
                                        num_intersections, inter_x, inter_y)
    if perm is not None:
        road_order = perm
        length, max_flow = length[perm], max_flow[perm]
        free_speed, perm_lanes = free_speed[perm], perm_lanes[perm]
        from_inter, to_inter = from_inter[perm], to_inter[perm]
    renumbered = not np.array_equal(road_order, np.arange(num_roads))

    free_flow = length / free_speed
    capacity = (length * perm_lanes / physics.effective_cell_size).astype(
        np.int64) + 1
    nmax = int(capacity.max()) + 1

    outgoing: list[list[int]] = [[] for _ in range(num_intersections)]
    for i in range(num_roads):
        outgoing[from_inter[i]].append(i)
    # A renumbered build orders every slot structure by input position, so
    # that ascending-slot tie-breaks pick the same physical edge as the
    # identity build and in-slot (k, v) sits at stream position
    # ``k*R + road_order[v]``.
    if renumbered:
        for roads in outgoing:
            roads.sort(key=lambda r: road_order[r])

    e_src, e_dst, e_w = [], [], []
    for u in range(num_roads):
        downs = outgoing[to_inter[u]]
        total = sum(max_flow[u] for _ in downs)
        for v in downs:
            e_src.append(u)
            e_dst.append(v)
            e_w.append(max_flow[u] / total if total > 0 else 1.0)

    f_src, f_dst, f_w = list(e_src), list(e_dst), list(e_w)
    for k in range(num_intersections):
        src_idx = num_roads + 2 * k
        for road in outgoing[k]:
            f_src.append(src_idx)
            f_dst.append(road)
            f_w.append(0.0)
    road_dest = np.empty(num_roads, dtype=np.int64)
    for road in range(num_roads):
        dest_idx = num_roads + 2 * to_inter[road] + 1
        road_dest[road] = dest_idx
        f_src.append(road)
        f_dst.append(dest_idx)
        f_w.append(0.0)

    e_src_np = np.asarray(e_src, dtype=np.int32)
    e_dst_np = np.asarray(e_dst, dtype=np.int32)
    f_src_np = np.asarray(f_src, dtype=np.int32)
    f_dst_np = np.asarray(f_dst, dtype=np.int32)
    choice_mask = f_dst_np < num_roads
    num_nodes = num_roads + 2 * num_intersections

    degree = np.bincount(f_src_np, minlength=num_nodes)
    max_deg = max(int(degree.max()), 1)
    nbr = np.tile(np.arange(num_nodes, dtype=np.int32)[:, None], (1, max_deg))
    nbr_ok = np.zeros((num_nodes, max_deg), dtype=bool)
    slot = np.zeros(num_nodes, dtype=np.int64)
    for u, v in zip(f_src_np, f_dst_np):
        nbr[u, slot[u]] = v
        nbr_ok[u, slot[u]] = True
        slot[u] += 1

    max_out = max(1, max((len(o) for o in outgoing), default=1))
    inter_out = np.zeros((num_intersections, max_out), dtype=np.int32)
    inter_ok = np.zeros((num_intersections, max_out), dtype=bool)
    for k, roads in enumerate(outgoing):
        inter_out[k, :len(roads)] = roads
        inter_ok[k, :len(roads)] = True

    critical = max_flow * free_flow / physics.seconds_per_hour
    congestion_constant = free_flow * (
        capacity + physics.congestion_softening - critical
    )

    e_w_np = np.asarray(e_w, dtype=np.float32)
    # An in-slot column gathers edges across source roads: sort it by the
    # sources' input positions where renumbered (the other tables inherit
    # the order of ``outgoing``).
    in_tab, in_tab_ok = _edge_table(
        e_dst_np, num_roads,
        order_key=road_order[e_src_np] if renumbered else None)
    out_tab, out_tab_ok = _edge_table(e_src_np, num_roads)
    ch_tab, ch_tab_ok = _edge_table(f_src_np[choice_mask], num_nodes)
    in_src = np.where(in_tab_ok, e_src_np[in_tab], 0).astype(np.int32)
    with np.errstate(divide="ignore"):
        in_logit = np.where(
            in_tab_ok & (e_w_np[in_tab] > 0),
            np.log(np.maximum(e_w_np[in_tab], 1e-30)),
            -np.inf,
        ).astype(np.float32)
    out_dst = np.where(out_tab_ok, e_dst_np[out_tab], 0).astype(np.int32)
    ch_dst = np.where(
        ch_tab_ok, f_dst_np[choice_mask][ch_tab], 0
    ).astype(np.int32)

    def t(a, dtype):
        return torch.as_tensor(
            np.ascontiguousarray(np.asarray(a).astype(dtype)), device=device
        )

    f32, i32 = np.float32, np.int32
    return Network(
        num_roads=num_roads,
        num_intersections=num_intersections,
        nmax=nmax,
        capacity=t(capacity, f32),
        free_flow=t(free_flow, f32),
        length=t(length, f32),
        max_flow=t(max_flow, f32),
        critical_number=t(critical, f32),
        congestion_constant=t(congestion_constant, f32),
        road_dest=t(road_dest, i32),
        edge_src=t(e_src_np, i32),
        edge_dst=t(e_dst_np, i32),
        edge_attr=t(e_w, f32),
        full_src=t(f_src_np, i32),
        full_dst=t(f_dst_np, i32),
        full_attr=t(f_w, f32),
        choice_src=t(f_src_np[choice_mask], i32),
        choice_dst=t(f_dst_np[choice_mask], i32),
        in_edge_ok=t(in_tab_ok, bool),
        in_src_tab=t(in_src, i32),
        in_logit_tab=t(in_logit, f32),
        out_edge_ok=t(out_tab_ok, bool),
        out_dst_tab=t(out_dst, i32),
        choice_ok=t(ch_tab_ok, bool),
        choice_dst_tab=t(ch_dst, i32),
        nbr=t(nbr, i32),
        nbr_ok=t(nbr_ok, bool),
        road_to=t(to_inter, i32),
        inter_out_road=t(inter_out, i32),
        inter_out_ok=t(inter_ok, bool),
        inter_x=t(np.zeros(num_intersections) if inter_x is None else inter_x,
                  f32),
        inter_y=t(np.zeros(num_intersections) if inter_y is None else inter_y,
                  f32),
        road_order=t(road_order, i32),
        renumbered=renumbered,
    )


def default_selected_road(network: Network) -> torch.Tensor:
    """Initial SELECTED_ROAD per node: each node's first outgoing road, -1
    where it has none."""
    sel = np.full((network.num_nodes,), -1, dtype=np.int32)
    src = network.choice_src.cpu().numpy()
    dst = network.choice_dst.cpu().numpy()
    for s, d in zip(src[::-1], dst[::-1]):
        sel[s] = d
    return torch.as_tensor(sel, device=network.device)
