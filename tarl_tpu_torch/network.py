"""Static road-network representation, the dual graph (ports
``tarl_tpu/network.py``: ``Network``, ``build_network`` and
``default_selected_road``).

Nodes are roads, then one SRC/DEST node pair per intersection (SRC of
intersection k is ``R + 2k``, DEST ``R + 2k + 1``); edges are allowed turns.
The build is the reference's, array for array, on numpy; the result lives
on one torch device.

Not ported, because on a GPU they carry no semantics: the roll plans
(``in_roll_*`` / ``out_roll_*``), which evaluated the in-slot gather as
rotations on the TPU, and the roll-friendly renumbering search that served
them.  The port keeps the identity road order (``road_order = arange(R)``,
``renumbered = False``), which is what the reference builds for every grid.
The primal routing tables (``road_to``, ``inter_out_road``,
``inter_out_ok``) and the dual neighbour table (``nbr``, ``nbr_ok``, read
by the all-pairs relaxation of the learned policy's distance prior) are
built as the reference builds them.
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

    # Road index -> input (XML link-list) position; identity in the port.
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


def _edge_table(by: np.ndarray, n_rows: int):
    """K-major padded table of edge ids grouped by ``by`` (slot order =
    increasing edge id)."""
    groups: list[list[int]] = [[] for _ in range(n_rows)]
    for e, g in enumerate(by):
        groups[int(g)].append(e)
    kmax = max(1, max((len(g) for g in groups), default=1))
    tab = np.zeros((kmax, n_rows), dtype=np.int32)
    ok = np.zeros((kmax, n_rows), dtype=bool)
    for g, es in enumerate(groups):
        for s, e in enumerate(es):
            tab[s, g] = e
            ok[s, g] = True
    return tab, ok


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
    weight-0 SRC->road and road->DEST edges, and the congestion constants."""
    device = resolve_device(device)
    length = np.asarray(length, dtype=np.float64)
    max_flow = np.asarray(max_flow, dtype=np.float64)
    free_speed = np.asarray(free_speed, dtype=np.float64)
    perm_lanes = np.asarray(perm_lanes, dtype=np.float64)
    from_inter = np.asarray(from_inter, dtype=np.int64)
    to_inter = np.asarray(to_inter, dtype=np.int64)
    num_roads = int(length.shape[0])

    free_flow = length / free_speed
    capacity = (length * perm_lanes / physics.effective_cell_size).astype(
        np.int64) + 1
    nmax = int(capacity.max()) + 1

    outgoing: list[list[int]] = [[] for _ in range(num_intersections)]
    for i in range(num_roads):
        outgoing[from_inter[i]].append(i)

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
    in_tab, in_tab_ok = _edge_table(e_dst_np, num_roads)
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
        road_order=t(np.arange(num_roads), i32),
        renumbered=False,
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
