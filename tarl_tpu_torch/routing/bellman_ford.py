"""Shortest paths on the primal (intersection) graph by Bellman-Ford
relaxation (ports ``tarl_tpu/routing/bellman_ford.py``: ``BIG``, the road
and node cost functions, ``primal_all_pairs_dist``, ``primal_dest_dist``,
``primal_next_roads`` and ``primal_relax_next_roads``).

Every relaxation goes through :func:`primal_relax_next_roads`: Jacobi
min-plus sweeps over the out-slot table of each intersection, optionally
followed by the next-road argmin.  On a CUDA tensor it launches the
hand-written kernels of ``csrc/primal_relax.cu`` (nvcc into a shared
library with a C interface, loaded with ctypes) or raises; on a CPU tensor
it takes :func:`primal_relax_next_roads_plain`, the same function in plain
PyTorch.  It never falls back from the kernel to the plain version.

The relax takes one of three forms, chosen by shape, never as a fallback
(a launch that fails raises):

* the resident form, where :func:`resident_plan` gives a tile width (at
  most 4,096 intersections of at most 4 out-slots, at least two sweeps or
  uncapped: the sp row, the zoned parts, the table init): one launch;
  each block keeps a tile of 8 columns of every row in its shared memory,
  runs the sweeps on it and stops at the first sweep that lowers nothing
  in its tile;
* the cluster form, where :func:`cluster_plan` gives ``(tile width,
  blocks)`` (past 4,096 and up to 65,536 intersections, the same slots
  and sweeps: the million-agent row's refreshes and table init, the TPU's
  row-blocked K3 and K5): one launch; a thread-block cluster of 2-16
  blocks holds a tile of at most 7 columns of every row across its blocks'
  shared memory, each block 4,096 rows or fewer, and a successor's value
  is read from the block that owns its row (distributed shared memory),
  whatever the intersection order.  The tile is narrowed so that its
  clusters fill the card's last wave (:func:`launch_cluster_plan`; the
  card's capacity is asked once per shape, and a cluster it cannot
  schedule raises);
* the global form elsewhere (a single sweep, more slots than 4, more
  than 65,536 intersections: the radial metro's zoned tables, the TPU's
  K6): one cooperative launch of as many blocks as the card holds at once
  (asked once per card, :func:`_global_fit`; a card that holds none
  raises), which compacts each row's slots (:func:`compact_slots` is the
  rule's plain twin), sweeps through two tables in device memory with a
  grid barrier between sweeps and an early-exit flag read on the device,
  and writes the next roads in the same launch.

Min-plus relaxation is idempotent at its fixpoint, so the early exit of
every form gives tables equal bit for bit to those of every capped sweep,
and the uncapped relax (``max_iters=None``, at most ``I - 1`` sweeps)
makes no host read (the plain version reads its convergence test every
sweep, counted by :mod:`~tarl_tpu_torch.core.sync`).  Each form's calls
are counted apart (:data:`RESIDENT_LAUNCHES`, :data:`CLUSTER_LAUNCHES`,
:data:`GLOBAL_LAUNCHES`; :data:`LAUNCHES` counts every call), one launch
each.

Left out: ``primal_delta_buckets``, ``epilogue_slot_tables``,
``_epilogue_rep_tables``, the row windows, the VMEM plans and every
``TARL_*`` environment gate.  They choose between bitwise-identical
evaluations of the same relaxation on the TPU (rotations against row
gathers, tile widths, row blocks); the GPU kernels gather directly.

:func:`all_pairs_next_hop_nbr` is the dual-graph all-pairs relaxation over
the padded neighbour table, plain PyTorch (the reference has no kernel for
it): it gives the dual routing backend's next-hop table, the learned
policy's distance prior, the progress reward's potential, the Nash gap and
MSA's shortest paths.  :func:`all_pairs_next_hop` is the same relaxation
over the full edge list with optional per-edge costs (``strict_compat``'s
table, with :func:`reference_edge_costs`), its own tie rule kept.  Both
read their convergence flag every :data:`CHECK_EVERY` sweeps (where the
reference reads none: its loop runs on the device) and add the sweeps they
ran to :data:`DUAL_SWEEPS`.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .._build import check_tensor, current_stream
from ..config import DEFAULT_PHYSICS, PhysicsConfig
from ..core.sync import host_read
from ..network import Network
from ..ops.segment import segment_min
from ..state import RoadState

# The reference's jnp.float32(1e18): exactly representable in float32.
BIG = float(np.float32(1e18))

# Kernel launches: relax calls through primal_relax_next_roads (and of
# those, the calls each form ran: one launch of the resident, the cluster
# or the global kernel), and the next-road kernel through
# primal_next_roads.  The plain version does not count.
LAUNCHES = 0
RESIDENT_LAUNCHES = 0
CLUSTER_LAUNCHES = 0
GLOBAL_LAUNCHES = 0
NEXT_ROAD_LAUNCHES = 0

# Sweeps between host reads of the convergence flag of the dual all-pairs
# relaxations; sweeps past the fixpoint change nothing.
CHECK_EVERY = 8
# Sweeps run by the dual all-pairs relaxations (whole batches of
# CHECK_EVERY, the last one cut at the cap).
DUAL_SWEEPS = 0

# The resident kernel's limits (csrc/primal_relax.cu): MAX_TILE_COLS
# destination columns a block, at most RESIDENT_ROWS rows of at most
# RESIDENT_SLOTS slots (its slot tables stay in registers), and at least
# RESIDENT_MIN_SWEEPS sweeps (one sweep costs the global form one pass).
MAX_TILE_COLS = 8
RESIDENT_ROWS = 4096
RESIDENT_SLOTS = 4
RESIDENT_MIN_SWEEPS = 2
# The cluster kernel's limits: a cluster of at most CLUSTER_MAX_BLOCKS
# blocks (a power of two), each holding RESIDENT_ROWS rows of a tile of at
# most CLUSTER_TILE_COLS columns (two such tiles, the distances and the
# staged next roads, fill a block's shared memory at RESIDENT_ROWS rows).
CLUSTER_MAX_BLOCKS = 16
CLUSTER_TILE_COLS = 7
# The global kernel's grid-barrier state: 4-byte words, zero before a
# stream's first launch and left so by every launch (csrc kSyncWords).
GLOBAL_SYNC_WORDS = 96

_FNS = None
# Clusters the card can hold at once, by (device, I, K, B): asked once per
# shape (cudaOccupancyMaxActiveClusters).
_CLUSTER_FIT: dict = {}
# Blocks of the global kernel the card holds at once, by device index, and
# its barrier state, by (device index, stream): launches on one stream run
# in order, launches on two streams each have their own.
_GLOBAL_FIT: dict = {}
_GLOBAL_SYNC: dict = {}


def reset_launches() -> None:
    global LAUNCHES, RESIDENT_LAUNCHES, CLUSTER_LAUNCHES, GLOBAL_LAUNCHES
    global NEXT_ROAD_LAUNCHES, DUAL_SWEEPS
    LAUNCHES = 0
    RESIDENT_LAUNCHES = 0
    CLUSTER_LAUNCHES = 0
    GLOBAL_LAUNCHES = 0
    NEXT_ROAD_LAUNCHES = 0
    DUAL_SWEEPS = 0


# --- dual all-pairs relaxation ----------------------------------------------

def all_pairs_next_hop_nbr(
    nbr: torch.Tensor,         # int32[N, D] padded out-neighbour table
    nbr_ok: torch.Tensor,      # bool[N, D]
    entry_cost: torch.Tensor,  # float32[N]
    max_iters: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(dist[N, N], next_hop[N, N])`` over all ordered node pairs by
    Jacobi min-plus sweeps over the neighbour table: ``dist[v, d]`` is the
    cheapest v -> d cost (the sum of the entry costs of every node after
    v), ``next_hop[v, d]`` its first node (the lowest slot among ties),
    ``v`` itself on the diagonal and -1 where d is unreachable.

    At most ``max_iters`` sweeps (``N - 1`` when None), stopping once a
    sweep changes nothing; the flag is read on the host every
    :data:`CHECK_EVERY` sweeps, and the sweeps past the fixpoint change
    nothing, so the tables equal the reference's bit for bit."""
    n, d = nbr.shape
    nbr_l = nbr.long()
    w = torch.where(nbr_ok, entry_cost[nbr_l], BIG)

    def sweep(dist):
        new = dist
        for slot in range(d):
            new = torch.minimum(new, w[:, slot][:, None]
                                + dist[nbr_l[:, slot]])
        return new

    dist = _relax_batched(sweep, n, max_iters, nbr.device)
    cand = w[:, :, None] + dist[nbr_l]                    # [N, D, N]
    hop = nbr.gather(1, torch.argmin(cand, dim=1))       # first slot on ties
    return dist, _finish_next_hop(dist, hop)


def _relax_batched(sweep, n: int, max_iters: int | None, dev):
    """Jacobi sweeps from the all-pairs cold start (0 on the diagonal, BIG
    elsewhere) in batches of :data:`CHECK_EVERY`, reading after each batch
    whether its last sweep lowered anything; at most ``max_iters`` (``n -
    1`` when None)."""
    global DUAL_SWEEPS
    iters = (n - 1) if max_iters is None else max_iters
    dist = torch.full((n, n), BIG, dtype=torch.float32, device=dev)
    dist.fill_diagonal_(0.0)
    done = 0
    while done < iters:
        n_sweeps = min(CHECK_EVERY, iters - done)
        for k in range(n_sweeps):
            new = sweep(dist)
            if k == n_sweeps - 1:
                changed = torch.any(new < dist)
            dist = new
        done += n_sweeps
        DUAL_SWEEPS += n_sweeps
        if not host_read(changed)[0]:
            break
    return dist


def _finish_next_hop(dist, hop):
    """``hop`` where the pair is reachable and off the diagonal, -1 where
    unreachable, the node itself on the diagonal.  int32[N, N]."""
    n = dist.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=dist.device)
    next_hop = torch.where((dist < BIG) & ~eye, hop, -1)
    iota = torch.arange(n, dtype=torch.int32, device=dist.device)[:, None]
    return torch.where(eye, iota, next_hop).to(torch.int32)


def all_pairs_next_hop(
    edge_src: torch.Tensor,    # int32[E]
    edge_dst: torch.Tensor,    # int32[E]
    entry_cost: torch.Tensor,  # float32[N]
    num_nodes: int,
    max_iters: int | None = None,
    edge_cost: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(dist[N, N], next_hop[N, N])`` by Jacobi sweeps over the edge
    list: ``cand[e, d] = w[e] + dist[edge_dst[e], d]`` min-reduced over each
    node's out-edges, with ``w`` the entry cost of each edge's head or
    ``edge_cost`` (float32[E]) where given.  Stops and reads as
    :func:`all_pairs_next_hop_nbr` does.

    The next hop keeps the reference's tie rule, which is not the
    neighbour form's: among the out-edges whose candidate lies within
    ``1e-6`` of the minimum (``cand <= best + 1e-6`` in float32), the
    lowest edge id; ``v`` itself on the diagonal and -1 where d is
    unreachable (or v has no out-edge).  Min is exact, so the segment
    reductions are bitwise on every device."""
    n = num_nodes
    e_n = edge_src.shape[0]
    dst = edge_dst.long()
    w = edge_cost if edge_cost is not None else entry_cost[dst]

    def sweep(dist):
        cand = w[:, None] + dist[dst]
        return torch.minimum(dist, segment_min(cand, edge_src, n))

    dist = _relax_batched(sweep, n, max_iters, edge_src.device)
    cand = w[:, None] + dist[dst]                          # [E, N]
    best = segment_min(cand, edge_src, n)                  # [N, N]
    e_ids = torch.arange(e_n, dtype=torch.int32, device=edge_src.device)
    is_best = cand <= best[edge_src.long()] + 1e-6
    arg_e = segment_min(torch.where(is_best, e_ids[:, None], e_n),
                        edge_src, n)
    hop = torch.where(arg_e < e_n,
                      edge_dst[torch.clamp(arg_e, max=e_n - 1).long()], -1)
    return dist, _finish_next_hop(dist, hop)


# --- costs -------------------------------------------------------------------

def road_costs(road: RoadState, network: Network,
               physics: PhysicsConfig = DEFAULT_PHYSICS) -> torch.Tensor:
    """Congested traversal cost per road: ``max(fftt, cc / (cap + 10 -
    n))``.  float32[R]."""
    count_f = road.count.to(torch.float32)
    tc = network.congestion_constant / (
        network.capacity + physics.congestion_softening - count_f)
    return torch.maximum(network.free_flow, tc)


def node_entry_costs(road: RoadState, network: Network,
                     physics: PhysicsConfig = DEFAULT_PHYSICS
                     ) -> torch.Tensor:
    """Congested cost of entering each dual node (0 for SRC/DEST nodes).
    float32[N]."""
    out = torch.zeros(network.num_nodes, dtype=torch.float32,
                      device=road.count.device)
    out[:network.num_roads] = road_costs(road, network, physics)
    return out


def marginal_road_costs(road: RoadState, network: Network,
                        physics: PhysicsConfig = DEFAULT_PHYSICS
                        ) -> torch.Tensor:
    """Marginal social cost per road, ``tt(n) + n * dtt/dn``: the extra
    term ``n * cc / (cap + 10 - n)^2`` where the congestion branch of ``tt``
    is active, else 0.  float32[R]."""
    count_f = road.count.to(torch.float32)
    denom = network.capacity + physics.congestion_softening - count_f
    tt_c = network.congestion_constant / denom
    tt = torch.maximum(network.free_flow, tt_c)
    ext = torch.where(tt_c > network.free_flow,
                      count_f * network.congestion_constant / (denom * denom),
                      0.0)
    return tt + ext


def reference_edge_costs(road: RoadState, network: Network,
                         physics: PhysicsConfig = DEFAULT_PHYSICS
                         ) -> torch.Tensor:
    """``strict_compat``'s per-edge costs over the full edge list: the
    reference simulator's ``w(u -> v) = max(fftt[u], cc[v] / (cap[u] + 10
    - n[u]))``, the source's free-flow time, occupancy and capacity with
    the target's congestion constant; SRC/DEST nodes carry zeros.
    float32[Ef]."""
    n, r = network.num_nodes, network.num_roads
    dev = road.count.device

    def pad(x):
        out = torch.zeros(n, dtype=torch.float32, device=dev)
        out[:r] = x
        return out

    fftt, cap = pad(network.free_flow), pad(network.capacity)
    cc = pad(network.congestion_constant)
    cnt = pad(road.count.to(torch.float32))
    u, v = network.full_src.long(), network.full_dst.long()
    tc = cc[v] / (cap[u] + physics.congestion_softening - cnt[u])
    return torch.maximum(fftt[u], tc)


def marginal_node_costs(road: RoadState, network: Network,
                        physics: PhysicsConfig = DEFAULT_PHYSICS
                        ) -> torch.Tensor:
    """Marginal social cost of entering each dual node (0 for SRC/DEST
    nodes).  float32[N]."""
    out = torch.zeros(network.num_nodes, dtype=torch.float32,
                      device=road.count.device)
    out[:network.num_roads] = marginal_road_costs(road, network, physics)
    return out


# --- the plain version -------------------------------------------------------

def _slot_tables(road_cost, inter_out_road, inter_out_ok, road_to):
    """``(w[I, K], succ[I, K])``: each out-slot's road cost (BIG on padding)
    and the intersection its road leads to."""
    out = inter_out_road.long()
    w = torch.where(inter_out_ok, road_cost[out], BIG)
    return w, road_to[out].long()


def _sweep_plain(dist, w, succ):
    """One Jacobi sweep: a slot loop of full-row gathers."""
    new = dist
    for k in range(succ.shape[1]):
        new = torch.minimum(new, w[:, k, None] + dist[succ[:, k]])
    return new


def _next_roads_plain(dist, w, succ, inter_out_road):
    best = torch.full_like(dist, BIG)
    road = torch.full_like(dist, -1.0)
    for k in range(succ.shape[1]):
        cand = w[:, k, None] + dist[succ[:, k]]
        take = cand < best
        best = torch.where(take, cand, best)
        road = torch.where(
            take, inter_out_road[:, k].to(torch.float32)[:, None], road)
    return torch.where(best < BIG, road, -1.0)


def compact_slots(inter_out_road: torch.Tensor,
                  inter_out_ok: torch.Tensor) -> torch.Tensor:
    """bool[I, K]: the slots the global kernel's prologue keeps, in their
    order (the rule's plain twin): every slot but a padding slot whose road
    repeats an earlier padding slot of its row.  Such a slot's candidate is
    the earlier one's bit for bit (weight BIG, the same successor and
    road), so it can lower no minimum and win no strict <: the relax over
    the kept slots is the padded loop's, for any table."""
    pad = ~inter_out_ok
    k_n = inter_out_road.shape[1]
    earlier = torch.ones(k_n, k_n, dtype=torch.bool,
                         device=pad.device).tril(-1)          # [k, j]: j < k
    same = inter_out_road[:, :, None] == inter_out_road[:, None, :]
    repeat = (same & pad[:, None, :] & earlier).any(dim=2) & pad
    return ~repeat


def primal_relax_next_roads_plain(
    road_cost: torch.Tensor,
    inter_out_road: torch.Tensor,
    inter_out_ok: torch.Tensor,
    road_to: torch.Tensor,
    dist0: torch.Tensor,
    max_iters: int | None,
    relax_only: bool = False,
):
    """The plain PyTorch version of :func:`primal_relax_next_roads`: the
    reference's gather sweep and ``primal_next_roads``."""
    i_n = inter_out_road.shape[0]
    iters = i_n - 1 if max_iters is None else int(max_iters)
    w, succ = _slot_tables(road_cost, inter_out_road, inter_out_ok, road_to)
    dist = dist0
    for _ in range(iters):
        new = _sweep_plain(dist, w, succ)
        if max_iters is None and not host_read(torch.any(new < dist))[0]:
            break
        dist = new
    if relax_only:
        return dist, None
    return dist, _next_roads_plain(dist, w, succ, inter_out_road)


# --- the kernel --------------------------------------------------------------

def resident_plan(i_n: int, d_n: int, k_n: int,
                  max_iters: int | None) -> int | None:
    """The resident kernel's tile width for ``max_iters`` sweeps (None:
    uncapped) of an ``[i_n, d_n]`` table with ``k_n`` out-slots a row:
    :data:`MAX_TILE_COLS` (``d_n`` where that is fewer) where the kernel
    takes the shape, ``None`` where the global form runs.  The last tile of
    a ``d_n`` that is not a multiple of the width is narrower (the kernel
    masks it)."""
    if (i_n > RESIDENT_ROWS or k_n > RESIDENT_SLOTS
            or (max_iters is not None and max_iters < RESIDENT_MIN_SWEEPS)):
        return None
    return max(1, min(MAX_TILE_COLS, d_n))


def cluster_plan(i_n: int, d_n: int, k_n: int, max_iters: int | None,
                 clusters: int | None = None) -> tuple[int, int] | None:
    """The cluster kernel's ``(tile width, blocks a cluster)`` for
    ``max_iters`` sweeps (None: uncapped) of an ``[i_n, d_n]`` table with
    ``k_n`` out-slots a row, where :func:`resident_plan` declines only
    because ``i_n`` passes :data:`RESIDENT_ROWS`: the smallest power of two
    ``B`` with ``i_n / B <= RESIDENT_ROWS``, up to
    :data:`CLUSTER_MAX_BLOCKS` (65,536 rows).  ``None`` where the shape is
    the resident form's or the global form's (one sweep, more slots than
    registers keep, more rows than 16 blocks hold).

    The width is :data:`CLUSTER_TILE_COLS` (``d_n`` where that is
    fewer); given ``clusters``, the clusters the card holds at once, it is
    narrowed so that the tiles fill their last wave: a tile's time grows
    with its width, and a wave takes as long as its slowest cluster."""
    if (i_n <= RESIDENT_ROWS or i_n > RESIDENT_ROWS * CLUSTER_MAX_BLOCKS
            or k_n > RESIDENT_SLOTS
            or (max_iters is not None and max_iters < RESIDENT_MIN_SWEEPS)):
        return None
    blocks = 2
    while i_n > RESIDENT_ROWS * blocks:
        blocks *= 2
    cols = max(1, min(CLUSTER_TILE_COLS, d_n))
    if clusters:
        waves = -(-(-(-d_n // cols)) // clusters)
        cols = max(1, -(-d_n // (waves * clusters)))
    return cols, blocks


def _kernel_fns():
    global _FNS
    if _FNS is None:
        from .._build import load_library

        lib = load_library("primal_relax")
        p, i = ctypes.c_void_p, ctypes.c_int
        global_form = lib.tarl_primal_global
        global_form.argtypes = [p] * 10 + [i] * 5 + [p]
        global_form.restype = ctypes.c_int
        global_fit = lib.tarl_primal_global_fit
        global_fit.argtypes = [i, p]
        global_fit.restype = ctypes.c_int
        next_road = lib.tarl_primal_next_road
        next_road.argtypes = [p] * 5 + [i] * 3 + [p, p]
        next_road.restype = ctypes.c_int
        resident = lib.tarl_primal_resident
        resident.argtypes = [p] * 7 + [i] * 5 + [p]
        resident.restype = ctypes.c_int
        cluster = lib.tarl_primal_cluster
        cluster.argtypes = [p] * 7 + [i] * 6 + [p]
        cluster.restype = ctypes.c_int
        cluster_fit = lib.tarl_primal_cluster_fit
        cluster_fit.argtypes = [i] * 4 + [p]
        cluster_fit.restype = ctypes.c_int
        _FNS = (global_form, next_road, resident, cluster, cluster_fit,
                global_fit)
    return _FNS


def _check_inputs(road_cost, inter_out_road, inter_out_ok, road_to, dist):
    """Raise unless the inputs are what the kernels take: one device,
    float32 costs and distances, int32 ids, a bool mask, contiguous."""
    dev = dist.device
    i_n, k_n = inter_out_road.shape
    r = road_to.shape[0]
    if dist.dim() != 2 or dist.shape[0] != i_n:
        raise ValueError(f"dist has shape {tuple(dist.shape)}, expected "
                         f"({i_n}, D)")
    for name, t, dtype, shape in (
            ("road_cost", road_cost, torch.float32, (r,)),
            ("inter_out_road", inter_out_road, torch.int32, (i_n, k_n)),
            ("inter_out_ok", inter_out_ok, torch.bool, (i_n, k_n)),
            ("road_to", road_to, torch.int32, (r,)),
            ("dist", dist, torch.float32, tuple(dist.shape))):
        check_tensor(name, t, dtype, shape, dev)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")


def _launch_next_road(dist, road_cost, inter_out_road, inter_out_ok,
                      road_to):
    i_n, k_n = inter_out_road.shape
    road = torch.empty_like(dist)
    next_road = _kernel_fns()[1]
    err = next_road(dist.data_ptr(), road_cost.data_ptr(),
                    inter_out_road.data_ptr(), inter_out_ok.data_ptr(),
                    road_to.data_ptr(), i_n, dist.shape[1], k_n,
                    road.data_ptr(), current_stream(dist.device))
    if err != 0:
        raise RuntimeError(f"primal_relax next-road launch failed: CUDA "
                           f"error {err}")
    return road


def _launch_tiled(form: str, road_cost, inter_out_road, inter_out_ok,
                  road_to, dist0, relax_only, *shape):
    """One launch of the ``"resident"`` or ``"cluster"`` kernel: ``shape``
    is its ints after ``I, D, K``."""
    i_n, k_n = inter_out_road.shape
    dist = torch.empty_like(dist0)
    road = None if relax_only else torch.empty_like(dist0)
    err = _kernel_fns()[{"resident": 2, "cluster": 3}[form]](
        dist0.data_ptr(), dist.data_ptr(),
        None if road is None else road.data_ptr(), road_cost.data_ptr(),
        inter_out_road.data_ptr(), inter_out_ok.data_ptr(),
        road_to.data_ptr(), i_n, dist0.shape[1], k_n, *shape,
        current_stream(dist0.device))
    if err != 0:
        raise RuntimeError(f"primal_relax {form} launch failed: CUDA error "
                           f"{err}")
    return dist, road


def _cluster_fit(device, i_n: int, k_n: int, blocks: int) -> int:
    """Clusters of ``blocks`` blocks of ``i_n`` rows the card holds at once
    (at the widest tile: a narrower one needs less shared memory), asked
    the first time the shape launches; raises where the card cannot
    schedule one."""
    key = (device.index, i_n, k_n, blocks)
    if key not in _CLUSTER_FIT:
        n = ctypes.c_int(0)
        err = _kernel_fns()[4](i_n, k_n, CLUSTER_TILE_COLS, blocks,
                               ctypes.addressof(n))
        if err != 0:
            raise RuntimeError(f"primal_relax cluster occupancy query "
                               f"failed: CUDA error {err}")
        if n.value < 1:
            raise RuntimeError(
                f"the card cannot schedule a cluster of {blocks} blocks of "
                f"the relax kernel (I={i_n})")
        _CLUSTER_FIT[key] = n.value
    return _CLUSTER_FIT[key]


def launch_cluster_plan(device, i_n: int, d_n: int, k_n: int,
                        max_iters: int | None) -> tuple[int, int] | None:
    """:func:`cluster_plan` told the card's capacity: the plan the wrapper
    launches on ``device`` (raises where the card cannot schedule such a
    cluster)."""
    plan = cluster_plan(i_n, d_n, k_n, max_iters)
    if plan is None:
        return None
    return cluster_plan(i_n, d_n, k_n, max_iters,
                        _cluster_fit(device, i_n, k_n, plan[1]))


def _global_fit(device) -> int:
    """Blocks of the global kernel the card holds at once (its resources
    do not depend on the shape), asked the first time the card launches
    it; raises where the card cannot schedule one."""
    if device.index not in _GLOBAL_FIT:
        n = ctypes.c_int(0)
        err = _kernel_fns()[5](device.index, ctypes.addressof(n))
        if err != 0:
            raise RuntimeError(f"primal_relax global occupancy query failed: "
                               f"CUDA error {err}")
        if n.value < 1:
            raise RuntimeError("the card cannot schedule a block of the "
                               "global relax kernel")
        _GLOBAL_FIT[device.index] = n.value
    return _GLOBAL_FIT[device.index]


def _launch_global(road_cost, inter_out_road, inter_out_ok, road_to, dist0,
                   relax_only, iters):
    """One launch of the global kernel: ``iters`` sweeps at most, with
    its scratch table, its slot lists and the stream's barrier state."""
    i_n, k_n = inter_out_road.shape
    d_n = dist0.shape[1]
    dev = dist0.device
    stream = current_stream(dev)
    if (dev.index, stream) not in _GLOBAL_SYNC:
        _GLOBAL_SYNC[dev.index, stream] = torch.zeros(
            GLOBAL_SYNC_WORDS, dtype=torch.int32, device=dev)
    dist = torch.empty_like(dist0)
    road = None if relax_only else torch.empty_like(dist0)
    # One table of rows padded to 4 columns beside dist where its rows
    # take float4, else two.
    scratch = torch.empty((1 if d_n % 4 == 0 else 2) * i_n * -(-d_n // 4)
                          * 4, dtype=torch.float32, device=dev)
    work = torch.empty(i_n * (3 * k_n + 1), dtype=torch.int32, device=dev)
    err = _kernel_fns()[0](
        dist0.data_ptr(), dist.data_ptr(),
        None if road is None else road.data_ptr(), scratch.data_ptr(),
        work.data_ptr(), _GLOBAL_SYNC[dev.index, stream].data_ptr(),
        road_cost.data_ptr(), inter_out_road.data_ptr(),
        inter_out_ok.data_ptr(), road_to.data_ptr(), i_n, d_n, k_n, iters,
        _global_fit(dev), stream)
    if err != 0:
        raise RuntimeError(f"primal_relax global launch failed: CUDA error "
                           f"{err}")
    return dist, road


def _launch_relax(road_cost, inter_out_road, inter_out_ok, road_to, dist0,
                  max_iters, relax_only):
    """The relax in the form its shape takes: the resident kernel where
    :func:`resident_plan` gives a width, else the cluster kernel where
    :func:`cluster_plan` gives one, else the global form; each form's calls
    counted apart."""
    global RESIDENT_LAUNCHES, CLUSTER_LAUNCHES, GLOBAL_LAUNCHES
    i_n, k_n = inter_out_road.shape
    d_n = dist0.shape[1]
    iters = i_n - 1 if max_iters is None else int(max_iters)
    args = (road_cost, inter_out_road, inter_out_ok, road_to, dist0,
            relax_only)
    cols = resident_plan(i_n, d_n, k_n, max_iters)
    if cols is not None:
        out = _launch_tiled("resident", *args, cols, iters)
        RESIDENT_LAUNCHES += 1
        return out
    plan = launch_cluster_plan(dist0.device, i_n, d_n, k_n, max_iters)
    if plan is not None:
        out = _launch_tiled("cluster", *args, *plan, iters)
        CLUSTER_LAUNCHES += 1
        return out
    out = _launch_global(*args, iters)
    GLOBAL_LAUNCHES += 1
    return out


def primal_relax_next_roads(
    road_cost: torch.Tensor,       # float32[R]
    inter_out_road: torch.Tensor,  # int32[I, K]
    inter_out_ok: torch.Tensor,    # bool[I, K]
    road_to: torch.Tensor,         # int32[R]
    dist0: torch.Tensor,           # float32[I, D] — already anchored
    max_iters: int | None,
    relax_only: bool = False,
):
    """``(relaxed dist[I, D], next_road[I, D])`` (``next_road`` None with
    ``relax_only``).

    ``max_iters`` sweeps (``None``: until converged, at most ``I - 1``) of
    ``new[i, d] = min(dist[i, d], min_k w[i, k] + dist[succ[i, k], d])``
    from ``dist0``, then ``next_road[i, d]``, the out-road of the first slot
    attaining the minimum of ``w + dist[succ]`` (float32 id, -1.0 where that
    minimum is not below BIG).  ``dist0`` must carry its anchor zeros.  The
    CUDA kernels for CUDA tensors (one call counted, one launch: the
    resident form where :func:`resident_plan` takes the shape, the cluster
    form where :func:`cluster_plan` does, else the global form), the plain
    version for CPU tensors; inputs the kernels would not take raise on
    either device."""
    global LAUNCHES
    _check_inputs(road_cost, inter_out_road, inter_out_ok, road_to, dist0)
    if dist0.device.type == "cuda":
        out = _launch_relax(road_cost, inter_out_road, inter_out_ok,
                            road_to, dist0, max_iters, relax_only)
        LAUNCHES += 1
        return out
    return primal_relax_next_roads_plain(
        road_cost, inter_out_road, inter_out_ok, road_to, dist0, max_iters,
        relax_only)


def primal_next_roads(
    dist: torch.Tensor,            # float32[I, D]
    road_cost: torch.Tensor,       # float32[R]
    inter_out_road: torch.Tensor,  # int32[I, K]
    inter_out_ok: torch.Tensor,    # bool[I, K]
    road_to: torch.Tensor,         # int32[R]
) -> torch.Tensor:
    """The best outgoing road per (intersection, destination column) of a
    finished table: float32[I, D], -1.0 where unreachable.  The next-road
    kernel for CUDA tensors, the plain version for CPU tensors."""
    global NEXT_ROAD_LAUNCHES
    _check_inputs(road_cost, inter_out_road, inter_out_ok, road_to, dist)
    if dist.device.type == "cuda":
        road = _launch_next_road(dist, road_cost, inter_out_road,
                                 inter_out_ok, road_to)
        NEXT_ROAD_LAUNCHES += 1
        return road
    w, succ = _slot_tables(road_cost, inter_out_road, inter_out_ok, road_to)
    return _next_roads_plain(dist, w, succ, inter_out_road)


def primal_all_pairs_dist(
    road_cost: torch.Tensor,
    inter_out_road: torch.Tensor,
    inter_out_ok: torch.Tensor,
    road_to: torch.Tensor,
    max_iters: int | None = None,
    dist0: torch.Tensor | None = None,
) -> torch.Tensor:
    """All-pairs intersection distances, float32[I, I]: the relax from
    ``dist0`` (any upper bound; default 0 on the diagonal and BIG
    elsewhere) with its diagonal set to 0."""
    i_n = inter_out_road.shape[0]
    eye = torch.eye(i_n, dtype=torch.bool, device=road_cost.device)
    dist0 = torch.where(eye, 0.0, BIG if dist0 is None else dist0)
    return primal_relax_next_roads(road_cost, inter_out_road, inter_out_ok,
                                   road_to, dist0, max_iters,
                                   relax_only=True)[0]


def primal_dest_dist(
    road_cost: torch.Tensor,
    inter_out_road: torch.Tensor,
    inter_out_ok: torch.Tensor,
    road_to: torch.Tensor,
    dest_list: torch.Tensor,       # int32[D] destination intersections
    max_iters: int | None = None,
    dist0: torch.Tensor | None = None,
) -> torch.Tensor:
    """Destination-restricted distances, float32[I, D]: column j holds the
    distances to ``dest_list[j]``; same relaxation and warm start as
    :func:`primal_all_pairs_dist`."""
    i_n = inter_out_road.shape[0]
    anchor = (torch.arange(i_n, device=road_cost.device)[:, None]
              == dest_list.long()[None, :])
    dist0 = torch.where(anchor, 0.0, BIG if dist0 is None else dist0)
    return primal_relax_next_roads(road_cost, inter_out_road, inter_out_ok,
                                   road_to, dist0, max_iters,
                                   relax_only=True)[0]
