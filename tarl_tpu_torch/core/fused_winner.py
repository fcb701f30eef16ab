"""Direction winner + confirm as one kernel call (ports
``tarl_tpu/core/fused_winner.py``: ``direction_confirm_fused`` and its
Pallas kernel ``_kernel``; ``fused_shard_winner`` and its kernel
``_shard_winner_kernel``).

:func:`direction_confirm` returns, per road, ``(accept, win_src, agent,
dest, popped)``: whether the road received a transfer, the winning upstream
(R for none), the transferred agent and its DEST node, and whether the road
popped its head because it won downstream.  It takes the tick's direction
key, as the reference's ``direction_confirm_fused`` does, and the noise of
in-slot ``k`` of road ``v`` is ``rng.direction_gumbel(key, network)[k,
v]``.  On a CUDA tensor it launches the hand-written kernel of
``csrc/fused_winner.cu`` (route: nvcc into a shared library with a C
interface, loaded with ctypes), which draws that noise itself, in one
launch after a memset, or raises; on a CPU tensor it takes
:func:`direction_confirm_plain`, the same function in plain PyTorch.  It
never falls back from the kernel to the plain version.

The TPU kernel's roll plan and exception overlay have no counterpart: on
the GPU the in-slot reads are direct gathers, and the confirm is the
winners' scatter onto their upstreams (each upstream proposes to one road,
so it wins at most once).  The tail push and head pop stay in PyTorch
(:func:`apply_transfers`).

:func:`fused_shard_winner` is the winner alone on the road blocks of a
road-sharded tick (:mod:`tarl_tpu_torch.parallel.shard_map_episode`): it
reads each in-slot's upstream packed word, head id and head dest from the
replicated halo vectors, which the TPU kernel took pre-read through the
roll plan, and takes the tick's direction key where the TPU kernel took
the block's ``[KIN, rl]`` Gumbel columns: in-slot ``k`` of global column
``c`` draws at ``k*R + road_order[c]``, the address :func:`direction_confirm`
draws at, so the sharded tick draws the serial tick's noise.  Its
per-episode tables are a :class:`ShardTables`, checked where it is built.
Same rule: the kernel on a CUDA tensor, its plain version
:func:`fused_shard_winner_plain` on a CPU tensor.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from .._build import check_tensor, current_stream
from ..config import DEFAULT_PHYSICS, PhysicsConfig
from ..network import Network
from ..state import RoadState
from . import rng
from .direction import free_space_mask, push_winners, road_delta, winners
from .response import pop_heads, popped_mask

# Kernel launches through :func:`direction_confirm` (K1) and
# :func:`fused_shard_winner` (K7), one per call; the plain versions do not
# count.
LAUNCHES = 0
SHARD_LAUNCHES = 0

_FN = None
_SHARD_FN = None


def reset_launches() -> None:
    global LAUNCHES, SHARD_LAUNCHES
    LAUNCHES = 0
    SHARD_LAUNCHES = 0


def direction_confirm_plain(
    road: RoadState,
    selected_road: torch.Tensor,
    network: Network,
    time: float,
    key: rng.Key,
    physics: PhysicsConfig = DEFAULT_PHYSICS,
):
    """The plain PyTorch version: ``direction_step``'s winner logic plus
    ``confirm_step``'s pop mask, on ``rng.direction_gumbel(key,
    network)``'s matrix, drawn at the positions the kernel draws."""
    gumbel = rng.gumbel_at_positions(key, rng.direction_positions(network))
    accept, win_src, agent, dest = winners(
        road, selected_road, network, time, gumbel, physics)
    return accept, win_src, agent, dest, popped_mask(accept, win_src)


def _kernel_fn():
    global _FN
    if _FN is None:
        from .._build import load_library

        fn = load_library("fused_winner").tarl_fused_winner
        p, f, i, u = (ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                      ctypes.c_uint32)
        fn.argtypes = [p] * 11 + [u, u, f, p, f, f, f, i, i, i, p, p, p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _checked_call(road, selected_road, network, time, key):
    """Check what changes from tick to tick (the road fields, the
    selection, the clock and the key) against the network, whose own
    tables :attr:`Network.winner_tables` checked once.  Returns the
    network's table addresses and the key's words."""
    tables = network.winner_tables
    dev = network.device
    r, nmax = network.num_roads, road.nmax
    i32 = torch.int32
    for name, t, dtype, shape in (
            ("fifo_ids", road.fifo_ids, i32, (r, nmax)),
            ("fifo_departure", road.fifo_departure, torch.float32,
             (r, nmax)),
            ("fifo_dest", road.fifo_dest, i32, (r, nmax)),
            ("head", road.head, i32, (r,)),
            ("count", road.count, i32, (r,)),
            ("selected_road", selected_road, i32, (network.num_nodes,))):
        check_tensor(name, t, dtype, shape, dev)
    if isinstance(time, torch.Tensor):
        check_tensor("time", time, torch.float32, (), dev)
    return tables, rng.key_words(key)


def direction_confirm(
    road: RoadState,
    selected_road: torch.Tensor,
    network: Network,
    time: float,
    key: rng.Key,
    physics: PhysicsConfig = DEFAULT_PHYSICS,
):
    """``(accept, win_src, agent, dest, popped)`` for one tick: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors.  Inputs the
    kernel would not take raise on either device.  ``time`` is a host
    float or a float32 0-d tensor on the road state's device (the RL
    environment's clock, read by the kernel on the device); ``key`` is
    the tick's direction key, two words in ``[0, 2**32)``."""
    global LAUNCHES
    tables, (k1, k2) = _checked_call(road, selected_road, network, time, key)
    dev = network.device
    if dev.type == "cpu":
        return direction_confirm_plain(road, selected_road, network, time,
                                       key, physics)
    if dev.type != "cuda":
        raise ValueError(f"direction_confirm: unsupported device {dev}")
    r, nmax = network.num_roads, road.nmax
    ints = torch.empty((3, r), dtype=torch.int32, device=dev)
    flags = torch.empty((2, r), dtype=torch.bool, device=dev)
    if isinstance(time, torch.Tensor):
        time_host, time_dev = 0.0, time.data_ptr()
    else:
        time_host, time_dev = float(time), None
    err = _kernel_fn()(
        road.fifo_ids.data_ptr(), road.fifo_departure.data_ptr(),
        road.fifo_dest.data_ptr(), road.head.data_ptr(),
        road.count.data_ptr(), selected_road.data_ptr(), *tables, k1, k2,
        time_host, time_dev, physics.gridlock_patience,
        physics.congestion_buffer, free_space_mask(r, nmax), r, nmax,
        network.in_src_tab.shape[0], ints.data_ptr(), flags.data_ptr(),
        current_stream(dev))
    if err != 0:
        raise RuntimeError(f"fused_winner kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    win_src, agent, dest = ints.unbind(0)
    accept, popped = flags.unbind(0)
    return accept, win_src, agent, dest, popped


def apply_transfers(
    road: RoadState,
    network: Network,
    time: float,
    accept: torch.Tensor,
    agent: torch.Tensor,
    dest: torch.Tensor,
    popped: torch.Tensor,
    physics: PhysicsConfig = DEFAULT_PHYSICS,
    compute_delta: bool = True,
) -> tuple[RoadState, torch.Tensor]:
    """Push the winners at their tails, pop the confirmed heads, and the
    congestion-delay row of the pre-transfer heads.  Returns ``(road,
    road_delta_tt)``."""
    delta = (road_delta(road, network) if compute_delta
             else torch.zeros((0,), dtype=torch.float32,
                              device=road.count.device))
    road = push_winners(road, network, time, accept, agent, dest, physics)
    return pop_heads(road, popped), delta


# --- the road-block winner (K7) ---------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class ShardTables:
    """K7's tables for a device's ``n`` local roads, fixed for an episode:
    the ``[KIN, n]`` in-slot columns (``in_src`` int32, ``in_logit``
    float32, ``in_ok`` bool), the local roads' float32 ``capacity``, and
    the network's ``road_order`` (int32 ``[R]``, over the real roads).
    Built only as the kernel takes them: contiguous, on one device (raises
    otherwise); ``pointers`` keeps their addresses for the launches."""

    in_src: torch.Tensor
    in_logit: torch.Tensor
    in_ok: torch.Tensor
    capacity: torch.Tensor
    road_order: torch.Tensor
    pointers: tuple[int, ...] = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        if self.in_src.dim() != 2:
            raise ValueError(f"in_src has rank {self.in_src.dim()}, "
                             "expected 2")
        kin, n = self.in_src.shape
        dev = self.in_src.device
        tables = [
            ("in_logit", self.in_logit, torch.float32, (kin, n)),
            ("in_src", self.in_src, torch.int32, (kin, n)),
            ("in_ok", self.in_ok, torch.bool, (kin, n)),
            ("capacity", self.capacity, torch.float32, (n,)),
        ]
        for name, t, dtype, shape in tables:
            check_tensor(name, t, dtype, shape, dev)
        ro = self.road_order
        check_tensor("road_order", ro, torch.int32,
                     (ro.shape[0] if ro.dim() == 1 else -1,), dev)
        object.__setattr__(self, "pointers", tuple(
            t.data_ptr() for _, t, _, _ in tables) + (ro.data_ptr(),))

    @property
    def num_roads(self) -> int:
        """R, the network's real roads."""
        return self.road_order.shape[0]


def shard_slot_mask(pack, tables: ShardTables, count_f, col0: int,
                    physics: PhysicsConfig, layout) -> torch.Tensor:
    """bool ``[KIN, n]``: in-slot ``k`` of local road ``v`` may send its
    upstream's head into ``v`` this tick (K7's decode of the packed word and
    its eligibility, gridlock escape included).  Padded columns (global
    column ``R`` and on) have no slot."""
    shift_free, shift_sel, free_mask = layout
    buf = float(physics.congestion_buffer)
    n = count_f.shape[0]
    cap = tables.capacity
    col = col0 + torch.arange(n, dtype=torch.int32, device=count_f.device)
    space_ok = count_f < cap - buf
    v_free = cap - count_f
    v_slot_ok = count_f < cap
    p = pack[tables.in_src.long()]
    dep_ok = (p & 1) > 0
    nonempty = (p & 2) > 0
    stuck = (p & 4) > 0
    u_free = ((p >> shift_free) & free_mask).to(torch.float32)
    wants_v = (p >> shift_sel) == col
    mask = dep_ok & space_ok & wants_v & nonempty
    mask = mask | (stuck & (u_free <= buf) & (u_free <= v_free) & wants_v
                   & nonempty & v_slot_ok)
    return mask & tables.in_ok & (col < tables.num_roads)


def shard_slot_positions(tables: ShardTables, col0: int) -> torch.Tensor:
    """int64 ``[KIN, n]``: the canonical stream position ``k * R +
    road_order[c]`` of in-slot ``k`` of global column ``c = col0 + v``
    (:func:`~tarl_tpu_torch.core.rng.direction_positions`' columns; a
    padded column takes its last real road's, and has no slot)."""
    kin, n = tables.in_src.shape
    r = tables.num_roads
    dev = tables.in_src.device
    col = torch.clamp(col0 + torch.arange(n, device=dev), max=r - 1)
    return (torch.arange(kin, dtype=torch.int64, device=dev)[:, None] * r
            + tables.road_order.to(torch.int64)[col][None, :])


def fused_shard_winner_plain(pack, head_id, head_dest, key: rng.Key,
                             tables: ShardTables, count_f, col0: int,
                             r_sentinel: int, physics: PhysicsConfig,
                             layout):
    """The plain PyTorch version of :func:`fused_shard_winner`: the local
    columns of the direction noise drawn from ``key``, then the reference
    shard tick's winner loop in its non-roll form
    (``parallel/shard_map_episode.py:1234-1284``) and the sentinel guard
    that follows it."""
    n = count_f.shape[0]
    dev = count_f.device
    src, logit = tables.in_src, tables.in_logit
    mask = shard_slot_mask(pack, tables, count_f, col0, physics, layout)
    gumbel = rng.gumbel_at_positions(key, shard_slot_positions(tables, col0))
    neg_inf = torch.tensor(float("-inf"), device=dev)
    best = torch.full((n,), float("-inf"), dtype=torch.float32, device=dev)
    win_slot = torch.zeros((n,), dtype=torch.int64, device=dev)
    accept = torch.zeros((n,), dtype=torch.bool, device=dev)
    for k in range(src.shape[0]):
        s_k = torch.where(mask[k], logit[k] + gumbel[k], neg_inf)
        take = s_k > best
        best = torch.where(take, s_k, best)
        win_slot = torch.where(take, k, win_slot)
        accept = accept | take
    win = torch.where(accept, src.gather(0, win_slot[None, :])[0], r_sentinel)
    safe = torch.clamp(win, max=r_sentinel - 1).long()
    agent = torch.where(accept, head_id[safe], 0)
    accept = agent != 0          # sentinel guard
    win = torch.where(accept, win, r_sentinel).to(torch.int32)
    dest = torch.where(accept, head_dest[safe], 0)
    return accept, win, agent, dest


def _shard_kernel_fn():
    global _SHARD_FN
    if _SHARD_FN is None:
        from .._build import load_library

        fn = load_library("fused_winner").tarl_fused_shard_winner
        p, f, i, u = (ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                      ctypes.c_uint32)
        fn.argtypes = [p] * 9 + [u, u] + [i] * 6 + [f, i, i, p, p, p]
        fn.restype = ctypes.c_int
        _SHARD_FN = fn
    return _SHARD_FN


def fused_shard_winner(pack, head_id, head_dest, key: rng.Key,
                       tables: ShardTables, count_f, col0: int,
                       r_sentinel: int, physics: PhysicsConfig, layout):
    """The winner of each road of a device's road blocks: ``(accept bool,
    win int32 (r_sentinel = none), agent int32, dest int32)``, each ``[n]``.

    ``pack``, ``head_id`` and ``head_dest`` are the replicated halo vectors
    over all ``r_sentinel`` (padded) roads: the upstream packed words of
    :func:`~tarl_tpu_torch.core.direction.pack_upstream` and the head ids
    and dests.  ``key`` is the tick's direction key, two words in ``[0,
    2**32)``; ``tables`` the device's :class:`ShardTables`; ``count_f``
    the local roads' float32 counts.  Local road ``v`` is global road
    ``col0 + v``.  ``layout`` is :func:`~tarl_tpu_torch.core.direction.
    upstream_pack_layout`'s.  The CUDA kernel for CUDA tensors (one launch
    for every local block, its noise drawn inside), the plain version for
    CPU tensors; inputs the kernel would not take raise on either
    device."""
    dev = tables.in_src.device
    kin, n = tables.in_src.shape
    i32 = torch.int32
    for name, t, dtype, shape in (
            ("pack", pack, i32, (r_sentinel,)),
            ("head_id", head_id, i32, (r_sentinel,)),
            ("head_dest", head_dest, i32, (r_sentinel,)),
            ("count_f", count_f, torch.float32, (n,))):
        check_tensor(name, t, dtype, shape, dev)
    k1, k2 = rng.key_words(key)
    if not 0 <= col0 <= r_sentinel - n:
        raise ValueError(f"columns {col0}..{col0 + n} lie outside the "
                         f"{r_sentinel} roads")
    if not 0 < tables.num_roads <= r_sentinel:
        raise ValueError(f"road_order holds {tables.num_roads} roads, "
                         f"expected 1..{r_sentinel}")
    if dev.type == "cpu":
        return fused_shard_winner_plain(pack, head_id, head_dest, key,
                                        tables, count_f, col0, r_sentinel,
                                        physics, layout)
    if dev.type != "cuda":
        raise ValueError(f"fused_shard_winner: unsupported device {dev}")
    global SHARD_LAUNCHES
    shift_free, shift_sel, free_mask = layout
    accept = torch.empty(n, dtype=torch.bool, device=dev)
    ints = torch.empty((3, n), dtype=i32, device=dev)
    logit_p, src_p, ok_p, cap_p, order_p = tables.pointers
    err = _shard_kernel_fn()(
        pack.data_ptr(), head_id.data_ptr(), head_dest.data_ptr(), logit_p,
        src_p, ok_p, count_f.data_ptr(), cap_p, order_p, k1, k2, col0,
        tables.num_roads, r_sentinel, shift_free, shift_sel, free_mask,
        float(physics.congestion_buffer), n, kin, accept.data_ptr(),
        ints.data_ptr(), current_stream(dev))
    if err != 0:
        raise RuntimeError(f"fused_shard_winner kernel launch failed: CUDA "
                           f"error {err}")
    SHARD_LAUNCHES += 1
    win, agent, dest = ints.unbind(0)
    return accept, win, agent, dest
