"""Direction winner + confirm as one kernel call (ports
``tarl_tpu/core/fused_winner.py``: ``direction_confirm_fused`` and its
Pallas kernel ``_kernel``).

:func:`direction_confirm` returns, per road, ``(accept, win_src, agent,
dest, popped)``: whether the road received a transfer, the winning upstream
(R for none), the transferred agent and its DEST node, and whether the road
popped its head because it won downstream.  On a CUDA tensor it launches
the hand-written kernel of ``csrc/fused_winner.cu`` (route: nvcc into a
shared library with a C interface, loaded with ctypes) or raises; on a CPU
tensor it takes :func:`direction_confirm_plain`, the same function in
plain PyTorch.  It never falls back from the kernel to the plain version.

The TPU kernel's roll plan and exception overlay have no counterpart: on
the GPU the in-slot and out-slot reads are direct gathers.  The Gumbel
matrix is drawn outside, as the TPU kernel takes it, and the tail push and
head pop stay in PyTorch (:func:`apply_transfers`).
"""
from __future__ import annotations

import ctypes

import torch

from .._build import check_tensor
from ..config import DEFAULT_PHYSICS, PhysicsConfig
from ..network import Network
from ..state import RoadState
from .direction import free_space_mask, push_winners, road_delta, winners
from .response import pop_heads, popped_mask

# Kernel launches through :func:`direction_confirm` (one per call); the
# plain version does not count.
LAUNCHES = 0

_FN = None


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def direction_confirm_plain(
    road: RoadState,
    selected_road: torch.Tensor,
    network: Network,
    time: float,
    gumbel: torch.Tensor,
    physics: PhysicsConfig = DEFAULT_PHYSICS,
):
    """The plain PyTorch version: ``direction_step``'s winner logic plus
    ``confirm_step``'s pop mask."""
    accept, win_src, agent, dest = winners(
        road, selected_road, network, time, gumbel, physics)
    return accept, win_src, agent, dest, popped_mask(accept, win_src)


def _kernel_fn():
    global _FN
    if _FN is None:
        from .._build import load_library

        fn = load_library("fused_winner").tarl_fused_winner
        p, f, i = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
        fn.argtypes = [p] * 13 + [f, p] + [f] * 3 + [i] * 4 + [p] * 6
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _checked_inputs(road, selected_road, network, gumbel):
    """The kernel's inputs in argument order, after checking that each lies
    on the road state's device with the dtype, shape and layout the kernel
    takes."""
    dev = road.count.device
    r, nmax = road.num_roads, road.nmax
    kin, kout = network.in_src_tab.shape[0], network.out_dst_tab.shape[0]
    i32, f32, b = torch.int32, torch.float32, torch.bool
    inputs = [
        ("fifo_ids", road.fifo_ids, i32, (r, nmax)),
        ("fifo_departure", road.fifo_departure, f32, (r, nmax)),
        ("fifo_dest", road.fifo_dest, i32, (r, nmax)),
        ("head", road.head, i32, (r,)),
        ("count", road.count, i32, (r,)),
        ("selected_road", selected_road, i32, (network.num_nodes,)),
        ("capacity", network.capacity, f32, (r,)),
        ("in_src_tab", network.in_src_tab, i32, (kin, r)),
        ("in_logit_tab", network.in_logit_tab, f32, (kin, r)),
        ("in_edge_ok", network.in_edge_ok, b, (kin, r)),
        ("out_dst_tab", network.out_dst_tab, i32, (kout, r)),
        ("out_edge_ok", network.out_edge_ok, b, (kout, r)),
        ("gumbel", gumbel, f32, (kin, r)),
    ]
    for name, t, dtype, shape in inputs:
        check_tensor(name, t, dtype, shape, dev)
    return [t for _, t, _, _ in inputs]


def _launch(road, inputs, network, time, physics):
    global LAUNCHES
    dev = road.count.device
    r, nmax = road.num_roads, road.nmax
    kin, kout = network.in_src_tab.shape[0], network.out_dst_tab.shape[0]
    i32, b = torch.int32, torch.bool
    accept = torch.empty(r, dtype=b, device=dev)
    win_src = torch.empty(r, dtype=i32, device=dev)
    agent = torch.empty(r, dtype=i32, device=dev)
    dest = torch.empty(r, dtype=i32, device=dev)
    popped = torch.empty(r, dtype=b, device=dev)
    fn = _kernel_fn()
    if isinstance(time, torch.Tensor):
        check_tensor("time", time, torch.float32, (), dev)
        time_host, time_dev = 0.0, time.data_ptr()
    else:
        time_host, time_dev = float(time), None
    err = fn(
        *(t.data_ptr() for t in inputs),
        time_host, time_dev, float(physics.gridlock_patience),
        float(physics.congestion_buffer), float(free_space_mask(r, nmax)),
        r, nmax, kin, kout,
        accept.data_ptr(), win_src.data_ptr(), agent.data_ptr(),
        dest.data_ptr(), popped.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_winner kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    return accept, win_src, agent, dest, popped


def direction_confirm(
    road: RoadState,
    selected_road: torch.Tensor,
    network: Network,
    time: float,
    gumbel: torch.Tensor,
    physics: PhysicsConfig = DEFAULT_PHYSICS,
):
    """``(accept, win_src, agent, dest, popped)`` for one tick: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors.  Inputs the
    kernel would not take raise on either device.  ``time`` is a host
    float or a float32 0-d tensor on the road state's device (the RL
    environment's clock, read by the kernel on the device)."""
    inputs = _checked_inputs(road, selected_road, network, gumbel)
    if road.count.device.type == "cuda":
        return _launch(road, inputs, network, time, physics)
    if road.count.device.type != "cpu":
        raise ValueError(f"direction_confirm: unsupported device "
                         f"{road.count.device}")
    return direction_confirm_plain(road, selected_road, network, time, gumbel,
                                   physics)


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
