"""The fused edge-phase core (ports ``tarl_tpu/core/fused_core.py``:
``gumbel_argmax_payload``, its Pallas kernel ``_argmax_payload_kernel``,
and ``fused_core_step``).

The direction winner and the confirm pop collapse into one per-downstream
Gumbel-max over the turn-edge list: the eligibility, the gridlock escape and
the logits are exact float32 elementwise ops over the edges, then a
Gumbel-max picks one eligible edge per downstream road and returns the head
agent and the source road of its upstream.  The source pops its head, the
agent is pushed at the downstream tail.

Two entries reach the hand-written kernel of ``csrc/fused_core.cu`` (nvcc
into a shared library with a C interface, loaded with ctypes), which draws
its noise inside:

* :func:`fused_core_sample`, the edge phase of a tick in one launch: it
  takes the road state, the selections, the clock and the key, and
  computes the eligibility and the logits in the kernel.
  :func:`fused_core_step` calls it once per tick;
* :func:`gumbel_argmax_payload`, with logits and payloads in: the TPU
  kernel's own function, the same kernel body with the eligibility pass
  switched off.

On a CPU tensor each takes its plain PyTorch version
(:func:`fused_core_sample_plain`, :func:`gumbel_argmax_payload_plain`).
Neither falls back from the kernel to the plain version.

Differences from the reference, by design:

* the noise of edge e is ``random_bits(key, (E,))[e]`` (threefry) through
  the reference kernel's transform (:func:`~tarl_tpu_torch.core.rng.
  payload_gumbel`); the TPU's hardware bits cannot be reproduced, so the
  port samples the same law from another stream.  ``bits=`` of the plain
  versions overrides the bits: zeros reproduce the reference's interpret
  mode, which stubs its generator to zeros;
* payloads are int32 (the reference carries them as float32, exact below
  2**24), and a segment without an eligible edge gives ``b =
  num_segments``, the reference's documented value (its kernel writes the
  padded width); ``fused_core_step`` clamps ``b`` to R either way.
"""
from __future__ import annotations

import ctypes
from typing import Callable

import torch

from .._build import check_tensor, current_stream
from ..config import DEFAULT_PHYSICS, PhysicsConfig
from ..network import Network
from ..ops.segment import (NEG_LARGE, SegmentLayout, segment_argmax_plain,
                           segment_layout)
from ..state import RoadState
from . import rng
from .direction import push_winners, road_delta
from .response import pop_heads, popped_mask

# Kernel launches through :func:`fused_core_sample` (LAUNCHES) and
# :func:`gumbel_argmax_payload` (PAYLOAD_LAUNCHES), one per call on a CUDA
# tensor; the plain versions do not count.
LAUNCHES = 0
PAYLOAD_LAUNCHES = 0

_FN = None
_SAMPLE_FN = None


def reset_launches() -> None:
    global LAUNCHES, PAYLOAD_LAUNCHES
    LAUNCHES = PAYLOAD_LAUNCHES = 0


def _check_inputs(logits, segment_ids, payload_a, payload_b, layout):
    e = logits.shape[0] if logits.dim() == 1 else -1
    dev = logits.device
    check_tensor("logits", logits, torch.float32, (e,), dev)
    check_tensor("segment_ids", segment_ids, segment_ids.dtype, (e,), dev)
    check_tensor("payload_a", payload_a, torch.int32, (e,), dev)
    check_tensor("payload_b", payload_b, torch.int32, (e,), dev)
    if layout is not None and layout.ids is not segment_ids:
        raise ValueError("gumbel_argmax_payload: the layout was built from "
                         "another id tensor")


def gumbel_argmax_payload_plain(
    logits: torch.Tensor,
    segment_ids: torch.Tensor,
    payload_a: torch.Tensor,
    payload_b: torch.Tensor,
    key: rng.Key,
    num_segments: int,
    layout: SegmentLayout | None = None,
    bits: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of :func:`gumbel_argmax_payload`.
    ``bits`` (int64[E] holding uint32 values) replaces the noise bits
    ``random_bits(key, (E,))``; the layout is not needed."""
    e, dev = logits.shape[0], logits.device
    if e == 0:
        zeros = torch.zeros(num_segments, dtype=torch.int32, device=dev)
        return zeros, torch.full_like(zeros, num_segments)
    if bits is None:
        bits = rng.random_bits(key, (e,), dev)
    ok = torch.isfinite(logits) & (logits > NEG_LARGE)
    # A finite logit plus the bounded noise stays finite, so the argmax's
    # own rule (finite scores above NEG_LARGE) is the kernel's.
    score = torch.where(ok, logits + rng.payload_gumbel(bits), NEG_LARGE)
    arg = segment_argmax_plain(score, segment_ids, num_segments).long()
    has = arg < e
    pick = torch.clamp(arg, max=e - 1)
    return (torch.where(has, payload_a[pick], 0).to(torch.int32),
            torch.where(has, payload_b[pick], num_segments).to(torch.int32))


def _kernel_fn():
    global _FN
    if _FN is None:
        from .._build import load_library

        fn = load_library("fused_core").tarl_gumbel_argmax_payload
        p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
        fn.argtypes = [p] * 5 + [i, i, u, u, p, p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def gumbel_argmax_payload(
    logits: torch.Tensor,
    segment_ids: torch.Tensor,
    payload_a: torch.Tensor,
    payload_b: torch.Tensor,
    key: rng.Key,
    num_segments: int,
    layout: SegmentLayout | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sample one element per segment with probability ``softmax(logits)``
    (Gumbel-max, noise from ``key``) and return its two payloads: ``(a
    int32[S], b int32[S])``, with ``a = 0`` and ``b = num_segments`` for a
    segment without a finite logit.  The kernel (K12) for CUDA tensors, the
    plain version for CPU tensors; ``layout`` is the CSR of
    ``segment_ids`` (built here when not given)."""
    global PAYLOAD_LAUNCHES
    _check_inputs(logits, segment_ids, payload_a, payload_b, layout)
    k1, k2 = rng.key_words(key)
    dev = logits.device
    if dev.type == "cpu":
        return gumbel_argmax_payload_plain(logits, segment_ids, payload_a,
                                           payload_b, key, num_segments)
    if dev.type != "cuda":
        raise ValueError(f"gumbel_argmax_payload: unsupported device {dev}")
    if layout is None:
        layout = segment_layout(segment_ids, num_segments)
    if layout.num_segments != num_segments:
        raise ValueError(f"gumbel_argmax_payload: layout has "
                         f"{layout.num_segments} segments, expected "
                         f"{num_segments}")
    # The layout's offsets and order were checked where it was built, on
    # the device of segment_ids, which _check_inputs held to the logits'.
    # The lanes per segment follow the mean run; longer runs are walked.
    out = torch.empty((2, num_segments), dtype=torch.int32, device=dev)
    width = -(-logits.shape[0] // max(num_segments, 1))
    err = _kernel_fn()(
        logits.data_ptr(), payload_a.data_ptr(), payload_b.data_ptr(),
        *layout.pointers, num_segments, width, k1, k2, out.data_ptr(),
        current_stream(dev))
    if err != 0:
        raise RuntimeError(f"fused_core kernel launch failed: CUDA error "
                           f"{err}")
    PAYLOAD_LAUNCHES += 1
    return out[0], out[1]


# --- the edge phase in one launch -------------------------------------------

def edge_logits(road: RoadState, selected_road: torch.Tensor,
                network: Network, time: float,
                physics: PhysicsConfig = DEFAULT_PHYSICS) -> torch.Tensor:
    """float32 ``[E]``: the reference's exact float32 eligibility over the
    turn edges (``dep_ok``, ``space_ok``, ``wants_v``, ``nonempty``, the
    gridlock escape with its guards) and the logits of the eligible
    edges' weights, ``-inf`` elsewhere."""
    r = road.num_roads
    u = network.edge_src.long()
    v = network.edge_dst.long()
    head_departure = road.head_departure()
    count_f = road.count.to(torch.float32)
    cap = network.capacity
    buf = physics.congestion_buffer

    hd_u = head_departure[u]
    cnt_u, cap_u = count_f[u], cap[u]
    cnt_v, cap_v = count_f[v], cap[v]
    wants_v = selected_road[:r][u] == v
    nonempty = road.count[u] > 0
    mask = (hd_u <= time) & (cnt_v < cap_v - buf) & wants_v & nonempty
    stuck = (hd_u - time) < -physics.gridlock_patience
    u_full = cap_u - buf <= cnt_u
    v_freer = cap_u - cnt_u <= cap_v - cnt_v
    v_has_slot = cnt_v < cap_v
    mask = mask | (stuck & u_full & v_freer & wants_v & nonempty & v_has_slot)
    prob = network.edge_attr * mask.to(torch.float32)
    return torch.where(prob > 0, torch.log(torch.clamp(prob, min=1e-30)),
                       float("-inf"))


def fused_core_sample_plain(
    road: RoadState,
    selected_road: torch.Tensor,
    network: Network,
    time: float,
    key: rng.Key,
    physics: PhysicsConfig = DEFAULT_PHYSICS,
    bits: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of :func:`fused_core_sample`:
    :func:`edge_logits`, then :func:`gumbel_argmax_payload_plain` with the
    upstreams' head agents and the upstreams as payloads.  ``bits``
    replaces the noise bits as there."""
    logits = edge_logits(road, selected_road, network, time, physics)
    return gumbel_argmax_payload_plain(
        logits, network.edge_dst, road.head_ids()[network.edge_src.long()],
        network.edge_src, key, road.num_roads, bits=bits)


def _sample_fn():
    global _SAMPLE_FN
    if _SAMPLE_FN is None:
        from .._build import load_library

        fn = load_library("fused_core").tarl_fused_core_sample
        p, f, i, u = (ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                      ctypes.c_uint32)
        fn.argtypes = [p] * 10 + [f, f, f, i, i, i, u, u, p, p]
        fn.restype = ctypes.c_int
        _SAMPLE_FN = fn
    return _SAMPLE_FN


def fused_core_sample(
    road: RoadState,
    selected_road: torch.Tensor,
    network: Network,
    time: float,
    key: rng.Key,
    physics: PhysicsConfig = DEFAULT_PHYSICS,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The edge phase of one tick: for each road, the Gumbel-max over its
    eligible incoming turn edges (noise from ``key``), as ``(agent
    int32[R], src int32[R])``: the winning upstream's head agent and the
    upstream, ``(0, R)`` where no edge is eligible.  One kernel launch for
    CUDA tensors, which computes the eligibility and the logits itself;
    the plain version for CPU tensors.  ``time`` is a host float; ``key``
    two words in ``[0, 2**32)``.  Inputs the kernel would not take raise
    on either device."""
    global LAUNCHES
    tables = network.core_tables
    dev = network.device
    r, nmax = network.num_roads, road.nmax
    i32 = torch.int32
    for name, t, dtype, shape in (
            ("fifo_ids", road.fifo_ids, i32, (r, nmax)),
            ("fifo_departure", road.fifo_departure, torch.float32,
             (r, nmax)),
            ("head", road.head, i32, (r,)),
            ("count", road.count, i32, (r,)),
            ("selected_road", selected_road, i32, (network.num_nodes,))):
        check_tensor(name, t, dtype, shape, dev)
    k1, k2 = rng.key_words(key)
    if dev.type == "cpu":
        return fused_core_sample_plain(road, selected_road, network, time,
                                       key, physics)
    if dev.type != "cuda":
        raise ValueError(f"fused_core_sample: unsupported device {dev}")
    out = torch.empty((2, r), dtype=i32, device=dev)
    err = _sample_fn()(
        road.fifo_ids.data_ptr(), road.fifo_departure.data_ptr(),
        road.head.data_ptr(), road.count.data_ptr(),
        selected_road.data_ptr(), *tables, float(time),
        physics.gridlock_patience, physics.congestion_buffer, r, nmax,
        network.in_src_tab.shape[0], k1, k2, out.data_ptr(),
        current_stream(dev))
    if err != 0:
        raise RuntimeError(f"fused_core_sample kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES += 1
    return out[0], out[1]


def fused_core_step(
    road: RoadState,
    selected_road: torch.Tensor,
    network: Network,
    time: float,
    key: rng.Key,
    physics: PhysicsConfig = DEFAULT_PHYSICS,
    compute_delta: bool = False,
    payload: Callable = fused_core_sample,
) -> tuple[RoadState, torch.Tensor, torch.Tensor]:
    """The direction winner and the confirm pop of one tick as one sampler
    over the turn edges.  Returns ``(road, popped, road_delta_tt)``;
    ``road_delta_tt`` is the per-source congestion delay of the
    pre-transfer heads when ``compute_delta``, else empty.  ``payload``
    replaces :func:`fused_core_sample` (same signature), e.g. with its
    plain version to run that on the card."""
    r = road.num_roads
    agent, src = payload(road, selected_road, network, time, key, physics)
    accept = agent != 0                     # sentinel guard
    win_src = torch.clamp(src, max=r)
    dest = torch.where(accept,
                       road.head_dests()[torch.clamp(win_src, max=r - 1)], 0)
    delta = (road_delta(road, network) if compute_delta
             else torch.zeros((0,), dtype=torch.float32,
                              device=road.count.device))
    popped = popped_mask(accept, win_src)
    road = push_winners(road, network, time, accept, agent, dest, physics)
    return pop_heads(road, popped), popped, delta
