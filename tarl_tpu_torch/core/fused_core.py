"""The fused edge-phase core (ports ``tarl_tpu/core/fused_core.py``:
``gumbel_argmax_payload``, its Pallas kernel ``_argmax_payload_kernel``,
and ``fused_core_step``).

The direction winner and the confirm pop collapse into one per-downstream
Gumbel-max over the turn-edge list: the eligibility, the gridlock escape and
the logits are exact float32 elementwise ops over the edges, then
:func:`gumbel_argmax_payload` picks one eligible edge per downstream road
and returns the head agent and the source road of its upstream.  The
source pops its head, the agent is pushed at the downstream tail.

On a CUDA tensor :func:`gumbel_argmax_payload` launches the hand-written
kernel of ``csrc/fused_core.cu`` (nvcc into a shared library with a C
interface, loaded with ctypes), which draws its noise inside; on a CPU
tensor it takes :func:`gumbel_argmax_payload_plain`, the same function in
plain PyTorch.  It never falls back from the kernel to the plain version.

Differences from the reference, by design:

* the noise of edge e is ``random_bits(key, (E,))[e]`` (threefry) through
  the reference kernel's transform (:func:`~tarl_tpu_torch.core.rng.
  payload_gumbel`); the TPU's hardware bits cannot be reproduced, so the
  port samples the same law from another stream.  ``bits=`` of the plain
  version overrides the bits: zeros reproduce the reference's interpret
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

# Kernel launches through :func:`gumbel_argmax_payload` (one per call on a
# CUDA tensor); the plain version does not count.
LAUNCHES = 0

_FN = None


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


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
        fn.argtypes = [p] * 5 + [i, u, u, p, p, p]
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
    global LAUNCHES
    _check_inputs(logits, segment_ids, payload_a, payload_b, layout)
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
    out_a = torch.empty(num_segments, dtype=torch.int32, device=dev)
    out_b = torch.empty(num_segments, dtype=torch.int32, device=dev)
    err = _kernel_fn()(
        logits.data_ptr(), payload_a.data_ptr(), payload_b.data_ptr(),
        *layout.pointers, num_segments, key[0], key[1], out_a.data_ptr(),
        out_b.data_ptr(), current_stream(dev))
    if err != 0:
        raise RuntimeError(f"fused_core kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    return out_a, out_b


def fused_core_step(
    road: RoadState,
    selected_road: torch.Tensor,
    network: Network,
    time: float,
    key: rng.Key,
    physics: PhysicsConfig = DEFAULT_PHYSICS,
    compute_delta: bool = False,
    payload: Callable = gumbel_argmax_payload,
) -> tuple[RoadState, torch.Tensor, torch.Tensor]:
    """The direction winner and the confirm pop of one tick as one sampler
    over the turn edges.  Returns ``(road, popped, road_delta_tt)``;
    ``road_delta_tt`` is the per-source congestion delay of the
    pre-transfer heads when ``compute_delta``, else empty.  ``payload``
    replaces :func:`gumbel_argmax_payload` (same signature), e.g. with its
    plain version to run that on the card."""
    r = road.num_roads
    u = network.edge_src.long()
    v = network.edge_dst.long()
    head_departure = road.head_departure()
    count_f = road.count.to(torch.float32)
    cap = network.capacity
    buf = physics.congestion_buffer

    # The reference's exact float32 eligibility over the edge list.
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
    logits = torch.where(prob > 0, torch.log(torch.clamp(prob, min=1e-30)),
                         float("-inf"))

    agent, src = payload(logits, network.edge_dst, road.head_ids()[u],
                         network.edge_src, key, r, network.edge_layout)
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
