"""The relax's counts (``csrc/primal_relax.cu``: Jacobi sweeps of the
``[I, D]`` table and the next-road pass in one launch, stopping at the
first sweep that lowers nothing), on one refresh's inputs.

Bytes: the road costs and the road-to map (4 a road each), the slot table
and its valid flags (5 a slot), the warm start read and the distances and
next roads written (12 a table entry).  Operations: an add and a min for
each valid slot, column and sweep the inputs need, and for the next-road
pass.  The sweeps are counted by the benchmark's reference on the same
inputs: those that lower some distance, up to the cap.
"""
from __future__ import annotations

import torch

from .peaks import least_seconds


def sweeps_needed(net, cost, dist0, cap: int | None) -> int:
    """Sweeps of the reference relax from ``dist0`` under ``cost`` that
    lower some distance, at most ``cap`` (None: no cap)."""
    from ..reference.routing import slot_tables, sweep

    w, succ = slot_tables(cost, net.inter_out_road, net.inter_out_ok,
                          net.road_to)
    dist, n = dist0, 0
    limit = net.num_intersections - 1 if cap is None else cap
    while n < limit:
        new = sweep(dist, w, succ)
        if not bool(torch.any(new < dist)):
            break
        dist, n = new, n + 1
    return n


def least(net, sweeps: int, dests: int) -> tuple[float, str]:
    """The relax's least seconds for ``sweeps`` sweeps of an ``[I,
    dests]`` table and its next roads, and what bounds it."""
    r = net.num_roads
    i_n, k_n = net.inter_out_road.shape
    valid = int(net.inter_out_ok.sum())
    moved = 4 * r + 5 * i_n * k_n + 4 * r + 3 * 4 * i_n * dests
    return least_seconds(moved, 2 * (sweeps + 1) * valid * dests)


def share_pct(run, kernel: str) -> float | None:
    """The relax's mean least time over the traced refreshes' inputs, over
    the mean device time a call of ``kernel`` in the traced span, in
    percent; None where the span holds no such launch."""
    from types import SimpleNamespace

    from ..trace import device_time_ns

    if run.trace is None or not run.refresh_inputs:
        return None
    times = device_time_ns(run.trace, kernel)
    if not times:
        return None
    ref = run.ref
    cap = run.cell.traffic["routing"].get("max_bf_iters")
    bounds = []
    for count, next_hop in run.refresh_inputs:
        state = SimpleNamespace(road=SimpleNamespace(count=count),
                                next_hop=next_hop)
        cost, dist0 = ref.policy.refresh_inputs(state, ref.net)
        sweeps = sweeps_needed(ref.net, cost, dist0, cap)
        bounds.append(least(ref.net, sweeps, dist0.shape[1])[0])
    return 100.0 * (sum(bounds) / len(bounds)) / (sum(times) / len(times)
                                                  / 1e9)
