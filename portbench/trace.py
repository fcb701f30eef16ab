"""The traced spans of a ``--trace 1`` run: ``torch.profiler`` over a fixed
run of ticks, read from the profiler's raw records
(``kineto_results.events()``; ``prof.events()`` would first build the host
event tree, tens of seconds at these sizes).

The device span records device activity only, so that the host runs as in
an untraced run and the device's idle share is the untraced one's; the
host span, shorter, records host operations too, to say what the host was
doing while the device was idle.
"""
from __future__ import annotations

import bisect
import time
import warnings


def start(device, host: bool):
    """A started profiler: device activity, and host operations where
    ``host`` (or where there is no device)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] if device.type == "cuda" else []
    if host or not acts:
        acts.append(ProfilerActivity.CPU)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    with warnings.catch_warnings():
        # A profiler without a schedule warns that it keeps one cycle.
        warnings.simplefilter("ignore", UserWarning)
        prof = profile(activities=acts)
        prof.start()
    prof.portbench = (device, time.perf_counter())
    return prof


def stop(prof, ticks: int) -> dict:
    """The span's records, after a synchronise: ``window_s`` (host clock
    from start to the synchronise), ``ticks``, ``device`` ``[(start_ns,
    dur_ns, name, kind)]`` sorted by start, ``host`` ``[(start_ns,
    dur_ns, name)]``, and ``busy_s``, the union of the device intervals."""
    import torch

    device, t0 = prof.portbench
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    window_s = time.perf_counter() - t0
    prof.stop()
    dev, host = [], []
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        if e.is_hidden_event():
            continue
        if e.device_type() == cuda:
            dev.append((e.start_ns(), e.duration_ns(), e.name(),
                        activity(e.name())))
        else:
            host.append((e.start_ns(), e.duration_ns(), e.name()))
    dev.sort()
    return {"window_s": window_s, "ticks": ticks, "device": dev,
            "host": host, "busy_s": union_ns(dev) / 1e9}


def merged(intervals) -> list:
    """``[(start, end)]`` of the union of ``(start, duration, ...)``
    records sorted by start."""
    out = []
    for rec in intervals:
        s, e = rec[0], rec[0] + rec[1]
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def union_ns(intervals) -> int:
    return sum(e - s for s, e in merged(intervals))


def activity(name: str) -> str:
    """A device record's kind by its name, as CUPTI names them: a copy
    (``Memcpy ...``), a memset (``Memset ...``) or a kernel."""
    if name.startswith("Memcpy"):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def is_launch(kind: str) -> bool:
    """A device kernel or memset (a copy is neither)."""
    return kind in ("kernel", "memset")


def device_time_ns(trace: dict, name_part: str) -> list[int]:
    """Durations of the device activities whose name holds ``name_part``."""
    return [d for _, d, name, _ in trace["device"] if name_part in name]


def breakdown(trace: dict, host_trace: dict | None) -> dict:
    """The ten device operations that took the most time over the device
    span, and the ten host operations under which the device sat idle
    longest over the host span (each idle gap labelled by the innermost
    host operation covering its midpoint; ``host python`` where none
    does)."""
    by_op: dict = {}
    for _, dur, name, _ in trace["device"]:
        by_op[name[:120]] = by_op.get(name[:120], 0) + dur
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    gaps: dict = {}
    if host_trace is not None and host_trace["device"]:
        host = sorted(host_trace["host"])
        starts = [h[0] for h in host]
        busy = merged(host_trace["device"])
        for (_, e0), (s1, _) in zip(busy, busy[1:]):
            mid = (e0 + s1) // 2
            label, best = "host python", None
            # Host operations nest a few deep: the covering ones start
            # shortly before the midpoint.
            i = bisect.bisect_right(starts, mid)
            for s, d, name in host[max(0, i - 64):i]:
                if s + d >= mid and (best is None or d < best):
                    label, best = name[:120], d
            gaps[label] = gaps.get(label, 0) + (s1 - e0)
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, d / 1e9] for n, d in ops],
            "idle_gaps": [[n, d / 1e9] for n, d in idle]}
