"""The program's phase spans over the traced device span, and the device
operations put down to them.

The program records a span at each layer boundary of its tick
(``tarl_tpu_torch.utils.timers``: ``tick``, and under it ``insert``,
``withdraw``, ``choice`` with ``refresh`` under it, and ``core``; each host
read a span named by its site) while a ``torch.profiler`` profile runs, so
a ``--trace 1`` run's two traced spans carry them, on the profiler's clock.
The first reader takes them from the program into ``run.spans``; the
device span's ticks are the first ``run.trace["ticks"]`` tick spans taken
(the host span comes later).  A program without spans leaves
``run.spans`` None, and every reader here returns None.

Each device operation goes to the innermost span open at its launch: the
runtime record (``cudaLaunchKernel``, ``cudaMemcpyAsync``, ...) it pairs
with.  The trace keeps no correlation ids, so the pairing is by order
within each kind of record (kernel, memset, copy), which one stream keeps
on both sides: the k-th launch call of a kind launched the k-th device
record of that kind.  Where one side has more records of a kind, the
surplus is dropped from its start (CUPTI can miss the span's first kernel)
and a dropped device record is put down to no span; the result's
``route`` counts them.  The device's time stamps are never compared with
the host's: on the card they drift from the host clock by up to 15 ms over
a traced span in some runs, so an operation's device start can fall under
a span that opened after its launch.
"""
from __future__ import annotations

import bisect
from types import SimpleNamespace

PHASES = ("insert", "withdraw", "choice", "refresh", "core")
# CUDA API calls that put one record of a kind on the device.
LAUNCHES = {
    "kernel": ("cudaLaunchKernel", "cudaLaunchKernelExC",
               "cudaLaunchCooperativeKernel", "cuLaunchKernel",
               "cuLaunchKernelEx"),
    "memset": ("cudaMemsetAsync", "cudaMemset"),
    "memcpy": ("cudaMemcpyAsync", "cudaMemcpy"),
}


def taken(run):
    """The program's spans since the last take (``run.spans``), taken on
    the first call; None where the program records none."""
    if not hasattr(run, "spans"):
        try:
            from tarl_tpu_torch.utils.timers import take_spans
        except ImportError:
            run.spans = None
        else:
            run.spans = take_spans() or None
    return run.spans


def phases(run):
    """:func:`attribute` of the run's traced device span (``run.phases``,
    computed on the first call), or None."""
    if not hasattr(run, "phases"):
        spans = taken(run)
        run.phases = (None if spans is None or run.trace is None
                      else attribute(spans, run.trace))
    return run.phases


def innermost(spans, starts, order, t):
    """The index of the innermost span open at ``t`` (``starts`` the spans'
    starts in ``order``, sorted), or -1."""
    i = bisect.bisect_right(starts, t) - 1
    if i < 0:
        return -1
    k = order[i]
    while k != -1 and spans[k].end_ns < t:
        k = spans[k].parent
    return k


def launch_times(trace: dict):
    """Each device record's launch time (None where it pairs with no
    launch), paired by order within its kind, and the route: ``launch``,
    or ``launch, <n> unpaired`` where surplus records were dropped."""
    dev = trace["device"]
    at: list = [None] * len(dev)
    unpaired = 0
    for kind, names in LAUNCHES.items():
        calls = sorted(h[0] for h in trace["host"] if h[2] in names)
        mine = [k for k, d in enumerate(dev) if d[3] == kind]
        surplus = len(calls) - len(mine)
        unpaired += abs(surplus)
        calls, mine = calls[max(surplus, 0):], mine[max(-surplus, 0):]
        for c, k in zip(calls, mine):
            at[k] = c
    return at, ("launch" if not unpaired
                else f"launch, {unpaired} unpaired")


def attribute(spans, trace: dict):
    """The device span's phases: ``ticks`` (the tick spans), ``refreshes``
    (their count), ``device_ns`` (each phase's operations' device time,
    its own and not its children's; ``tick`` for those under a tick but
    no phase, ``None`` for those under no tick or paired with no launch),
    ``wall_ns`` (each phase span's self time: its length less its child
    phases'), ``reads`` (read spans by site), ``launches`` (each device
    record's launch time) and ``route``; None where fewer tick spans were
    taken than the span has ticks."""
    all_ticks = [i for i, s in enumerate(spans) if s.name == "tick"]
    n = trace["ticks"]
    if len(all_ticks) < n:
        return None
    ticks = all_ticks[:n]
    lo, hi = ticks[0], ticks[-1]
    hi = max(i for i, s in enumerate(spans) if s.tick == spans[hi].tick)
    # The spans of those ticks (sites and phases), in the order they open.
    order = list(range(lo, hi + 1))
    starts = [spans[i].start_ns for i in order]

    def phase_of(k):
        while k != -1 and spans[k].name not in PHASES \
                and spans[k].name != "tick":
            k = spans[k].parent
        return None if k == -1 else spans[k].name

    device_ns: dict = {}
    at, route = launch_times(trace)
    for t, (_, dur, _, _) in zip(at, trace["device"]):
        p = None if t is None else phase_of(
            innermost(spans, starts, order, t))
        device_ns[p] = device_ns.get(p, 0) + dur
    wall_ns: dict = {}
    reads: dict = {}
    refreshes = 0
    for i in order:
        s = spans[i]
        if s.name in PHASES:
            wall_ns[s.name] = wall_ns.get(s.name, 0) + s.end_ns - s.start_ns
            parent = spans[s.parent].name if s.parent != -1 else None
            if parent in PHASES:
                wall_ns[parent] -= s.end_ns - s.start_ns
            refreshes += s.name == "refresh"
        elif s.name != "tick":
            reads[s.name] = reads.get(s.name, 0) + 1
    return SimpleNamespace(
        ticks=[spans[i] for i in ticks], refreshes=refreshes,
        device_ns=device_ns, wall_ns=wall_ns, reads=reads, route=route,
        launches=at, label=lambda t: label(spans, starts, order, t))


def label(spans, starts, order, t) -> str:
    """The name of the innermost span open at host time ``t``, or
    ``between spans``."""
    k = innermost(spans, starts, order, t)
    return "between spans" if k == -1 else spans[k].name


def per(run, phase: str, kind: str):
    """A phase's device or wall milliseconds, a tick (a refresh for
    ``refresh``), over the traced device span; None where nothing was
    read."""
    ph = phases(run)
    if ph is None or (kind == "device_ns" and not run.trace["device"]):
        return None
    count = ph.refreshes if phase == "refresh" else len(ph.ticks)
    if not count:
        return None
    return getattr(ph, kind).get(phase, 0) / count / 1e6


def reads_per_tick(run, phase: str):
    """Host reads a tick over the traced device span by the sites of
    ``phase`` (``insert.*``, ``withdraw.*``)."""
    ph = phases(run)
    if ph is None:
        return None
    return sum(n for site, n in ph.reads.items()
               if site.startswith(phase + ".")) / len(ph.ticks)


def tick_ms(run) -> list | None:
    """The program's tick spans over the traced device span, in ms."""
    ph = phases(run)
    if ph is None:
        return None
    return [(s.end_ns - s.start_ns) / 1e6 for s in ph.ticks]


def idle_by_span(run) -> list | None:
    """The traced device span's idle gaps, each labelled by the innermost
    program span over its midpoint, or ``between spans`` where none is
    open: the ten largest totals, ``[[label, seconds]]``, as
    ``breakdown``'s ``idle_gaps``; None without spans.  A gap ends where
    the device starts an operation; the midpoint is taken on the host clock
    back from that operation's launch (half the gap before it), since the
    device's stamps drift from the host's.  A gap closed by an unpaired
    operation is ``unpaired``."""
    ph = phases(run)
    if ph is None:
        return None
    gaps: dict = {}
    end = None
    for (s, dur, _, _), launch in zip(run.trace["device"], ph.launches):
        if end is not None and s > end:
            name = ("unpaired" if launch is None
                    else ph.label(launch - (s - end) // 2))
            gaps[name] = gaps.get(name, 0) + (s - end)
        end = s + dur if end is None else max(end, s + dur)
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return [[n, d / 1e9] for n, d in idle]
