"""The port's timing: spans inside the program, the device synchronise the
facade's phase timers use, and a ``torch.profiler`` trace for the episode
runner (ports ``tarl_tpu/utils/timers.py``'s ``device_trace``; its
``Stopwatch`` is replaced by the spans).

**Spans.**  ``with span("choice"):`` or ``@spanned("insert")`` marks a
layer boundary.  While spans are off, ``span`` returns one shared no-op
context and ``spanned`` calls straight through: no allocation, no clock
read, no device call.  They are on while :func:`tracing` says so, and
while a ``torch.profiler`` profile runs, so that a profiler trace carries
them (a process that never profiles and never calls :func:`tracing`
records nothing); under a profiler alone they stop once ``PROFILED_CAP``
records wait to be taken, so that a profiled tool that never takes them
neither grows without bound nor pays for spans past that.  Each span
records, in memory, its name, the sequence number of the enclosing
``tick`` span (-1 outside any), the index of the enclosing span (-1 at
the root) and its start and end in nanoseconds of ``time.time_ns``, the
clock the profiler stamps its records with, so that spans and device
records line up with no conversion.  Nothing is written out until
:func:`take_spans`.  The spans the program opens: ``tick``
(``core.step.tick``) and, under it, ``insert``, ``withdraw``, ``choice``
and ``core``; ``refresh`` under ``choice`` in
``core.step.run_episode_periodic``; one span a host read, named by its
site (``core.sync.host_read``), under the phase that reads.
"""
from __future__ import annotations

import contextlib
import functools
import json
import os
import time
from typing import NamedTuple

import torch
import torch.autograd.profiler as _profiler


class SpanRecord(NamedTuple):
    """A closed span: ``tick`` is the enclosing ``tick`` span's sequence
    number (-1 outside any), ``parent`` the enclosing span's index in the
    same :func:`take_spans` list (-1 at the root)."""

    name: str
    tick: int
    parent: int
    start_ns: int
    end_ns: int


# Records that a profiler alone (spans not turned on) may leave untaken.
PROFILED_CAP = 1 << 14
_ON = False
_RECORDS: list = []     # [name, tick, parent, start_ns, end_ns]
_OPEN: list = []        # indices in _RECORDS of the open spans
_TICK = -1              # the open tick span's sequence number
_TICKS = 0              # tick spans opened so far
_now = time.time_ns


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _TICK, _TICKS
        if self.name == "tick":
            _TICK, _TICKS = _TICKS, _TICKS + 1
        parent = _OPEN[-1] if _OPEN else -1
        _OPEN.append(len(_RECORDS))
        _RECORDS.append([self.name, _TICK, parent, _now(), -1])
        return None

    def __exit__(self, exc_type, exc, tb):
        global _TICK
        rec = _RECORDS[_OPEN.pop()]
        rec[4] = _now()
        if rec[0] == "tick":
            _TICK = -1
        return False


def span(name: str):
    """A context that records a span named ``name`` while spans are on."""
    if _ON or (_profiler._is_profiler_enabled
               and len(_RECORDS) < PROFILED_CAP):
        return _Span(name)
    return _OFF


def spanned(name: str):
    """A decorator: each call of the function is a span named ``name``
    while spans are on."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if _ON or (_profiler._is_profiler_enabled
                       and len(_RECORDS) < PROFILED_CAP):
                with _Span(name):
                    return fn(*args, **kwargs)
            return fn(*args, **kwargs)
        return call
    return wrap


def tracing(on: bool) -> None:
    """Turn spans on or off (a running ``torch.profiler`` profile turns
    them on whatever this says, up to ``PROFILED_CAP`` records)."""
    global _ON
    _ON = bool(on)


def take_spans() -> list[SpanRecord]:
    """The spans recorded since the last call, in the order they opened,
    and clear them.  Take them with no span open: an open span's record
    would be lost."""
    if _OPEN:
        raise RuntimeError(f"{len(_OPEN)} spans still open")
    out = [SpanRecord(*r) for r in _RECORDS]
    _RECORDS.clear()
    return out


def synchronize(tensors) -> None:
    """Wait for the devices of ``tensors`` (a tensor or an iterable of
    them): ``torch.cuda.synchronize`` for each CUDA device; nothing on the
    CPU, where PyTorch runs in order."""
    if isinstance(tensors, torch.Tensor):
        tensors = (tensors,)
    for dev in {t.device for t in tensors if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def device_trace(trace_dir: str | None):
    """A ``torch.profiler`` trace of the block (the CPU and, where
    available, the card), written under ``trace_dir`` as a Chrome trace
    (``trace.json``), with spans on over the block and the program's spans
    beside it (``spans.json``: the spans not yet taken, the block's among
    them, as :class:`SpanRecord` fields on the trace's clock); does nothing
    when ``trace_dir`` is None."""
    if trace_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    was_on = _ON
    tracing(True)
    try:
        with profile(activities=activities) as prof:
            yield
    finally:
        tracing(was_on)
    with open(os.path.join(trace_dir, "spans.json"), "w") as f:
        json.dump([r._asdict() for r in take_spans()], f)
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
