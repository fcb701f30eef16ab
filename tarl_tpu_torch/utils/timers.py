"""Wall-clock phase timing (ports ``tarl_tpu/utils/timers.py``:
``Stopwatch`` and ``device_trace``).

The simulator facade's eager tick times each phase with
``torch.cuda.synchronize()`` barriers on the card; the episode runner's
fused mode can record a ``torch.profiler`` trace instead.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import torch


def synchronize(tensors) -> None:
    """Wait for the devices of ``tensors`` (a tensor or an iterable of
    them): ``torch.cuda.synchronize`` for each CUDA device; nothing on the
    CPU, where PyTorch runs in order."""
    if isinstance(tensors, torch.Tensor):
        tensors = (tensors,)
    for dev in {t.device for t in tensors if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


@dataclass
class Stopwatch:
    """Accumulating named timers."""

    totals: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def time(self, name: str, block_on=None):
        """Time a block; ``block_on`` (a tensor or an iterable of tensors)
        is synchronised before the clock stops, so that the device's work is
        attributed to the block."""
        start = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                synchronize(block_on)
            self.totals[name] = self.totals.get(name, 0.0) + (
                time.perf_counter() - start)

    def summary(self) -> str:
        total = sum(self.totals.values())
        lines = [f"{k:20} {v:10.3f} s" for k, v in self.totals.items()]
        lines.append(f"{'total':20} {total:10.3f} s")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(trace_dir: str | None):
    """A ``torch.profiler`` trace of the block (the CPU and, where
    available, the card), written under ``trace_dir`` as a Chrome trace
    (``trace.json``); does nothing when ``trace_dir`` is None."""
    if trace_dir is None:
        yield
        return
    import os

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
