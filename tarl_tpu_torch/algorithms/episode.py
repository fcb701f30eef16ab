"""The episode runner with progress and profiling hooks (ports
``tarl_tpu/algorithms/episode.py``: ``run_episode``).

* ``mode="fused"`` (default): the episode in chunks of
  :meth:`~tarl_tpu_torch.simulator.TransportationSimulator.run_fast`,
  aligned to the policy's refresh period so that every chunk but the last
  takes the periodic driver; the phase split is not observed, and the
  whole episode's time goes to the core timer;
* ``mode="eager"``: one :meth:`~tarl_tpu_torch.simulator.
  TransportationSimulator.run` a tick, each phase timed.

``profile`` runs cProfile over the episode; ``jax_trace_dir`` (the
reference's name, which callers pass) records a ``torch.profiler`` trace
there (:func:`~tarl_tpu_torch.utils.timers.device_trace`).
"""
from __future__ import annotations

import cProfile
import io
import pstats
import time as _time
from pathlib import Path
from typing import Optional, Union

from ..simulator import TransportationSimulator
from ..utils.timers import device_trace


def run_episode(
    simulator: TransportationSimulator,
    steps: int = 86400,
    *,
    mode: str = "fused",
    chunk: int = 4096,
    profile: bool = False,
    profile_output: Optional[Union[str, Path]] = None,
    jax_trace_dir: Optional[str] = None,
    progress: bool = True,
) -> TransportationSimulator:
    """Run ``steps`` ticks on the configured simulator."""
    if mode not in ("fused", "eager"):
        raise ValueError(f"Unknown mode {mode!r}")
    if progress:
        print("\n" + "=" * 10 + " Starting Simulation " + "=" * 10)

    profiler = cProfile.Profile() if profile else None
    if profiler is not None:
        profiler.enable()

    with device_trace(jax_trace_dir):
        if mode == "fused":
            # Refresh-aligned chunks, never above the caller's chunk (it may
            # be a device-memory cap): where the period exceeds it, the
            # periodic driver is skipped instead.
            rate = simulator.policy.periodic_rate
            if rate and rate <= chunk and chunk % rate:
                chunk -= chunk % rate
            done = 0
            t0 = _time.time()
            while done < steps:
                n = min(chunk, steps - done)
                simulator.run_fast(n)
                done += n
                if progress:
                    speed = done / max(_time.time() - t0, 1e-9)
                    print(f"\r  tick {done}/{steps} ({speed:,.0f} ticks/s)",
                          end="")
            if progress:
                print()
            simulator.timers.core_time += _time.time() - t0
        else:
            iterator = range(steps)
            if progress:
                try:
                    from tqdm import tqdm

                    iterator = tqdm(iterator, desc="Running Simulation",
                                    unit="step")
                except ImportError:
                    pass
            for _ in iterator:
                simulator.run()

    if profiler is not None:
        profiler.disable()
        stream = io.StringIO()
        pstats.Stats(profiler, stream=stream).sort_stats(
            "cumtime").print_stats(20)
        print("\n=== Profiling Results ===")
        print(stream.getvalue())
        if profile_output:
            output_path = Path(profile_output)
            output_path.parent.mkdir(parents=True, exist_ok=True)
            output_path.write_text(stream.getvalue())

    return simulator
