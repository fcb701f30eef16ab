"""What the port's spans (``tarl_tpu_torch.utils.timers``) cost a tick, off
and on.

One tick's span calls with empty bodies, built from the program's own
``spanned`` and ``span`` and ``core.sync.host_read``: ``tick`` and under it
``insert``, ``withdraw``, ``choice`` and ``core``, with ``--reads`` host
reads of a 0-d CPU tensor split between the insert and the withdraw.  Less
the same tick of plain functions, each read a bare
``torch.stack(...).tolist()``.  Timed over ``--ticks`` ticks with spans off
and on (the records taken every 1,000 ticks); microseconds a tick, the
median of ``--repeats`` runs.

    python3 scripts/span_cost.py [--reads 1 2 5] [--ticks 20000]
        [--repeats 7]

Prints the card's name and power limit first where there is one.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from tarl_tpu_torch.core import sync  # noqa: E402
from tarl_tpu_torch.utils import timers  # noqa: E402

ZERO = torch.zeros((), dtype=torch.int32)


def make_tick(spans: bool):
    """One tick's calls: with the program's spans and reads, or plain."""
    wrap = timers.spanned if spans else (lambda name: lambda fn: fn)

    def read(site):
        if spans:
            return sync.host_read(ZERO, site=site)
        return torch.stack([ZERO.to(torch.int64)]).tolist()

    @wrap("insert")
    def insert(n):
        for _ in range(n):
            read("insert.window")

    @wrap("withdraw")
    def withdraw(n):
        for _ in range(n):
            read("withdraw.escalate")

    @wrap("core")
    def core():
        pass

    def choice():
        pass

    @wrap("tick")
    def tick(reads):
        insert((reads + 1) // 2)
        withdraw(reads // 2)
        if spans:
            with timers.span("choice"):
                choice()
        else:
            choice()
        core()

    return tick


def us_a_tick(tick, reads: int, ticks: int, on: bool) -> float:
    timers.tracing(on)
    t0 = time.perf_counter()
    for i in range(ticks):
        tick(reads)
        if i % 1000 == 999:
            timers.take_spans()
    dt = time.perf_counter() - t0
    timers.tracing(False)
    timers.take_spans()
    return dt / ticks * 1e6


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reads", type=int, nargs="+", default=[1, 2, 5])
    ap.add_argument("--ticks", type=int, default=20000)
    ap.add_argument("--repeats", type=int, default=7)
    args = ap.parse_args()
    if torch.cuda.is_available():
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True)
        print("card:", out.stdout.strip())
    torch.set_num_threads(1)
    spanned, plain = make_tick(True), make_tick(False)
    for reads in args.reads:
        got = {"off": [], "on": []}
        for _ in range(args.repeats):
            bare = us_a_tick(plain, reads, args.ticks, False)
            got["off"].append(us_a_tick(spanned, reads, args.ticks, False)
                              - bare)
            got["on"].append(us_a_tick(spanned, reads, args.ticks, True)
                             - bare)
        print(f"reads {reads}: off {statistics.median(got['off']):.2f} "
              f"us/tick, on {statistics.median(got['on']):.2f} us/tick "
              f"(median of {args.repeats})", flush=True)


if __name__ == "__main__":
    main()
