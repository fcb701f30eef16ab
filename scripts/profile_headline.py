"""Where the time of a headline tick goes, on one GPU, with the default
core (K1) and with the fused core (K12).

Runs the headline episode of ``chip_smoke.py`` phase 2 (Grid16x16, 50,000
commuters, exact mode: backlog Q=256, W=32, withdraw depth 2, both
escalations, random choice) through ``run_episode``, once per core, and
reports for a window of ticks after a warm-up:

1. a phase breakdown: each phase of the tick wrapped in
   ``torch.cuda.synchronize()`` (so the sum exceeds the plain tick time);
   the fused core's sampler (K12) is also timed on its own inside it;
2. ``torch.profiler`` over a window of plain ticks: device time per tick,
   device kernels per tick, the device's idle share of the wall, and the
   largest device items;
3. the plain tick time over the same number of ticks.

    python3 scripts/profile_headline.py [--warmup 1800] [--ticks 300]

Needs an NVIDIA GPU; prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import collections
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--warmup", type=int, default=1800)
    ap.add_argument("--ticks", type=int, default=300)
    ap.add_argument("--profile-ticks", type=int, default=100)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_headline: needs an NVIDIA GPU")
    import chip_smoke
    from tarl_tpu_torch.core import fused_core, fused_winner
    from tarl_tpu_torch.core import step as step_mod
    from tarl_tpu_torch.core.step import Policy, init_sim_state, run_episode
    from tarl_tpu_torch.routing.policies import random_choice
    from tarl_tpu_torch.state import sort_agents_by_departure

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda", 0)
    net, agents = chip_smoke.load_scenario("Grid16x16_50000", 16, 16, 50000,
                                           dev)
    agents = sort_agents_by_departure(agents)
    n = args.ticks

    spent = collections.Counter()

    def timed(label, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            spent[label] += time.perf_counter() - t0
            return out
        return run

    k12 = "  of which K12 (gumbel_argmax_payload)"
    for fused in (False, True):
        name = "fused core (K12)" if fused else "default core (K1)"
        sim = chip_smoke.headline_sim(fused_core=fused)
        policy = Policy(choice=random_choice)
        state = init_sim_state(net, agents, sim=sim, policy=policy)
        state, _ = run_episode(state, net, policy, args.warmup, sim=sim)
        torch.cuda.synchronize()

        # 1. phase breakdown, synchronised
        spent.clear()
        patches = [
            ("insert_agents_backlogged", "insert (backlog)"),
            ("withdraw_agents", "withdraw"),
            ("direction_gumbel", "direction Gumbel draw [KIN, R]"),
            ("apply_transfers", "epilogue (apply_transfers)"),
            ("fused_core_step", "fused core step (eligibility, logits, "
                                "K12, push, pop)"),
        ]
        saved = [(attr, getattr(step_mod, attr)) for attr, _ in patches]
        for attr, label in patches:
            setattr(step_mod, attr, timed(label, getattr(step_mod, attr)))
        timed_policy = Policy(choice=timed("choice (random, its Gumbel draw)",
                                           random_choice))
        t0 = time.perf_counter()
        state, _ = run_episode(
            state, net, timed_policy, n, sim=sim,
            core=timed("core K1 (direction_confirm)",
                       fused_winner.direction_confirm),
            payload=timed(k12, fused_core.gumbel_argmax_payload))
        torch.cuda.synchronize()
        synced = (time.perf_counter() - t0) / n
        for attr, fn in saved:
            setattr(step_mod, attr, fn)

        # 3. plain ticks
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = run_episode(state, net, policy, n, sim=sim)
        torch.cuda.synchronize()
        plain = (time.perf_counter() - t0) / n

        end = args.warmup + 2 * n
        print(f"headline tick, {name}, ticks {args.warmup}-{end} ({card}): "
              f"{plain * 1e3:.3f} ms/tick plain (ticks {args.warmup + n}-"
              f"{end}), {synced * 1e3:.3f} ms/tick with every phase "
              f"synchronised", flush=True)
        outer = sum(s for label, s in spent.items() if label != k12)
        for label, s in spent.most_common():
            if label == k12:
                continue
            print(f"  {label}: {s / n * 1e3:.3f} ms/tick", flush=True)
            if label.startswith("fused core step"):
                print(f"  {k12}: {spent[k12] / n * 1e3:.3f} ms/tick",
                      flush=True)
        print(f"  rest (key split, clock, metrics, glue): "
              f"{(synced - outer / n) * 1e3:.3f} ms/tick", flush=True)

        # 2. profiler
        from torch.profiler import ProfilerActivity, profile

        m = args.profile_ticks
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, _ = run_episode(state, net, policy, m, sim=sim)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        by_name = collections.Counter()
        for e in events:
            by_name[e.name] += e.time_range.end - e.time_range.start
        device_us = sum(by_name.values())
        print(f"profiler over {m} ticks, {name} ({card}): wall "
              f"{wall / m * 1e3:.3f} ms/tick (profiled), device time "
              f"{device_us / m / 1e3:.3f} ms/tick, {len(events) / m:.1f} "
              f"device kernels/tick, device idle "
              f"{1 - device_us / 1e6 / wall:.1%}", flush=True)
        for item, us in by_name.most_common(8):
            print(f"  {us / m:.2f} us/tick  {item[:90]}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
