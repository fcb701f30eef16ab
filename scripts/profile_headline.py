"""Where the time of a headline tick goes, on one GPU, with the default
core (K1), with the fused core (K12), and on road blocks (the sharded
tick, K7).

Runs the headline episode of ``chip_smoke.py`` phase 2 (Grid16x16, 50,000
commuters, exact mode: backlog Q=256, W=32, withdraw depth 2, both
escalations, random choice) through ``run_episode``, once per core, and
through ``run_episode_shard_map`` on ``chip_smoke.SHARD_BLOCKS`` road
blocks (the warm-up through ``run_episode``: the states are equal
bitwise), and
reports for a window of ticks after a warm-up:

1. a phase breakdown: each phase of the tick wrapped in
   ``torch.cuda.synchronize()`` (so the sum exceeds the plain tick time);
   the fused core's sampler (K12) is also timed on its own inside it;
2. ``torch.profiler`` over a window of plain ticks: device time per tick,
   device kernels per tick, the device's idle share of the wall, and the
   largest device items;
3. the plain tick time over the same number of ticks.

With ``--pairs N`` it reports instead the serial (default core) and the
sharded tick in N alternating windows of ``--ticks`` ticks, each from the
same warm state (serial first in odd pairs, sharded first in even ones),
after one untimed window of each, and their medians: the block
structure's cost with the host's drift within the call taken out.

    python3 scripts/profile_headline.py [--warmup 1800] [--ticks 300]
        [--pairs N]

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
    ap.add_argument("--pairs", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_headline: needs an NVIDIA GPU")
    import chip_smoke
    from tarl_tpu_torch.core import fused_core, fused_winner
    from tarl_tpu_torch.core import step as step_mod
    from tarl_tpu_torch.core.step import Policy, init_sim_state, run_episode
    from tarl_tpu_torch.parallel import shard_map_episode as sme
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

    if args.pairs:
        return _pairs(args, net, agents, card)
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

    k12 = ("  of which K12 (fused_core_sample: eligibility, logits and "
           "Gumbel-max)")
    choice_label = "choice (random, its Gumbel draw)"
    # K1 and K7 draw their noise inside (no [KIN, R] matrix); K12's fused
    # entry computes the eligibility and the logits inside.
    serial_patches = (step_mod, [
        ("insert_agents_backlogged", "insert (backlog)"),
        ("withdraw_agents", "withdraw"),
        ("apply_transfers", "epilogue (apply_transfers)"),
        ("fused_core_step", "fused core step (K12, push, pop)"),
    ])
    # The sharded tick's phases, by the module-level names it calls; the
    # halo's head reads and stacks, the insert's count scatter, the
    # withdraw's marks, the pop mask and the metrics fall in "rest".
    shard_patches = (sme, [
        ("backlog_frontier_append", "insert: frontier append"),
        ("drain_backlog", "insert: drain"),
        ("scan_run", "withdraw scans"),
        ("pack_upstream", "packed upstream words"),
        ("push_winners", "tail push"),
        ("pop_heads", "head pop"),
    ])
    blocks_s = chip_smoke.SHARD_BLOCKS
    mesh = sme.make_road_mesh(blocks_s, dev)
    for name, fused, blocks in (
            ("default core (K1)", False, None),
            ("fused core (K12)", True, None),
            (f"sharded, {blocks_s} blocks (K7)", False, blocks_s)):
        sim = chip_smoke.headline_sim(fused_core=fused)
        policy = Policy(choice=random_choice)
        state = init_sim_state(net, agents, sim=sim, policy=policy)
        state, _ = run_episode(state, net, policy, args.warmup, sim=sim)
        torch.cuda.synchronize()

        def tick_run(state, pol, ticks, timed_run=False):
            if blocks is None:
                kw = {}
                if timed_run:
                    kw = dict(core=timed("core K1 (direction_confirm, its "
                                         "noise drawn inside)",
                                         fused_winner.direction_confirm),
                              payload=timed(
                                  k12, fused_core.fused_core_sample))
                return run_episode(state, net, pol, ticks, sim=sim, **kw)
            winner = (timed("core K7 (fused_shard_winner, its noise "
                            "drawn inside)",
                            fused_winner.fused_shard_winner)
                      if timed_run else fused_winner.fused_shard_winner)
            return sme.run_episode_shard_map(state, net, pol, ticks, mesh,
                                             sim=sim, winner=winner)

        # 1. phase breakdown, synchronised
        spent.clear()
        module, patches = serial_patches if blocks is None else shard_patches
        saved = [(attr, getattr(module, attr)) for attr, _ in patches]
        for attr, label in patches:
            setattr(module, attr, timed(label, getattr(module, attr)))
        timed_choice = timed(choice_label, random_choice)
        if blocks is not None:
            mesh.all_gather = timed("mesh all_gather (halo x2, winners)",
                                    sme.RoadMesh.all_gather.__get__(mesh))
            mesh.psum = timed("mesh psum (withdraw, on-way, done)",
                              sme.RoadMesh.psum.__get__(mesh))
        t0 = time.perf_counter()
        state, _ = tick_run(state, Policy(choice=timed_choice), n, True)
        torch.cuda.synchronize()
        synced = (time.perf_counter() - t0) / n
        for attr, fn in saved:
            setattr(module, attr, fn)
        vars(mesh).pop("all_gather", None)
        vars(mesh).pop("psum", None)

        # 3. plain ticks
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = tick_run(state, policy, n)
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
        rest = ("rest (key split, clock, metrics, glue)" if blocks is None
                else "rest (halo reads and stacks, count scatters, withdraw "
                     "marks, pop mask, key split, clock, metrics)")
        print(f"  {rest}: "
              f"{(synced - outer / n) * 1e3:.3f} ms/tick", flush=True)

        # 2. profiler
        from torch.profiler import ProfilerActivity, profile

        m = args.profile_ticks
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, _ = tick_run(state, policy, m)
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


def _pairs(args, net, agents, card) -> int:
    """``--pairs``: alternating serial and sharded windows from one warm
    state; prints ms/tick of each window and the medians."""
    import statistics

    import torch

    import chip_smoke
    from tarl_tpu_torch.core.step import Policy, init_sim_state, run_episode
    from tarl_tpu_torch.parallel import shard_map_episode as sme
    from tarl_tpu_torch.routing.policies import random_choice

    sim = chip_smoke.headline_sim()
    policy = Policy(choice=random_choice)
    mesh = sme.make_road_mesh(chip_smoke.SHARD_BLOCKS, net.device)
    state = init_sim_state(net, agents, sim=sim, policy=policy)
    state, _ = run_episode(state, net, policy, args.warmup, sim=sim)
    runs = {
        "serial": lambda: run_episode(state, net, policy, args.ticks,
                                      sim=sim),
        "sharded": lambda: sme.run_episode_shard_map(
            state, net, policy, args.ticks, mesh, sim=sim),
    }
    for run in runs.values():        # first-call costs, untimed
        run()
    times = {"serial": [], "sharded": []}
    for i in range(args.pairs):
        for name in (("serial", "sharded") if i % 2 == 0
                     else ("sharded", "serial")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[name]()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) / args.ticks * 1e3)
    end = args.warmup + args.ticks
    for name, ms in times.items():
        print(f"{name} ({chip_smoke.SHARD_BLOCKS} blocks)"
              if name == "sharded"
              else name, f"ticks {args.warmup}-{end}, ms/tick per window "
              f"({card}):", " ".join(f"{t:.3f}" for t in ms), flush=True)
    med = {k: statistics.median(v) for k, v in times.items()}
    wins = sum(a < b for a, b in zip(times["serial"], times["sharded"]))
    print(f"medians: serial {med['serial']:.3f}, sharded "
          f"{med['sharded']:.3f} ms/tick, ratio "
          f"{med['sharded'] / med['serial']:.3f}; serial faster in {wins} "
          f"of {args.pairs} pairs", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
