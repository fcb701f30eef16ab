#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits nonzero; nothing is caught):

1. Card: name and power limit (``nvidia-smi``), torch and CUDA versions;
   build the CUDA kernels from ``tarl_tpu_torch/csrc`` and time the build.
2. Kernel against plain: the fused-winner kernel must equal its plain
   PyTorch version bitwise on all five outputs, on road states captured
   every 600 ticks of the headline episode and on 20 seeded random states
   of a Grid64x64 network, each with a fresh Gumbel matrix; both are timed
   per call with CUDA events.
3. The headline episode: Grid16x16, 50,000 agents departing over 06:00-08:00,
   7,200 ticks of 1 s in bitwise-exact mode (per-SRC backlog insert Q=256,
   W=32, withdraw depth 2, both escalations, random route choice).  Asserts
   a zero overflow monitor, conservation, arrivals, and one kernel call per
   tick; prints agent-steps/s measured after a 64-tick warm-up.
4. The episode in context: the first 600 ticks again with the plain version
   in the core, from the same key; the state must equal the kernel run's at
   tick 600 bitwise.
5. A JSON line per kernel, then ``{"ok": true, "device": {...}}`` last.

Exits nonzero, printing no result, where no CUDA device is available or
the package is missing beside this script.  Scenario files are written
under ``build/scenarios`` in the checkout.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HEADLINE_TICKS = 7200
WARMUP_TICKS = 64
CAPTURE_EVERY = 600
RANDOM_STATES = 20
TIMED_CALLS = 200


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def load_scenario(name, rows, cols, num_agents, device):
    from tarl_tpu_torch.io.matsim import load_network, load_population
    from tarl_tpu_torch.io.scenarios import grid_scenario

    cache = os.path.join(ROOT, "build", "scenarios")
    base = os.path.join(cache, name)
    if not os.path.exists(os.path.join(base, "network.xml")):
        grid_scenario(cache, name, rows=rows, cols=cols,
                      num_agents=num_agents, peak_start=6 * 3600,
                      peak_spread=2 * 3600)
    net = load_network(os.path.join(base, "network"), device=device)
    agents, _ = load_population(os.path.join(base, "population"),
                                os.path.join(base, "network"), device=device)
    return net, agents


def random_road_state(net, seed: int, time_now: float):
    """A random ring state that respects the invariants: ``0 <= count <=
    capacity``, live slots hold distinct agents >= 1 with their DEST nodes,
    selections are valid choice edges (or -1)."""
    import numpy as np
    import torch

    from tarl_tpu_torch.state import RoadState

    rng = np.random.default_rng(seed)
    r, nmax = net.num_roads, net.nmax
    cap = net.capacity.cpu().numpy().astype(np.int64)
    count = rng.integers(0, cap + 1)
    head = rng.integers(0, nmax, size=r)
    logical = (np.arange(nmax)[None, :] - head[:, None]) % nmax
    live = logical < count[:, None]
    ids = np.where(live, (rng.permutation(r * nmax) + 1).reshape(r, nmax), 0)
    dep = np.where(live, time_now + rng.integers(-40, 40, (r, nmax)), 0.0)
    arr = np.where(live, dep - 30.0, 0.0)
    dst = np.where(live, net.num_roads + 2 * rng.integers(
        0, net.num_intersections, (r, nmax)) + 1, 0)
    ids, dst = ids.astype(np.int32), dst.astype(np.int32)
    dep, arr = dep.astype(np.float32), arr.astype(np.float32)
    ok = net.choice_ok.cpu().numpy()
    tab = net.choice_dst_tab.cpu().numpy()
    nslots = ok.sum(axis=0)
    pick = (rng.random(net.num_nodes) * np.maximum(nslots, 1)).astype(int)
    sel = np.where(nslots > 0, tab[pick, np.arange(net.num_nodes)], -1)
    sel[rng.random(net.num_nodes) < 0.02] = -1
    dev = net.device

    def t(a):
        return torch.as_tensor(a, device=dev)

    road_state = RoadState(
        fifo_ids=t(ids), fifo_arrival=t(arr), fifo_departure=t(dep),
        fifo_dest=t(dst), head=t(head.astype(np.int32)),
        count=t(count.astype(np.int32)),
    )
    return road_state, t(sel.astype(np.int32))


def compare_kernel(cases, net, physics):
    """Kernel vs plain on each (road, selected_road, time, gumbel) case:
    bitwise on all five outputs.  Returns the largest absolute difference
    (0 when all match)."""
    import torch

    from tarl_tpu_torch.core.fused_winner import (
        direction_confirm, direction_confirm_plain)

    names = ("accept", "win_src", "agent", "dest", "popped")
    worst = 0
    for i, (road, sel, t_now, gumbel) in enumerate(cases):
        got = direction_confirm(road, sel, net, t_now, gumbel, physics)
        want = direction_confirm_plain(road, sel, net, t_now, gumbel, physics)
        torch.cuda.synchronize()
        for name, a, b in zip(names, got, want):
            if a.dtype != b.dtype or a.shape != b.shape:
                raise AssertionError(f"case {i}: {name} {a.dtype}{tuple(a.shape)}"
                                     f" vs {b.dtype}{tuple(b.shape)}")
            diff = int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
            worst = max(worst, diff)
            if not torch.equal(a, b):
                raise AssertionError(f"case {i}: kernel and plain differ in "
                                     f"{name} (max |diff| {diff})")
        if not bool(got[0].any()):
            raise AssertionError(f"case {i}: no transfer accepted; the "
                                 "comparison would be vacuous")
    return worst


def time_per_call(fn, args, calls: int = TIMED_CALLS) -> float:
    """Milliseconds per call, CUDA events around back-to-back calls after a
    warm-up."""
    import torch

    for _ in range(10):
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs an NVIDIA GPU")
    sys.path.insert(0, ROOT)
    import numpy as np

    from tarl_tpu_torch import _build
    from tarl_tpu_torch.config import DEFAULT_PHYSICS, SimConfig
    from tarl_tpu_torch.convert import to_numpy
    from tarl_tpu_torch.core import fused_winner, rng, sync
    from tarl_tpu_torch.core.step import (
        Policy, average_travel_time, init_sim_state, run_episode)
    from tarl_tpu_torch.routing.policies import random_choice
    from tarl_tpu_torch.state import sort_agents_by_departure

    dev = torch.device("cuda", 0)
    physics = DEFAULT_PHYSICS

    # --- 1. card ------------------------------------------------------------
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.load_library("fused_winner")
    log(f"kernel build: fused_winner {time.perf_counter() - t0:.2f} s "
        f"(nvcc {' '.join(_build.ARCH_FLAGS)})")

    # --- 3. the headline episode (captures phase 2's states) -------------
    t0 = time.perf_counter()
    net, agents = load_scenario("Grid16x16_50000", 16, 16, 50000, dev)
    agents = sort_agents_by_departure(agents)
    log(f"scenario Grid16x16: {net.num_roads} roads, Nmax {net.nmax}, "
        f"{agents.num_agents} agent rows, set-up "
        f"{time.perf_counter() - t0:.1f} s")
    sim = SimConfig(
        timestep=1, start_time=6 * 3600,
        end_time=6 * 3600 + HEADLINE_TICKS,
        record_road_optimality=False, insert_window=32, insert_backlog=256,
        withdraw_depth=2, sorted_population=True, insert_escalate=True,
        withdraw_escalate=True,
    )
    policy = Policy(choice=random_choice)
    state = init_sim_state(net, agents, sim=sim, policy=policy)

    fused_winner.reset_launches()
    sync.reset()
    overflow = 0.0
    captured = []
    state, logs = run_episode(state, net, policy, WARMUP_TICKS, sim=sim)
    overflow += float(logs.window_saturated.sum())
    torch.cuda.synchronize()
    reads_before = sync.HOST_READS
    t0 = time.perf_counter()
    done_ticks = WARMUP_TICKS
    while done_ticks < HEADLINE_TICKS:
        n = CAPTURE_EVERY - done_ticks % CAPTURE_EVERY
        state, logs = run_episode(state, net, policy, n, sim=sim)
        overflow += float(logs.window_saturated.sum())
        done_ticks += n
        captured.append(state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fused_winner.LAUNCHES
    measured = HEADLINE_TICKS - WARMUP_TICKS
    syncs_per_tick = (sync.HOST_READS - reads_before) / measured

    on_road = int(state.road.count.sum())
    on_way = int(state.agents.on_way.sum())
    done = int(state.agents.done.sum())
    avg_tt = float(average_travel_time(state.agents))
    if overflow != 0.0:
        raise AssertionError(f"overflow monitor read {overflow}, not 0")
    if on_road != on_way:
        raise AssertionError(f"conservation: {on_road} on roads, "
                             f"{on_way} inserted and not done")
    if done <= 0:
        raise AssertionError("no agent arrived")
    if launches != HEADLINE_TICKS:
        raise AssertionError(f"fused_winner ran {launches} times in "
                             f"{HEADLINE_TICKS} ticks")
    if not (np.isfinite(avg_tt) and avg_tt > 0):
        raise AssertionError(f"average travel time {avg_tt}")
    rate = agents.num_agents * measured / wall
    log(f"headline: {rate:.1f} agent-steps/s ({measured} ticks in "
        f"{wall:.2f} s, {wall / measured * 1e3:.3f} ms/tick), done {done}, "
        f"on roads {on_road}, average travel time {avg_tt:.3f} s, host "
        f"syncs per tick {syncs_per_tick:.3f}, overflow {overflow}, "
        f"fused_winner calls {launches}")

    # --- 2. kernel against plain ----------------------------------------
    kin, r = net.in_src_tab.shape
    cases = [
        (s.road, s.selected_road, s.time,
         rng.gumbel(rng.prng_key(1000 + i), (kin, r), dev))
        for i, s in enumerate(captured)
    ]
    err16 = compare_kernel(cases, net, physics)
    big, _ = load_scenario("Grid64x64_10", 64, 64, 10, dev)
    kin64, r64 = big.in_src_tab.shape
    big_cases = []
    for i in range(RANDOM_STATES):
        t_now = 6 * 3600.0 + 37 * i
        road64, sel64 = random_road_state(big, i, t_now)
        big_cases.append((road64, sel64, t_now,
                          rng.gumbel(rng.prng_key(2000 + i), (kin64, r64),
                                     dev)))
    err64 = compare_kernel(big_cases, big, physics)
    log(f"kernel vs plain: bitwise equal on {len(cases)} headline states "
        f"(R={r}) and {len(big_cases)} random Grid64x64 states (R={r64})")

    timings = {}
    for label, g, (road_c, sel_c, t_c, gum_c) in (
            ("Grid16x16", net, cases[len(cases) // 2]),
            ("Grid64x64", big, big_cases[0])):
        args = (road_c, sel_c, g, t_c, gum_c, physics)
        plain1 = time_per_call(fused_winner.direction_confirm_plain, args)
        kern1 = time_per_call(fused_winner.direction_confirm, args)
        kern2 = time_per_call(fused_winner.direction_confirm, args)
        plain2 = time_per_call(fused_winner.direction_confirm_plain, args)
        timings[label] = (min(kern1, kern2), min(plain1, plain2))
        log(f"fused_winner {label} (R={g.num_roads}): kernel "
            f"{kern1 * 1e3:.2f} / {kern2 * 1e3:.2f} us per call, plain "
            f"{plain1 * 1e3:.2f} / {plain2 * 1e3:.2f} us per call "
            f"(plain, kernel, kernel, plain)")

    # --- 4. the episode in context ----------------------------------------
    ref = captured[0]
    plain_state = init_sim_state(net, agents, sim=sim, policy=policy)
    launches_before = fused_winner.LAUNCHES
    plain_state, _ = run_episode(plain_state, net, policy, CAPTURE_EVERY,
                                 sim=sim,
                                 core=fused_winner.direction_confirm_plain)
    if fused_winner.LAUNCHES != launches_before:
        raise AssertionError("the plain episode launched the kernel")
    mismatched = _diff_paths(to_numpy(ref), to_numpy(plain_state))
    if mismatched:
        raise AssertionError(f"kernel and plain episodes differ at tick "
                             f"{CAPTURE_EVERY}: {mismatched}")
    log(f"episode in context: kernel and plain states equal bitwise at tick "
        f"{CAPTURE_EVERY}")

    # --- 5. results -------------------------------------------------------
    kern_ms, plain_ms = timings["Grid16x16"]
    print(json.dumps({"kernels": [{
        "name": "fused_winner",
        "route": "cuda",
        "source": "tarl_tpu_torch/csrc/fused_winner.cu",
        "replaces": "tarl_tpu/core/fused_winner.py:96",
        "launches": launches,
        "max_abs_err": float(max(err16, err64)),
        "ms": kern_ms,
        "plain_ms": plain_ms,
        "ms_grid64": timings["Grid64x64"][0],
        "plain_ms_grid64": timings["Grid64x64"][1],
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


def _diff_paths(a, b, path="state") -> list[str]:
    """Paths of the nested numpy dicts at which ``a`` and ``b`` differ in
    dtype, shape or any element."""
    import numpy as np

    if isinstance(a, dict):
        out = []
        for k in a:
            out += _diff_paths(a[k], b[k], f"{path}.{k}")
        return out
    if a is None or b is None:
        return [] if a is None and b is None else [path]
    a, b = np.asarray(a), np.asarray(b)
    same = a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    return [] if same else [path]


if __name__ == "__main__":
    sys.exit(main())
