#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits nonzero; nothing is caught):

1. Card: name and power limit (``nvidia-smi``), torch and CUDA versions;
   build the CUDA kernels from ``tarl_tpu_torch/csrc`` (``fused_winner``
   and ``primal_relax``, one nvcc each, started together) and time the
   builds.
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
6. The shortest-path row (``bench.py``'s second row) on the port:
   Grid64x64, 200,000 agents departing over 06:00-08:00, departure-sorted,
   ``make_policy("dijkstra", RoutingConfig(refresh_rate=10,
   max_bf_iters=8, backend="primal"))``, windowed insert W=1024, withdraw
   depth 2, no escalation, 1,020 ticks of ``run_episode_periodic`` timed
   after two warm-up periods.  Asserts conservation, arrivals, a finite
   table with a road for every pair, the relax kernel on each of the 102
   refreshes (the initial table's next-road pass counted apart) and K1 on
   every tick; prints agent-steps/s, ms/tick, ms per refresh (CUDA
   events), the saturation monitor and host reads per tick.
7. Relax kernel against plain, bitwise on distances and next roads: K2
   mode (8 sweeps + next road) on the refresh inputs captured at every
   20th refresh of phase 6, on 5 seeded random-cost Grid64x64 warm starts
   and on one tie-heavy cold start (every road at free flow); relax-only
   at 8 sweeps (K4's function) and at 1 (K6's) on the same inputs;
   uncapped from the cold start on the Grid16x16 network (the device path
   of ``primal_table_init``); and Grid128x128 with 512 seeded destination
   columns at 8 sweeps in both modes (the size at which the TPU needed
   the row-blocked K3/K5).  Times K2 mode and one sweep at Grid64x64,
   plain, kernel, kernel, plain.
8. The row in context: the first 200 ticks of phase 6 again with the
   plain relax, from the same initial state; the state at tick 200
   (packed routing table included) must equal the kernel run's bitwise,
   and the relax kernel must not run.  Prints ms/tick over ticks 20-200
   of both runs.
5. Last: a JSON line of the kernels (``fused_winner``, ``primal_relax``),
   the card's name and power limit, then ``{"ok": true, "device":
   {...}}``.

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
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
KERNELS = ("fused_winner", "primal_relax")
HEADLINE_TICKS = 7200
WARMUP_TICKS = 64
CAPTURE_EVERY = 600
RANDOM_STATES = 20
TIMED_CALLS = 200
SP_TICKS = 1020
SP_WARMUP_TICKS = 20
SP_CONTEXT_TICKS = 200
SP_CAPTURE_EVERY = 20        # refreshes
SP_RANDOM_STATES = 5
RELAX_TIMED_CALLS = 20
BIG_DESTS = 512


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


def build_kernels() -> dict:
    """Build every kernel library in parallel; seconds per kernel."""
    from tarl_tpu_torch import _build

    def one(name):
        t0 = time.perf_counter()
        _build.load_library(name)
        return time.perf_counter() - t0

    with ThreadPoolExecutor(len(KERNELS)) as pool:
        return dict(zip(KERNELS, pool.map(one, KERNELS)))


def sp_row_config():
    """``bench.py``'s shortest-path row: ``(RoutingConfig, SimConfig)``."""
    from tarl_tpu_torch.config import RoutingConfig, SimConfig

    routing = RoutingConfig(refresh_rate=10, max_bf_iters=8,
                            backend="primal")
    sim = SimConfig(timestep=1, start_time=6 * 3600,
                    record_road_optimality=False, insert_window=1024,
                    withdraw_depth=2, sorted_population=True,
                    insert_escalate=False, withdraw_escalate=False)
    return routing, sim


def sp_row(net, agents, ticks=SP_TICKS, warmup=SP_WARMUP_TICKS,
           context=SP_CONTEXT_TICKS, capture_every=SP_CAPTURE_EVERY):
    """Phase 6: the shortest-path row through ``make_policy`` and
    ``run_episode_periodic``.  Launch counts are reset just before the
    initial table is built.  Returns a dict of results, with the initial
    state, the state at tick ``context`` and the relax inputs (cost, warm
    start) of every ``capture_every``-th refresh."""
    import torch

    from tarl_tpu_torch.core import fused_winner, sync
    from tarl_tpu_torch.core.step import init_sim_state, run_episode_periodic
    from tarl_tpu_torch.routing import bellman_ford as bf
    from tarl_tpu_torch.simulator import make_policy

    routing, sim = sp_row_config()
    on_card = net.device.type == "cuda"
    captured = []

    def capturing_relax(cost, out_r, ok, road_to, dist0, max_iters,
                        relax_only=False):
        if len(refresh_events) % capture_every == 0:
            captured.append((cost, dist0))   # fresh tensors, never written
        return bf.primal_relax_next_roads(cost, out_r, ok, road_to, dist0,
                                          max_iters, relax_only)

    policy = make_policy("dijkstra", routing, network=net,
                         relax=capturing_relax)
    refresh_events = []
    refresh = policy.refresh

    def timed_refresh(state, network):
        if not on_card:
            buf = refresh(state, network)
            refresh_events.append(None)
            return buf
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        buf = refresh(state, network)
        ev[1].record()
        refresh_events.append(ev)
        return buf

    policy = policy._replace(refresh=timed_refresh)

    def sync_dev():
        if on_card:
            torch.cuda.synchronize()

    fused_winner.reset_launches()
    bf.reset_launches()
    sync.reset()
    t0 = time.perf_counter()
    state0 = init_sim_state(net, agents, sim=sim, policy=policy)
    sync_dev()
    init_s = time.perf_counter() - t0
    init_next_road = bf.NEXT_ROAD_LAUNCHES

    state, logs = run_episode_periodic(state0, net, policy, warmup, sim=sim)
    saturated = float(logs.window_saturated.sum())
    sync_dev()
    reads_before = sync.HOST_READS
    t0 = time.perf_counter()
    state, logs = run_episode_periodic(state, net, policy, context - warmup,
                                       sim=sim)
    at_context = state
    saturated += float(logs.window_saturated.sum())
    sync_dev()
    context_wall = time.perf_counter() - t0
    state, logs = run_episode_periodic(state, net, policy, ticks - context,
                                       sim=sim)
    sync_dev()
    wall = time.perf_counter() - t0
    saturated += float(logs.window_saturated.sum())
    measured = ticks - warmup
    refresh_ms = ([a.elapsed_time(b) for a, b in refresh_events]
                  if on_card else [])
    return {
        "state0": state0, "at_context": at_context, "final": state,
        "captured": captured, "init_s": init_s, "wall": wall,
        "context_wall": context_wall,
        "measured": measured,
        "rate": agents.num_agents * measured / wall,
        "saturated": saturated,
        "reads_per_tick": (sync.HOST_READS - reads_before) / measured,
        "refreshes": len(refresh_events),
        "refresh_ms": (sum(refresh_ms) / len(refresh_ms)
                       if refresh_ms else float("nan")),
        "relax_launches": bf.LAUNCHES,
        "init_next_road_launches": init_next_road,
        "next_road_launches": bf.NEXT_ROAD_LAUNCHES,
        "winner_launches": fused_winner.LAUNCHES,
        "routing": routing, "sim": sim,
    }


def check_sp_row(res, net, ticks=SP_TICKS) -> None:
    """Phase 6's asserts on the final state and the counts."""
    import torch

    from tarl_tpu_torch.routing import policies
    from tarl_tpu_torch.routing.bellman_ford import BIG

    final = res["final"]
    on_road = int(final.road.count.sum())
    on_way = int(final.agents.on_way.sum())
    if on_road != on_way:
        raise AssertionError(f"sp row conservation: {on_road} on roads, "
                             f"{on_way} inserted and not done")
    if int(final.agents.done.sum()) <= 0:
        raise AssertionError("sp row: no agent arrived")
    i_n = net.num_intersections
    dist, cost, road = policies._primal_unpack(final.next_hop, i_n, i_n,
                                               net.num_roads)
    if not (bool(torch.isfinite(final.next_hop).all())
            and float(dist.max()) < BIG and bool((road >= 0).all())):
        raise AssertionError("sp row: routing table not finite, or a pair "
                             "without a next road")
    refreshes = ticks // res["routing"].refresh_rate
    expected = {"refreshes": refreshes, "relax_launches": refreshes,
                "init_next_road_launches": 1, "next_road_launches": 1,
                "winner_launches": ticks}
    for name, want in expected.items():
        if res[name] != want:
            raise AssertionError(f"sp row: {name} = {res[name]}, expected "
                                 f"{want}")


def _relax_bits(out):
    """The relax outputs as int32 views (bitwise comparison)."""
    import torch

    return [None if t is None else t.view(torch.int32) for t in out]


def compare_relax(cases, modes) -> float:
    """Kernel against plain on each ``(label, cost, tables, dist0)`` case in
    each ``(max_iters, relax_only)`` mode: bitwise on distances and next
    roads.  Returns the largest absolute difference (0 when all match)."""
    import torch

    from tarl_tpu_torch.routing import bellman_ford as bf

    worst = 0.0
    changed = {mode: False for mode in modes}
    for label, cost, tables, dist0 in cases:
        for iters, relax_only in modes:
            got = bf.primal_relax_next_roads(cost, *tables, dist0, iters,
                                             relax_only)
            want = bf.primal_relax_next_roads_plain(cost, *tables, dist0,
                                                    iters, relax_only)
            if dist0.device.type == "cuda":
                torch.cuda.synchronize()
            for name, a, b in zip(("dist", "next road"), got, want):
                if (a is None) != (b is None):
                    raise AssertionError(f"{label}: {name} missing")
                if a is None:
                    continue
                diff = float((a.double() - b.double()).abs().max())
                worst = max(worst, diff)
                if a.shape != b.shape or not torch.equal(*_relax_bits((a, b))):
                    raise AssertionError(
                        f"{label}, {iters} sweeps, relax_only={relax_only}: "
                        f"kernel and plain differ in {name} (max |diff| "
                        f"{diff})")
            changed[(iters, relax_only)] |= not torch.equal(got[0], dist0)
    if not all(changed.values()):
        raise AssertionError("a mode changed no input; the comparison "
                             "would be vacuous")
    return worst


def relax_tables(net):
    return (net.inter_out_road, net.inter_out_ok, net.road_to)


def grid64_relax_cases(net, captured, seeds=SP_RANDOM_STATES):
    """Phase 7's Grid64x64 inputs: the captured refresh inputs, seeded
    random costs warm-started from the free-flow table as a refresh would,
    and the tie-heavy cold start at free flow."""
    import numpy as np
    import torch

    from tarl_tpu_torch.routing import policies
    from tarl_tpu_torch.routing.bellman_ford import BIG

    tables = relax_tables(net)
    cases = [(f"refresh {j * SP_CAPTURE_EVERY}", c, tables, d)
             for j, (c, d) in enumerate(captured)]
    i_n = net.num_intersections
    ff = net.free_flow
    ff_dist = torch.as_tensor(policies._host_dijkstra(net), device=net.device)
    for seed in range(seeds):
        g = np.random.default_rng(seed)
        cost = ff * torch.as_tensor(
            g.uniform(1.0, 4.0, net.num_roads).astype(np.float32),
            device=net.device)
        dist0 = policies._warm_start(ff_dist, ff, cost)
        dist0.diagonal().fill_(0.0)
        cases.append((f"random {seed}", cost, tables, dist0))
    if not bool((ff == ff[0]).all()):
        raise AssertionError("grid roads differ in free flow: no tie case")
    cold = torch.full((i_n, i_n), BIG, device=net.device)
    cold.diagonal().fill_(0.0)
    cases.append(("ties, cold", ff.clone(), tables, cold))
    return cases


def big_dest_cases(net, dests=BIG_DESTS):
    """Phase 7's Grid128x128 inputs: ``dests`` seeded destination columns,
    random costs, from the anchored cold start and from a random warm
    start."""
    import numpy as np
    import torch

    from tarl_tpu_torch.routing.bellman_ford import BIG

    g = np.random.default_rng(128)
    i_n, dev = net.num_intersections, net.device
    cols = torch.as_tensor(np.sort(g.choice(i_n, dests, replace=False)),
                           device=dev)
    anchor = torch.arange(i_n, device=dev)[:, None] == cols[None, :]
    cost = net.free_flow * torch.as_tensor(
        g.uniform(1.0, 4.0, net.num_roads).astype(np.float32), device=dev)
    warm = torch.as_tensor(
        g.uniform(0.0, 4000.0, (i_n, dests)).astype(np.float32), device=dev)
    tables = relax_tables(net)
    return [("Grid128 cold", cost, tables,
             torch.where(anchor, 0.0, BIG).contiguous()),
            ("Grid128 warm", cost, tables,
             torch.where(anchor, 0.0, warm).contiguous())]


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
    builds = build_kernels()
    log("kernel build: " + ", ".join(f"{k} {s:.2f} s"
                                     for k, s in builds.items())
        + f", {time.perf_counter() - t0:.2f} s in all (nvcc "
        f"{' '.join(_build.ARCH_FLAGS)})")

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

    # --- 6. the shortest-path row -------------------------------------------
    t0 = time.perf_counter()
    net64, agents64 = load_scenario("Grid64x64_200000", 64, 64, 200000, dev)
    agents64 = sort_agents_by_departure(agents64)
    load_s = time.perf_counter() - t0
    sp = sp_row(net64, agents64)
    check_sp_row(sp, net64)
    final = sp["final"]
    log(f"sp row Grid64x64: {net64.num_roads} roads, "
        f"{net64.num_intersections} intersections, {agents64.num_agents} "
        f"agent rows; set-up {load_s:.1f} s scenario + {sp['init_s']:.2f} s "
        f"initial table (scipy Dijkstra + next-road kernel)")
    log(f"sp row: {sp['rate']:.1f} agent-steps/s ({sp['measured']} ticks in "
        f"{sp['wall']:.2f} s, {sp['wall'] / sp['measured'] * 1e3:.3f} "
        f"ms/tick), {sp['refresh_ms']:.3f} ms per refresh (CUDA events, "
        f"{sp['refreshes']} refreshes), done "
        f"{int(final.agents.done.sum())}, on roads "
        f"{int(final.road.count.sum())}, saturation monitor sum "
        f"{sp['saturated']}, host reads per tick "
        f"{sp['reads_per_tick']:.3f}, primal_relax calls "
        f"{sp['relax_launches']} (+{sp['init_next_road_launches']} "
        f"next-road pass of the initial table), fused_winner calls "
        f"{sp['winner_launches']}")

    # --- 7. relax kernel against plain --------------------------------------
    from tarl_tpu_torch.routing import bellman_ford as bf
    from tarl_tpu_torch.routing.bellman_ford import BIG

    iters = sp["routing"].max_bf_iters
    cases64 = grid64_relax_cases(net64, sp["captured"])
    errs = {}
    errs["K2 mode"] = compare_relax(cases64, [(iters, False)])
    errs["relax only, 8 sweeps"] = compare_relax(cases64, [(iters, True)])
    errs["relax only, 1 sweep"] = compare_relax(cases64, [(1, True)])
    cold16 = torch.full((net.num_intersections,) * 2, BIG, device=dev)
    cold16.diagonal().fill_(0.0)
    g16 = np.random.default_rng(16)
    cost16 = net.free_flow * torch.as_tensor(
        g16.uniform(1.0, 4.0, net.num_roads).astype(np.float32), device=dev)
    cases16 = [("Grid16 ties, cold", net.free_flow, relax_tables(net),
                cold16),
               ("Grid16 random, cold", cost16, relax_tables(net), cold16)]
    errs["uncapped, cold"] = compare_relax(cases16, [(None, False)])
    for _, c, tabs, d0 in cases16:
        d, _ = bf.primal_relax_next_roads(c, *tabs, d0, None)
        if float(d.max()) >= BIG:
            raise AssertionError("uncapped relax left a pair unreached")
    big, _ = load_scenario("Grid128x128_10", 128, 128, 10, dev)
    errs["Grid128, 512 dests"] = compare_relax(
        big_dest_cases(big), [(iters, False), (iters, True)])
    log(f"primal_relax vs plain: bitwise equal in every mode ("
        + "; ".join(errs) + f") on {len(cases64)} Grid64x64 inputs "
        f"({len(sp['captured'])} captured refreshes), 2 Grid16x16 and 2 "
        f"Grid128x128 (I={big.num_intersections}) inputs")

    relax_t = {}
    label, c, tabs, d0 = cases64[len(sp["captured"]) // 2]
    for mode, (n_it, only) in (("K2 mode", (iters, False)),
                               ("one sweep", (1, True))):
        args = (c, *tabs, d0, n_it, only)
        plain1 = time_per_call(bf.primal_relax_next_roads_plain, args,
                               RELAX_TIMED_CALLS)
        kern1 = time_per_call(bf.primal_relax_next_roads, args,
                              RELAX_TIMED_CALLS)
        kern2 = time_per_call(bf.primal_relax_next_roads, args,
                              RELAX_TIMED_CALLS)
        plain2 = time_per_call(bf.primal_relax_next_roads_plain, args,
                               RELAX_TIMED_CALLS)
        relax_t[mode] = (min(kern1, kern2), min(plain1, plain2))
        log(f"primal_relax Grid64x64 {mode} ({label}): kernel "
            f"{kern1:.4f} / {kern2:.4f} ms per call, plain {plain1:.4f} / "
            f"{plain2:.4f} ms per call (plain, kernel, kernel, plain)")

    # --- 8. the row in context ---------------------------------------------
    from tarl_tpu_torch.core.step import run_episode_periodic
    from tarl_tpu_torch.simulator import make_policy

    plain_policy = make_policy("dijkstra", sp["routing"], network=net64,
                               relax=bf.primal_relax_next_roads_plain)
    launches_before = bf.LAUNCHES
    plain_sp, _ = run_episode_periodic(sp["state0"], net64, plain_policy,
                                       SP_WARMUP_TICKS, sim=sp["sim"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain_sp, _ = run_episode_periodic(plain_sp, net64, plain_policy,
                                       SP_CONTEXT_TICKS - SP_WARMUP_TICKS,
                                       sim=sp["sim"])
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    if bf.LAUNCHES != launches_before:
        raise AssertionError("the plain sp episode launched the relax kernel")
    mismatched = _diff_paths(_state_bits(sp["at_context"]),
                             _state_bits(plain_sp))
    if mismatched:
        raise AssertionError(f"kernel and plain sp episodes differ at tick "
                             f"{SP_CONTEXT_TICKS}: {mismatched}")
    span = SP_CONTEXT_TICKS - SP_WARMUP_TICKS
    log(f"sp row in context: kernel and plain-relax states equal bitwise at "
        f"tick {SP_CONTEXT_TICKS}, packed table included; ticks "
        f"{SP_WARMUP_TICKS}-{SP_CONTEXT_TICKS}: kernel "
        f"{sp['context_wall'] / span * 1e3:.3f} ms/tick, plain relax "
        f"{plain_wall / span * 1e3:.3f} ms/tick")

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
        "launches_sp_row": sp["winner_launches"],
    }, {
        "name": "primal_relax",
        "route": "cuda",
        "source": "tarl_tpu_torch/csrc/primal_relax.cu",
        "replaces": "tarl_tpu/routing/bellman_ford.py:644",
        "launches": sp["relax_launches"],
        "next_road_launches": sp["next_road_launches"],
        "max_abs_err": max(errs.values()),
        "ms": relax_t["K2 mode"][0],
        "plain_ms": relax_t["K2 mode"][1],
        "ms_one_sweep": relax_t["one sweep"][0],
        "plain_ms_one_sweep": relax_t["one sweep"][1],
        "modes": list(errs),
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


def _state_bits(state) -> dict:
    """``to_numpy`` of a state with the routing scratch as raw bits."""
    from tarl_tpu_torch.convert import to_numpy

    d = to_numpy(state)
    d["next_hop"] = d["next_hop"].view("uint32")
    return d


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
