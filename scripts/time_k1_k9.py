"""Per-call time of the direction winner (K1), the road-block winner (K7),
the fused core's sampler (K12) and the segment reductions (K9-K11) on one
GPU, host and device apart, and the headline ticks (default core, fused
core, road blocks) and the learned evaluation step around them, for this
checkout or another.

    python3 scripts/time_k1_k9.py [--root DIR] [--calls 200] [--label NAME]
        [--warmup-ticks 1800] [--ticks 300] [--steps 500]

Each item is timed two ways over the same ``--calls`` back-to-back calls
after a warm-up: CUDA events around the run (the per-call time of
``chip_smoke.py``, which the host's launch path sets while the device
waits), and the device time of the kernels those calls launched, from
``torch.profiler`` (with the kernels and memsets per call).

- K1 at the headline's Grid16x16 (R = 960) and at Grid64x64 (R = 16,128)
  on a seeded random road state: the call alone and, as a tick pays it,
  with the tick's noise: where the tree's K1 takes a ``[KIN, R]`` Gumbel
  matrix, ``rng.direction_gumbel`` and then the call; where it takes the
  tick's key, the call.
- K7 at the headline's Grid16x16 over ``chip_smoke.SHARD_BLOCKS`` blocks
  on a seeded random road state, built as the sharded tick builds its
  arguments: the call alone and, as a tick pays it, with its noise: where
  the tree's K7 takes a ``[KIN, n]`` Gumbel matrix,
  ``rng.direction_gumbel``, the blocks' columns of it and then the call;
  where it takes the tick's key, the call.
- K12 at the headline's Grid16x16 on the same state: as a tick pays it
  (where the tree has ``fused_core_sample``, that one launch; else the
  fused core step's eligibility and logits over the edge list, then
  ``gumbel_argmax_payload``), and the bare ``gumbel_argmax_payload`` on
  those logits.
- K9-K11 at the learned path's Grid8x8 shape (``network.full_src``, E =
  1,256, N = 352) with a kept layout, beside ``index_add_`` into
  ``torch.zeros`` (the sum) and ``scatter_reduce`` amax into a filled row
  (the max).  The learned step's action as it pays it,
  ``GraphDistribution.mode()`` and ``.sample(key)`` on the same logits,
  in whichever form the tree has (the parent's: the division, the draw,
  K11 and the hot scatter; the action entry's: one launch of K11),
  and, where the tree has it, ``segment_action`` itself in both modes.
  The collection step's log-prob as it pays it,
  ``GraphDistribution.log_prob(action)`` of the sample's action and
  ``.log_probs()``, in whichever form the tree has (the parent's: the
  scale, K10, K9 three times and the steps between; K10's entry: one
  launch and a memset, then ``torch.sum`` and ``masked_fill_``), and,
  where the tree has it, the entry itself (``segment_log_prob``,
  ``segment_log_probs``).
- The relax (K2) at the sp row's shape (Grid64x64, I = D = 4,096, 8
  sweeps): K2 mode and relax only from a random-cost warm start (every
  sweep lowers something) and K2 mode from the host Dijkstra's free-flow
  table at free flow, as the tree's ``primal_relax_next_roads`` runs them;
  where the tree has ``resident_plan``, also each form forced (the plan
  patched): K2 mode and relax only at 8 sweeps and relax only at one
  sweep, resident and global.
- The relax past 4,096 rows (the TPU's K3 and K5) on the Grid128x128
  network (I = 16,384, ``chip_smoke.load_scenario``'s XML) with 256
  seeded destination columns (the million-agent row's shape) and with 512
  (``chip_smoke.BIG_DESTS``), from a random warm start, 8 sweeps with
  and without the next roads: as the tree's ``primal_relax_next_roads``
  runs them and, where the tree has ``cluster_plan``, the cluster form
  at the full tile width of 7 and the global form
  (``chip_smoke.forced_relax``).
- The relax's global form (the TPU's K6), as the tree's
  ``primal_relax_next_roads`` runs it: at the radial metro's shape
  (``chip_smoke.radial_scenario_on``: I = 8,193 intersections of K = 8
  out-slots, the population's destination columns) 8 sweeps with and
  without the next roads from a refresh's warm start (random costs over
  the free-flow table, ``policies._warm_start``), the uncapped table init
  from the cold start, and from the cold start (where every sweep lowers
  something) 1, 2, 4, 8 and 16 sweeps and 8 with the next roads, at the
  population's D and at D rounded down to a multiple of 4; and one sweep
  at I = D = 4,096 (Grid64x64) from a random warm start.
- The headline tick (``chip_smoke.py`` phase 2's episode) with the
  default core, with the fused core (phase 13) and on
  ``chip_smoke.SHARD_BLOCKS`` road blocks (phase 17, from the default
  core's warm state: the states are equal bitwise): ms/tick over
  ``--ticks`` ticks after ``--warmup-ticks``, ending in a synchronise.  The learned evaluation (phase 8's Grid8x8 policy with the
  trained weights): ms/step over ``--steps`` greedy steps from the start,
  after an untimed run of 100.

``--root`` imports ``tarl_tpu_torch`` from another checkout (the timing
helpers stay this checkout's ``chip_smoke.py``), such as an unpacked
``git archive`` of an earlier commit under ``build/``, so that two trees
are timed in turns within one call (parent, change, change, parent).
Prints the card's name and power limit, one line per item, and a JSON
line last.  Needs an NVIDIA GPU.
"""
from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--calls", type=int, default=200)
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--warmup-ticks", type=int, default=1800)
    ap.add_argument("--ticks", type=int, default=300)
    ap.add_argument("--steps", type=int, default=500)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_k1_k9: needs an NVIDIA GPU")
    # This checkout's chip_smoke.py for the timing helpers; its helpers
    # import tarl_tpu_torch from --root.
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    from tarl_tpu_torch.config import DEFAULT_PHYSICS
    from tarl_tpu_torch.convert import load_params_npz, mpnn_params_from_numpy
    from tarl_tpu_torch.core import fused_winner, rng
    from tarl_tpu_torch.core.step import Policy, init_sim_state, run_episode
    from tarl_tpu_torch.io.matsim import load_network, load_population
    from tarl_tpu_torch.io.scenarios import ensure_scenario
    from tarl_tpu_torch.ops import segment as seg
    from tarl_tpu_torch.parallel.shard_map_episode import (
        make_road_mesh, run_episode_shard_map)
    from tarl_tpu_torch.routing.policies import random_choice
    from tarl_tpu_torch.state import sort_agents_by_departure

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; tree {args.label} ({root})", flush=True)
    dev = torch.device("cuda", 0)
    calls = args.calls
    takes_key = "key" in inspect.signature(
        fused_winner.direction_confirm).parameters
    out = {"label": args.label, "card": card, "k1_takes_key": takes_key}

    def record(name, fn):
        ev_ms = chip_smoke.time_per_call(fn, (), calls)
        dev_ms, acts = chip_smoke.device_time_per_call(fn, (), calls)
        out[name] = {"event_us": ev_ms * 1e3,
                     "device_us": None if dev_ms is None else dev_ms * 1e3,
                     "device_activities_per_call": acts}
        print(f"{name}: {ev_ms * 1e3:.2f} us per call (CUDA events), device "
              f"{chip_smoke.fmt_us(dev_ms)} per call in {acts:.1f} kernels "
              f"or memsets ({card}; {args.label})", flush=True)

    def wall(run) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for label, rows in (("grid16", 16), ("grid64", 64)):
        net = chip_smoke.grid_network(rows, rows, dev)
        t_now = 6 * 3600.0 + 17
        road, sel = chip_smoke.random_road_state(net, rows, t_now)
        key = rng.prng_key(rows)
        if takes_key:
            def call(road=road, sel=sel, net=net, key=key):
                return fused_winner.direction_confirm(
                    road, sel, net, t_now, key, DEFAULT_PHYSICS)
            tick = call
        else:
            gumbel = rng.direction_gumbel(key, net)

            def call(road=road, sel=sel, net=net, gumbel=gumbel):
                return fused_winner.direction_confirm(
                    road, sel, net, t_now, gumbel, DEFAULT_PHYSICS)

            def tick(road=road, sel=sel, net=net, key=key):
                return fused_winner.direction_confirm(
                    road, sel, net, t_now, rng.direction_gumbel(key, net),
                    DEFAULT_PHYSICS)
        record(f"k1_{label}", call)
        record(f"k1_with_noise_{label}", tick)

    time_k7_k12(record, chip_smoke, dev, out)

    base = ensure_scenario(os.path.join(root, "build", "scenarios"),
                           "Grid8x8")
    net8 = load_network(os.path.join(base, "network"), device=dev)
    ids, n = net8.full_src, net8.num_nodes
    g = torch.Generator(device="cpu").manual_seed(8)
    data = torch.randn(ids.shape[0], generator=g).to(dev)
    expd = torch.exp(data - data.max())
    layout = seg.segment_layout(ids, n)
    key_l = ids.long()
    out["shape"] = f"E={ids.shape[0]}, N={n}"
    record("k9", lambda: seg.segment_sum(expd, ids, n, layout))
    record("index_add", lambda: torch.zeros(n, device=dev).index_add_(
        0, key_l, expd))
    record("k10", lambda: seg.segment_max(data, ids, n, layout))
    record("scatter_reduce_amax", lambda: torch.full(
        (n,), seg.NEG_LARGE, device=dev).scatter_reduce_(0, key_l, data,
                                                         "amax"))
    record("k11", lambda: seg.segment_argmax(data, ids, n, layout))
    from tarl_tpu_torch.rl.distribution import GraphDistribution

    dist = GraphDistribution(data, ids, n, layout=layout)
    key8 = rng.prng_key(8)
    record("dist_mode", dist.mode)
    record("dist_sample", lambda: dist.sample(key8))
    if hasattr(seg, "segment_action"):
        record("k11_action_mode",
               lambda: seg.segment_action(data, ids, n, layout))
        record("k11_action_sample",
               lambda: seg.segment_action(data, ids, n, layout, 1.0, key8))
    action = dist.sample(key8)
    record("dist_log_prob", lambda: dist.log_prob(action))
    record("dist_log_probs", dist.log_probs)
    if hasattr(seg, "segment_log_prob"):
        record("k10_log_prob", lambda: seg.segment_log_prob(
            data, action, ids, n, layout))
        record("k10_log_probs",
               lambda: seg.segment_log_probs(data, ids, n, layout))
    time_k2(record, chip_smoke, dev, out)
    time_k3_k5(record, chip_smoke, dev, out)
    time_k6(record, chip_smoke, dev, out)

    net16, agents16 = chip_smoke.load_scenario("Grid16x16_50000", 16, 16,
                                               50000, dev)
    agents16 = sort_agents_by_departure(agents16)
    sim = chip_smoke.headline_sim()
    policy = Policy(choice=random_choice)
    state = init_sim_state(net16, agents16, sim=sim, policy=policy)
    state, _ = run_episode(state, net16, policy, args.warmup_ticks, sim=sim)
    sim_fc = chip_smoke.headline_sim(fused_core=True)
    state_fc = init_sim_state(net16, agents16, sim=sim_fc, policy=policy)
    state_fc, _ = run_episode(state_fc, net16, policy, args.warmup_ticks,
                              sim=sim_fc)
    mesh = make_road_mesh(chip_smoke.SHARD_BLOCKS, dev)
    runs = (
        ("headline", "default core", lambda: run_episode(
            state, net16, policy, args.ticks, sim=sim)),
        ("fused_core_headline", "fused core", lambda: run_episode(
            state_fc, net16, policy, args.ticks, sim=sim_fc)),
        ("sharded_headline", f"{chip_smoke.SHARD_BLOCKS} road blocks",
         lambda: run_episode_shard_map(state, net16, policy, args.ticks,
                                       mesh, sim=sim)),
    )
    for name, what, run in runs:
        ms = wall(run) / args.ticks * 1e3
        out[f"{name}_ms_per_tick"] = ms
        print(f"headline tick ({what}), ticks {args.warmup_ticks}-"
              f"{args.warmup_ticks + args.ticks}: {ms:.3f} ms/tick ({card}; "
              f"{args.label})", flush=True)

    agents8, _ = load_population(os.path.join(base, "population"),
                                 os.path.join(base, "network"), device=dev)
    st8 = init_sim_state(net8, agents8, policy=policy)
    ppo = chip_smoke.learned_ppo(net8)
    trained = mpnn_params_from_numpy(load_params_npz(
        os.path.join(root, chip_smoke.WEIGHTS)), device=dev)
    ppo.eval_rollout(trained, st8, rng.prng_key(0), 100)
    ms = wall(lambda: ppo.eval_rollout(trained, st8, rng.prng_key(0),
                                       args.steps)) / args.steps * 1e3
    out["learned_ms_per_step"] = ms
    print(f"learned eval (Grid8x8, trained), steps 0-{args.steps}: "
          f"{ms:.3f} ms/step ({card}; {args.label})", flush=True)
    print(json.dumps(out), flush=True)
    return 0


def time_k2(record, chip_smoke, dev, out) -> None:
    """The relax at the sp row's shape (see the module docstring)."""
    import torch

    from tarl_tpu_torch.routing import bellman_ford as bf
    from tarl_tpu_torch.routing import policies

    net = chip_smoke.grid_network(64, 64, dev)
    _, cost, tabs, warm = chip_smoke.grid64_relax_cases(net, [], seeds=1)[0]
    ff = net.free_flow
    fixed = torch.as_tensor(policies._host_dijkstra(net), device=dev)
    record("k2_mode_random_warm",
           lambda: bf.primal_relax_next_roads(cost, *tabs, warm, 8))
    record("k2_relax_only_random_warm",
           lambda: bf.primal_relax_next_roads(cost, *tabs, warm, 8, True))
    record("k2_mode_free_flow_table",
           lambda: bf.primal_relax_next_roads(ff, *tabs, fixed, 8))
    if hasattr(bf, "resident_plan"):
        plan = bf.resident_plan
        forced = {"resident": lambda i_n, d_n, k_n, it: min(8, d_n),
                  "global": lambda *shape: None}
        try:
            for form, rule in forced.items():
                bf.resident_plan = rule
                for label, it, only in (("mode", 8, False),
                                        ("relax_only", 8, True),
                                        ("relax_only_1_sweep", 1, True)):
                    def call(it=it, only=only):
                        return bf.primal_relax_next_roads(cost, *tabs, warm,
                                                          it, only)
                    record(f"k2_{form}_{label}_random_warm", call)
        finally:
            bf.resident_plan = plan
    out["k2_shape"] = (f"I=D={net.num_intersections}, "
                       f"K={tabs[0].shape[1]}, 8 sweeps")


def time_k3_k5(record, chip_smoke, dev, out) -> None:
    """The relax past 4,096 rows (see the module docstring)."""
    from tarl_tpu_torch.routing import bellman_ford as bf

    net, _ = chip_smoke.load_scenario("Grid128x128_10", 128, 128, 10, dev)
    has_cluster = hasattr(bf, "cluster_plan")
    for dests in (256, chip_smoke.BIG_DESTS):
        _, cost, tabs, warm = chip_smoke.big_dest_cases(net, dests)[1]
        for label, only in (("k3_mode", False), ("k5_relax_only", True)):
            def call(only=only):
                return bf.primal_relax_next_roads(cost, *tabs, warm, 8, only)
            record(f"{label}_d{dests}", call)
            if has_cluster:
                for form in ("full width", "global"):
                    with chip_smoke.forced_relax(form):
                        record(f"{label}_d{dests}_{form.replace(' ', '_')}",
                               call)
    if has_cluster:
        i_n, k_n = tabs[0].shape
        plan = bf.cluster_plan(i_n, 256, k_n, 8)
        fit = bf._cluster_fit(dev, i_n, k_n, plan[1])
        out["k3_k5_clusters_at_once"] = fit
        print(f"cluster form at I={i_n}: clusters of {plan[1]} blocks, "
              f"{fit} at once on the card; tile widths D=256 "
              f"{bf.cluster_plan(i_n, 256, k_n, 8, fit)[0]}, D=512 "
              f"{bf.cluster_plan(i_n, 512, k_n, 8, fit)[0]}", flush=True)
    out["k3_k5_shape"] = (f"I={net.num_intersections}, D=256 and "
                          f"{chip_smoke.BIG_DESTS}, K={tabs[0].shape[1]}, "
                          f"8 sweeps, random warm start")


def time_k6(record, chip_smoke, dev, out) -> None:
    """The relax's global form (see the module docstring)."""
    import numpy as np
    import torch

    from tarl_tpu_torch.routing import bellman_ford as bf
    from tarl_tpu_torch.routing import policies

    net, _, dest, _ = chip_smoke.radial_scenario_on(dev)
    tabs = chip_smoke.relax_tables(net)
    i_n, d_n = net.num_intersections, len(dest)
    anchor = (torch.arange(i_n, device=dev)[:, None]
              == torch.as_tensor(dest, device=dev).long()[None, :])
    cold = torch.where(anchor, 0.0, bf.BIG).contiguous()
    ff = net.free_flow
    ff_dist = bf.primal_relax_next_roads_plain(ff, *tabs, cold, None,
                                               True)[0]
    g = np.random.default_rng(6)
    cost = ff * torch.as_tensor(
        g.uniform(1.0, 4.0, net.num_roads).astype(np.float32), device=dev)
    warm = torch.where(anchor, 0.0, policies._warm_start(ff_dist, ff, cost))
    record("k6_radial_refresh",
           lambda: bf.primal_relax_next_roads(cost, *tabs, warm, 8))
    record("k6_radial_refresh_relax_only",
           lambda: bf.primal_relax_next_roads(cost, *tabs, warm, 8, True))
    record("k6_radial_table_init",
           lambda: bf.primal_relax_next_roads(ff, *tabs, cold, None))
    # From the cold start every one of the first ~170 sweeps lowers
    # something: the time per sweep and of the next roads, at the
    # population's D and at a multiple of 4 columns.
    for cols in (d_n, d_n // 4 * 4):
        c0 = cold[:, :cols].contiguous()
        for n in (1, 2, 4, 8, 16):
            record(f"k6_radial_cold_d{cols}_{n}_sweeps",
                   lambda n=n, c0=c0: bf.primal_relax_next_roads(
                       ff, *tabs, c0, n, True))
        record(f"k6_radial_cold_d{cols}_8_sweeps_next_roads",
               lambda c0=c0: bf.primal_relax_next_roads(ff, *tabs, c0, 8))
    net64 = chip_smoke.grid_network(64, 64, dev)
    _, c64, tabs64, w64 = chip_smoke.grid64_relax_cases(net64, [],
                                                        seeds=1)[0]
    record("k6_grid64_one_sweep",
           lambda: bf.primal_relax_next_roads(c64, *tabs64, w64, 1, True))
    out["k6_shape"] = (f"radial I={i_n}, D={d_n}, K={tabs[0].shape[1]}; "
                       "Grid64x64 I=D=4096, K=4")


def time_k7_k12(record, chip_smoke, dev, out) -> None:
    """K7 and K12 at the headline's Grid16x16 on one seeded random road
    state, in whichever form the tree under test has (see the module
    docstring)."""
    import torch

    from tarl_tpu_torch.config import DEFAULT_PHYSICS as physics
    from tarl_tpu_torch.core import fused_core, fused_winner, rng
    from tarl_tpu_torch.core.direction import (pack_upstream,
                                               upstream_pack_layout)

    net = chip_smoke.grid_network(16, 16, dev)
    t_now = 6 * 3600.0 + 17
    road, sel = chip_smoke.random_road_state(net, 160, t_now)
    key = rng.prng_key(160)
    r, nmax = net.num_roads, net.nmax
    blocks = chip_smoke.SHARD_BLOCKS
    rp = -(-r // blocks) * blocks

    def pad(x, fill):
        tail = torch.full((rp - r,) + tuple(x.shape[1:]), fill,
                          dtype=x.dtype, device=dev)
        return torch.cat([x, tail])

    def cols(x, fill):
        return pad(x.t(), fill).t().contiguous()

    s = sel[:r]
    sel_enc = pad(torch.where((s >= 0) & (s < r), s, r), r)
    count = pad(road.count, 0)
    cap = pad(net.capacity, 0.0)
    pack = pack_upstream(pad(road.head_departure(), 0.0), count, cap,
                         sel_enc, t_now, physics, r, nmax)
    halo = (pack, pad(road.head_ids(), 0), pad(road.head_dests(), 0))
    tail = (0, rp, physics, upstream_pack_layout(r, nmax))
    count_f = count.to(torch.float32)
    src, logit, ok = (cols(net.in_src_tab, 0), cols(net.in_logit_tab, 0.0),
                      cols(net.in_edge_ok, False))
    if hasattr(fused_winner, "ShardTables"):
        tables = fused_winner.ShardTables(in_src=src, in_logit=logit,
                                          in_ok=ok, capacity=cap,
                                          road_order=net.road_order)

        def k7():
            return fused_winner.fused_shard_winner(*halo, key, tables,
                                                   count_f, *tail)
        k7_tick = k7
    else:
        gumbel = cols(rng.direction_gumbel(key, net), 0.0)

        def k7():
            return fused_winner.fused_shard_winner(
                *halo, gumbel, logit, src, ok, count_f, cap, *tail)

        def k7_tick():
            return fused_winner.fused_shard_winner(
                *halo, cols(rng.direction_gumbel(key, net), 0.0), logit,
                src, ok, count_f, cap, *tail)
    record("k7_grid16", k7)
    record("k7_with_noise_grid16", k7_tick)

    def edge_phase():
        """The parent tree's eligibility and logits over the edge list
        (``fused_core_step`` before its fold into the kernel)."""
        u, v = net.edge_src.long(), net.edge_dst.long()
        hd_u = road.head_departure()[u]
        count_r = road.count.to(torch.float32)
        cap_r = net.capacity
        buf = physics.congestion_buffer
        cnt_u, cap_u = count_r[u], cap_r[u]
        cnt_v, cap_v = count_r[v], cap_r[v]
        wants_v = sel[:r][u] == v
        nonempty = road.count[u] > 0
        mask = (hd_u <= t_now) & (cnt_v < cap_v - buf) & wants_v & nonempty
        stuck = (hd_u - t_now) < -physics.gridlock_patience
        mask = mask | (stuck & (cap_u - buf <= cnt_u)
                       & (cap_u - cnt_u <= cap_v - cnt_v) & wants_v
                       & nonempty & (cnt_v < cap_v))
        prob = net.edge_attr * mask.to(torch.float32)
        return torch.where(prob > 0, torch.log(torch.clamp(prob, min=1e-30)),
                           float("-inf"))

    logits = edge_phase()
    payload_a = road.head_ids()[net.edge_src.long()]
    bare_args = (logits, net.edge_dst, payload_a, net.edge_src, key, r,
                 net.edge_layout)
    if hasattr(fused_core, "fused_core_sample"):
        def k12_tick():
            return fused_core.fused_core_sample(road, sel, net, t_now, key,
                                                physics)
    else:
        def k12_tick():
            return fused_core.gumbel_argmax_payload(
                edge_phase(), net.edge_dst, road.head_ids()[
                    net.edge_src.long()], net.edge_src, key, r,
                net.edge_layout)
    record("k12_tick_grid16", k12_tick)
    record("k12_bare_grid16",
           lambda: fused_core.gumbel_argmax_payload(*bare_args))
    out["k7_k12_shape"] = (f"R={r}, {blocks} blocks for K7; E="
                           f"{net.edge_src.shape[0]} for K12")


if __name__ == "__main__":
    raise SystemExit(main())
