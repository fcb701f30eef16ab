"""Per-call time of the direction winner (K1) and the segment reductions
(K9-K11) on one GPU, host and device apart, and the headline tick and the
learned evaluation step around them, for this checkout or another.

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
- K9-K11 at the learned path's Grid8x8 shape (``network.full_src``, E =
  1,256, N = 352) with a kept layout, beside ``index_add_`` into
  ``torch.zeros`` (the sum) and ``scatter_reduce`` amax into a filled row
  (the max).
- The headline tick (``chip_smoke.py`` phase 2's episode, default core):
  ms/tick over ``--ticks`` ticks after ``--warmup-ticks``, ending in a
  synchronise.  The learned evaluation (phase 8's Grid8x8 policy with the
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

    net16, agents16 = chip_smoke.load_scenario("Grid16x16_50000", 16, 16,
                                               50000, dev)
    agents16 = sort_agents_by_departure(agents16)
    sim = chip_smoke.headline_sim()
    policy = Policy(choice=random_choice)
    state = init_sim_state(net16, agents16, sim=sim, policy=policy)
    state, _ = run_episode(state, net16, policy, args.warmup_ticks, sim=sim)
    ms = wall(lambda: run_episode(state, net16, policy, args.ticks,
                                  sim=sim)) / args.ticks * 1e3
    out["headline_ms_per_tick"] = ms
    print(f"headline tick (default core), ticks {args.warmup_ticks}-"
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


if __name__ == "__main__":
    raise SystemExit(main())
