"""Where the time of a learned-policy evaluation step goes, on one GPU.

Runs the greedy evaluation of the port's learned policy on the builtin
Grid8x8 scenario with the trained weights (the configuration of
``chip_smoke.py`` phase 8), step by step as ``PPO.eval_rollout`` does, and
reports for a window of steps after a warm-up:

1. a phase breakdown: each phase of the step wrapped in
   ``torch.cuda.synchronize()`` (so the sum exceeds the plain step time);
2. ``torch.profiler`` over a window of plain steps: device time per step,
   device kernels per step, the device's idle share of the wall, and the
   largest device items;
3. the plain step time over the same number of steps.

With ``--collect`` it does the same for the rollout collection (phase 9 of
``chip_smoke.py``): sampled steps of ``PPO.collect_rollout`` from
``PPO.init``'s state, ``--warmup`` steps, then ``--steps`` with every
phase synchronised (the sample, the log-prob, the value and the env
step's phases among them), ``--steps`` plain, and ``--profile-steps``
under ``torch.profiler``.

    python3 scripts/profile_learned_eval.py [--warmup 2000] [--steps 300]
        [--collect] [--root DIR]

``--root`` imports ``tarl_tpu_torch`` (and the weights) from another
checkout, such as an unpacked ``git archive`` of an earlier commit under
``build/``, so that two trees are measured in turns within one call.
Needs an NVIDIA GPU; prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import collections
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--warmup", type=int, default=2000)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--profile-steps", type=int, default=100)
    ap.add_argument("--collect", action="store_true")
    ap.add_argument("--root", default=HERE)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_learned_eval: needs an NVIDIA GPU")
    # The learned policy's matrix products in full float32 (PPO checks).
    torch.backends.cuda.matmul.allow_tf32 = False
    from tarl_tpu_torch.config import RLConfig
    from tarl_tpu_torch.convert import load_params_npz, mpnn_params_from_numpy
    from tarl_tpu_torch.core import rng
    from tarl_tpu_torch.core.fused_winner import direction_confirm
    from tarl_tpu_torch.core.step import Policy, init_sim_state
    from tarl_tpu_torch.io.matsim import load_network, load_population
    from tarl_tpu_torch.io.scenarios import ensure_scenario
    from tarl_tpu_torch.models.mpnn import MPNNPolicyNet, MPNNValueNetSimple
    from tarl_tpu_torch.ops import segment as seg
    from tarl_tpu_torch.rl import env as env_mod
    from tarl_tpu_torch.rl import ppo as ppo_mod
    from tarl_tpu_torch.routing.policies import random_choice

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; tree {root}", flush=True)
    card = f"{card}; {os.path.basename(root)}"
    dev = torch.device("cuda", 0)
    base = ensure_scenario(os.path.join(root, "build", "scenarios"),
                           "Grid8x8")
    net = load_network(os.path.join(base, "network"), device=dev)
    agents, _ = load_population(os.path.join(base, "population"),
                                os.path.join(base, "network"), device=dev)
    st = init_sim_state(net, agents, policy=Policy(choice=random_choice))
    rl = RLConfig(reward_mode="progress", gamma=0.98, gae_lambda=0.9,
                  rollout_steps=256)
    ppo = ppo_mod.PPO(net, MPNNPolicyNet(net.num_nodes, net.num_roads + 1,
                                         use_distance_prior=True,
                                         prior_scale=30.0),
                      MPNNValueNetSimple(net.num_nodes), rl=rl)
    params = mpnn_params_from_numpy(load_params_npz(os.path.join(
        root, "tarl_tpu_torch", "weights", "grid8x8_mpnn_best.npz")),
        device=dev)
    if args.collect:
        return profile_collection(args, card, ppo, st, params, env_mod)

    env, obs = env_mod.env_reset(st, net, rl, ppo.physics, ppo._dist_ff)
    key = rng.prng_key(0)

    def step(env, obs, key, ops=seg.KERNELS, core=direction_confirm):
        key, k = rng.split(key)
        action = ppo.act(params, env, obs, k, True, ops)
        env, obs, *_ = env_mod.env_step(env, action, net, rl, ppo.sim_cfg,
                                        ppo.physics, dist_ff=ppo._dist_ff,
                                        core=core)
        return env, obs, key

    with torch.no_grad():
        for _ in range(args.warmup):
            env, obs, key = step(env, obs, key)
    torch.cuda.synchronize()

    # 1. phase breakdown, synchronised
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

    patches = [
        (ppo, "_context", "context (agent rows, virtual mask)"),
        (ppo, "_policy_logits", "policy MLP + distance prior"),
        (env_mod, "apply_transfers", "epilogue (apply_transfers)"),
        (env_mod, "withdraw_agents", "withdraw"),
        (env_mod, "insert_agents", "insert (whole population)"),
        (env_mod, "_phi", "progress potential Phi"),
        (env_mod, "_observe", "observation"),
    ]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    saved.append((env_mod, "ExternalChoice", env_mod.ExternalChoice))
    for obj, name, label in patches:
        setattr(obj, name, timed(label, getattr(obj, name)))
    choice_cls = saved[-1][2]
    env_mod.ExternalChoice = lambda action: timed(
        "choice (action -> selections)", choice_cls(action))
    timed_ops = seg.KERNELS._replace(
        action=timed("K11 (the action entry: the mode's argmax and "
                     "multi-hot action, via the wrapper)",
                     seg.segment_action))
    timed_core = timed("core K1 (direction_confirm, its noise drawn "
                       "inside)", direction_confirm)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        for _ in range(args.steps):
            env, obs, key = step(env, obs, key, timed_ops, timed_core)
    torch.cuda.synchronize()
    synced = (time.perf_counter() - t0) / args.steps

    for obj, name, fn in saved:
        setattr(obj, name, fn)

    # 3. plain steps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        for _ in range(args.steps):
            env, obs, key = step(env, obs, key)
    torch.cuda.synchronize()
    plain = (time.perf_counter() - t0) / args.steps

    print(f"learned eval step, Grid8x8, trained weights, steps "
          f"{args.warmup}-{args.warmup + args.steps} ({card}): "
          f"{plain * 1e3:.3f} ms/step plain, {synced * 1e3:.3f} ms/step with "
          f"every phase synchronised", flush=True)
    accounted = sum(spent.values())
    for label, s in spent.most_common():
        print(f"  {label}: {s / args.steps * 1e3:.3f} ms/step", flush=True)
    print(f"  rest (key split, clock, metrics, glue): "
          f"{(synced - accounted / args.steps) * 1e3:.3f} ms/step",
          flush=True)

    # 2. profiler
    n = args.profile_steps
    state = [env, obs, key]

    def steps():
        for _ in range(n):
            state[:] = step(*state)

    profile_steps(steps, n, card)
    return 0


def profile_steps(run, n: int, card: str) -> None:
    """``torch.profiler`` over ``run()``, ``n`` steps: the wall per step,
    the device time and device kernels per step, the device's idle share
    and the largest device items."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with torch.no_grad():
            run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = collections.Counter()
    for e in events:
        by_name[e.name] += e.time_range.end - e.time_range.start
    device_us = sum(by_name.values())
    print(f"profiler over {n} steps ({card}): wall {wall / n * 1e3:.3f} "
          f"ms/step (profiled), device time {device_us / n / 1e3:.3f} "
          f"ms/step, {len(events) / n:.1f} device kernels/step, device idle "
          f"{1 - device_us / 1e6 / wall:.1%}", flush=True)
    for name, us in by_name.most_common(8):
        print(f"  {us / n:.2f} us/step  {name[:90]}", flush=True)


def profile_collection(args, card, ppo, st, params, env_mod) -> int:
    """The ``--collect`` mode (see the module docstring): the same three
    measurements over sampled collection steps."""
    import dataclasses

    import torch

    from tarl_tpu_torch.core import rng
    from tarl_tpu_torch.rl import distribution as dist_mod

    def collect(ts_env, ts_obs, key, steps):
        ppo.rl = dataclasses.replace(ppo.rl, rollout_steps=steps)
        env, obs, key, _, _ = ppo.collect_rollout(params, ts_env, ts_obs,
                                                  key)
        return env, obs, key

    ts = ppo.init(st, rng.prng_key(0), torch.Generator().manual_seed(0))
    state = [ts.env, ts.obs, ts.key]
    state[:] = collect(*state, args.warmup)
    torch.cuda.synchronize()

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

    graph = dist_mod.GraphDistribution
    patches = [
        (ppo, "_context", "context (agent rows, virtual mask)"),
        (ppo, "_policy_logits", "policy MLP + distance prior"),
        (ppo, "_value", "value net"),
        (graph, "sample", "sample (K11's action entry)"),
        (graph, "log_prob", "log_prob (K10's entry, or the parent's "
                            "composition on K9 and K10)"),
        (env_mod, "apply_transfers", "epilogue (apply_transfers)"),
        (env_mod, "withdraw_agents", "withdraw"),
        (env_mod, "insert_agents", "insert (whole population)"),
        (env_mod, "_phi", "progress potential Phi"),
        (env_mod, "_observe", "observation"),
    ]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    for obj, name, label in patches:
        setattr(obj, name, timed(label, getattr(obj, name)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state[:] = collect(*state, args.steps)
    torch.cuda.synchronize()
    synced = (time.perf_counter() - t0) / args.steps
    for obj, name, fn in saved:
        setattr(obj, name, fn)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state[:] = collect(*state, args.steps)
    torch.cuda.synchronize()
    plain = (time.perf_counter() - t0) / args.steps
    print(f"collection step, Grid8x8, trained weights, steps "
          f"{args.warmup}-{args.warmup + args.steps} ({card}): "
          f"{plain * 1e3:.3f} ms/step plain, {synced * 1e3:.3f} ms/step with "
          f"every phase synchronised", flush=True)
    accounted = sum(spent.values())
    for label, s in spent.most_common():
        print(f"  {label}: {s / args.steps * 1e3:.3f} ms/step", flush=True)
    print(f"  rest (key split, core, clock, done reads, stacking): "
          f"{(synced - accounted / args.steps) * 1e3:.3f} ms/step",
          flush=True)

    n = args.profile_steps

    def steps():
        state[:] = collect(*state, n)

    profile_steps(steps, n, card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
