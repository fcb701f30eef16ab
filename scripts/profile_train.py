"""Where the time of a PPO training iteration goes, on one GPU.

Runs ``PPO.train_iteration`` at ``chip_smoke.py`` phase 21's configuration
(the builtin Grid8x8 scenario, the committed weights, 256 collection
steps, 5 epochs of 2 minibatches of 128) and reports, after
``--warmup`` iterations:

1. per iteration, the collection, GAE and the update, from CUDA events
   recorded at their boundaries (no synchronisation inside), beside the
   iteration's host time;
2. as many iterations with the update's pieces each wrapped in
   ``torch.cuda.synchronize()``: the loss's forward, the backward and
   Adam's step, per update;
3. ``torch.profiler`` over one iteration: device time, device kernels and
   the device's idle share, for the whole iteration and for the update
   alone, and the largest device items.

    python3 scripts/profile_train.py [--iterations 3] [--warmup 1]
        [--root DIR]

``--root`` imports ``tarl_tpu_torch`` from another checkout (an unpacked
``git archive`` under ``build/``), so that two trees are measured in turns
within one call.  A tree without ``PPO.train_iteration`` gets its
collection timed alone.  Needs an NVIDIA GPU; prints the card's name and
power limit first.
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
    ap.add_argument("--iterations", type=int, default=3)
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--root", default=HERE)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_train: needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    from tarl_tpu_torch.config import RLConfig
    from tarl_tpu_torch.convert import load_params_npz, mpnn_params_from_numpy
    from tarl_tpu_torch.core import rng, sync
    from tarl_tpu_torch.core.step import Policy, init_sim_state
    from tarl_tpu_torch.io.matsim import load_network, load_population
    from tarl_tpu_torch.io.scenarios import ensure_scenario
    from tarl_tpu_torch.models.mpnn import MPNNPolicyNet, MPNNValueNetSimple
    from tarl_tpu_torch.rl.ppo import PPO
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
    rl = RLConfig(rollout_steps=256, minibatch_size=128, num_epochs=5,
                  entropy_coef=0.003, learning_rate=1e-3,
                  reward_mode="progress", gamma=0.98, gae_lambda=0.9)
    ppo = PPO(net, MPNNPolicyNet(net.num_nodes, net.num_roads + 1,
                                 use_distance_prior=True, prior_scale=30.0),
              MPNNValueNetSimple(net.num_nodes), rl=rl)
    params = mpnn_params_from_numpy(load_params_npz(os.path.join(
        root, "tarl_tpu_torch", "weights", "grid8x8_mpnn_best.npz")),
        device=dev)
    ts = ppo.init(st, rng.prng_key(0), torch.Generator().manual_seed(0))
    if not hasattr(ppo, "train_iteration"):
        return collection_only(args, card, ppo, ts, params)
    ts = ts._replace(params=params, opt_state=ppo.optimizer.init(params))
    for _ in range(args.warmup):
        ts, _ = ppo.train_iteration(ts)
    torch.cuda.synchronize()

    # 1. the split, from CUDA events at the boundaries
    marks = {}

    def event():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def wrap(name, fn):
        def run(*a, **k):
            marks[f"{name}0"] = event()
            out = fn(*a, **k)
            marks[f"{name}1"] = event()
            return out
        return run

    collect, update = ppo.collect_rollout, ppo._update_epochs
    ppo.collect_rollout = wrap("collect", collect)
    ppo._update_epochs = wrap("update", update)
    rows = []
    for _ in range(args.iterations):
        reads = sync.HOST_READS
        t0 = time.perf_counter()
        ts, _ = ppo.train_iteration(ts)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        rows.append((marks["collect0"].elapsed_time(marks["collect1"]),
                     marks["collect1"].elapsed_time(marks["update0"]),
                     marks["update0"].elapsed_time(marks["update1"]), wall,
                     sync.HOST_READS - reads))
    ppo.collect_rollout, ppo._update_epochs = collect, update
    steps, updates = rl.rollout_steps, rl.num_epochs * 2
    for i, (c, g, u, wall, reads) in enumerate(rows, 1):
        print(f"iteration {i} ({card}): collection {c:.3f} ms "
              f"({c / steps:.3f} ms/step), GAE {g:.3f} ms, update {u:.3f} ms "
              f"({u / updates:.3f} ms per update), iteration {wall:.3f} ms "
              f"(host clock), host reads {reads}", flush=True)

    # 2. the update's pieces, each synchronised
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

    loss_and_grads, loss, step = (ppo._loss_and_grads, ppo._loss,
                                  ppo.optimizer.update)
    ppo._loss_and_grads = timed("loss and gradients", loss_and_grads)
    ppo._loss = timed("forward (the loss)", loss)
    ppo.optimizer.update = timed("step (Adam)", step)
    for i in range(args.iterations):
        spent.clear()
        ts, _ = ppo.train_iteration(ts)
        fwd = spent["forward (the loss)"]
        print(f"update pieces, synchronised, iteration {i + 1} ({card}): "
              f"forward {fwd / updates * 1e3:.3f} ms, backward "
              f"{(spent['loss and gradients'] - fwd) / updates * 1e3:.3f} "
              f"ms, step {spent['step (Adam)'] / updates * 1e3:.3f} ms per "
              f"update", flush=True)
    ppo._loss_and_grads, ppo._loss = loss_and_grads, loss
    ppo.optimizer.update = step

    # 3. the profiler over one iteration, and over the update alone
    state = [ts]

    def iteration():
        state[0], _ = ppo.train_iteration(state[0])

    profile(iteration, "iteration", card)
    _, _, key, traj, last = ppo.collect_rollout(state[0].params,
                                                state[0].env, state[0].obs,
                                                state[0].key)
    from tarl_tpu_torch.rl.gae import gae, normalize

    adv, ret = gae(traj.reward, traj.value, last, traj.done, rl.gamma,
                   rl.gae_lambda)
    adv = normalize(adv)
    profile(lambda: ppo._update_epochs(state[0].params, state[0].opt_state,
                                       traj, adv, ret, key),
            "update", card)
    return 0


def profile(run, label: str, card: str) -> None:
    """``torch.profiler`` over ``run()``: wall, device time, device kernels,
    the device's idle share and the largest device items."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = collections.Counter()
    for e in events:
        by_name[e.name] += e.time_range.end - e.time_range.start
    device_us = sum(by_name.values())
    print(f"profiler, one {label} ({card}): wall {wall * 1e3:.3f} ms "
          f"(profiled), device time {device_us / 1e3:.3f} ms, "
          f"{len(events)} device kernels, device idle "
          f"{1 - device_us / 1e6 / wall:.1%}", flush=True)
    for name, us in by_name.most_common(6):
        print(f"  {us / 1e3:.3f} ms  {name[:90]}", flush=True)


def collection_only(args, card, ppo, ts, params) -> int:
    """A tree without the training path: its collection of
    ``rl.rollout_steps`` steps, timed ``--iterations`` times after
    ``--warmup``."""
    import torch

    env, obs, key = ts.env, ts.obs, ts.key
    for i in range(args.warmup + args.iterations):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        env, obs, key, _, _ = ppo.collect_rollout(params, env, obs, key)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if i >= args.warmup:
            print(f"collection {i - args.warmup + 1} ({card}, no training "
                  f"path in this tree): {ms:.3f} ms "
                  f"({ms / ppo.rl.rollout_steps:.3f} ms/step)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
