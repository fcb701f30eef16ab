"""The six multi-device checks of the reference's
``__graft_entry__.dryrun_multichip`` on the port, across processes.

:func:`dryrun_multichip` spawns ``n_ranks`` processes of one
``torch.distributed`` group (a ``FileStore`` in a fresh directory, no TCP
port), joins each with its own timeout, and returns the lines they print.
Every rank checks each path against the one-process run it computes
itself, as the reference checks its shard_map paths against the unsharded
ones, and prints one line a path:

1. ``BatchedPPO.train_step`` on a ``dp x sp`` mesh over the group (the
   reference's shape: ``sp = 2`` from 4 even ranks), ``num_envs = dp``:
   a finite loss, the rank's replicas bitwise the one-process step's and
   the parameters within twice the learning rate times the updates;
2. a sampled learned MPNN episode on road blocks (one block a rank) of a
   4x4 grid of 100 commuters: 20 ticks bitwise the serial episode;
3. the same with a Graph Transformer policy (the slot twin, each layer's
   node rows gathered over the ranks);
4. ``ShardedPPO._grads`` on node-column blocks against
   ``PPO._loss_and_grads`` on a rollout: max ``|d|`` below 1e-5, then one
   train iteration with a finite loss;
5. ``SpatialPPO.rollout``: actions and rewards bitwise
   ``PPO.collect_rollout``'s, then one iteration;
6. the transformer's ``ShardedPPO._grads``: relative difference below 1e-3
   (``|a - b| / (|a| + |b| + 1e-3)``, the reference's bar), then one
   iteration.

The scenarios are generated once, before the spawn, in the run's
directory; on the card each rank runs under deterministic algorithms.  There is no compiled-episode cache, so the reference's faults
R1 and R2 cannot occur.  ``device=None`` puts rank k on the card ``k`` mod
the cards there are; pass ``"cpu"`` on the CPU.

    python -m tarl_tpu_torch.parallel.dryrun [N_RANKS] [--backend gloo]
        [--device cpu]
"""
from __future__ import annotations

import argparse
import multiprocessing
import os
import shutil
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

STEPS = 20          # ticks of paths 2 and 3
SPAWN_TIMEOUT = 300.0


def _scenarios(root: str) -> None:
    from ..io.scenarios import grid_scenario

    grid_scenario(root, "GraftDryrun", rows=3, cols=3, num_agents=50)
    grid_scenario(root, "GraftDryrunSpatial", rows=4, cols=4,
                  num_agents=100)


def _load(base: str, dev):
    from ..core.step import Policy, init_sim_state
    from ..io.matsim import load_network, load_population
    from ..routing.policies import random_choice

    net = load_network(os.path.join(base, "network"), device=dev)
    agents, _ = load_population(os.path.join(base, "population"),
                                os.path.join(base, "network"), device=dev)
    state = init_sim_state(net, agents, policy=Policy(choice=random_choice))
    return net, state


def _same(a, b) -> bool:
    from ..convert import to_numpy

    def eq(x, y):
        if isinstance(x, dict):
            return all(eq(x[k], y[k]) for k in x)
        if x is None:
            return y is None
        x, y = np.asarray(x), np.asarray(y)
        return x.shape == y.shape and bool(np.all(
            (x == y) | (np.isnan(x) & np.isnan(y)) if x.dtype.kind == "f"
            else x == y))

    return eq(to_numpy(a), to_numpy(b))


def grad_diff(a: dict, b: dict, relative: bool = False) -> float:
    """The largest ``|a - b|`` (relative: ``|a - b| / (|a| + |b| +
    1e-3)``, the reference's bar) over two trees of tensors, parameters or
    gradients, ``{part: {name: tensor}}``."""
    worst = 0.0
    for part in a:
        for k in a[part]:
            d = (a[part][k] - b[part][k]).abs()
            if relative:
                d = d / (a[part][k].abs() + b[part][k].abs() + 1e-3)
            worst = max(worst, float(d.max()))
    return worst


def _encoding(net, dim: int, seed: int) -> np.ndarray:
    """A seeded normal node encoding, the same on every rank and in every
    run (the reference's Laplacian encoding is another basis at each call,
    fault R4, and the gradient bar's margin depends on the draw)."""
    return np.random.default_rng(seed).standard_normal(
        (net.num_nodes, dim)).astype(np.float32)


def run_paths(group, dev, root: str) -> list[str]:
    """The six paths on this rank of ``group``, tensors on ``dev``, the
    scenarios under ``root``; returns the lines, raising at the first check
    that fails."""
    from ..config import RLConfig
    from ..core import rng, step
    from ..models.mpnn import MPNNPolicyNet, MPNNValueNetSimple
    from ..models.transformer.agent import (
        TransformerRoutePolicy,
        TransformerValueNet,
    )
    from ..rl.gae import gae, normalize
    from ..rl.learned_policy import make_learned_choice
    from ..rl.ppo import PPO, init_params
    from .mesh import make_mesh
    from .shard import BatchedPPO, replica
    from .shard_map_episode import make_road_mesh, run_episode_shard_map
    from .sharded_ppo import ShardedPPO, make_node_mesh
    from .spatial_ppo import SpatialPPO

    world, rank = dist.get_world_size(group), dist.get_rank(group)
    tag = f"rank {rank} of {world}"
    lines = []
    net, state = _load(os.path.join(root, "GraftDryrun"), dev)

    # --- 1. batched training on a dp x sp mesh over the ranks ---
    mesh = make_mesh(group=group, device=dev)
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    rl = RLConfig(rollout_steps=max(4, sp * 2), minibatch_size=8,
                  num_epochs=1)
    ppo = PPO(net, MPNNPolicyNet(net.num_nodes, net.num_roads + 1),
              MPNNValueNetSimple(net.num_nodes), rl=rl)
    runs = {}
    for name, m in (("ranks", mesh), ("one", make_mesh(1, device=dev))):
        bp = BatchedPPO(ppo, m, num_envs=dp)
        ts = bp.init(state, rng.prng_key(0), torch.Generator().manual_seed(0))
        runs[name] = (bp, *bp.train_step(ts))
    bp, ts1, metrics = runs["ranks"]
    _, want, _ = runs["one"]
    loss = float(metrics.loss_total)
    updates = rl.num_epochs * bp.num_minibatches
    worst = grad_diff(ts1.params, want.params)
    same = all(_same(replica(ts1.envs, j), replica(want.envs, i))
               for j, i in enumerate(bp.replicas))
    if not (np.isfinite(loss) and same
            and worst <= 2 * rl.learning_rate * updates):
        raise AssertionError(f"path 1 ({tag}): loss {loss}, replicas equal "
                             f"{same}, parameters within {worst}")
    lines.append(f"dryrun_multichip OK on {tag} (mesh dp={dp} sp={sp}, "
                 f"replicas {bp.replicas.start}-{bp.replicas.stop - 1}): "
                 f"loss={loss:.4f}, the one-process step's replicas bitwise, "
                 f"parameters within {worst:.2e}")

    # --- 2./3. learned episodes on road blocks ---
    net2, state2 = _load(os.path.join(root, "GraftDryrunSpatial"), dev)
    road_mesh = make_road_mesh(world, dev, group=group)
    pnet = MPNNPolicyNet(net2.num_nodes, net2.num_roads + 1)
    pe2 = _encoding(net2, 8, seed=2)
    tnet = TransformerRoutePolicy(pe2, hidden_dim=8, num_layers=2,
                                  num_heads=2)
    for label, module, seed in (("spatial", pnet, 2),
                                ("attention", tnet, 3)):
        params = {k: v.to(dev) for k, v in init_params(
            module, torch.Generator().manual_seed(seed)).items()}
        policy = make_learned_choice(module, params, net2)
        want2, _ = step.run_episode(state2, net2, policy, STEPS)
        got2, _ = run_episode_shard_map(state2, net2, policy, STEPS,
                                        road_mesh)
        if not _same(want2, got2):
            raise AssertionError(f"path {label} ({tag}): the road blocks' "
                                 f"episode differs from the serial one")
        what = ("learned MPNN policy, edge-sharded" if label == "spatial"
                else "slot-twin GTConv policy, per-layer all_gather halo")
        last = road_mesh.first + road_mesh.held - 1
        lines.append(f"dryrun_multichip {label} OK on {tag} (road blocks "
                     f"{road_mesh.first}-{last} of {world}, {what}, {STEPS} "
                     f"ticks bitwise-equal to the serial episode)")

    # --- 4./6. node-sharded gradients; 5. the spatial rollout ---
    node_mesh = make_node_mesh(world, dev, group=group)
    pe6 = _encoding(net, 8, seed=6)
    ppo6 = PPO(net, TransformerRoutePolicy(pe6, hidden_dim=8, num_layers=2,
                                           num_heads=2),
               TransformerValueNet(pe6, hidden_dim=8, num_layers=1,
                                   num_heads=2),
               rl=rl, value_uses_graph=True)
    for label, p, seed in (("sharded-PPO", ppo, 5),
                           ("attention-PPO", ppo6, 11)):
        relative = p is ppo6
        ts = p.init(state, rng.prng_key(seed),
                    torch.Generator().manual_seed(seed))
        _, _, _, traj, last = p.collect_rollout(ts.params, ts.env, ts.obs,
                                                ts.key)
        adv, ret = gae(traj.reward, traj.value, last, traj.done, rl.gamma,
                       rl.gae_lambda)
        adv = normalize(adv)
        _, g_ref = p._loss_and_grads(ts.params, traj, adv, ret)
        spp = ShardedPPO(p, node_mesh)
        _, g_sh = spp._grads(ts.params, traj, adv, ret)
        err = grad_diff(g_ref, g_sh, relative)
        bar = 1e-3 if relative else 1e-5
        _, m = spp.train_iteration(ts)
        loss = float(m.loss_total)
        if not (err < bar and np.isfinite(loss)):
            raise AssertionError(f"path {label} ({tag}): gradients differ "
                                 f"by {err} (bar {bar}), loss {loss}")
        lines.append(f"dryrun_multichip {label} OK on {tag} (node-column "
                     f"blocks {node_mesh.first}-"
                     f"{node_mesh.first + node_mesh.held - 1} of {world}, "
                     f"max {'relative ' if relative else ''}|grad diff| vs "
                     f"unsharded = {err:.2e}; one full train step "
                     f"loss={loss:.4f})")
        if p is not ppo:
            continue
        ts5 = ppo.init(state, rng.prng_key(7),
                       torch.Generator().manual_seed(7))
        want5 = ppo.collect_rollout(ts5.params, ts5.env, ts5.obs,
                                    ts5.key)[3]
        spat = SpatialPPO(ppo, node_mesh)
        got5 = spat.rollout(ts5)
        if not (torch.equal(got5.action, want5.action)
                and torch.equal(got5.reward, want5.reward)):
            raise AssertionError(f"path spatial-PPO ({tag}): the rollout's "
                                 f"actions or rewards differ")
        _, m5 = spat.train_iteration(ts5)
        loss5 = float(m5.loss_total)
        if not np.isfinite(loss5):
            raise AssertionError(f"path spatial-PPO ({tag}): loss {loss5}")
        lines.append(f"dryrun_multichip spatial-PPO OK on {tag} (road and "
                     f"node-column blocks {node_mesh.first}-"
                     f"{node_mesh.first + node_mesh.held - 1}, rollout "
                     f"actions and rewards bitwise-equal, node-sharded "
                     f"update; one full train step loss={loss5:.4f})")
    return lines


def _rank_main(rank: int, world: int, backend: str, out: str,
               device) -> None:
    torch.set_num_threads(1)
    if device is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    else:
        dev = torch.device(device)
    if dev.type == "cuda":
        # The transformer's flat forward sums with index_add_, whose
        # atomics order the sums anew in each run unless deterministic
        # algorithms are on (cuBLAS reads its workspace setting at its
        # first call); path 6 compares a noise-level gradient.
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
    store = os.path.join(out, "store")
    dist.init_process_group(backend, init_method=f"file://{store}",
                            world_size=world, rank=rank)
    try:
        lines = run_paths(dist.group.WORLD, dev, out)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out, f"rank{rank}.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")


def dryrun_multichip(n_ranks: int, backend: str = "gloo", device=None,
                     timeout: float = SPAWN_TIMEOUT) -> list[str]:
    """Run the six paths in ``n_ranks`` spawned processes of a ``backend``
    group; prints and returns every rank's lines (rank 0's first).  A rank
    that does not end within ``timeout`` seconds of its join is killed;
    raises where any rank failed."""
    out = tempfile.mkdtemp(prefix="tarl_dryrun_")
    try:
        _scenarios(out)
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=_rank_main, args=(
            k, n_ranks, backend, out, device)) for k in range(n_ranks)]
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(timeout)
        finally:
            hung = [k for k, p in enumerate(procs) if p.is_alive()]
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        if hung:
            raise RuntimeError(f"dryrun_multichip: ranks {hung} did not end "
                               f"within {timeout:.0f} s")
        codes = [p.exitcode for p in procs]
        if any(codes):
            raise RuntimeError(f"dryrun_multichip: ranks exited with {codes}")
        lines = []
        for k in range(n_ranks):
            with open(os.path.join(out, f"rank{k}.txt")) as f:
                lines += f.read().splitlines()
    finally:
        shutil.rmtree(out, ignore_errors=True)
    for line in lines:
        print(line, flush=True)
    return lines


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("n_ranks", type=int, nargs="?", default=2)
    parser.add_argument("--backend", default="gloo")
    parser.add_argument("--device", default=None)
    args = parser.parse_args(argv)
    t0 = time.perf_counter()
    dryrun_multichip(args.n_ranks, args.backend, args.device)
    print(f"dryrun_multichip: {args.n_ranks} ranks in "
          f"{time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
