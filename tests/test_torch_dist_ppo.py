"""The sharded trainers across processes, on the CPU: ``ShardedPPO``,
``SpatialPPO`` and ``BatchedPPO`` over a gloo group, and the port's
``dryrun_multichip``.

Braess, the MPNN with its distance prior (and, for ``ShardedPPO``'s
gradients, the Graph Transformer), 8 collection steps, two epochs of
minibatches of 8 (4 for the single-environment trainers), in 2 and 4
processes spawned with ``torch.multiprocessing`` (a ``FileStore`` under
``tmp_path``, each process joined with its own timeout).  Each rank's
results against the one-process runs, made here:

* ``ShardedPPO`` on 4 node-column blocks: a minibatch's gradients at rtol
  2e-5, atol 1e-6 (the transformer's at rtol 1e-4, atol 1e-5; the float
  sums add the ranks' parts in the ring's order); one ``train_iteration``:
  the trajectory and the environment bitwise, the parameters at rtol 1e-3,
  atol 5e-3.
* ``SpatialPPO`` on 4 road and node-column blocks: the ``progress``
  rollout's actions, dones, clock, ``on_network``, contexts and values
  bitwise, the rewards at rtol 1e-6, atol 1e-5, the log-probs at rtol
  1e-5, atol 1e-6; one ``on_network`` iteration: the environment bitwise,
  the parameters at rtol 1e-3, atol 5e-3.
* ``BatchedPPO`` with 4 replicas on ``make_mesh(group=...)`` (``dp x sp``
  2 x 1, and 2 x 2 in 4 processes): the rank's replicas and their keys
  bitwise the one-process step's, the gathered update buffer's actions,
  rewards, dones, contexts and log-probs bitwise, the parameters within
  twice the learning rate times the updates.
* ``RoadMesh.all_gather`` and ``psum`` carry gradients across ranks: with
  rank k's loss weighted ``k + 1``, each rank's gradients are the summed
  losses' (exact small integers).
* ``dryrun_multichip(2)`` prints its six lines on each rank.

The spawned ranks import this module, whose top level imports no jax.
"""
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from tarl_tpu_torch import convert
from tarl_tpu_torch.config import RLConfig
from tarl_tpu_torch.core import rng, step
from tarl_tpu_torch.io.matsim import load_network, load_population
from tarl_tpu_torch.io.scenarios import ensure_scenario
from tarl_tpu_torch.models import mpnn
from tarl_tpu_torch.models.transformer import agent
from tarl_tpu_torch.parallel.dryrun import dryrun_multichip
from tarl_tpu_torch.parallel.mesh import make_mesh
from tarl_tpu_torch.parallel.shard import BatchedPPO, replica
from tarl_tpu_torch.parallel.sharded_ppo import ShardedPPO, make_node_mesh
from tarl_tpu_torch.parallel.spatial_ppo import SpatialPPO, make_spatial_mesh
from tarl_tpu_torch.rl.gae import gae, normalize
from tarl_tpu_torch.rl.ppo import PPO
from tarl_tpu_torch.routing.policies import random_choice

BLOCKS = 4
ENVS = 4
SPAWN_TIMEOUT = 180            # seconds a rank may take
RL_KW = dict(rollout_steps=8, minibatch_size=4, num_epochs=2,
             entropy_coef=0.01, gamma=0.98, episode_start=21600)


def _setup(base: str):
    """``(net, state, ppos)`` made alike in every process: the MPNN PPO
    in the ``progress`` and ``on_network`` modes, the batched trainer's
    and the transformer's, the transformer's encoding seeded."""
    torch.set_num_threads(1)
    net = load_network(os.path.join(base, "network"), device="cpu")
    agents, _ = load_population(os.path.join(base, "population"),
                                os.path.join(base, "network"), device="cpu")
    state = step.init_sim_state(net, agents,
                                policy=step.Policy(choice=random_choice))

    def mpnn_ppo(**kw):
        return PPO(net, mpnn.MPNNPolicyNet(
            net.num_nodes, net.num_roads + 1, use_distance_prior=True,
            prior_scale=30.0), mpnn.MPNNValueNetSimple(net.num_nodes),
            rl=RLConfig(**{**RL_KW, **kw}))

    pe = np.random.default_rng(8).standard_normal(
        (net.num_nodes, 8)).astype(np.float32)
    nets = dict(hidden_dim=8, num_heads=2)
    ppos = {
        "progress": mpnn_ppo(reward_mode="progress"),
        "on_network": mpnn_ppo(reward_mode="on_network"),
        "batched": mpnn_ppo(reward_mode="progress", minibatch_size=8),
        "transformer": PPO(
            net, agent.TransformerRoutePolicy(pe, num_layers=2, **nets),
            agent.TransformerValueNet(pe, num_layers=1, **nets),
            rl=RLConfig(**RL_KW), value_uses_graph=True),
    }
    return net, state, ppos


def _params(tree: dict) -> dict:
    return {p: {k: v.numpy() for k, v in sub.items()}
            for p, sub in tree.items()}


def _init(ppo, state, seed: int):
    return ppo.init(state, rng.prng_key(seed),
                    torch.Generator().manual_seed(seed))


def _minibatch(ppo, ts):
    """A rollout's first 4 steps with their normalised advantages."""
    _, _, _, traj, last = ppo.collect_rollout(ts.params, ts.env, ts.obs,
                                              ts.key)
    adv, ret = gae(traj.reward, traj.value, last, traj.done, ppo.rl.gamma,
                   ppo.rl.gae_lambda)
    adv = normalize(adv)
    return type(traj)(*(a[:4] for a in traj)), adv[:4], ret[:4]


def _keep_buffer(ppo, out: dict) -> None:
    update = ppo._update_epochs

    def keep(params, opt_state, buffer, adv, ret, key, grads_fn=None):
        out["buffer"] = buffer
        return update(params, opt_state, buffer, adv, ret, key, grads_fn)

    ppo._update_epochs = keep


def _runs(ppos, state, node_mesh, batch_mesh) -> dict:
    """Every trainer's results on the given meshes (a group's or one
    process's), as numpy trees."""
    out = {}
    for name in ("progress", "transformer"):
        ppo = ppos[name]
        ts = _init(ppo, state, 1)
        _, grads = ShardedPPO(ppo, node_mesh)._grads(ts.params,
                                                     *_minibatch(ppo, ts))
        out[f"grads_{name}"] = _params(grads)
    ppo = ppos["progress"]
    ts1, _ = ShardedPPO(ppo, node_mesh).train_iteration(_init(ppo, state, 2))
    out["sharded"] = dict(env=convert.to_numpy(ts1.env),
                          obs=convert.to_numpy(ts1.obs),
                          params=_params(ts1.params))
    spat = SpatialPPO(ppo, node_mesh)
    out["spatial_traj"] = convert.to_numpy(spat.rollout(_init(ppo, state,
                                                               3)))
    ppo = ppos["on_network"]
    ts1, _ = SpatialPPO(ppo, node_mesh).train_iteration(_init(ppo, state, 4))
    out["spatial"] = dict(env=convert.to_numpy(ts1.env),
                          params=_params(ts1.params))
    ppo = ppos["batched"]
    trainer = BatchedPPO(ppo, batch_mesh, num_envs=ENVS)
    kept = {}
    _keep_buffer(ppo, kept)
    ts = trainer.init(state, rng.prng_key(5), torch.Generator().manual_seed(5))
    ts1, _ = trainer.train_step(ts)
    out["batched"] = dict(
        replicas=list(trainer.replicas), keys=list(ts1.keys),
        envs=[convert.to_numpy(replica(ts1.envs, j))
              for j in range(len(trainer.replicas))],
        params=_params(ts1.params),
        buffer=convert.to_numpy(kept["buffer"]),
        updates=ts1.opt_state.count)
    return out


def _collective_grads(mesh) -> dict:
    """Gradients through the mesh's collectives: each rank's loss is its
    weight ``rank + 1`` times a function of the gathered rows and of the
    blocks' sum; the gradients of the ranks' summed losses reach the
    rows' own rank."""
    rank = mesh.rank
    held, rl = mesh.held, 3
    blocks = torch.arange(mesh.first, mesh.first + held,
                          dtype=torch.float32)
    x = (blocks[:, None, None] * 10 + torch.arange(rl * 2).view(1, rl, 2)
         + 1.0).requires_grad_()
    weight = torch.arange(mesh.num_blocks * rl * 2,
                          dtype=torch.float32).view(-1, 2)
    (float(rank + 1) * (weight * mesh.all_gather(x)).sum()).backward()
    part = (blocks[:, None] + torch.tensor([0.5, -1.0])).requires_grad_()
    total = mesh.psum(part)
    (float(rank + 1) * (total ** 2).sum()).backward()
    return dict(first=mesh.first, held=held, gather=x.grad.numpy(),
                psum=part.grad.numpy(), total=total.detach().numpy())


def _rank_main(rank: int, world: int, store: str, base: str, out: str):
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    try:
        _, state, ppos = _setup(base)
        group = dist.group.WORLD
        mesh = make_node_mesh(BLOCKS, "cpu", group=group)
        assert (mesh.first, mesh.held) == (rank * BLOCKS // world,
                                           BLOCKS // world)
        batch_mesh = make_mesh(group=group, device="cpu")
        res = _runs(ppos, state, mesh, batch_mesh)
        res["shape"] = dict(batch_mesh.shape)
        res["collectives"] = _collective_grads(mesh)
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def scenario(tmp_path_factory):
    return ensure_scenario(str(tmp_path_factory.mktemp("torch_dist_ppo")),
                           "Braess")


@pytest.fixture(scope="module")
def one_process(scenario):
    _, state, ppos = _setup(scenario)
    return _runs(ppos, state, make_node_mesh(BLOCKS, "cpu"),
                 make_mesh(1, device="cpu"))


@pytest.fixture(scope="module", params=[2, 4])
def ranks(request, scenario, tmp_path_factory):
    world = request.param
    out = str(tmp_path_factory.mktemp(f"ppo_ranks{world}"))
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(
        k, world, os.path.join(out, "store"), scenario, out))
        for k in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout=SPAWN_TIMEOUT)
    finally:
        hung = [p.pid for p in procs if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    assert not hung, f"ranks {hung} did not end within {SPAWN_TIMEOUT} s"
    assert [p.exitcode for p in procs] == [0] * world
    return world, [torch.load(os.path.join(out, f"rank{k}.pt"),
                              weights_only=False) for k in range(world)]


def _close(want, got, rtol, atol, path="root"):
    if isinstance(want, dict):
        for k in want:
            _close(want[k], got[k], rtol, atol, f"{path}.{k}")
        return
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=path)


def test_collectives_carry_gradients_across_ranks(ranks):
    """The gather's backward sums every rank's cotangent and keeps the
    rank's rows; the sum's backward sums the cotangents: with rank k's
    loss weighted ``k + 1``, each rank's gradients are the one-process
    gradients of the summed losses, ``sum_k (k + 1)`` times the
    unweighted ones."""
    world, results = ranks
    scale = world * (world + 1) / 2
    weight = np.arange(BLOCKS * 3 * 2, dtype=np.float32).reshape(BLOCKS,
                                                                 3, 2)
    blocks = np.arange(BLOCKS, dtype=np.float32)
    total = (blocks[:, None] + np.array([0.5, -1.0], np.float32)).sum(0)
    for res in results:
        got = res["collectives"]
        rows = slice(got["first"], got["first"] + got["held"])
        np.testing.assert_array_equal(got["gather"], scale * weight[rows])
        np.testing.assert_array_equal(got["total"], total)
        np.testing.assert_array_equal(
            got["psum"], np.broadcast_to(scale * 2 * total,
                                         got["psum"].shape))
    one = _collective_grads(make_node_mesh(BLOCKS, "cpu"))
    np.testing.assert_array_equal(one["gather"], weight)
    np.testing.assert_array_equal(one["psum"], np.broadcast_to(
        2 * total, one["psum"].shape))


def test_sharded_ppo_gradients_across_ranks(ranks, one_process):
    from test_torch_network import assert_tree_equal

    world, results = ranks
    for res in results:
        _close(one_process["grads_progress"], res["grads_progress"], 2e-5,
               1e-6, f"MPNN, {world} ranks")
        _close(one_process["grads_transformer"], res["grads_transformer"],
               1e-4, 1e-5, f"transformer, {world} ranks")
        want, got = one_process["sharded"], res["sharded"]
        assert_tree_equal(want["env"], got["env"], "env")
        assert_tree_equal(want["obs"], got["obs"], "obs")
        _close(want["params"], got["params"], 1e-3, 5e-3, "parameters")


def test_spatial_ppo_across_ranks(ranks, one_process):
    from test_torch_network import assert_tree_equal

    world, results = ranks
    want = one_process["spatial_traj"]
    for res in results:
        got = res["spatial_traj"]
        for f in ("action", "done", "time", "on_network", "x", "value"):
            np.testing.assert_array_equal(got[f], want[f], f)
        np.testing.assert_allclose(got["reward"], want["reward"], rtol=1e-6,
                                   atol=1e-5)
        np.testing.assert_allclose(got["log_prob"], want["log_prob"],
                                   rtol=1e-5, atol=1e-6)
        assert_tree_equal(one_process["spatial"]["env"], res["spatial"]["env"],
                          f"env, {world} ranks")
        _close(one_process["spatial"]["params"], res["spatial"]["params"],
               1e-3, 5e-3, "parameters")


def test_batched_ppo_across_ranks(ranks, one_process):
    from test_torch_network import assert_tree_equal

    world, results = ranks
    want = one_process["batched"]
    assert want["replicas"] == list(range(ENVS))
    lr = RL_KW.get("learning_rate", RLConfig().learning_rate)
    shape = {2: {"dp": 2, "sp": 1}, 4: {"dp": 2, "sp": 2}}[world]
    rows = []
    for rank, res in enumerate(results):
        assert res["shape"] == shape
        got = res["batched"]
        row = rank // shape["sp"]
        assert got["replicas"] == [2 * row, 2 * row + 1]
        rows.append(got["replicas"])
        for j, i in enumerate(got["replicas"]):
            assert got["keys"][j] == want["keys"][i]
            assert_tree_equal(want["envs"][i], got["envs"][j],
                              f"replica {i} on rank {rank}")
        for f in ("action", "reward", "done", "x", "log_prob"):
            np.testing.assert_array_equal(got["buffer"][f],
                                          want["buffer"][f], f)
        assert got["updates"] == want["updates"] == 8
        worst = max(float(np.abs(got["params"][p][k]
                                 - want["params"][p][k]).max())
                    for p in want["params"] for k in want["params"][p])
        assert worst <= 2 * lr * got["updates"], worst
    assert sorted({tuple(r) for r in rows}) == [(0, 1), (2, 3)]


def test_dryrun_multichip_two_ranks(capsys):
    lines = dryrun_multichip(2, device="cpu")
    assert len(lines) == 12
    for rank in range(2):
        mine = [ln for ln in lines if f"on rank {rank} of 2" in ln]
        assert len(mine) == 6, mine
        for label in ("OK", "spatial OK", "attention OK", "sharded-PPO OK",
                      "spatial-PPO OK", "attention-PPO OK"):
            assert any(f"dryrun_multichip {label}" in ln for ln in mine), \
                label
    assert capsys.readouterr().out.count("dryrun_multichip") == 12
