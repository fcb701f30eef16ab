"""Road blocks across processes, on the CPU: ``make_road_mesh(S,
group=...)`` over gloo, and ``parallel.sharded_episode``'s entry points.

* Grid4x4 on 8 road blocks in 2 and 4 processes spawned with
  ``torch.multiprocessing`` (a ``FileStore`` under ``tmp_path``, no TCP
  port; each process joined with its own timeout, so that a hung rank
  fails the test and does not hang the suite): the headline's exact mode
  with the random policy, a sampled learned MPNN and the dual shortest-path
  policy.  Every rank's final state and logs equal the port's serial
  episode bitwise.  In each group a mesh of 3 blocks is refused.
* ``run_episode_sharded`` on a one-device ``DeviceMesh`` and on a road
  mesh of 8 blocks equals the reference's ``run_episode_sharded`` on its
  8-device CPU mesh (``tests/test_parallel.py``'s case: 400 ticks, the
  population padded to 8 by each side's ``pad_agents``).
* A state on another device than the mesh's is refused.

The spawned ranks import this module, whose top level imports no jax.
"""
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from tarl_tpu_torch import convert
from tarl_tpu_torch.config import RoutingConfig, SimConfig
from tarl_tpu_torch.core import step
from tarl_tpu_torch.io.matsim import load_network, load_population
from tarl_tpu_torch.io.scenarios import ensure_scenario
from tarl_tpu_torch.models.mpnn import MPNNPolicyNet
from tarl_tpu_torch.parallel.mesh import make_mesh
from tarl_tpu_torch.parallel.shard_map_episode import (
    make_road_mesh,
    run_episode_shard_map,
)
from tarl_tpu_torch.parallel.sharded_episode import (
    run_episode_sharded,
    shard_sim_state,
)
from tarl_tpu_torch.parallel.sharded_episode import (
    pad_agents as port_pad_agents,
)
from tarl_tpu_torch.rl.learned_policy import make_learned_choice
from tarl_tpu_torch.routing.policies import random_choice
from tarl_tpu_torch.simulator import make_policy
from tarl_tpu_torch.state import sort_agents_by_departure

START = 6 * 3600
BLOCKS = 8
SPAWN_TIMEOUT = 120            # seconds a rank may take
EXACT = dict(start_time=START, record_road_optimality=False,
             insert_window=32, insert_backlog=256, withdraw_depth=2,
             sorted_population=True, insert_escalate=True,
             withdraw_escalate=True)
# name: (SimConfig fields, ticks)
CASES = {
    "exact_random": (EXACT, 200),
    "mpnn_sampled": (dict(start_time=START), 120),
    "dual": (dict(start_time=START), 200),
}


def _case(name: str, base: str):
    """``(net, state0, policy, sim, ticks)`` of a case, made alike in every
    process from the scenario files under ``base`` and numpy seeds."""
    torch.set_num_threads(1)
    fields, ticks = CASES[name]
    net = load_network(os.path.join(base, "network"), device="cpu")
    agents, _ = load_population(os.path.join(base, "population"),
                                os.path.join(base, "network"), device="cpu")
    sim = SimConfig(**fields)
    if sim.sorted_population:
        agents = sort_agents_by_departure(agents)
    if name == "dual":
        policy = make_policy("dijkstra", RoutingConfig(refresh_rate=10),
                             network=net)
    elif name == "mpnn_sampled":
        pnet = MPNNPolicyNet(net.num_nodes, net.num_roads + 1)
        g = np.random.default_rng(17)
        params = {k: torch.as_tensor(
            (0.3 * g.standard_normal(tuple(v.shape))).astype(np.float32))
            for k, v in sorted(pnet.state_dict().items())}
        policy = make_learned_choice(pnet, params, net)
    else:
        policy = step.Policy(choice=random_choice)
    state = step.init_sim_state(net, agents, sim=sim, policy=policy)
    return net, state, policy, sim, ticks


def _rank_main(rank: int, world: int, store: str, base: str, out: str):
    """One rank: every case on ``BLOCKS`` blocks over the gloo group, each
    result written to ``out`` for the test to compare."""
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    try:
        results = {}
        for name in CASES:
            net, state, policy, sim, ticks = _case(name, base)
            mesh = make_road_mesh(BLOCKS, "cpu", group=dist.group.WORLD)
            assert (mesh.first, mesh.held) == (rank * BLOCKS // world,
                                               BLOCKS // world)
            final, logs = run_episode_shard_map(state, net, policy, ticks,
                                                mesh, sim=sim)
            results[name] = (convert.to_numpy(final), convert.to_numpy(logs))
        try:
            make_road_mesh(3, "cpu", group=dist.group.WORLD)
            results["refused"] = False
        except ValueError:
            results["refused"] = True
        torch.save(results, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def scenario(tmp_path_factory):
    return ensure_scenario(str(tmp_path_factory.mktemp("torch_dist")),
                           "Grid4x4")


@pytest.fixture(scope="module")
def serial(scenario):
    out = {}
    for name in CASES:
        net, state, policy, sim, ticks = _case(name, scenario)
        final, logs = step.run_episode(state, net, policy, ticks, sim=sim)
        out[name] = (convert.to_numpy(final), convert.to_numpy(logs))
        assert int(final.agents.done.sum()) > 0, name
    return out


@pytest.fixture(scope="module", params=[2, 4])
def ranks(request, scenario, tmp_path_factory):
    """The results of every rank of a spawned gloo group of ``param``
    processes."""
    world = request.param
    out = str(tmp_path_factory.mktemp(f"ranks{world}"))
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


@pytest.mark.parametrize("case", sorted(CASES))
def test_ranks_equal_the_serial_episode(ranks, serial, case):
    from test_torch_network import assert_tree_equal

    world, results = ranks
    want_state, want_logs = serial[case]
    for rank, res in enumerate(results):
        state, logs = res[case]
        assert_tree_equal(want_state, state, f"{case} rank {rank} of {world}")
        assert_tree_equal(want_logs, logs, f"{case} logs rank {rank}")


def test_mesh_refuses_blocks_the_group_cannot_split(ranks):
    world, results = ranks
    assert all(res["refused"] for res in results), world


def test_state_on_another_device_is_refused(scenario):
    net, state, policy, sim, _ = _case("exact_random", scenario)
    with pytest.raises(ValueError, match="lies on cpu"):
        run_episode_shard_map(state, net, policy, 1, make_road_mesh(4),
                              sim=sim)


def test_run_episode_sharded_matches_reference(scenario):
    """``tests/test_parallel.py::test_sharded_episode_matches_unsharded`` on
    both packages: the reference's ``run_episode_sharded`` (GSPMD over 8
    XLA CPU devices) and the port's, from the same unpadded population,
    final states bitwise."""
    from tarl_tpu.config import SimConfig as RefSimConfig
    from tarl_tpu.core.step import Policy, init_sim_state
    from tarl_tpu.io.matsim import load_network as ref_load_network
    from tarl_tpu.io.matsim import load_population as ref_load_population
    from tarl_tpu.parallel.mesh import make_mesh as ref_make_mesh
    from tarl_tpu.parallel.sharded_episode import pad_agents
    from tarl_tpu.parallel.sharded_episode import (
        run_episode_sharded as ref_run_episode_sharded,
    )
    from tarl_tpu.routing.policies import random_choice as ref_random_choice

    from test_torch_network import assert_tree_equal

    ticks = 400
    cfg = dict(start_time=START, end_time=START + ticks,
               record_road_optimality=False)
    net_path = os.path.join(scenario, "network")
    net = ref_load_network(net_path)
    agents = pad_agents(ref_load_population(
        os.path.join(scenario, "population"), net_path)[0], 8)
    sim = RefSimConfig(**cfg)
    policy = Policy(choice=ref_random_choice)
    state = init_sim_state(net, agents, sim=sim, policy=policy)
    want, _ = ref_run_episode_sharded(state, net, policy, ticks,
                                      ref_make_mesh(8), sim=sim)
    want = convert.to_numpy(want)

    pnet, _, ppolicy, _, _ = _case("exact_random", scenario)
    psim = SimConfig(**cfg)
    pagents = load_population(os.path.join(scenario, "population"),
                              net_path, device="cpu")[0]
    assert pagents.num_agents % 8 != 0
    # A one-device DeviceMesh is one block: the population comes padded,
    # as the reference's test pads it; a road mesh of 8 blocks pads it.
    for agents_in, mesh in ((port_pad_agents(pagents, 8),
                             make_mesh(1, device="cpu")),
                            (pagents, make_road_mesh(8, "cpu"))):
        pstate = step.init_sim_state(pnet, agents_in, sim=psim,
                                     policy=ppolicy)
        placed = shard_sim_state(pstate, mesh)
        assert placed.agents.num_agents == want["agents"]["origin"].shape[0]
        got, _ = run_episode_sharded(pstate, pnet, ppolicy, ticks, mesh,
                                     sim=psim)
        assert_tree_equal(want, convert.to_numpy(got), "final state")
    assert int(got.agents.done.sum()) > 0
