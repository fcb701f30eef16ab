"""Every policy on road blocks: the port's ``run_episode_shard_map`` with
the learned MPNN and transformer (edge-sharded), the strict-compat and the
dual shortest-path policies, on the CPU.

Grid4x4 on 4 and 8 blocks and Grid3x5 (44 roads) on 7 padded blocks.  In
each case the same numpy-seeded inputs (scenario files, a Flax ``init``
carried into the port's state dict) go through the reference's serial
``run_episode``, the port's serial ``run_episode`` and the port's sharded
episode; the final states and logs are bitwise equal.  (The reference
holds its own ``run_episode_shard_map`` bitwise to its serial episode in
``tests/test_shard_map_episode.py``; its learned and transformer cases are
marked ``slow`` there, so they are not rerun here.)

* the MPNN (with the distance prior) greedy and sampled, and a sampled
  MPNN with ``extra_obs``;
* the transformer greedy and sampled (its slot twin on the blocks'
  columns, each layer's node rows gathered);
* strict-compat, and the dual policy under both ``cost_mode``s;
* a sampled learned MPNN in the headline's backlog mode, cut into the same
  ``run_episode`` calls on every side (a learned backlog episode depends
  on its cut: the reference's fault R5).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tarl_tpu.config import RoutingConfig, SimConfig
from tarl_tpu.core.step import Policy, init_sim_state, run_episode
from tarl_tpu.io.matsim import load_network, load_population
from tarl_tpu.models.mpnn import MPNNPolicyNet
from tarl_tpu.rl import learned_policy as r_lp
from tarl_tpu.routing.policies import random_choice
from tarl_tpu.simulator import make_policy
from tarl_tpu.state import sort_agents_by_departure as sort_ref_agents

from tarl_tpu_torch import convert
from tarl_tpu_torch.config import RoutingConfig as PortRoutingConfig
from tarl_tpu_torch.config import SimConfig as PortSimConfig
from tarl_tpu_torch.core import step as p_step
from tarl_tpu_torch.io.matsim import load_network as p_load_network
from tarl_tpu_torch.io.matsim import load_population as p_load_population
from tarl_tpu_torch.io.scenarios import grid_scenario
from tarl_tpu_torch.models import mpnn as p_mpnn
from tarl_tpu_torch.parallel.shard_map_episode import (
    make_road_mesh,
    run_episode_shard_map,
)
from tarl_tpu_torch.rl import learned_policy as p_lp
from tarl_tpu_torch.simulator import make_policy as p_make_policy
from tarl_tpu_torch.state import sort_agents_by_departure

from test_torch_learned_policy import _nets
from test_torch_network import assert_tree_equal

torch.set_num_threads(1)

START = 6 * 3600
EXACT = dict(start_time=START, record_road_optimality=False,
             insert_window=32, insert_backlog=256, withdraw_depth=2,
             sorted_population=True, insert_escalate=True,
             withdraw_escalate=True)
# name: (scenario, blocks, policy, deterministic, run_episode calls)
CASES = {
    "mpnn_greedy": ("Grid4x4", 4, "mpnn", True, (150,)),
    "mpnn_sampled": ("Grid4x4", 8, "mpnn", False, (150,)),
    "mpnn_extra_obs": ("Grid3x5", 7, "mpnn_extra", False, (150,)),
    "transformer_greedy": ("Grid3x5", 7, "transformer", True, (100,)),
    "transformer_sampled": ("Grid4x4", 4, "transformer", False, (100,)),
    "strict_compat": ("Grid4x4", 8, "strict", None, (300,)),
    "dual_travel": ("Grid3x5", 7, "dual", None, (300,)),
    "dual_marginal": ("Grid4x4", 4, "so", None, (300,)),
    "learned_backlog": ("Backlog", 4, "mpnn", False, (20, 40)),
}
ROUTING = {"strict": dict(refresh_rate=10, strict_compat=True),
           "dual": dict(refresh_rate=10), "so": dict(refresh_rate=10)}


def _load(base: str, sort: bool):
    """``(ref_net, ref_agents, port_net, port_agents)`` from the files
    under ``base``, each package's own loader."""
    net_path = os.path.join(base, "network")
    pop_path = os.path.join(base, "population")
    net = load_network(net_path)
    agents = load_population(pop_path, net_path)[0]
    pnet = p_load_network(net_path, device="cpu")
    pagents = p_load_population(pop_path, net_path, device="cpu")[0]
    if sort:
        agents, pagents = sort_ref_agents(agents), \
            sort_agents_by_departure(pagents)
    return net, agents, pnet, pagents


@pytest.fixture(scope="module")
def scenarios(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_shard_pol"))
    out = {}
    for name, kw, sort in (
            ("Grid4x4", dict(rows=4, cols=4, num_agents=500), False),
            ("Grid3x5", dict(rows=3, cols=5, num_agents=120), False),
            # 1,000 commuters over 06:00-06:05, for the backlog mode.
            ("Backlog", dict(rows=4, cols=4, num_agents=1000,
                             peak_start=START, peak_spread=300), True)):
        grid_scenario(root, name, **kw)
        out[name] = _load(os.path.join(root, name), sort)
    assert out["Grid3x5"][2].num_roads % 7 != 0
    return out


def _mpnn_extra(net, pnet, x):
    """A Flax ``init`` of the MPNN over the 19-column context and the port's
    net with its state dict."""
    ref = MPNNPolicyNet(num_nodes=net.num_nodes,
                        num_node_embeddings=net.num_roads + 1)
    fp = ref.init(jax.random.PRNGKey(11), x, jnp.zeros((4, 1)),
                  jnp.zeros((4,), jnp.int32), jnp.zeros((4,), jnp.int32))
    port = p_mpnn.MPNNPolicyNet(pnet.num_nodes, pnet.num_roads + 1,
                                context_dim=x.shape[1])
    params = convert.mpnn_params_from_numpy(
        {"policy": jax.tree.map(np.asarray, fp), "value": {}},
        device="cpu")["policy"]
    return ref, port, fp, params


def _policies(kind, deterministic, net, agents, pnet, sim):
    """The reference's and the port's policy of one case."""
    if kind in ROUTING:
        algo = "so" if kind == "so" else "dijkstra"
        return (make_policy(algo, RoutingConfig(**ROUTING[kind]),
                            network=net),
                p_make_policy(algo, PortRoutingConfig(**ROUTING[kind]),
                              network=pnet))
    extra = kind == "mpnn_extra"
    st = init_sim_state(net, agents, sim=sim,
                        policy=Policy(choice=random_choice))
    x = r_lp.rollout_context(st, net, extra_obs=extra)
    if extra:
        ref, port, fp, params = _mpnn_extra(net, pnet, x)
        dist = pdist = None
    else:
        ref, port, fp, params, dist, pdist = _nets(net, pnet, kind, x)
    return (r_lp.make_learned_choice(ref, fp, net,
                                     deterministic=deterministic, dist=dist,
                                     extra_obs=extra),
            p_lp.make_learned_choice(port, params, pnet,
                                     deterministic=deterministic, dist=pdist,
                                     extra_obs=extra))


def _bits(state):
    d = convert.to_numpy(state)
    d["next_hop"] = d["next_hop"].view(np.uint32)
    return d


@pytest.mark.parametrize("case", sorted(CASES))
def test_policy_on_blocks_equals_both_serial_episodes(scenarios, case):
    scenario, blocks, kind, deterministic, cuts = CASES[case]
    net, agents, pnet, pagents = scenarios[scenario]
    fields = EXACT if scenario == "Backlog" else dict(start_time=START)
    sim, psim = SimConfig(**fields), PortSimConfig(**fields)
    policy, ppolicy = _policies(kind, deterministic, net, agents, pnet, sim)
    assert (ppolicy.learned is not None) == (kind not in ROUTING)
    routing = PortRoutingConfig(**ROUTING.get(kind, {}))
    mesh = make_road_mesh(blocks, "cpu")

    ref = init_sim_state(net, agents, sim=sim, policy=policy)
    serial = sharded = p_step.init_sim_state(pnet, pagents, sim=psim,
                                             policy=ppolicy)
    for n in cuts:
        ref, ref_logs = run_episode(ref, net, policy, n, sim=sim)
        serial, logs = p_step.run_episode(serial, pnet, ppolicy, n,
                                          sim=psim)
        sharded, sharded_logs = run_episode_shard_map(
            sharded, pnet, ppolicy, n, mesh, sim=psim, routing=routing)
    assert_tree_equal(convert.to_numpy(ref), convert.to_numpy(serial),
                      f"{case}: the reference's and the port's serial")
    assert_tree_equal(convert.to_numpy(ref_logs), convert.to_numpy(logs),
                      f"{case}: serial logs")
    assert_tree_equal(_bits(serial), _bits(sharded),
                      f"{case}: serial and {blocks} blocks")
    assert_tree_equal(convert.to_numpy(logs), convert.to_numpy(sharded_logs),
                      f"{case}: logs on blocks")
    assert int(sharded.road.count.sum()) + int(sharded.agents.done.sum()) > 0
    if kind in ROUTING:
        assert sharded.choice_count == sum(cuts)
