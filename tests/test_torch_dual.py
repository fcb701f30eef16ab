"""The port's dual routing backend against the JAX reference, bitwise.

* ``all_pairs_next_hop`` (the edge-list relax, with entry costs and with
  per-edge costs) and ``all_pairs_next_hop_nbr`` on Braess and Grid4x4
  under seeded random costs drawn from a few values (so that ties are
  everywhere), uncapped and capped, and ``reference_edge_costs`` on
  seeded random occupancies: distances and next hops bitwise.
* ``make_shortest_path_choice`` in both cost modes and under
  ``strict_compat``, and ``shortest_path_entry`` (all agents and a subset),
  on states reached by the reference's own episodes: a refresh call and a
  lookup call, the whole state bitwise.
* Dual dijkstra episodes on both packages (Easy and Grid4x4, 1,500 ticks;
  ``so`` on Bottleneck; ``strict_compat`` on Braess): the final state,
  next-hop table included, and every tick log bitwise.
* The port's dual and primal backends give the same episode on Easy,
  Grid4x4 and Grid8x8 (the roads, the agents, the metrics and the logs
  bitwise; the selections of empty roads, which route the dummy agent,
  differ), as the reference asserts of its own.
"""
import numpy as np
import pytest
import torch

from tarl_tpu.config import RoutingConfig, SimConfig
from tarl_tpu.core.step import init_sim_state, run_episode
from tarl_tpu.routing import bellman_ford as ref_bf
from tarl_tpu.routing import policies as ref_pol
from tarl_tpu.simulator import make_policy

import jax.numpy as jnp

from tarl_tpu_torch import convert
from tarl_tpu_torch.config import RoutingConfig as PortRoutingConfig
from tarl_tpu_torch.config import SimConfig as PortSimConfig
from tarl_tpu_torch.core import step as p_step
from tarl_tpu_torch.routing import bellman_ford as p_bf
from tarl_tpu_torch.routing import policies as p_pol
from tarl_tpu_torch.simulator import make_policy as p_make_policy

from test_torch_network import assert_tree_equal, load_both

torch.set_num_threads(1)

START = 6 * 3600 - 60
SCENARIOS = ("Braess", "Grid4x4")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("torch_dual_scen"))


@pytest.fixture(scope="module")
def nets(root):
    return {s: load_both(root, s) for s in
            ("Braess", "Easy", "Grid4x4", "Bottleneck")}


def _tie_costs(rng, n: int) -> np.ndarray:
    """Costs from four values: most paths tie with another."""
    return rng.choice(np.float32([1.0, 2.0, 3.0, 0.5]), size=n)


def _random_road(rng, ref_net):
    """The reference's empty road state with seeded counts in [0, cap]."""
    from tarl_tpu.state import init_road_state

    cap = np.asarray(ref_net.capacity).astype(np.int64)
    road = init_road_state(ref_net.num_roads, ref_net.nmax)
    return road._replace(count=jnp.asarray(
        rng.integers(0, cap + 1).astype(np.int32)))


def _port_road(road):
    return convert._road_from_numpy(convert.to_numpy(road), "cpu")


@pytest.mark.parametrize("scenario", SCENARIOS)
@pytest.mark.parametrize("max_iters", [None, 2])
def test_edge_list_relax_bitwise(nets, scenario, max_iters):
    net, _, pnet, _ = nets[scenario]
    rng = np.random.default_rng(7)
    n = net.num_nodes
    entry = np.zeros(n, np.float32)
    entry[:net.num_roads] = _tie_costs(rng, net.num_roads)
    road = _random_road(rng, net)
    edge_cost = ref_bf.reference_edge_costs(road, net)
    p_edge_cost = p_bf.reference_edge_costs(_port_road(road), pnet)
    np.testing.assert_array_equal(np.asarray(edge_cost), p_edge_cost.numpy())
    for w, pw in ((None, None), (edge_cost, p_edge_cost)):
        want = ref_bf.all_pairs_next_hop(
            net.full_src, net.full_dst, jnp.asarray(entry), n,
            max_iters=max_iters, edge_cost=w)
        got = p_bf.all_pairs_next_hop(
            pnet.full_src, pnet.full_dst, torch.as_tensor(entry), n,
            max_iters=max_iters, edge_cost=pw)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # The neighbour form under the same tie-heavy costs.
    want = ref_bf.all_pairs_next_hop_nbr(net.nbr, net.nbr_ok,
                                         jnp.asarray(entry),
                                         max_iters=max_iters)
    got = p_bf.all_pairs_next_hop_nbr(pnet.nbr, pnet.nbr_ok,
                                      torch.as_tensor(entry),
                                      max_iters=max_iters)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _ref_state(net, agents, routing, ticks, algo="dijkstra"):
    """The reference's dual episode state after ``ticks`` ticks."""
    sim = SimConfig(start_time=START, timestep=1)
    policy = make_policy(algo, routing, network=net)
    state = init_sim_state(net, agents, sim=sim, policy=policy)
    state, _ = run_episode(state, net, policy, ticks, sim=sim)
    return state


@pytest.mark.parametrize("mode", ["travel_time", "marginal", "strict"])
def test_shortest_path_choice_bitwise(nets, mode):
    scenario = "Braess" if mode == "strict" else "Grid4x4"
    net, agents, pnet, _ = nets[scenario]
    kw = ({"strict_compat": True} if mode == "strict"
          else {"cost_mode": mode})
    routing = RoutingConfig(backend="dual", **kw)
    state = _ref_state(net, agents, routing, 300)
    pstate = convert.sim_state_from_numpy(convert.to_numpy(state), "cpu")
    choice = ref_pol.make_shortest_path_choice(routing)
    pchoice = p_pol.make_shortest_path_choice(
        PortRoutingConfig(backend="dual", **kw))
    assert int(state.choice_count) % routing.refresh_rate == 0
    for call in ("refresh", "lookup"):
        state, _ = choice(state, net)
        pstate, _ = pchoice(pstate, pnet)
        assert_tree_equal(convert.to_numpy(state), convert.to_numpy(pstate),
                          call)
    if mode == "strict":
        return
    ids = jnp.asarray([1, 5, 3, agents.num_agents - 1], jnp.int32)
    for sel in (None, ids):
        want = ref_pol.shortest_path_entry(state, net, sel)
        got = p_pol.shortest_path_entry(
            pstate, pnet, None if sel is None else torch.tensor(
                np.asarray(sel)))
        np.testing.assert_array_equal(np.asarray(want), got.numpy())


EPISODES = {
    # scenario, algo, RoutingConfig fields, ticks
    "easy": ("Easy", "dijkstra", {}, 1500),
    "grid4x4": ("Grid4x4", "dijkstra", {}, 1500),
    "bottleneck_so": ("Bottleneck", "so", {}, 700),
    "braess_strict": ("Braess", "dijkstra", {"strict_compat": True}, 900),
}


@pytest.mark.parametrize("case", sorted(EPISODES))
def test_dual_episode_bitwise(nets, case):
    scenario, algo, fields, ticks = EPISODES[case]
    net, agents, pnet, pagents = nets[scenario]
    sim = SimConfig(start_time=START, timestep=1)
    policy = make_policy(algo, RoutingConfig(**fields), network=net)
    state = init_sim_state(net, agents, sim=sim, policy=policy)
    final, logs = run_episode(state, net, policy, ticks, sim=sim)

    psim = PortSimConfig(start_time=START, timestep=1)
    ppolicy = p_make_policy(algo, PortRoutingConfig(**fields), network=pnet)
    assert ppolicy.needs_next_hop
    assert (ppolicy.entry is None) == bool(fields.get("strict_compat"))
    pstate = p_step.init_sim_state(pnet, pagents, sim=psim, policy=ppolicy)
    assert_tree_equal(convert.to_numpy(state), convert.to_numpy(pstate),
                      "initial state")
    pfinal, plogs = p_step.run_episode(pstate, pnet, ppolicy, ticks, sim=psim)
    assert_tree_equal(convert.to_numpy(final), convert.to_numpy(pfinal),
                      "final state")
    assert_tree_equal(convert.to_numpy(logs), convert.to_numpy(plogs),
                      "logs")
    assert int(pfinal.agents.done[1:].sum()) > 0


@pytest.mark.parametrize("scenario,ticks", [("Easy", 800),
                                            ("Grid4x4", 800),
                                            ("Grid8x8", 400)])
def test_port_dual_equals_primal(root, nets, scenario, ticks):
    if scenario == "Grid8x8":
        _, _, pnet, pagents = load_both(root, scenario)
    else:
        _, _, pnet, pagents = nets[scenario]
    sim = PortSimConfig(start_time=START, timestep=1)
    finals = {}
    for backend in ("dual", "primal"):
        policy = p_make_policy("dijkstra",
                               PortRoutingConfig(backend=backend),
                               network=pnet)
        state = p_step.init_sim_state(pnet, pagents, sim=sim, policy=policy)
        finals[backend] = p_step.run_episode(state, pnet, policy, ticks,
                                             sim=sim)
    (dual, dlogs), (primal, plogs) = finals["dual"], finals["primal"]
    # Not selected_road: an empty road routes the dummy agent (dest 0),
    # which the two tables send to different places, and nobody follows.
    for field in ("road", "agents", "metrics"):
        assert_tree_equal(convert.to_numpy(getattr(dual, field)),
                          convert.to_numpy(getattr(primal, field)), field)
    assert_tree_equal(convert.to_numpy(dlogs), convert.to_numpy(plogs),
                      "logs")
    assert int(dual.agents.done[1:].sum()) > 0
