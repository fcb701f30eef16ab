"""The port's shortest-path slice as a whole against the JAX reference,
bitwise.

Grid8x8 episodes on the primal backend with ``refresh_rate=10`` and
``max_bf_iters=8`` run on both packages from the same scenario files:

* ``periodic``: 300 ticks of ``run_episode_periodic``, windowed insert
  W=64 on the departure-sorted population, withdraw depth 2, no escalation
  (the shape of ``bench.py``'s shortest-path row);
* ``escalate``: 100 ticks of ``run_episode`` with W=4 and both
  escalations, so that extra window passes run;
* ``so``: 100 ticks of ``run_episode_periodic`` on marginal social costs;
* ``zoned``: the destination-restricted tables over the population's
  destinations (moved to every third intersection, 22 zones),
  whole-population insert with per-agent entry roads, 300 ticks of
  ``run_episode``.

The final ``SimState`` (with the packed routing table ``next_hop``, compared
as raw bits, and ``sel_dest``) and every ``TickLog`` field must be equal in
dtype, shape and value; so must the port's two episode runners.

The million-agent row (``scripts/bench_million.py``: Grid128x128, 10^6
commuters departing 06:00-09:00 to 256 zones) scaled down to Grid16x16,
5,000 commuters and 16 zones, each package parsing the same
``grid_scenario`` files and taking its own path, for 120 ticks, bitwise in
the same way: its ``sp`` row (zoned tables over the population's
destinations, ``run_episode_periodic``, windowed insert W=4,096) and its
``exact_random`` row (backlog insert Q=256, W=64, both escalations,
overflow monitor 0).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tarl_tpu.config import RoutingConfig, SimConfig
from tarl_tpu.core.step import init_sim_state, run_episode, \
    run_episode_periodic
from tarl_tpu.io.matsim import load_network, load_population
from tarl_tpu.io.scenarios import grid_scenario
from tarl_tpu.routing.policies import _dest_inter
from tarl_tpu.simulator import make_policy
from tarl_tpu.state import sort_agents_by_departure

from tarl_tpu_torch import convert
from tarl_tpu_torch.config import RoutingConfig as PortRoutingConfig
from tarl_tpu_torch.config import SimConfig as PortSimConfig
from tarl_tpu_torch.core import step as p_step
from tarl_tpu_torch.io import matsim as p_matsim
from tarl_tpu_torch.routing.policies import _dest_inter as p_dest_inter
from tarl_tpu_torch.simulator import make_policy as p_make_policy
from tarl_tpu_torch.state import sort_agents_by_departure as p_sort

from test_torch_network import assert_tree_equal, load_both

torch.set_num_threads(1)

START = 6 * 3600
ROUTING = dict(refresh_rate=10, max_bf_iters=8, backend="primal")
WINDOWED = dict(start_time=START, record_road_optimality=False,
                withdraw_depth=2, sorted_population=True)
CASES = {
    # algo, zoned, runner, ticks, SimConfig fields
    "periodic": ("dijkstra", False, "periodic", 300, dict(
        WINDOWED, insert_window=64, insert_escalate=False,
        withdraw_escalate=False)),
    "escalate": ("dijkstra", False, "plain", 100, dict(
        WINDOWED, insert_window=4, insert_escalate=True,
        withdraw_escalate=True)),
    "so": ("so", False, "periodic", 100, dict(
        WINDOWED, insert_window=64, insert_escalate=False,
        withdraw_escalate=False)),
    "zoned": ("dijkstra", True, "plain", 300, dict(start_time=START - 60)),
}


# scripts/bench_million.py's scenario and rows at a twentieth of the side
# and a two-hundredth of the commuters.
MILLION_SCENARIO = dict(rows=16, cols=16, num_agents=5000,
                        peak_start=START, peak_spread=3 * 3600,
                        num_dest_zones=16)
MILLION_TICKS = 120
MILLION_BASE = dict(timestep=1, start_time=START,
                    record_road_optimality=False, withdraw_depth=2,
                    sorted_population=True)
MILLION_ROWS = {
    "sp": ("dijkstra", dict(MILLION_BASE, insert_window=4096)),
    "exact_random": ("random", dict(
        MILLION_BASE, insert_window=64, insert_backlog=256,
        insert_escalate=True, withdraw_escalate=True)),
}


@pytest.fixture(scope="module")
def grid8(tmp_path_factory):
    return load_both(str(tmp_path_factory.mktemp("torch_sp_scen")),
                     "Grid8x8")


def _bits(tree):
    """``convert.to_numpy`` of a state with the routing scratch as raw
    bits (the zoned table holds int8 bytes reinterpreted as float32)."""
    d = convert.to_numpy(tree)
    d["next_hop"] = d["next_hop"].view(np.uint32)
    return d


@pytest.mark.parametrize("case", sorted(CASES))
def test_sp_episode_bitwise(grid8, case):
    algo, zoned, runner_name, steps, cfg = CASES[case]
    net, agents, pnet, pagents = grid8
    if cfg.get("sorted_population"):
        agents, pagents = sort_agents_by_departure(agents), p_sort(pagents)
    kw = {}
    if zoned:
        # Commute to every third intersection only: 22 zones, a column
        # count that the int8 slot table pads to a multiple of 4.
        dest = np.array(agents.dest)
        inter = (dest[1:] - net.num_roads - 1) // 2
        dest[1:] = net.num_roads + 2 * (3 * (inter // 3)) + 1
        agents = agents._replace(dest=jnp.asarray(dest))
        pagents = pagents._replace(dest=torch.as_tensor(dest))
        kw["dest_inters"] = np.unique(3 * (inter // 3))
        assert len(kw["dest_inters"]) == 22

    sim = SimConfig(**cfg)
    policy = make_policy(algo, RoutingConfig(**ROUTING), network=net, **kw)
    state = init_sim_state(net, agents, sim=sim, policy=policy)
    runner = run_episode_periodic if runner_name == "periodic" else run_episode
    final, logs = runner(state, net, policy, steps, sim=sim)

    psim = PortSimConfig(**cfg)
    ppolicy = p_make_policy(algo, PortRoutingConfig(**ROUTING), network=pnet,
                            **kw)
    assert ppolicy.periodic_rate == 10
    pstate = p_step.init_sim_state(pnet, pagents, sim=psim, policy=ppolicy)
    assert_tree_equal(_bits(state), _bits(pstate), "initial state")
    prunner = (p_step.run_episode_periodic if runner_name == "periodic"
               else p_step.run_episode)
    pfinal, plogs = prunner(pstate, pnet, ppolicy, steps, sim=psim)

    assert_tree_equal(_bits(final), _bits(pfinal), "final state")
    assert_tree_equal(convert.to_numpy(logs), convert.to_numpy(plogs),
                      "logs")
    # The port's other runner gives the same episode.
    other = (p_step.run_episode if runner_name == "periodic"
             else p_step.run_episode_periodic)
    ofinal, ologs = other(pstate, pnet, ppolicy, steps, sim=psim)
    assert_tree_equal(_bits(pfinal), _bits(ofinal), "port runners")
    assert_tree_equal(convert.to_numpy(plogs), convert.to_numpy(ologs),
                      "port runner logs")

    assert pfinal.choice_count == steps
    assert int(pfinal.agents.done.sum()) > 0
    assert int(pfinal.road.count.sum()) == int(pfinal.agents.on_way.sum())
    # The zoned lookup leaves sel_dest at its -1 start, as the reference's.
    assert bool((pfinal.sel_dest >= 0).all()) != zoned
    sat = float(plogs.window_saturated.sum())
    assert sat > 0 if case == "escalate" else sat == 0


@pytest.fixture(scope="module")
def million16(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_million_scen"))
    grid_scenario(root, "Million16", **MILLION_SCENARIO)
    net_path = os.path.join(root, "Million16", "network")
    pop_path = os.path.join(root, "Million16", "population")
    net = load_network(net_path)
    agents, _ = load_population(pop_path, net_path)
    pnet = p_matsim.load_network(net_path, device="cpu")
    pagents, _ = p_matsim.load_population(pop_path, net_path, device="cpu")
    return (net, sort_agents_by_departure(agents), pnet, p_sort(pagents))


@pytest.mark.parametrize("row", sorted(MILLION_ROWS))
def test_million_row_scaled_bitwise(million16, row):
    algo, cfg = MILLION_ROWS[row]
    net, agents, pnet, pagents = million16
    kw = {}
    if algo == "dijkstra":
        dest = np.unique(np.asarray(_dest_inter(net, agents.dest)))
        assert np.array_equal(
            dest, np.unique(p_dest_inter(pnet, pagents.dest).numpy()))
        # 16 zones, and the dummy agent's clamped intersection 0.
        assert len(dest) in (16, 17)
        kw["dest_inters"] = dest
    sim, psim = SimConfig(**cfg), PortSimConfig(**cfg)
    policy = make_policy(algo, RoutingConfig(**ROUTING), network=net, **kw)
    ppolicy = p_make_policy(algo, PortRoutingConfig(**ROUTING), network=pnet,
                            **kw)
    assert bool(policy.periodic_rate) == (algo == "dijkstra")
    runner, prunner = ((run_episode_periodic, p_step.run_episode_periodic)
                       if policy.periodic_rate
                       else (run_episode, p_step.run_episode))
    state = init_sim_state(net, agents, sim=sim, policy=policy)
    pstate = p_step.init_sim_state(pnet, pagents, sim=psim, policy=ppolicy)
    assert_tree_equal(_bits(state), _bits(pstate), "initial state")
    final, logs = runner(state, net, policy, MILLION_TICKS, sim=sim)
    pfinal, plogs = prunner(pstate, pnet, ppolicy, MILLION_TICKS, sim=psim)
    assert_tree_equal(_bits(final), _bits(pfinal), "final state")
    assert_tree_equal(convert.to_numpy(logs), convert.to_numpy(plogs),
                      "logs")

    on_way = int(pfinal.agents.on_way.sum())
    assert int(pfinal.road.count.sum()) == on_way > 0
    assert int(pfinal.agents.done.sum()) + on_way <= pagents.num_agents
    if row == "exact_random":
        assert float(plogs.window_saturated.sum()) == 0.0
