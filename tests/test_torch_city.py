"""The irregular city row (``io/city``) and the road-renumbering search
(``network``) on the port against the JAX reference, on the reference
test's MiniCity (900 target intersections, 3,000 commuters, 32 zones,
seed 7).

* (a) The port's generator writes the reference's ``network.xml.gz`` and
  ``population.xml.gz`` byte for byte once decompressed (the gzip header
  holds a time stamp), and an equal ``city_stats.json``.
* (b) The search's pieces equal the reference's: ``_turn_edge_pairs``,
  ``hilbert_rank``, ``rcm_rank``, ``polar_rank``, ``_order_exceptions``
  (the input order and each candidate's), ``roll_cost_budget`` and
  ``roll_friendly_road_order`` at the default budget and at 0.4.
* (c) ``road_order``, ``renumbered`` and every table of the built
  ``Network`` are bitwise the reference's: as built (MiniCity keeps its
  input order: no candidate fits the 5% budget at this size), and with
  both packages' search given the 0.4 budget (a renumbered build).
* (d) Episodes, bitwise (the final state with the packed routing table as
  raw bits, and every tick log): the 300-tick exact backlog episode of
  ``tests/test_city.py`` (random choice, W=32, Q=2,048) as built, and 60
  ticks of it from 06:30 on the renumbered build (both Gumbel streams
  addressed by input position); and a 120-tick zoned shortest-path
  episode (``scripts/bench_city.py``'s sp row: refresh every 10 ticks
  capped at 8 sweeps, W=1,024, depth 2) as built.

A renumbered zoned episode, the radial metro's, is in
``tests/test_torch_radial.py``.
"""
import gzip
import json
import os

import numpy as np
import pytest
import torch

import tarl_tpu.network as ref_network
from tarl_tpu.config import RoutingConfig, SimConfig
from tarl_tpu.core.roll_gather import roll_cost_budget
from tarl_tpu.core.step import init_sim_state, run_episode
from tarl_tpu.core.step import run_episode_periodic
from tarl_tpu.io.city import city_scenario
from tarl_tpu.io.matsim import load_network, load_population
from tarl_tpu.io.matsim import parse_network_xml
from tarl_tpu.routing.policies import _dest_inter
from tarl_tpu.simulator import make_policy
from tarl_tpu.state import sort_agents_by_departure

import tarl_tpu_torch.network as port_network
from tarl_tpu_torch import convert
from tarl_tpu_torch.config import RoutingConfig as PortRoutingConfig
from tarl_tpu_torch.config import SimConfig as PortSimConfig
from tarl_tpu_torch.core import step as p_step
from tarl_tpu_torch.io import matsim as p_matsim
from tarl_tpu_torch.io.city import city_scenario as p_city_scenario
from tarl_tpu_torch.simulator import make_policy as p_make_policy
from tarl_tpu_torch.state import sort_agents_by_departure as p_sort

from test_torch_network import PORT_NETWORK_FIELDS, assert_tree_equal

torch.set_num_threads(1)

START = 6 * 3600
CITY = dict(num_intersections=900, num_agents=3000, num_dest_zones=32,
            seed=7)
NUMBERINGS = ("input order", "renumbered at 0.4")
EXACT = dict(timestep=1, start_time=START, record_road_optimality=False,
             sorted_population=True, insert_window=32, insert_backlog=2048,
             withdraw_depth=None)
# (numbering, start, ticks): the reference test's episode as built, and a
# shorter one on the renumbered build in the peak.
EXACT_RUNS = [("input order", START, 300),
              ("renumbered at 0.4", START + 1800, 60)]
ROUTING = dict(refresh_rate=10, max_bf_iters=8, backend="primal")
ZONED = dict(timestep=1, start_time=START, record_road_optimality=False,
             insert_escalate=False, withdraw_escalate=False,
             insert_window=1024, withdraw_depth=2, sorted_population=True)
ZONED_TICKS = 120


@pytest.fixture(scope="module")
def cities(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_city"))
    ref = city_scenario(os.path.join(root, "ref"), "MiniCity", **CITY)
    port = p_city_scenario(os.path.join(root, "port"), "MiniCity", **CITY)
    return ref, port


def _coords(parsed):
    xy = np.array([parsed.node_positions[i]
                   for i in parsed.sorted_intersections])
    return xy[:, 0], xy[:, 1]


def test_city_files_are_the_references(cities):
    ref, port = cities
    for name in ("network.xml.gz", "population.xml.gz"):
        with gzip.open(os.path.join(ref, name)) as a, \
                gzip.open(os.path.join(port, name)) as b:
            assert a.read() == b.read(), name
    with open(os.path.join(ref, "city_stats.json")) as a, \
            open(os.path.join(port, "city_stats.json")) as b:
        assert json.load(a) == json.load(b)


def test_search_pieces_equal_the_references(cities):
    p = parse_network_xml(os.path.join(cities[0], "network"))
    x, y = _coords(p)
    fi, ti, n_i = p.from_inter, p.to_inter, p.num_intersections
    e_u, e_v = ref_network._turn_edge_pairs(fi, ti, n_i)
    pe_u, pe_v = port_network._turn_edge_pairs(fi, ti, n_i)
    np.testing.assert_array_equal(pe_u, e_u)
    np.testing.assert_array_equal(pe_v, e_v)
    ranks = {}
    for name in ("hilbert_rank", "polar_rank"):
        ranks[name] = getattr(ref_network, name)(x, y)
        np.testing.assert_array_equal(getattr(port_network, name)(x, y),
                                      ranks[name], err_msg=name)
    ranks["rcm_rank"] = ref_network.rcm_rank(fi, ti, n_i)
    np.testing.assert_array_equal(port_network.rcm_rank(fi, ti, n_i),
                                  ranks["rcm_rank"])
    r = p.num_roads
    floor = max(64, e_u.size // 512)
    orders = [np.arange(r)] + [
        np.lexsort((np.arange(r), rank[ti], rank[fi]))
        for rank in ranks.values()]
    for order in orders:
        pos = np.empty(r, np.int64)
        pos[order] = np.arange(r)
        assert port_network._order_exceptions(pos, e_u, e_v, r, 24, floor) \
            == ref_network._order_exceptions(pos, e_u, e_v, r, 24, floor)
    for entries, buckets in ((e_u.size, 24), (10 ** 6, 24), (10, 3),
                             (50_000, 16)):
        assert port_network.roll_cost_budget(entries, buckets) == \
            roll_cost_budget(entries, buckets)
    for frac in (0.05, 0.4):
        want = ref_network.roll_friendly_road_order(
            fi, ti, n_i, x, y, max_buckets=24, max_exc_frac=frac)
        got = port_network.roll_friendly_road_order(
            fi, ti, n_i, x, y, max_buckets=24, max_exc_frac=frac)
        if want is None:
            assert got is None, frac
        else:
            np.testing.assert_array_equal(got, want, err_msg=str(frac))
    assert ref_network.roll_friendly_road_order(fi, ti, n_i, x, y) is None


def _load(base: str, numbering: str):
    """``(ref_net, ref_agents, port_net, port_agents, dest)`` of the city
    at ``base``, parsed by each package's loader; for "renumbered at 0.4"
    both packages' search runs at the 0.4 budget."""
    mp = pytest.MonkeyPatch()
    if numbering == "renumbered at 0.4":
        for mod in (ref_network, port_network):
            search = mod.roll_friendly_road_order
            mp.setattr(mod, "roll_friendly_road_order",
                       lambda *a, _s=search, **k: _s(*a, max_exc_frac=0.4))
    net_path = os.path.join(base, "network")
    pop_path = os.path.join(base, "population")
    try:
        net = load_network(net_path)
        pnet = p_matsim.load_network(net_path, device="cpu")
    finally:
        mp.undo()
    agents, _ = load_population(pop_path, net_path)
    pagents, _ = p_matsim.load_population(pop_path, net_path, device="cpu")
    agents, pagents = sort_agents_by_departure(agents), p_sort(pagents)
    dest = np.unique(np.asarray(_dest_inter(net, agents.dest)))
    return net, agents, pnet, pagents, dest


@pytest.fixture(scope="module")
def city(cities):
    """Numbering -> :func:`_load` of MiniCity."""
    return {n: _load(cities[0], n) for n in NUMBERINGS}


@pytest.mark.parametrize("numbering", NUMBERINGS)
def test_network_tables_bitwise(city, numbering):
    net, agents, pnet, pagents, _ = city[numbering]
    assert pnet.renumbered == (numbering != "input order")
    ref, port = convert.to_numpy(net), convert.to_numpy(pnet)
    for name in PORT_NETWORK_FIELDS:
        assert_tree_equal(ref[name], port[name], name)
    assert_tree_equal(convert.to_numpy(agents), convert.to_numpy(pagents),
                      "agents")


def _bits(tree):
    d = convert.to_numpy(tree)
    if d.get("next_hop") is not None:
        d["next_hop"] = d["next_hop"].view(np.uint32)
    return d


def _episode_bitwise(net, agents, pnet, pagents, sim, psim, policy,
                     ppolicy, ticks, periodic):
    state = init_sim_state(net, agents, sim=sim, policy=policy)
    pstate = p_step.init_sim_state(pnet, pagents, sim=psim, policy=ppolicy)
    assert_tree_equal(_bits(state), _bits(pstate), "initial state")
    run = run_episode_periodic if periodic else run_episode
    prun = p_step.run_episode_periodic if periodic else p_step.run_episode
    final, logs = run(state, net, policy, ticks, sim=sim)
    pfinal, plogs = prun(pstate, pnet, ppolicy, ticks, sim=psim)
    assert_tree_equal(_bits(final), _bits(pfinal), "final state")
    assert_tree_equal(convert.to_numpy(logs), convert.to_numpy(plogs),
                      "logs")
    on_way = int(pfinal.agents.on_way.sum())
    assert int(pfinal.road.count.sum()) == on_way
    return pfinal, plogs


@pytest.mark.parametrize("numbering,start,ticks", EXACT_RUNS)
def test_exact_backlog_episode_bitwise(city, numbering, start, ticks):
    net, agents, pnet, pagents, _ = city[numbering]
    cfg = dict(EXACT, start_time=start)
    final, logs = _episode_bitwise(
        net, agents, pnet, pagents, SimConfig(**cfg), PortSimConfig(**cfg),
        make_policy("random", RoutingConfig()),
        p_make_policy("random", PortRoutingConfig()), ticks, False)
    assert float(logs.window_saturated.sum()) == 0.0
    assert int(final.agents.inserted[1:].sum()) > 0


def test_zoned_sp_episode_bitwise(city):
    net, agents, pnet, pagents, dest = city["input order"]
    policy = make_policy("dijkstra", RoutingConfig(**ROUTING), network=net,
                         dest_inters=dest)
    ppolicy = p_make_policy("dijkstra", PortRoutingConfig(**ROUTING),
                            network=pnet, dest_inters=dest)
    final, _ = _episode_bitwise(
        net, agents, pnet, pagents, SimConfig(**ZONED),
        PortSimConfig(**ZONED), policy, ppolicy, ZONED_TICKS, True)
    assert int(final.agents.inserted[1:].sum()) > 0
