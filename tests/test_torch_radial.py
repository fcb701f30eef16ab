"""The radial metro (``scripts/bench_radial.py``'s non-grid row) on the
port against the JAX reference, bitwise, at a small size.

``radial_scenario(rings=4, spokes=16)``: 65 intersections, 240 roads
(under the reference's 512-road renumbering gate, so both packages keep the
identity road order) and a centre of 8 spurs, so every intersection has 8
out-slots (K = 8) and the relax takes the port's global form, which the
CPU runs as its plain version:

* (a) the port writes the reference's scenario files, its routing tables
  equal the reference's, and the resident and cluster plans decline the
  shape;
* (b) ``primal_relax_next_roads`` (the plain version on CPU tensors)
  against the reference's gather sweep and its bucketed roll sweep
  (``primal_relax_next_roads`` / ``_primal_relax``), from warm starts with
  tie-heavy (free-flow) and random costs and from the cold start, over all
  intersections and over the zoned columns: 8 sweeps with and without the
  next roads, 1 sweep, uncapped with and without them.  The reference's
  K6 itself needs I % 8 == 0 (``_pallas_sweep_ok``) and the radial has
  rings x spokes + 1 rows; its interpret-mode parity stays in
  ``test_torch_routing.py::test_relax_against_pallas_k4_k6``;
* (c) the zoned shortest-path episode, ``bench_radial.py``'s bounded row
  (windowed insert, no escalation) and its exact row (both escalations),
  ``run_episode_periodic`` for 300 ticks on 400 commuters, bitwise (the
  final state with the packed routing table as raw bits, and every tick
  log);
* (d) the global kernel's slot compaction (``compact_slots``, the plain
  twin of its prologue): on random tables with repeated and scattered
  padding, and on the radial's own, the relax and next roads over the kept
  slots equal the padded loop's bitwise;
* (e) a radial that both packages renumber: 32 rings of 64 spokes (8,080
  roads, the smallest radial the reference renumbers; its polar order),
  every table bitwise and a 300-tick zoned episode of the bounded row,
  bitwise.

The kernel itself against the plain version on a card:
``tests/test_torch_card_k6.py``.
"""
import filecmp
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tarl_tpu.config import RoutingConfig, SimConfig
from tarl_tpu.core.step import init_sim_state, run_episode_periodic
from tarl_tpu.io.matsim import load_network, load_population
from tarl_tpu.io.scenarios import radial_scenario
from tarl_tpu.routing import bellman_ford as bf
from tarl_tpu.routing.policies import _dest_inter
from tarl_tpu.simulator import make_policy
from tarl_tpu.state import sort_agents_by_departure

from tarl_tpu_torch import convert
from tarl_tpu_torch.config import RoutingConfig as PortRoutingConfig
from tarl_tpu_torch.config import SimConfig as PortSimConfig
from tarl_tpu_torch.core import step as p_step
from tarl_tpu_torch.io import matsim as p_matsim
from tarl_tpu_torch.io.scenarios import radial_scenario as p_radial
from tarl_tpu_torch.routing import bellman_ford as pbf
from tarl_tpu_torch.routing.policies import _dest_inter as p_dest_inter
from tarl_tpu_torch.simulator import make_policy as p_make_policy
from tarl_tpu_torch.state import sort_agents_by_departure as p_sort

from test_torch_network import PORT_NETWORK_FIELDS, assert_tree_equal

torch.set_num_threads(1)

START = 6 * 3600
# bench_radial.py's scenario at 4 rings of 16 spokes, 400 commuters
# departing over ten minutes (so that a 300-tick episode sees trips end).
SCENARIO = dict(rings=4, spokes=16, num_agents=400, cbd_fraction=1.0,
                peak_start=START, peak_spread=600)
ROUTING = dict(refresh_rate=10, max_bf_iters=8, backend="primal")
BASE = dict(timestep=1, start_time=START, record_road_optimality=False,
            insert_window=1024, withdraw_depth=2, sorted_population=True)
ROWS = {"bounded": dict(BASE, insert_escalate=False,
                        withdraw_escalate=False),
        "exact": dict(BASE, insert_escalate=True, withdraw_escalate=True)}
TICKS = 300
MODES = {"8 sweeps + next roads": (8, False), "8 sweeps": (8, True),
         "1 sweep": (1, True), "uncapped + next roads": (None, False),
         "uncapped": (None, True)}


@pytest.fixture(scope="module")
def radial(tmp_path_factory):
    """``(root, ref_net, ref_agents, port_net, port_agents, dest)``: each
    package's loader on the reference's files (departure-sorted) and the
    zone list ``unique(_dest_inter(net, agents.dest))``."""
    root = str(tmp_path_factory.mktemp("torch_radial_scen"))
    radial_scenario(root, "Radial", **SCENARIO)
    net_path = os.path.join(root, "Radial", "network")
    pop_path = os.path.join(root, "Radial", "population")
    net = load_network(net_path)
    agents, _ = load_population(pop_path, net_path)
    pnet = p_matsim.load_network(net_path, device="cpu")
    pagents, _ = p_matsim.load_population(pop_path, net_path, device="cpu")
    agents, pagents = sort_agents_by_departure(agents), p_sort(pagents)
    dest = np.unique(np.asarray(_dest_inter(net, agents.dest)))
    assert np.array_equal(dest,
                          np.unique(p_dest_inter(pnet, pagents.dest).numpy()))
    return root, net, agents, pnet, pagents, dest


def _tables(net):
    return net.inter_out_road, net.inter_out_ok, net.road_to


def _ptables(pnet):
    return pnet.inter_out_road, pnet.inter_out_ok, pnet.road_to


def test_radial_tables_and_plans(radial):
    root, net, _, pnet, _, dest = radial
    p_radial(root, "RadialPort", **SCENARIO)
    for name in ("network.xml", "population.xml"):
        assert filecmp.cmp(os.path.join(root, "Radial", name),
                           os.path.join(root, "RadialPort", name),
                           shallow=False), name
    ref, port = convert.to_numpy(net), convert.to_numpy(pnet)
    for name in ("road_to", "inter_out_road", "inter_out_ok"):
        assert_tree_equal(ref[name], port[name], name)
    i_n, k_n = pnet.inter_out_road.shape
    assert (i_n, pnet.num_roads, k_n) == (65, 240, 8)
    assert not getattr(net, "renumbered", False)
    degree = np.bincount(port["inter_out_ok"].sum(axis=1))
    assert degree[8] == 1 and degree[3] + degree[4] == i_n - 1
    for d_n in (len(dest), i_n):
        for iters in (8, 1, None):
            assert pbf.resident_plan(i_n, d_n, k_n, iters) is None
            assert pbf.cluster_plan(i_n, d_n, k_n, iters) is None


def _inputs(net, dest, start: str, cols: str):
    """``(cost, dist0)`` as numpy float32: free-flow (tie-heavy: every ring
    road of one ring costs the same) or seeded random costs, and the cold
    start or a warm start (the free-flow table scaled by the worst cost
    ratio, as a refresh builds it), anchored at each column's own row;
    columns over every intersection or over the zones."""
    i_n = net.num_intersections
    ff = np.array(net.free_flow)
    cost = ff if start != "warm random" else (
        ff * np.random.default_rng(7).uniform(1.0, 4.0, ff.shape)
    ).astype(np.float32)
    col = np.arange(i_n) if cols == "all" else dest
    anchor = np.arange(i_n)[:, None] == col[None, :]
    if start == "cold":
        d0 = np.full(anchor.shape, float(bf.BIG), np.float32)
    else:
        d_ff = np.asarray(bf.primal_all_pairs_dist(jnp.asarray(ff),
                                                   *_tables(net)))[:, col]
        ratio = np.float32(np.max(cost / np.maximum(ff, np.float32(1e-6))))
        d0 = np.minimum(d_ff * max(ratio, np.float32(1.0)),
                        np.float32(bf.BIG)).astype(np.float32)
    return cost, np.where(anchor, np.float32(0.0), d0).astype(np.float32)


@pytest.mark.parametrize("cols", ["all", "zoned"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_radial_relax_bitwise(radial, mode, cols):
    _, net, _, pnet, _, dest = radial
    iters, relax_only = MODES[mode]
    i_n = net.num_intersections
    buckets = bf.primal_delta_buckets(*_tables(net),
                                      coords=(net.inter_x, net.inter_y))
    changed = False
    for start in ("warm ties", "warm random", "cold"):
        cost, d0 = _inputs(net, dest, start, cols)
        got_d, got_r = pbf.primal_relax_next_roads(
            torch.as_tensor(cost), *_ptables(pnet), torch.as_tensor(d0),
            iters, relax_only)
        assert (got_r is None) == relax_only
        changed |= not np.array_equal(got_d.numpy(), d0)
        jc, jd = jnp.asarray(cost), jnp.asarray(d0)
        # The reference's gather sweep, and its bucketed roll sweep where
        # the radial's offsets bucket.
        for ref_buckets in (None, buckets):
            ref_d = bf._primal_relax(jd, jc, *_tables(net),
                                     i_n - 1 if iters is None else iters,
                                     buckets=ref_buckets)
            what = f"{start}, buckets={ref_buckets is not None}"
            assert_tree_equal(np.asarray(ref_d), got_d.numpy(),
                              f"{mode} dist, {what}")
            if not relax_only:
                ref_r = bf.primal_next_roads(ref_d, jc, *_tables(net))
                assert_tree_equal(np.asarray(ref_r), got_r.numpy(),
                                  f"{mode} next road, {what}")
        if not relax_only:
            ref_d, ref_r = bf.primal_relax_next_roads(jc, *_tables(net), jd,
                                                      iters)
            assert_tree_equal(np.asarray(ref_d), got_d.numpy(),
                              f"{mode} dist, {start}, relax_next_roads")
            assert_tree_equal(np.asarray(ref_r), got_r.numpy(),
                              f"{mode} next road, {start}, relax_next_roads")
    assert changed


def _bits(tree):
    d = convert.to_numpy(tree)
    d["next_hop"] = d["next_hop"].view(np.uint32)
    return d


@pytest.mark.parametrize("row", sorted(ROWS))
def test_radial_zoned_episode_bitwise(radial, row):
    _, net, agents, pnet, pagents, dest = radial
    sim, psim = SimConfig(**ROWS[row]), PortSimConfig(**ROWS[row])
    policy = make_policy("dijkstra", RoutingConfig(**ROUTING), network=net,
                         dest_inters=dest)
    ppolicy = p_make_policy("dijkstra", PortRoutingConfig(**ROUTING),
                            network=pnet, dest_inters=dest)
    state = init_sim_state(net, agents, sim=sim, policy=policy)
    pstate = p_step.init_sim_state(pnet, pagents, sim=psim, policy=ppolicy)
    assert_tree_equal(_bits(state), _bits(pstate), "initial state")
    final, logs = run_episode_periodic(state, net, policy, TICKS, sim=sim)
    pfinal, plogs = p_step.run_episode_periodic(pstate, pnet, ppolicy,
                                                TICKS, sim=psim)
    assert_tree_equal(_bits(final), _bits(pfinal), "final state")
    assert_tree_equal(convert.to_numpy(logs), convert.to_numpy(plogs),
                      "logs")
    on_way = int(pfinal.agents.on_way.sum())
    assert int(pfinal.road.count.sum()) == on_way
    assert int(pfinal.agents.done.sum()) > 0
    if row == "exact":
        assert float(plogs.window_saturated.sum()) == 0.0


def test_renumbered_radial_zoned_episode_bitwise(tmp_path):
    radial_scenario(str(tmp_path), "Radial", **dict(SCENARIO, rings=32,
                                                    spokes=64))
    net_path = os.path.join(str(tmp_path), "Radial", "network")
    pop_path = os.path.join(str(tmp_path), "Radial", "population")
    net = load_network(net_path)
    pnet = p_matsim.load_network(net_path, device="cpu")
    assert net.renumbered and pnet.renumbered
    ref, port = convert.to_numpy(net), convert.to_numpy(pnet)
    for name in PORT_NETWORK_FIELDS:
        assert_tree_equal(ref[name], port[name], name)
    agents, _ = load_population(pop_path, net_path)
    pagents, _ = p_matsim.load_population(pop_path, net_path, device="cpu")
    agents, pagents = sort_agents_by_departure(agents), p_sort(pagents)
    dest = np.unique(np.asarray(_dest_inter(net, agents.dest)))
    sim, psim = SimConfig(**ROWS["bounded"]), PortSimConfig(**ROWS["bounded"])
    policy = make_policy("dijkstra", RoutingConfig(**ROUTING), network=net,
                         dest_inters=dest)
    ppolicy = p_make_policy("dijkstra", PortRoutingConfig(**ROUTING),
                            network=pnet, dest_inters=dest)
    state = init_sim_state(net, agents, sim=sim, policy=policy)
    pstate = p_step.init_sim_state(pnet, pagents, sim=psim, policy=ppolicy)
    assert_tree_equal(_bits(state), _bits(pstate), "initial state")
    final, logs = run_episode_periodic(state, net, policy, TICKS, sim=sim)
    pfinal, plogs = p_step.run_episode_periodic(pstate, pnet, ppolicy,
                                                TICKS, sim=psim)
    assert_tree_equal(_bits(final), _bits(pfinal), "final state")
    assert_tree_equal(convert.to_numpy(logs), convert.to_numpy(plogs),
                      "logs")
    assert int(pfinal.agents.done.sum()) > 0


def _relax_kept(cost, out_road, ok, road_to, dist0, iters, keep):
    """The plain relax and next roads over the kept slots only, in their
    order: what the global kernel's compact slot lists compute."""
    w, succ = pbf._slot_tables(cost, out_road, ok, road_to)
    dist = dist0
    for _ in range(iters):
        new = dist
        for k in range(succ.shape[1]):
            cand = torch.minimum(new, w[:, k, None] + dist[succ[:, k]])
            new = torch.where(keep[:, k, None], cand, new)
        dist = new
    best = torch.full_like(dist, pbf.BIG)
    road = torch.full_like(dist, -1.0)
    for k in range(succ.shape[1]):
        cand = w[:, k, None] + dist[succ[:, k]]
        take = keep[:, k, None] & (cand < best)
        best = torch.where(take, cand, best)
        road = torch.where(take, out_road[:, k].to(torch.float32)[:, None],
                           road)
    return dist, torch.where(best < pbf.BIG, road, -1.0)


def _scattered_table(seed: int, i_n=48, k_n=6, r_n=90):
    """Random out-slot tables whose padding is neither on road 0 nor last:
    valid and padding slots interleaved, padding roads drawn from three
    roads (so some repeat within a row and some do not), costs with ties,
    and a random warm start with anchors, unreached pairs and entries of
    -BIG (against which a padding slot's candidate BIG + dist is 0, so
    every padding term counts)."""
    g = np.random.default_rng(seed)
    out_road = g.integers(0, r_n, (i_n, k_n)).astype(np.int32)
    ok = g.random((i_n, k_n)) < 0.5
    pad_roads = g.choice(r_n, 3, replace=False)
    out_road[~ok] = g.choice(pad_roads, int((~ok).sum()))
    road_to = g.integers(0, i_n, r_n).astype(np.int32)
    cost = g.integers(1, 6, r_n).astype(np.float32)
    d0 = g.uniform(0.0, 40.0, (i_n, 20)).astype(np.float32)
    d0[g.random(d0.shape) < 0.3] = float(pbf.BIG)
    d0[g.random(d0.shape) < 0.1] = -float(pbf.BIG)
    d0[g.integers(0, i_n, 20), np.arange(20)] = 0.0
    return tuple(torch.as_tensor(a) for a in (cost, out_road, ok, road_to,
                                              d0))


@pytest.mark.parametrize("table", ["scattered 0", "scattered 1", "radial"])
def test_compact_slots_keep_the_relax(radial, table):
    if table == "radial":
        _, _, _, pnet, _, dest = radial
        cost = pnet.free_flow
        out_road, ok, road_to = _ptables(pnet)
        i_n = pnet.num_intersections
        anchor = torch.arange(i_n)[:, None] == torch.as_tensor(dest)[None, :]
        d0 = torch.where(anchor, 0.0, pbf.BIG)
    else:
        cost, out_road, ok, road_to, d0 = _scattered_table(
            int(table.split()[1]))
    keep = pbf.compact_slots(out_road, ok)
    assert bool(keep[ok].all())
    dropped = int((~keep).sum())
    if table == "radial":
        # build_network pads with road 0: one padding term a padded row.
        kept = keep.sum(dim=1)
        valid = ok.sum(dim=1)
        assert torch.equal(kept, valid + (valid < ok.shape[1]).long())
        assert dropped > 0
    else:
        # Some padding repeats an earlier padding road of its row, some
        # does not (kept, and after a valid slot); the padding terms count:
        # the valid slots alone give another relax.
        assert dropped > 0 and bool((keep & ~ok).any())
        alone = _relax_kept(cost, out_road, ok, road_to, d0, 3, ok)
        padded = pbf.primal_relax_next_roads_plain(cost, out_road, ok,
                                                   road_to, d0, 3)
        assert not all(torch.equal(a, b) for a, b in zip(alone, padded))
    for iters in (1, 3, 8):
        want = pbf.primal_relax_next_roads_plain(cost, out_road, ok,
                                                 road_to, d0, iters)
        got = _relax_kept(cost, out_road, ok, road_to, d0, iters, keep)
        for name, a, b in zip(("dist", "next road"), got, want):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), \
                f"{table}, {iters} sweeps: {name}"
