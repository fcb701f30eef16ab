"""The golden trace on the port: the port's tick against the upstream
simulator's physics (``tests/reference_port.py``), on the CPU.

Mirrors ``tests/test_reference_trace.py``.  The port's production tick
(strict-compat Dijkstra, refresh every 10 ticks, the whole-population
insert and the unbounded withdraw) and ``reference_port.TorchReferenceSim``
run side by side for 400 Braess ticks from 06:00 with one Gumbel stream:
the port's own draw, ``core.rng.gumbel(k_dir, (KIN, R))`` with ``k_dir``
taken from the tick's key as ``core.step.core_phase`` takes it, handed to
the oracle per turn edge (edge e = (u -> v) is v's k-th incoming turn edge,
so ``gumbel_e[e] = gumbel[k, v]``).  Each tick, bitwise:

* the packed ``x[N, 3*Nmax+7]`` (``schema.pack_state``; the oracle's dead
  FIFO slots zeroed, as the upstream leaves stale stamps there),
* the ``[A, 9]`` agent rows,
* the next-hop table at every refresh.

At the end agents have finished and the hourly counts are not zero.  The
port's ``pack_state`` is also held bitwise against
``tarl_tpu.schema.pack_state`` on the same states (at ticks 0, 200 and 400),
carried across by ``convert.to_numpy``.

Under Dijkstra every Braess agent takes the same turn, so in this window
no road has two eligible in-slots at once and the noise decides no winner
(an oracle fed zeros instead passes as well).  A second test holds the
noise's mapping where it does decide: two heads contesting one Braess road,
the port's core (winner, confirm, push and pop) against the oracle's
direction and response under 32 keys, each head winning under some.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tarl_tpu.schema import pack_state as ref_pack_state
from tarl_tpu.state import RoadState as RefRoadState

from reference_port import TorchReferenceSim
from tarl_tpu_torch import convert
from tarl_tpu_torch.config import RoutingConfig, SimConfig
from tarl_tpu_torch.core import rng
from tarl_tpu_torch.core.fused_winner import (
    apply_transfers,
    direction_confirm,
)
from tarl_tpu_torch.core.step import init_sim_state, tick
from tarl_tpu_torch.io.matsim import load_network, load_population
from tarl_tpu_torch.io.scenarios import ensure_scenario
from tarl_tpu_torch.schema import agent_features_matrix, pack_state
from tarl_tpu_torch.simulator import make_policy
from tarl_tpu_torch.state import init_road_state

torch.set_num_threads(1)

NUM_TICKS = 400
REFERENCE_PACK_TICKS = (0, 200, 400)


@pytest.fixture(scope="module")
def braess(tmp_path_factory):
    base = ensure_scenario(str(tmp_path_factory.mktemp("trace_scen")),
                           "Braess")
    net_path = os.path.join(base, "network")
    net = load_network(net_path, device="cpu")
    agents, _ = load_population(os.path.join(base, "population"), net_path,
                                device="cpu")
    return net, agents


def in_slot_edge_table(net) -> np.ndarray:
    """int64[KIN, R]: the edge id of road v's k-th incoming turn edge (-1
    past its last)."""
    dst = net.edge_dst.numpy()
    kin, r = net.in_src_tab.shape
    tab = np.full((kin, r), -1, np.int64)
    fill = np.zeros(r, np.int64)
    for e, v in enumerate(dst):
        tab[fill[v], v] = e
        fill[v] += 1
    return tab


def edge_gumbel(k_dir, net, slot_edge) -> np.ndarray:
    """The direction noise of key ``k_dir``, ``[KIN, R]`` slot-major, per
    turn edge."""
    gslot = rng.gumbel(k_dir, tuple(net.in_src_tab.shape), "cpu").numpy()
    out = np.zeros(net.num_turn_edges, np.float32)
    ok = slot_edge >= 0
    out[slot_edge[ok]] = gslot[ok]
    return out


def reference_packed(state, net) -> np.ndarray:
    """``tarl_tpu.schema.pack_state`` of the port's state, carried across
    as numpy."""
    road = convert.to_numpy(state.road)
    ref_net = type("Net", (), {
        "num_nodes": net.num_nodes,
        **{f: jnp.asarray(convert.to_numpy(getattr(net, f)))
           for f in ("capacity", "free_flow", "length", "max_flow")}})
    return np.asarray(ref_pack_state(
        RefRoadState(**{f: jnp.asarray(v) for f, v in road.items()}),
        ref_net, jnp.asarray(convert.to_numpy(state.selected_road))))


def oracle(net, road, agents, selected_road, time: float,
           refresh_rate: int = 10) -> TorchReferenceSim:
    """The upstream physics from the port's state."""
    return TorchReferenceSim(
        pack_state(road, net, selected_road),
        agent_features_matrix(agents),
        routes_src=net.edge_src.numpy(),
        routes_dst=net.edge_dst.numpy(),
        routes_attr=net.edge_attr.numpy(),
        full_src=net.full_src.numpy(),
        full_dst=net.full_dst.numpy(),
        adj=net.dense_adjacency().numpy(),
        congestion_constant=net.congestion_constant.numpy(),
        num_roads=net.num_roads,
        nmax=net.nmax,
        time=time,
        timestep=1.0,
        refresh_rate=refresh_rate,
    )


def test_braess_golden_trace(braess):
    net, agents = braess
    routing = RoutingConfig(strict_compat=True, refresh_rate=10)
    sim = SimConfig(start_time=6 * 3600, timestep=1)
    policy = make_policy("dijkstra", routing=routing)
    state = init_sim_state(net, agents, sim=sim, policy=policy)
    # The upstream zero-initialises the packed matrix, so SELECTED_ROAD
    # starts at road 0 everywhere.
    state = state._replace(
        selected_road=torch.zeros_like(state.selected_road))
    ref = oracle(net, state.road, state.agents, state.selected_road,
                 float(sim.start_time), routing.refresh_rate)
    slot_edge = in_slot_edge_table(net)

    for t in range(NUM_TICKS):
        if t in REFERENCE_PACK_TICKS:
            np.testing.assert_array_equal(
                pack_state(state.road, net, state.selected_road).numpy(),
                reference_packed(state, net),
                err_msg=f"pack_state differs from the reference's at tick "
                        f"{t}")
        # The tick's direction key, as core_phase splits it.
        gumbel_e = edge_gumbel(rng.split(state.key)[1], net, slot_edge)
        state, _ = tick(state, net, policy, sim=sim)
        ref.tick(gumbel_e)

        np.testing.assert_array_equal(
            pack_state(state.road, net, state.selected_road).numpy(),
            ref.canonical_x(),
            err_msg=f"packed state diverged at tick {t}")
        np.testing.assert_array_equal(
            agent_features_matrix(state.agents).numpy(), ref.af.numpy(),
            err_msg=f"agent rows diverged at tick {t}")
        if t % routing.refresh_rate == 0:
            np.testing.assert_array_equal(
                state.next_hop.numpy(), ref.next_hop,
                err_msg=f"next-hop tables diverged at refresh tick {t}")

    assert NUM_TICKS in REFERENCE_PACK_TICKS
    np.testing.assert_array_equal(
        pack_state(state.road, net, state.selected_road).numpy(),
        reference_packed(state, net))
    # The trace exercised the physics: agents entered, moved through turn
    # transfers and finished.
    assert int(state.agents.done[1:].sum()) > 0
    assert int(state.metrics.hourly_counts.sum()) > 0


def test_contested_winner_follows_the_noise(braess):
    """Two due heads select one road: the injected noise decides which one
    moves, and the port moves the one the oracle moves."""
    net, agents = braess
    dst, src = net.edge_dst.numpy(), net.edge_src.numpy()
    v = int(np.flatnonzero(np.bincount(dst, minlength=net.num_roads) >= 2)[0])
    ups = [int(u) for u in src[dst == v][:2]]
    t_now = 6 * 3600.0 + 100.0
    road = init_road_state(net.num_roads, net.nmax, "cpu")
    ids = road.fifo_ids.clone()
    dest = road.fifo_dest.clone()
    dep = road.fifo_departure.clone()
    count = road.count.clone()
    for a, u in zip((1, 2), ups):
        ids[u, 0], dest[u, 0], dep[u, 0], count[u] = (
            a, agents.dest[a], t_now - 5.0, 1)
    road = road._replace(fifo_ids=ids, fifo_dest=dest, fifo_departure=dep,
                         count=count)
    sel = torch.zeros(net.num_nodes, dtype=torch.int32)
    sel[ups] = v
    on_way = agents._replace(inserted=torch.isin(
        torch.arange(agents.num_agents), torch.tensor([1, 2])))
    slot_edge = in_slot_edge_table(net)
    movers = set()
    for seed in range(32):
        key = rng.prng_key(seed)
        accept, _, agent, agent_dest, popped = direction_confirm(
            road, sel, net, t_now, key)
        moved, _ = apply_transfers(road, net, t_now, accept, agent,
                                   agent_dest, popped)
        ref = oracle(net, road, on_way, sel, t_now)
        ref.direction(edge_gumbel(key, net, slot_edge))
        ref.response()
        np.testing.assert_array_equal(
            pack_state(moved, net, sel).numpy(), ref.canonical_x(),
            err_msg=f"key {seed}")
        assert int(moved.count[v]) == 1
        movers.add(int(moved.fifo_ids[v, 0]))
    assert movers == {1, 2}
