"""The port's packed state view and the ring views under it, against the
JAX reference on the CPU, bitwise.

* ``FeatureHelpers`` for Nmax in {1, 5, 256} and
  ``ObservationFeatureHelpers``: every column the reference's maps name;
  the observation map's first seven columns are ``rl.observation.
  node_features``'s order and the packed row's last seven.
* ``RoadState.tail_ids`` and ``logical_view``, ``BacklogState.capacity``
  and ``qdest``, and ``schema.pack_state`` against the reference's on the
  states of a Grid4x4 backlog episode (with wrapped ring heads and
  non-empty queues) and on seeded random rings (full, empty and wrapped
  queues), carried across by ``convert.to_numpy``.
* The facade's ``packed_x()`` and ``h`` against the reference facade's
  on TwoLink and Braess, with the reference's own layout checks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tarl_tpu import schema as ref_schema
from tarl_tpu.io.scenarios import ensure_scenario
from tarl_tpu.simulator import TransportationSimulator as RefSim
from tarl_tpu.simulator import make_policy as ref_make_policy
from tarl_tpu.state import BacklogState as RefBacklogState
from tarl_tpu.state import RoadState as RefRoadState

from tarl_tpu_torch import convert, schema
from tarl_tpu_torch.config import SimConfig
from tarl_tpu_torch.core import step
from tarl_tpu_torch.rl.observation import node_features
from tarl_tpu_torch.routing.policies import random_choice
from tarl_tpu_torch.simulator import TransportationSimulator as PortSim
from tarl_tpu_torch.simulator import make_policy
from tarl_tpu_torch.state import RoadState, sort_agents_by_departure

from test_torch_network import load_both

torch.set_num_threads(1)

START = 6 * 3600
BACKLOG = SimConfig(
    start_time=START, record_road_optimality=False, insert_window=32,
    insert_backlog=256, withdraw_depth=2, sorted_population=True,
    insert_escalate=True, withdraw_escalate=True)
CAPTURE_EVERY = 200
CAPTURES = 3
# Every column attribute of the packed map (the slices and ints).
PACKED_COLUMNS = (
    "AGENT_POSITION", "AGENT_TIME_ARRIVAL", "AGENT_TIME_DEPARTURE",
    "MAX_NUMBER_OF_AGENT", "NUMBER_OF_AGENT", "FREE_FLOW_TIME_TRAVEL",
    "LENGHT_OF_ROAD", "MAX_FLOW", "SELECTED_ROAD", "ROAD_INDEX", "NODE_TYPE",
    "HEAD_FIFO", "HEAD_FIFO_ARRIVAL_TIME", "HEAD_FIFO_DEPARTURE_TIME",
    "CONGESTION_FILE", "width", "Nmax")
# The observation's first seven columns, as node_features orders them.
NODE_COLUMNS = ("MAX_NUMBER_OF_AGENT", "NUMBER_OF_AGENT",
                "FREE_FLOW_TIME_TRAVEL", "LENGHT_OF_ROAD", "MAX_FLOW",
                "SELECTED_ROAD", "ROAD_INDEX")


def public(cls) -> dict:
    return {k: getattr(cls, k) for k in dir(cls) if not k.startswith("_")}


@pytest.mark.parametrize("nmax", [1, 5, 256])
def test_feature_helpers_columns(nmax):
    got, want = schema.FeatureHelpers(Nmax=nmax), ref_schema.FeatureHelpers(
        Nmax=nmax)
    assert set(public(type(got))) == set(public(type(want)))
    for name in PACKED_COLUMNS:
        assert getattr(got, name) == getattr(want, name), name
    assert got.width == 3 * nmax + 7 and got.NODE_TYPE == got.width


def test_observation_helpers_columns():
    assert public(schema.ObservationFeatureHelpers) == public(
        ref_schema.ObservationFeatureHelpers)
    assert public(schema.AgentFeatureHelpers) == public(
        ref_schema.AgentFeatureHelpers)
    h = schema.FeatureHelpers(Nmax=5)
    obs = schema.ObservationFeatureHelpers
    assert [getattr(obs, c) for c in NODE_COLUMNS] == list(range(7))
    assert [getattr(h, c) - 3 * h.Nmax for c in NODE_COLUMNS] == list(
        range(7))


@pytest.fixture(scope="module")
def grid4_states(tmp_path_factory):
    """The port's Grid4x4 backlog episode, captured every 200 ticks, with
    the reference's network."""
    root = str(tmp_path_factory.mktemp("torch_schema_scen"))
    ref_net, _, net, agents = load_both(root, "Grid4x4")
    agents = sort_agents_by_departure(agents)
    policy = step.Policy(choice=random_choice)
    state = step.init_sim_state(net, agents, sim=BACKLOG, policy=policy)
    states = []
    for _ in range(CAPTURES):
        state, _ = step.run_episode(state, net, policy, CAPTURE_EVERY,
                                    sim=BACKLOG)
        states.append(state)
    return ref_net, net, states


def random_rings(nmax: int, roads: int, seed: int) -> RoadState:
    """Seeded rings: random heads, and counts of 0, ``nmax`` and between."""
    g = np.random.default_rng(seed)
    count = g.integers(0, nmax + 1, roads).astype(np.int32)
    count[:2] = (0, nmax)
    return RoadState(
        fifo_ids=torch.as_tensor(g.integers(1, 1 << 20, (roads, nmax),
                                            dtype=np.int32)),
        fifo_arrival=torch.as_tensor(g.uniform(2e4, 3e4, (roads, nmax))
                                     .astype(np.float32)),
        fifo_departure=torch.as_tensor(g.uniform(2e4, 3e4, (roads, nmax))
                                       .astype(np.float32)),
        fifo_dest=torch.as_tensor(g.integers(0, 99, (roads, nmax),
                                             dtype=np.int32)),
        head=torch.as_tensor(g.integers(0, nmax, roads).astype(np.int32)),
        count=torch.as_tensor(count),
    )


def to_ref(nt, cls):
    """A port named tuple as the reference's, through ``convert``."""
    return cls(**{k: jnp.asarray(v) for k, v in convert.to_numpy(nt).items()})


def road_cases(grid4_states):
    ref_net, net, states = grid4_states
    cases = [(f"grid4 tick {CAPTURE_EVERY * (i + 1)}", s.road,
              s.selected_road, net, ref_net)
             for i, s in enumerate(states)]
    g = np.random.default_rng(3)
    for seed in range(2):
        sel = torch.as_tensor(g.integers(-1, net.num_roads, net.num_nodes)
                              .astype(np.int32))
        cases.append((f"random rings {seed}",
                      random_rings(net.nmax, net.num_roads, seed), sel, net,
                      ref_net))
    return cases


def test_grid4_states_wrap_and_queue(grid4_states):
    """The episode's states exercise the ring: a queue wraps past the end
    of its row, and queues are not empty."""
    _, _, states = grid4_states
    assert any(int(((s.road.head + s.road.count) > s.road.nmax).sum()) > 0
               for s in states)
    assert all(int(s.road.count.sum()) > 0 for s in states)


def test_ring_views_equal_the_references(grid4_states):
    for label, road, _, _, _ in road_cases(grid4_states):
        ref = to_ref(road, RefRoadState)
        np.testing.assert_array_equal(road.tail_ids().numpy(),
                                      np.asarray(ref.tail_ids()), label)
        views = road.logical_view()
        assert [v.dtype for v in views] == [torch.int32, torch.float32,
                                            torch.float32]
        for got, want in zip(views, ref.logical_view()):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          label)
        ids, _, _ = road.logical_view()
        np.testing.assert_array_equal(ids[:, 0][road.count > 0],
                                      road.head_ids()[road.count > 0])


def test_backlog_views_equal_the_references(grid4_states):
    _, _, states = grid4_states
    for s in states:
        ref = to_ref(s.backlog, RefBacklogState)
        assert s.backlog.capacity == ref.capacity == BACKLOG.insert_backlog
        np.testing.assert_array_equal(s.backlog.qdest.numpy(),
                                      np.asarray(ref.qdest))
        np.testing.assert_array_equal(s.backlog.qids.numpy(),
                                      np.asarray(ref.qids))


def test_pack_state_equals_the_references(grid4_states):
    for label, road, sel, net, ref_net in road_cases(grid4_states):
        x = schema.pack_state(road, net, sel)
        want = np.asarray(ref_schema.pack_state(
            to_ref(road, RefRoadState), ref_net, jnp.asarray(sel.numpy())))
        assert x.dtype == torch.float32 and x.shape == want.shape
        np.testing.assert_array_equal(x.numpy(), want, label)


def test_pack_state_tail_is_node_features(grid4_states):
    """The packed row's last seven columns are the observation's node
    features, in the observation map's order."""
    _, net, states = grid4_states
    s = states[-1]
    h = schema.FeatureHelpers(Nmax=net.nmax)
    x = schema.pack_state(s.road, net, s.selected_road)
    feats = node_features(s, net)
    obs = schema.ObservationFeatureHelpers
    for c in NODE_COLUMNS:
        np.testing.assert_array_equal(x[:, getattr(h, c)].numpy(),
                                      feats[:, getattr(obs, c)].numpy(), c)


@pytest.fixture(scope="module")
def scen_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_schema_facade"))
    for name in ("TwoLink", "Braess"):
        ensure_scenario(root, name)
    return root


@pytest.mark.parametrize("name,start,ticks", [("TwoLink", 0, 1),
                                              ("Braess", START, 120)])
def test_facade_packed_x(scen_root, tmp_path, name, start, ticks):
    sims = []
    for cls, policy, kw in ((RefSim, ref_make_policy, {}),
                            (PortSim, make_policy, {"device": "cpu"})):
        sim = cls(data_root=scen_root, save_root=str(tmp_path / cls.__module__),
                  **kw)
        sim.load_network(name)
        sim.load_population(name)
        sim.set_policy(policy("random", network=sim.network))
        sim.config_parameters(timestep_size=1, start_time=start)
        for _ in range(ticks):
            sim.run()
        sims.append(sim)
    ref, port = sims
    x = port.packed_x()
    assert x.device.type == "cpu" and x.dtype == torch.float32
    np.testing.assert_array_equal(x.numpy(), np.asarray(ref.packed_x()))
    assert port.h == schema.FeatureHelpers(Nmax=ref.h.Nmax)
    if name == "TwoLink":
        # The reference's layout checks: agent 1, inserted on road 0 at
        # t = 0, heads its FIFO.
        h = port.h
        x = x.numpy()
        assert x.shape == (port.network.num_nodes, 3 * h.Nmax + 7)
        assert x[0, h.HEAD_FIFO] == 1.0
        assert x[0, h.NUMBER_OF_AGENT] == 1.0
        assert x[0, h.MAX_NUMBER_OF_AGENT] == float(port.network.capacity[0])
        assert x[-1, h.ROAD_INDEX] == -1.0
    else:
        assert int(port.state.road.count.sum()) > 0
