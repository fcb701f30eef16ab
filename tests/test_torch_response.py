"""The port's legacy confirm (``core/response.response_step``) against the
JAX reference's, on the CPU.

* Grid4x4 states of the port's random-policy episode at ticks 900, 1,500 and
  2,100, each after the direction step's push (``direction_step``, the
  winners at the tails, no pop yet: the state the legacy confirm reads),
  carried to the reference: the popped mask and the road state bitwise.
* ``tests/test_core_physics.py::TestPingPongConfirm``'s case on both
  packages: an agent moving onto the empty opposing road fires the confirm
  on both roads (the reference's documented double fire, copied on
  purpose), and the agent vanishes; the results bitwise.
* The per-road max runs over ``Network.edge_src_layout``, built once from
  ``edge_src``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tarl_tpu.core.response import response_step as ref_response_step
from tarl_tpu.state import RoadState as RefRoadState

from tarl_tpu_torch import convert
from tarl_tpu_torch.config import SimConfig
from tarl_tpu_torch.core import rng
from tarl_tpu_torch.core import step as p_step
from tarl_tpu_torch.core.direction import direction_step
from tarl_tpu_torch.core.response import response_step
from tarl_tpu_torch.network import build_network
from tarl_tpu_torch.routing.policies import random_choice
from tarl_tpu_torch.state import init_road_state

from test_torch_network import assert_tree_equal, load_both

torch.set_num_threads(1)


def _ref_road(road) -> RefRoadState:
    return RefRoadState(**{f: jnp.asarray(getattr(road, f).numpy())
                           for f in RefRoadState._fields})


def _both_confirms(road, net, ref_net):
    got_road, got = response_step(road, net)
    want_road, want = ref_response_step(_ref_road(road), ref_net)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert_tree_equal(convert.to_numpy(want_road), convert.to_numpy(got_road),
                      "road")
    return got_road, got


@pytest.fixture(scope="module")
def grid4(tmp_path_factory):
    return load_both(str(tmp_path_factory.mktemp("torch_response")),
                     "Grid4x4")


@pytest.mark.parametrize("ticks", [900, 1500, 2100])
def test_response_step_matches_the_reference(grid4, ticks):
    net, agents, pnet, pagents = grid4
    sim = SimConfig(start_time=6 * 3600, record_road_optimality=False)
    policy = p_step.Policy(choice=random_choice)
    state = p_step.init_sim_state(pnet, pagents, sim=sim, policy=policy)
    state, _ = p_step.run_episode(state, pnet, policy, ticks, sim=sim)
    state, _ = random_choice(state, pnet)
    road, _, accept, _ = direction_step(
        state.road, state.selected_road, pnet, state.time,
        rng.direction_gumbel(rng.prng_key(ticks), pnet))
    assert int(accept.sum()) > 0
    _, popped = _both_confirms(road, pnet, net)
    assert int(popped.sum()) >= int(accept.sum())
    assert pnet.edge_src_layout.ids is pnet.edge_src


def _single_road():
    length = np.array([5 * 7.5, 5 * 7.5])
    return dict(length=length, max_flow=np.array([10.0, 10.0]),
                free_speed=length / 10.0, perm_lanes=np.array([1.0, 1.0]),
                from_inter=np.array([0, 1]), to_inter=np.array([1, 0]),
                num_intersections=2)


def test_legacy_tail_head_check_double_fires():
    from tarl_tpu.network import build_network as ref_build_network

    net = build_network(**_single_road(), device="cpu")
    ref_net = ref_build_network(**_single_road())
    road = init_road_state(net.num_roads, net.nmax, "cpu")
    ids, dep, count = (road.fifo_ids.clone(), road.fifo_departure.clone(),
                       road.count.clone())
    ids[0, 0], dep[0, 0], count[0] = 7, 0.0, 1
    road = road._replace(fifo_ids=ids, fifo_departure=dep, count=count)
    sel = torch.tensor([1, 0] + [-1] * (net.num_nodes - 2),
                       dtype=torch.int32)
    road2, _, accept, win = direction_step(
        road, sel, net, 10.0, rng.direction_gumbel(rng.prng_key(0), net))
    assert bool(accept[1]) and int(win[1]) == 0
    legacy, popped = _both_confirms(road2, net, ref_net)
    assert bool(popped[0]) and bool(popped[1])
    assert int(legacy.count.sum()) == 0
