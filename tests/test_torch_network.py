"""The PyTorch port's ingestion against the JAX reference.

For each builtin scenario, the port's ``load_network`` / ``load_population``
(its own XML parser) must give every ``Network`` field the port keeps and
every ``AgentState`` column equal to the reference's, dtype and value
exactly; so must ``sort_agents_by_departure`` and ``default_selected_road``.
A round trip through ``tarl_tpu_torch.convert`` is the identity.

The helpers here are shared by the other ``test_torch_*`` files.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from tarl_tpu.io.matsim import load_network, load_population
from tarl_tpu.io.scenarios import ensure_scenario
from tarl_tpu.network import default_selected_road
from tarl_tpu.state import init_agent_state, sort_agents_by_departure

import tarl_tpu_torch.io.matsim as port_matsim
from tarl_tpu_torch import convert
from tarl_tpu_torch.network import Network as PortNetwork
from tarl_tpu_torch.network import (
    default_selected_road as port_default_selected_road,
)
from tarl_tpu_torch.state import init_agent_state as port_init_agent_state
from tarl_tpu_torch.state import (
    sort_agents_by_departure as port_sort_agents,
)

torch.set_num_threads(1)

SCENARIOS = ["TwoLink", "Braess", "Easy", "Grid4x4", "Grid8x8"]
PORT_NETWORK_FIELDS = [f.name for f in dataclasses.fields(PortNetwork)]


def load_both(root: str, scenario: str):
    """``(ref_net, ref_agents, port_net, port_agents)`` parsed from the same
    scenario files by each package's own loader."""
    base = ensure_scenario(root, scenario)
    net_path = os.path.join(base, "network")
    pop_path = os.path.join(base, "population")
    net = load_network(net_path)
    agents, _ = load_population(pop_path, net_path)
    pnet = port_matsim.load_network(net_path, device="cpu")
    pagents, _ = port_matsim.load_population(pop_path, net_path,
                                             device="cpu")
    return net, agents, pnet, pagents


def assert_tree_equal(ref, port, path="root"):
    """Nested numpy dicts (``convert.to_numpy`` of either package's objects)
    equal in structure, dtype, shape and every element."""
    if isinstance(ref, dict):
        assert isinstance(port, dict), path
        for k in ref:
            assert k in port, f"{path}.{k} missing in the port"
            assert_tree_equal(ref[k], port[k], f"{path}.{k}")
        return
    if ref is None:
        assert port is None, path
        return
    a, b = np.asarray(ref), np.asarray(port)
    assert a.dtype == b.dtype, f"{path}: dtype {a.dtype} vs {b.dtype}"
    assert a.shape == b.shape, f"{path}: shape {a.shape} vs {b.shape}"
    bad = np.argwhere(~((a == b) | (np.isnan(a) & np.isnan(b)))
                      if a.dtype.kind == "f" else a != b)
    assert bad.size == 0, f"{path}: {len(bad)} elements differ, first {bad[:3]}"


@pytest.fixture(scope="module")
def scen_root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("torch_net_scen"))


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_network_and_agents_equal(scen_root, scenario):
    net, agents, pnet, pagents = load_both(scen_root, scenario)
    ref = convert.to_numpy(net)
    port = convert.to_numpy(pnet)
    for name in PORT_NETWORK_FIELDS:
        assert_tree_equal(ref[name], port[name], name)
    assert_tree_equal(convert.to_numpy(agents), convert.to_numpy(pagents),
                      "agents")
    assert_tree_equal(np.asarray(default_selected_road(net)),
                      port_default_selected_road(pnet).numpy(),
                      "default_selected_road")
    assert_tree_equal(convert.to_numpy(sort_agents_by_departure(agents)),
                      convert.to_numpy(port_sort_agents(pagents)),
                      "sorted agents")


@pytest.mark.parametrize("scenario", ["Braess", "Grid4x4"])
def test_convert_round_trip(scen_root, scenario):
    """Reference arrays carried across by ``convert`` rebuild the port's own
    objects, and ``to_numpy`` brings them back unchanged."""
    net, agents, pnet, pagents = load_both(scen_root, scenario)
    carried = convert.network_from_numpy(convert.to_numpy(net),
                                         device="cpu")
    assert_tree_equal(convert.to_numpy(pnet), convert.to_numpy(carried),
                      "network")
    assert carried.num_roads == pnet.num_roads
    assert carried.nmax == pnet.nmax
    assert carried.renumbered is False
    again = convert.network_from_numpy(convert.to_numpy(pnet),
                                      device="cpu")
    assert_tree_equal(convert.to_numpy(pnet), convert.to_numpy(again),
                      "network round trip")
    back = convert.agents_from_numpy(convert.to_numpy(agents),
                                     device="cpu")
    assert_tree_equal(convert.to_numpy(pagents), convert.to_numpy(back),
                      "agents")


def test_init_agent_state():
    r = np.random.default_rng(0)
    cols = dict(origin=r.integers(0, 9, 7), dest=r.integers(0, 9, 7),
                departure=r.random(7) * 1e4, age=r.random(7) * 80,
                sex=r.integers(0, 2, 7).astype(float))
    assert_tree_equal(convert.to_numpy(init_agent_state(**cols)),
                      convert.to_numpy(port_init_agent_state(**cols,
                                                             device="cpu")))
