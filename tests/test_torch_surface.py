"""The last of the reference's public surface in the port, against the JAX
reference on the CPU (bitwise unless a case says otherwise).

* The package's exports are the reference's, and an AST walk of both
  packages finds every public function, class, method and dataclass field
  of ``tarl_tpu`` in the port's file of the same path, but for the names
  cut on purpose (:data:`CUT`, the TPU-only machinery).
* ``Network``'s ``num_turn_edges``, ``num_full_edges``,
  ``src_node_indices``, ``dest_node_indices`` and ``dense_adjacency`` on
  Braess and Grid4x4.
* ``routing.bellman_ford.congested_next_hop``, distances and table, on a
  mid-episode Grid4x4 state.
* ``core.step.init_sim_state(next_hop=T)`` keeps ``T``, and a
  shortest-path episode from ``T`` equals the reference's from ``T``.
* ``io.scenarios.pad_network_xml``: the same XML as the reference's, an
  existing file reused, the base path where nothing is padded; the padded
  file parses to the reference's network, and the port's road-block
  dijkstra episode on it equals the serial episode of the unpadded
  network on the real roads.
* ``io.matsim``: ``ParsedNetwork.src_index`` / ``dest_index``,
  ``PopulationStats.summary``, and ``verbose=True`` printing what the
  reference's Python parser prints, from the Python and the native parser
  and through ``load_population``.
* ``rl.trainer.ppo_train``'s evaluation logs the figure
  ``eval/leg_histogram`` to TensorBoard; with ``plot_leg_histogram``
  unable to draw, training still finishes, with no figure.
"""
import ast
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tarl_tpu
from tarl_tpu.config import RoutingConfig as RefRoutingConfig
from tarl_tpu.config import SimConfig as RefSimConfig
from tarl_tpu.core.step import init_sim_state as ref_init_sim_state
from tarl_tpu.core.step import run_episode as ref_run_episode
from tarl_tpu.io import matsim as ref_matsim
from tarl_tpu.io import native as ref_native
from tarl_tpu.io import scenarios as ref_scenarios
from tarl_tpu.routing.bellman_ford import (
    congested_next_hop as ref_congested_next_hop,
)
from tarl_tpu.simulator import make_policy as ref_make_policy
from tarl_tpu.state import RoadState as RefRoadState

import tarl_tpu_torch
from tarl_tpu_torch import convert
from tarl_tpu_torch.config import RLConfig, RoutingConfig, SimConfig
from tarl_tpu_torch.core import step
from tarl_tpu_torch.core.rng import prng_key
from tarl_tpu_torch.io import matsim as p_matsim
from tarl_tpu_torch.io.scenarios import grid_scenario, pad_network_xml
from tarl_tpu_torch.metrics import reporting
from tarl_tpu_torch.models.mpnn import MPNNPolicyNet, MPNNValueNetSimple
from tarl_tpu_torch.parallel.sharded_episode import run_episode_sharded
from tarl_tpu_torch.parallel.shard_map_episode import make_road_mesh
from tarl_tpu_torch.rl.ppo import PPO
from tarl_tpu_torch.rl.trainer import ppo_train
from tarl_tpu_torch.routing.bellman_ford import congested_next_hop
from tarl_tpu_torch.routing.policies import random_choice
from tarl_tpu_torch.simulator import make_policy

from test_torch_network import PORT_NETWORK_FIELDS, assert_tree_equal, load_both

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
START = 6 * 3600

# The reference's public names the port leaves out on purpose: the TPU's
# evaluation strategies, which choose between bitwise-identical evaluations
# and carry no semantics on a GPU.  ``ROADMAP.md`` (queue 1) says why, name
# by name.
CUT_MODULES = {
    # Covered by csrc/segment.cu (K9-K11).
    "ops/pallas_segment.py",
    # The roll plans: the in-slot gather as lane rotations.
    "core/roll_gather.py",
}
CUT = {
    "network.py": {f"Network.{side}_roll_{f}" for side in ("in", "out")
                   for f in ("sel", "shift", "shift_t", "exc_k", "exc_src",
                             "exc_v")},
    # The port's plain_segments selects the plain reductions.
    "ops/segment.py": {"no_pallas"},
    # The delta buckets and the epilogue tables of the roll plans.
    "routing/bellman_ford.py": {"primal_delta_buckets",
                                "epilogue_slot_tables"},
    # K1's launch serves the fused and the column-tiled forms; the gates
    # were VMEM and roll-plan limits.
    "core/fused_winner.py": {"direction_confirm_fused",
                             "direction_confirm_fused_tiled",
                             "fused_winner_ok", "fused_winner_tiled_ok",
                             "fused_shard_winner_ok"},
    # Named timers nothing read; the port times its layers with spans.
    "utils/timers.py": {"Stopwatch", "Stopwatch.time", "Stopwatch.summary",
                        "Stopwatch.totals"},
}


def public_names(path: str, aliases: bool = False) -> set:
    """Top-level functions and classes (and with ``aliases`` the names
    assigned at top level, such as ``make_node_mesh = make_road_mesh``);
    each class's methods and annotated fields (but a Flax ``nn.Module``'s,
    whose fields are its constructor's arguments), all without a leading
    underscore."""
    with open(path) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif aliases and isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
        if isinstance(node, ast.ClassDef):
            flax = any(ast.unparse(b) == "nn.Module" for b in node.bases)
            for m in node.body:
                if isinstance(m, ast.FunctionDef):
                    out.add(f"{node.name}.{m.name}")
                elif isinstance(m, ast.AnnAssign) and not flax:
                    out.add(f"{node.name}.{m.target.id}")
    return {n for n in out
            if not any(p.startswith("_") for p in n.split("."))}


def test_package_exports_the_references_names():
    with open(os.path.join(REPO, "tarl_tpu", "__init__.py")) as f:
        tree = ast.parse(f.read())
    names = {a.asname or a.name for node in tree.body
             if isinstance(node, ast.ImportFrom) for a in node.names}
    assert len(names) == 16
    for name in names:
        ours = getattr(tarl_tpu_torch, name)
        assert ours.__module__.startswith("tarl_tpu_torch."), name
        assert getattr(tarl_tpu, name).__name__ == ours.__name__, name


def test_public_surface_is_the_references():
    ref_root = os.path.join(REPO, "tarl_tpu")
    missing, cut_seen = {}, set()
    for dirpath, _, files in os.walk(ref_root):
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, f), ref_root)
            port = os.path.join(REPO, "tarl_tpu_torch", rel)
            if rel in CUT_MODULES:
                assert not os.path.exists(port), rel
                cut_seen.add(rel)
                continue
            assert os.path.exists(port), f"no port file for {rel}"
            cut = CUT.get(rel, set())
            ours = public_names(port, aliases=True)
            gone = public_names(os.path.join(dirpath, f)) - ours
            if gone - cut:
                missing[rel] = sorted(gone - cut)
            # A cut name is one the port really lacks.
            assert not cut & ours, rel
    assert missing == {}
    assert cut_seen == CUT_MODULES


@pytest.fixture(scope="module")
def scen_root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("torch_surface_scen"))


@pytest.mark.parametrize("scenario", ["Braess", "Grid4x4"])
def test_network_helpers(scen_root, scenario):
    net, _, pnet, _ = load_both(scen_root, scenario)
    assert pnet.num_turn_edges == net.num_turn_edges
    assert pnet.num_full_edges == net.num_full_edges
    for name in ("src_node_indices", "dest_node_indices", "dense_adjacency"):
        got = getattr(pnet, name)()
        want = np.asarray(getattr(net, name)())
        assert got.device == pnet.device
        assert_tree_equal(want, got.numpy(), name)
    assert int(pnet.dense_adjacency().sum()) == pnet.num_full_edges


@pytest.fixture(scope="module")
def grid4_mid(scen_root):
    """A Grid4x4 random episode's state at tick 300, with both networks
    and the port's agents."""
    net, agents, pnet, pagents = load_both(scen_root, "Grid4x4")
    sim = SimConfig(start_time=START)
    policy = step.Policy(choice=random_choice)
    state = step.init_sim_state(pnet, pagents, sim=sim, policy=policy)
    state, _ = step.run_episode(state, pnet, policy, 300, sim=sim)
    assert int(state.road.count.sum()) > 0
    return net, agents, pnet, pagents, state


def test_congested_next_hop(grid4_mid):
    net, _, pnet, _, state = grid4_mid
    dist, table = congested_next_hop(state.road, pnet)
    road = RefRoadState(**{k: jnp.asarray(v) for k, v in
                           convert.to_numpy(state.road).items()})
    want_dist, want_table = ref_congested_next_hop(road, net)
    assert_tree_equal(np.asarray(want_dist), dist.numpy(), "dist")
    assert_tree_equal(np.asarray(want_table), table.numpy(), "next_hop")
    # The congestion moves the table off the free-flow one.
    _, free = congested_next_hop(state.road._replace(
        count=torch.zeros_like(state.road.count)), pnet)
    assert not torch.equal(free, table)


def test_init_sim_state_takes_a_given_table(grid4_mid):
    net, agents, pnet, pagents, state = grid4_mid
    _, table = congested_next_hop(state.road, pnet)
    routing = RoutingConfig(refresh_rate=25)
    sim = SimConfig(start_time=START)
    policy = make_policy("dijkstra", routing=routing, network=pnet)
    ours = step.init_sim_state(pnet, pagents, sim=sim, policy=policy,
                               next_hop=table)
    assert ours.next_hop is table
    assert ours.sel_dest is not None
    ref_policy = ref_make_policy("dijkstra", routing=RefRoutingConfig(
        refresh_rate=25), network=net)
    ref_sim = RefSimConfig(start_time=START)
    ref = ref_init_sim_state(net, agents, sim=ref_sim, policy=ref_policy,
                             next_hop=jnp.asarray(table.numpy()))
    assert_tree_equal(convert.to_numpy(ref), convert.to_numpy(ours),
                      "initial state")
    ref_final, _ = ref_run_episode(ref, net, ref_policy, 60, sim=ref_sim)
    final, _ = step.run_episode(ours, pnet, policy, 60, sim=sim)
    assert_tree_equal(convert.to_numpy(ref_final), convert.to_numpy(final),
                      "final state")
    assert int(final.road.count.sum()) > 0


@pytest.fixture(scope="module")
def grid3x5(tmp_path_factory):
    """Grid3x5's files, written once by each package's generator."""
    out = {}
    for side, gen in (("ref", ref_scenarios.grid_scenario),
                      ("port", grid_scenario)):
        root = str(tmp_path_factory.mktemp(f"torch_pad_{side}"))
        out[side] = gen(root, "Grid3x5", rows=3, cols=5, num_agents=120)
    return out


def test_pad_network_xml_writes_the_references_file(grid3x5):
    bases = {side: os.path.join(b, "network") for side, b in grid3x5.items()}
    padded = {side: pad_network_xml(b, 8) if side == "port"
              else ref_scenarios.pad_network_xml(b, 8)
              for side, b in bases.items()}
    for side, b in bases.items():
        assert padded[side] == b + "_pad8"
    with open(padded["ref"] + ".xml", "rb") as f:
        want = f.read()
    with open(padded["port"] + ".xml", "rb") as f:
        assert f.read() == want
    # An existing file is reused, not rewritten.
    mtime = os.stat(padded["port"] + ".xml").st_mtime_ns
    assert pad_network_xml(bases["port"], 8) == padded["port"]
    assert os.stat(padded["port"] + ".xml").st_mtime_ns == mtime
    # 48 roads already divide into 16 blocks, and 4.
    assert pad_network_xml(padded["port"], 16) == padded["port"]
    assert pad_network_xml(padded["port"], 4) == padded["port"]
    assert not os.path.exists(padded["port"] + "_pad16.xml")
    # The padded file parses to the reference's network.
    ref_net = ref_matsim.load_network(padded["ref"])
    net = p_matsim.load_network(padded["port"], device="cpu")
    ref_d, d = convert.to_numpy(ref_net), convert.to_numpy(net)
    for name in PORT_NETWORK_FIELDS:
        assert_tree_equal(ref_d[name], d[name], name)
    assert net.num_roads == 48


def test_padded_road_blocks_equal_the_unpadded_episode(grid3x5):
    base = grid3x5["port"]
    net_base = os.path.join(base, "network")
    pop = os.path.join(base, "population")
    raw = p_matsim.load_network(net_base, device="cpu")
    assert raw.num_roads % 8 != 0, "the fixture must need padding"
    padded = pad_network_xml(net_base, 8)
    net = p_matsim.load_network(padded, device="cpu")
    agents, _ = p_matsim.load_population(pop, padded, device="cpu")
    raw_agents, _ = p_matsim.load_population(pop, net_base, device="cpu")

    routing = RoutingConfig(refresh_rate=10)
    sim = SimConfig(start_time=START, end_time=START + 600)
    serial_policy = make_policy("dijkstra", routing=routing)
    serial, serial_logs = step.run_episode(
        step.init_sim_state(raw, raw_agents, sim=sim, policy=serial_policy),
        raw, serial_policy, 600, sim=sim)
    policy = make_policy("dijkstra", routing=routing)
    blocks, logs = run_episode_sharded(
        step.init_sim_state(net, agents, sim=sim, policy=policy), net,
        policy, 600, make_road_mesh(8, "cpu"), sim=sim, routing=routing)

    r, a = raw.num_roads, raw_agents.num_agents
    assert torch.equal(blocks.agents.arrival[:a], serial.agents.arrival)
    assert torch.equal(blocks.road.count[:r], serial.road.count)
    assert torch.equal(blocks.metrics.hourly_counts[:, :r],
                       serial.metrics.hourly_counts)
    assert torch.equal(logs.arrivals, serial_logs.arrivals)
    # The pad roads are inert: never occupied, never traversed.
    assert int(blocks.road.count[r:].sum()) == 0
    assert int(blocks.metrics.hourly_counts[:, r:].sum()) == 0
    assert int(serial.agents.done[1:].sum()) > 0


def test_parsed_network_indices_and_summary(scen_root, monkeypatch):
    base = os.path.join(scen_root, "Grid4x4")
    load_both(scen_root, "Grid4x4")
    net_path, pop_path = (os.path.join(base, n)
                          for n in ("network", "population"))
    monkeypatch.setenv("TARL_NATIVE", "0")
    ref = ref_matsim.parse_network_xml(net_path)
    _, ref_stats = ref_matsim.parse_population_xml(pop_path, ref)
    for parser in ("python", "native"):
        ours = p_matsim.parse_network_xml(net_path, parser)
        for name in ours.sorted_intersections:
            assert ours.src_index(name) == ref.src_index(name)
            assert ours.dest_index(name) == ref.dest_index(name)
        _, stats = p_matsim.parse_population_xml(pop_path, ours, parser)
        assert stats.summary() == ref_stats.summary()
    with pytest.raises(ValueError):
        ours.src_index("no such intersection")


@pytest.mark.parametrize("scenario", ["Braess", "Grid4x4"])
def test_verbose_prints_the_references_lines(scen_root, scenario,
                                             monkeypatch, capsys):
    load_both(scen_root, scenario)
    base = os.path.join(scen_root, scenario)
    net_path, pop_path = (os.path.join(base, n)
                          for n in ("network", "population"))
    monkeypatch.setenv("TARL_NATIVE", "0")
    capsys.readouterr()
    ref_matsim.parse_population_xml(
        pop_path, ref_matsim.parse_network_xml(net_path), verbose=True)
    want = capsys.readouterr().out
    monkeypatch.delenv("TARL_NATIVE")
    assert want.startswith("👥 | Population created: ")
    assert "📊 | Departure histogram" in want
    for parser in ("python", "native"):
        parsed = p_matsim.parse_network_xml(net_path, parser)
        _, stats = p_matsim.parse_population_xml(pop_path, parsed, parser,
                                                 verbose=True)
        assert stats.parser == parser
        assert capsys.readouterr().out == want, parser
        p_matsim.load_population(pop_path, net_path, device="cpu",
                                 parser=parser, verbose=True)
        assert capsys.readouterr().out == want, parser
    p_matsim.parse_population_xml(pop_path, parsed, "native")
    assert capsys.readouterr().out == ""
    if ref_native.available():
        # The reference's native path prints its summary alone, tagged.
        monkeypatch.setenv("TARL_NATIVE", "1")
        ref_matsim.parse_population_xml(
            pop_path, ref_matsim.parse_network_xml(net_path), verbose=True)
        line = capsys.readouterr().out
        assert line == want.splitlines(True)[0].replace(
            "created:", "created (native):")


def tiny_ppo(scen_root):
    _, _, pnet, pagents = load_both(scen_root, "Braess")
    rl = RLConfig(episode_start=START, rollout_steps=8, minibatch_size=8)
    ppo = PPO(pnet, MPNNPolicyNet(pnet.num_nodes, pnet.num_roads + 1),
              MPNNValueNetSimple(pnet.num_nodes), rl=rl)
    st = step.init_sim_state(pnet, pagents,
                             policy=step.Policy(choice=random_choice))
    return ppo, st, rl


@pytest.mark.parametrize("drawable", [True, False])
def test_ppo_train_logs_the_leg_histogram(scen_root, tmp_path, monkeypatch,
                                          drawable):
    pytest.importorskip("torch.utils.tensorboard")
    pytest.importorskip("matplotlib")
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator,
    )

    drawn = []
    plot = reporting.plot_leg_histogram

    def spy(values, timestep, output_dir):
        drawn.append(values)
        if not drawable:
            raise reporting.PlottingUnavailable("cannot draw")
        return plot(values, timestep, output_dir)

    monkeypatch.setattr(reporting, "plot_leg_histogram", spy)
    ppo, st, rl = tiny_ppo(scen_root)
    log_dir = str(tmp_path / "logs")
    ppo_train(ppo, st, num_iterations=2, rl=rl, key=prng_key(5),
              generator=torch.Generator().manual_seed(5), log_dir=log_dir,
              eval_interval=1, eval_steps=30, verbose=False)
    assert len(drawn) == 2
    for values in drawn:
        rows = np.asarray(values)
        assert rows.shape == (30, 4)
        # [departures, arrivals, on the network, clock] per step: the
        # departures balance the occupancy's change and the arrivals.
        assert (np.diff(rows[:, 3]) >= 0).all() and rows[0, 3] > START
        np.testing.assert_array_equal(
            rows[:, 0], np.diff(rows[:, 2], prepend=0.0) + rows[:, 1])
    events = EventAccumulator(log_dir, size_guidance={"images": 0})
    events.Reload()
    assert "eval/avg_return" in events.Tags()["scalars"]
    images = events.Tags()["images"]
    assert ("eval/leg_histogram" in images) == drawable
    if drawable:
        assert [e.step for e in events.Images("eval/leg_histogram")] == [
            rl.rollout_steps, 2 * rl.rollout_steps]
