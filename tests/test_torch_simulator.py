"""The port's simulator facade, episode runner and caches against the JAX
reference.

* The eager tick: ``TransportationSimulator.run()`` on both packages,
  tick by tick on Braess under the dual dijkstra policy and under random
  choice: every tick's leg-histogram row ``[departures, arrivals, on_way,
  time]`` and road-optimality row bitwise, and the final state bitwise.
* ``run_fast`` (the periodic driver, refresh-aligned) against ``run()``:
  the same state and logs, bitwise; the phase timers.
* The road-optimality stores on Grid4x4: "sparse" reconstructs "dense"
  bitwise (all roads and a subset), its per-road totals; the blow-out to
  "hourly" at once and after a kept prefix, after which the figure is
  drawn from the hourly accumulator.
* The caches: network, population and mid-episode state round trips
  (bitwise); a reference cache file in the same directory is left as it
  is, and neither package's loader takes the other's file; a stale tag is
  rebuilt.
* ``algorithms.episode.run_episode``: fused and eager give the same
  episode; the fused chunks are cut to the refresh period; cProfile's
  report and the trace are written.
"""
import os

import numpy as np
import pytest
import torch

from tarl_tpu.algorithms.episode import run_episode as ref_run_episode
from tarl_tpu.io import cache as ref_cache
from tarl_tpu.io.scenarios import ensure_scenario
from tarl_tpu.simulator import TransportationSimulator, make_policy

from tarl_tpu_torch import convert
from tarl_tpu_torch.algorithms.episode import run_episode
from tarl_tpu_torch.core.fused_winner import direction_confirm_plain
from tarl_tpu_torch.io import cache
from tarl_tpu_torch.simulator import PhaseTimers
from tarl_tpu_torch.simulator import TransportationSimulator as PortSim
from tarl_tpu_torch.simulator import make_policy as p_make_policy

from test_torch_network import assert_tree_equal

torch.set_num_threads(1)

START = 6 * 3600


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_sim_scen"))
    for s in ("Braess", "Grid4x4"):
        ensure_scenario(root, s)
    return root


def _port_sim(root, save, scenario, algo, **kw):
    sim = PortSim(data_root=root, save_root=save, device="cpu", **kw)
    sim.load_network(scenario)
    sim.load_population(scenario)
    sim.set_policy(p_make_policy(algo, network=sim.network))
    sim.config_parameters(timestep_size=1, start_time=START)
    return sim


def _ref_sim(root, save, scenario, algo):
    sim = TransportationSimulator(data_root=root, save_root=save)
    sim.load_network(scenario)
    sim.load_population(scenario)
    sim.set_policy(make_policy(algo, network=sim.network))
    sim.config_parameters(timestep_size=1, start_time=START)
    return sim


@pytest.mark.parametrize("algo", ["dijkstra", "random"])
def test_eager_run_matches_reference(data_root, tmp_path, algo):
    ref = _ref_sim(data_root, str(tmp_path / "r"), "Braess", algo)
    port = _port_sim(data_root, str(tmp_path / "p"), "Braess", algo)
    assert_tree_equal(convert.to_numpy(ref.state),
                      convert.to_numpy(port.state), "initial")
    for i in range(300):
        ref.run()
        port.run()
        assert ref.leg_histogram_values[-1] == \
            port.leg_histogram_values[-1], f"tick {i}"
        t_ref, d_ref = ref.road_optimality_values[-1]
        t_port, d_port = port.road_optimality_values[-1]
        assert t_ref == t_port
        np.testing.assert_array_equal(np.asarray(d_ref), d_port)
    assert_tree_equal(convert.to_numpy(ref.state),
                      convert.to_numpy(port.state), "final")
    assert port.time == START + 300
    assert sum(row[1] for row in port.leg_histogram_values) > 0


def test_run_fast_matches_run(data_root, tmp_path):
    eager = _port_sim(data_root, str(tmp_path / "a"), "Grid4x4", "dijkstra")
    fast = _port_sim(data_root, str(tmp_path / "b"), "Grid4x4", "dijkstra")
    assert fast.policy.periodic_rate == 10
    for _ in range(200):
        eager.run(core=direction_confirm_plain)
    logs = fast.run_fast(200)
    assert logs.departures.shape == (200,)
    assert_tree_equal(convert.to_numpy(eager.state),
                      convert.to_numpy(fast.state), "state")
    assert eager.leg_histogram_values == fast.leg_histogram_values
    for (ta, da), (tb, db) in zip(eager.road_optimality_values,
                                  fast.road_optimality_values):
        assert ta == tb
        np.testing.assert_array_equal(da, db)
    t = eager.timers
    assert min(t.inserting_time, t.withdraw_time, t.choice_time,
               t.core_time) > 0.0
    assert t.total == pytest.approx(t.inserting_time + t.withdraw_time
                                    + t.choice_time + t.core_time)
    assert fast.timers == PhaseTimers()
    eager.reset()
    assert eager.time == START and eager.timers == PhaseTimers()
    assert not eager.leg_histogram_values
    assert int(eager.state.road.count.sum()) == 0


def test_sparse_store_matches_dense(data_root, tmp_path):
    dense = _port_sim(data_root, str(tmp_path / "d"), "Grid4x4", "random")
    dense.run_fast(400)
    sparse = _port_sim(data_root, str(tmp_path / "s"), "Grid4x4", "random")
    sparse.road_optimality_store = "sparse"
    for _ in range(4):
        sparse.run_fast(100)
    assert len(dense.road_optimality_values) == 400
    assert not dense.road_optimality_sparse
    assert len(sparse.road_optimality_sparse) == 400
    assert not sparse.road_optimality_values
    r = dense.network.num_roads
    td, md = dense.road_optimality_series(range(r))
    ts, ms = sparse.road_optimality_series(range(r))
    np.testing.assert_array_equal(td, ts)
    np.testing.assert_array_equal(md, ms)
    assert ms.sum() > 0.0
    sub = [3, 0, r - 1]
    np.testing.assert_array_equal(sparse.road_optimality_series(sub)[1],
                                  md[:, sub])
    np.testing.assert_allclose(sparse._sparse_road_total,
                               np.abs(md).sum(axis=0), rtol=1e-6)


@pytest.mark.parametrize("budget,kept", [(10, 0), (None, 100)])
def test_sparse_blowout_to_hourly(data_root, tmp_path, budget, kept):
    probe = _port_sim(data_root, str(tmp_path / "q"), "Grid4x4", "random")
    probe.road_optimality_store = "sparse"
    probe.run_fast(100)
    if budget is None:   # the first chunk fits, the second does not
        budget = probe._sparse_nnz
    sim = _port_sim(data_root, str(tmp_path / "h"), "Grid4x4", "random",
                    sparse_nnz_budget=budget)
    sim.road_optimality_store = "sparse"
    sim.run_fast(100)
    sim.run_fast(200)
    assert sim.road_optimality_store == "hourly"
    assert len(sim.road_optimality_sparse) == kept
    times, mat = sim.road_optimality_series([0, 1])
    assert times.shape == (kept,) and mat.shape == (kept, 2)
    assert float(sim.state.metrics.delta_tt_hourly.sum()) > 0.0
    # Past the blow-out the road-optimality figure comes from the hourly
    # accumulator, a line a road over the hours with traffic.
    import matplotlib.pyplot as plt

    hourly = sim.state.metrics.delta_tt_hourly.sum(dim=1).numpy()
    lines = sim.plot_road_optimality(None).axes[0].get_lines()
    plt.close("all")
    assert len(lines) == sim.network.num_roads
    np.testing.assert_array_equal(lines[0].get_xdata(),
                                  np.arange(np.nonzero(hourly)[0][-1] + 1))
    assert len(sim.compute_node_metrics(None)) == sim.network.num_roads


def test_cache_round_trips(data_root, tmp_path):
    save = str(tmp_path / "save")
    ref_net = ref_cache.load_or_build_network("Grid4x4", data_root, save)
    ref_cache.load_or_build_population("Grid4x4", data_root, save)
    ref_files = [os.path.join(save, "Grid4x4", f)
                 for f in ("network.npz", "population.npz")]
    before = [(open(f, "rb").read(), os.stat(f).st_mtime_ns)
              for f in ref_files]

    net = cache.load_or_build_network("Grid4x4", data_root, save, "cpu")
    agents = cache.load_or_build_population("Grid4x4", data_root, save,
                                            "cpu")
    port_files = [os.path.join(save, "Grid4x4", f)
                  for f in (cache.NETWORK_FILE, cache.POPULATION_FILE)]
    assert all(os.path.exists(f) for f in port_files)
    assert not set(port_files) & set(ref_files)
    net2 = cache.load_or_build_network("Grid4x4", data_root, save, "cpu")
    agents2 = cache.load_or_build_population("Grid4x4", data_root, save,
                                             "cpu")
    assert_tree_equal(convert.to_numpy(net), convert.to_numpy(net2), "net")
    assert_tree_equal(convert.to_numpy(agents), convert.to_numpy(agents2),
                      "agents")
    np.testing.assert_array_equal(np.asarray(ref_net.free_flow),
                                  net2.free_flow.numpy())
    assert [(open(f, "rb").read(), os.stat(f).st_mtime_ns)
            for f in ref_files] == before

    # Neither package takes the other's file.
    with pytest.raises(ValueError):
        cache.load_network_cache(ref_files[0], "cpu")
    with pytest.raises(ValueError):
        cache.load_population_cache(ref_files[1], "cpu")
    with pytest.raises((ValueError, KeyError)):
        ref_cache.load_network_cache(port_files[0])
    # A file of another tag is stale: rebuilt from the XML.
    np.savez(port_files[0], __tarl_tpu_torch__=np.asarray("old"))
    net3 = cache.load_or_build_network("Grid4x4", data_root, save, "cpu")
    assert_tree_equal(convert.to_numpy(net), convert.to_numpy(net3), "net3")


def test_sim_state_round_trip(data_root, tmp_path):
    sim = _port_sim(data_root, str(tmp_path / "s"), "Grid4x4", "dijkstra")
    sim.run_fast(150)
    path = str(tmp_path / "state.npz")
    cache.save_sim_state(sim.state, path)
    restored = cache.load_sim_state(sim.state, path, "cpu")
    assert_tree_equal(convert.to_numpy(sim.state),
                      convert.to_numpy(restored), "restored")
    assert isinstance(restored.time, float) and restored.insert_ptr == \
        sim.state.insert_ptr
    other = _port_sim(data_root, str(tmp_path / "o"), "Grid4x4", "dijkstra")
    other.state = restored
    sim.run_fast(50)
    other.run_fast(50)
    assert_tree_equal(convert.to_numpy(sim.state),
                      convert.to_numpy(other.state), "resumed")
    random_sim = _port_sim(data_root, str(tmp_path / "x"), "Grid4x4",
                           "random")
    with pytest.raises(ValueError, match="template"):
        cache.load_sim_state(random_sim.state, path, "cpu")


def test_episode_runner_fused_equals_eager(data_root, tmp_path):
    fused = _port_sim(data_root, str(tmp_path / "f"), "Braess", "dijkstra")
    eager = _port_sim(data_root, str(tmp_path / "e"), "Braess", "dijkstra")
    chunks = []
    run_fast = fused.run_fast

    def recording(n):
        chunks.append(n)
        return run_fast(n)

    fused.run_fast = recording
    prof = tmp_path / "prof" / "profile.txt"
    run_episode(fused, 110, mode="fused", chunk=25, profile=True,
                profile_output=prof, jax_trace_dir=str(tmp_path / "trace"),
                progress=False)
    # Cut from 25 to the refresh period's multiple, 20: every chunk but the
    # last takes the periodic driver.
    assert chunks == [20, 20, 20, 20, 20, 10]
    assert prof.read_text().strip()
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0
    assert fused.timers.core_time > 0.0 and fused.timers.choice_time == 0.0
    run_episode(eager, 110, mode="eager", progress=False)
    assert_tree_equal(convert.to_numpy(fused.state),
                      convert.to_numpy(eager.state), "state")
    assert fused.leg_histogram_values == eager.leg_histogram_values
    assert eager.timers.choice_time > 0.0
    with pytest.raises(ValueError):
        run_episode(eager, 1, mode="lazy", progress=False)


def test_episode_runner_matches_reference(data_root, tmp_path):
    """The reference runner's fused episode and the port's, Braess under
    dual dijkstra: the final state bitwise."""
    ref = _ref_sim(data_root, str(tmp_path / "r"), "Braess", "dijkstra")
    port = _port_sim(data_root, str(tmp_path / "p"), "Braess", "dijkstra")
    ref_run_episode(ref, 600, chunk=128, progress=False)
    run_episode(port, 600, chunk=128, progress=False)
    assert_tree_equal(convert.to_numpy(ref.state),
                      convert.to_numpy(port.state), "final")
    assert ref.leg_histogram_values == port.leg_histogram_values
    assert port.average_travel_time() == ref.average_travel_time()
