"""The port's reports (``tarl_tpu_torch.metrics.reporting`` through the
facade) against the JAX reference's, on the same Braess episode.

Both facades run the reference CLI's dual dijkstra row on Braess for
``TICKS`` ticks of ``run_fast`` (bitwise the same episode), with each
road-optimality store: "dense" (a row a tick), "sparse" (nonzero pairs a
tick) and "hourly" (no per-tick series: the hourly accumulator).  Then:

* ``node_metrics.csv`` and ``daily_counts.csv`` are byte-identical.  Both
  facades are handed the same expected counts (the reference's
  ``run_msa``), so the second file holds the writer to pandas' bytes; the
  port's assignment is held to the reference's in
  ``test_torch_equilibrium.py``;
* every line and scatter of ``leg_histogram.png``, ``road_optimality.png``
  and ``daily_counts.png`` holds the reference figure's data within rtol
  1e-6, with the same labels; ``computation_time.png`` from equal phase
  timers (they are wall clock) has the reference's wedges (angles within
  rtol 1e-6) and texts;
* ``get_info`` gives the same string for every road.

Without matplotlib, the drawing calls raise ``PlottingUnavailable`` (an
``ImportError`` naming matplotlib) after writing their CSV file, and the
CLI's summary prints one line naming the figures it did not draw while
still writing the CSV files and ``equilibrium_report.json``.
"""
import os
import sys

import numpy as np
import pytest
import torch

from tarl_tpu.algorithms.msa import run_msa
from tarl_tpu.config import SimConfig
from tarl_tpu.simulator import PhaseTimers, TransportationSimulator
from tarl_tpu.simulator import make_policy

from tarl_tpu_torch.config import SimConfig as PortSimConfig
from tarl_tpu_torch.metrics import reporting
from tarl_tpu_torch.runner import main as port_main
from tarl_tpu_torch.simulator import PhaseTimers as PortPhaseTimers
from tarl_tpu_torch.simulator import TransportationSimulator as PortSim
from tarl_tpu_torch.simulator import make_policy as port_make_policy

torch.set_num_threads(1)

START = 21600
TICKS = 1800
STORES = ("dense", "sparse", "hourly")
RTOL = 1e-6


def _facades(root: str, store: str):
    """Both facades after the Braess episode, with ``store``."""
    cfg = dict(timestep=1, start_time=START, end_time=START + TICKS,
               record_road_optimality=store != "hourly")
    out = []
    for cls, sim_cls, policy, kw in (
            (TransportationSimulator, SimConfig, make_policy, {}),
            (PortSim, PortSimConfig, port_make_policy, {"device": "cpu"})):
        sim = cls(sim=sim_cls(**cfg), data_root=os.path.join(root, "data"),
                  save_root=os.path.join(root, "save"), **kw)
        sim.load_network("Braess")
        sim.load_population("Braess")
        sim.set_policy(policy("dijkstra", network=sim.network))
        sim.config_parameters(timestep_size=1, start_time=START)
        if store == "sparse":
            sim.road_optimality_store = "sparse"
        sim.run_fast(TICKS)
        out.append(sim)
    return out


@pytest.fixture(scope="module", params=STORES)
def episode(request, tmp_path_factory):
    root = str(tmp_path_factory.mktemp(f"report_{request.param}"))
    ref, port = _facades(root, request.param)
    assert ref.road_optimality_store == port.road_optimality_store
    return request.param, root, ref, port


def _lines(fig):
    """Every axes' lines and scatter offsets, with their labels."""
    out = []
    for ax in fig.axes:
        for line in ax.get_lines():
            out.append((line.get_label(), line.get_drawstyle(),
                        np.asarray(line.get_xydata(), np.float64)))
        for coll in ax.collections:
            out.append(("collection", None,
                        np.asarray(coll.get_offsets(), np.float64)))
    return out


def _assert_same_figure(ref_fig, port_fig):
    ref, port = _lines(ref_fig), _lines(port_fig)
    assert [(a, b) for a, b, _ in ref] == [(a, b) for a, b, _ in port]
    assert ref, "the figure has no data"
    for (label, _, a), (_, _, b) in zip(ref, port):
        assert a.shape == b.shape, label
        np.testing.assert_allclose(b, a, rtol=RTOL, err_msg=label)
    for ra, pa in zip(ref_fig.axes, port_fig.axes):
        assert ra.get_title() == pa.get_title()
        assert ra.get_xlabel() == pa.get_xlabel()
        assert ra.get_ylabel() == pa.get_ylabel()


def test_csv_files_are_byte_identical(episode):
    store, root, ref, port = episode
    ref_dir, port_dir = (os.path.join(root, d, store) for d in ("r", "p"))
    want = ref.compute_node_metrics(ref_dir)
    got = port.compute_node_metrics(port_dir)
    assert list(want) == list(got)
    for road in want:
        assert want[road]["hourly_counts"] == got[road]["hourly_counts"]
        np.testing.assert_array_equal(
            [got[road]["avg_vc"], got[road]["std_vc"]],
            [want[road]["avg_vc"], want[road]["std_vc"]])
    expected = run_msa(ref.network, ref.state.agents)
    ref.plot_daily_counts(expected, ref_dir)
    port.plot_daily_counts(expected, port_dir)
    for name in ("node_metrics.csv", "daily_counts.csv"):
        with open(os.path.join(ref_dir, name), "rb") as f:
            a = f.read()
        with open(os.path.join(port_dir, name), "rb") as f:
            b = f.read()
        assert a == b, name


def test_figures_hold_the_references_data(episode):
    _, _, ref, port = episode
    import matplotlib.pyplot as plt

    _assert_same_figure(ref.plot_leg_histogram(None),
                        port.plot_leg_histogram(None))
    _assert_same_figure(ref.plot_road_optimality(None),
                        port.plot_road_optimality(None))
    _assert_same_figure(ref.plot_road_optimality(None, road_ids=[3, 0, 3]),
                        port.plot_road_optimality(None, road_ids=[3, 0, 3]))
    expected = run_msa(ref.network, ref.state.agents)
    _assert_same_figure(ref.plot_daily_counts(expected, None),
                        port.plot_daily_counts(expected, None))
    plt.close("all")


def test_computation_time_pie(episode):
    _, _, ref, port = episode
    import matplotlib.pyplot as plt

    ref.timers = PhaseTimers(1.25, 0.5, 0.75, 2.0)
    port.timers = PortPhaseTimers(1.25, 0.5, 0.75, 2.0)
    a, b = ref.plot_computation_time(None), port.plot_computation_time(None)
    (ra,), (pa,) = a.axes, b.axes
    assert [t.get_text() for t in ra.texts] == [t.get_text()
                                               for t in pa.texts]
    assert [w.get_label() for w in ra.patches] == [w.get_label()
                                                  for w in pa.patches]
    np.testing.assert_allclose(
        [(w.theta1, w.theta2) for w in pa.patches],
        [(w.theta1, w.theta2) for w in ra.patches], rtol=RTOL)
    assert ra.get_title() == pa.get_title()
    plt.close("all")


def test_get_info(episode):
    _, _, ref, port = episode
    for road in range(ref.network.num_roads):
        assert port.get_info(road) == ref.get_info(road)


def test_without_matplotlib(tmp_path, monkeypatch, capsys):
    """The CLI's summary without matplotlib: the CSV files and the report
    are written, no figure, and one line names the four undrawn ones."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    with pytest.raises(reporting.PlottingUnavailable, match="matplotlib"):
        reporting.plot_daily_counts(np.ones((2, 3), np.int32), {0: 1.0},
                                    str(tmp_path / "direct"))
    assert (tmp_path / "direct" / "daily_counts.csv").exists()
    runner = port_main(["--algo", "dijkstra", "--scenario", "Braess",
                        "--start-end-time", str(START), str(START + 900),
                        "--device", "cpu", "--output-dir", "out"])
    files = sorted(os.listdir("out"))
    assert files == ["daily_counts.csv", "equilibrium_report.json",
                     "node_metrics.csv"]
    undrawn = runner.undrawn
    assert undrawn == ["computation_time.png", "leg_histogram.png",
                       "road_optimality.png", "daily_counts.png"]
    lines = [line for line in capsys.readouterr().out.splitlines()
             if line.startswith("did not draw")]
    assert len(lines) == 1 and "matplotlib" in lines[0]
    assert all(f in lines[0] for f in undrawn)
