"""The metropolitan grid's cell, ``grid256_4m.sp``: on the tiny copy its
sound run is correct with no mismatch and its control is not, on the CPU;
on a card its control at the cell's own size is not correct; and the
cell's two relax metrics read nothing where no cluster launch ran.  Run
from the root of the checkout: ``python -m pytest portbench/tests``, and
on a card ``python -m pytest -m cuda
portbench/tests/test_portbench_grid256.py``."""
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from portbench import harness

REPO = Path(__file__).resolve().parents[2]
CELL = "grid256_4m.sp"


def reader(name):
    return harness.metric_reader(harness.BENCH_DIR, name)


def test_the_cell_is_the_metropolitan_grid():
    cell = harness.find_cell(REPO, CELL, True)
    cfg = cell.config
    assert (cfg["rows"], cfg["cols"], cfg["num_agents"], cfg["zones"]) == (
        256, 256, 4_000_000, 256)
    assert {"refresh.relax_c16_roofline", "refresh.relax_waves",
            "device.idle_pct", "tick.kernels"} <= {n for n, _ in cell.metrics}
    assert "refresh.relax_cluster_roofline" not in dict(cell.metrics)
    million = harness.find_cell(REPO, "grid128_1m.sp", True)
    assert cell.traffic == million.traffic
    same = ("scenario", "block_length", "capacity", "freespeed",
            "peak_start", "peak_spread", "physics", "start_time",
            "simulated_s")
    assert [cfg[k] for k in same] == [million.config[k] for k in same]


def test_sound_run_is_correct(tiny_root, run_tiny):
    res = run_tiny(tiny_root, CELL, seed=2 ** 31 + 23)
    assert res["correct"], res["checks"]
    assert all(c["value"] == 0 for c in res["checks"].values())


def test_control_comes_out_not_correct(tiny_root):
    from portbench.control import control_readings

    out = control_readings(tiny_root, CELL, 24, torch.device("cpu"))
    assert not out["correct"]
    assert out["start_mismatch"]["value"] > 0


def test_relax_metrics_read_nothing_without_a_cluster_launch(tiny_root,
                                                             run_tiny):
    from tarl_tpu_torch.routing import bellman_ford as pbf

    pbf.reset_launches()
    assert reader("refresh.relax_waves")(SimpleNamespace()) is None
    no_trace = SimpleNamespace(trace=None, refresh_inputs=[])
    assert reader("refresh.relax_c16_roofline")(no_trace) is None
    other = SimpleNamespace(
        trace={"device": [(0, 10, "pr_global_kernel", "kernel")]},
        refresh_inputs=[object()])
    assert reader("refresh.relax_c16_roofline")(other) is None
    # A traced run on the CPU: the plain relax, no cluster launch.
    res = run_tiny(tiny_root, CELL, seed=5, trace=True)
    assert pbf.CLUSTER_LAUNCHES == 0
    assert "refresh.relax_waves" not in res["metrics"]
    assert "refresh.relax_c16_roofline" not in res["metrics"]
    assert "tick.host_reads" in res["metrics"]


def test_relax_waves_is_the_mean_of_the_counters(monkeypatch):
    from tarl_tpu_torch.routing import bellman_ford as pbf

    monkeypatch.setattr(pbf, "CLUSTER_LAUNCHES", 4)
    monkeypatch.setattr(pbf, "CLUSTER_WAVES", 22)
    assert reader("refresh.relax_waves")(SimpleNamespace()) == 5.5


@pytest.mark.cuda
def test_control_at_the_cells_size():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from portbench.control import control_readings

    out = control_readings(REPO, CELL, 2 ** 31 + 29, torch.device("cuda"))
    assert not out["correct"]
    assert out["start_mismatch"]["value"] > 0
