"""The metric arithmetic on synthetic inputs: the rate, the tail over every
tick, the device's busy union and idle share, launches a tick, the
breakdown's labels, tick times from marks, and the roofline counts."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import harness, trace
from portbench.roofline import k1, peaks, relax


def reader(name):
    return harness.metric_reader(harness.BENCH_DIR, name)


def test_agent_steps_per_s_counts_every_row_and_tick():
    run = SimpleNamespace(agent_rows=1_000_001, ticks=2400, window_s=16.0)
    assert reader("agent_steps_per_s")(run) == 1_000_001 * 2400 / 16.0


def test_tail_is_over_every_tick():
    run = SimpleNamespace(tick_ms=[float(v) for v in range(1, 1001)])
    assert reader("tick.ms_p95")(run) == pytest.approx(950.05)
    assert reader("tick.ms_p95")(SimpleNamespace(tick_ms=[])) is None


def test_busy_is_the_union_of_device_intervals():
    names = ["void k<1>(float*)", "fw_winner_kernel",
             "Memcpy DtoD (Device -> Device)", "Memset (Device)"]
    assert [trace.activity(n) for n in names] == [
        "kernel", "kernel", "memcpy", "memset"]
    dev = [(0, 10, "a", "kernel"), (5, 10, "b", "kernel"),
           (30, 10, "c", "memcpy"), (40, 5, "d", "memset")]
    assert trace.merged(dev) == [[0, 15], [30, 45]]
    assert trace.union_ns(dev) == 30
    t = {"device": dev, "busy_s": 30e-9, "window_s": 120e-9, "ticks": 2}
    run = SimpleNamespace(trace=t)
    assert reader("device.idle_pct")(run) == pytest.approx(75.0)
    assert reader("device.busy_ms")(run) == pytest.approx(15e-6)
    # Kernels and memsets count as launches, copies do not.
    assert reader("tick.kernels")(run) == 1.5
    assert reader("device.idle_pct")(SimpleNamespace(trace=None)) is None


def test_breakdown_labels_gaps_by_the_innermost_host_op():
    dev = [(0, 10, "k1", "kernel"), (20, 10, "k2", "kernel"),
           (100, 10, "k1", "kernel")]
    host = [(0, 200, "aten::outer"), (12, 6, "aten::item"),
            (40, 50, "cudaStreamSynchronize")]
    bd = trace.breakdown({"device": dev}, {"device": dev, "host": host})
    assert bd["device_ops"][0] == ["k1", 20e-9]
    assert dict(bd["idle_gaps"]) == {"aten::item": 10e-9,
                                     "cudaStreamSynchronize": 70e-9}


def test_tick_times_run_from_mark_to_mark():
    clock = SimpleNamespace(ms=lambda a, b: b - a)
    marks = harness.Marks(clock, ticks=[(0.0, 1.0), (10.0, 12.0),
                                        (25.0, 26.0)])
    reps = [SimpleNamespace(marks=(0, 3), refresh=(0, 0), end=31.0)]
    sp = SimpleNamespace(dev=(100, 140), host=(150, 170), grid=1)
    s = harness.summarize(marks, reps, sp, False, clock)
    assert s.ticks == 3
    assert s.tick_ms == [10.0, 15.0, 6.0]
    assert s.callable_ms == [1.0, 2.0, 1.0]


def test_least_time_takes_the_larger_bound():
    t, by = peaks.least_seconds(3.35e12, 1.0)
    assert (t, by) == (1.0, "bytes")
    t, by = peaks.least_seconds(1.0, 67e12)
    assert (t, by) == (1.0, "ops")


def _line(n):
    """A one-way chain of n intersections, 100 m roads, as the reference
    builds it."""
    from portbench.reference.network import build_network

    return build_network(
        length=np.full(n - 1, 100.0), max_flow=np.full(n - 1, 600.0),
        free_speed=np.full(n - 1, 10.0), perm_lanes=np.ones(n - 1),
        from_inter=np.arange(n - 1), to_inter=np.arange(1, n),
        num_intersections=n, device="cpu")


def test_relax_counts_the_sweeps_the_inputs_need():
    net = _line(6)
    dist0 = torch.full((6, 1), 1e18)
    dist0[5, 0] = 0.0
    assert relax.sweeps_needed(net, net.free_flow, dist0, None) == 5
    assert relax.sweeps_needed(net, net.free_flow, dist0, 3) == 3
    r, (i_n, k_n) = net.num_roads, net.inter_out_road.shape
    valid = int(net.inter_out_ok.sum())
    t, by = relax.least(net, 5, 1)
    moved = 8 * r + 5 * i_n * k_n + 12 * i_n
    assert t == pytest.approx(max(moved / peaks.HBM_BYTES_PER_S,
                                  2 * 6 * valid / peaks.F32_OPS_PER_S))


def test_k1_counts_on_an_empty_network():
    from portbench.reference.config import PhysicsConfig
    from portbench.reference.state import init_road_state

    net = _line(5)
    road = init_road_state(net.num_roads, net.nmax, "cpu")
    sel = torch.zeros(net.num_nodes, dtype=torch.int32)
    t, by = k1.least(net, road, sel, 21600.0, (1, 2), PhysicsConfig())
    r = net.num_roads
    valid = int(net.in_edge_ok.sum())
    sources = int(net.in_src_tab[net.in_edge_ok].unique().numel())
    moved = (8 * r + net.in_edge_ok.numel() + 4 * valid + 12 * sources + 4
             + 14 * r)
    assert t == pytest.approx(max(moved / peaks.HBM_BYTES_PER_S,
                                  20 * valid / peaks.F32_OPS_PER_S))
