"""The port's spans (``utils.timers``) and host reads by site
(``core.sync``), on the CPU (one case on the card).

* Spans off record nothing: ``span`` hands out one shared object and a
  ``spanned`` function calls straight through.
* A Grid4x4 episode gives the same state and logs, bitwise, with spans on
  and off: windowed insert with both escalations, the backlog insert
  (``run_episode``), and a periodic shortest-path episode
  (``run_episode_periodic``).
* With spans on, each tick is one ``tick`` span whose phase children are
  ``insert``, ``withdraw``, ``choice`` and ``core`` in that order;
  ``refresh`` sits under ``choice`` on every ``periodic_rate``-th tick and
  only there; each host read is a span named by its site under its phase;
  every span's ``tick`` and ``parent`` agree with the spans around it.
* Spans share the profiler's clock: under ``torch.profiler`` the records
  of the ops run inside a span lie within it, and those run outside it
  outside it (on the card: the ``cudaLaunchKernel`` records); a running
  profiler turns spans on, a device-only one too, up to ``PROFILED_CAP``
  untaken records; ``device_trace`` turns them on and writes them out.
* A traced episode has one read span per counted read (``HOST_READS``),
  under the tick's site names.
"""
import json
import time

import pytest
import torch

from tarl_tpu_torch.config import RoutingConfig, SimConfig
from tarl_tpu_torch.core import step, sync
from tarl_tpu_torch.io import matsim
from tarl_tpu_torch.io.scenarios import ensure_scenario
from tarl_tpu_torch.routing.policies import random_choice
from tarl_tpu_torch.simulator import make_policy
from tarl_tpu_torch.state import sort_agents_by_departure
from tarl_tpu_torch.utils import timers

torch.set_num_threads(1)

# Half an hour into the departures, so that hundreds of agents are due at
# the first tick and the loops run extra passes.
START = 6 * 3600 + 1800
PHASES = ["insert", "withdraw", "choice", "core"]
SITES = {"insert.window", "insert.frontier", "insert.drain",
         "withdraw.escalate"}
SORTED = dict(start_time=START, record_road_optimality=False,
              sorted_population=True)
CASES = {
    # runner, policy, ticks, SimConfig fields
    "windowed": ("run_episode", "random", 40, dict(
        SORTED, insert_window=4, insert_escalate=True, withdraw_depth=1,
        withdraw_escalate=True)),
    "backlog": ("run_episode", "random", 40, dict(
        SORTED, insert_window=8, insert_backlog=16, insert_escalate=True,
        withdraw_depth=2, withdraw_escalate=True)),
    "periodic": ("run_episode_periodic", "dijkstra", 30, dict(
        SORTED, insert_window=64, withdraw_depth=2)),
}
RATE = 5


@pytest.fixture(scope="module")
def grid4(tmp_path_factory):
    base = ensure_scenario(str(tmp_path_factory.mktemp("spans")), "Grid4x4")
    net = matsim.load_network(f"{base}/network", device="cpu")
    agents, _ = matsim.load_population(f"{base}/population",
                                       f"{base}/network", device="cpu")
    return net, sort_agents_by_departure(agents)


@pytest.fixture(autouse=True)
def spans_off():
    timers.tracing(False)
    timers.take_spans()
    yield
    timers.tracing(False)
    timers.take_spans()


def run(grid4, case):
    runner, algo, ticks, cfg = CASES[case]
    net, agents = grid4
    sim = SimConfig(**cfg)
    if algo == "random":
        policy = step.Policy(choice=random_choice)
    else:
        policy = make_policy(algo, RoutingConfig(
            refresh_rate=RATE, max_bf_iters=8, backend="primal"),
            network=net)
    state = step.init_sim_state(net, agents, sim=sim, policy=policy)
    return getattr(step, runner)(state, net, policy, ticks, sim=sim)


def leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, tuple):
        return [v for item in x for v in leaves(item)]
    return [x]


def test_spans_off_record_nothing():
    assert timers.span("tick") is timers.span("insert")

    @timers.spanned("tick")
    def one(x, y=1):
        """A phase."""
        with timers.span("insert"):
            return x + y

    assert one(2, y=3) == 5 and one.__name__ == "one"
    assert one.__doc__ == "A phase."
    assert timers.take_spans() == []
    timers.tracing(True)
    assert one(2) == 3
    timers.tracing(False)
    assert [(s.name, s.tick, s.parent) for s in timers.take_spans()] == [
        ("tick", 0, -1), ("insert", 0, 0)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_episode_is_the_same_with_spans_on(grid4, case):
    off = leaves(run(grid4, case))
    timers.tracing(True)
    on = leaves(run(grid4, case))
    timers.tracing(False)
    assert len(timers.take_spans()) > CASES[case][2]
    assert len(on) == len(off)
    for a, b in zip(off, on):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b)
        else:
            assert a == b


def check_tree(spans):
    """Every span's parent opened before it and encloses it, and its tick
    is its parent's (a tick span's own number at the tick)."""
    for i, s in enumerate(spans):
        assert s.start_ns <= s.end_ns
        if s.parent == -1:
            assert s.tick == -1 or s.name == "tick"
            continue
        p = spans[s.parent]
        assert s.parent < i
        assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
        assert s.tick == p.tick
        assert s.name != "tick"


@pytest.mark.parametrize("case", sorted(CASES))
def test_each_tick_is_a_tree_of_its_phases(grid4, case):
    timers.tracing(True)
    run(grid4, case)
    timers.tracing(False)
    spans = timers.take_spans()
    check_tree(spans)
    ticks = [i for i, s in enumerate(spans) if s.name == "tick"]
    assert len(ticks) == CASES[case][2]
    assert len({spans[i].tick for i in ticks}) == len(ticks)
    periodic = CASES[case][0] == "run_episode_periodic"
    for n, t in enumerate(ticks):
        kids = [s.name for s in spans if s.parent == t]
        assert kids == PHASES
        choice = next(i for i, s in enumerate(spans)
                      if s.parent == t and s.name == "choice")
        under = [s.name for s in spans if s.parent == choice]
        assert under == (["refresh"] if periodic and n % RATE == 0 else [])
    for s in spans:
        if s.name in SITES:
            assert spans[s.parent].name == s.name.split(".")[0]
    # Outside the ticks only the routing table's init reads the host.
    outside = {(s.name, s.parent) for s in spans if s.tick == -1}
    assert outside == ({("routing.bellman_ford", -1)} if periodic
                       else set())


@pytest.mark.parametrize("case", ["windowed", "backlog"])
def test_reads_by_site_sum_to_host_reads(grid4, case):
    sync.reset()
    timers.tracing(True)
    run(grid4, case)
    timers.tracing(False)
    spans = timers.take_spans()
    by_site = {}
    for s in spans:
        if s.name not in PHASES + ["tick", "refresh"]:
            by_site[s.name] = by_site.get(s.name, 0) + 1
    assert sum(by_site.values()) == sync.HOST_READS > 0
    assert set(by_site) <= SITES
    ticks = CASES[case][2]
    if case == "windowed":
        assert set(by_site) == {"insert.window", "withdraw.escalate"}
        assert by_site["insert.window"] > ticks      # escalation passes
    else:
        assert set(by_site) == {"insert.frontier", "insert.drain",
                                "withdraw.escalate"}
        assert by_site["insert.drain"] >= ticks
    assert by_site["withdraw.escalate"] > ticks
    sync.reset()
    assert sync.HOST_READS == 0


def _profiled(activities, device):
    """Ops before, inside and after a span, 2 ms apart, under a profiler:
    the span and the profiler's records."""
    from torch.profiler import profile

    x = torch.ones(4096, device=device)
    with profile(activities=activities) as prof:
        torch.cumsum(x, 0)
        time.sleep(0.002)
        with timers.span("probe"):
            torch.cummax(x, 0)
        time.sleep(0.002)
        torch.cumprod(x, 0)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    (probe,) = timers.take_spans()
    return probe, list(prof.profiler.kineto_results.events())


def test_spans_share_the_profilers_clock():
    from torch.profiler import ProfilerActivity

    probe, events = _profiled([ProfilerActivity.CPU], torch.device("cpu"))
    assert probe.name == "probe" and probe.tick == -1
    found = set()
    for e in events:
        s, end = e.start_ns(), e.start_ns() + e.duration_ns()
        if e.name() == "aten::cummax":
            assert probe.start_ns <= s and end <= probe.end_ns
        elif e.name() in ("aten::cumsum", "aten::cumprod"):
            assert end < probe.start_ns or s > probe.end_ns
        found.add(e.name())
    assert {"aten::cummax", "aten::cumsum", "aten::cumprod"} <= found


def test_episode_ops_lie_in_their_phase_spans(grid4):
    """Under a CPU profiler (which turns spans on) every ``cummin`` (the
    withdraw's scan, run nowhere else) lies inside a withdraw span."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run(grid4, "windowed")
    spans = [s for s in timers.take_spans() if s.name == "withdraw"]
    assert len(spans) == CASES["windowed"][2]
    scans = [(e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events()
             if e.name() == "aten::cummin"]
    assert len(scans) >= len(spans)
    for s, e in scans:
        assert any(w.start_ns <= s and e <= w.end_ns for w in spans)


def test_a_profiler_alone_leaves_at_most_the_cap(monkeypatch):
    """Under a profiler, with spans not turned on and nothing taken, spans
    stop at ``PROFILED_CAP`` records; turned on, they do not."""
    from torch.profiler import ProfilerActivity, profile

    monkeypatch.setattr(timers, "PROFILED_CAP", 5)

    @timers.spanned("tick")
    def one():
        with timers.span("insert"):
            pass

    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(10):
            one()
    spans = timers.take_spans()
    assert [s.name for s in spans] == ["tick", "insert"] * 2 + ["tick"]
    check_tree(spans)
    timers.tracing(True)
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(10):
            one()
    timers.tracing(False)
    assert len(timers.take_spans()) == 20


def test_device_trace_writes_its_spans(tmp_path):
    """``device_trace`` turns spans on over its block, and off again after,
    and writes them beside the trace."""
    with timers.device_trace(str(tmp_path)):
        with timers.span("probe"):
            torch.cummax(torch.ones(64), 0)
    with timers.span("after"):
        pass
    assert timers.take_spans() == []
    (probe,) = json.load(open(tmp_path / "spans.json"))
    assert probe["name"] == "probe" and probe["parent"] == -1
    assert probe["start_ns"] <= probe["end_ns"]
    trace = json.load(open(tmp_path / "trace.json"))
    assert any(e.get("name") == "aten::cummax" for e in trace["traceEvents"])


@pytest.mark.cuda
def test_spans_share_the_profilers_clock_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.profiler import ProfilerActivity

    dev = torch.device("cuda")
    probe, events = _profiled([ProfilerActivity.CPU, ProfilerActivity.CUDA],
                              dev)
    launches = [(e.start_ns(), e.start_ns() + e.duration_ns())
                for e in events if e.name() == "cudaLaunchKernel"]
    inside = [1 for s, e in launches
              if probe.start_ns <= s and e <= probe.end_ns]
    outside = [1 for s, e in launches if e < probe.start_ns
               or s > probe.end_ns]
    assert inside and len(inside) + len(outside) == len(launches)
    # A device-only profiler (the benchmark's traced span) turns spans on.
    probe, _ = _profiled([ProfilerActivity.CUDA], dev)
    assert probe.name == "probe"
