"""The readers of the program's spans (``portbench.spans``): the device
operations put down to phases by their launch records, paired by order
within each kind, surplus records dropped from the start, the device's
clock never compared with the host's; the phases' self times, host reads
and tick spans over the traced device span alone; the idle gaps labelled
by span on the host clock; nothing from a program without spans; and a run
of the harness, which leaves no span behind and spans off."""
from collections import namedtuple
from types import SimpleNamespace

import pytest

from portbench import harness, spans

Span = namedtuple("Span", "name tick parent start_ns end_ns")


def reader(name):
    return harness.metric_reader(harness.BENCH_DIR, name)


def tree():
    """Two ticks of the device span and one of the host span after it."""
    out = []

    def add(name, tick, parent, s, e):
        out.append(Span(name, tick, parent, s, e))
        return len(out) - 1

    t = add("tick", 0, -1, 0, 100)
    i = add("insert", 0, t, 0, 30)
    add("insert.window", 0, i, 20, 25)
    add("withdraw", 0, t, 30, 50)
    c = add("choice", 0, t, 50, 80)
    add("refresh", 0, c, 55, 70)
    add("core", 0, t, 80, 100)
    t = add("tick", 1, -1, 100, 200)
    for name, s, e in (("insert", 100, 130), ("withdraw", 130, 150),
                       ("choice", 150, 170), ("core", 170, 200)):
        add(name, 1, t, s, e)
    t = add("tick", 2, -1, 1000, 1100)
    w = add("withdraw", 2, t, 1000, 1100)
    add("withdraw.escalate", 2, w, 1010, 1020)
    return out


# (launch, device start, duration): the second launches inside the
# insert's read and runs in the withdraw; the last runs after every tick.
OPS = [(10, 12, 4), (25, 32, 6), (60, 61, 8), (75, 77, 2), (90, 91, 3),
       (140, 141, 5), (205, 206, 1)]
BY_LAUNCH = {"insert": 10, "withdraw": 5, "refresh": 8, "choice": 2,
             "core": 3, None: 1}


def run_of(skew: int = 0):
    """The ops as kernels, the device's stamps ``skew`` off the host's."""
    dev = [(s + skew, d, f"k{n}", "kernel")
           for n, (_, s, d) in enumerate(OPS)]
    host = [(700, 5, "cudaStreamSynchronize")]
    host += [(c, 3, "cudaLaunchKernel") for c, _, _ in OPS]
    return SimpleNamespace(trace={"ticks": 2, "device": dev, "host": host},
                           spans=tree())


@pytest.mark.parametrize("skew", [0, -40, 25])
def test_device_time_goes_to_the_phase_that_launched_it(skew):
    run = run_of(skew)
    ph = spans.phases(run)
    assert ph.route == "launch"
    assert ph.device_ns == BY_LAUNCH
    ms = {p: reader(f"{p}.device_ms")(run) for p in spans.PHASES}
    assert ms["insert"] == pytest.approx(10 / 2e6)
    assert ms["withdraw"] == pytest.approx(5 / 2e6)
    assert ms["refresh"] == pytest.approx(8e-6)      # one refresh
    assert ms["choice"] == pytest.approx(1e-6)       # the refresh's left out


def test_surplus_records_are_dropped_from_the_start():
    run = run_of()
    host, dev = run.trace["host"], run.trace["device"]
    # A kernel launch with no device record before the span's first, and
    # a copy whose first launch left none: the kernels pair as before.
    host += [(1, 3, "cudaLaunchKernel"), (45, 3, "cudaMemcpyAsync"),
             (95, 3, "cudaMemcpyAsync")]
    dev.append((96, 2, "Memcpy DtoH (Device -> Pageable)", "memcpy"))
    dev.sort()
    ph = spans.phases(run)
    assert ph.route == "launch, 2 unpaired"
    assert ph.device_ns == dict(BY_LAUNCH, core=5)
    # A device record with no launch goes to no span.
    run = run_of()
    run.trace["device"].insert(0, (2, 7, "k", "kernel"))
    ph = spans.phases(run)
    assert ph.route == "launch, 1 unpaired"
    assert ph.device_ns == {**BY_LAUNCH, None: 8}


def test_wall_reads_and_ticks_are_the_device_spans():
    run = run_of(True)
    assert reader("insert.wall_ms")(run) == pytest.approx(30e-6)
    # choice's self time: (30 - 15) and 20 over two ticks.
    assert reader("choice.wall_ms")(run) == pytest.approx(17.5e-6)
    assert reader("refresh.wall_ms")(run) == pytest.approx(15e-6)
    assert reader("core.wall_ms")(run) == pytest.approx(25e-6)
    assert reader("insert.host_reads")(run) == 0.5
    # The host span's escalation is not the device span's.
    assert reader("withdraw.host_reads")(run) == 0.0
    assert reader("tick.wall_ms_p95")(run) == pytest.approx(1e-4)


@pytest.mark.parametrize("skew", [0, -40])
def test_idle_gaps_are_labelled_by_the_innermost_span(skew):
    # Each gap's midpoint on the host clock: half the gap before the launch
    # of the operation that ends it.
    got = dict(spans.idle_by_span(run_of(skew)))
    assert got == pytest.approx({"core": 72e-9, "insert": 63e-9,
                                 "withdraw": 23e-9, "choice": 8e-9})
    # A gap whose midpoint no span covers.
    run = run_of(skew)
    run.trace["device"].append((900 + skew, 10, "late", "kernel"))
    run.trace["host"].append((890, 3, "cudaLaunchKernel"))
    assert dict(spans.idle_by_span(run))["between spans"] == pytest.approx(
        693e-9)


def test_a_program_without_spans_reads_nothing(monkeypatch):
    from tarl_tpu_torch.utils import timers

    monkeypatch.delattr(timers, "take_spans")
    run = SimpleNamespace(trace={"ticks": 2, "device": [], "host": []})
    for name in ("insert.device_ms", "core.wall_ms", "tick.wall_ms_p95",
                 "withdraw.host_reads", "refresh.wall_ms"):
        assert reader(name)(run) is None
    assert spans.idle_by_span(run) is None
    # Too few tick spans for the traced span: nothing either.
    run = SimpleNamespace(trace={"ticks": 5, "device": [], "host": []},
                          spans=tree())
    assert reader("insert.wall_ms")(run) is None


def _spans_left():
    from tarl_tpu_torch.utils import timers

    off = timers.span("a") is timers.span("b")
    return timers.take_spans(), off


def test_untraced_run_records_no_span(tiny_root, run_tiny):
    res = run_tiny(tiny_root, "grid128_1m.random")
    assert res["correct"]
    assert _spans_left() == ([], True)


def test_traced_run_reads_the_phases(tiny_root, run_tiny):
    res = run_tiny(tiny_root, "grid128_1m.sp", trace=True)
    assert res["correct"]
    m = res["metrics"]
    for name in ("insert.wall_ms", "withdraw.wall_ms", "choice.wall_ms",
                 "core.wall_ms", "refresh.wall_ms", "tick.wall_ms_p95",
                 "insert.host_reads", "withdraw.host_reads"):
        assert m[name]["value"] >= 0, name
    # The sp cell's windowed insert reads once a pass, the withdraw once a
    # tick at least (depth 2, escalating); the CPU run has no device.
    assert m["insert.host_reads"]["value"] >= 1
    assert m["withdraw.host_reads"]["value"] >= 1
    assert "insert.device_ms" not in m
    assert _spans_left() == ([], True)
