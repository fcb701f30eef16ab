"""One run of one benchmark cell: set-up, the measured window of replays,
the traced spans, the comparison with the plain reference, and the
result's line.

A cell names a configuration (``configs/<name>.json``: the network's
generator and sizes, the demand, the deployment it stands for) and a
traffic mix (``traffic/<name>.json``: its driver and the driver's
settings).  A driver (``drivers/<name>.py``) builds the program and its
reference; each metric is read by ``metrics/<name>.py``; a network kind
is generated by ``scenarios/<kind>.py``.  The harness finds all of them
by name, so a cell, a configuration, a metric or an entry kind is added
by adding files.

The window runs whole *replays*: episodes of the configuration's
simulated span from its start time, each from the initial state saved at
set-up, under a simulation key derived from the seed and the replay's
index.  Replays are begun until ``--seconds`` have passed.  Each replay is
one call of the program's episode, but for the first, which is cut where
the comparison keeps states (and, in a traced run, where the traced spans
begin and end).  A CUDA event is recorded at each call of the program's
once-a-tick callable; a tick's time is the distance between two such
events.  The program measured is ``tarl_tpu_torch``; the harness imports
it and nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from . import trace as tracing

BENCH_DIR = Path(__file__).resolve().parent
# Top-level module names the measured process may not hold: the JAX
# package and JAX itself (compared whole: ``tarl_tpu_torch`` is allowed).
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "tarl_tpu")
# Ticks run before the window, under a key of their own, to the nearest
# multiple of the driver's grid (two refreshes at a refresh rate of 10).
WARMUP_TICKS = 20
# Ticks of the traced device span whose inputs the roofline readers keep.
K1_SAMPLES = 4


# --- specification ----------------------------------------------------------

def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """A cell as ``BENCHMARK.json`` and its files give it."""

    name: str
    config: dict
    traffic: dict
    metrics: list          # (name, unit) of this run's metrics
    files: Path            # the benchmark's folder in the checkout


def find_cell(root: Path, name: str, trace: bool) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its configuration
    and traffic files, and the metrics a run with (or without) ``trace``
    reports: the cell's end-to-end metrics, or its per-layer ones."""
    spec = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    files = root / BENCH_DIR.name
    configs = {c["name"]: c for c in spec["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(files / "traffic" / f"{w['traffic']}.json")
    group = spec["per_layer"] if trace else spec["end_to_end"]
    metrics = [(m["name"], m["unit"]) for m in group
               if name in m.get("workloads", [name])]
    return Cell(name, config, traffic, metrics, files)


def metric_reader(files: Path, name: str):
    """``metrics/<name>.py``'s ``read(run)``."""
    path = files / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def scenario(kind: str):
    """``scenarios/<kind>.py``: ``network(cfg)`` and ``population(cfg,
    net, seed)``."""
    return importlib.import_module(f"portbench.scenarios.{kind}")


def driver(cell: Cell):
    """``drivers/<name>.py`` of the cell's traffic (see
    :mod:`portbench.drivers`)."""
    return importlib.import_module(
        f"portbench.drivers.{cell.traffic['driver']}")


def seed_words(seed: int, *more: int) -> tuple[int, int]:
    """Two 32-bit words derived from the seed (any whole number) and
    ``more``: a replay's simulation key."""
    ss = np.random.SeedSequence([seed % 2 ** 64, *more])
    return tuple(int(w) for w in ss.generate_state(2, np.uint32))


def spans(cell: Cell, seed: int) -> SimpleNamespace:
    """The replay's ticks and the first replay's spans, each on the
    driver's grid: the comparison's (``[0, L)`` from the start and ``[k0,
    k0 + L)``, ``L`` a twelfth of the replay, ``k0`` drawn from the seed
    strictly between the two ends, so that the first replay is always cut
    into four calls), the traced device span (a sixth of the replay from
    its middle) and the traced host span (a sixtieth from three
    quarters)."""
    ticks, grid = driver(cell).replay_ticks(cell)

    def on_grid(x: float) -> int:
        return max(grid, grid * round(x / grid))

    span = on_grid(ticks / 12)
    rng = np.random.default_rng(seed % 2 ** 64)
    k0 = grid * int(rng.integers(span // grid + 1, (ticks - span) // grid))
    dev0, host0 = on_grid(ticks / 2), on_grid(3 * ticks / 4)
    dev = (dev0, dev0 + on_grid(ticks / 6))
    host = (host0, host0 + on_grid(ticks / 60))
    if not span < k0 < k0 + span < ticks or not dev[1] <= host0 \
            or host[1] > ticks:
        raise ValueError(f"a replay of {ticks} ticks is too short")
    return SimpleNamespace(ticks=ticks, grid=grid, span=span, k0=k0,
                           dev=dev, host=host, warmup=on_grid(WARMUP_TICKS))


# --- the marks --------------------------------------------------------------

class Clock:
    """Marks on the device's stream (CUDA events, read after the window) or,
    on the CPU, the host clock."""

    def __init__(self, device):
        import torch

        self.torch = torch
        self.cuda = device.type == "cuda"

    def mark(self):
        if not self.cuda:
            return time.perf_counter() * 1e3
        ev = self.torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else b - a

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()


@dataclasses.dataclass
class Marks:
    """What a driver's wrapped callables record: a pair of marks around each
    call of the once-a-tick callable and of the refresh, and the inputs of
    the ticks in ``keep_ticks`` (and of the refreshes while
    ``keep_refresh``) for the roofline readers."""

    clock: Clock
    ticks: list = dataclasses.field(default_factory=list)
    refreshes: list = dataclasses.field(default_factory=list)
    tick: int = 0                  # the replay's tick at the next call
    keep_ticks: set = dataclasses.field(default_factory=set)
    keep_refresh: bool = False
    tick_inputs: list = dataclasses.field(default_factory=list)
    refresh_inputs: list = dataclasses.field(default_factory=list)


# --- the run ----------------------------------------------------------------

def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             started: float) -> dict:
    """One run of ``cell``: returns the result's dict (the line the
    benchmark prints).  ``started`` is the host clock at the process's
    start; ``device`` the torch device the program runs on."""
    import torch

    from . import check
    from tarl_tpu_torch.core import sync

    drv = driver(cell)
    clock = Clock(device)
    marks = Marks(clock)
    kind = scenario(cell.config["scenario"])
    net_arrays = kind.network(cell.config)
    pop = kind.population(cell.config, net_arrays, seed)
    prog = drv.Program(cell, net_arrays, pop, device, marks)
    sp = spans(cell, seed)

    # Warm-up: the first ticks of a replay (a refresh among them), under a
    # key of their own; then the marks are dropped.
    prog.run(prog.replay_state(seed_words(seed, 2 ** 31)), sp.warmup)
    clock.sync()
    marks.ticks.clear()
    marks.refreshes.clear()

    replays = []
    reads0 = sync.HOST_READS
    # What set-up left on the heap is not the window's: keep the
    # collector's passes in the window to what the window allocates.
    gc.collect()
    gc.freeze()
    clock.sync()
    cpu0 = time.process_time()
    t_start = time.perf_counter()
    setup_s = t_start - started
    while True:
        r = len(replays)
        marks.tick = 0
        m0, rm0 = len(marks.ticks), len(marks.refreshes)
        state = prog.replay_state(seed_words(seed, r))
        if r == 0:
            first = first_replay(prog, marks, state, sp, trace, device)
        else:
            prog.run(state, sp.ticks)
        end = clock.mark()
        replays.append(SimpleNamespace(marks=(m0, len(marks.ticks)),
                                       refresh=(rm0, len(marks.refreshes)),
                                       end=end))
        del state
        if time.perf_counter() - t_start >= seconds:
            break
    clock.sync()
    window_s = time.perf_counter() - t_start
    cpu_s = time.process_time() - cpu0
    gc.unfreeze()
    host_reads = sync.HOST_READS - reads0
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)

    run = summarize(marks, replays, sp, trace, clock)
    run.__dict__.update(
        setup_s=setup_s, window_s=window_s, agent_rows=prog.rows,
        host_reads_per_tick=host_reads / run.ticks, marked=prog.marked,
        network_s=prog.network_s, cell=cell, trace=first.traces.get("dev"),
        host_trace=first.traces.get("host"), tick_inputs=marks.tick_inputs,
        refresh_inputs=marks.refresh_inputs)

    # The comparison with the plain reference, once the window has closed,
    # the peak memory has been read and the replays' states are gone.
    ref = drv.Reference(cell, net_arrays, pop, device)
    run.ref = ref
    compare = getattr(drv, "compare", check.compare)
    checks = compare(ref, prog, first.kept, sp, seed_words(seed, 0))

    metrics = {}
    for name, unit in cell.metrics:
        value = metric_reader(cell.files, name)(run)
        if value is not None:
            metrics[name] = {"value": value, "unit": unit}
    result = {
        "correct": all(v <= lim for v, lim in checks.values()),
        "attempted": run.ticks,
        "failed": 0,
        "metrics": metrics,
        "device": device_record(device, memory_peak),
    }
    # Each replay's seconds from its first mark to its end (device clock),
    # beside the metrics: not a metric, a record of the window's drift.
    result["replay_s"] = [
        clock.ms(marks.ticks[rep.marks[0]][0], rep.end) / 1e3
        for rep in replays]
    # The process's CPU seconds over the window: near ``window_s`` where the
    # host paces the run, whatever its speed.
    result["host_cpu_s"] = cpu_s
    if trace and run.trace is not None:
        result["device"].update(busy_s=run.trace["busy_s"],
                                window_s=run.trace["window_s"])
        result["breakdown"] = tracing.breakdown(run.trace, run.host_trace)
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, (v, lim) in checks.items()}
    return result


def first_replay(prog, marks: Marks, state, sp, trace: bool,
                 device) -> SimpleNamespace:
    """The window's first replay, cut at the comparison's bounds and, where
    ``trace``, at the traced spans' (the profiler runs over those): the
    states and tick logs the comparison keeps, and the spans' records."""
    import torch

    cuts = {sp.span, sp.k0, sp.k0 + sp.span, sp.ticks}
    if trace:
        cuts |= {*sp.dev, *sp.host}
        marks.keep_ticks = set(np.linspace(
            sp.dev[0], sp.dev[1] - 1, K1_SAMPLES).astype(int).tolist())
    kept, logs_at, traces = {}, {}, {}
    done = 0
    for b in sorted(cuts):
        if trace and done == sp.dev[0]:
            prof = tracing.start(device, host=False)
            marks.keep_refresh = True
        if trace and done == sp.host[0]:
            prof = tracing.start(device, host=True)
        state, logs = prog.run(state, b - done)
        for s0 in (0, sp.k0):
            if s0 <= done < s0 + sp.span:
                logs_at.setdefault(s0, []).append(logs)
        done = b
        if b in (sp.span, sp.k0, sp.k0 + sp.span):
            kept[b] = state
        if trace and b == sp.dev[1]:
            traces["dev"] = tracing.stop(prof, sp.dev[1] - sp.dev[0])
            marks.keep_refresh = False
        if trace and b == sp.host[1]:
            traces["host"] = tracing.stop(prof, sp.host[1] - sp.host[0])
    marks.keep_ticks = set()
    for s0, logs in logs_at.items():
        kept["logs", s0] = type(logs[0])(*(
            torch.cat([getattr(lg, f) for lg in logs])
            for f in logs[0]._fields))
    return SimpleNamespace(kept=kept, traces=traces)


def summarize(marks: Marks, replays: list, sp, trace: bool,
              clock: Clock) -> SimpleNamespace:
    """Tick, callable and refresh times from the marks, once the window has
    closed.  A tick's time runs from its mark to the next one (the last
    tick of a replay to the replay's end).  In a traced run the ticks of
    the traced replay's spans, and the ticks beside them, are left out of
    the times (the profiler's start and stop sit between them)."""
    ticks, tick_ms, callable_ms, refresh_ms = 0, [], [], []
    lo, hi = sp.dev[0] - 1, sp.host[1] + 1
    for r, rep in enumerate(replays):
        a, b = rep.marks
        tm = marks.ticks[a:b]
        ticks += len(tm)
        nexts = [m[0] for m in tm[1:]] + [rep.end]
        for i, ((mark, end), nxt) in enumerate(zip(tm, nexts)):
            if trace and r == 0 and lo <= i < hi:
                continue
            tick_ms.append(clock.ms(mark, nxt))
            callable_ms.append(clock.ms(mark, end))
        ra, rb = rep.refresh
        for i, (s, e) in enumerate(marks.refreshes[ra:rb]):
            if trace and r == 0 and lo <= i * sp.grid < hi:
                continue
            refresh_ms.append(clock.ms(s, e))
    return SimpleNamespace(ticks=ticks, tick_ms=tick_ms,
                           callable_ms=callable_ms, refresh_ms=refresh_ms)


def device_record(device, memory_peak: int) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": int(memory_peak)}


def forbidden_modules(modules) -> list[str]:
    """The loaded modules whose top-level name (before the first dot) is
    one of :data:`FORBIDDEN_MODULES`, compared whole."""
    return sorted({m for m in modules
                   if m.split(".", 1)[0] in FORBIDDEN_MODULES})
