"""The simulator facade (ports ``tarl_tpu/simulator.py``: ``make_policy``,
``_periodic_fields``, ``PhaseTimers`` and ``TransportationSimulator``).

``make_policy("random" | "dijkstra" | "so", routing, physics, network=,
dest_inters=)`` builds a :class:`~tarl_tpu_torch.core.step.Policy` on the
dual backend (the next-hop table over the dual nodes, per-agent entry
roads; with ``strict_compat`` the reference simulator's own entry rule and
edge costs) or the primal one (intersection tables), as
``routing.backend`` says.

:class:`TransportationSimulator` keeps the reference facade's surface:
scenario loading through the caches of :mod:`~tarl_tpu_torch.io.cache`,
``config_parameters``, ``set_policy``, the clock, ``reset``, the eager
tick ``run()`` with its four phase timers, ``run_fast(n)`` over the
episode drivers, the per-tick logs and the road-optimality stores, and
the reports of :mod:`~tarl_tpu_torch.metrics.reporting` on them
(``plot_computation_time``, ``plot_leg_histogram``,
``plot_road_optimality``, ``compute_node_metrics``, ``plot_daily_counts``)
and ``get_info``.
"""
from __future__ import annotations

import dataclasses
import functools
import time as _time
from typing import Callable, Optional

import numpy as np
import torch

from .config import (
    DEFAULT_PHYSICS,
    DEFAULT_ROUTING,
    PhysicsConfig,
    RoutingConfig,
    SimConfig,
)
from .core.fused_winner import direction_confirm
from .core.step import (
    Policy,
    average_travel_time,
    core_phase,
    init_sim_state,
    insert_phase,
    reset_sim_state,
    run_episode,
    run_episode_periodic,
    withdraw_phase,
)
from .device import resolve_device
from .io.cache import load_or_build_network, load_or_build_population
from .network import Network
from .routing.bellman_ford import primal_relax_next_roads
from .routing.policies import (
    _NEVER_REFRESH,
    make_primal_dest_parts,
    make_shortest_path_choice,
    make_shortest_path_choice_primal,
    primal_entry_lookup,
    primal_table_init,
    random_choice,
    shortest_path_entry,
)
from .state import SimState, TickLog
from .utils.timers import synchronize


def make_policy(
    algo: str,
    routing: RoutingConfig = DEFAULT_ROUTING,
    physics: PhysicsConfig = DEFAULT_PHYSICS,
    network=None,
    dest_inters=None,
    relax=primal_relax_next_roads,
) -> Policy:
    """Policy for a classical algorithm: ``"random"``, ``"dijkstra"``
    (congested shortest paths) or ``"so"`` (shortest paths on marginal
    social costs).  ``routing.backend`` ``"auto"`` picks the primal backend
    when ``network`` has more than 8,000 dual nodes (the reference's
    ``N^2 > 64M`` rule; without ``network``, or with ``strict_compat``, it
    picks the dual one), else the dual one.  ``dest_inters`` restricts the
    primal tables to those destination intersections.  ``relax`` computes
    each primal refresh (see :func:`~tarl_tpu_torch.routing.policies.
    make_shortest_path_choice_primal`).

    The dual policy reads its next hops from ``state.next_hop`` (int32[N,
    N]); with ``strict_compat`` entrants follow ``selected_road[origin]``,
    which the reference's edge costs and dummy-driven SRC rows set."""
    if algo == "random":
        return Policy(choice=random_choice)
    if algo == "so":
        if routing.strict_compat:
            raise ValueError("--algo so is incompatible with strict_compat")
        return make_policy(
            "dijkstra", dataclasses.replace(routing, cost_mode="marginal"),
            physics, network=network, dest_inters=dest_inters, relax=relax)
    if algo != "dijkstra":
        raise ValueError(f"Unknown classical algorithm {algo!r}")
    backend = routing.backend
    if backend == "auto":
        big = network is not None and network.num_nodes ** 2 > 64_000_000
        backend = "primal" if (big and not routing.strict_compat) else "dual"
    if backend != "primal":
        choice = make_shortest_path_choice(routing, physics)
        if routing.strict_compat:
            return Policy(choice=choice, needs_next_hop=True)
        return Policy(choice=choice, entry=shortest_path_entry,
                      entry_lookup=shortest_path_entry, needs_next_hop=True,
                      **_periodic_fields(choice, routing))
    if routing.strict_compat:
        raise ValueError("strict_compat requires the dual routing backend")
    if dest_inters is not None:
        choice, entry_lookup, table_init = make_primal_dest_parts(
            dest_inters, routing, physics, network=network, relax=relax)
        return Policy(choice=choice,
                      entry=lambda s, n: entry_lookup(s, n),
                      entry_lookup=entry_lookup, table_init=table_init,
                      **_periodic_fields(choice, routing))
    choice = make_shortest_path_choice_primal(routing, physics,
                                              network=network, relax=relax)
    return Policy(choice=choice,
                  entry=lambda s, n: primal_entry_lookup(s, n),
                  entry_lookup=primal_entry_lookup,
                  # The anchor table is exact; only refreshes are capped.
                  table_init=functools.partial(primal_table_init,
                                               max_iters=None),
                  **_periodic_fields(choice, routing))


def _periodic_fields(choice, routing: RoutingConfig) -> dict:
    """The refresh/lookup split for
    :func:`~tarl_tpu_torch.core.step.run_episode_periodic`: the choice's
    ``refresh_fn`` and ``lookup_fn`` and the cadence; empty when the choice
    carries no split or never refreshes."""
    refresh = getattr(choice, "refresh_fn", None)
    lookup = getattr(choice, "lookup_fn", None)
    if refresh is None or lookup is None:
        return {}
    if routing.refresh_rate >= _NEVER_REFRESH:
        return {}
    return {"refresh": refresh, "lookup": lookup,
            "periodic_rate": int(routing.refresh_rate)}


@dataclasses.dataclass
class PhaseTimers:
    """Per-phase wall-clock seconds accumulated by the eager tick."""

    inserting_time: float = 0.0
    withdraw_time: float = 0.0
    choice_time: float = 0.0
    core_time: float = 0.0

    @property
    def total(self) -> float:
        return (self.inserting_time + self.withdraw_time + self.choice_time
                + self.core_time)


class TransportationSimulator:
    """The reference facade's surface over the port's tick.

    ``device`` (None: the card) places the network, the population and the
    state.  ``sparse_nnz_budget`` caps the nonzeros the "sparse"
    road-optimality store keeps before it falls back to the hourly
    accumulator (the reference reads it from ``TARL_SPARSE_NNZ_BUDGET``,
    with the same default)."""

    def __init__(
        self,
        *,
        physics: PhysicsConfig = DEFAULT_PHYSICS,
        sim: SimConfig = SimConfig(),
        data_root: str = "data",
        save_root: str = "save",
        device: torch.device | str | None = None,
        sparse_nnz_budget: int = 5 * 10 ** 7,
    ):
        self.physics = physics
        self.sim = sim
        self.data_root = data_root
        self.save_root = save_root
        self.device = resolve_device(device)
        self.network: Optional[Network] = None
        self.state: Optional[SimState] = None
        self.policy: Policy = Policy(choice=random_choice)
        self.timers = PhaseTimers()
        # Per-tick host logs: [departures, arrivals, on_way, time] rows,
        # and the road-optimality series in one of three stores: "dense"
        # (a (time, float32[R]) row a tick), "sparse" ((time, int32[nnz],
        # float32[nnz]) triplets, exact at O(nnz) host memory) or "hourly"
        # (no per-tick series: the state's hourly accumulator).
        self.leg_histogram_values: list = []
        self.road_optimality_values: list = []
        self.road_optimality_store: str = "dense"
        self.road_optimality_sparse: list = []
        self._sparse_nnz = 0
        self._sparse_nnz_budget = int(sparse_nnz_budget)
        self._sparse_road_total = None  # float64[R] |delta| mass per road

    # --- configuration ---------------------------------------------------
    def load_network(self, scenario: str) -> None:
        self.network = load_or_build_network(scenario, self.data_root,
                                             self.save_root, self.device)
        self.scenario = scenario

    def load_population(self, scenario: str) -> None:
        self.agents0 = load_or_build_population(scenario, self.data_root,
                                                self.save_root, self.device)

    def config_parameters(self, timestep_size: int = 1, start_time: int = 0,
                          end_time: Optional[int] = None,
                          **overrides) -> None:
        self.sim = dataclasses.replace(
            self.sim, timestep=timestep_size, start_time=start_time,
            end_time=end_time if end_time is not None else self.sim.end_time,
            **overrides)
        self._init_state()

    def set_policy(self, policy: Policy) -> None:
        self.policy = policy
        self._init_state()

    def _init_state(self) -> None:
        if self.network is None or not hasattr(self, "agents0"):
            return
        self.state = init_sim_state(self.network, self.agents0,
                                    sim=self.sim, policy=self.policy)

    @property
    def time(self) -> float:
        return float(self.state.time)

    def set_time(self, t) -> None:
        self.state = self.state._replace(time=float(np.float32(t)))

    def reset(self) -> None:
        """Empty queues, agent progress, metrics, timers and logs, with the
        clock at the configured start."""
        self.state = reset_sim_state(self.state, self.sim.start_time)
        self.timers = PhaseTimers()
        self.leg_histogram_values = []
        self.road_optimality_values = []
        self.road_optimality_sparse = []
        self._sparse_nnz = 0
        self._sparse_road_total = None

    # --- stepping -----------------------------------------------------------
    def run(self, core: Callable = direction_confirm) -> TickLog:
        """One tick, eager, each of its four phases (insert, withdraw,
        choice, core) timed with the device synchronised at its end.  The
        core phase is :func:`~tarl_tpu_torch.core.step.tick`'s (kernel K1
        on the card); ``core=direction_confirm_plain`` runs the plain
        version for comparison.  Appends the tick's logs; returns them."""
        net, sim, physics = self.network, self.sim, self.physics
        state = self.state
        b = _time.perf_counter()
        state, saturated = insert_phase(state, net, self.policy, sim,
                                        physics)
        synchronize(state.road.count)
        e = _time.perf_counter()
        self.timers.inserting_time += e - b

        b = e
        state, wcount = withdraw_phase(state, net, sim)
        synchronize(state.road.count)
        e = _time.perf_counter()
        self.timers.withdraw_time += e - b

        b = e
        state, _ = self.policy.choice(state, net)
        synchronize(state.selected_road)
        e = _time.perf_counter()
        self.timers.choice_time += e - b

        b = e
        state, log = core_phase(state, net, wcount, saturated, sim, physics,
                                core=core)
        synchronize(state.road.count)
        e = _time.perf_counter()
        self.timers.core_time += e - b

        self.state = state
        self._append_logs(log, 1)
        return log

    def run_fast(self, num_steps: int) -> TickLog:
        """``num_steps`` ticks through the episode driver (the periodic one,
        :func:`~tarl_tpu_torch.core.step.run_episode_periodic`, where the
        policy carries the split and the chunk is refresh-aligned; bitwise
        the same episode); appends the logs and returns them."""
        rate = self.policy.periodic_rate
        runner = run_episode
        if (rate and num_steps % rate == 0
                and self.state.choice_count % rate == 0):
            runner = run_episode_periodic
        self.state, logs = runner(self.state, self.network, self.policy,
                                  num_steps, sim=self.sim,
                                  physics=self.physics)
        self._append_logs(logs, num_steps)
        return logs

    def _append_logs(self, logs: TickLog, n: int) -> None:
        """The leg-histogram rows and the road-optimality rows of ``n``
        ticks' logs (one tick unstacked when ``n`` is 1 and the logs are
        0-d), in one transfer each."""
        cols = torch.stack([logs.departures, logs.arrivals, logs.on_way,
                            logs.time.to(logs.on_way.device)]).reshape(4, n)
        rows = cols.T.cpu().numpy()
        self.leg_histogram_values += [[float(v) for v in row]
                                      for row in rows]
        delta = logs.road_delta_tt
        if self.sim.record_road_optimality and delta.numel():
            self._record_delta(rows[:, 3],
                               delta.reshape(n, -1).cpu().numpy())

    def _record_delta(self, ts: np.ndarray, delta: np.ndarray) -> None:
        """Append a chunk's per-tick road-delta rows (``ts`` [T], ``delta``
        [T, R]) to the active store: "dense" keeps the rows, "sparse" their
        nonzero (index, value) pairs, and falls back to "hourly" (no
        per-tick series) once the nonzeros pass the budget; the prefix
        kept so far stays readable."""
        if self.road_optimality_store == "dense":
            for i in range(delta.shape[0]):
                self.road_optimality_values.append((float(ts[i]), delta[i]))
            return
        if self.road_optimality_store != "sparse":
            return
        rows, cols = np.nonzero(delta)  # C order: sorted by row
        vals = delta[rows, cols].astype(np.float32)
        self._sparse_nnz += vals.size
        if self._sparse_nnz > self._sparse_nnz_budget:
            print(f"per-tick road-optimality nonzeros exceed "
                  f"{self._sparse_nnz_budget:.0e}: per-tick collection stops "
                  f"at t={float(ts[0]):.0f}; the "
                  f"{len(self.road_optimality_sparse)}-tick prefix is kept "
                  "(road_optimality_series), the hourly accumulator covers "
                  "the episode")
            self.road_optimality_store = "hourly"
            return
        if self._sparse_road_total is None:
            self._sparse_road_total = np.zeros(delta.shape[1], np.float64)
        self._sparse_road_total += np.bincount(
            cols, weights=np.abs(vals), minlength=delta.shape[1])
        counts = np.bincount(rows, minlength=delta.shape[0])
        offs = np.concatenate([[0], np.cumsum(counts)])
        for i in range(delta.shape[0]):
            lo, hi = offs[i], offs[i + 1]
            self.road_optimality_sparse.append(
                (float(ts[i]), cols[lo:hi].astype(np.int32), vals[lo:hi]))

    def road_optimality_series(self, road_ids) -> tuple:
        """``(times [T], mat [T, len(road_ids)])`` from whichever per-tick
        store holds the series (the sparse prefix also after a fall-back
        to "hourly"); exact in both."""
        ids = np.asarray(list(road_ids), dtype=np.int64)
        if self.road_optimality_store == "sparse" or \
                self.road_optimality_sparse:
            entries = self.road_optimality_sparse
            times = np.asarray([t for t, _, _ in entries])
            order = np.argsort(ids)
            sorted_ids = ids[order]
            mat = np.zeros((len(entries), ids.size), np.float32)
            for i, (_, idx, val) in enumerate(entries):
                pos = np.searchsorted(sorted_ids, idx)
                pos_c = np.minimum(pos, ids.size - 1)
                hit = sorted_ids[pos_c] == idx
                mat[i, order[pos_c[hit]]] = val[hit]
            return times, mat
        values = self.road_optimality_values
        times = np.asarray([t for t, _ in values])
        mat = (np.stack([np.asarray(v) for _, v in values])[:, ids]
               if values else np.zeros((0, ids.size), np.float32))
        return times, mat

    # --- observation and metrics ------------------------------------------
    def observe(self):
        """``(node_features [N, 7], edge_features [Ef, 1], edge_index [2,
        Ef], agent_index [N])``, the reference's ``state()`` contract."""
        from .rl.observation import observe

        return observe(self.state, self.network)

    def average_travel_time(self) -> float:
        return float(average_travel_time(self.state.agents))

    def plot_computation_time(self, output_dir: str = "data/outputs"):
        from .metrics.reporting import plot_computation_time

        return plot_computation_time(self.timers, output_dir)

    def plot_leg_histogram(self, output_dir: Optional[str] = "data/outputs"):
        from .metrics.reporting import plot_leg_histogram

        return plot_leg_histogram(self.leg_histogram_values,
                                  self.sim.timestep, output_dir)

    def plot_road_optimality(self, output_dir: Optional[str] = "data/outputs",
                             road_ids: Optional[list] = None):
        """The road-optimality figure from the active store: the sparse
        store's columns (by default the 20 roads of most delay), else the
        dense rows, else, where no per-tick series was kept, the hourly
        accumulator at hour resolution."""
        from .metrics.reporting import (
            plot_road_optimality, plot_road_optimality_columns)

        if (self.road_optimality_store == "sparse"
                and self.road_optimality_sparse):
            if road_ids is None:
                tot = self._sparse_road_total
                road_ids = [int(r) for r in
                            np.argsort(-tot)[:min(20, tot.size)]]
            times, mat = self.road_optimality_series(road_ids)
            return plot_road_optimality_columns(
                times, {rid: mat[:, j] for j, rid in enumerate(road_ids)},
                output_dir)
        values = self.road_optimality_values
        if not values and self.sim.record_road_optimality_hourly:
            mat = self.state.metrics.delta_tt_hourly.cpu().numpy()
            hours = np.nonzero(mat.sum(axis=1))[0]
            last = int(hours[-1]) + 1 if hours.size else 0
            values = [(h * 3600.0, mat[h]) for h in range(last)]
        return plot_road_optimality(values, output_dir, road_ids)

    def compute_node_metrics(self,
                             output_dir: Optional[str] = "data/outputs"):
        from .metrics.reporting import compute_node_metrics

        return compute_node_metrics(
            self.state.metrics.hourly_counts.cpu().numpy(),
            self.network.max_flow.cpu().numpy(), output_dir)

    def plot_daily_counts(self, expected_counts: dict,
                          output_dir: Optional[str] = "data/outputs"):
        from .metrics.reporting import plot_daily_counts

        return plot_daily_counts(
            self.state.metrics.hourly_counts.cpu().numpy(),
            expected_counts, output_dir)

    def get_info(self, road_id: int) -> str:
        """One road's occupancy, its first 15 queued agents (head first),
        its head's time to departure and selected road, and the clock."""
        road = self.state.road
        nmax = road.fifo_ids.shape[1]
        head = int(road.head[road_id])
        cols = [(head + j) % nmax for j in range(nmax)]
        ids = road.fifo_ids[road_id].cpu().numpy()[cols]
        cnt = int(road.count[road_id])
        cap = float(self.network.capacity[road_id])
        next_dep = float(road.fifo_departure[road_id, head]) - self.time
        sel = int(self.state.selected_road[road_id])
        return (f"Road {road_id}: {cnt} / {cap:.0f}\n"
                f"Queue: {ids[:15]}\n"
                f"Next departure in {next_dep:.0f}s toward road {sel}\n"
                f"Current time: {self.time:.0f}")
