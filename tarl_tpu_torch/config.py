"""Typed configuration of the PyTorch port (ports ``tarl_tpu/config.py``).

``PhysicsConfig``, ``SimConfig``, ``RoutingConfig`` and ``RLConfig``
keep the reference's field names and defaults so one configuration reads
the same in both packages. A few ``SimConfig`` fields only choose
between bitwise-identical evaluation strategies of the TPU build
(``insert_compact``, ``withdraw_compact``); the port accepts and ignores
them. ``fused_core`` selects the fused edge-phase core
(:mod:`tarl_tpu_torch.core.fused_core`) for networks of at most 4,096
roads, as the reference does on its own chip; it samples the same law as
the default core from another random stream.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PhysicsConfig:
    """Constants of the queueing / congestion model."""

    # Slots at the tail of every FIFO reserved for gridlock resolution.
    congestion_buffer: int = 3
    # Softening constant in ``tt = max(fftt, cc / (cap + softening - n))``.
    congestion_softening: float = 10.0
    # Seconds past the scheduled departure after which the gridlock-escape
    # submask activates.
    gridlock_patience: float = 10.0
    # Critical-density factor: capacity [veh/h] * fftt [s] / 3600.
    seconds_per_hour: float = 3600.0
    # MATSim default effective cell size [m] when the XML omits it.
    effective_cell_size: float = 7.5


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Parameters of a simulation run (same fields as the reference)."""

    timestep: int = 1                 # seconds between ticks
    start_time: int = 0               # seconds since midnight
    end_time: int = 86400             # seconds since midnight
    seed: int = 0
    # Maximum withdrawals per road per tick scanned from the FIFO head
    # (None = the whole queue).
    withdraw_depth: int | None = None
    # Re-scan roads whose pop run hit the depth bound until none saturates.
    withdraw_escalate: bool = True
    # Insertion candidate window (None = the whole population).
    insert_window: int | None = None
    # Ids 1..A-1 are in nondecreasing departure order.
    sorted_population: bool = False
    # Extra window passes on saturated ticks (windowed insert).
    insert_escalate: bool = True
    # Per-SRC candidate queue depth of the backlog insert (None = off).
    insert_backlog: int | None = None
    # TPU scatter-compaction budgets; bitwise-neutral, ignored by the port.
    insert_compact: int | str | None = "auto"
    withdraw_compact: int | str | None = "auto"
    # Per-tick [T, R] road-optimality series.
    record_road_optimality: bool = True
    # Hourly [H, R] road-optimality accumulator.
    record_road_optimality_hourly: bool = True
    # The fused edge-phase core (one Gumbel-max over the turn edges per
    # downstream road, kernel K12) for R <= 4,096; a different random stream.
    fused_core: bool = False
    # Hour buckets of the traffic-count accumulator.
    num_hours: int = 30

    @property
    def num_steps(self) -> int:
        return (self.end_time - self.start_time) // self.timestep


@dataclasses.dataclass(frozen=True)
class RoutingConfig:
    """Routing-policy knobs (same fields and defaults as the reference)."""

    # Ticks between shortest-path table refreshes.
    refresh_rate: int = 10
    # Cap on Bellman-Ford sweeps per refresh (None = until converged).
    max_bf_iters: int | None = None
    # The reference simulator's own entry-road and edge-cost quirks; needs
    # the dual backend, which the port does not have yet.
    strict_compat: bool = False
    # "primal" (intersection tables), "dual" (not ported) or "auto".
    backend: str = "auto"
    # "travel_time" (user-equilibrium seeking) or "marginal" (system
    # optimal: tt + n * dtt/dn).
    cost_mode: str = "travel_time"


@dataclasses.dataclass(frozen=True)
class RLConfig:
    """PPO and environment parameters (same fields and defaults as the
    reference; ``rl/env.py`` documents the reward modes)."""

    episode_start: int = 6 * 3600 - 60   # env reset time
    episode_end: int = 7 * 3600          # done threshold
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_epsilon: float = 0.2
    learning_rate: float = 1e-3
    # Terminal cosine lr anneal: hold ``learning_rate`` for
    # ``lr_anneal_start`` updates, then decay to ``lr_anneal_floor *
    # learning_rate`` over ``lr_anneal_updates`` updates (None = off).
    lr_anneal_updates: int | None = None
    lr_anneal_start: int = 0
    lr_anneal_floor: float = 0.0
    entropy_coef: float = 0.0
    value_coef: float = 1.0
    rollout_steps: int = 32
    num_epochs: int = 1
    minibatch_size: int = 32
    num_envs: int = 1
    max_grad_norm: float | None = None
    # "on_network" (-(agents on the network)), "individual" (100 * 600 /
    # travel time of this step's arrivals), "throughput" (arrivals),
    # "system" (-(on the network + due and not inserted) / progress_scale)
    # or "progress" (decrease of the potential Phi / progress_scale).
    reward_mode: str = "on_network"
    progress_scale: float = 100.0
    # "progress" with the potential's distance-to-go under the current
    # congested costs (one all-pairs relaxation per step).
    congested_potential: bool = False
    # Surface each SRC node's earliest pending entrant in the observation.
    observe_pending_entrants: bool = True
    # Append the three congestion columns of
    # ``rl.observation.extra_node_features`` to the context.
    extra_obs: bool = False


DEFAULT_PHYSICS = PhysicsConfig()
DEFAULT_SIM = SimConfig()
DEFAULT_ROUTING = RoutingConfig()
DEFAULT_RL = RLConfig()
