"""Configuration of the reference simulator: the program's field names and
defaults for the physics, the run and the routing."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PhysicsConfig:
    """Constants of the queueing / congestion model."""

    congestion_buffer: int = 3
    congestion_softening: float = 10.0
    gridlock_patience: float = 10.0
    seconds_per_hour: float = 3600.0
    effective_cell_size: float = 7.5


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Parameters of a simulation run.  ``insert_compact``,
    ``withdraw_compact`` and ``fused_core`` are accepted so that one
    traffic file configures both sides; the reference has only the default
    core and ignores the compaction budgets."""

    timestep: int = 1
    start_time: int = 0
    end_time: int = 86400
    seed: int = 0
    withdraw_depth: int | None = None
    withdraw_escalate: bool = True
    insert_window: int | None = None
    sorted_population: bool = False
    insert_escalate: bool = True
    insert_backlog: int | None = None
    insert_compact: int | str | None = "auto"
    withdraw_compact: int | str | None = "auto"
    record_road_optimality: bool = True
    record_road_optimality_hourly: bool = True
    fused_core: bool = False
    num_hours: int = 30


@dataclasses.dataclass(frozen=True)
class RoutingConfig:
    """Routing-policy knobs."""

    refresh_rate: int = 10
    max_bf_iters: int | None = None
    strict_compat: bool = False
    backend: str = "auto"
    cost_mode: str = "travel_time"


DEFAULT_PHYSICS = PhysicsConfig()
DEFAULT_SIM = SimConfig()
DEFAULT_ROUTING = RoutingConfig()
