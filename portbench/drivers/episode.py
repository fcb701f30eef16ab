"""The episode driver: a policy from ``simulator.make_policy`` run through
``core.step.run_episode`` (its ``choice`` marked once a tick) or
``core.step.run_episode_periodic`` (its ``lookup`` marked once a tick, its
``refresh`` marked too), with the default core.

Traffic keys: ``policy`` (a ``make_policy`` name), ``episode``
(``run_episode`` or ``run_episode_periodic``), ``zoned`` (one routing
column per distinct destination intersection), ``routing``
(``RoutingConfig`` fields) and ``sim`` (``SimConfig`` fields).
"""
from __future__ import annotations

import time

import numpy as np


def replay_ticks(cell) -> tuple[int, int]:
    """The ticks of a replay, and the refresh rate its chunks keep to."""
    tr = cell.traffic
    ticks = int(cell.config["simulated_s"]) // int(tr["sim"].get("timestep",
                                                                  1))
    grid = int(tr.get("routing", {}).get("refresh_rate", 1)) \
        if tr["episode"] == "run_episode_periodic" else 1
    return ticks, grid


class Program:
    """The system under test: the network, the agents, the policy (its
    once-a-tick callable and refresh wrapped with marks), the episode
    function and the saved initial state."""

    def __init__(self, cell, net_arrays: dict, pop: dict, device, marks):
        import torch

        from tarl_tpu_torch import config as pc
        from tarl_tpu_torch.core import step
        from tarl_tpu_torch.network import build_network
        from tarl_tpu_torch.simulator import make_policy
        from tarl_tpu_torch.state import init_agent_state, \
            sort_agents_by_departure

        cfg, tr = cell.config, cell.traffic
        self.torch = torch
        self.marks = marks
        self.physics = pc.PhysicsConfig(**physics_fields(cfg, net_arrays))
        t0 = time.perf_counter()
        self.net = build_network(
            **network_fields(net_arrays), physics=self.physics,
            device=device)
        marks.clock.sync()
        self.network_s = time.perf_counter() - t0
        agents = sort_agents_by_departure(init_agent_state(
            pop["origin"], pop["dest"], pop["departure"], pop["age"],
            pop["sex"], pop["employed"], device=device))
        self.rows = agents.num_agents
        self.sim = pc.SimConfig(start_time=int(cfg["start_time"]),
                                **tr["sim"])
        routing = pc.RoutingConfig(**tr.get("routing", {}))
        zones = dest_inters(net_arrays, pop) if tr.get("zoned") else None
        self.periodic = tr["episode"] == "run_episode_periodic"
        self.marked = "lookup" if self.periodic else "choice"
        self.run_fn = getattr(step, tr["episode"])
        self.policy = self._wrapped(make_policy(
            tr["policy"], routing, self.physics, network=self.net,
            dest_inters=zones))
        self.state0 = step.init_sim_state(self.net, agents, sim=self.sim,
                                          policy=self.policy)
        marks.clock.sync()

    def _wrapped(self, policy):
        marks, periodic = self.marks, self.periodic

        def timed(fn):
            def call(state, network, *rest):
                a = marks.clock.mark()
                out = fn(state, network, *rest)
                marks.ticks.append((a, marks.clock.mark()))
                # ``lookup`` returns the state, ``choice`` (state, entry).
                s = out if periodic else out[0]
                if marks.tick in marks.keep_ticks:
                    marks.tick_inputs.append((s.road, s.selected_road,
                                              s.time, s.key))
                marks.tick += 1
                return out
            return call

        if not periodic:
            return policy._replace(choice=timed(policy.choice))
        refresh = policy.refresh

        def timed_refresh(state, network):
            a = marks.clock.mark()
            buf = refresh(state, network)
            marks.refreshes.append((a, marks.clock.mark()))
            if marks.keep_refresh:
                marks.refresh_inputs.append((state.road.count,
                                             state.next_hop))
            return buf

        return policy._replace(lookup=timed(policy.lookup),
                               refresh=timed_refresh)

    def replay_state(self, key):
        """The saved initial state, copied, under the replay's key."""
        return clone_tree(self.state0, self.torch)._replace(key=key)

    def run(self, state, ticks: int):
        return self.run_fn(state, self.net, self.policy, ticks, sim=self.sim,
                           physics=self.physics)


class Reference:
    """The plain reference of the cell (``portbench/reference``), built
    from the generated arrays.  ``lower`` (a dtype or None) stores every
    time stamp of the state in that precision after each tick: the
    control."""

    def __init__(self, cell, net_arrays: dict, pop: dict, device,
                 lower=None):
        from ..check import rounded_to
        from ..reference import config as rc
        from ..reference import network as rn
        from ..reference import routing as rr
        from ..reference import state as rs
        from ..reference import step as rstep

        cfg, tr = cell.config, cell.traffic
        self.state_types = rs
        self.physics = rc.PhysicsConfig(**physics_fields(cfg, net_arrays))
        self.net = rn.build_network(**network_fields(net_arrays),
                                    physics=self.physics, device=device)
        self.agents = rs.sort_agents_by_departure(rs.init_agent_state(
            pop["origin"], pop["dest"], pop["departure"], pop["age"],
            pop["sex"], pop["employed"], device=device))
        self.sim = rc.SimConfig(start_time=int(cfg["start_time"]),
                                **tr["sim"])
        routing = rc.RoutingConfig(**tr.get("routing", {}))
        zones = dest_inters(net_arrays, pop) if tr.get("zoned") else None
        self.policy = rr.make_policy(tr["policy"], routing, self.physics,
                                     dest_inters=zones)
        self.run_fn = getattr(rstep, tr["episode"])
        self.init_fn = rstep.init_sim_state
        self.after_tick = None if lower is None else rounded_to(lower)

    def initial(self, key=None):
        return self.init_fn(self.net, self.agents, sim=self.sim,
                            policy=self.policy, key=key)

    def run(self, state, ticks: int):
        return self.run_fn(state, self.net, self.policy, ticks, sim=self.sim,
                           physics=self.physics, after_tick=self.after_tick)

    def adopt(self, x):
        """A program state as the reference's types (tensors shared)."""
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            cls = getattr(self.state_types, type(x).__name__)
            return cls(*(self.adopt(v) for v in x))
        return x


def physics_fields(cfg: dict, net_arrays: dict) -> dict:
    return dict(cfg.get("physics", {}),
                effective_cell_size=float(net_arrays["effective_cell_size"]))


def network_fields(a: dict) -> dict:
    return {k: a[k] for k in ("length", "max_flow", "free_speed",
                              "perm_lanes", "from_inter", "to_inter",
                              "num_intersections", "inter_x", "inter_y")}


def dest_inters(net_arrays: dict, pop: dict) -> np.ndarray:
    """The distinct destination intersections of the population, the dummy
    agent's clamped intersection 0 among them: one routing-table column
    each."""
    r = net_arrays["length"].shape[0]
    i_n = net_arrays["num_intersections"]
    return np.unique(np.clip((pop["dest"] - r - 1) // 2, 0, i_n - 1))


def clone_tree(x, torch):
    """A copy of a state: tensors cloned, tuples rebuilt, other values
    kept."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(clone_tree(v, torch) for v in x))
    return x
