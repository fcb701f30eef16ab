"""The policy factory of the simulator facade (ports ``make_policy`` and
``_periodic_fields`` of ``tarl_tpu/simulator.py``).

``make_policy("random" | "dijkstra" | "so", routing, physics, network=,
dest_inters=)`` builds a :class:`~tarl_tpu_torch.core.step.Policy`.  The
shortest-path algorithms run on the primal backend; where the reference
would choose the dual backend, or ``strict_compat`` asks for it, this
raises ``NotImplementedError``: the dual tables are not ported yet.  The
facade class itself (phase timers, plotting) is not ported.
"""
from __future__ import annotations

import dataclasses
import functools

from .config import (
    DEFAULT_PHYSICS,
    DEFAULT_ROUTING,
    PhysicsConfig,
    RoutingConfig,
)
from .core.step import Policy
from .routing.bellman_ford import primal_relax_next_roads
from .routing.policies import (
    _NEVER_REFRESH,
    make_primal_dest_parts,
    make_shortest_path_choice_primal,
    primal_entry_lookup,
    primal_table_init,
    random_choice,
)


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
    ``N^2 > 64M`` rule), else the dual one.  ``dest_inters`` restricts the
    tables to those destination intersections.  ``relax`` computes each
    refresh (see :func:`~tarl_tpu_torch.routing.policies.
    make_shortest_path_choice_primal`)."""
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
        raise NotImplementedError(
            "the dual routing backend (and strict_compat) is not ported; "
            "use RoutingConfig(backend='primal')")
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
    :func:`~tarl_tpu_torch.core.step.run_episode_periodic`; empty when the
    policy never refreshes."""
    if routing.refresh_rate >= _NEVER_REFRESH:
        return {}
    return {"refresh": choice.refresh_fn, "lookup": choice.lookup_fn,
            "periodic_rate": int(routing.refresh_rate)}
