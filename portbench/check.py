"""What decides ``correct``: the program's states and tick logs against the
plain reference (``portbench/reference``), element for element.

The reference (the cell's driver builds it, ``portbench/drivers``) is built
from the same generated arrays as the program: its own network (the
renumbering search included), agents, routing table and initial state.
Three numbers are compared, each with the limit 0:

* ``init_mismatch``: the program's network tables and saved initial state
  (its free-flow routing table included) against the reference's;
* ``start_mismatch``: the first ``L`` ticks of the window's first replay,
  run by the reference from its own initial state under the replay's key,
  against the program's state after them and its ``L`` tick logs;
* ``span_mismatch``: ticks ``[k0, k0 + L)`` of that replay (``k0`` drawn
  from the seed), run by the reference from the program's state at ``k0``,
  against the program's state at ``k0 + L`` and its tick logs.

A number is the count of elements (and host values: clock, key, pointers)
that differ bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def rounded_to(dtype):
    """``after_tick`` storing the state's time stamps (ring arrival and
    departure stamps, agents' departures and arrivals) in ``dtype``."""
    def after_tick(state):
        def low(t):
            return t.to(dtype).to(t.dtype)

        road, agents = state.road, state.agents
        return state._replace(
            road=road._replace(fifo_arrival=low(road.fifo_arrival),
                               fifo_departure=low(road.fifo_departure)),
            agents=agents._replace(departure=low(agents.departure),
                                   arrival=low(agents.arrival)))
    return after_tick


def leaves(x, path="") -> dict:
    """``{path: value}`` over dicts, named tuples and dataclasses."""
    if isinstance(x, dict):
        out = {}
        for k, v in x.items():
            out.update(leaves(v, f"{path}.{k}"))
        return out
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        out = {}
        for f in x._fields:
            out.update(leaves(getattr(x, f), f"{path}.{f}"))
        return out
    if dataclasses.is_dataclass(x):
        out = {}
        for f in dataclasses.fields(x):
            out.update(leaves(getattr(x, f.name), f"{path}.{f.name}"))
        return out
    return {path: x}


def _bits(t: torch.Tensor) -> torch.Tensor:
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    if t.dtype == torch.float64:
        return t.view(torch.int64)
    return t


def mismatches(a, b) -> int:
    """Elements (and host values) of ``a`` that differ bit for bit from
    ``b``, leaf by leaf; a leaf of another dtype or shape counts whole."""
    la, lb = leaves(a), leaves(b)
    count = 0
    for path in la.keys() | lb.keys():
        x, y = la.get(path), lb.get(path)
        if isinstance(x, torch.Tensor) or isinstance(y, torch.Tensor):
            if not (isinstance(x, torch.Tensor)
                    and isinstance(y, torch.Tensor)):
                count += (x if isinstance(x, torch.Tensor) else y).numel()
            elif x.dtype != y.dtype or x.shape != y.shape:
                count += max(x.numel(), y.numel())
            else:
                y = y.to(x.device)
                count += int((_bits(x) != _bits(y)).sum())
        elif np.asarray(x != y).any():
            count += 1
    return count


def compare(ref, prog, kept: dict, sp, key0) -> dict:
    """``{name: (value, limit)}``: the three numbers of the module
    docstring.  ``kept`` holds the program's states at ``L``, ``k0`` and
    ``k0 + L`` and, under ``("logs", 0)`` and ``("logs", k0)``, its tick
    logs of the two spans."""
    # The program's network carries cached properties of its own beside
    # the tables; compare the reference's tables.
    net_fields = [f.name for f in dataclasses.fields(ref.net)]
    prog_tables = {f: getattr(prog.net, f) for f in net_fields}
    ref_tables = {f: getattr(ref.net, f) for f in net_fields}
    state0 = ref.initial()
    init = (mismatches(prog_tables, ref_tables)
            + mismatches(ref.adopt(prog.state0), state0))

    start_state, start_logs = ref.run(state0._replace(key=key0), sp.span)
    start = (mismatches(ref.adopt(kept[sp.span]), start_state)
             + mismatches(ref.adopt(kept["logs", 0]), start_logs))
    del start_state

    span_state, span_logs = ref.run(ref.adopt(kept[sp.k0]), sp.span)
    span = (mismatches(ref.adopt(kept[sp.k0 + sp.span]), span_state)
            + mismatches(ref.adopt(kept["logs", sp.k0]), span_logs))
    return {"init_mismatch": (init, 0), "start_mismatch": (start, 0),
            "span_mismatch": (span, 0)}
