"""Carry the reference's arrays across, and back.

``network_from_numpy``, ``agents_from_numpy`` and ``sim_state_from_numpy``
take dicts of numpy arrays — what ``np.asarray`` yields on the fields of the
reference's ``Network``, ``AgentState`` and ``SimState`` (nested states as
nested dicts) — and build the port's objects on a given device.
:func:`to_numpy` goes back: port objects become the same nested dicts, with
the reference's dtypes (the host scalars ``time``, ``key`` and
``insert_ptr`` as float32, uint32[2] and int32).  The routing scratch
``next_hop`` and ``sel_dest`` cross as they are.  Fields the port does not
keep (the roll plans, the dual ``nbr`` tables) are ignored on the way in.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .network import Network
from .state import (
    AgentState,
    BacklogState,
    MetricState,
    RoadState,
    SimState,
)


def _t(a, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a), device=device)


def network_from_numpy(d: dict, device: torch.device | str = "cpu"
                       ) -> Network:
    kwargs = {}
    for f in dataclasses.fields(Network):
        if f.name in ("num_roads", "num_intersections", "nmax"):
            kwargs[f.name] = int(d[f.name])
        elif f.name == "renumbered":
            kwargs[f.name] = bool(d.get(f.name, False))
        else:
            kwargs[f.name] = _t(d[f.name], device)
    return Network(**kwargs)


def agents_from_numpy(d: dict, device: torch.device | str = "cpu"
                      ) -> AgentState:
    return AgentState(**{f: _t(d[f], device) for f in AgentState._fields})


def _road_from_numpy(d: dict, device) -> RoadState:
    return RoadState(**{f: _t(d[f], device) for f in RoadState._fields})


def sim_state_from_numpy(d: dict, device: torch.device | str = "cpu"
                         ) -> SimState:
    backlog = d.get("backlog")
    sel_dest = d.get("sel_dest")
    key = np.asarray(d["key"]).astype(np.uint32)
    return SimState(
        road=_road_from_numpy(d["road"], device),
        agents=agents_from_numpy(d["agents"], device),
        selected_road=_t(d["selected_road"], device),
        time=float(np.float32(d["time"])),
        key=(int(key[0]), int(key[1])),
        metrics=MetricState(**{f: _t(d["metrics"][f], device)
                               for f in MetricState._fields}),
        next_hop=_t(d["next_hop"], device),
        choice_count=int(d["choice_count"]),
        insert_order=_t(d["insert_order"], device),
        insert_ptr=int(d["insert_ptr"]),
        backlog=None if backlog is None else BacklogState(
            **{f: _t(backlog[f], device) for f in BacklogState._fields}),
        sel_dest=None if sel_dest is None else _t(sel_dest, device),
    )


def to_numpy(obj: Any) -> Any:
    """Port objects (states, logs, networks, tensors) as nested dicts of
    numpy arrays."""
    if obj is None:
        return None
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, SimState):
        d = {f: to_numpy(getattr(obj, f)) for f in SimState._fields}
        d["time"] = np.float32(obj.time)
        d["key"] = np.asarray(obj.key, dtype=np.uint32)
        d["insert_ptr"] = np.int32(obj.insert_ptr)
        d["choice_count"] = np.int32(obj.choice_count)
        return d
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return {f: to_numpy(getattr(obj, f)) for f in obj._fields}
    if dataclasses.is_dataclass(obj):
        return {f.name: to_numpy(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    return np.asarray(obj)
