"""Carry the reference's arrays across, and back.

``network_from_numpy``, ``agents_from_numpy`` and ``sim_state_from_numpy``
take dicts of numpy arrays — what ``np.asarray`` yields on the fields of the
reference's ``Network``, ``AgentState`` and ``SimState`` (nested states as
nested dicts) — and build the port's objects on a given device.
:func:`to_numpy` goes back: port objects become the same nested dicts, with
the reference's dtypes (the host scalars ``time``, ``key`` and
``insert_ptr`` as float32, uint32[2] and int32).  The routing scratch
``next_hop`` and ``sel_dest`` cross as they are.  Fields the port does not
keep (the roll plans) are ignored on the way in.

:func:`mpnn_params_from_numpy` carries the reference's MPNN parameters
(Flax trees as numpy: ``{"policy": {"params": {layer: {"kernel", "bias"}}},
"value": ...}``) into the port's state dicts, and
:func:`mpnn_params_to_numpy` goes back; :func:`load_params_npz` reads such a
tree from an ``.npz`` of flat ``policy/params/edge_fc1/kernel`` keys.
:func:`adam_state_from_numpy` carries optax's ``ScaleByAdamState``
(``count``, and ``mu`` and ``nu`` keyed like those parameter trees) into the
port's ``rl.ppo.AdamState``, and :func:`adam_state_to_numpy` goes back.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .device import resolve_device
from .network import Network
from .state import (
    AgentState,
    BacklogState,
    MetricState,
    RoadState,
    SimState,
)


def _t(a, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a), device=resolve_device(device))


def network_from_numpy(d: dict, device: torch.device | str | None = None
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


def agents_from_numpy(d: dict, device: torch.device | str | None = None
                      ) -> AgentState:
    return AgentState(**{f: _t(d[f], device) for f in AgentState._fields})


def _road_from_numpy(d: dict, device) -> RoadState:
    return RoadState(**{f: _t(d[f], device) for f in RoadState._fields})


def sim_state_from_numpy(d: dict, device: torch.device | str | None = None
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
        d["time"] = np.float32(float(obj.time))
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


def _module_params_from_numpy(tree: dict, device) -> dict:
    """One Flax module tree -> a state dict: a Dense ``kernel [in, out]``
    becomes ``<name>.weight [out, in]``, an Embed ``embedding`` becomes
    ``<name>.weight``."""
    tree = tree.get("params", tree)
    out = {}
    for name, leaves in tree.items():
        for leaf, arr in leaves.items():
            a = np.asarray(arr, dtype=np.float32)
            if leaf == "kernel":
                out[f"{name}.weight"] = _t(a.T, device)
            elif leaf == "bias":
                out[f"{name}.bias"] = _t(a, device)
            elif leaf == "embedding":
                out[f"{name}.weight"] = _t(a, device)
            else:
                raise ValueError(f"unknown parameter {name}/{leaf}")
    return out


def mpnn_params_from_numpy(tree: dict, device: torch.device | str | None = None
                           ) -> dict:
    """``{"policy": state_dict, "value": state_dict}`` from the reference's
    ``{"policy": ..., "value": ...}`` parameter trees."""
    return {part: _module_params_from_numpy(tree[part], device)
            for part in ("policy", "value")}


# The Flax Embed modules of the MPNN nets (the rest are Dense).
_EMBEDDINGS = ("nodes_embedding",)


def mpnn_params_to_numpy(params: dict) -> dict:
    """The inverse of :func:`mpnn_params_from_numpy`: Flax-shaped trees of
    numpy arrays."""
    out = {}
    for part, state in params.items():
        layers: dict = {}
        for key, t in state.items():
            name, leaf = key.rsplit(".", 1)
            a = t.detach().cpu().numpy()
            if name in _EMBEDDINGS:
                layers.setdefault(name, {})["embedding"] = a
            elif leaf == "weight":
                layers.setdefault(name, {})["kernel"] = np.ascontiguousarray(
                    a.T)
            else:
                layers.setdefault(name, {})["bias"] = a
        out[part] = {"params": layers}
    return out


def adam_state_from_numpy(state: dict,
                          device: torch.device | str | None = None):
    """The port's ``AdamState`` from ``{"count", "mu", "nu"}`` as numpy:
    the fields of the reference's optax ``ScaleByAdamState``, the moments
    shaped like its parameter trees."""
    from .rl.ppo import AdamState

    return AdamState(int(np.asarray(state["count"])),
                     mpnn_params_from_numpy(state["mu"], device),
                     mpnn_params_from_numpy(state["nu"], device))


def adam_state_to_numpy(state) -> dict:
    """The inverse of :func:`adam_state_from_numpy` (``count`` as
    int32)."""
    return {"count": np.int32(state.count),
            "mu": mpnn_params_to_numpy(state.mu),
            "nu": mpnn_params_to_numpy(state.nu)}


def load_params_npz(path: str) -> dict:
    """A nested dict of numpy arrays from an ``.npz`` whose keys are
    ``/``-separated paths."""
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return tree
