"""Scenario caches (ports ``tarl_tpu/io/cache.py``: ``save_network``,
``load_network_cache``, ``save_population``, ``load_population_cache``,
``save_sim_state``, ``load_sim_state``, ``load_or_build_network`` and
``load_or_build_population``).

The port's files have names of their own, ``save/<scenario>/
torch_network.npz`` and ``torch_population.npz``, beside the reference's
``network.npz`` and ``population.npz``: the port's :class:`~tarl_tpu_torch.
network.Network` has other fields, and a ``save/`` shared by both packages
must never hand one package the other's file.  Each file carries the tag
:data:`CACHE_TAG`; a file without it, or with another, is stale and is
rebuilt from the scenario's XML.  Every loader takes ``device=`` (None is
the card).
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..convert import network_from_numpy, sim_state_from_numpy, to_numpy
from ..network import Network
from ..schema import agent_features_matrix, agents_from_matrix
from ..state import AgentState, SimState

# Written into every file under "__tarl_tpu_torch__"; bump when the
# Network, AgentState or SimState fields or their build change (2: road
# numbering by the renumbering search).
CACHE_TAG = "tarl_tpu_torch.cache.2"
NETWORK_FILE = "torch_network.npz"
POPULATION_FILE = "torch_population.npz"
_TAG_KEY = "__tarl_tpu_torch__"


def _check_tag(data, path: str) -> None:
    if _TAG_KEY not in data.files or str(data[_TAG_KEY]) != CACHE_TAG:
        raise ValueError(f"stale or foreign cache {path}")


def save_network(network: Network, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {_TAG_KEY: np.asarray(CACHE_TAG)}
    for k, v in to_numpy(network).items():
        arrays[k] = np.asarray(v)
    np.savez_compressed(path, **arrays)


def load_network_cache(path: str,
                       device: torch.device | str | None = None) -> Network:
    with np.load(path) as data:
        _check_tag(data, path)
        return network_from_numpy(
            {f.name: data[f.name] for f in dataclasses.fields(Network)},
            device)


def save_population(agents: AgentState, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(
        path, **{_TAG_KEY: np.asarray(CACHE_TAG)},
        agent_features=agent_features_matrix(agents).cpu().numpy())


def load_population_cache(path: str,
                          device: torch.device | str | None = None
                          ) -> AgentState:
    with np.load(path) as data:
        _check_tag(data, path)
        return agents_from_matrix(data["agent_features"], device=device)


def _flatten(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        elif v is not None:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def save_sim_state(state: SimState, path: str) -> None:
    """Checkpoint a whole :class:`~tarl_tpu_torch.state.SimState` mid-episode
    (queues, agents, clock, key, metric accumulators, routing scratch), so
    that an episode can resume at any tick."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **{_TAG_KEY: np.asarray(CACHE_TAG)},
                        **_flatten(to_numpy(state)))


def load_sim_state(template: SimState, path: str,
                   device: torch.device | str | None = None) -> SimState:
    """Restore a state saved by :func:`save_sim_state` on ``device``;
    ``template`` is a state of the same structure (e.g. from
    ``init_sim_state``), against whose fields, dtypes and shapes the file
    is checked."""
    with np.load(path) as data:
        _check_tag(data, path)
        flat = {k: data[k] for k in data.files if k != _TAG_KEY}
    want = _flatten(to_numpy(template))
    if set(flat) != set(want) or any(
            flat[k].dtype != want[k].dtype or flat[k].shape != want[k].shape
            for k in want):
        raise ValueError(f"{path} does not hold a state shaped like the "
                         "template")
    return sim_state_from_numpy(_unflatten(flat), device)


def load_or_build_network(scenario: str, data_root: str = "data",
                          save_root: str = "save",
                          device: torch.device | str | None = None
                          ) -> Network:
    """The cached network, or the scenario's XML parsed (and cached)."""
    cache_path = os.path.join(save_root, scenario, NETWORK_FILE)
    if os.path.exists(cache_path):
        try:
            return load_network_cache(cache_path, device)
        except (ValueError, KeyError):
            print(f"Stale cache {cache_path}; rebuilding from XML")
    from .matsim import load_network
    from .scenarios import ensure_scenario

    base = ensure_scenario(data_root, scenario)
    network = load_network(os.path.join(base, "network"), device=device)
    save_network(network, cache_path)
    return network


def load_or_build_population(scenario: str, data_root: str = "data",
                             save_root: str = "save",
                             device: torch.device | str | None = None
                             ) -> AgentState:
    """The cached population, or the scenario's XML parsed (and cached)."""
    cache_path = os.path.join(save_root, scenario, POPULATION_FILE)
    if os.path.exists(cache_path):
        try:
            return load_population_cache(cache_path, device)
        except (ValueError, KeyError):
            print(f"Stale cache {cache_path}; rebuilding from XML")
    from .matsim import load_population
    from .scenarios import ensure_scenario

    base = ensure_scenario(data_root, scenario)
    agents, _ = load_population(os.path.join(base, "population"),
                                os.path.join(base, "network"), device=device)
    save_population(agents, cache_path)
    return agents
