"""The Manhattan grid of ``tarl_tpu_torch.io.scenarios.grid_scenario``, as
arrays: the network exactly as the MATSim parse of its XML numbers it
(intersections in sorted-id order, links in file order), and a commuter
population under the same law, drawn in numpy from the run's seed.

The law (``grid_scenario`` with ``num_dest_zones``): ``zones`` distinct
work intersections drawn uniformly; each commuter's destination uniform
over the zones, its origin uniform over the other intersections, its
departure a whole second uniform in ``[peak_start, peak_start +
peak_spread)``, its age a whole number uniform in ``[18, 80)``, its sex
female with probability one half, employed.
"""
from __future__ import annotations

import numpy as np

DUMMY_DEPARTURE = 48 * 3600.0


def _names(rows: int, cols: int) -> np.ndarray:
    r, c = np.divmod(np.arange(rows * cols), cols)
    return np.char.add(np.char.add("n", r.astype(str)),
                       np.char.add("_", c.astype(str)))


def network(cfg: dict) -> dict:
    """The parsed network: per-link ``length``, ``max_flow``,
    ``free_speed``, ``perm_lanes``, ``from_inter``, ``to_inter`` (sorted-id
    ordinals), per-intersection ``inter_x``, ``inter_y``, and
    ``num_intersections``, ``effective_cell_size``, and ``ordinal``
    (row-major generation index -> ordinal)."""
    rows, cols = int(cfg["rows"]), int(cfg["cols"])
    n = rows * cols
    ordinal = np.empty(n, np.int64)
    ordinal[np.argsort(_names(rows, cols), kind="stable")] = np.arange(n)
    node = np.arange(n).reshape(rows, cols)
    # Per intersection in row-major order, the links in the generator's
    # order: east, west (to and from the right neighbour), south, north.
    pairs = np.full((rows, cols, 4, 2), -1, np.int64)
    pairs[:, :-1, 0] = np.stack([node[:, :-1], node[:, 1:]], -1)
    pairs[:, :-1, 1] = np.stack([node[:, 1:], node[:, :-1]], -1)
    pairs[:-1, :, 2] = np.stack([node[:-1, :], node[1:, :]], -1)
    pairs[:-1, :, 3] = np.stack([node[1:, :], node[:-1, :]], -1)
    pairs = pairs.reshape(-1, 2)
    pairs = pairs[pairs[:, 0] >= 0]
    links = pairs.shape[0]
    block = float(cfg["block_length"])
    x = np.empty(n)
    y = np.empty(n)
    x[ordinal] = (np.arange(n) % cols) * block
    y[ordinal] = (np.arange(n) // cols) * block
    return {
        "length": np.full(links, block),
        "max_flow": np.full(links, float(cfg["capacity"])),
        "free_speed": np.full(links, float(cfg["freespeed"])),
        "perm_lanes": np.ones(links),
        "from_inter": ordinal[pairs[:, 0]],
        "to_inter": ordinal[pairs[:, 1]],
        "inter_x": x, "inter_y": y,
        "num_intersections": n,
        "effective_cell_size": 7.5,
        "ordinal": ordinal,
    }


def population(cfg: dict, net: dict, seed: int) -> dict:
    """The agent columns, row 0 the dummy agent (origin and dest 0,
    departure at 48 h, age 20): ``origin`` (SRC node ``R + 2k``), ``dest``
    (DEST node ``R + 2k + 1``), ``departure``, ``age``, ``sex``,
    ``employed``, in the order of the drawn commuters."""
    n = net["num_intersections"]
    r = net["length"].shape[0]
    a = int(cfg["num_agents"])
    rng = np.random.default_rng(seed)
    zones = rng.choice(n, size=int(cfg["zones"]), replace=False)
    dest = zones[rng.integers(0, zones.shape[0], a)]
    origin = rng.integers(0, n - 1, a)
    origin += origin >= dest
    dep = int(cfg["peak_start"]) + rng.integers(0, int(cfg["peak_spread"]), a)
    age = rng.integers(18, 80, a)
    sex = rng.random(a) < 0.5
    ordinal = net["ordinal"]
    return _with_dummy(r + 2 * ordinal[origin], r + 2 * ordinal[dest] + 1,
                       dep, age, sex.astype(np.float64), np.ones(a))


def _with_dummy(origin, dest, dep, age, sex, employed) -> dict:
    def col(dummy, a):
        return np.concatenate([[dummy], np.asarray(a, np.float64)])

    return {"origin": col(0, origin).astype(np.int64),
            "dest": col(0, dest).astype(np.int64),
            "departure": col(DUMMY_DEPARTURE, dep),
            "age": col(20.0, age), "sex": col(0.0, sex),
            "employed": col(0.0, employed)}
