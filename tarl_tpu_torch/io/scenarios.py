"""Synthetic scenario generators (ports ``tarl_tpu/io/scenarios.py``).

Numpy and XML only, copied from the reference so both packages write the
same scenario files from the same seed.

The reference expects scenarios under ``data/<name>/{network,population}.xml``
(transportation_simulator.py:256-265, agents/base.py:83-84) but ships none.
These generators emit MATSim-format XML so the whole ingestion path — and any
MATSim tooling — can be exercised end to end, and also build scenarios
directly as arrays for benchmarks.

Available generators:

* :func:`braess_network` — the 4-intersection Braess diamond, the canonical
  equilibrium test case (mirrors the spirit of tests/conftest.py:45-91).
* :func:`grid_scenario` — an n x m Manhattan grid with bidirectional links
  and a random commuter population, the workhorse benchmark scenario.
* :func:`two_link_scenario` — the reference's 2-link test network
  (tests/conftest.py:94-106).

:func:`pad_network_xml` pads a network's XML with inert roads to a multiple
of a block count.
"""
from __future__ import annotations

import gzip
import os
from typing import Optional

import numpy as np


def _write_xml(path: str, content: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if path.endswith(".gz"):
        with gzip.open(path, "wt") as f:
            f.write(content)
    else:
        with open(path, "w") as f:
            f.write(content)


def network_xml(nodes: list[tuple[str, float, float]],
                links: list[dict], effective_cell_size: float = 7.5) -> str:
    """Serialize node/link tables to MATSim network XML."""
    parts = ["<network>", " <nodes>"]
    for nid, x, y in nodes:
        parts.append(f'  <node id="{nid}" x="{x}" y="{y}"/>')
    parts.append(" </nodes>")
    parts.append(f' <links effectivecellsize="{effective_cell_size}">')
    for l in links:
        parts.append(
            '  <link id="{id}" from="{from_}" to="{to}" length="{length}" '
            'capacity="{capacity}" freespeed="{freespeed}" permlanes="{permlanes}"/>'.format(**l)
        )
    parts.append(" </links>")
    parts.append("</network>")
    return "\n".join(parts)


def population_xml(trips: list[dict]) -> str:
    """Serialize trips to MATSim population XML.

    Each trip dict: ``{person, origin, dest, end_time, age, sex, employed}``
    where origin/dest are intersection ids and ``end_time`` is "HH:MM:SS".
    """
    parts = ["<population>"]
    for t in trips:
        parts.append(f' <person id="{t["person"]}">')
        parts.append("  <attributes>")
        parts.append(f'   <attribute name="car_avail">always</attribute>')
        parts.append(f'   <attribute name="age">{t.get("age", 30)}</attribute>')
        parts.append(f'   <attribute name="sex">{t.get("sex", "m")}</attribute>')
        parts.append(f'   <attribute name="employed">{t.get("employed", "yes")}</attribute>')
        parts.append("  </attributes>")
        parts.append("  <plan>")
        parts.append(
            f'   <act type="home" link="{t["origin"]}" end_time="{t["end_time"]}"/>'
        )
        parts.append(f'   <act type="work" link="{t["dest"]}"/>')
        parts.append("  </plan>")
        parts.append(" </person>")
    parts.append("</population>")
    return "\n".join(parts)


def two_link_scenario(root: str, name: str = "TwoLink") -> str:
    """The reference test network: A<->B with two 100 m links
    (tests/conftest.py:94-106) plus one commuter A->B."""
    nodes = [("A", 0.0, 0.0), ("B", 100.0, 0.0)]
    links = [
        dict(id="0", from_="A", to="B", length=100, capacity=10, freespeed=10, permlanes=1),
        dict(id="1", from_="B", to="A", length=100, capacity=10, freespeed=10, permlanes=1),
    ]
    trips = [dict(person="p1", origin="A", dest="B", end_time="00:00:00")]
    base = os.path.join(root, name)
    _write_xml(os.path.join(base, "network.xml"), network_xml(nodes, links))
    _write_xml(os.path.join(base, "population.xml"), population_xml(trips))
    return base


def braess_network(root: str, name: str = "Braess",
                   num_agents: int = 200, seed: int = 0) -> str:
    """Braess diamond: S -> {U, D} -> T plus the U->D shortcut.

    The classic Price-of-Anarchy example: adding the shortcut worsens the
    user equilibrium, which the TSTT / Nash-gap / PoA metrics should expose.
    """
    nodes = [("S", 0, 0), ("U", 500, 500), ("D", 500, -500), ("T", 1000, 0)]
    links = [
        dict(id="SU", from_="S", to="U", length=700, capacity=600, freespeed=14, permlanes=1),
        dict(id="SD", from_="S", to="D", length=700, capacity=1800, freespeed=7, permlanes=1),
        dict(id="UT", from_="U", to="T", length=700, capacity=1800, freespeed=7, permlanes=1),
        dict(id="DT", from_="D", to="T", length=700, capacity=600, freespeed=14, permlanes=1),
        dict(id="UD", from_="U", to="D", length=100, capacity=1800, freespeed=20, permlanes=1),
        # return links so T is not a sink in the dual graph
        dict(id="TS", from_="T", to="S", length=1400, capacity=1800, freespeed=14, permlanes=2),
    ]
    rng = np.random.default_rng(seed)
    trips = []
    for i in range(num_agents):
        dep = 6 * 3600 + int(rng.integers(0, 1800))
        hh, mm, ss = dep // 3600, (dep % 3600) // 60, dep % 60
        trips.append(
            dict(person=f"p{i}", origin="S", dest="T",
                 end_time=f"{hh:02d}:{mm:02d}:{ss:02d}")
        )
    base = os.path.join(root, name)
    _write_xml(os.path.join(base, "network.xml"), network_xml(nodes, links))
    _write_xml(os.path.join(base, "population.xml"), population_xml(trips))
    return base


def bottleneck_scenario(root: str, name: str = "Bottleneck",
                        num_agents: int = 720, demand_seconds: int = 600,
                        seed: int = 0) -> str:
    """Two-route bottleneck: S -> A -> T (fast free-flow, low capacity) vs
    S -> B -> T (slower free-flow, high capacity).

    Sized so the user equilibrium is a *mixed* split (~0.68 agents/s down the
    fast route keeps both routes at ~80 s) while demand (1.2 agents/s) exceeds
    what the fast route can carry.  A deterministic congested next-hop table
    (DijkstraAgents, reference base.py:519-584) routes every co-located agent
    identically, so it can only bang-bang between the routes at its refresh
    period — the classic delayed-feedback oscillation — whereas a stochastic
    learned policy can realize the split.  A third, decoy route (S -> C -> T,
    free-flow ~250 s, never part of any equilibrium) separates the methods:
    uniform random wastes a third of the demand on it, the flapping table
    avoids it but oscillates, and a learned policy must BOTH avoid the decoy
    AND mix the two good routes.  Companion experiment to the Braess network
    (same file): Braess shows equilibrium *selection*, this shows equilibrium
    *mixing*.
    """
    nodes = [("S", 0, 0), ("A", 500, 200), ("B", 500, -200),
             ("C", 500, -600), ("T", 1000, 0)]
    links = [
        # fast, scarce: fftt 20 s/link, 41 cells, queue tt up to ~73 s/link
        dict(id="SA", from_="S", to="A", length=300, capacity=600, freespeed=15, permlanes=1),
        dict(id="AT", from_="A", to="T", length=300, capacity=600, freespeed=15, permlanes=1),
        # slow, plentiful: fftt 70+10 s, effectively uncongestible here
        dict(id="SB", from_="S", to="B", length=1050, capacity=3600, freespeed=15, permlanes=1),
        dict(id="BT", from_="B", to="T", length=150, capacity=3600, freespeed=15, permlanes=1),
        # decoy: fftt 240+10 s, plentiful — never optimal
        dict(id="SC", from_="S", to="C", length=1200, capacity=3600, freespeed=5, permlanes=1),
        dict(id="CT", from_="C", to="T", length=150, capacity=3600, freespeed=15, permlanes=1),
        # return link so T is not a sink in the dual graph
        dict(id="TS", from_="T", to="S", length=1400, capacity=3600, freespeed=20, permlanes=1),
    ]
    rng = np.random.default_rng(seed)
    trips = []
    for i in range(num_agents):
        dep = 6 * 3600 + int(rng.integers(0, demand_seconds))
        hh, mm, ss = dep // 3600, (dep % 3600) // 60, dep % 60
        trips.append(
            dict(person=f"p{i}", origin="S", dest="T",
                 end_time=f"{hh:02d}:{mm:02d}:{ss:02d}")
        )
    base = os.path.join(root, name)
    _write_xml(os.path.join(base, "network.xml"), network_xml(nodes, links))
    _write_xml(os.path.join(base, "population.xml"), population_xml(trips))
    return base


def grid_scenario(
    root: str,
    name: Optional[str] = None,
    *,
    rows: int = 4,
    cols: int = 4,
    num_agents: int = 500,
    block_length: float = 200.0,
    capacity: float = 600.0,
    freespeed: float = 13.9,
    peak_start: int = 6 * 3600,
    peak_spread: int = 3600,
    seed: int = 0,
    num_dest_zones: Optional[int] = None,
) -> str:
    """An ``rows x cols`` Manhattan grid with bidirectional links and a random
    commuter population drawn over all intersection pairs.

    ``num_dest_zones`` restricts trip destinations to a random subset of that
    many intersections (commuter "work zones") — the population shape the
    destination-restricted routing tables are built for."""
    name = name or f"Grid{rows}x{cols}"
    nodes = []
    for r in range(rows):
        for c in range(cols):
            nodes.append((f"n{r}_{c}", c * block_length, r * block_length))

    links = []

    def add(u, v):
        links.append(
            dict(id=f"l{len(links)}", from_=u, to=v, length=block_length,
                 capacity=capacity, freespeed=freespeed, permlanes=1)
        )

    for r in range(rows):
        for c in range(cols):
            if c + 1 < cols:
                add(f"n{r}_{c}", f"n{r}_{c + 1}")
                add(f"n{r}_{c + 1}", f"n{r}_{c}")
            if r + 1 < rows:
                add(f"n{r}_{c}", f"n{r + 1}_{c}")
                add(f"n{r + 1}_{c}", f"n{r}_{c}")

    rng = np.random.default_rng(seed)
    inter_ids = [n[0] for n in nodes]
    if num_dest_zones is not None:
        zones = rng.choice(len(inter_ids), size=num_dest_zones, replace=False)
    trips = []
    for i in range(num_agents):
        if num_dest_zones is not None:
            o = int(rng.integers(0, len(inter_ids)))
            d = int(zones[rng.integers(0, num_dest_zones)])
            while d == o:
                o = int(rng.integers(0, len(inter_ids)))
            dep = peak_start + int(rng.integers(0, peak_spread))
            hh, mm, ss = dep // 3600, (dep % 3600) // 60, dep % 60
            trips.append(
                dict(person=f"p{i}", origin=inter_ids[o], dest=inter_ids[d],
                     end_time=f"{hh:02d}:{mm:02d}:{ss:02d}",
                     age=int(rng.integers(18, 80)),
                     sex="f" if rng.random() < 0.5 else "m")
            )
            continue
        o, d = rng.choice(len(inter_ids), size=2, replace=False)
        dep = peak_start + int(rng.integers(0, peak_spread))
        hh, mm, ss = dep // 3600, (dep % 3600) // 60, dep % 60
        trips.append(
            dict(person=f"p{i}", origin=inter_ids[o], dest=inter_ids[d],
                 end_time=f"{hh:02d}:{mm:02d}:{ss:02d}",
                 age=int(rng.integers(18, 80)),
                 sex="f" if rng.random() < 0.5 else "m")
        )
    base = os.path.join(root, name)
    _write_xml(os.path.join(base, "network.xml"), network_xml(nodes, links))
    _write_xml(os.path.join(base, "population.xml"), population_xml(trips))
    return base


def radial_scenario(
    root: str,
    name: Optional[str] = None,
    *,
    rings: int = 8,
    spokes: int = 12,
    num_agents: int = 5000,
    ring_spacing: float = 400.0,
    capacity: float = 600.0,
    radial_capacity: float = 1200.0,
    freespeed: float = 13.9,
    peak_start: int = 6 * 3600,
    peak_spread: int = 3600,
    cbd_fraction: float = 0.7,
    center_spurs: Optional[int] = None,
    seed: int = 0,
) -> str:
    """A ring-and-spoke metro: ``rings`` concentric rings of ``spokes``
    intersections around a centre, ring roads between angular neighbours and
    higher-capacity radial roads along each spoke (plus centre spurs).

    ``center_spurs`` (default ``min(spokes, 8)``) caps how many evenly-
    spaced spokes connect to the centre node: the slot-major core and the
    primal routing tables are sized by the MAXIMUM node degree, so a
    degree-``spokes`` hub would inflate every [K, ·] table network-wide —
    and real arterial systems feed a CBD through a handful of radials, not
    one junction of 128 legs.

    The NON-GRID counterpart of :func:`grid_scenario`: ring-link lengths grow
    with radius, the turn-graph delta structure is irregular (ring wrap +
    centre spurs), and commuting is CBD-concentrated — ``cbd_fraction`` of
    trips end in the central zone (centre + innermost ring), the natural
    workload for destination-restricted routing tables.  No reference
    equivalent (its scenarios are hand-authored XML); exists to measure the
    routing/physics stack off the Manhattan-grid structure the delta-bucket
    sweeps exploit.
    """
    import math

    name = name or f"Radial{rings}x{spokes}"
    nodes = [("c", 0.0, 0.0)]
    for k in range(1, rings + 1):
        r = k * ring_spacing
        for s in range(spokes):
            a = 2.0 * math.pi * s / spokes
            nodes.append((f"r{k}_{s}", r * math.cos(a), r * math.sin(a)))

    links = []

    def add(u, v, length, cap):
        links.append(
            dict(id=f"l{len(links)}", from_=u, to=v, length=round(length, 1),
                 capacity=cap, freespeed=freespeed, permlanes=1)
        )
        links.append(
            dict(id=f"l{len(links)}", from_=v, to=u, length=round(length, 1),
                 capacity=cap, freespeed=freespeed, permlanes=1)
        )

    for k in range(1, rings + 1):
        ring_len = 2.0 * math.pi * k * ring_spacing / spokes
        for s in range(spokes):
            add(f"r{k}_{s}", f"r{k}_{(s + 1) % spokes}", ring_len, capacity)
    spurs = min(spokes, 8) if center_spurs is None else center_spurs
    for s in range(spokes):
        if spurs and s % max(spokes // spurs, 1) == 0:
            add("c", f"r1_{s}", ring_spacing, radial_capacity)
        for k in range(1, rings):
            add(f"r{k}_{s}", f"r{k + 1}_{s}", ring_spacing, radial_capacity)

    rng = np.random.default_rng(seed)
    all_ids = [n[0] for n in nodes]
    cbd_ids = ["c"] + [f"r1_{s}" for s in range(spokes)]
    trips = []
    for i in range(num_agents):
        o = all_ids[int(rng.integers(1, len(all_ids)))]  # homes off-centre
        if rng.random() < cbd_fraction:
            d = cbd_ids[int(rng.integers(0, len(cbd_ids)))]
        else:
            d = all_ids[int(rng.integers(0, len(all_ids)))]
        while d == o:
            d = all_ids[int(rng.integers(0, len(all_ids)))]
        dep = peak_start + int(rng.integers(0, peak_spread))
        hh, mm, ss = dep // 3600, (dep % 3600) // 60, dep % 60
        trips.append(
            dict(person=f"p{i}", origin=o, dest=d,
                 end_time=f"{hh:02d}:{mm:02d}:{ss:02d}",
                 age=int(rng.integers(18, 80)),
                 sex="f" if rng.random() < 0.5 else "m")
        )
    base = os.path.join(root, name)
    _write_xml(os.path.join(base, "network.xml"), network_xml(nodes, links))
    _write_xml(os.path.join(base, "population.xml"), population_xml(trips))
    return base


BUILTIN_GENERATORS = {
    "TwoLink": two_link_scenario,
    "Braess": braess_network,
    "Bottleneck": bottleneck_scenario,
    "Easy": lambda root, name="Easy": grid_scenario(
        root, name, rows=3, cols=3, num_agents=200
    ),
    "Grid4x4": grid_scenario,
    "Grid8x8": lambda root, name="Grid8x8": grid_scenario(
        root, name, rows=8, cols=8, num_agents=5000
    ),
    "Radial": radial_scenario,
}


def ensure_scenario(data_root: str, scenario: str) -> str:
    """Return ``data_root/scenario`` generating it from a builtin if absent
    (the reference's prefix-based directory convention, ts.py:256-265)."""
    base = os.path.join(data_root, scenario)
    if os.path.exists(os.path.join(base, "network.xml")) or os.path.exists(
        os.path.join(base, "network.xml.gz")
    ):
        return base
    if scenario in BUILTIN_GENERATORS:
        return BUILTIN_GENERATORS[scenario](data_root, scenario)
    raise FileNotFoundError(
        f"Scenario '{scenario}' not found under {data_root} and no builtin generator exists."
    )


def pad_network_xml(network_base: str, multiple: int) -> str:
    """Pad a network to ``num_roads % multiple == 0`` with inert roads, for
    the road-block episodes, which need ``R`` to divide into blocks.

    Appends ``(-R) % multiple`` self-loop links, each on its own new
    intersection ``~pad<k>``.  ``~`` sorts after every real id, so the real
    intersections keep their ordinals, and a pad road's only turn edge is
    its own loop: it never takes or gives a transfer, and the padded
    simulation is the unpadded one on the real roads (the direction noise
    is ``[KIN, R_pad]``, so the random policy's stream differs).

    Writes ``<network_base>_pad<multiple>.xml`` beside the source (reusing
    it where it exists) and returns its base path, without the extension;
    ``network_base`` itself where no pad is needed.  Load the network and
    the population against the returned path, so that the SRC/DEST
    numbering (``R + 2k``) agrees."""
    import xml.etree.ElementTree as ET

    from .matsim import resolve_xml_path

    src = resolve_xml_path(network_base)
    out_base = f"{network_base}_pad{multiple}"
    out_path = out_base + ".xml"
    if os.path.exists(out_path):
        return out_base
    if src.endswith(".gz"):
        with gzip.open(src, "rb") as f:
            tree = ET.parse(f)
    else:
        tree = ET.parse(src)
    root = tree.getroot()
    links_el = root.find("links")
    nodes_el = root.find("nodes")
    if links_el is None:
        raise ValueError("The XML file does not contain a 'links' element.")
    links = [e for e in links_el if e.tag == "link"]
    num_pad = (-len(links)) % multiple
    if num_pad == 0:
        return network_base
    for k in range(num_pad):
        nid = f"~pad{k}"
        if nodes_el is not None:
            ET.SubElement(nodes_el, "node", id=nid, x="0", y="0")
        ET.SubElement(
            links_el, "link",
            id=f"~padlink{k}", attrib={"from": nid, "to": nid},
            length="7.5", capacity="1", freespeed="7.5", permlanes="1",
        )
    tree.write(out_path)
    return out_base
