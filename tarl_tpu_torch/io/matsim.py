"""MATSim XML scenario ingestion (ports ``tarl_tpu/io/matsim.py``).

Two parsers with the reference's conventions: effective cell size default
7.5, sorted-intersection SRC/DEST indexing (SRC of intersection k is ``R +
2k``, DEST ``R + 2k + 1``), the person filters (``car_avail ==
"always"``, at least two activities), one trip row per consecutive
activity pair, the nearest-intersection fallback for coordinate plans,
and the dummy agent row 0 whose departure lies past any horizon.

The native C++ parser (:mod:`~tarl_tpu_torch.io.native`) reads the
network, and the population where its plans name links; a population with
coordinate plans goes, whole, to the pure-Python parser, which alone has
the nearest-intersection search, as in the reference.  Every parse entry
takes ``parser``: ``None`` (the default) is native, warning once and
taking the Python parser where the native one cannot be built or fails
on a file; ``"native"`` raises there instead; ``"python"`` is the Python
parser.  Each parse records which parser read the file and its seconds
(``ParsedNetwork.parser``/``seconds``, ``PopulationStats.parser``/
``fallback``/``seconds``).  The reference's ``TARL_NATIVE`` environment
switch is this keyword.
"""
from __future__ import annotations

import dataclasses
import gzip
import os
import time
import warnings
from datetime import datetime
from typing import Optional
from xml.etree import ElementTree

import numpy as np
import torch

from ..config import DEFAULT_PHYSICS, PhysicsConfig
from ..network import Network, build_network
from ..state import AgentState
from . import native

PARSERS = ("native", "python")
_warned: set = set()


def resolve_xml_path(file_path: str) -> str:
    """Pick ``<path>.xml.gz`` over ``<path>.xml``."""
    gz_path = file_path + ".xml.gz"
    xml_path = file_path + ".xml"
    if os.path.exists(gz_path):
        return gz_path
    if os.path.exists(xml_path):
        return xml_path
    raise FileNotFoundError(f"Neither {gz_path} nor {xml_path} exists.")


def _check_parser(parser: Optional[str]) -> None:
    if parser is not None and parser not in PARSERS:
        raise ValueError(f"parser {parser!r}: expected one of {PARSERS} "
                         "or None")


def _native_failed(parser: Optional[str], err: Exception) -> None:
    """An explicit ``parser="native"`` raises ``err``; the default warns
    (once per message) and returns, for the Python parser to run."""
    if parser == "native":
        raise err
    msg = f"{err}; taking the Python parser"
    if msg not in _warned:
        _warned.add(msg)
        warnings.warn(msg, RuntimeWarning, stacklevel=3)


def _parse_root(path: str):
    if path.endswith(".gz"):
        with gzip.open(path, "rb") as f:
            return ElementTree.parse(f).getroot()
    return ElementTree.parse(path).getroot()


@dataclasses.dataclass
class ParsedNetwork:
    """Raw link table + intersection indexing shared by network and
    population ingestion."""

    link_ids: list[str]
    length: np.ndarray
    max_flow: np.ndarray
    free_speed: np.ndarray
    perm_lanes: np.ndarray
    from_inter: np.ndarray
    to_inter: np.ndarray
    sorted_intersections: list[str]
    node_positions: dict[str, tuple[float, float]]
    effective_cell_size: float
    source_path: Optional[str] = None  # the resolved file
    parser: str = "python"             # "native" or "python"
    seconds: float = 0.0               # the parse's wall time

    @property
    def num_roads(self) -> int:
        return len(self.link_ids)

    @property
    def num_intersections(self) -> int:
        return len(self.sorted_intersections)


def parse_network_xml(file_path: str,
                      parser: Optional[str] = None) -> ParsedNetwork:
    """Parse a MATSim network file (``file_path`` without extension) with
    ``parser`` (module docstring).  The native parser numbers the links
    ``"0"...``, as the reference's does, and places only the intersections
    the links name (at (0, 0) where no ``<node>`` gives them)."""
    _check_parser(parser)
    actual = resolve_xml_path(file_path)
    t0 = time.perf_counter()
    if parser != "python":
        try:
            p = native.parse_network_native(actual)
        except native.NativeError as e:
            _native_failed(parser, e)
        else:
            return ParsedNetwork(
                link_ids=[str(i) for i in range(len(p["length"]))],
                length=p["length"], max_flow=p["max_flow"],
                free_speed=p["free_speed"], perm_lanes=p["perm_lanes"],
                from_inter=p["from_inter"], to_inter=p["to_inter"],
                sorted_intersections=p["sorted_intersections"],
                node_positions=p["node_positions"],
                effective_cell_size=p["effective_cell_size"],
                source_path=actual, parser="native",
                seconds=time.perf_counter() - t0)
    root = _parse_root(actual)
    links = root.find("links")
    if links is None:
        raise ValueError("The XML file does not contain a 'links' element.")
    try:
        cell_size = float(links.get("effectivecellsize"))
    except (TypeError, ValueError):
        cell_size = 7.5

    nodes = root.find("nodes")
    node_positions = {}
    if nodes is not None:
        for node in nodes:
            if node.tag != "node":
                continue
            node_positions[node.get("id")] = (
                float(node.get("x", 0.0)),
                float(node.get("y", 0.0)),
            )

    link_ids, length, max_flow, free_speed, perm_lanes = [], [], [], [], []
    from_ids, to_ids = [], []
    intersections: set[str] = set()
    for link in links:
        if link.tag != "link":
            continue
        a = link.attrib
        link_ids.append(a.get("id", str(len(link_ids))))
        length.append(float(a["length"]))
        max_flow.append(float(a["capacity"]))
        free_speed.append(float(a["freespeed"]))
        perm_lanes.append(float(a.get("permlanes", 1.0)))
        from_ids.append(a["from"])
        to_ids.append(a["to"])
        intersections.update((a["from"], a["to"]))

    sorted_inters = sorted(intersections)
    inter_ord = {name: k for k, name in enumerate(sorted_inters)}
    return ParsedNetwork(
        link_ids=link_ids,
        length=np.asarray(length),
        max_flow=np.asarray(max_flow),
        free_speed=np.asarray(free_speed),
        perm_lanes=np.asarray(perm_lanes),
        from_inter=np.asarray([inter_ord[i] for i in from_ids], dtype=np.int64),
        to_inter=np.asarray([inter_ord[i] for i in to_ids], dtype=np.int64),
        sorted_intersections=sorted_inters,
        node_positions=node_positions,
        effective_cell_size=cell_size,
        source_path=actual,
        seconds=time.perf_counter() - t0,
    )


def load_network(
    file_path: str,
    physics: PhysicsConfig = DEFAULT_PHYSICS,
    device: torch.device | str | None = None,
    parser: Optional[str] = None,
) -> Network:
    """MATSim network file -> :class:`Network` on ``device``, read by
    ``parser`` (module docstring)."""
    parsed = parse_network_xml(file_path, parser)
    physics = dataclasses.replace(
        physics, effective_cell_size=parsed.effective_cell_size
    )
    pos = parsed.node_positions
    coords = np.asarray(
        [pos.get(name, (0.0, 0.0)) for name in parsed.sorted_intersections],
        dtype=np.float64,
    ).reshape(-1, 2)
    return build_network(
        length=parsed.length,
        max_flow=parsed.max_flow,
        free_speed=parsed.free_speed,
        perm_lanes=parsed.perm_lanes,
        from_inter=parsed.from_inter,
        to_inter=parsed.to_inter,
        num_intersections=parsed.num_intersections,
        physics=physics,
        inter_x=coords[:, 0],
        inter_y=coords[:, 1],
        device=device,
    )


# ---------------------------------------------------------------------------
# Population
# ---------------------------------------------------------------------------

def _extract_activities(plan_elem):
    acts = plan_elem.findall("act")
    if not acts:
        acts = plan_elem.findall("activity")
    return acts


def _extract_departure_time(act_elem) -> int:
    """``end_time`` -> seconds since midnight."""
    time_str = act_elem.get("end_time")
    if not time_str:
        return 0
    for fmt in ("%H:%M:%S", "%H:%M"):
        try:
            t = datetime.strptime(time_str, fmt)
            return t.hour * 3600 + t.minute * 60 + t.second
        except ValueError:
            continue
    return 0


def _parse_person_attributes(person_elem) -> dict:
    attrs = dict(person_elem.attrib)
    attributes_elem = person_elem.find("attributes")
    if attributes_elem is not None:
        for attr in attributes_elem.findall("attribute"):
            name = attr.get("name")
            value = attr.text
            if name and value:
                attrs[name] = value
    attrs.setdefault("car_avail", attrs.get("carAvail", "always"))
    attrs.setdefault("sex", "m")
    attrs.setdefault("employed", "no")
    attrs.setdefault("age", "20")
    return attrs


@dataclasses.dataclass
class PopulationStats:
    """Ingestion statistics."""

    total_agents: int = 0
    selected_agents: int = 0
    total_trips: int = 0
    exclusions: dict = dataclasses.field(default_factory=dict)
    invalid_trip_coords: int = 0
    trips_per_agent: list = dataclasses.field(default_factory=list)
    parser: str = "python"            # "native" or "python"
    # Why the native parser handed the population to the Python one
    # ("coordinate plans"), where it did.
    fallback: Optional[str] = None
    seconds: float = 0.0              # the population file's parse


# Dummy agent row 0: departure at 48 h, so it never departs.
DUMMY_DEPARTURE = 48 * 3600.0


def parse_population_xml(
    population_path: str, parsed_network: ParsedNetwork,
    parser: Optional[str] = None,
) -> tuple[np.ndarray, PopulationStats]:
    """Parse a MATSim population into ``[A, 9]`` float32 trip rows in
    :class:`~tarl_tpu_torch.schema.AgentFeatureHelpers` column order, with
    ``parser`` (module docstring).  The native parser reads the network
    again from ``parsed_network.source_path``; where plans name
    coordinates, the Python parser reads the whole population."""
    _check_parser(parser)
    actual = resolve_xml_path(population_path)
    t0 = time.perf_counter()
    fallback = None
    if parser != "python":
        try:
            if parsed_network.source_path is None:
                raise native.NativeError(
                    "the native parser reads the network from its file: "
                    "the parsed network has none")
            result = native.parse_population_native(
                actual, parsed_network.source_path)
        except native.NativeError as e:
            _native_failed(parser, e)
        else:
            if result is not None:
                rows, d = result
                return rows, PopulationStats(
                    total_agents=d["total_agents"],
                    selected_agents=d["selected_agents"],
                    total_trips=rows.shape[0] - 1,
                    exclusions={k: d[k] for k in (
                        "car_avail_not_always", "no_plan",
                        "too_few_activities", "no_valid_trip")},
                    invalid_trip_coords=d["invalid_trip_coords"],
                    parser="native", seconds=time.perf_counter() - t0)
            fallback = "coordinate plans"
    rows, stats = _parse_population_python(actual, parsed_network)
    stats.fallback = fallback
    stats.seconds = time.perf_counter() - t0
    return rows, stats


def _parse_population_python(actual: str, parsed_network: ParsedNetwork
                             ) -> tuple[np.ndarray, PopulationStats]:
    population = _parse_root(actual)

    inter_index = {
        name: (parsed_network.num_roads + 2 * k,
               parsed_network.num_roads + 2 * k + 1)
        for k, name in enumerate(parsed_network.sorted_intersections)
    }

    kdtree = None
    if parsed_network.node_positions:
        kd_ids = [i for i in parsed_network.sorted_intersections
                  if i in parsed_network.node_positions]
        coords = np.array([parsed_network.node_positions[i] for i in kd_ids])
        if coords.size:
            from scipy.spatial import cKDTree

            kdtree = cKDTree(coords)

    def nearest_intersection(x: float, y: float) -> str:
        return kd_ids[int(kdtree.query([x, y])[1])]

    rows = [[0.0, 0.0, DUMMY_DEPARTURE, 0.0, 20.0, 0.0, 0.0, 0.0, 0.0]]
    stats = PopulationStats(exclusions={
        "car_avail_not_always": 0,
        "no_plan": 0,
        "too_few_activities": 0,
        "no_valid_trip": 0,
    })

    for person in population:
        if person.tag != "person":
            continue
        stats.total_agents += 1
        attrs = _parse_person_attributes(person)
        car_avail = attrs.get("car_avail", attrs.get("carAvail", "")).lower()
        if car_avail != "always":
            stats.exclusions["car_avail_not_always"] += 1
            continue
        plan = person.find("plan")
        if plan is None:
            stats.exclusions["no_plan"] += 1
            continue
        acts = _extract_activities(plan)
        if len(acts) < 2:
            stats.exclusions["too_few_activities"] += 1
            continue
        sex = 1.0 if attrs.get("sex", "m").lower() == "f" else 0.0
        employed = 1.0 if attrs.get("employed", "no").lower() == "yes" else 0.0
        age = float(attrs.get("age", 0))
        valid_trips = 0
        for i in range(len(acts) - 1):
            origin_node = acts[i].get("link")
            dest_node = acts[i + 1].get("link")
            if origin_node not in inter_index and kdtree is not None:
                ox, oy = acts[i].get("x"), acts[i].get("y")
                if ox is not None and oy is not None:
                    try:
                        origin_node = nearest_intersection(float(ox), float(oy))
                    except Exception:
                        pass
            if dest_node not in inter_index and kdtree is not None:
                dx, dy = acts[i + 1].get("x"), acts[i + 1].get("y")
                if dx is not None and dy is not None:
                    try:
                        dest_node = nearest_intersection(float(dx), float(dy))
                    except Exception:
                        pass
            if origin_node in inter_index and dest_node in inter_index:
                src_idx = inter_index[origin_node][0]
                dest_idx = inter_index[dest_node][1]
            else:
                stats.invalid_trip_coords += 1
                continue
            dep = _extract_departure_time(acts[i])
            rows.append([float(src_idx), float(dest_idx), float(dep), 0.0,
                         age, sex, employed, 0.0, 0.0])
            valid_trips += 1
        if valid_trips > 0:
            stats.selected_agents += 1
            stats.trips_per_agent.append(valid_trips)
        else:
            stats.exclusions["no_valid_trip"] += 1

    stats.total_trips = len(rows) - 1
    return np.asarray(rows, dtype=np.float32), stats


def load_population(
    population_path: str,
    network_path: str,
    device: torch.device | str | None = None,
    parser: Optional[str] = None,
) -> tuple[AgentState, PopulationStats]:
    """MATSim population + network files -> :class:`AgentState`, both read
    by ``parser`` (module docstring)."""
    from ..schema import agents_from_matrix

    parsed = parse_network_xml(network_path, parser)
    rows, stats = parse_population_xml(population_path, parsed, parser)
    return agents_from_matrix(rows, device=device), stats
