"""The port's native MATSim parser (``io/native.py``, built from
``tarl_tpu_torch/native/matsim_parser.cpp``) and ``io/matsim``'s dispatch,
on the CPU.

* Grid4x4, Braess, Bottleneck and a radial metro (4 rings of 16 spokes):
  the native parse bitwise the port's Python parse and the reference's
  Python parse (``TARL_NATIVE=0``) and, where it builds, the reference's
  own native one: the ``[A, 9]`` rows, the link arrays, the intersection
  ids and positions, the cell size and the statistics.
* A small ``io.city`` scenario (``.xml.gz``, some plans by coordinates
  only): its population goes, whole, to the Python parser in both
  packages, with equal rows; its network is read natively from the
  ``.gz``.
* ``.xml.gz`` input equal to the same file unzipped.
* Coordinate plans: a population whose plan names no link goes to the
  Python parser; one that names links and coordinates stays native.
* A library that cannot be built (a compiler path that does not exist):
  ``parser="native"`` raises with the compiler's error, the default warns
  once and takes the Python parser.
* The library is built under ``build/tarl_tpu_torch/`` from the port's own
  source, never ``native/build``; an unknown ``parser`` is refused.
"""
import gzip
import os
import shutil

import numpy as np
import pytest

from tarl_tpu.io import matsim as ref_matsim
from tarl_tpu.io import native as ref_native
from tarl_tpu.io.city import city_scenario
from tarl_tpu.io.scenarios import ensure_scenario

from tarl_tpu_torch import _build
from tarl_tpu_torch.io import matsim as p_matsim
from tarl_tpu_torch.io import native as p_native
from tarl_tpu_torch.io.scenarios import radial_scenario

LINK_FIELDS = ("length", "max_flow", "free_speed", "perm_lanes",
               "from_inter", "to_inter")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("torch_native_scen"))


def _base(root: str, name: str) -> str:
    if name == "Radial":
        base = os.path.join(root, "Radial")
        if not os.path.exists(os.path.join(base, "network.xml")):
            radial_scenario(root, "Radial", rings=4, spokes=16,
                            num_agents=400, cbd_fraction=1.0,
                            peak_start=21600, peak_spread=600)
        return base
    return ensure_scenario(root, name)


def _assert_parsed_equal(a, b, what: str, positions: bool = True):
    for f in LINK_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f"{what} {f}"
    assert a.sorted_intersections == b.sorted_intersections, what
    assert a.effective_cell_size == b.effective_cell_size, what
    if positions:
        for i in a.sorted_intersections:
            assert a.node_positions.get(i, (0.0, 0.0)) == \
                b.node_positions.get(i, (0.0, 0.0)), f"{what} {i}"


def _stats(s) -> tuple:
    return (s.total_agents, s.selected_agents, s.total_trips, s.exclusions,
            s.invalid_trip_coords)


def _ref_python(monkeypatch, net_path, pop_path):
    monkeypatch.setenv("TARL_NATIVE", "0")
    net = ref_matsim.parse_network_xml(net_path)
    rows, stats = ref_matsim.parse_population_xml(pop_path, net)
    monkeypatch.delenv("TARL_NATIVE")
    return net, rows, stats


@pytest.mark.parametrize("name", ["Grid4x4", "Braess", "Bottleneck",
                                  "Radial"])
def test_native_equals_both_python_parsers(root, name, monkeypatch):
    base = _base(root, name)
    net_path = os.path.join(base, "network")
    pop_path = os.path.join(base, "population")
    nat = p_matsim.parse_network_xml(net_path, "native")
    rows, stats = p_matsim.parse_population_xml(pop_path, nat, "native")
    assert (nat.parser, stats.parser, stats.fallback) == (
        "native", "native", None)
    assert nat.seconds > 0 and stats.seconds > 0
    assert nat.source_path == net_path + ".xml"
    py = p_matsim.parse_network_xml(net_path, "python")
    py_rows, py_stats = p_matsim.parse_population_xml(pop_path, py, "python")
    assert (py.parser, py_stats.parser) == ("python", "python")
    ref, ref_rows, ref_stats = _ref_python(monkeypatch, net_path, pop_path)
    for other, other_rows, other_stats, what in (
            (py, py_rows, py_stats, "port python"),
            (ref, ref_rows, ref_stats, "reference python")):
        _assert_parsed_equal(nat, other, f"{name} {what}")
        assert rows.dtype == other_rows.dtype == np.float32
        np.testing.assert_array_equal(rows, other_rows, f"{name} {what}")
        assert _stats(stats) == _stats(other_stats), what
    if ref_native.available():
        got = ref_native.parse_network_native(net_path + ".xml")
        for f in LINK_FIELDS:
            np.testing.assert_array_equal(getattr(nat, f), got[f])
        assert got["node_positions"] == nat.node_positions
        ref_rows_native, _ = ref_native.parse_population_native(
            pop_path + ".xml", net_path + ".xml")
        np.testing.assert_array_equal(rows, ref_rows_native)
    # The default is native; the loaders give equal tables either way.
    agents, st = p_matsim.load_population(pop_path, net_path, device="cpu")
    py_agents, _ = p_matsim.load_population(pop_path, net_path,
                                            device="cpu", parser="python")
    assert st.parser == "native"
    for f in agents._fields:
        assert np.array_equal(getattr(agents, f).numpy(),
                              getattr(py_agents, f).numpy()), f


def test_city_coordinate_plans_take_the_python_parser(root, monkeypatch):
    base = city_scenario(os.path.join(root, "city"), "MiniCity",
                         num_intersections=400, num_agents=1200,
                         num_dest_zones=16, seed=7)
    net_path = os.path.join(base, "network")
    pop_path = os.path.join(base, "population")
    assert os.path.exists(pop_path + ".xml.gz")
    nat = p_matsim.parse_network_xml(net_path)
    assert nat.parser == "native"
    rows, stats = p_matsim.parse_population_xml(pop_path, nat)
    assert (stats.parser, stats.fallback) == ("python", "coordinate plans")
    assert p_native.parse_population_native(pop_path + ".xml.gz",
                                            net_path + ".xml.gz") is None
    ref_net = ref_matsim.parse_network_xml(net_path)
    ref_rows, ref_stats = ref_matsim.parse_population_xml(pop_path, ref_net)
    np.testing.assert_array_equal(rows, ref_rows)
    assert _stats(stats) == _stats(ref_stats)
    _, py_rows, _ = _ref_python(monkeypatch, net_path, pop_path)
    np.testing.assert_array_equal(rows, py_rows)
    py = p_matsim.parse_network_xml(net_path, "python")
    _assert_parsed_equal(nat, py, "city")


def test_gzip_input_equals_plain(root, tmp_path):
    base = _base(root, "Grid4x4")
    gz = tmp_path / "Grid4x4gz"
    gz.mkdir()
    for name in ("network", "population"):
        with open(os.path.join(base, f"{name}.xml"), "rb") as f, \
                gzip.open(gz / f"{name}.xml.gz", "wb") as g:
            shutil.copyfileobj(f, g)
    assert p_native.gzip_supported()
    plain = p_matsim.parse_network_xml(os.path.join(base, "network"),
                                       "native")
    zipped = p_matsim.parse_network_xml(str(gz / "network"), "native")
    assert zipped.source_path.endswith(".xml.gz")
    _assert_parsed_equal(plain, zipped, "gz")
    rows, _ = p_matsim.parse_population_xml(
        os.path.join(base, "population"), plain, "native")
    zrows, zstats = p_matsim.parse_population_xml(str(gz / "population"),
                                                  zipped, "native")
    assert zstats.parser == "native"
    np.testing.assert_array_equal(rows, zrows)


POP = """<?xml version="1.0" encoding="utf-8"?>
<population>
 <person id="1"><plan selected="yes">
  <act type="home" {a} end_time="06:00:00"/>
  <leg mode="car"/>
  <act type="work" {b}/>
 </plan></person>
 <person id="2"><plan selected="yes">
  <act type="home" link="{o}" end_time="07:30:00"/>
  <leg mode="car"/>
  <act type="work" link="{d}"/>
 </plan></person>
</population>
"""


def test_coordinate_plans_take_the_python_parser(root, tmp_path):
    base = _base(root, "Braess")
    net_path = os.path.join(base, "network")
    parsed = p_matsim.parse_network_xml(net_path, "native")
    o, d = parsed.sorted_intersections[0], parsed.sorted_intersections[-1]
    (ox, oy), (dx, dy) = parsed.node_positions[o], parsed.node_positions[d]
    cases = {
        "coordinates": (f'x="{ox + 3.0}" y="{oy - 2.0}"',
                        f'x="{dx - 1.0}" y="{dy + 4.0}"', "python"),
        "links and coordinates": (f'link="{o}" x="{ox}" y="{oy}"',
                                  f'link="{d}" x="{dx}" y="{dy}"',
                                  "native"),
    }
    for name, (a, b, want) in cases.items():
        path = tmp_path / name.replace(" ", "_")
        (tmp_path / f"{path.name}.xml").write_text(
            POP.format(a=a, b=b, o=o, d=d))
        rows, stats = p_matsim.parse_population_xml(str(path), parsed)
        py_rows, _ = p_matsim.parse_population_xml(str(path), parsed,
                                                   "python")
        assert stats.parser == want, name
        np.testing.assert_array_equal(rows, py_rows, name)
        assert rows.shape == (3, 9), name
        assert rows[1, 0] == parsed.num_roads + 2 * 0, name


@pytest.fixture
def unbuildable(tmp_path, monkeypatch):
    """The parser's library as on a host whose compiler cannot be run."""
    monkeypatch.setattr(_build, "CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(p_native, "_lib", None)
    monkeypatch.setattr(p_native, "_build_error", None)
    monkeypatch.setattr(p_matsim, "_warned", set())


def test_native_raises_where_the_library_cannot_be_built(root, unbuildable):
    base = _base(root, "Braess")
    net_path = os.path.join(base, "network")
    assert not p_native.available()
    with pytest.raises(p_native.NativeError, match="no-such-g"):
        p_matsim.parse_network_xml(net_path, "native")
    with pytest.raises(p_native.NativeError, match="cannot be built"):
        p_matsim.load_population(os.path.join(base, "population"), net_path,
                                 device="cpu", parser="native")
    with pytest.warns(RuntimeWarning, match="taking the Python parser"):
        parsed = p_matsim.parse_network_xml(net_path)
    assert parsed.parser == "python"
    rows, stats = p_matsim.parse_population_xml(
        os.path.join(base, "population"), parsed)
    assert stats.parser == "python" and stats.fallback is None
    assert rows.shape[0] == stats.total_trips + 1


def test_library_is_the_ports_own_build(root):
    base = _base(root, "Braess")
    p_matsim.parse_network_xml(os.path.join(base, "network"), "native")
    lib = os.path.realpath(p_native.load_library()._name)
    assert os.path.dirname(lib) == os.path.realpath(_build.BUILD_DIR)
    assert os.path.basename(lib).startswith(f"lib{p_native.LIBRARY}_")
    assert p_native.SOURCE == (_build.PACKAGE_DIR / "native"
                               / "matsim_parser.cpp")
    assert "native/build" not in lib and "libtarl_native" not in lib
    with pytest.raises(ValueError, match="parser 'fast'"):
        p_matsim.parse_network_xml(os.path.join(base, "network"), "fast")
