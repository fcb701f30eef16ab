"""The vectorised generators keep the laws of the port's XML generators:
the grid's and the city's networks and the city's population are the
parse of ``grid_scenario``'s and ``city_scenario``'s files, array for
array, and the grid's population keeps ``grid_scenario``'s law."""
import numpy as np
import pytest

from portbench.scenarios import city, grid

NET_KEYS = ("length", "max_flow", "free_speed", "perm_lanes", "from_inter",
            "to_inter")


def _positions(parsed):
    xy = np.asarray([parsed.node_positions[n]
                     for n in parsed.sorted_intersections])
    return xy[:, 0], xy[:, 1]


@pytest.mark.parametrize("rows,cols", [(3, 3), (7, 12), (11, 4)])
def test_grid_network_is_the_parse_of_its_xml(tmp_path, rows, cols):
    from tarl_tpu_torch.io.matsim import parse_network_xml
    from tarl_tpu_torch.io.scenarios import grid_scenario

    base = grid_scenario(str(tmp_path), "G", rows=rows, cols=cols,
                         num_agents=5)
    parsed = parse_network_xml(base + "/network")
    net = grid.network(dict(rows=rows, cols=cols, block_length=200.0,
                            capacity=600.0, freespeed=13.9))
    for k in NET_KEYS:
        assert np.array_equal(np.asarray(getattr(parsed, k), np.float64),
                              net[k].astype(np.float64)), k
    x, y = _positions(parsed)
    assert np.array_equal(x, net["inter_x"]) and np.array_equal(y,
                                                                net["inter_y"])
    assert net["num_intersections"] == parsed.num_intersections


def test_grid_population_keeps_the_law():
    cfg = dict(rows=12, cols=12, block_length=200.0, capacity=600.0,
               freespeed=13.9, num_agents=200_000, zones=7,
               peak_start=21600, peak_spread=10800)
    net = grid.network(cfg)
    pop = grid.population(cfg, net, 2 ** 33 + 5)
    r, n = net["length"].shape[0], net["num_intersections"]
    o = (pop["origin"][1:] - r) // 2
    d = (pop["dest"][1:] - r - 1) // 2
    assert (pop["origin"][1:] - r) .min() >= 0 and np.all(
        (pop["origin"][1:] - r) % 2 == 0) and np.all(
        (pop["dest"][1:] - r) % 2 == 1)
    assert np.all(o != d)
    assert len(np.unique(d)) == 7
    dep = pop["departure"][1:]
    assert dep.min() >= 21600 and dep.max() < 21600 + 10800
    assert np.all(dep == np.floor(dep))
    # Destinations uniform over the zones, origins over the others.
    counts = np.bincount(d, minlength=n)[np.unique(d)]
    assert counts.min() > 0.95 * counts.mean()
    # An origin is uniform over the intersections but its destination: a
    # zone is an origin only when another zone is the destination.
    oc = np.bincount(o, minlength=n)
    expect = np.full(n, 200_000 / (n - 1))
    expect[np.unique(d)] *= 1 - 1 / 7
    assert np.abs(oc / expect - 1).max() < 0.12
    assert abs(pop["sex"][1:].mean() - 0.5) < 0.01
    assert pop["age"][1:].min() == 18 and pop["age"][1:].max() == 79
    assert (pop["origin"][0], pop["dest"][0], pop["departure"][0],
            pop["age"][0]) == (0, 0, 48 * 3600.0, 20.0)
    again = grid.population(cfg, net, 2 ** 33 + 5)
    assert all(np.array_equal(pop[k], again[k]) for k in pop)


def test_city_is_the_parse_of_its_xml(tmp_path):
    from tarl_tpu_torch.io.city import city_scenario
    from tarl_tpu_torch.io.matsim import load_population, parse_network_xml

    cfg = dict(network_seed=7, num_intersections=400,
               extent=[3250.0, 2625.0], max_link_length=450.0,
               one_way_frac=0.15, num_bridges=9, false_easting=683000.0,
               false_northing=4930000.0, num_agents=3000, zones=16,
               peak_start=21600, peak_spread=7200, coord_plan_frac=0.02)
    base = city_scenario(str(tmp_path), "C", num_intersections=400,
                         num_agents=3000, num_dest_zones=16,
                         extent=tuple(cfg["extent"]), seed=7)
    parsed = parse_network_xml(base + "/network")
    # One stream for the network and then the population, as the
    # generator draws them.
    rng = np.random.default_rng(7)
    net = city._parsed(city._graph(rng, cfg), cfg)
    for k in NET_KEYS:
        assert np.array_equal(np.asarray(getattr(parsed, k), np.float64),
                              net[k].astype(np.float64)), k
    x, y = _positions(parsed)
    assert np.array_equal(x, net["inter_x"]) and np.array_equal(y,
                                                                net["inter_y"])
    pop = city.draw_population(rng, cfg, net)
    agents, _ = load_population(base + "/population", base + "/network",
                                device="cpu")
    for k in ("origin", "dest", "departure", "age", "sex", "employed"):
        assert np.array_equal(getattr(agents, k).numpy().astype(np.float64),
                              pop[k].astype(np.float64)), k
    # The benchmark's network keeps its seed; the population follows the
    # run's.
    assert np.array_equal(city.network(cfg)["from_inter"], net["from_inter"])
    other = city.population(cfg, net, 8)
    assert not np.array_equal(other["origin"], pop["origin"])
