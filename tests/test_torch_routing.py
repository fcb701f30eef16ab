"""The port's routing layer against the JAX reference, bitwise.

* The primal routing tables of ``Network`` on every builtin scenario.
* ``road_costs``, ``marginal_road_costs`` and their dual-node forms on
  random occupancies.
* ``primal_all_pairs_dist`` (uncapped, and capped from a warm start),
  ``primal_dest_dist`` and ``primal_next_roads`` with random costs and with
  the tie-heavy free-flow costs of a grid (every road 14.39 s).
* The port's relax (its plain version here: CPU tensors) against the
  reference's Pallas kernels themselves, run in interpret mode: K2
  (relax + next road), K4 (relax), K6 (one dynamic-shift sweep) on Grid8x8
  and Grid12x12, and the row-blocked K3/K5 on a synthetic ring given to the
  port as out-road tables.
* ``primal_table_init`` on Grid8x8 (device relax) and Grid32x32 (scipy's
  Dijkstra on the host, I^2 > 10^6).
* The resident kernel's plan (tile width, column tail, the global form
  past the shared-memory limit), and a model of its per-tile early exit:
  the columns split into tiles, each tile's sweeps stopped at its first
  sweep that lowers nothing, equal to the reference's Pallas K2 and K4
  bitwise at 1, 3 and 8 sweeps and uncapped (the idempotence argument on
  real inputs).  The resident kernel and the global form against the
  plain version on a card: ``tests/test_torch_card_k2_k11.py``.
* The cluster kernel's plan past 4,096 rows (blocks a cluster, the
  global form past 65,536 rows and at one sweep, the tile narrowed to the
  card's capacity); the model of the per-tile early exit above is its
  function too (a tile holds every row in either form).  The cluster
  kernel against the plain version on a card:
  ``tests/test_torch_card_k3_k5.py``.

Inputs come from the scenario files and numpy seeds; each side gets the
same arrays.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from tarl_tpu.io.scenarios import grid_scenario
from tarl_tpu.routing import bellman_ford as bf
from tarl_tpu.routing.policies import primal_table_init
from tarl_tpu.state import init_road_state

from tarl_tpu_torch import convert
from tarl_tpu_torch.routing import bellman_ford as pbf
from tarl_tpu_torch.routing import policies as ppol
from tarl_tpu_torch.state import init_road_state as p_init_road_state

from test_torch_network import SCENARIOS, assert_tree_equal, load_both

torch.set_num_threads(1)

ROUTING_FIELDS = ("road_to", "inter_out_road", "inter_out_ok")


@pytest.fixture(scope="module")
def scen_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_routing_scen"))
    for n in (12, 32):
        grid_scenario(root, f"Grid{n}x{n}", rows=n, cols=n, num_agents=20)
    return root


@pytest.fixture(scope="module")
def grids(scen_root):
    return {name: load_both(scen_root, name)
            for name in ("Grid8x8", "Grid12x12")}


def _tables(net):
    return net.inter_out_road, net.inter_out_ok, net.road_to


def _ptables(pnet):
    return pnet.inter_out_road, pnet.inter_out_ok, pnet.road_to


def _costs(net, kind, seed):
    """float32[R]: congested random costs (at least free flow) or the
    tie-heavy free-flow costs."""
    ff = np.array(net.free_flow)
    if kind == "ties":
        assert np.all(ff == ff[0])
        return ff
    rng = np.random.default_rng(seed)
    return (ff * rng.uniform(1.0, 4.0, ff.shape)).astype(np.float32)


def _cold(i_n):
    return np.where(np.eye(i_n, dtype=bool), 0.0, float(bf.BIG)).astype(
        np.float32)


def _warm(net, cost, seed):
    """An anchored warm start as the refresh builds it: a free-flow table
    scaled by the worst cost ratio, capped at BIG."""
    ff = np.asarray(net.free_flow)
    d_ff = np.asarray(bf.primal_all_pairs_dist(
        jnp.asarray(ff), *_tables(net)))
    ratio = np.float32(np.max(cost / np.maximum(ff, np.float32(1e-6))))
    d0 = np.minimum(d_ff * max(ratio, np.float32(1.0)),
                    np.float32(bf.BIG)).astype(np.float32)
    np.fill_diagonal(d0, 0.0)
    return d0


def _eq(ref, got, what):
    assert_tree_equal(np.asarray(ref), got.numpy(), what)


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_network_routing_tables(scen_root, scenario):
    net, _, pnet, _ = load_both(scen_root, scenario)
    ref, port = convert.to_numpy(net), convert.to_numpy(pnet)
    for name in ROUTING_FIELDS:
        assert_tree_equal(ref[name], port[name], name)
    assert port["inter_out_ok"].sum() == pnet.num_roads


@pytest.mark.parametrize("fn", ["road_costs", "marginal_road_costs",
                                "node_entry_costs", "marginal_node_costs"])
def test_road_costs(grids, fn):
    net, _, pnet, _ = grids["Grid8x8"]
    rng = np.random.default_rng(3)
    cap = np.asarray(net.capacity).astype(np.int64)
    count = rng.integers(0, cap + 1).astype(np.int32)
    road = init_road_state(net.num_roads, net.nmax)._replace(
        count=jnp.asarray(count))
    proad = p_init_road_state(pnet.num_roads, pnet.nmax, "cpu")._replace(
        count=torch.as_tensor(count))
    ref = getattr(bf, fn)(road, net)
    got = getattr(pbf, fn)(proad, pnet)
    _eq(ref, got, fn)
    if fn.startswith("marginal"):
        plain = fn.replace("marginal_", "").replace("node", "node_entry")
        assert np.any(np.asarray(ref) > np.asarray(getattr(bf, plain)(road,
                                                                     net)))


@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("grid", ["Grid8x8", "Grid12x12"])
def test_primal_dist_and_next_roads(grids, grid, kind):
    net, _, pnet, _ = grids[grid]
    cost = _costs(net, kind, 5)
    jc, tc = jnp.asarray(cost), torch.as_tensor(cost)
    full = bf.primal_all_pairs_dist(jc, *_tables(net))
    pfull = pbf.primal_all_pairs_dist(tc, *_ptables(pnet))
    _eq(full, pfull, "all-pairs uncapped")
    assert float(pfull.max()) < bf.BIG

    d0 = _warm(net, cost, 5)
    for iters in (2, 8):
        ref = bf.primal_all_pairs_dist(jc, *_tables(net), max_iters=iters,
                                       dist0=jnp.asarray(d0))
        got = pbf.primal_all_pairs_dist(tc, *_ptables(pnet),
                                        max_iters=iters,
                                        dist0=torch.as_tensor(d0))
        _eq(ref, got, f"all-pairs warm, {iters} sweeps")

    dests = np.random.default_rng(1).choice(net.num_intersections, 7,
                                            replace=False).astype(np.int32)
    ref = bf.primal_dest_dist(jc, *_tables(net), jnp.asarray(dests))
    got = pbf.primal_dest_dist(tc, *_ptables(pnet), torch.as_tensor(dests))
    _eq(ref, got, "dest-restricted")
    _eq(np.asarray(full)[:, dests], got, "dest columns of all-pairs")

    ref = bf.primal_next_roads(full, jc, *_tables(net))
    got = pbf.primal_next_roads(pfull, tc, *_ptables(pnet))
    _eq(ref, got, "next roads")
    off_diag = ~np.eye(net.num_intersections, dtype=bool)
    assert np.all(got.numpy()[off_diag] >= 0)


# The launch function of each reference kernel, and the gate that opens it.
_LAUNCH = {"K2": ("_multisweep_nr_pallas", "_multisweep_nr_tile", 128),
           "K4": ("_multisweep_pallas", "_multisweep_tile", 128),
           "K6": ("_sweep_pallas", "_pallas_sweep_ok", True)}


def _interpret_relax(net, cost, d0, iters, monkeypatch, kernel):
    """The reference's relax through one of its Pallas kernels, in
    interpret mode, with the delta buckets of the grid; asserts that the
    kernel was launched."""
    out_r, ok, road_to = _tables(net)
    buckets = bf.primal_delta_buckets(out_r, ok, road_to,
                                      coords=(net.inter_x, net.inter_y))
    assert buckets is not None
    jc, jd = jnp.asarray(cost), jnp.asarray(d0)
    launch, gate, opened = _LAUNCH[kernel]
    calls = []
    real = getattr(bf, launch)

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    with monkeypatch.context() as m, pltpu.force_tpu_interpret_mode():
        m.setattr(bf, gate, lambda *a, **k: opened)
        m.setattr(bf, launch, spy)
        if kernel == "K2":
            epi = bf.epilogue_slot_tables(out_r, ok, road_to, buckets)
            out = bf.primal_relax_next_roads(jc, out_r, ok, road_to, jd,
                                             iters, buckets=buckets,
                                             epi_tables=epi)
        else:
            out = bf._primal_relax(jd, jc, out_r, ok, road_to, iters,
                                   buckets=buckets), None
    assert calls, f"{kernel} was not launched"
    return out


@pytest.mark.parametrize("iters", [1, 3, 8])
@pytest.mark.parametrize("grid", ["Grid8x8", "Grid12x12"])
def test_relax_against_pallas_k2(grids, grid, iters, monkeypatch):
    """K2 from the cold start (8 sweeps do not converge at Grid12x12: a
    Gauss-Seidel sweep would differ) with random costs."""
    net, _, pnet, _ = grids[grid]
    cost = _costs(net, "random", iters)
    d0 = _cold(net.num_intersections)
    ref_d, ref_r = _interpret_relax(net, cost, d0, iters, monkeypatch, "K2")
    got_d, got_r = pbf.primal_relax_next_roads(
        torch.as_tensor(cost), *_ptables(pnet), torch.as_tensor(d0), iters)
    _eq(ref_d, got_d, "K2 dist")
    _eq(ref_r, got_r, "K2 next road")
    # Capped below the diameter: some pairs still unreached.
    if grid == "Grid12x12" or iters < 8:
        assert float(got_d.max()) == bf.BIG
        assert float(got_r.min()) == -1.0


@pytest.mark.parametrize("kernel,iters", [("K4", 8), ("K4", 3), ("K6", 1),
                                          ("K6", 3)])
def test_relax_against_pallas_k4_k6(grids, kernel, iters, monkeypatch):
    """K4 (multisweep relax) and K6 (one dynamic-shift sweep per launch)
    from a warm start with tie-heavy costs, and from the cold start."""
    net, _, pnet, _ = grids["Grid8x8"]
    for cost, d0 in ((_costs(net, "ties", 0), None),
                     (_costs(net, "random", 9), _cold(net.num_intersections))):
        d0 = _warm(net, cost, 0) if d0 is None else d0
        ref, _ = _interpret_relax(net, cost, d0, iters, monkeypatch, kernel)
        got, none = pbf.primal_relax_next_roads(
            torch.as_tensor(cost), *_ptables(pnet), torch.as_tensor(d0),
            iters, relax_only=True)
        assert none is None
        _eq(ref, got, f"{kernel} dist")


def test_relax_against_pallas_row_blocked():
    """K3/K5 (row windows with halo) and K2/K4 (full-resident) on the ring
    of ``tests/test_roll_gather.py``: intersection i has four out-roads,
    road 4i+b leading to (i + delta_b) mod 64 with weight w[i, b]."""
    i_n, iters = 64, 3
    deltas = (1, i_n - 1, 4, i_n - 4)
    block, h = 16, (iters + 1) * 4
    rng = np.random.default_rng(11)
    b_n, b_pad, d_p = len(deltas), 128, 256
    w = rng.uniform(1.0, 9.0, (i_n, b_n)).astype(np.float32)
    d0 = rng.uniform(0.0, 50.0, (i_n, d_p)).astype(np.float32)
    d0[rng.integers(0, i_n, 8), rng.integers(0, d_p, 8)] = 0.0

    w_cols = np.full((i_n, b_pad), bf.BIG, np.float32)
    w_cols[:, :b_n] = w
    road_ids = np.arange(i_n * b_n, dtype=np.int32).reshape(i_n, b_n)
    road_cols = np.full((i_n, b_pad), -1.0, np.float32)
    road_cols[:, :b_n] = road_ids
    slot_cols = np.full((i_n, b_pad), 1e9, np.float32)
    slot_cols[:, :b_n] = np.arange(b_n)
    shifts = tuple((i_n - d) % i_n for d in deltas)
    args = [jnp.asarray(a) for a in (d0, w_cols, road_cols, slot_cols)]
    with pltpu.force_tpu_interpret_mode():
        k5 = bf._multisweep_pallas_rowblock(args[0], args[1], deltas, iters,
                                            (block, h, 128))
        k4 = bf._multisweep_pallas(args[0], args[1], shifts, iters, 128)
        k3 = bf._multisweep_nr_pallas_rowblock(*args, deltas, iters,
                                               (block, h, 128))
        k2 = bf._multisweep_nr_pallas(*args, shifts, iters, 128)

    road_to = ((np.arange(i_n)[:, None] + np.asarray(deltas)[None, :])
               % i_n).astype(np.int32).reshape(-1)
    tabs = (torch.as_tensor(w.reshape(-1)), torch.as_tensor(road_ids),
            torch.ones((i_n, b_n), dtype=torch.bool),
            torch.as_tensor(road_to))
    dist, road = pbf.primal_relax_next_roads(*tabs, torch.as_tensor(d0),
                                             iters)
    for name, (ref_d, ref_r) in (("K3", k3), ("K2", k2)):
        _eq(ref_d, dist, f"{name} dist")
        _eq(ref_r, road, f"{name} next road")
    _eq(k5, dist, "K5 dist")
    _eq(k4, dist, "K4 dist")
    assert not np.array_equal(d0, dist.numpy())


@pytest.mark.parametrize("grid", ["Grid8x8", "Grid32x32"])
def test_primal_table_init(scen_root, grids, grid):
    """Device relax (I^2 <= 10^6) and the host Dijkstra path above it."""
    if grid in grids:
        net, _, pnet, _ = grids[grid]
    else:
        net, _, pnet, _ = load_both(scen_root, grid)
    assert (net.num_intersections ** 2 > 1_000_000) == (grid == "Grid32x32")
    ref = np.asarray(primal_table_init(net))
    got = ppol.primal_table_init(pnet)
    assert_tree_equal(ref.view(np.uint32), got.numpy().view(np.uint32),
                      "packed table")
    i_n = pnet.num_intersections
    dist, cost, road = ppol._primal_unpack(got, i_n, i_n, pnet.num_roads)
    assert got.numel() == ppol.primal_buf_size(i_n, i_n, pnet.num_roads)
    assert float(dist.max()) < bf.BIG and torch.equal(cost, pnet.free_flow)
    assert int((road < 0).sum()) == 0     # every pair reachable


@pytest.mark.parametrize("i_n,d_n,k_n,iters,want", [
    (4096, 4096, 4, 8, 8),       # the sp row: 512 tiles of 8 columns
    (4096, 13, 4, 8, 8),         # a tail of 5 columns
    (4096, 4, 4, 8, 4),          # the zoned parts' _round4 columns: D < 8
    (256, 256, 4, None, 8),      # the uncapped table init
    (64, 1, 4, 2, 1),
    (4096, 4096, 4, 1, None),    # one sweep: the global form's one pass
    (4096, 4096, 4, 0, None),
    (4096, 4096, 5, 8, None),    # more slots than registers keep
    (4097, 100, 4, 8, None),     # more rows than registers keep
    (16384, 512, 4, 8, None),    # Grid128x128, the TPU's K3/K5 case
    (65536, 16, 4, None, None),  # Grid256x256
])
def test_resident_plan(i_n, d_n, k_n, iters, want):
    cols = pbf.resident_plan(i_n, d_n, k_n, iters)
    assert cols == want
    if cols is None:
        return
    assert cols == min(pbf.MAX_TILE_COLS, d_n)
    tiles = -(-d_n // cols)
    tail = d_n - (tiles - 1) * cols
    assert 1 <= tail <= cols and (tail == cols) == (d_n % cols == 0)


def _tiled_relax(cost, pnet, d0, iters, cols, relax_only):
    """A model of the resident kernel: the columns of ``d0`` in tiles of
    ``cols`` (the last one narrower), each relaxed by the plain sweep until
    ``iters`` sweeps (``I - 1`` when None) or its first sweep that lowers
    nothing in the tile, then the plain next-road pass on the tile.
    Returns ``(dist, road or None, sweeps run per tile)``."""
    out_r, ok, road_to = _ptables(pnet)
    w, succ = pbf._slot_tables(cost, out_r, ok, road_to)
    cap = d0.shape[0] - 1 if iters is None else iters
    dists, roads, sweeps = [], [], []
    for c0 in range(0, d0.shape[1], cols):
        d = d0[:, c0:c0 + cols]
        n = 0
        while n < cap:
            new = pbf._sweep_plain(d, w, succ)
            n += 1
            if not bool((new < d).any()):
                break
            d = new
        dists.append(d)
        sweeps.append(n)
        if not relax_only:
            roads.append(pbf._next_roads_plain(d, w, succ, out_r))
    road = None if relax_only else torch.cat(roads, dim=1)
    return torch.cat(dists, dim=1), road, sweeps


def _near_start(net, seed):
    """``(cost, dist0)``: the exact all-pairs table of random costs, and
    those costs with a few roads made cheaper, so that the relax from that
    table settles within a few sweeps, at different sweeps in different
    tiles."""
    cost = _costs(net, "random", seed)
    d0 = np.array(bf.primal_all_pairs_dist(jnp.asarray(cost),
                                           *_tables(net)))
    g = np.random.default_rng(seed + 100)
    cheaper = cost.copy()
    cheaper[g.choice(cost.shape[0], 6, replace=False)] *= np.float32(0.5)
    return cheaper, d0


@pytest.mark.parametrize("iters", [1, 3, 8, None])
@pytest.mark.parametrize("kernel", ["K2", "K4"])
@pytest.mark.parametrize("grid,cols", [("Grid8x8", 3), ("Grid12x12", 5)])
def test_tiled_early_exit_against_pallas(grids, grid, cols, kernel, iters,
                                         monkeypatch):
    """The per-tile early exit gives the reference's capped (and uncapped)
    tables bitwise, from a near start and from the cold start, with a
    tile width that leaves a column tail."""
    net, _, pnet, _ = grids[grid]
    i_n = net.num_intersections
    ref_iters = i_n - 1 if iters is None else iters
    relax_only = kernel == "K4"
    early = []
    for cost, d0 in (_near_start(net, 3), (_costs(net, "random", 4),
                                           _cold(i_n))):
        ref_d, ref_r = _interpret_relax(net, cost, d0, ref_iters,
                                        monkeypatch, kernel)
        got_d, got_r, sweeps = _tiled_relax(
            torch.as_tensor(cost), pnet, torch.as_tensor(d0), iters, cols,
            relax_only)
        _eq(ref_d, got_d, f"{kernel} dist, tiles of {cols}")
        if not relax_only:
            _eq(ref_r, got_r, f"{kernel} next road, tiles of {cols}")
        plain_d, plain_r = pbf.primal_relax_next_roads(
            torch.as_tensor(cost), *_ptables(pnet), torch.as_tensor(d0),
            iters, relax_only)
        assert torch.equal(plain_d, got_d)
        assert (plain_r is None) == relax_only
        early.append(min(sweeps) < max(sweeps) or max(sweeps) < ref_iters)
    # Some tile stopped early, from the near start at 8 sweeps and from
    # both starts uncapped: the model exercised the exit.
    if iters is None:
        assert all(early)
    elif iters == 8:
        assert early[0]


@pytest.mark.parametrize("i_n,d_n,k_n,iters,resident,cluster", [
    (4096, 256, 4, 8, 8, None),         # the resident form's shape
    (4097, 256, 4, 8, None, (7, 2)),    # one row past it: two blocks
    (16384, 256, 4, 8, None, (7, 4)),   # the million-agent row's refresh
    (16384, 257, 4, None, None, (7, 4)),  # its uncapped table init
    (16384, 3, 4, 8, None, (3, 4)),     # D below the tile width
    (65536, 16, 4, 8, None, (7, 16)),   # Grid256x256: 16 blocks
    (65537, 16, 4, 8, None, None),      # past 16 blocks: the global form
    (16384, 256, 4, 1, None, None),     # one sweep (K6): the global form
    (16384, 256, 4, 0, None, None),
    (16384, 256, 5, 8, None, None),     # more slots than registers keep
])
def test_cluster_plan(i_n, d_n, k_n, iters, resident, cluster):
    assert pbf.resident_plan(i_n, d_n, k_n, iters) == resident
    assert pbf.cluster_plan(i_n, d_n, k_n, iters) == cluster
    if cluster is None:
        return
    cols, blocks = cluster
    rows = -(-i_n // blocks)
    assert rows <= pbf.RESIDENT_ROWS < 2 * rows      # the smallest power
    assert blocks & (blocks - 1) == 0 and 2 <= blocks <= 16


@pytest.mark.parametrize("d_n,clusters,cols", [
    (256, 30, 5),     # 52 tiles fill two waves of 30 (37 of 7 would not)
    (512, 30, 6),     # 86 tiles in three waves
    (224, 32, 7),     # 32 tiles of 7 fill one wave of 32
    (13, 30, 1),      # fewer columns than clusters: one column a tile
    (16384, 30, 7),   # many waves: the full width
])
def test_cluster_plan_fills_the_last_wave(d_n, clusters, cols):
    got, blocks = pbf.cluster_plan(16384, d_n, 4, 8, clusters)
    assert (got, blocks) == (cols, 4)
    waves = -(-(-(-d_n // pbf.CLUSTER_TILE_COLS)) // clusters)
    assert -(-d_n // got) <= waves * clusters    # no wave added
    assert got == 1 or -(-d_n // (got - 1)) > waves * clusters  # narrowest


@pytest.mark.parametrize("clusters,plan,waves", [
    (7, (7, 16), 6),   # 37 tiles of 7 in six waves of 7
    (8, (7, 16), 5),   # 37 tiles in five waves of 8
    (9, (6, 16), 5),   # five waves of 9 hold 45 tiles: narrowed to 43 of 6
])
def test_cluster_plan_grid256_zoned_tables(clusters, plan, waves):
    """Grid256x256's zoned tables (65,536 rows, 257 columns) in clusters of
    16 blocks, at 8 sweeps and uncapped, and the waves each plan runs."""
    for iters in (8, None):
        assert pbf.cluster_plan(65536, 257, 4, iters, clusters) == plan
    assert pbf.cluster_waves(257, plan[0], clusters) == waves
    assert pbf.cluster_waves(257, pbf.CLUSTER_TILE_COLS, clusters) >= waves


def test_cluster_counters_add_each_launch_plan(monkeypatch):
    """Each call of the cluster path adds its plan to the counters (blocks,
    tile width, the cached capacity, waves) with no host read; the other
    forms add nothing there; ``reset_launches`` zeroes them."""
    from tarl_tpu_torch.core import sync

    meta = torch.device("meta")
    launched = []
    monkeypatch.setattr(pbf, "_launch_tiled",
                        lambda form, *a: launched.append((form, a[-3:])))
    monkeypatch.setitem(pbf._CLUSTER_FIT, (None, 65536, 4, 16), 8)
    monkeypatch.setitem(pbf._CLUSTER_FIT, (None, 16384, 4, 4), 30)

    def relax(i_n, d_n, iters):
        pbf._launch_relax(
            torch.empty(4 * i_n, device=meta),
            torch.empty((i_n, 4), dtype=torch.int32, device=meta),
            torch.empty((i_n, 4), dtype=torch.bool, device=meta),
            torch.empty(4 * i_n, dtype=torch.int32, device=meta),
            torch.empty((i_n, d_n), device=meta), iters, False)

    pbf.reset_launches()
    reads = sync.HOST_READS
    relax(65536, 257, 8)
    relax(65536, 257, None)
    assert launched == [("cluster", (7, 16, 8)), ("cluster", (7, 16, 65535))]
    assert (pbf.CLUSTER_LAUNCHES, pbf.CLUSTER_BLOCKS, pbf.CLUSTER_COLS,
            pbf.CLUSTER_AT_ONCE, pbf.CLUSTER_WAVES) == (2, 32, 14, 16, 10)
    relax(16384, 257, 8)                  # the million grid: 52 tiles of 5
    assert (pbf.CLUSTER_LAUNCHES, pbf.CLUSTER_BLOCKS, pbf.CLUSTER_COLS,
            pbf.CLUSTER_AT_ONCE, pbf.CLUSTER_WAVES) == (3, 36, 19, 46, 12)
    relax(4096, 257, 8)                   # the resident form
    assert launched[-1][0] == "resident"
    assert (pbf.RESIDENT_LAUNCHES, pbf.CLUSTER_LAUNCHES,
            pbf.CLUSTER_WAVES) == (1, 3, 12)
    assert sync.HOST_READS == reads
    pbf.reset_launches()
    assert (pbf.CLUSTER_LAUNCHES, pbf.CLUSTER_BLOCKS, pbf.CLUSTER_COLS,
            pbf.CLUSTER_AT_ONCE, pbf.CLUSTER_WAVES) == (0, 0, 0, 0, 0)
