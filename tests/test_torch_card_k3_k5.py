"""The relax past 4,096 rows (the TPU's K3 and K5) in the cluster form,
against the plain version on a card, with no jax: on a card run

    python -m pytest --noconftest -m cuda tests/test_torch_card_k3_k5.py

Every test is marked ``cuda`` and skips where no card is.  The networks
are built from link arrays (``network.build_network``), the inputs from
numpy seeds:

* a 50 x 100 grid whose 5,000 intersections are relabelled by a seeded
  permutation, so that most successors lie in the other block of the
  cluster (two blocks of 2,500 rows): every mode, on every column and on
  tails of 13 and 3 columns, from a warm start and from the cold start;
* Grid128x128 (16,384 rows, clusters of 4) with 256 seeded destination
  columns, as the million-agent row refreshes them, in every mode, and
  uncapped from the anchored cold start with no host read;
* Grid256x256 (65,536 rows, clusters of 16, the card's non-portable
  cluster size) with 16 columns at 8 sweeps, and with 257 seeded columns
  (the metropolitan grid's zoned tables) at 8 sweeps from a random warm
  start and uncapped from the anchored cold start, each launch counted
  with its plan.

Modes: 8 sweeps and the next roads (K3's function), 8 sweeps alone (K5's),
3 sweeps, and uncapped (up to I - 1 sweeps in one launch).  Distances and
next roads must equal ``primal_relax_next_roads_plain``'s bit for bit (the
plain version on the card, whose gathers and minima are exact), and each
call must launch the cluster kernel once.  The wrapper narrows the tile to
fill the card's last wave of clusters; each case also runs at the full
width of 7 (the card's capacity withheld from ``cluster_plan``), so that
the tails of 13 and 3 columns are masked tiles.
"""
import numpy as np
import pytest
import torch

from tarl_tpu_torch.core import sync
from tarl_tpu_torch.network import build_network
from tarl_tpu_torch.routing import bellman_ford as pbf

MODES = ((8, False), (8, True), (3, False), (None, False))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; chip_smoke.py phase 6 "
                    "checks the cluster form on the card")
    return torch.device("cuda", 0)


def _grid(rows: int, cols: int, dev, seed=None):
    """A ``rows x cols`` grid of two-way links (``grid_scenario``'s link
    attributes), its intersections relabelled by a seeded permutation
    where ``seed`` is given."""
    frm, to = [], []
    for r in range(rows):
        for c in range(cols):
            k = r * cols + c
            if c + 1 < cols:
                frm += [k, k + 1]
                to += [k + 1, k]
            if r + 1 < rows:
                frm += [k, k + cols]
                to += [k + cols, k]
    frm, to = np.asarray(frm), np.asarray(to)
    if seed is not None:
        label = np.random.default_rng(seed).permutation(rows * cols)
        frm, to = label[frm], label[to]
    n = frm.shape[0]
    return build_network(
        length=np.full(n, 200.0), max_flow=np.full(n, 600.0),
        free_speed=np.full(n, 13.9), perm_lanes=np.ones(n),
        from_inter=frm, to_inter=to, num_intersections=rows * cols,
        device=dev)


def _inputs(net, dests: int, seed: int):
    """``(cost, tables, cold, warm)``: random costs over free flow, the
    cold start anchored at ``dests`` seeded columns and a random warm
    start with the same anchors."""
    g = np.random.default_rng(seed)
    i_n, dev = net.num_intersections, net.device
    cols = torch.as_tensor(np.sort(g.choice(i_n, dests, replace=False)),
                           device=dev)
    anchor = torch.arange(i_n, device=dev)[:, None] == cols[None, :]
    cost = net.free_flow * torch.as_tensor(
        g.uniform(1.0, 4.0, net.num_roads).astype(np.float32), device=dev)
    warm = torch.as_tensor(
        g.uniform(0.0, 4000.0, (i_n, dests)).astype(np.float32), device=dev)
    tables = (net.inter_out_road, net.inter_out_ok, net.road_to)
    return (cost, tables, torch.where(anchor, 0.0, pbf.BIG).contiguous(),
            torch.where(anchor, 0.0, warm).contiguous())


def _check(cost, tables, dist0, modes, blocks):
    i_n, k_n = tables[0].shape
    fit = pbf._cluster_fit
    for iters, only in modes:
        plan = pbf.cluster_plan(i_n, dist0.shape[1], k_n, iters)
        assert plan is not None and plan[1] == blocks, plan
        want = pbf.primal_relax_next_roads_plain(cost, *tables, dist0, iters,
                                                 only)
        for width in ("balanced", "full"):
            pbf._cluster_fit = fit if width == "balanced" else (
                lambda *shape: None)
            try:
                before, reads = pbf.CLUSTER_LAUNCHES, sync.HOST_READS
                got = pbf.primal_relax_next_roads(cost, *tables, dist0,
                                                  iters, only)
                torch.cuda.synchronize()
            finally:
                pbf._cluster_fit = fit
            assert pbf.CLUSTER_LAUNCHES == before + 1
            assert sync.HOST_READS == reads, "the cluster form read the host"
            for name, a, b in zip(("dist", "next road"), got, want):
                assert (a is None) == (b is None), name
                if a is not None:
                    assert torch.equal(a.view(torch.int32),
                                       b.view(torch.int32)), \
                        (name, width, i_n, dist0.shape[1], iters, only)
            assert not torch.equal(got[0], dist0), "the relax changed nothing"


@pytest.mark.cuda
def test_cluster_relax_scattered_successors():
    dev = _card()
    net = _grid(50, 100, dev, seed=5)
    succ = net.road_to[net.inter_out_road.long()].long()
    rows = torch.arange(net.num_intersections, device=dev)[:, None]
    remote = ((succ >= 2500) != (rows >= 2500)) & net.inter_out_ok
    assert float(remote.sum()) > 0.4 * float(net.inter_out_ok.sum())
    cost, tables, cold, warm = _inputs(net, 64, seed=50)
    for d0 in (warm, cold, warm[:, :13].contiguous(),
               cold[:, :3].contiguous()):
        _check(cost, tables, d0, MODES, blocks=2)


@pytest.mark.cuda
def test_cluster_relax_grid128_million_row_shape():
    dev = _card()
    net = _grid(128, 128, dev)
    cost, tables, cold, warm = _inputs(net, 256, seed=128)
    _check(cost, tables, warm, MODES, blocks=4)
    _check(cost, tables, cold, ((None, True), (None, False)), blocks=4)
    reached = pbf.primal_relax_next_roads(cost, *tables, cold, None, True)[0]
    assert float(reached.max()) < pbf.BIG


@pytest.mark.cuda
def test_cluster_relax_grid256_sixteen_blocks():
    dev = _card()
    net = _grid(256, 256, dev)
    cost, tables, _, warm = _inputs(net, 16, seed=256)
    _check(cost, tables, warm, ((8, False),), blocks=16)


@pytest.mark.cuda
def test_cluster_relax_grid256_zoned_tables():
    dev = _card()
    net = _grid(256, 256, dev)
    cost, tables, cold, warm = _inputs(net, 257, seed=257)
    pbf.reset_launches()
    _check(cost, tables, warm, ((8, False),), blocks=16)
    _check(cost, tables, cold, ((None, False),), blocks=16)
    fit = pbf._cluster_fit(dev, 65536, 4, 16)
    assert (pbf.RESIDENT_LAUNCHES, pbf.GLOBAL_LAUNCHES) == (0, 0)
    assert pbf.CLUSTER_LAUNCHES == 4
    assert pbf.CLUSTER_BLOCKS == 4 * 16
    assert pbf.CLUSTER_AT_ONCE == 4 * fit
    # Two launches at the narrowed tile, two at the full width of 7.
    cols = pbf.cluster_plan(65536, 257, 4, 8, fit)[0]
    assert pbf.CLUSTER_COLS == 2 * cols + 2 * pbf.CLUSTER_TILE_COLS
    assert pbf.CLUSTER_WAVES == 2 * pbf.cluster_waves(257, cols, fit) \
        + 2 * pbf.cluster_waves(257, pbf.CLUSTER_TILE_COLS, fit)
    reached = pbf.primal_relax_next_roads(cost, *tables, cold, None)[0]
    assert float(reached.max()) < pbf.BIG
