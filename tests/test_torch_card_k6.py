"""The relax's global form (the TPU's K6: one persistent launch a call)
against the plain version on a card, with no jax: on a card run

    python -m pytest --noconftest -m cuda tests/test_torch_card_k6.py

Every test is marked ``cuda`` and skips where no card is.  Inputs come
from numpy seeds:

* the radial metro of ``scripts/bench_radial.py`` (64 rings of 128 spokes:
  8,193 intersections of 8 out-slots) with its 129 CBD columns (the centre
  and the first ring), from a random warm start and from the cold start,
  in every mode, and on tails of 13 and 3 columns;
* one sweep at I = D = 4,096 (Grid64x64), the shape of ``PERF.md``'s K6
  row, and a radial warm start already at its fixpoint (the first sweep
  lowers nothing: every block leaves after it) at 1 and 2 sweeps and with
  none;
* a table whose padding is neither on road 0 nor last (valid and padding
  slots interleaved, padding roads that repeat within a row and that do
  not), with entries of -BIG so that every padding term counts, on rows of
  128 columns that start 4 bytes past a 16-byte boundary.

Modes: 8 sweeps with and without the next roads, 1 sweep, uncapped with
and without them.  Distances and next roads must equal
``primal_relax_next_roads_plain``'s bit for bit, each call must be one
global-form call (no resident or cluster launch), and the uncapped relax
must read nothing on the host.
"""
import numpy as np
import pytest
import torch

from tarl_tpu_torch.core import sync
from tarl_tpu_torch.io.matsim import load_network
from tarl_tpu_torch.io.scenarios import radial_scenario
from tarl_tpu_torch.routing import bellman_ford as pbf

from test_torch_card_k3_k5 import _card, _grid

MODES = ((8, False), (8, True), (1, True), (None, False), (None, True))
CBD = 129   # the centre and the first ring of 128 spokes


@pytest.fixture(scope="module")
def radial_net(tmp_path_factory):
    dev = _card()
    root = str(tmp_path_factory.mktemp("card_k6_radial"))
    radial_scenario(root, "Radial", rings=64, spokes=128, num_agents=10)
    return load_network(f"{root}/Radial/network", device=dev)


def _check(cost, tables, dist0, modes, changes=True):
    for iters, only in modes:
        want = pbf.primal_relax_next_roads_plain(cost, *tables, dist0, iters,
                                                 only)
        counts = (pbf.GLOBAL_LAUNCHES, pbf.RESIDENT_LAUNCHES,
                  pbf.CLUSTER_LAUNCHES)
        reads = sync.HOST_READS
        got = pbf.primal_relax_next_roads(cost, *tables, dist0, iters, only)
        torch.cuda.synchronize()
        assert sync.HOST_READS == reads, "the global form read the host"
        assert (pbf.GLOBAL_LAUNCHES, pbf.RESIDENT_LAUNCHES,
                pbf.CLUSTER_LAUNCHES) == (counts[0] + 1, *counts[1:])
        for name, a, b in zip(("dist", "next road"), got, want):
            assert (a is None) == (b is None), name
            if a is not None:
                assert torch.equal(a.view(torch.int32), b.view(torch.int32)), \
                    (name, tuple(dist0.shape), iters, only)
        assert torch.equal(got[0], dist0) != changes, (iters, only)


def _radial_inputs(net, seed: int):
    g = np.random.default_rng(seed)
    i_n, dev = net.num_intersections, net.device
    anchor = (torch.arange(i_n, device=dev)[:, None]
              == torch.arange(CBD, device=dev)[None, :])
    cost = net.free_flow * torch.as_tensor(
        g.uniform(1.0, 4.0, net.num_roads).astype(np.float32), device=dev)
    warm = torch.as_tensor(
        g.uniform(0.0, 4000.0, (i_n, CBD)).astype(np.float32), device=dev)
    return (cost, torch.where(anchor, 0.0, warm).contiguous(),
            torch.where(anchor, 0.0, pbf.BIG).contiguous())


@pytest.mark.cuda
def test_global_form_radial(radial_net):
    net = radial_net
    tables = (net.inter_out_road, net.inter_out_ok, net.road_to)
    i_n, k_n = tables[0].shape
    assert (i_n, k_n) == (8193, 8)
    assert pbf.resident_plan(i_n, CBD, k_n, 8) is None
    assert pbf.launch_cluster_plan(net.device, i_n, CBD, k_n, 8) is None
    cost, warm, cold = _radial_inputs(net, 64)
    for d0 in (warm, cold, warm[:, :13].contiguous(),
               cold[:, :3].contiguous()):
        _check(cost, tables, d0, MODES)
    reached = pbf.primal_relax_next_roads(cost, *tables, cold, None)
    assert float(reached[0].max()) < pbf.BIG
    assert float(reached[1].min()) >= 0.0


@pytest.mark.cuda
def test_global_form_one_sweep():
    dev = _card()
    net = _grid(64, 64, dev)
    tables = (net.inter_out_road, net.inter_out_ok, net.road_to)
    i_n = net.num_intersections
    g = np.random.default_rng(4096)
    cost = net.free_flow * torch.as_tensor(
        g.uniform(1.0, 4.0, net.num_roads).astype(np.float32), device=dev)
    warm = torch.as_tensor(g.uniform(0.0, 4000.0, (i_n, i_n)).astype(
        np.float32), device=dev)
    warm.diagonal().fill_(0.0)
    _check(cost, tables, warm, ((1, True), (1, False)))


@pytest.mark.cuda
def test_global_form_from_its_fixpoint(radial_net):
    """At the fixpoint the first sweep lowers nothing and every block
    leaves after it: with 2 sweeps that sweep wrote the scratch table, so
    the kernel copies dist0 out; with none it copies at once."""
    net = radial_net
    tables = (net.inter_out_road, net.inter_out_ok, net.road_to)
    cost, warm, _ = _radial_inputs(net, 65)
    fixed = pbf.primal_relax_next_roads_plain(cost, *tables, warm, None,
                                              True)[0]
    _check(cost, tables, fixed, ((0, False), (1, False), (2, False),
                                 (2, True), (None, False)), changes=False)


@pytest.mark.cuda
def test_global_form_any_slot_layout():
    dev = _card()
    g = np.random.default_rng(6)
    i_n, k_n, r_n, d_n = 5000, 6, 9000, 128
    out_road = g.integers(0, r_n, (i_n, k_n)).astype(np.int32)
    ok = g.random((i_n, k_n)) < 0.5
    out_road[~ok] = g.choice(g.choice(r_n, 3, replace=False),
                             int((~ok).sum()))
    road_to = g.integers(0, i_n, r_n).astype(np.int32)
    cost = g.integers(1, 6, r_n).astype(np.float32)
    d0 = g.uniform(0.0, 40.0, (i_n, d_n)).astype(np.float32)
    d0[g.random(d0.shape) < 0.3] = float(pbf.BIG)
    d0[g.random(d0.shape) < 0.01] = -float(pbf.BIG)
    tables = tuple(torch.as_tensor(a, device=dev)
                   for a in (out_road, ok, road_to))
    keep = pbf.compact_slots(*tables[:2])
    assert bool((~keep).any()) and bool((keep & ~tables[1]).any())
    # Rows that start 4 bytes past a 16-byte boundary: no float4 loads.
    store = torch.empty(i_n * d_n + 1, device=dev)
    shifted = store[1:].view(i_n, d_n)
    shifted.copy_(torch.as_tensor(d0, device=dev))
    assert shifted.data_ptr() % 16 == 4
    cost_t = torch.as_tensor(cost, device=dev)
    for dist0 in (shifted, shifted.clone()):
        _check(cost_t, tables, dist0, ((8, False), (1, True), (3, False)))
