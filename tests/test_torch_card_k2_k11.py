"""K11's action entry and K2's resident relax against their plain versions
on a card, with no jax: on a card run

    python -m pytest --noconftest -m cuda tests/test_torch_card_k2_k11.py

Both tests are marked ``cuda`` and skip where no card is.  The inputs are
made from numpy seeds and the port's own scenario files:

* ``segment_action`` on :data:`ACTION_CASES` (short segments as a node's
  out-edges are; temperatures 1 and 0.7; -inf logits, a segment of only
  -inf, empty segments, out-of-range ids, exact ties), with NaN and +-inf
  added, in both modes (no key, two keys), against
  ``segment_action_plain`` on the card and on the CPU, bitwise, one launch
  a call.  ``tests/test_torch_segment.py`` holds the plain version on the
  same cases against the reference's ``GraphDistribution``.
* ``primal_relax_next_roads`` on Grid8x8 and Grid12x12, from a near start
  (the exact table of random costs, then a few roads made cheaper) and
  from the cold start, on every column, 13 columns and 4 (a tail and
  D below the tile width), in K2 mode at 3 and 8 sweeps, relax only at 1
  and 8, and uncapped: the resident kernel where ``resident_plan`` takes
  the shape (no host read) and the global form (forced by a plan of
  ``None``), bitwise against the plain version on the CPU.
"""
import os

import numpy as np
import pytest
import torch

from tarl_tpu_torch.core import rng, sync
from tarl_tpu_torch.io.matsim import load_network
from tarl_tpu_torch.io.scenarios import grid_scenario
from tarl_tpu_torch.ops import segment as seg
from tarl_tpu_torch.routing import bellman_ford as pbf

ACTION_CASES = [("random", 1.0), ("random", 0.7), ("neg_inf", 1.0),
                ("neg_inf", 0.7), ("empty", 1.0), ("out_of_range", 0.7),
                ("ties", 1.0), ("ties", 0.7)]


def action_case(name: str):
    """``(logits float32[E], ids int32[E], num_segments)`` from a seed:
    short segments, as a node's out-edges are."""
    g = np.random.default_rng([c for c, _ in ACTION_CASES].index(name) + 40)
    e, n = 900, 250
    logits = (g.normal(size=e) * 3.0).astype(np.float32)
    ids = g.permutation(np.sort(g.integers(0, n, size=e))).astype(np.int32)
    if name == "neg_inf":
        logits[::9] = -np.inf
        logits[ids == 5] = -np.inf                    # a segment of only -inf
    elif name == "empty":
        ids[np.isin(ids, [3, 4, 20])] = 5
    elif name == "out_of_range":
        ids[::7] = -1
        ids[3::11] = n + 4
    elif name == "ties":
        logits = (np.round(logits * 2.0) / 2.0).astype(np.float32)
    return logits, ids, n


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; chip_smoke.py phases 6 "
                    "and 11 check these kernels on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_action_kernel_matches_plain_on_card():
    dev = _card()
    for name, temperature in ACTION_CASES:
        logits, ids, n = action_case(name)
        logits[:3] = [np.nan, np.inf, -np.inf]
        cl, ci = torch.as_tensor(logits), torch.as_tensor(ids)
        tl, ti = cl.to(dev), ci.to(dev)
        lay = seg.segment_layout(ti, n)
        for key in (None, rng.prng_key(7), rng.prng_key(8)):
            before = seg.ARGMAX_LAUNCHES
            got = seg.segment_action(tl, ti, n, lay, temperature, key)
            assert seg.ARGMAX_LAUNCHES == before + 1
            for where, want in (
                    ("card", seg.segment_action_plain(tl, ti, n, None,
                                                      temperature, key)),
                    ("CPU", seg.segment_action_plain(cl, ci, n, None,
                                                     temperature, key))):
                assert torch.equal(got.cpu(), want.cpu()), (name, key, where)


def _grid(root, n: int):
    grid_scenario(str(root), f"Grid{n}x{n}", rows=n, cols=n, num_agents=20)
    return load_network(os.path.join(str(root), f"Grid{n}x{n}", "network"),
                        device="cpu")


def _starts(net):
    """``[(cost, dist0)]``: a near start and the cold start, from seeds."""
    g = np.random.default_rng(3)
    i_n = net.num_intersections
    tabs = (net.inter_out_road, net.inter_out_ok, net.road_to)
    cost = net.free_flow * torch.as_tensor(
        g.uniform(1.0, 4.0, net.num_roads).astype(np.float32))
    exact = pbf.primal_all_pairs_dist(cost, *tabs)
    cheaper = cost.clone()
    cheaper[torch.as_tensor(g.choice(net.num_roads, 6, replace=False))] *= 0.5
    cold = torch.full((i_n, i_n), pbf.BIG)
    cold.diagonal().fill_(0.0)
    return [(cheaper, exact), (cost, cold)]


@pytest.mark.cuda
def test_resident_relax_matches_plain_on_card(tmp_path, monkeypatch):
    dev = _card()
    for n in (8, 12):
        net = _grid(tmp_path, n)
        tabs = (net.inter_out_road, net.inter_out_ok, net.road_to)
        dtabs = [t.to(dev) for t in tabs]
        for cost, d0 in _starts(net):
            for cols in (None, 13, 4):
                d = d0 if cols is None else d0[:, :cols].contiguous()
                for iters, only in ((8, False), (3, False), (8, True),
                                    (1, True), (None, False)):
                    want = pbf.primal_relax_next_roads_plain(
                        cost, *tabs, d, iters, only)
                    for plan in ("resident", "global"):
                        with monkeypatch.context() as m:
                            if plan == "global":
                                m.setattr(pbf, "resident_plan",
                                          lambda *shape: None)
                            reads = sync.HOST_READS
                            got = pbf.primal_relax_next_roads(
                                cost.to(dev), *dtabs, d.to(dev), iters, only)
                            torch.cuda.synchronize()
                            if plan == "resident":
                                assert sync.HOST_READS == reads
                        for a, b in zip(got, want):
                            assert (a is None) == (b is None)
                            if a is not None:
                                assert torch.equal(
                                    a.cpu().view(torch.int32),
                                    b.view(torch.int32)), (n, plan, iters)
