"""The random choice (``routing/policies.random_choice``) as the tick calls
it: the kernel of ``csrc/choice.cu`` on a CUDA network, the plain version
``random_choice_plain`` on a CPU network, with no jax.  On a card run

    python -m pytest --noconftest -m cuda tests/test_torch_choice.py

On the CPU:

* the wrapper is the plain version, bitwise, on a grid, on a renumbered
  city (its roads numbered by a seeded permutation) and on a grid with
  dead-end spurs (nodes with no choice slot, which keep their selection),
  and it launches nothing;
* a ``gumbel`` matrix takes the plain path on any device;
* the wrapper raises on a selection of another dtype, shape, device or
  layout, on a network table the kernel would not take, and on a device
  that is neither CPU nor CUDA;
* ``chip_smoke.choice_row``, the card's check of the kernel on a row's
  captured states, runs on a CPU network, where the wrapper is the plain
  version and launches nothing.

On a card (marked ``cuda``), the kernel against the plain version on the
card, bitwise, over 16 keys a network (some near ``2**32 - 1``): the
million grid's Grid128x128 (KC = 4, N = 97,792), the renumbered city and
the spurs, the key written back equal, one launch a call and none with a
``gumbel`` matrix.
"""
import os
from dataclasses import replace
from typing import NamedTuple

import numpy as np
import pytest
import torch

from tarl_tpu_torch import network as port_network
from tarl_tpu_torch.core import rng
from tarl_tpu_torch.io.city import city_scenario
from tarl_tpu_torch.io.matsim import load_network
from tarl_tpu_torch.network import build_network
from tarl_tpu_torch.routing import policies

torch.set_num_threads(1)

MASK = 2 ** 32 - 1
# Tick keys: small, seeded, and with words at and near 2**32 - 1.
KEYS = ([(0, s) for s in range(4)]
        + [tuple(int(w) for w in np.random.default_rng(s).integers(
            0, 2 ** 32, 2, dtype=np.uint64)) for s in range(8)]
        + [(MASK, MASK), (MASK, MASK - 1), (MASK - 1, 0), (0, MASK)])


class ChoiceState(NamedTuple):
    """What the random choice reads and writes of a tick's state."""

    selected_road: torch.Tensor
    key: tuple


def grid_network(rows: int, cols: int, spurs: int = 0, device="cpu"):
    """A ``rows x cols`` grid of two-way links (``grid_scenario``'s link
    attributes) and ``spurs`` one-way links from its first intersections to
    sinks of their own: each spur's head has no way on, so the spur and its
    sink's SRC node have no choice slot."""
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
    for s in range(spurs):
        frm.append(s)
        to.append(rows * cols + s)
    n = len(frm)
    return build_network(
        length=np.full(n, 200.0), max_flow=np.full(n, 600.0),
        free_speed=np.full(n, 13.9), perm_lanes=np.ones(n),
        from_inter=np.asarray(frm), to_inter=np.asarray(to),
        num_intersections=rows * cols + spurs, device=device)


def city_network(root: str, device="cpu"):
    """A small irregular city (``io/city.city_scenario``, 900 target
    intersections) with its roads numbered by a seeded permutation."""
    base = city_scenario(root, "MiniCity", num_intersections=900,
                         num_agents=50, num_dest_zones=8, seed=7)
    order = np.random.default_rng(12345)

    def seeded(from_inter, *args, **kwargs):
        return order.permutation(from_inter.shape[0]).astype(np.int64)

    mp = pytest.MonkeyPatch()
    mp.setattr(port_network, "roll_friendly_road_order", seeded)
    try:
        net = load_network(os.path.join(base, "network"), device=device)
    finally:
        mp.undo()
    assert net.renumbered
    return net


def random_selection(net, seed: int) -> torch.Tensor:
    """A seeded incoming selection: any road or -1, for every node."""
    g = np.random.default_rng(seed)
    sel = g.integers(-1, net.num_roads, net.num_nodes).astype(np.int32)
    return torch.as_tensor(sel, device=net.device)


@pytest.fixture(scope="module")
def networks(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_choice"))
    return {"grid": grid_network(6, 7), "city": city_network(root),
            "spurs": grid_network(4, 4, spurs=5)}


def test_spurs_have_nodes_without_a_slot(networks):
    net = networks["spurs"]
    none = ~net.choice_ok.any(dim=0)
    r = net.num_roads
    # The spurs, every DEST node and the sinks' SRC nodes.
    assert int(none[:r].sum()) == 5
    assert int(none[r + 1::2].sum()) == net.num_intersections
    assert int(none[r::2].sum()) == 5


@pytest.mark.parametrize("name", ["grid", "city", "spurs"])
def test_wrapper_is_the_plain_version_on_cpu(networks, name):
    net = networks[name]
    before = policies.LAUNCHES
    for i, key in enumerate(KEYS):
        state = ChoiceState(random_selection(net, i), key)
        got, entry = policies.random_choice(state, net)
        want, _ = policies.random_choice_plain(state, net)
        assert entry is None
        assert got.selected_road.dtype == torch.int32
        assert torch.equal(got.selected_road, want.selected_road)
        assert got.key == want.key == rng.split(key)[0]
        # A node with no ok slot keeps its selection; every other node
        # takes one of its slots.
        none = ~net.choice_ok.any(dim=0)
        assert torch.equal(got.selected_road[none], state.selected_road[none])
        tab = torch.where(net.choice_ok, net.choice_dst_tab, -2)
        assert bool((tab == got.selected_road[None, :]).any(dim=0)[~none]
                    .all())
    assert policies.LAUNCHES == before


@pytest.mark.parametrize("name", ["grid", "city", "spurs"])
def test_gumbel_matrix_takes_the_plain_path_on_any_device(networks, name):
    net = networks[name]
    state = ChoiceState(random_selection(net, 3), (7, 11))
    noise = rng.choice_gumbel(rng.split(state.key)[1], net)
    got, _ = policies.random_choice(state, net, gumbel=noise)
    want, _ = policies.random_choice_plain(state, net, gumbel=noise)
    assert torch.equal(got.selected_road, want.selected_road)
    # On a device with no kernel, the matrix still takes the plain path.
    meta = net.to("meta")
    before = policies.LAUNCHES
    out, _ = policies.random_choice(
        ChoiceState(state.selected_road.to("meta"), state.key), meta,
        gumbel=noise.to("meta"))
    assert out.selected_road.device.type == "meta"
    assert out.key == want.key
    assert policies.LAUNCHES == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "device", "layout",
                                 "table_dtype", "table_shape", "order_dtype",
                                 "unsupported_device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(networks, bad):
    net = networks["grid"]
    sel = random_selection(net, 0)
    if bad == "dtype":
        sel = sel.long()
    elif bad == "shape":
        sel = sel[:-1]
    elif bad == "device":
        sel = sel.to("meta")
    elif bad == "layout":
        sel = torch.stack([sel, sel], 1)[:, 0]
    elif bad == "table_dtype":
        net = replace(net, choice_ok=net.choice_ok.to(torch.uint8))
    elif bad == "table_shape":
        net = replace(net, choice_dst_tab=net.choice_dst_tab[:, :-1])
    elif bad == "order_dtype":
        net = replace(net, road_order=net.road_order.long())
    else:
        net, sel = net.to("meta"), sel.to("meta")
    with pytest.raises((TypeError, ValueError)):
        policies.random_choice(ChoiceState(sel, (1, 2)), net)


def test_choice_row_runs_on_cpu(networks):
    """The card's check of the kernel (``chip_smoke.choice_row``) on a few
    states of the renumbered city, on the CPU: every call checked, no
    launch, no timing."""
    import chip_smoke

    net = networks["city"]
    states = [ChoiceState(random_selection(net, i), KEYS[i]) for i in range(3)]
    before = policies.LAUNCHES
    out = chip_smoke.choice_row("city", net, states, "cpu")
    assert policies.LAUNCHES == before
    assert out["checked"] == 3 * (1 + len(chip_smoke.CHOICE_KEYS))
    assert (out["kc"], out["n"]) == tuple(net.choice_dst_tab.shape)
    assert out["renumbered"] and "ms" not in out
    assert out["least_bytes"] > 4 * net.num_roads


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; the random cells of "
                    "portbench check the kernel at the benchmark's shapes")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(tmp_path):
    dev = _card()
    nets = {"Grid128x128": grid_network(128, 128, device=dev),
            "city": city_network(str(tmp_path), device=dev),
            "spurs": grid_network(4, 4, spurs=5, device=dev)}
    assert nets["Grid128x128"].choice_dst_tab.shape == (4, 97_792)
    for name, net in nets.items():
        for i, key in enumerate(KEYS):
            state = ChoiceState(random_selection(net, i), key)
            before = policies.LAUNCHES
            got, _ = policies.random_choice(state, net)
            assert policies.LAUNCHES == before + 1, name
            want, _ = policies.random_choice_plain(state, net)
            torch.cuda.synchronize()
            assert got.key == want.key, (name, key)
            assert got.selected_road.dtype == torch.int32
            assert torch.equal(got.selected_road, want.selected_road), \
                (name, key)
        # A gumbel matrix takes the plain path on the card too.
        noise = rng.choice_gumbel(rng.split(key)[1], net)
        before = policies.LAUNCHES
        got, _ = policies.random_choice(state, net, gumbel=noise)
        assert policies.LAUNCHES == before
        assert torch.equal(got.selected_road, want.selected_road), name
