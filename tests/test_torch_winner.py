"""The direction winner (K1) as the tick calls it: by key, its confirm
folded into the winners' scatter, on the CPU.

* The plain version's noise is ``rng.direction_gumbel(key, network)``,
  and the plain version is ``winners`` on that matrix plus
  ``popped_mask``, bitwise.
* The pop mask as the winners' scatter onto their upstreams (what the
  kernel writes) equals the confirm over the out-slot tables
  (``out_dst_tab`` / ``out_edge_ok``: road u pops iff some valid out-slot
  leads to a road that u won), on random ring states and on every tick of
  short episodes of Grid4x4, Grid8x8, Braess and Bottleneck, and on hub
  networks whose in-slots fill 6 and 40 lanes (on a card, the kernel
  against the plain version there; marked ``cuda``).  On a card the same
  hubs hold the road-block winner (K7) and the fused core's edge phase
  (K12's fused entry) against their plain versions, both drawing their
  noise from a key.
* The default-core tick and ``env_step`` run with ``rng.direction_gumbel``
  replaced by a function that raises: nothing on those paths draws the
  ``[KIN, R]`` matrix outside the core.
"""
import os
import sys

import numpy as np
import pytest
import torch

from tarl_tpu_torch.config import DEFAULT_PHYSICS, RLConfig, SimConfig
from tarl_tpu_torch.core import direction, fused_core, fused_winner, rng
from tarl_tpu_torch.core.response import popped_mask
from tarl_tpu_torch.core.step import Policy, init_sim_state, run_episode
from tarl_tpu_torch.io.matsim import load_network, load_population
from tarl_tpu_torch.io.scenarios import ensure_scenario
from tarl_tpu_torch.rl import env as env_mod
from tarl_tpu_torch.routing.policies import random_choice
from tarl_tpu_torch.state import RoadState

torch.set_num_threads(1)

SCENARIOS = ["Grid4x4", "Grid8x8", "Braess", "Bottleneck"]
START = 6 * 3600


@pytest.fixture(scope="module")
def scenarios(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_winner"))
    out = {}
    for name in SCENARIOS:
        base = ensure_scenario(root, name)
        net = load_network(os.path.join(base, "network"), device="cpu")
        agents, _ = load_population(os.path.join(base, "population"),
                                    os.path.join(base, "network"),
                                    device="cpu")
        out[name] = (net, agents)
    return out


def random_state(net, seed: int, time_now: float):
    """A random ring state within the invariants (``0 <= count <=
    capacity``, distinct live agents >= 1) and selections drawn from the
    choice table, so that many roads have an eligible in-slot."""
    g = np.random.default_rng(seed)
    r, nmax = net.num_roads, net.nmax
    cap = net.capacity.numpy().astype(np.int64)
    count = g.integers(0, cap + 1)
    head = g.integers(0, nmax, size=r)
    live = ((np.arange(nmax)[None, :] - head[:, None]) % nmax
            < count[:, None])
    ids = np.where(live, (g.permutation(r * nmax) + 1).reshape(r, nmax), 0)
    dep = np.where(live, time_now + g.integers(-40, 40, (r, nmax)), 0.0)
    dst = np.where(live, g.integers(0, net.num_nodes, (r, nmax)), 0)
    ok, tab = net.choice_ok.numpy(), net.choice_dst_tab.numpy()
    nslots = ok.sum(axis=0)
    pick = (g.random(net.num_nodes) * np.maximum(nslots, 1)).astype(int)
    sel = np.where(nslots > 0, tab[pick, np.arange(net.num_nodes)], -1)
    road = RoadState(
        fifo_ids=torch.as_tensor(ids.astype(np.int32)),
        fifo_arrival=torch.as_tensor((dep - 30.0).astype(np.float32)),
        fifo_departure=torch.as_tensor(dep.astype(np.float32)),
        fifo_dest=torch.as_tensor(dst.astype(np.int32)),
        head=torch.as_tensor(head.astype(np.int32)),
        count=torch.as_tensor(count.astype(np.int32)),
    )
    return road, torch.as_tensor(sel.astype(np.int32))


def out_table_confirm(win_src: torch.Tensor, net) -> torch.Tensor:
    """The confirm over the out-slot tables, in plain torch: road u pops
    iff some valid out-slot k has ``win_src[out_dst[k, u]] == u``."""
    r = win_src.shape[0]
    ok = net.out_edge_ok
    dst = torch.where(ok, net.out_dst_tab, 0).long()
    return (ok & (win_src[dst] == torch.arange(r, dtype=torch.int32))
            ).any(dim=0)


def test_plain_version_is_winners_on_the_direction_stream(scenarios):
    net, _ = scenarios["Grid4x4"]
    for seed in range(3):
        road, sel = random_state(net, seed, START + 10.0)
        key = rng.prng_key(100 + seed)
        gumbel = rng.direction_gumbel(key, net)
        got = fused_winner.direction_confirm_plain(road, sel, net,
                                                   START + 10.0, key)
        want = direction.winners(road, sel, net, START + 10.0, gumbel)
        want = (*want, popped_mask(want[0], want[1]))
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)
        assert bool(got[0].any())


@pytest.mark.parametrize("states", ["random", "episode"])
@pytest.mark.parametrize("name", SCENARIOS)
def test_confirm_fold_equals_the_out_table_confirm(scenarios, name, states):
    net, agents = scenarios[name]
    pops = 0

    def check(road, sel, network, time, key, physics=DEFAULT_PHYSICS):
        nonlocal pops
        out = fused_winner.direction_confirm(road, sel, network, time, key,
                                             physics)
        accept, win_src, popped = out[0], out[1], out[4]
        assert torch.equal(popped, out_table_confirm(win_src, network))
        assert torch.equal(popped.sum(), accept.sum())
        pops += int(popped.sum())
        return out

    if states == "random":
        for seed in range(6):
            road, sel = random_state(net, seed, START + 7.0 * seed)
            check(road, sel, net, START + 7.0 * seed, rng.prng_key(seed))
    else:
        sim = SimConfig(start_time=START)
        policy = Policy(choice=random_choice)
        state = init_sim_state(net, agents, sim=sim, policy=policy)
        run_episode(state, net, policy, 400, sim=sim, core=check)
    assert pops > 0, f"{name}/{states}: no road popped"


@pytest.fixture
def no_direction_matrix(monkeypatch):
    """Every module-level ``direction_gumbel`` of the port raises."""
    def refuse(*args, **kwargs):
        raise AssertionError("the [KIN, R] direction matrix was drawn")

    for mod in list(sys.modules.values()):
        name = getattr(mod, "__name__", "") or ""
        if name.startswith("tarl_tpu_torch") and hasattr(
                mod, "direction_gumbel"):
            monkeypatch.setattr(mod, "direction_gumbel", refuse)
    with pytest.raises(AssertionError):
        rng.direction_gumbel(rng.prng_key(0), None)


@pytest.mark.parametrize("path", ["tick", "env_step"])
def test_core_paths_never_draw_the_direction_matrix(scenarios,
                                                     no_direction_matrix,
                                                     monkeypatch, path):
    net, agents = scenarios["Grid4x4"]
    accepted = []
    monkeypatch.setattr(fused_winner, "popped_mask", lambda a, w: (
        accepted.append(int(a.sum())), popped_mask(a, w))[1])
    policy = Policy(choice=random_choice)
    if path == "tick":
        sim = SimConfig(start_time=START)
        state = init_sim_state(net, agents, sim=sim, policy=policy)
        state, _ = run_episode(state, net, policy, 300, sim=sim)
        assert int(state.road.count.sum()) > 0
    else:
        rl = RLConfig(reward_mode="throughput", episode_start=START)
        env, _ = env_mod.env_reset(init_sim_state(net, agents), net, rl)
        g = np.random.default_rng(3)
        for _ in range(150):
            action = torch.as_tensor(g.random(net.full_src.shape[0]) < 0.3)
            env, *_ = env_mod.env_step(env, action, net, rl)
        assert float(env.sim.time) > START
    assert sum(accepted) > 0


def hub_network(spokes: int, device="cpu"):
    """A hub intersection with ``spokes`` two-way spokes: each road out of
    the hub has an in-slot for every road into it, so KIN is about
    ``spokes`` (past the kernel's 32 lanes a road at 40)."""
    from tarl_tpu_torch.network import build_network

    frm = [i for s in range(1, spokes + 1) for i in (s, 0)]
    to = [i for s in range(1, spokes + 1) for i in (0, s)]
    n = len(frm)
    return build_network(
        length=np.full(n, 200.0), max_flow=np.full(n, 600.0),
        free_speed=np.full(n, 13.9), perm_lanes=np.ones(n),
        from_inter=np.asarray(frm), to_inter=np.asarray(to),
        num_intersections=spokes + 1, device=device)


@pytest.mark.parametrize("spokes", [6, 40])
def test_confirm_fold_on_a_wide_hub(spokes):
    net = hub_network(spokes)
    assert net.in_src_tab.shape[0] >= spokes - 1
    pops = 0
    for seed in range(4):
        road, sel = random_state(net, seed, START + 3.0 * seed)
        out = fused_winner.direction_confirm(road, sel, net,
                                             START + 3.0 * seed,
                                             rng.prng_key(seed))
        assert torch.equal(out[4], out_table_confirm(out[1], net))
        pops += int(out[4].sum())
    assert pops > 0


@pytest.mark.cuda
def test_kernel_matches_plain_on_card_wide_hub():
    """K1 where a road's in-slots fill a lane group that is not a power of
    two (KIN 6 in groups of 8) and where they outnumber a warp (KIN 40:
    each of 32 lanes walks its slots), against the plain version on the
    card, both clock forms."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; chip_smoke.py checks K1 "
                    "at the main paths' shapes")
    dev = torch.device("cuda", 0)
    for spokes in (6, 40):
        net = hub_network(spokes, dev)
        for seed in range(4):
            road, sel = random_state(net.to("cpu"), seed, START + 3.0 * seed)
            road = RoadState(*(t.to(dev) for t in road))
            sel = sel.to(dev)
            key = rng.prng_key(seed)
            want = fused_winner.direction_confirm_plain(
                road, sel, net, START + 3.0 * seed, key)
            for clock in (START + 3.0 * seed,
                          torch.tensor(START + 3.0 * seed, device=dev)):
                got = fused_winner.direction_confirm(road, sel, net, clock,
                                                     key)
                torch.cuda.synchronize()
                for a, b in zip(got, want):
                    assert torch.equal(a, b)


def _card_hub_states(spokes, dev):
    """A hub on the card and four seeded ring states of it, each with its
    clock and key."""
    net = hub_network(spokes, dev)
    out = []
    for seed in range(4):
        t_now = START + 3.0 * seed
        road, sel = random_state(net.to("cpu"), seed, t_now)
        out.append((RoadState(*(t.to(dev) for t in road)), sel.to(dev),
                    t_now, rng.prng_key(70 + seed)))
    return net, out


@pytest.mark.cuda
def test_shard_winner_kernel_matches_plain_on_card_wide_hub():
    """K7 by key on hubs of KIN 6 and 40 over 3 padded blocks, the whole
    device and its last block, against the plain version on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; chip_smoke.py checks K7 "
                    "at the main paths' shapes")
    dev = torch.device("cuda", 0)
    for spokes in (6, 40):
        net, states = _card_hub_states(spokes, dev)
        r, nmax = net.num_roads, net.nmax
        rp = -(-r // 3) * 3
        rl = rp // 3
        layout = direction.upstream_pack_layout(r, nmax)

        def pad(x, fill):
            if x.dim() == 1:
                return torch.cat([x, torch.full((rp - r,), fill,
                                                dtype=x.dtype, device=dev)])
            return torch.cat([x, torch.full((x.shape[0], rp - r), fill,
                                            dtype=x.dtype, device=dev)], 1)

        cols = dict(in_src=pad(net.in_src_tab, 0),
                    in_logit=pad(net.in_logit_tab, 0.0),
                    in_ok=pad(net.in_edge_ok, False))
        cap = pad(net.capacity, 0.0)
        for road, sel, t_now, key in states:
            s = sel[:r]
            sel_enc = pad(torch.where((s >= 0) & (s < r), s, r), r)
            count_f = pad(road.count, 0).to(torch.float32)
            pack = direction.pack_upstream(
                pad(road.head_departure(), 0.0), pad(road.count, 0), cap,
                sel_enc, t_now, DEFAULT_PHYSICS, r, nmax)
            halo = (pack, pad(road.head_ids(), 0), pad(road.head_dests(), 0))
            for col0, cut in ((0, slice(None)), (rp - rl, slice(rp - rl, rp))):
                tables = fused_winner.ShardTables(
                    **{k: v[:, cut].contiguous() for k, v in cols.items()},
                    capacity=cap[cut].contiguous(), road_order=net.road_order)
                args = (*halo, key, tables, count_f[cut].contiguous(), col0,
                        rp, DEFAULT_PHYSICS, layout)
                before = fused_winner.SHARD_LAUNCHES
                got = fused_winner.fused_shard_winner(*args)
                want = fused_winner.fused_shard_winner_plain(*args)
                torch.cuda.synchronize()
                assert fused_winner.SHARD_LAUNCHES == before + 1
                for a, b in zip(got, want):
                    assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.cuda
def test_fused_core_sample_kernel_matches_plain_on_card_wide_hub():
    """K12's fused entry on hubs whose roads have 6 and 40 incoming turn
    edges (lanes past 32), against its plain version on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; chip_smoke.py checks K12 "
                    "at the main path's shape")
    dev = torch.device("cuda", 0)
    for spokes in (6, 40):
        net, states = _card_hub_states(spokes, dev)
        for road, sel, t_now, key in states:
            before = fused_core.LAUNCHES
            got = fused_core.fused_core_sample(road, sel, net, t_now, key)
            want = fused_core.fused_core_sample_plain(road, sel, net, t_now,
                                                      key)
            torch.cuda.synchronize()
            assert fused_core.LAUNCHES == before + 1
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and torch.equal(a, b)
