"""The port's road-sharded episode against the JAX reference and against
the port's serial episode, bitwise, on the CPU.

* (a) ``pack_upstream`` equals the reference's on seeded states, padded
  sentinel rows included, and both raise past 31 bits.
* (b) K7's plain version, given the tick's direction key, equals the
  reference's ``fused_shard_winner`` (its Pallas kernel in interpret mode,
  fed ``[KIN, rl]`` slot rows read from the same vectors and the blocks'
  columns of the reference's own ``direction_gumbel`` under the same key)
  on every block of a padded mesh; the wrapper's one call over all blocks
  equals the blocks' calls.  On a 40-spoke hub (40 in-slots a road: the
  kernel's lanes past 32) it equals the serial winner (K1's plain version)
  under the same key.  The sharded tick runs with ``rng.direction_gumbel``
  and ``rng.gumbel`` made to raise: no noise matrix is drawn.
* (c) A Grid4x4 episode on 8 road blocks equals the reference's
  ``run_episode_shard_map`` with its roll plan forced, so that the
  reference itself runs K7: final state and every log field.
* (d) The sharded episode equals the port's serial ``run_episode`` in
  every insert form, with bounded withdraw depth and escalation, and with
  both primal shortest-path policies, on 1 to 8 blocks and padded meshes.
* (e) The tick's collectives: two halo gathers, one winner gather and the
  ``psum``s per tick (a counting mesh); and the blocks split over threads,
  each holding its share and reading the others' rows only through the
  mesh, give the serial episode.
"""
import os
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tarl_tpu.config import PhysicsConfig, SimConfig
from tarl_tpu.core import direction as ref_direction
from tarl_tpu.core import roll_gather
from tarl_tpu.core.fused_winner import fused_shard_winner as ref_winner
from tarl_tpu.core.rng import direction_gumbel as ref_direction_gumbel
from tarl_tpu.core.step import Policy, init_sim_state
from tarl_tpu.parallel.shard_map_episode import (
    make_road_mesh as ref_make_road_mesh,
    run_episode_shard_map as ref_run_episode_shard_map,
)
from tarl_tpu.parallel.sharded_episode import pad_agents as ref_pad_agents
from tarl_tpu.routing.policies import random_choice

from tarl_tpu_torch import convert
from tarl_tpu_torch.config import DEFAULT_PHYSICS
from tarl_tpu_torch.config import RoutingConfig as PortRoutingConfig
from tarl_tpu_torch.config import SimConfig as PortSimConfig
from tarl_tpu_torch.core import direction, fused_winner, rng
from tarl_tpu_torch.core import step as p_step
from tarl_tpu_torch.io.matsim import load_network, load_population
from tarl_tpu_torch.io.scenarios import grid_scenario
from tarl_tpu_torch.parallel.shard_map_episode import (
    RoadMesh,
    make_road_mesh,
    run_episode_shard_map,
)
from tarl_tpu_torch.parallel.sharded_episode import pad_agents
from tarl_tpu_torch.routing.policies import _dest_inter
from tarl_tpu_torch.routing.policies import random_choice as p_random_choice
from tarl_tpu_torch.simulator import make_policy
from tarl_tpu_torch.state import RoadState, sort_agents_by_departure

from test_shard_map_episode import _forced_roll_net
from test_torch_network import assert_tree_equal, load_both
from test_torch_winner import hub_network, random_state

torch.set_num_threads(1)

START = 6 * 3600


@pytest.fixture(scope="module")
def grid4(tmp_path_factory):
    return load_both(str(tmp_path_factory.mktemp("torch_shard")), "Grid4x4")


@pytest.fixture(scope="module")
def grid3x5(tmp_path_factory):
    """Grid3x5 (44 roads: 8 blocks need padding), 120 commuters."""
    base = grid_scenario(str(tmp_path_factory.mktemp("torch_shard35")),
                         "Grid3x5", rows=3, cols=5, num_agents=120)
    net = load_network(os.path.join(base, "network"), device="cpu")
    agents, _ = load_population(os.path.join(base, "population"),
                                os.path.join(base, "network"), device="cpu")
    assert net.num_roads % 8 != 0
    return net, agents


def _random_ring(net, seed: int, time_now: float):
    """A seeded ring state with ``0 <= count <= capacity``, distinct live
    agents >= 1 with DEST nodes, departures around ``time_now``, and a
    random valid selection per node (2% none)."""
    g = np.random.default_rng(seed)
    r, nmax = net.num_roads, net.nmax
    cap = net.capacity.numpy().astype(np.int64)
    count = g.integers(0, cap + 1)
    head = g.integers(0, nmax, size=r)
    live = (np.arange(nmax)[None, :] - head[:, None]) % nmax < count[:, None]
    ids = np.where(live, (g.permutation(r * nmax) + 1).reshape(r, nmax), 0)
    dep = np.where(live, time_now + g.integers(-40, 40, (r, nmax)), 0.0)
    dst = np.where(live, r + 2 * g.integers(0, net.num_intersections,
                                            (r, nmax)) + 1, 0)
    ok, tab = net.choice_ok.numpy(), net.choice_dst_tab.numpy()
    nslots = ok.sum(axis=0)
    pick = (g.random(net.num_nodes) * np.maximum(nslots, 1)).astype(int)
    sel = np.where(nslots > 0, tab[pick, np.arange(net.num_nodes)], -1)
    sel[g.random(net.num_nodes) < 0.02] = -1
    road = RoadState(
        fifo_ids=torch.as_tensor(ids.astype(np.int32)),
        fifo_arrival=torch.as_tensor((dep - 30.0).astype(np.float32)),
        fifo_departure=torch.as_tensor(dep.astype(np.float32)),
        fifo_dest=torch.as_tensor(dst.astype(np.int32)),
        head=torch.as_tensor(head.astype(np.int32)),
        count=torch.as_tensor(count.astype(np.int32)))
    return road, torch.as_tensor(sel.astype(np.int32))


def _pad(x, rp, fill):
    tail = torch.full((rp - x.shape[-1],), fill, dtype=x.dtype)
    return torch.cat([x, tail])


def _pack_inputs(net, seed, rp):
    """Padded ``(head_dep, count, cap, sel_enc, time, head_id, head_dest)``
    over ``rp`` roads from a seeded ring state."""
    r = net.num_roads
    t_now = START + 17.0 * seed
    road, sel = _random_ring(net, seed, t_now)
    s = sel[:r]
    sel_enc = torch.where((s >= 0) & (s < r), s, r)
    return (_pad(road.head_departure(), rp, 0.0), _pad(road.count, rp, 0),
            _pad(net.capacity, rp, 0.0), _pad(sel_enc, rp, r), t_now,
            _pad(road.head_ids(), rp, 0), _pad(road.head_dests(), rp, 0))


# --- (a) the packed upstream word -------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pack_upstream_matches_reference(grid4, seed):
    _, _, pnet, _ = grid4
    r, nmax = pnet.num_roads, pnet.nmax
    rp = r + 5          # five inert padded rows
    dep, count, cap, sel_enc, t_now, _, _ = _pack_inputs(pnet, seed, rp)
    got = direction.pack_upstream(dep, count, cap, sel_enc, t_now,
                                  DEFAULT_PHYSICS, r, nmax)
    want = ref_direction.pack_upstream(
        jnp.asarray(dep.numpy()), jnp.asarray(count.numpy()),
        jnp.asarray(cap.numpy()), jnp.asarray(sel_enc.numpy()),
        jnp.float32(t_now), PhysicsConfig(), r, nmax)
    assert_tree_equal(np.asarray(want), got.numpy(), "pack")
    assert direction.upstream_pack_layout(r, nmax) == \
        ref_direction.upstream_pack_layout(r, nmax)
    for flag in (1, 2, 4):            # every flag is set somewhere and unset
        assert 0 < int(((got & flag) > 0).sum()) < rp


def test_pack_layout_raises_past_31_bits():
    for layout in (direction.upstream_pack_layout,
                   ref_direction.upstream_pack_layout):
        with pytest.raises(ValueError, match="overflow"):
            layout(1 << 22, 100)
        assert layout(1 << 20, 100) == (3, 10, 127)


# --- (b) K7's plain version against the reference's interpret-mode K7 ------

def test_shard_winner_plain_matches_reference(grid4, monkeypatch):
    net, _, pnet, _ = grid4
    monkeypatch.setenv("TARL_FUSED_WINNER_INTERPRET", "1")
    r, nmax = pnet.num_roads, pnet.nmax
    blocks = 5
    rp = -(-r // blocks) * blocks          # 50: the last block has 2 pads
    rl = rp // blocks
    kin = pnet.in_src_tab.shape[0]
    layout = direction.upstream_pack_layout(r, nmax)
    src_p = torch.cat([pnet.in_src_tab,
                       torch.zeros((kin, rp - r), dtype=torch.int32)], 1)
    logit_p = torch.cat([pnet.in_logit_tab, torch.zeros((kin, rp - r))], 1)
    ok_p = torch.cat([pnet.in_edge_ok,
                      torch.zeros((kin, rp - r), dtype=torch.bool)], 1)
    accepted = 0
    for seed in range(2):
        dep, count, cap, sel_enc, t_now, hid, hdst = _pack_inputs(
            pnet, 10 + seed, rp)
        pack = direction.pack_upstream(dep, count, cap, sel_enc, t_now,
                                       DEFAULT_PHYSICS, r, nmax)
        # The tick's direction key, and the reference's own matrix from it.
        jkey = jax.random.split(jax.random.PRNGKey(100 + seed))[1]
        key = tuple(int(w) for w in np.asarray(jkey))
        assert key == rng.split(rng.prng_key(100 + seed))[1]
        gum = torch.as_tensor(np.array(ref_direction_gumbel(jkey, net)))
        gum = torch.cat([gum, torch.zeros((kin, rp - r))], 1)
        count_f = count.to(torch.float32)
        parts = []
        for b in range(blocks):
            c = slice(b * rl, (b + 1) * rl)
            src = src_p[:, c].contiguous()
            cols = (logit_p[:, c].contiguous(), src, ok_p[:, c].contiguous(),
                    count_f[c], cap[c])
            tables = fused_winner.ShardTables(
                in_src=src, in_logit=cols[0], in_ok=cols[2],
                capacity=cap[c].contiguous(), road_order=pnet.road_order)
            got = fused_winner.fused_shard_winner_plain(
                pack, hid, hdst, key, tables, count_f[c].contiguous(),
                b * rl, rp, DEFAULT_PHYSICS, layout)
            s64 = src.long()
            want = ref_winner(
                *(jnp.asarray(v[s64].numpy()) for v in (pack, hid, hdst)),
                jnp.asarray(gum[:, c].contiguous().numpy()),
                *(jnp.asarray(v.numpy()) for v in cols),
                jnp.arange(b * rl, (b + 1) * rl, dtype=jnp.int32), rp,
                PhysicsConfig(), layout)
            for name, w, p in zip(("accept", "win", "agent", "dest"), want,
                                  got):
                assert_tree_equal(np.asarray(w), p.numpy(),
                                  f"block {b} {name}")
            parts.append(got)
            accepted += int(got[0].sum())
        whole = fused_winner.fused_shard_winner(
            pack, hid, hdst, key, fused_winner.ShardTables(
                in_src=src_p, in_logit=logit_p, in_ok=ok_p, capacity=cap,
                road_order=pnet.road_order),
            count_f, 0, rp, DEFAULT_PHYSICS, layout)
        for i, t in enumerate(whole):
            assert torch.equal(t, torch.cat([p[i] for p in parts]))
    assert accepted > 10


@pytest.mark.parametrize("spokes,blocks", [(6, 5), (40, 3)])
def test_shard_winner_plain_equals_serial_winner_on_a_hub(spokes, blocks):
    """K7 by key on a hub over padded blocks equals the serial winner
    (``direction_confirm_plain``, K1's function) under the same key: both
    draw in-slot ``k`` of road ``c`` at ``k*R + road_order[c]``."""
    net = hub_network(spokes)
    r, nmax = net.num_roads, net.nmax
    kin = net.in_src_tab.shape[0]
    assert kin >= spokes - 1
    rp = -(-r // blocks) * blocks
    assert rp > r
    layout = direction.upstream_pack_layout(r, nmax)

    def pad(x, fill):
        return _pad(x, rp, fill) if x.dim() == 1 else torch.cat(
            [x, torch.full((x.shape[0], rp - r), fill, dtype=x.dtype)], 1)

    tables = fused_winner.ShardTables(
        in_src=pad(net.in_src_tab, 0), in_logit=pad(net.in_logit_tab, 0.0),
        in_ok=pad(net.in_edge_ok, False), capacity=pad(net.capacity, 0.0),
        road_order=net.road_order)
    accepted = 0
    for seed in range(4):
        t_now = START + 3.0 * seed
        road, sel = random_state(net, seed, t_now)
        key = rng.prng_key(50 + seed)
        s = sel[:r]
        sel_enc = _pad(torch.where((s >= 0) & (s < r), s, r), rp, r)
        count = _pad(road.count, rp, 0)
        pack = direction.pack_upstream(
            _pad(road.head_departure(), rp, 0.0), count, tables.capacity,
            sel_enc, t_now, DEFAULT_PHYSICS, r, nmax)
        got = fused_winner.fused_shard_winner(
            pack, _pad(road.head_ids(), rp, 0), _pad(road.head_dests(), rp, 0),
            key, tables, count.to(torch.float32), 0, rp, DEFAULT_PHYSICS,
            layout)
        acc, win_src, agent, dest, _ = fused_winner.direction_confirm_plain(
            road, sel, net, t_now, key)
        assert torch.equal(got[0][:r], acc)
        assert torch.equal(got[1][:r], torch.where(acc, win_src, rp))
        assert torch.equal(got[2][:r], agent)
        assert torch.equal(got[3][:r], dest)
        assert not bool(got[0][r:].any())
        accepted += int(acc.sum())
    assert accepted > 0


@pytest.fixture
def no_noise_matrix(monkeypatch):
    """Every module-level ``direction_gumbel`` and ``gumbel`` of the port
    raises: only draws at given positions (``gumbel_at_positions``) are
    left."""
    def refuse(*args, **kwargs):
        raise AssertionError("a noise matrix was drawn")

    for mod in list(sys.modules.values()):
        name = getattr(mod, "__name__", "") or ""
        if not name.startswith("tarl_tpu_torch"):
            continue
        for attr in ("direction_gumbel", "gumbel"):
            if getattr(mod, attr, None) is getattr(rng, attr):
                monkeypatch.setattr(mod, attr, refuse)
    for fn in (rng.direction_gumbel, rng.gumbel):
        with pytest.raises(AssertionError):
            fn(rng.prng_key(0), None)


def test_sharded_tick_never_draws_a_noise_matrix(grid4, no_noise_matrix):
    """The sharded tick with a deterministic choice (primal shortest path)
    draws no ``[KIN, R]`` matrix, and still equals the serial run."""
    net, agents = grid4[2:]
    sim = PortSimConfig(**CASES["primal"][4])
    agents = sort_agents_by_departure(agents)
    policy = _port_policy("dijkstra", net, agents)
    state = p_step.init_sim_state(net, agents, sim=sim, policy=policy)
    final, logs = p_step.run_episode(state, net, policy, 200, sim=sim)
    sfinal, slogs = run_episode_shard_map(
        state, net, policy, 200, make_road_mesh(4, "cpu"), sim=sim)
    assert_tree_equal(_bits(final), _bits(sfinal), "final state")
    assert_tree_equal(convert.to_numpy(logs), convert.to_numpy(slogs), "logs")
    assert int(sfinal.road.count.sum()) > 0


# --- (c) the episode against the reference's shard_map ----------------------

def test_sharded_episode_matches_reference(grid4, monkeypatch):
    net, agents, pnet, pagents = grid4
    agents, pagents = ref_pad_agents(agents, 8), pad_agents(pagents, 8)
    assert_tree_equal(convert.to_numpy(agents), convert.to_numpy(pagents),
                      "padded agents")
    monkeypatch.setattr(roll_gather, "MIN_ROADS", 0)
    monkeypatch.setenv("TARL_FUSED_WINNER_INTERPRET", "1")
    steps = 300
    cfg = dict(start_time=START, end_time=START + steps)
    sim = SimConfig(**cfg)
    policy = Policy(choice=random_choice)
    state = init_sim_state(net, agents, sim=sim, policy=policy)
    final, logs = ref_run_episode_shard_map(
        state, _forced_roll_net(net), policy, steps, ref_make_road_mesh(8),
        sim=sim)

    psim = PortSimConfig(**cfg)
    ppolicy = p_step.Policy(choice=p_random_choice)
    pstate = p_step.init_sim_state(pnet, pagents, sim=psim, policy=ppolicy)
    before = fused_winner.SHARD_LAUNCHES
    pfinal, plogs = run_episode_shard_map(
        pstate, pnet, ppolicy, steps, make_road_mesh(8, "cpu"), sim=psim)
    assert fused_winner.SHARD_LAUNCHES == before    # the CPU takes plain
    assert_tree_equal(convert.to_numpy(final), convert.to_numpy(pfinal),
                      "final state")
    assert_tree_equal(convert.to_numpy(logs), convert.to_numpy(plogs), "logs")
    assert int(pfinal.agents.done.sum()) > 0


# --- (d) the sharded episode against the port's serial one -------------------

WINDOWED = dict(start_time=START, record_road_optimality=False,
                withdraw_depth=2)
EXACT = dict(start_time=START, record_road_optimality=False,
             insert_window=32, insert_backlog=256, withdraw_depth=2,
             sorted_population=True, insert_escalate=True,
             withdraw_escalate=True)
ROUTING = dict(refresh_rate=10, max_bf_iters=8, backend="primal")
CASES = {
    # scenario, blocks, policy, ticks, SimConfig fields
    "whole_1": ("Grid4x4", 1, "random", 300, dict(start_time=START)),
    "whole_4": ("Grid4x4", 4, "random", 300, dict(start_time=START)),
    "whole_8": ("Grid4x4", 8, "random", 300, dict(start_time=START)),
    "padded_grid3x5": ("Grid3x5", 8, "random", 300, dict(start_time=START)),
    "windowed": ("Grid4x4", 4, "random", 300, dict(
        WINDOWED, insert_window=16, sorted_population=True,
        insert_escalate=False, withdraw_escalate=False)),
    # Starting at 06:30, the first ticks find many agents due at once.
    "windowed_escalate": ("Grid4x4", 3, "random", 300, dict(
        WINDOWED, start_time=START + 1800, insert_window=4,
        insert_escalate=True)),
    "backlog": ("Grid4x4", 4, "random", 300, EXACT),
    "depth1_escalate": ("Grid4x4", 8, "random", 300, dict(
        start_time=START, withdraw_depth=1, withdraw_escalate=True)),
    "primal": ("Grid4x4", 4, "dijkstra", 300, dict(
        WINDOWED, insert_window=64, sorted_population=True,
        insert_escalate=False, withdraw_escalate=False)),
    "primal_zoned": ("Grid3x5", 7, "zoned", 300, dict(start_time=START - 60)),
}


def _scenario(name, grid4, grid3x5):
    return grid4[2:] if name == "Grid4x4" else grid3x5


def _port_policy(kind, net, agents):
    if kind == "random":
        return p_step.Policy(choice=p_random_choice)
    kw = {}
    if kind == "zoned":
        kw["dest_inters"] = np.unique(_dest_inter(net, agents.dest).numpy())
    return make_policy("dijkstra", PortRoutingConfig(**ROUTING), network=net,
                       **kw)


def _bits(state):
    d = convert.to_numpy(state)
    d["next_hop"] = d["next_hop"].view(np.uint32)
    return d


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_episode_matches_serial(grid4, grid3x5, case):
    scenario, blocks, kind, steps, cfg = CASES[case]
    net, agents = _scenario(scenario, grid4, grid3x5)
    sim = PortSimConfig(**cfg)
    if sim.sorted_population:
        agents = sort_agents_by_departure(agents)
    policy = _port_policy(kind, net, agents)
    state = p_step.init_sim_state(net, agents, sim=sim, policy=policy)
    final, logs = p_step.run_episode(state, net, policy, steps, sim=sim)
    sfinal, slogs = run_episode_shard_map(
        state, net, policy, steps, make_road_mesh(blocks, "cpu"), sim=sim)
    assert_tree_equal(_bits(final), _bits(sfinal), "final state")
    assert_tree_equal(convert.to_numpy(logs), convert.to_numpy(slogs), "logs")
    assert int(sfinal.agents.done.sum()) > 0
    if case.startswith("windowed_escalate"):
        assert float(slogs.window_saturated.sum()) > 0
    if kind != "random":
        assert sfinal.choice_count == steps


# --- (e) the collectives ---------------------------------------------------

class CountingMesh(RoadMesh):
    """A one-device mesh that counts its collectives."""

    def __init__(self, num_blocks):
        super().__init__(num_blocks, "cpu")
        self.gathers = self.psums = 0

    def all_gather(self, x):
        self.gathers += 1
        return super().all_gather(x)

    def psum(self, x):
        self.psums += 1
        return super().psum(x)


@pytest.mark.parametrize("form,psums", [("whole", 4), ("backlog", 3)])
def test_collectives_per_tick(grid4, form, psums):
    net, agents = grid4[2:]
    cfg = dict(start_time=START) if form == "whole" else EXACT
    sim = PortSimConfig(**cfg)
    if sim.sorted_population:
        agents = sort_agents_by_departure(agents)
    policy = p_step.Policy(choice=p_random_choice)
    state = p_step.init_sim_state(net, agents, sim=sim, policy=policy)
    counts = []
    for steps in (0, 20):
        mesh = CountingMesh(4)
        run_episode_shard_map(state, net, policy, steps, mesh, sim=sim)
        counts.append((mesh.gathers, mesh.psums))
    # Set-up and the end's gather of the blocks' rings and hourly columns
    # (six ring fields, two metric arrays) happen once per episode.
    assert counts[0] == (8, 0)
    assert ((counts[1][0] - 8) / 20, counts[1][1] / 20) == (3, psums)


class _Hub:
    """The exchange of ``world`` threads: each posts its part and reads
    everyone's, in rank order."""

    def __init__(self, world):
        self.parts = [None] * world
        self.barrier = threading.Barrier(world, timeout=120)

    def exchange(self, rank, x):
        self.parts[rank] = x
        self.barrier.wait()
        out = list(self.parts)
        self.barrier.wait()
        return out


class ThreadMesh(RoadMesh):
    """Rank ``rank`` of ``world`` threads, holding its ``num_blocks //
    world`` blocks only; other blocks' rows reach it through the hub."""

    def __init__(self, num_blocks, rank, world, hub):
        super().__init__(num_blocks, "cpu")
        self.held = num_blocks // world
        self.first = rank * self.held
        self.rank, self.hub = rank, hub

    def all_gather(self, x):
        return torch.cat([p.reshape(-1, *p.shape[2:])
                          for p in self.hub.exchange(self.rank, x)])

    def psum(self, x):
        parts = self.hub.exchange(self.rank, x.sum(dim=0, dtype=x.dtype))
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        return total


@pytest.mark.parametrize("world,steps", [(2, 150), (4, 60)])
def test_blocks_split_over_threads_match_serial(grid4, world, steps):
    net, agents = grid4[2:]
    # From 06:30 the network fills at once and trips end within a minute.
    sim = PortSimConfig(start_time=START + 1800)
    policy = p_step.Policy(choice=p_random_choice)
    state = p_step.init_sim_state(net, agents, sim=sim, policy=policy)
    final, logs = p_step.run_episode(state, net, policy, steps, sim=sim)
    hub, results = _Hub(world), [None] * world

    def rank_run(rank):
        mesh = ThreadMesh(8, rank, world, hub)
        results[rank] = run_episode_shard_map(state, net, policy, steps, mesh,
                                              sim=sim)

    threads = [threading.Thread(target=rank_run, args=(k,))
               for k in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    for rank, result in enumerate(results):
        assert result is not None, f"rank {rank} failed"
        assert_tree_equal(convert.to_numpy(final),
                          convert.to_numpy(result[0]), f"rank {rank} state")
        assert_tree_equal(convert.to_numpy(logs), convert.to_numpy(result[1]),
                          f"rank {rank} logs")
    assert int(final.agents.done.sum()) > 0
