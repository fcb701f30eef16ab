"""Each phase of the port's tick against the JAX reference, bitwise.

States are captured in reference episodes — a Grid8x8 run with the default
configuration, and a 4x4 burst in the exact backlog mode whose SRC queues
run deep — then carried across with ``tarl_tpu_torch.convert``.  Each phase
gets the same inputs on both sides, with the reference's own Gumbel
matrices and keys, and must give the same ring fields, heads, counts,
winners, stamps and masks, exactly.  The kernel wrapper
``direction_confirm`` takes the tick's key, as the reference's fused
winner does, and its plain version here (CPU tensors).
"""
import jax
import numpy as np
import pytest
import torch

from tarl_tpu.config import DEFAULT_PHYSICS, RoutingConfig, SimConfig
from tarl_tpu.core.direction import direction_step
from tarl_tpu.core.insert import (
    backlog_frontier_append,
    insert_agents,
    insert_agents_backlogged,
    insert_agents_windowed,
    reconstruct_inserted,
)
from tarl_tpu.core.response import confirm_step
from tarl_tpu.core.rng import choice_gumbel, direction_gumbel
from tarl_tpu.core.step import (
    Policy,
    init_sim_state,
    run_episode,
    run_episode_periodic,
)
from tarl_tpu.core.withdraw import withdraw_agents
from tarl_tpu.io.scenarios import grid_scenario
from tarl_tpu.routing.policies import primal_entry_lookup, random_choice
from tarl_tpu.simulator import make_policy
from tarl_tpu.state import sort_agents_by_departure

from tarl_tpu_torch import convert
from tarl_tpu_torch.core import direction as p_direction
from tarl_tpu_torch.core import fused_winner as p_fused
from tarl_tpu_torch.core import insert as p_insert
from tarl_tpu_torch.core import response as p_response
from tarl_tpu_torch.core import withdraw as p_withdraw
from tarl_tpu_torch.routing import policies as p_policies

from test_torch_network import assert_tree_equal, load_both

torch.set_num_threads(1)


def _port(ref_state, pnet):
    return convert.sim_state_from_numpy(convert.to_numpy(ref_state),
                                        device="cpu")


def _np(x):
    return convert.to_numpy(x)


@pytest.fixture(scope="module")
def grid8(tmp_path_factory):
    """A Grid8x8 state 400 ticks into the default-configuration episode."""
    root = str(tmp_path_factory.mktemp("torch_core_scen"))
    net, agents, pnet, _ = load_both(root, "Grid8x8")
    sim = SimConfig(start_time=6 * 3600, record_road_optimality=False)
    policy = Policy(choice=random_choice)
    state = init_sim_state(net, agents, sim=sim, policy=policy)
    state, _ = run_episode(state, net, policy, 400, sim=sim)
    return net, pnet, state


@pytest.fixture(scope="module")
def burst(tmp_path_factory):
    """A 4x4 grid with 2,000 departures in one minute, 45 ticks into the
    exact backlog mode: capacity blocks hundreds of entrants, so the SRC
    queues hold deep backlogs while the frontier is still mid-burst."""
    root = str(tmp_path_factory.mktemp("torch_burst_scen"))
    grid_scenario(root, "Burst4", rows=4, cols=4, num_agents=2000,
                  peak_start=6 * 3600, peak_spread=60)
    net, agents, pnet, _ = load_both(root, "Burst4")
    agents = sort_agents_by_departure(agents)
    sim = SimConfig(start_time=6 * 3600, record_road_optimality=False,
                    insert_window=16, insert_backlog=1024,
                    sorted_population=True, withdraw_depth=2)
    policy = Policy(choice=random_choice)
    state = init_sim_state(net, agents, sim=sim, policy=policy)
    state, logs = run_episode(state, net, policy, 45, sim=sim)
    assert float(np.asarray(logs.window_saturated).sum()) == 0.0
    assert int(np.asarray(state.backlog.qcount).sum()) > 100
    assert int(state.insert_ptr) < agents.num_agents - 1
    return net, pnet, state


@pytest.fixture(scope="module")
def sp_states(tmp_path_factory):
    """Grid8x8 states 60 ticks into shortest-path episodes (primal tables,
    windowed insert W=64), one on the departure-sorted population and one
    on the population as loaded, keyed by ``sorted_population``."""
    root = str(tmp_path_factory.mktemp("torch_sp_core_scen"))
    net, agents, pnet, _ = load_both(root, "Grid8x8")
    policy = make_policy("dijkstra", RoutingConfig(
        refresh_rate=10, max_bf_iters=8, backend="primal"), network=net)
    out = {}
    for sort in (True, False):
        ag = sort_agents_by_departure(agents) if sort else agents
        sim = SimConfig(start_time=6 * 3600, record_road_optimality=False,
                        insert_window=64, sorted_population=sort,
                        insert_escalate=False)
        state = init_sim_state(net, ag, sim=sim, policy=policy)
        state, _ = run_episode_periodic(state, net, policy, 60, sim=sim)
        out[sort] = (net, pnet, state)
    return out


@pytest.mark.parametrize("sorted_fast,escalate,entry", [
    (sorted_fast, escalate, entry)
    for sorted_fast in (True, False)
    for escalate in (False, True)
    for entry in ("lookup", "selected_road")
] + [(True, True, "entry_road"), (False, False, "entry_road")])
def test_insert_agents_windowed(sp_states, sorted_fast, escalate, entry):
    """A window of 3 with 40 s of departures due: the overflow monitor
    reads 1 without escalation, and escalation passes run with it.  Entry
    roads come from the table per window (``entry_lookup``), from the full
    per-agent array (``entry_road``) or from ``selected_road[origin]``."""
    net, pnet, state = sp_states[sorted_fast]
    pstate = _port(state, pnet)
    lookup = plookup = entry_road = pentry_road = None
    if entry == "lookup":
        def lookup(ids):
            return primal_entry_lookup(state, net, ids)

        def plookup(ids):
            return p_policies.primal_entry_lookup(pstate, pnet, ids)
    elif entry == "entry_road":
        entry_road = primal_entry_lookup(state, net)
        pentry_road = p_policies.primal_entry_lookup(pstate, pnet)
    t = state.time + 40.0
    road, agents, ptr, sat = insert_agents_windowed(
        state.road, state.agents, state.selected_road, net, t,
        state.insert_order, state.insert_ptr, 3, entry_road=entry_road,
        entry_lookup=lookup, sorted_fast=sorted_fast, escalate=escalate)
    proad, pagents, pptr, psat = p_insert.insert_agents_windowed(
        pstate.road, pstate.agents, pstate.selected_road, pnet,
        pstate.time + 40.0, pstate.insert_order, pstate.insert_ptr, 3,
        entry_road=pentry_road, entry_lookup=plookup,
        sorted_fast=sorted_fast, escalate=escalate)
    assert_tree_equal(_np(road), _np(proad), "road")
    assert_tree_equal(_np(agents), _np(pagents), "agents")
    assert int(ptr) == pptr
    assert float(sat) == psat
    assert psat > 1.0 if escalate else psat == 1.0
    assert int(proad.count.sum()) > int(pstate.road.count.sum())


def test_insert_agents_entry_road(sp_states):
    """The whole-population insert with per-agent entry roads from the
    routing table."""
    net, pnet, state = sp_states[False]
    pstate = _port(state, pnet)
    entry = primal_entry_lookup(state, net)
    pentry = p_policies.primal_entry_lookup(pstate, pnet)
    assert_tree_equal(_np(entry), _np(pentry), "entry roads")
    t = state.time + 40.0
    road, agents = insert_agents(state.road, state.agents,
                                 state.selected_road, net, t,
                                 entry_road=entry)
    proad, pagents = p_insert.insert_agents(
        pstate.road, pstate.agents, pstate.selected_road, pnet,
        pstate.time + 40.0, entry_road=pentry)
    assert_tree_equal(_np(road), _np(proad), "road")
    assert_tree_equal(_np(agents), _np(pagents), "agents")
    assert int(proad.count.sum()) > int(pstate.road.count.sum())


def test_random_choice(grid8):
    net, pnet, state = grid8
    pstate = _port(state, pnet)
    ref, _ = random_choice(state, net)
    sub = jax.random.split(state.key)[1]
    noise = torch.as_tensor(np.array(choice_gumbel(sub, net)))
    got, _ = p_policies.random_choice(pstate, pnet, gumbel=noise)
    assert_tree_equal(_np(ref.selected_road), _np(got.selected_road))
    assert got.key == tuple(int(w) for w in np.asarray(ref.key))
    # The port's own draw (Gumbel within an ulp) picks the same roads.
    own, _ = p_policies.random_choice(pstate, pnet)
    assert_tree_equal(_np(ref.selected_road), _np(own.selected_road))


@pytest.mark.parametrize("depth", [1, 2, None])
@pytest.mark.parametrize("dt", [0.0, 150.0])
def test_withdraw(grid8, depth, dt):
    net, pnet, state = grid8
    pstate = _port(state, pnet)
    road, agents, wcount = withdraw_agents(
        state.road, state.agents, net, state.time + dt, depth=depth,
        compact=None, escalate=True)
    proad, pagents, pwcount = p_withdraw.withdraw_agents(
        pstate.road, pstate.agents, pnet, pstate.time + dt, depth=depth,
        escalate=True)
    assert_tree_equal(_np(road), _np(proad), "road")
    assert_tree_equal(_np(agents), _np(pagents), "agents")
    assert_tree_equal(_np(wcount), _np(pwcount), "wcount")
    assert int(np.asarray(wcount).sum()) > 0
    if depth == 1:
        assert int(np.asarray(wcount).max()) >= 1   # escalation pass ran


@pytest.mark.parametrize("dt", [30.0, 120.0])
def test_insert_agents(grid8, dt):
    net, pnet, state = grid8
    pstate = _port(state, pnet)
    road, agents = insert_agents(state.road, state.agents,
                                 state.selected_road, net, state.time + dt)
    proad, pagents = p_insert.insert_agents(
        pstate.road, pstate.agents, pstate.selected_road, pnet,
        pstate.time + dt)
    assert_tree_equal(_np(road), _np(proad), "road")
    assert_tree_equal(_np(agents), _np(pagents), "agents")
    assert int(np.asarray(road.count).sum()) > int(
        np.asarray(state.road.count).sum())


@pytest.mark.parametrize("window", [16, 256])
def test_backlog_frontier_append(burst, window):
    net, pnet, state = burst
    pstate = _port(state, pnet)
    ag = state.agents
    static_tab = jax.numpy.stack(
        [ag.departure, ag.origin.astype(jax.numpy.float32),
         ag.dest.astype(jax.numpy.float32)], axis=1)
    b = state.backlog
    t = state.time + 40.0
    qpack, qcount, ptr, overflow = backlog_frontier_append(
        b.qpack, b.qcount, b.qhead, static_tab, state.insert_ptr, t,
        R=net.num_roads, window=window, escalate=True)
    pb, pag = pstate.backlog, pstate.agents
    pqpack, pqcount, pptr, poverflow = p_insert.backlog_frontier_append(
        pb.qpack, pb.qcount, pb.qhead, pag.departure, pag.origin, pag.dest,
        pstate.insert_ptr, pstate.time + 40.0, num_roads=pnet.num_roads,
        window=window, escalate=True)
    assert_tree_equal(_np(qpack), _np(pqpack), "qpack")
    assert_tree_equal(_np(qcount), _np(pqcount), "qcount")
    assert int(ptr) == pptr
    assert float(overflow) == poverflow
    assert pptr > pstate.insert_ptr


@pytest.mark.parametrize("update_inserted", [True, False])
def test_insert_agents_backlogged(burst, update_inserted):
    net, pnet, state = burst
    pstate = _port(state, pnet)
    out = insert_agents_backlogged(
        state.road, state.agents, state.backlog, state.selected_road, net,
        state.time, state.insert_ptr, 16, update_inserted=update_inserted)
    pout = p_insert.insert_agents_backlogged(
        pstate.road, pstate.agents, pstate.backlog, pstate.selected_road,
        pnet, pstate.time, pstate.insert_ptr, 16,
        update_inserted=update_inserted)
    for name, a, b in zip(("road", "agents", "backlog"), out[:3], pout[:3]):
        assert_tree_equal(_np(a), _np(b), name)
    assert int(out[3]) == pout[3]
    assert float(out[4]) == pout[4]
    drained = (np.asarray(out[0].count).sum()
               - np.asarray(state.road.count).sum())
    assert drained > 0


def test_reconstruct_inserted(burst):
    net, pnet, state = burst
    pstate = _port(state, pnet)
    ref = reconstruct_inserted(state.agents, state.backlog, state.insert_ptr)
    got = p_insert.reconstruct_inserted(pstate.agents, pstate.backlog,
                                        pstate.insert_ptr)
    assert_tree_equal(_np(ref.inserted), _np(got.inserted))
    # The flag equals the one the episode maintained eagerly.
    assert_tree_equal(_np(state.agents.inserted), _np(got.inserted))


def _key(k):
    """A reference key (uint32[2]) as the port's ``Key``."""
    return tuple(int(w) for w in np.asarray(k))


def _steps(state, n):
    """``n`` consecutive (time, direction key) pairs from ``state``."""
    key, t = state.key, state.time
    for _ in range(n):
        key, k = jax.random.split(key)
        yield t, k
        t = t + 1.0


def test_direction_and_confirm_steps(grid8):
    net, pnet, state = grid8
    pstate = _port(state, pnet)
    road, proad = state.road, pstate.road
    accepted = 0
    for t, k in _steps(state, 12):
        gumbel = torch.as_tensor(np.array(direction_gumbel(k, net)))
        r1, delta, acc, win = direction_step(
            road, state.selected_road, net, t, k, DEFAULT_PHYSICS)
        p1, pdelta, pacc, pwin = p_direction.direction_step(
            proad, pstate.selected_road, pnet, float(t), gumbel)
        assert_tree_equal(_np(r1), _np(p1), "pushed road")
        for name, a, b in (("delta", delta, pdelta), ("accept", acc, pacc),
                           ("win_src", win, pwin)):
            assert_tree_equal(_np(a), _np(b), name)
        road, popped = confirm_step(r1, acc, win, net)
        proad, ppopped = p_response.confirm_step(p1, pacc, pwin)
        assert_tree_equal(_np(road), _np(proad), "popped road")
        assert_tree_equal(_np(popped), _np(ppopped), "popped")
        accepted += int(np.asarray(acc).sum())
    assert accepted > 0


def test_direction_confirm_wrapper_matches_reference(grid8):
    """The kernel wrapper (plain version on CPU), given the tick's key as
    the reference's fused winner is, and the transfer epilogue against the
    reference's ``direction_step`` + ``confirm_step``."""
    net, pnet, state = grid8
    pstate = _port(state, pnet)
    road, proad = state.road, pstate.road
    for t, k in _steps(state, 12):
        r1, delta, acc, win = direction_step(
            road, state.selected_road, net, t, k, DEFAULT_PHYSICS)
        road, popped = confirm_step(r1, acc, win, net)
        accept, win_src, agent, dest, ppopped = p_fused.direction_confirm(
            proad, pstate.selected_road, pnet, float(t), _key(k))
        assert_tree_equal(_np(acc), _np(accept), "accept")
        assert_tree_equal(_np(win), _np(win_src), "win_src")
        assert_tree_equal(_np(popped), _np(ppopped), "popped")
        # agent / dest are what the reference pushed at each tail.
        tail = (np.asarray(proad.head) + np.asarray(proad.count)) % pnet.nmax
        rows = np.arange(pnet.num_roads)
        a = np.asarray(acc)
        np.testing.assert_array_equal(
            np.where(a, np.asarray(r1.fifo_ids)[rows, tail], 0),
            agent.numpy())
        np.testing.assert_array_equal(
            np.where(a, np.asarray(r1.fifo_dest)[rows, tail], 0),
            dest.numpy())
        proad, pdelta = p_fused.apply_transfers(
            proad, pnet, float(t), accept, agent, dest, ppopped)
        assert_tree_equal(_np(road), _np(proad), "road")
        assert_tree_equal(_np(delta), _np(pdelta), "delta")


def test_direction_confirm_matches_reference_tiled(grid8, monkeypatch):
    """K8a/K8b, the column-tiled form of the reference's fused winner
    (``direction_confirm_fused_tiled``), against the port's
    ``direction_confirm`` + ``apply_transfers`` (K1's function), bitwise on
    accept, win_src, popped, the delay row and every road field.  The
    reference runs in interpret mode on a forced roll plan with exceptions,
    in tiles of 128 roads, so Grid8x8's R = 224 ends in a partial tile; both
    take the same key."""
    from tarl_tpu.core.fused_winner import direction_confirm_fused_tiled

    from test_roll_gather import _force_plan

    monkeypatch.setenv("TARL_FUSED_WINNER_INTERPRET", "1")
    monkeypatch.setenv("TARL_FUSED_TILE", "128")
    net, pnet, state = grid8
    net = _force_plan(net)
    assert net.num_roads % 128 != 0
    assert int(net.in_roll_exc_src.shape[0]) > 0
    tiled = jax.jit(lambda road, t, k: direction_confirm_fused_tiled(
        road, state.selected_road, net, t, k, DEFAULT_PHYSICS,
        compute_delta=True))
    pstate = _port(state, pnet)
    road, proad = state.road, pstate.road
    accepted = 0
    for t, k in _steps(state, 8):
        road, delta, acc, win, popped = tiled(road, t, k)
        accept, win_src, agent, dest, ppopped = p_fused.direction_confirm(
            proad, pstate.selected_road, pnet, float(t), _key(k))
        proad, pdelta = p_fused.apply_transfers(
            proad, pnet, float(t), accept, agent, dest, ppopped)
        for name, a, b in (("accept", acc, accept), ("win_src", win, win_src),
                           ("popped", popped, ppopped),
                           ("delta", delta, pdelta)):
            assert_tree_equal(_np(a), _np(b), name)
        assert_tree_equal(_np(road), _np(proad), "road")
        accepted += int(np.asarray(acc).sum())
    assert accepted > 0
