"""The fused edge-phase core (``SimConfig.fused_core``) against the JAX
reference, on the CPU.

The reference's sampler draws its noise from the TPU's hardware generator,
which interpret mode stubs to zeros; the port's plain version takes a
``bits`` override, and zero bits reproduce that stream exactly.  So:

* (i) the payload function with zero bits equals the reference's
  ``gumbel_argmax_payload`` bitwise (``a`` and ``min(b, S)``) on seeded
  cases of more than two of its 512-edge tiles, with empty segments,
  ``-inf`` logits and exact ties;
* (ii) ``fused_core_step`` equals the reference's bitwise (every road
  field, ``popped``, ``road_delta_tt``) on the cases of
  ``tests/test_fused_core.py`` and ``tests/test_core_physics.py``, with
  and without the delay row;
* (iii) the port's noise bits are ``jax.random.bits(k_dir, (E,))``
  bitwise, and its transform equals the reference kernel's to 1e-6,
  relative and absolute (two libm ``log`` calls, each may round an ulp
  apart; the noise lies in [-2.8, 16.2], where an ulp is at most 2e-6);
* (iv) on a merge of two upstreams with edge weights 0.8 and 0.2, the
  port's win frequency over 4,000 keys, with its own noise, lies within 4
  binomial sigma of 0.8, and so does the reference's ``direction_step``;
* (v) a Grid4x4 episode with ``fused_core=True`` equals the reference's
  ``run_episode`` bitwise (final state, key included, and every
  ``TickLog`` field).  The reference takes its fused branch only where
  ``jax.default_backend()`` reads ``"tpu"``; the test hands its tick a
  ``jax`` whose ``default_backend`` says so, under interpret mode;
* (vi) the edge phase in one call, ``fused_core_sample_plain`` with zero
  bits, equals what the reference's ``fused_core_step`` computes and hands
  its sampler: the logits bitwise, and the sampler's two payloads, on
  seeded random road states of Grid4x4, Grid8x8 and a 40-spoke hub (each
  hub road has 40 incoming turn edges: the kernel's lanes past 32) with
  stuck heads past ``gridlock_patience``, full roads and exact weight
  ties.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import tarl_tpu.core.fused_core as ref_fused_core
import tarl_tpu.core.step as ref_step
from tarl_tpu.config import SimConfig
from tarl_tpu.core.direction import direction_step
from tarl_tpu.core.fused_core import fused_core_step as ref_fused_core_step
from tarl_tpu.core.fused_core import gumbel_argmax_payload as ref_payload
from tarl_tpu.network import build_network as ref_build_network
from tarl_tpu.routing.policies import random_choice
from tarl_tpu.state import RoadState as RefRoadState
from tarl_tpu.state import init_road_state as ref_init_road_state

from tarl_tpu_torch import convert
from tarl_tpu_torch.config import SimConfig as PortSimConfig
from tarl_tpu_torch.core import fused_core, rng
from tarl_tpu_torch.core import step as p_step
from tarl_tpu_torch.config import DEFAULT_PHYSICS
from tarl_tpu_torch.network import build_network
from tarl_tpu_torch.routing.policies import random_choice as p_random_choice
from tarl_tpu_torch.state import RoadState

from test_torch_network import assert_tree_equal, load_both

torch.set_num_threads(1)


def zero_bits_payload(logits, segment_ids, payload_a, payload_b, key,
                      num_segments, layout=None):
    """The port's plain sampler with zero noise bits: the reference's
    interpret-mode stream."""
    bits = torch.zeros(logits.shape[0], dtype=torch.int64)
    return fused_core.gumbel_argmax_payload_plain(
        logits, segment_ids, payload_a, payload_b, key, num_segments,
        layout, bits=bits)


def zero_noise(road, selected_road, network, time, key, physics=None):
    """The port's plain edge phase with zero noise bits (the
    ``payload=`` hook of ``fused_core_step`` and ``run_episode``)."""
    bits = torch.zeros(network.edge_src.shape[0], dtype=torch.int64)
    return fused_core.fused_core_sample_plain(
        road, selected_road, network, time, key,
        *(() if physics is None else (physics,)), bits=bits)


# --- (i) the payload function ---------------------------------------------

@pytest.mark.parametrize("e,s,seed", [(1100, 37, 0), (1500, 300, 1),
                                      (2600, 130, 2)])
def test_payload_function_matches_reference(e, s, seed):
    g = np.random.default_rng(seed)
    logits = g.normal(size=e).astype(np.float32)
    logits[::3] = np.round(logits[::3] * 2.0) / 2.0       # exact ties
    logits[g.integers(0, e, e // 10)] = -np.inf
    # A third of the segments receive no element; one keeps only -inf.
    live = np.sort(g.choice(s, size=2 * s // 3, replace=False))
    ids = live[g.integers(0, live.size, e)].astype(np.int32)
    logits[ids == live[0]] = -np.inf
    pay_a = g.integers(1, 1 << 20, e).astype(np.int32)
    pay_b = g.integers(0, s, e).astype(np.int32)
    with pltpu.force_tpu_interpret_mode():
        ra, rb = ref_payload(jnp.asarray(logits), jnp.asarray(ids),
                             jnp.asarray(pay_a, jnp.float32),
                             jnp.asarray(pay_b, jnp.float32), 12345, s)
    pa, pb = zero_bits_payload(torch.as_tensor(logits), torch.as_tensor(ids),
                               torch.as_tensor(pay_a), torch.as_tensor(pay_b),
                               rng.prng_key(seed), s)
    assert pa.dtype == pb.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(ra).astype(np.int32), pa.numpy())
    np.testing.assert_array_equal(
        np.minimum(np.asarray(rb).astype(np.int64), s), pb.numpy())
    empty = ~np.isin(np.arange(s), ids) | (np.arange(s) == live[0])
    assert empty.sum() > s // 4
    assert (pa.numpy()[empty] == 0).all() and (pb.numpy()[empty] == s).all()
    assert (pa.numpy()[~empty] > 0).all()


# --- (ii) the step ----------------------------------------------------------

CHAIN = dict(length=[75.0] * 3, max_flow=[10.0] * 3, free_speed=[7.5] * 3,
             perm_lanes=[1.0] * 3, from_inter=[0, 1, 2], to_inter=[1, 2, 0],
             num_intersections=3)
MERGE = dict(length=[75.0] * 4, max_flow=[30.0, 10.0, 10.0, 10.0],
             free_speed=[7.5] * 4, perm_lanes=[1.0] * 4,
             from_inter=[0, 1, 2, 3], to_inter=[2, 2, 3, 0],
             num_intersections=4)


def _networks(spec):
    arrays = {k: (np.asarray(v) if isinstance(v, list) else v)
              for k, v in spec.items()}
    return ref_build_network(**arrays), build_network(**arrays, device="cpu")


def _seed(road, r, agent_id, dep, arrival=None):
    road = road._replace(
        fifo_ids=road.fifo_ids.at[r, 0].set(agent_id),
        fifo_departure=road.fifo_departure.at[r, 0].set(dep),
        count=road.count.at[r].set(1),
    )
    if arrival is not None:
        road = road._replace(fifo_arrival=road.fifo_arrival.at[r, 0].set(
            arrival))
    return road


def _case(name):
    """``(spec, reference road, selections, time)`` of one case."""
    if name == "competing":
        net, _ = _networks(MERGE)
        road = ref_init_road_state(net.num_roads, net.nmax)
        road = _seed(_seed(road, 0, 5, 0.0), 1, 6, 0.0)
        return MERGE, road, [2, 2, 3, 0] + [-1] * 8, 10.0
    net, _ = _networks(CHAIN)
    road = ref_init_road_state(net.num_roads, net.nmax)
    sel, t = [1, 2, 0] + [-1] * 6, 10.0
    if name == "single_transfer":
        road = _seed(road, 0, 7, 5.0)
    elif name == "blocked_before_departure":
        road = _seed(road, 0, 7, 50.0)
    elif name == "wrong_selection":
        road = _seed(road, 0, 7, 0.0)
        sel = [2, 2, 0] + [-1] * 6
    elif name == "full_downstream":
        road = _seed(road, 0, 7, 0.0)
        road = road._replace(count=road.count.at[1].set(
            int(net.capacity[1]) - 3))
    elif name == "conservation":
        for r, aid in ((0, 1), (1, 2), (2, 3)):
            road = _seed(road, r, aid, 0.0)
    elif name == "road_delta":
        road = _seed(road, 0, 7, 42.0, arrival=0.0)
        t = 50.0
    elif name == "no_ghost":
        # A wrapped, emptied road whose stale head looks stuck.
        road = road._replace(
            fifo_ids=road.fifo_ids.at[0, 2].set(9),
            fifo_departure=road.fifo_departure.at[0, 2].set(1.0),
            head=road.head.at[0].set(2))
        t = 100.0
    return CHAIN, road, sel, t


STEP_CASES = ["single_transfer", "blocked_before_departure",
              "wrong_selection", "full_downstream", "conservation",
              "competing", "road_delta", "no_ghost"]


def _port_road(road):
    return RoadState(**{k: torch.as_tensor(np.array(v)) for k, v in
                        convert.to_numpy(road).items()})


@pytest.mark.parametrize("compute_delta", [False, True])
@pytest.mark.parametrize("name", STEP_CASES)
def test_fused_core_step_matches_reference(name, compute_delta):
    spec, road, sel, t = _case(name)
    net, pnet = _networks(spec)
    with pltpu.force_tpu_interpret_mode():
        r_road, r_popped, r_delta = ref_fused_core_step(
            road, jnp.asarray(sel, jnp.int32), net, jnp.float32(t),
            jax.random.PRNGKey(0), compute_delta=compute_delta)
    p_road, p_popped, p_delta = fused_core.fused_core_step(
        _port_road(road), torch.as_tensor(sel, dtype=torch.int32), pnet, t,
        rng.prng_key(0), compute_delta=compute_delta, payload=zero_noise)
    assert_tree_equal(convert.to_numpy(r_road), convert.to_numpy(p_road),
                      "road")
    assert_tree_equal(np.asarray(r_popped), p_popped.numpy(), "popped")
    assert_tree_equal(np.asarray(r_delta), p_delta.numpy(), "road_delta_tt")
    assert int(p_road.count.min()) >= 0
    moved = int(p_popped.sum())
    if name in ("single_transfer", "competing"):
        assert moved == 1
    elif name == "conservation":
        assert moved == 3 and p_road.head_ids().tolist() == [3, 1, 2]
    elif name != "road_delta":
        assert moved == 0
    if compute_delta and name == "road_delta":
        assert float(p_delta[0]) > 0.0


# --- (iii) the noise --------------------------------------------------------

@pytest.mark.parametrize("seed,e", [(0, 160), (3, 5000)])
def test_noise_bits_and_transform(seed, e):
    jkey = jax.random.split(jax.random.PRNGKey(seed))[1]
    pkey = rng.split(rng.prng_key(seed))[1]
    want = np.asarray(jax.random.bits(jkey, (e,))).astype(np.int64)
    bits = rng.random_bits(pkey, (e,), "cpu")
    np.testing.assert_array_equal(want, bits.numpy())
    # The reference kernel's transform, as jnp computes it.
    u = (jnp.asarray(want >> 8, jnp.int32).astype(jnp.float32)
         * (1.0 / (1 << 24)))
    ref_g = np.asarray(-jnp.log(-jnp.log(u + 1e-7) + 1e-7))
    np.testing.assert_allclose(rng.payload_gumbel(bits).numpy(), ref_g,
                               rtol=1e-6, atol=1e-6)
    zero = rng.payload_gumbel(torch.zeros(1, dtype=torch.int64))
    assert float(zero) == float(-np.log(-np.log(np.float32(1e-7))
                                        + np.float32(1e-7)).astype(
        np.float32))


# --- (iv) the law -----------------------------------------------------------

def test_win_frequency_follows_edge_weights():
    """Edges 0->2 and 1->2 weighted 0.8 and 0.2: road 0's head wins with
    probability 0.8 in the port (its own noise) and in the reference's
    default core, each within 4 binomial sigma over 4,000 keys."""
    net, pnet = _networks(MERGE)
    attr = np.array([0.8, 0.2, 1.0, 1.0], np.float32)
    assert net.edge_src.tolist() == [0, 1, 2, 3]
    assert net.edge_dst.tolist() == [2, 2, 3, 0]
    logit_tab = np.array(net.in_logit_tab)
    logit_tab[0, 2], logit_tab[1, 2] = np.log(attr[0]), np.log(attr[1])
    net = net.replace(edge_attr=jnp.asarray(attr),
                      in_logit_tab=jnp.asarray(logit_tab))
    pnet = dataclasses.replace(pnet, edge_attr=torch.as_tensor(attr),
                               in_logit_tab=torch.as_tensor(logit_tab))
    road = ref_init_road_state(net.num_roads, net.nmax)
    road = _seed(_seed(road, 0, 5, 0.0), 1, 6, 0.0)
    sel = [2, 2, 3, 0] + [-1] * 8
    proad = _port_road(road)
    psel = torch.as_tensor(sel, dtype=torch.int32)
    n, p = 4000, 0.8
    wins = 0
    for i in range(n):
        out, popped, _ = fused_core.fused_core_step(
            proad, psel, pnet, 10.0, rng.prng_key(i))
        assert int(popped.sum()) == 1
        wins += int(popped[0])
    sigma = np.sqrt(n * p * (1 - p))
    assert abs(wins - n * p) <= 4 * sigma, wins

    jsel = jnp.asarray(sel, jnp.int32)

    def winner(k):
        return direction_step(road, jsel, net, jnp.float32(10.0), k)[3][2]

    keys = jax.random.split(jax.random.PRNGKey(1), n)
    ref_wins = int((np.asarray(jax.jit(jax.vmap(winner))(keys)) == 0).sum())
    assert abs(ref_wins - n * p) <= 4 * sigma, ref_wins


# --- (v) the slice as a whole ----------------------------------------------

class _TpuBackendJax:
    """``jax`` with ``default_backend()`` reading ``"tpu"``."""

    def __init__(self, real):
        self._real = real

    def __getattr__(self, name):
        return getattr(self._real, name)

    @staticmethod
    def default_backend():
        return "tpu"


def test_fused_core_episode_matches_reference(tmp_path, monkeypatch):
    steps = 300
    net, agents, pnet, pagents = load_both(str(tmp_path), "Grid4x4")
    cfg = dict(start_time=6 * 3600, fused_core=True)
    sim = SimConfig(**cfg)
    policy = ref_step.Policy(choice=random_choice)
    state = ref_step.init_sim_state(net, agents, sim=sim, policy=policy)
    monkeypatch.setattr(ref_step, "jax", _TpuBackendJax(jax))
    with pltpu.force_tpu_interpret_mode():
        final, logs = ref_step.run_episode(state, net, policy, steps, sim=sim)

    psim = PortSimConfig(**cfg)
    ppolicy = p_step.Policy(choice=p_random_choice)
    pstate = p_step.init_sim_state(pnet, pagents, sim=psim, policy=ppolicy)
    pfinal, plogs = p_step.run_episode(pstate, pnet, ppolicy, steps,
                                       sim=psim, payload=zero_noise)

    assert_tree_equal(convert.to_numpy(final), convert.to_numpy(pfinal),
                      "final state")
    assert_tree_equal(convert.to_numpy(logs), convert.to_numpy(plogs), "logs")
    assert tuple(pfinal.key) == tuple(int(k) for k in np.asarray(final.key))
    assert int(pfinal.agents.done.sum()) > 0
    assert int(pfinal.road.count.sum()) == int(pfinal.agents.on_way.sum())


# --- (vi) the edge phase in one call ---------------------------------------

def _hub_spec(spokes):
    """A hub intersection 0 with ``spokes`` two-way spokes: each road out
    of the hub has an incoming turn edge from every road into it."""
    frm = [i for k in range(1, spokes + 1) for i in (k, 0)]
    to = [i for k in range(1, spokes + 1) for i in (0, k)]
    n = len(frm)
    return dict(length=np.full(n, 200.0), max_flow=np.full(n, 600.0),
                free_speed=np.full(n, 13.9), perm_lanes=np.ones(n),
                from_inter=np.asarray(frm), to_inter=np.asarray(to),
                num_intersections=spokes + 1)


@pytest.fixture(scope="module")
def sample_networks(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_fc_sample"))
    out = {}
    for name in ("Grid4x4", "Grid8x8"):
        net, _, pnet, _ = load_both(os.path.join(root, name), name)
        out[name] = (net, pnet)
    out["hub40"] = _networks(_hub_spec(40))
    return out


def _random_heads(pnet, g, t):
    """Seeded ring state arrays and selections: a third of the roads full,
    head departures from 60 s before ``t`` (stuck past the patience) to
    40 s after it, distinct agents >= 1, a random valid selection per
    node."""
    r, nmax = pnet.num_roads, pnet.nmax
    cap = pnet.capacity.numpy().astype(np.int64)
    count = np.where(g.random(r) < 1 / 3, cap, g.integers(0, cap + 1))
    head = g.integers(0, nmax, size=r)
    live = (np.arange(nmax)[None, :] - head[:, None]) % nmax < count[:, None]
    ids = np.where(live, (g.permutation(r * nmax) + 1).reshape(r, nmax), 0)
    dep = np.where(live, t + g.integers(-60, 40, (r, nmax)), 0.0)
    dst = np.where(live, g.integers(0, pnet.num_nodes, (r, nmax)), 0)
    ok, tab = pnet.choice_ok.numpy(), pnet.choice_dst_tab.numpy()
    nslots = ok.sum(axis=0)
    pick = (g.random(pnet.num_nodes) * np.maximum(nslots, 1)).astype(int)
    sel = np.where(nslots > 0, tab[pick, np.arange(pnet.num_nodes)], -1)
    return dict(fifo_ids=ids.astype(np.int32),
                fifo_arrival=(dep - 30.0).astype(np.float32),
                fifo_departure=dep.astype(np.float32),
                fifo_dest=dst.astype(np.int32),
                head=head.astype(np.int32),
                count=count.astype(np.int32)), sel.astype(np.int32)


@pytest.mark.parametrize("name", ["Grid4x4", "Grid8x8", "hub40"])
def test_fused_sample_matches_reference_eligibility(sample_networks, name,
                                                    monkeypatch):
    net, pnet = sample_networks[name]
    g = np.random.default_rng(7)
    # Weights from three values: exact ties among a road's in-edges.
    attr = g.choice(np.float32([0.25, 0.5, 1.0]), pnet.edge_src.shape[0])
    net = net.replace(edge_attr=jnp.asarray(attr))
    pnet = dataclasses.replace(pnet, edge_attr=torch.as_tensor(attr))
    seen = []

    def capture(logits, v, pay_a, pay_b, seed, r):
        out = ref_payload(logits, v, pay_a, pay_b, seed, r)
        seen.append((np.asarray(logits), *(np.asarray(o) for o in out)))
        return out

    monkeypatch.setattr(ref_fused_core, "gumbel_argmax_payload", capture)
    r = pnet.num_roads
    u = pnet.edge_src.numpy()
    escapes = winners = 0
    for i in range(3):
        t = 6 * 3600.0 + 11.0 * i
        fields, sel = _random_heads(pnet, g, t)
        road = RefRoadState(**{k: jnp.asarray(v) for k, v in fields.items()})
        with pltpu.force_tpu_interpret_mode():
            ref_fused_core_step(road, jnp.asarray(sel), net, jnp.float32(t),
                                jax.random.PRNGKey(i))
        r_logits, r_agent, r_src = seen.pop()
        proad = RoadState(**{k: torch.as_tensor(v)
                             for k, v in fields.items()})
        psel = torch.as_tensor(sel)
        logits = fused_core.edge_logits(proad, psel, pnet, t)
        np.testing.assert_array_equal(r_logits, logits.numpy())
        agent, src = zero_noise(proad, psel, pnet, t, rng.prng_key(i))
        np.testing.assert_array_equal(r_agent.astype(np.int32),
                                      agent.numpy())
        np.testing.assert_array_equal(
            np.minimum(r_src.astype(np.int64), r), src.numpy())
        winners += int((agent > 0).sum())
        # Edges that only the gridlock escape made eligible.
        cnt = fields["count"].astype(np.float32)
        cap = pnet.capacity.numpy()
        hd = np.where(cnt > 0, fields["fifo_departure"][
            np.arange(r), fields["head"]], 0.0)[u]
        buf = DEFAULT_PHYSICS.congestion_buffer
        v = pnet.edge_dst.numpy()
        normal = (hd <= t) & (cnt[v] < cap[v] - buf)
        escapes += int(((r_logits > -np.inf) & ~normal).sum())
    assert winners > 0
    assert escapes > 0, "no edge took the gridlock escape"
