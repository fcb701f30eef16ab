"""The port's learned classical policy (``tarl_tpu_torch/rl/
learned_policy.py``, ``make_transformer_choice``) and the committed Braess
transformer weights against the JAX reference, on the CPU.

* ``rollout_context`` bitwise on a warmed Grid4x4 state, with and without
  the pending entrants and the extra columns, and with ``count`` and
  ``head_ids`` overridden.
* ``full_out_tables`` and ``slot_edge_tables`` equal the reference's on
  Grid4x4 and Braess.
* ``make_learned_choice`` with the transformer (its slot twin) and with the
  prior-equipped MPNN (``slot_logits``), deterministic and sampled from one
  key, parameters carried from a Flax ``init``: a 30-tick Grid4x4 episode
  through ``run_episode`` on both sides from the same warmed state, the
  selections equal at every tick and the final state bitwise.
* ``make_transformer_choice``: the same 30-tick episode, as the
  reference's test drives it.
* ``make_learned_choice`` in the headline's backlog mode: 60 sampled
  Grid4x4 ticks of the committed weights, in one call and in two, each
  against the reference cut alike, bitwise (a learned episode depends on
  its cut there on both sides: the reference's fault R5).
* ``tarl_tpu_torch/weights/braess_transformer_best.npz`` with the encoding
  it carries: the greedy evaluation's first 300 actions equal the
  reference's recorded ones, and the done count and TSTT after 300 steps
  equal the recorded ones; the sampled evaluation (key 3, 1,800 steps, as
  ``scripts/train_rl_demo.py`` evaluates a stochastic policy) ends with
  the reference's recorded done count, average travel time and TSTT.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tarl_tpu.config import SimConfig
from tarl_tpu.core.step import Policy, init_sim_state, run_episode
from tarl_tpu.io.matsim import load_network, load_population
from tarl_tpu.models.mpnn import MPNNPolicyNet
from tarl_tpu.models.transformer.agent import (
    TransformerRoutePolicy,
    make_transformer_choice,
    network_positional_encoding,
)
from tarl_tpu.models.transformer.slot_forward import slot_edge_tables
from tarl_tpu.rl import learned_policy as r_lp
from tarl_tpu.routing.bellman_ford import all_pairs_next_hop_nbr
from tarl_tpu.routing.policies import random_choice
from tarl_tpu.state import sort_agents_by_departure as sort_ref_agents

from tarl_tpu_torch import convert
from tarl_tpu_torch.config import RLConfig as PortRLConfig
from tarl_tpu_torch.config import SimConfig as PortSimConfig
from tarl_tpu_torch.core import rng as p_rng
from tarl_tpu_torch.core import step as p_step
from tarl_tpu_torch.io.matsim import load_network as p_load_network
from tarl_tpu_torch.io.matsim import load_population as p_load_population
from tarl_tpu_torch.io.scenarios import grid_scenario
from tarl_tpu_torch.metrics.equilibrium import tstt as p_tstt
from tarl_tpu_torch.models import mpnn as p_mpnn
from tarl_tpu_torch.models.transformer import agent as p_agent
from tarl_tpu_torch.models.transformer import slot_forward as p_slot
from tarl_tpu_torch.rl import learned_policy as p_lp
from tarl_tpu_torch.rl.env import env_reset, env_step
from tarl_tpu_torch.rl.ppo import PPO as PortPPO
from tarl_tpu_torch.routing import bellman_ford as p_bf
from tarl_tpu_torch.routing.policies import random_choice as p_random_choice
from tarl_tpu_torch.state import sort_agents_by_departure

from test_torch_network import assert_tree_equal, load_both

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, "tarl_tpu_torch", "weights",
                       "braess_transformer_best.npz")
START = 21600
WARM_TICKS = 60
TICKS = 30
CHECK_STEPS = 300


@pytest.fixture(scope="module")
def scenarios(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_lp_scen"))
    return {name: load_both(root, name) for name in ("Braess", "Grid4x4")}


@pytest.fixture(scope="module")
def warm(scenarios):
    """Grid4x4 after ``WARM_TICKS`` random ticks from 06:00 in the
    reference, and the same state in the port."""
    net, agents, pnet, _ = scenarios["Grid4x4"]
    sim = SimConfig(start_time=START)
    pol = Policy(choice=random_choice)
    st, _ = run_episode(init_sim_state(net, agents, sim=sim, policy=pol),
                        net, pol, WARM_TICKS, sim=sim)
    assert int(np.asarray(st.road.count).sum()) > 0
    return net, pnet, st, convert.sim_state_from_numpy(
        convert.to_numpy(st), device="cpu")


def _tree(state) -> dict:
    return convert.to_numpy(state)


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pending,extra", [(False, False), (True, False),
                                           (False, True), (True, True)])
def test_rollout_context_is_bitwise(warm, pending, extra):
    net, pnet, st, pst = warm
    want = r_lp.rollout_context(st, net, pending, extra_obs=extra)
    got = p_lp.rollout_context(pst, pnet, pending, extra_obs=extra)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # Overridden road state: the counts and heads of another state.
    count = np.asarray(st.road.count)[::-1].copy()
    heads = np.asarray(st.road.head_ids())[::-1].copy()
    want = r_lp.rollout_context(st, net, pending, jnp.asarray(count),
                                jnp.asarray(heads), extra_obs=extra)
    got = p_lp.rollout_context(pst, pnet, pending, torch.as_tensor(count),
                               torch.as_tensor(heads), extra_obs=extra)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("scenario", ["Braess", "Grid4x4"])
def test_slot_tables_equal_the_references(scenarios, scenario):
    net, _, pnet, _ = scenarios[scenario]
    for want, got in zip(r_lp.full_out_tables(net),
                         p_lp.full_out_tables(pnet)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.dtype == getattr(torch, str(np.asarray(want).dtype))
    want = slot_edge_tables(net)
    got = p_slot.slot_edge_tables(pnet)
    assert_tree_equal(convert.to_numpy(want), convert.to_numpy(got),
                      "slot tables")


# ---------------------------------------------------------------------------
def _nets(net, pnet, kind: str, x):
    """The reference's and the port's policy net, Flax parameters and
    their state dict, and the distance prior of each (MPNN only)."""
    n, e = net.num_nodes, net.num_full_edges
    ef = jnp.ones((e, 1), jnp.float32)
    if kind == "transformer":
        pe = network_positional_encoding(net, 16)
        ref = TransformerRoutePolicy(pe=pe)
        port = p_agent.TransformerRoutePolicy(pe)
        dist = pdist = None
        fp = ref.init(jax.random.PRNGKey(0), x, ef, net.full_src,
                      net.full_dst)
    else:
        ref = MPNNPolicyNet(num_nodes=n, num_node_embeddings=net.num_roads + 1,
                            use_distance_prior=True, prior_scale=30.0)
        port = p_mpnn.MPNNPolicyNet(n, net.num_roads + 1,
                                    use_distance_prior=True, prior_scale=30.0)
        dist, _ = all_pairs_next_hop_nbr(net.nbr, net.nbr_ok,
                                         net.entry_cost())
        pdist, _ = p_bf.all_pairs_next_hop_nbr(pnet.nbr, pnet.nbr_ok,
                                               pnet.entry_cost())
        fp = ref.init(jax.random.PRNGKey(0), x, ef, net.full_src,
                      net.full_dst, dist)
    params = convert.mpnn_params_from_numpy(
        {"policy": jax.tree.map(np.asarray, fp), "value": {}},
        device="cpu")["policy"]
    return ref, port, fp, params, dist, pdist


def _episodes(net, pnet, st, pst, policy, ppolicy, sim, psim):
    """``TICKS`` ticks of ``run_episode`` a tick at a time on both sides;
    asserts equal selections every tick and returns the final states."""
    for t in range(TICKS):
        st, _ = run_episode(st, net, policy, 1, sim=sim)
        pst, _ = p_step.run_episode(pst, pnet, ppolicy, 1, sim=psim)
        np.testing.assert_array_equal(pst.selected_road.numpy(),
                                      np.asarray(st.selected_road),
                                      err_msg=f"tick {t}")
    return st, pst


@pytest.mark.parametrize("deterministic", [True, False])
@pytest.mark.parametrize("kind", ["transformer", "mpnn"])
def test_learned_choice_episode_equals_the_references(warm, kind,
                                                      deterministic):
    net, pnet, st, pst = warm
    x = r_lp.rollout_context(st, net)
    ref, port, fp, params, dist, pdist = _nets(net, pnet, kind, x)
    policy = r_lp.make_learned_choice(ref, fp, net,
                                      deterministic=deterministic, dist=dist)
    ppolicy = p_lp.make_learned_choice(port, params, pnet,
                                       deterministic=deterministic,
                                       dist=pdist)
    assert ppolicy.learned.params is params
    assert (ppolicy.learned.slot_net is not None) == (kind == "transformer")
    sim, psim = SimConfig(start_time=START), PortSimConfig(start_time=START)
    before = np.asarray(st.selected_road)
    st, pst = _episodes(net, pnet, st, pst, policy, ppolicy, sim, psim)
    assert_tree_equal(_tree(st), _tree(pst), f"{kind} final state")
    assert (np.asarray(st.selected_road) != before).any()


def test_transformer_choice_episode_equals_the_references(warm):
    net, pnet, st, pst = warm
    x = r_lp.rollout_context(st, net)
    ref, port, fp, params, _, _ = _nets(net, pnet, "transformer", x)
    policy = Policy(choice=make_transformer_choice(ref, fp, net))
    ppolicy = p_step.Policy(choice=p_agent.make_transformer_choice(
        port, params, pnet))
    sim, psim = SimConfig(start_time=START), PortSimConfig(start_time=START)
    st, pst = _episodes(net, pnet, st, pst, policy, ppolicy, sim, psim)
    assert_tree_equal(_tree(st), _tree(pst), "final state")
    sel = pst.selected_road.numpy()[:pnet.num_roads]
    assert (sel >= 0).all()


@pytest.mark.parametrize("cuts", [(60,), (15, 45)])
def test_learned_backlog_episode_equals_the_references(tmp_path, cuts):
    """1,000 commuters over 06:00-06:05 on Grid4x4 in the headline's exact
    mode (backlog Q=256, W=32, both escalations), 60 ticks of the
    committed Braess weights sampled, with one encoding, cut into the same
    ``run_episode`` calls on both sides: the final state bitwise.  Backlog
    mode keeps ``agents.inserted`` lazily within a call, so the cut is part
    of the episode (the reference's fault R5): both sides must make it
    alike."""
    grid_scenario(str(tmp_path), "g", rows=4, cols=4, num_agents=1000,
                  peak_start=START, peak_spread=300)
    base = os.path.join(str(tmp_path), "g")
    net_path = os.path.join(base, "network")
    pop_path = os.path.join(base, "population")
    net = load_network(net_path)
    agents = sort_ref_agents(load_population(pop_path, net_path)[0])
    pnet = p_load_network(net_path, device="cpu")
    pagents = sort_agents_by_departure(
        p_load_population(pop_path, net_path, device="cpu")[0])
    tree = convert.load_params_npz(WEIGHTS)
    pe = p_agent.network_positional_encoding(pnet, 16)
    policy = r_lp.make_learned_choice(
        TransformerRoutePolicy(pe=jnp.asarray(pe)),
        jax.tree.map(jnp.asarray, tree["policy"]), net)
    ppolicy = p_lp.make_learned_choice(
        p_agent.TransformerRoutePolicy(pe),
        convert.mpnn_params_from_numpy(tree, device="cpu")["policy"],
        pnet)
    kw = dict(timestep=1, start_time=START, end_time=START + 600,
              record_road_optimality=False, insert_window=32,
              insert_backlog=256, withdraw_depth=2, sorted_population=True,
              insert_escalate=True, withdraw_escalate=True)
    sim, psim = SimConfig(**kw), PortSimConfig(**kw)
    st = init_sim_state(net, agents, sim=sim, policy=policy)
    pst = p_step.init_sim_state(pnet, pagents, sim=psim, policy=ppolicy)
    for n in cuts:
        st, _ = run_episode(st, net, policy, n, sim=sim)
        pst, _ = p_step.run_episode(pst, pnet, ppolicy, n, sim=psim)
    assert_tree_equal(_tree(st), _tree(pst), "state")
    assert int(pst.road.count.sum()) > 100


# ---------------------------------------------------------------------------
def _braess(scenarios):
    """The committed weights' tree and state dicts, the recorded run's PPO
    (``scripts/train_rl_demo.py``'s RL settings) with their encoding, and
    Braess's reset state."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import train_rl_demo

    _, _, pnet, pagents = scenarios["Braess"]
    tree = convert.load_params_npz(WEIGHTS)
    params = convert.mpnn_params_from_numpy(tree, device="cpu")
    pe = tree["pe"]
    ppo = PortPPO(pnet, p_agent.TransformerRoutePolicy(pe),
                  p_agent.TransformerValueNet(pe),
                  rl=PortRLConfig(**train_rl_demo.RL), value_uses_graph=True)
    pst = p_step.init_sim_state(pnet, pagents,
                                policy=p_step.Policy(choice=p_random_choice))
    return tree, params, ppo, pst


def test_committed_braess_weights_reproduce_the_recorded_evaluation(
        scenarios):
    tree, params, ppo, pst = _braess(scenarios)
    pnet = ppo.network
    key = p_rng.prng_key(0)
    env, obs = env_reset(pst, pnet, ppo.rl, ppo.physics, ppo._dist_ff)
    actions = []
    for _ in range(CHECK_STEPS):
        key, k = p_rng.split(key)
        action = ppo.act(params, env, obs, k)
        actions.append(action.numpy())
        env, obs, *_ = env_step(env, action, pnet, ppo.rl, ppo.sim_cfg,
                                ppo.physics, dist_ff=ppo._dist_ff)
    want = tree["reference"][f"actions_{CHECK_STEPS}"]
    np.testing.assert_array_equal(np.stack(actions), want)
    final, *_ = ppo.eval_rollout(params, pst, p_rng.prng_key(0),
                                 CHECK_STEPS)
    assert_tree_equal(_tree(env.sim), _tree(final.sim), "eval_rollout")
    rec = tree["reference"][f"eval_{CHECK_STEPS}"]
    a = final.sim.agents
    assert int(a.done[1:].sum()) == int(rec["done"])
    assert np.float32(p_tstt(a, final.sim.time)) == rec["tstt"]


def test_committed_braess_weights_reproduce_the_sampled_evaluation(
        scenarios):
    tree, params, ppo, pst = _braess(scenarios)
    env, *_ = ppo.eval_rollout(params, pst, p_rng.prng_key(3), 1800,
                               deterministic=False)
    rec = tree["reference"]["sampled_1800"]
    a = env.sim.agents
    assert int(a.done[1:].sum()) == int(rec["done"]) > 0
    assert np.float32(p_step.average_travel_time(a)) == \
        rec["avg_travel_time"]
    assert np.float32(p_tstt(a, env.sim.time)) == rec["tstt"]
