"""The port's spatially sharded PPO (``parallel/spatial_ppo.py``) against
the JAX reference's ``SpatialPPO`` on its 8-device CPU mesh, and against
the port's own unsharded rollout.

Braess, the MPNN with its distance prior, 8 collection steps, two epochs
of two minibatches of 4 (the reference's ``tests/test_spatial_ppo.py``
settings), parameters and state carried from the reference's ``init``;
the port on 8 blocks, as the reference, and on 3 (Braess's roads and
nodes padded).

* ``rollout`` in the ``on_network`` and ``progress`` modes: actions,
  dones, the clock and ``on_network`` bitwise the reference's sharded
  rollout's; the rewards bitwise in ``on_network`` and at rtol 1e-6, atol
  1e-5 in ``progress`` (block sums of the potential); the contexts within
  1e-6; log-probs and values at rtol 1e-5, atol 1e-6.  Against the port's
  ``PPO.collect_rollout`` the same, and the contexts and values bitwise.
* Grid4x4 with the episode's end 20 s after its start: a rollout of 32
  steps crosses an auto-reset, and equals ``collect_rollout`` (K7's plain
  version here) at those bars, in ``throughput`` and ``system`` too.
* One ``train_iteration`` (``on_network``) against the reference's: the
  average reward at rtol 1e-6, the loss at rtol 1e-4, atol 1e-5, the
  parameters at rtol 1e-3, atol 5e-3, the carried counts and clock
  bitwise; and the final environment, observation and key bitwise the
  port's unsharded iteration's.
* The reference's refusals: a windowed insert, the ``individual`` reward,
  ``congested_potential``; and an attention net.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from tarl_tpu.config import RLConfig
from tarl_tpu.core.step import Policy, init_sim_state
from tarl_tpu.models import mpnn as r_mpnn
from tarl_tpu.parallel.spatial_ppo import SpatialPPO as RefSpatialPPO
from tarl_tpu.parallel.spatial_ppo import make_spatial_mesh as ref_mesh
from tarl_tpu.rl.ppo import PPO
from tarl_tpu.routing.policies import random_choice

from tarl_tpu_torch import convert
from tarl_tpu_torch.config import RLConfig as PortRLConfig
from tarl_tpu_torch.config import SimConfig as PortSimConfig
from tarl_tpu_torch.core import rng as p_rng
from tarl_tpu_torch.core import step as p_step
from tarl_tpu_torch.core.fused_winner import fused_shard_winner
from tarl_tpu_torch.models import mpnn as p_mpnn
from tarl_tpu_torch.models.transformer import agent as p_agent
from tarl_tpu_torch.parallel.spatial_ppo import SpatialPPO, make_spatial_mesh
from tarl_tpu_torch.rl.ppo import PPO as PortPPO
from tarl_tpu_torch.routing.policies import random_choice as p_random_choice

from test_torch_network import assert_tree_equal, load_both

torch.set_num_threads(1)

RL_KW = dict(rollout_steps=8, minibatch_size=4, num_epochs=2,
             entropy_coef=0.01)
EXACT = ("action", "done", "time", "on_network")


def _key(k) -> tuple:
    return tuple(int(w) for w in np.asarray(k))


def _port_ppo(pnet, **kw):
    return PortPPO(pnet, p_mpnn.MPNNPolicyNet(
        pnet.num_nodes, pnet.num_roads + 1, use_distance_prior=True,
        prior_scale=30.0), p_mpnn.MPNNValueNetSimple(pnet.num_nodes),
        rl=PortRLConfig(**{**RL_KW, **kw}))


def _both(scen, **kw):
    net, agents, pnet, pagents = scen
    st = init_sim_state(net, agents, policy=Policy(choice=random_choice))
    pst = p_step.init_sim_state(pnet, pagents,
                                policy=p_step.Policy(choice=p_random_choice))
    ref = PPO(net, r_mpnn.MPNNPolicyNet(
        num_nodes=net.num_nodes, num_node_embeddings=net.num_roads + 1,
        use_distance_prior=True, prior_scale=30.0),
        r_mpnn.MPNNValueNetSimple(), rl=RLConfig(**{**RL_KW, **kw}))
    port = _port_ppo(pnet, **kw)
    ts = ref.init(st, jax.random.PRNGKey(0))
    params = convert.mpnn_params_from_numpy(
        jax.tree.map(np.asarray, ts.params), device="cpu")
    pts = port.init(pst, p_rng.prng_key(0), torch.Generator())
    pts = pts._replace(params=params, opt_state=port.optimizer.init(params),
                       key=_key(ts.key))
    return ref, port, ts, pts


def _check_traj(want, got, mode: str, exact_floats: bool = False) -> None:
    for f in EXACT:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    w_reward, g_reward = np.asarray(want.reward), got.reward.numpy()
    if mode == "progress":
        np.testing.assert_allclose(g_reward, w_reward, rtol=1e-6, atol=1e-5)
    else:
        np.testing.assert_array_equal(g_reward, w_reward)
    if exact_floats:
        np.testing.assert_array_equal(got.x.numpy(), np.asarray(want.x))
        np.testing.assert_array_equal(got.value.numpy(),
                                      np.asarray(want.value))
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=1e-6,
                               atol=1e-6)
    for f in ("log_prob", "value"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-5,
                                   atol=1e-6, err_msg=f)


@pytest.fixture(scope="module")
def scenarios(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_spatial"))
    return {name: load_both(root, name) for name in ("Braess", "Grid4x4")}


@pytest.fixture(scope="module", params=["on_network", "progress"])
def runs(request, scenarios):
    mode = request.param
    ref, port, ts, pts = _both(scenarios["Braess"], reward_mode=mode)
    ref_sp = RefSpatialPPO(ref, ref_mesh(8))
    return dict(mode=mode, ref=ref, ref_sp=ref_sp, port=port, ts=ts,
                pts=pts, want=ref_sp.rollout(ts))


@pytest.mark.parametrize("blocks", [8, 3])
def test_rollout_matches_the_reference(runs, blocks):
    port, pts = runs["port"], runs["pts"]
    got = SpatialPPO(port, make_spatial_mesh(blocks, "cpu")).rollout(pts)
    _check_traj(runs["want"], got, runs["mode"])
    own = port.collect_rollout(pts.params, pts.env, pts.obs, pts.key)[3]
    _check_traj(own, got, runs["mode"], exact_floats=True)


@pytest.mark.parametrize("mode", ["on_network", "throughput", "system",
                                  "progress"])
def test_rollout_across_a_reset_matches_collect_rollout(scenarios, mode):
    _, _, pnet, pagents = scenarios["Grid4x4"]
    port = _port_ppo(pnet, reward_mode=mode, rollout_steps=32,
                     episode_start=21600, episode_end=21620)
    pst = p_step.init_sim_state(pnet, pagents,
                                policy=p_step.Policy(choice=p_random_choice))
    pts = port.init(pst, p_rng.prng_key(3), torch.Generator().manual_seed(3))
    env, obs, key, want, last = port.collect_rollout(pts.params, pts.env,
                                                     pts.obs, pts.key)
    assert int(want.done.sum()) >= 1
    spat = SpatialPPO(port, make_spatial_mesh(4, "cpu"))
    genv, gobs, gkey, got, glast = spat._collect(pts, fused_shard_winner)
    _check_traj(want, got, mode, exact_floats=True)
    assert gkey == key
    assert torch.equal(glast, last)
    assert_tree_equal(convert.to_numpy(env), convert.to_numpy(genv), "env")
    assert_tree_equal(convert.to_numpy(obs), convert.to_numpy(gobs), "obs")


def test_train_iteration_matches_the_reference(scenarios):
    ref, port, ts, pts = _both(scenarios["Braess"])
    ts1, metrics = RefSpatialPPO(ref, ref_mesh(8)).train_iteration(ts)
    spat = SpatialPPO(port, make_spatial_mesh(8, "cpu"))
    pts1, pmetrics = spat.train_iteration(pts)
    np.testing.assert_allclose(float(pmetrics.avg_reward),
                               float(metrics.avg_reward), rtol=1e-6)
    np.testing.assert_allclose(float(pmetrics.loss_total),
                               float(metrics.loss_total), rtol=1e-4,
                               atol=1e-5)
    want = convert.mpnn_params_from_numpy(
        jax.tree.map(np.asarray, ts1.params), device="cpu")
    for part in want:
        for k in want[part]:
            np.testing.assert_allclose(pts1.params[part][k].numpy(),
                                       want[part][k].numpy(), rtol=1e-3,
                                       atol=5e-3, err_msg=f"{part} {k}")
    assert pts1.iteration == int(ts1.iteration) == 1
    np.testing.assert_array_equal(pts1.env.sim.road.count.numpy(),
                                  np.asarray(ts1.env.sim.road.count))
    assert float(pts1.env.sim.time) == float(ts1.env.sim.time)
    # The carried state is the unsharded iteration's, bitwise.
    own, _ = port.train_iteration(pts)
    assert own.key == pts1.key
    assert_tree_equal(convert.to_numpy(own.env), convert.to_numpy(pts1.env),
                      "env")
    assert_tree_equal(convert.to_numpy(own.obs), convert.to_numpy(pts1.obs),
                      "obs")


def test_refusals(scenarios):
    _, _, pnet, _ = scenarios["Braess"]
    mesh = make_spatial_mesh(2, "cpu")
    windowed = _port_ppo(pnet)
    windowed.sim_cfg = dataclasses.replace(PortSimConfig(), insert_window=8)
    with pytest.raises(ValueError, match="windowed"):
        SpatialPPO(windowed, mesh)
    with pytest.raises(ValueError, match="individual"):
        SpatialPPO(_port_ppo(pnet, reward_mode="individual"), mesh)
    with pytest.raises(ValueError, match="congested_potential"):
        SpatialPPO(_port_ppo(pnet, reward_mode="progress",
                             congested_potential=True), mesh)
    pe = np.zeros((pnet.num_nodes, 4), np.float32)
    attention = PortPPO(pnet, p_agent.TransformerRoutePolicy(pe),
                        p_agent.TransformerValueNet(pe),
                        rl=PortRLConfig(**RL_KW), value_uses_graph=True)
    with pytest.raises(ValueError, match="edge-row-independent"):
        SpatialPPO(attention, mesh)
