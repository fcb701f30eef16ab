"""The port's PPO training half against the JAX reference, on the CPU.

* ``core.rng.permutation`` bitwise against ``jax.random.permutation``
  (one shuffle round up to n = 1,625, two from 1,626).
* ``rl.gae``: ``gae`` and ``normalize`` at rtol 1e-6.
* ``rl.ppo.Adam`` against the reference's optax chain over 5 updates of
  the same seeded gradients: no clip, a clip that triggers and one that
  does not, the cosine anneal from update 0 and from update 2; parameters
  and ``mu``/``nu`` at rtol 1e-6, the rate at every count, and
  ``convert.adam_state_*`` both ways.
* The batched loss pieces against their per-sample forms: the nets with
  a leading batch axis, ``distribution.log_prob_and_entropy`` against
  ``GraphDistribution(..., ops=PLAIN)`` row by row, at rtol 1e-6.
* ``PPO._loss`` on one minibatch from parameters carried from a Flax
  ``init``, both policy modes, with and without the distance prior, and
  the graph critic (its segment sums under ``plain_segments``): the total
  and the aux at rtol 1e-5, every gradient at rtol 1e-4, atol 1e-6.
* One whole ``train_iteration`` from the same parameters, state and key
  (Grid4x4, 32 steps, one minibatch of 24 with the remainder dropped, the
  clip on): the trajectory as the collection test holds it, the metrics at
  rtol 1e-5, and the parameters after the update at atol 1e-5 in at least
  99% of the elements, every element within twice Adam's first step (the
  learning rate), with the worst difference printed.  Adam divides each
  gradient by its own RMS, so an element whose true gradient is 0 and whose
  computed one is float32 rounding noise on both sides (the last layer's
  bias and any unit whose effect on the logits is constant within each
  node's out-edges: the per-node softmax is invariant to those) takes a
  step of up to the learning rate in a direction the noise picks; the
  updates after it start from parameters that differ there, so a
  multi-update iteration is held by its pieces instead:
* ``_update_epochs`` over two epochs of two minibatches (the remainder
  dropped, the clip and the anneal on), bitwise against the reference's
  loop written out over the port's own loss, gradients and Adam (each
  held against the reference above) with ``jax.random.permutation``'s
  minibatch order.
* ``PPO.init``'s law (fault F1): 64 draws of the reference's ``init``
  (JAX keys) and 64 of the port's (generator seeds) at Grid4x4, both
  policy modes and both critics; per layer, pooled over the draws, each
  kernel's mean and variance within 5 standard errors of the
  ``lecun_normal`` law's (0 and 1/fan_in) and of the other package's,
  every value inside the +-2 standard deviations of the truncation and
  some within 5% of it (where 1,000 values or more are drawn), biases
  exactly 0 and the embeddings N(0, 1) within 5 standard errors.
* ``ppo_train`` on the port alone: three iterations with checkpoints,
  evaluations, ``track_best`` and an EMA; a run resumed from ``ckpt_2``
  ends bitwise where the uninterrupted run ends; ``best.json`` and
  ``metrics.csv`` carry the reference's names.
"""
import csv
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tarl_tpu.config import RLConfig
from tarl_tpu.core.step import Policy, init_sim_state
from tarl_tpu.models.mpnn import (
    MPNNPolicyNet,
    MPNNValueNet,
    MPNNValueNetSimple,
)
from tarl_tpu.rl import gae as ref_gae
from tarl_tpu.rl.ppo import PPO, Transition
from tarl_tpu.routing.policies import random_choice

from tarl_tpu_torch import convert
from tarl_tpu_torch.config import RLConfig as PortRLConfig
from tarl_tpu_torch.core import rng as p_rng
from tarl_tpu_torch.core import step as p_step
from tarl_tpu_torch.models import mpnn as p_mpnn
from tarl_tpu_torch.ops import segment as seg
from tarl_tpu_torch.rl import gae as p_gae
from tarl_tpu_torch.rl.checkpoint import latest_checkpoint, restore_checkpoint
from tarl_tpu_torch.rl.distribution import (
    GraphDistribution as PortGraphDistribution,
)
from tarl_tpu_torch.rl.distribution import log_prob_and_entropy
from tarl_tpu_torch.rl.ppo import PPO as PortPPO
from tarl_tpu_torch.rl.ppo import Transition as PortTransition
from tarl_tpu_torch.rl.trainer import ppo_train
from tarl_tpu_torch.routing.policies import random_choice as p_random_choice

from test_torch_network import load_both

torch.set_num_threads(1)

PRIOR_SCALE = 30.0
EPISODE = dict(reward_mode="progress", gamma=0.98, gae_lambda=0.9,
               episode_start=21600)


@pytest.fixture(scope="module")
def scenarios(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_train_scen"))
    return {name: load_both(root, name) for name in ("Braess", "Grid4x4")}


def _states(scen):
    net, agents, pnet, pagents = scen
    st = init_sim_state(net, agents, policy=Policy(choice=random_choice))
    pst = p_step.init_sim_state(pnet, pagents,
                                policy=p_step.Policy(choice=p_random_choice))
    return st, pst


def _both_ppo(scen, mode="edge_mlp", prior=True, graph=False, **kw):
    """The reference's and the port's PPO on one scenario, same settings."""
    net, _, pnet, _ = scen
    kw = {**EPISODE, **kw}
    ref = PPO(net, MPNNPolicyNet(num_nodes=net.num_nodes,
                                 num_node_embeddings=net.num_roads + 1,
                                 mode=mode, use_distance_prior=prior,
                                 prior_scale=PRIOR_SCALE),
              MPNNValueNet(num_nodes=net.num_nodes) if graph
              else MPNNValueNetSimple(),
              rl=RLConfig(**kw), value_uses_graph=graph)
    port = PortPPO(pnet, p_mpnn.MPNNPolicyNet(
        pnet.num_nodes, pnet.num_roads + 1, mode=mode,
        use_distance_prior=prior, prior_scale=PRIOR_SCALE),
        p_mpnn.MPNNValueNet(pnet.num_nodes) if graph
        else p_mpnn.MPNNValueNetSimple(pnet.num_nodes),
        rl=PortRLConfig(**kw), value_uses_graph=graph)
    return ref, port


def _port_tree(tree) -> dict:
    return convert.mpnn_params_from_numpy(jax.tree.map(np.asarray, tree),
                                          device="cpu")


def _adam_state(opt_state):
    """The ``ScaleByAdamState`` inside an optax chain's state."""
    if isinstance(opt_state, optax.ScaleByAdamState):
        return opt_state
    if isinstance(opt_state, tuple):
        for s in opt_state:
            found = _adam_state(s)
            if found is not None:
                return found
    return None


def _port_adam(opt_state):
    return convert.adam_state_from_numpy(
        jax.tree.map(np.asarray, _adam_state(opt_state)._asdict()),
        device="cpu")


def _assert_trees_close(ref: dict, port: dict, rtol, atol, what):
    for part in ref:
        assert sorted(ref[part]) == sorted(port[part]), what
        for k in ref[part]:
            np.testing.assert_allclose(port[part][k].numpy(),
                                       ref[part][k].numpy(), rtol=rtol,
                                       atol=atol, err_msg=f"{what} {part} {k}")


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [1, 7, 128, 256, 1625, 1626, 5000])
def test_permutation_is_jax_bitwise(n):
    for seed in (0, 11):
        want = np.asarray(jax.random.permutation(jax.random.PRNGKey(seed), n))
        got = p_rng.permutation(p_rng.prng_key(seed), n, device="cpu")
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want, f"seed {seed}")


def test_gae_and_normalize():
    g = np.random.default_rng(3)
    t = 40
    rewards = g.normal(size=t).astype(np.float32)
    values = g.normal(size=t).astype(np.float32)
    last = np.float32(g.normal())
    dones = g.random(t) < 0.15
    want_adv, want_ret = ref_gae.gae(jnp.asarray(rewards), jnp.asarray(values),
                                     jnp.asarray(last), jnp.asarray(dones),
                                     0.98, 0.9)
    adv, ret = p_gae.gae(torch.as_tensor(rewards), torch.as_tensor(values),
                         torch.as_tensor(last), torch.as_tensor(dones),
                         0.98, 0.9)
    np.testing.assert_allclose(adv.numpy(), np.asarray(want_adv), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(ret.numpy(), np.asarray(want_ret), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(
        p_gae.normalize(adv).numpy(),
        np.asarray(ref_gae.normalize(want_adv)), rtol=1e-6, atol=1e-6)


OPT_CASES = {
    "no_clip": {},
    "clip_triggers": dict(max_grad_norm=0.5),
    "clip_idle": dict(max_grad_norm=1e4),
    "anneal_from_0": dict(lr_anneal_updates=3, lr_anneal_floor=0.1),
    "anneal_from_2": dict(lr_anneal_updates=2, lr_anneal_start=2,
                          max_grad_norm=0.5),
}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_optimizer_matches_optax(scenarios, case):
    kw = dict(learning_rate=3e-3, **OPT_CASES[case])
    ref, port = _both_ppo(scenarios["Braess"], prior=False, **kw)
    st, pst = _states(scenarios["Braess"])
    ts = ref.init(st, jax.random.PRNGKey(1))
    params, opt_state = ts.params, ts.opt_state
    p_params = _port_tree(params)
    p_state = port.optimizer.init(p_params)
    g = np.random.default_rng(5)
    update = jax.jit(ref.tx.update)
    for i in range(5):
        grads = jax.tree.map(
            lambda a: jnp.asarray(g.normal(size=a.shape).astype(np.float32)),
            params)
        updates, opt_state = update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        p_params, p_state = port.optimizer.update(_port_tree(grads), p_state,
                                                  p_params)
        # atol: an ulp of the terms summed (XLA may fuse a product and a
        # sum into one FMA, and a sum may cancel).
        _assert_trees_close(_port_tree(params), p_params, 1e-6, 1e-8,
                            f"{case} params after update {i + 1}")
        want = _port_adam(opt_state)
        assert p_state.count == want.count == i + 1
        _assert_trees_close(want.mu, p_state.mu, 1e-6, 1e-7, f"{case} mu")
        _assert_trees_close(want.nu, p_state.nu, 1e-6, 1e-7, f"{case} nu")
    # The rate at every count, against the reference's schedule.
    rl = ref.rl
    if rl.lr_anneal_updates:
        schedule = optax.join_schedules(
            [optax.constant_schedule(rl.learning_rate),
             optax.cosine_decay_schedule(rl.learning_rate,
                                         rl.lr_anneal_updates,
                                         alpha=rl.lr_anneal_floor)],
            [max(rl.lr_anneal_start, 0)])
    else:
        schedule = optax.constant_schedule(rl.learning_rate)
    for count in range(8):
        np.testing.assert_allclose(
            port.optimizer.rate(count),
            float(schedule(jnp.asarray(count, jnp.int32))), rtol=1e-6)
    # The state carries back to optax's form.
    back = convert.adam_state_to_numpy(p_state)
    assert back["count"] == np.int32(5)
    again = convert.adam_state_from_numpy(back, device="cpu")
    for field in ("mu", "nu"):
        for part, sub in getattr(p_state, field).items():
            for k, v in sub.items():
                assert torch.equal(getattr(again, field)[part][k], v)


# ---------------------------------------------------------------------------
def _minibatch(port, pts, params, key, rows):
    """A collected minibatch (the port's collection equals the
    reference's) with old log-probs moved by seeded noise, so that the
    ratio leaves 1 and the clip engages."""
    _, _, _, traj, _ = port.collect_rollout(params, pts.env, pts.obs, key)
    batch = PortTransition(*(a[torch.as_tensor(rows)] for a in traj))
    g = np.random.default_rng(len(rows))
    noise = (g.normal(size=len(rows)) * 0.3).astype(np.float32)
    batch = batch._replace(log_prob=batch.log_prob + torch.as_tensor(noise))
    adv = g.normal(size=len(rows)).astype(np.float32)
    ret = g.normal(size=len(rows)).astype(np.float32)
    return batch, torch.as_tensor(adv), torch.as_tensor(ret)


def test_batched_forms_equal_the_per_sample_ones(scenarios):
    st, pst = _states(scenarios["Grid4x4"])
    _, port = _both_ppo(scenarios["Grid4x4"], rollout_steps=8)
    _, gport = _both_ppo(scenarios["Grid4x4"], graph=True, rollout_steps=8)
    pts = port.init(pst, p_rng.prng_key(0), torch.Generator().manual_seed(0))
    vparams = gport.init(pst, p_rng.prng_key(0),
                         torch.Generator().manual_seed(1)).params["value"]
    batch, _, _ = _minibatch(port, pts, pts.params, p_rng.prng_key(4),
                             np.arange(8))
    logits = port._policy_logits(pts.params["policy"], batch.x)
    values = port._value(pts.params["value"], batch.x, batch.time)
    with seg.plain_segments():
        gvalues = gport._value(vparams, batch.x, batch.time)
    lp, ent = log_prob_and_entropy(logits, batch.action, port._edge_src,
                                   port._num_nodes)
    assert logits.shape == batch.action.shape and lp.shape == (8,)
    for b in range(8):
        one = port._policy_logits(pts.params["policy"], batch.x[b])
        np.testing.assert_allclose(logits[b].numpy(), one.numpy(), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(
            float(values[b]),
            float(port._value(pts.params["value"], batch.x[b],
                              batch.time[b])), rtol=1e-6)
        np.testing.assert_allclose(
            float(gvalues[b]),
            float(gport._value(vparams, batch.x[b], batch.time[b])),
            rtol=1e-6)
        d = PortGraphDistribution(logits[b], port._edge_src, port._num_nodes,
                                  ops=seg.PLAIN)
        np.testing.assert_allclose(float(lp[b]),
                                   float(d.log_prob(batch.action[b])),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(ent[b]), float(d.entropy()),
                                   rtol=1e-6)
    # An invalid row scores -inf, as log_prob does.
    bad = batch.action.clone()
    bad[0] = False
    assert float(log_prob_and_entropy(logits, bad, port._edge_src,
                                      port._num_nodes)[0][0]) == -np.inf


LOSS_CASES = [("edge_mlp", True, False), ("edge_mlp", False, True),
              ("embedding", True, False), ("embedding", False, False)]


@pytest.mark.parametrize("mode,prior,graph", LOSS_CASES)
def test_loss_and_grads_match_the_reference(scenarios, mode, prior, graph):
    st, pst = _states(scenarios["Braess"])
    ref, port = _both_ppo(scenarios["Braess"], mode, prior, graph,
                          rollout_steps=16, entropy_coef=0.01,
                          value_coef=0.5)
    ts = ref.init(st, jax.random.PRNGKey(2))
    params = _port_tree(ts.params)
    pts = port.init(pst, p_rng.prng_key(2), torch.Generator())
    rows = np.arange(1, 16, 2)
    batch, adv, ret = _minibatch(port, pts, params, p_rng.prng_key(9), rows)
    rbatch = Transition(*(jnp.asarray(a.numpy()) for a in batch))
    (want, want_aux), want_grads = jax.value_and_grad(ref._loss, has_aux=True)(
        ts.params, rbatch, jnp.asarray(adv.numpy()), jnp.asarray(ret.numpy()))
    (total, aux), grads = port._loss_and_grads(params, batch, adv, ret)
    assert 0.0 < float(aux[4]) < 1.0, "the clip should engage on some rows"
    np.testing.assert_allclose(float(total), float(want), rtol=1e-5)
    np.testing.assert_allclose([float(a) for a in aux],
                               [float(a) for a in want_aux], rtol=1e-5,
                               atol=1e-7)
    _assert_trees_close(_port_tree(want_grads), grads, 1e-4, 1e-6, "grad")
    assert sorted(grads["policy"]) == sorted(port.policy_net.state_dict())


def test_train_iteration_matches_the_reference(scenarios):
    st, pst = _states(scenarios["Grid4x4"])
    lr = 1e-3
    ref, port = _both_ppo(scenarios["Grid4x4"], rollout_steps=32,
                          minibatch_size=24, entropy_coef=0.01,
                          learning_rate=lr, max_grad_norm=0.5)
    ts = ref.init(st, jax.random.PRNGKey(0))
    params = _port_tree(ts.params)
    pts = port.init(pst, p_rng.prng_key(0), torch.Generator())
    pts = pts._replace(params=params, opt_state=port.optimizer.init(params),
                       key=tuple(int(k) for k in np.asarray(ts.key)))
    ts1, metrics = ref.train_iteration(ts)
    pts1, pmetrics = port.train_iteration(pts)
    assert pts1.iteration == int(ts1.iteration) == 1
    assert pts1.key == tuple(int(k) for k in np.asarray(ts1.key))
    assert float(pts1.env.sim.time) == float(ts1.env.sim.time)
    np.testing.assert_array_equal(pts1.env.sim.agents.done.numpy(),
                                  np.asarray(ts1.env.sim.agents.done))
    for f in metrics._fields:
        np.testing.assert_allclose(float(getattr(pmetrics, f)),
                                   float(getattr(metrics, f)), rtol=1e-5,
                                   atol=1e-7, err_msg=f)
    # One update (32 // 24 minibatches, the remainder of 8 dropped).
    assert pts1.opt_state.count == int(_adam_state(ts1.opt_state).count) == 1
    want = _port_tree(ts1.params)
    diffs = torch.cat([(want[p][k] - pts1.params[p][k]).abs().reshape(-1)
                       for p in want for k in want[p]])
    close = float((diffs <= 1e-5).to(torch.float64).mean())
    print(f"train_iteration: worst parameter difference "
          f"{float(diffs.max()):.3g}, {close:.4%} of {diffs.numel()} "
          f"elements within 1e-5")
    assert close >= 0.99
    # Adam's first step moves each element by at most the rate, either way.
    assert float(diffs.max()) <= 2 * lr
    moved = torch.cat([(params[p][k] - pts1.params[p][k]).abs().reshape(-1)
                       for p in params for k in params[p]])
    assert float((moved > 0.5 * lr).to(torch.float64).mean()) > 0.25


def test_update_epochs_composes_the_reference_loop(scenarios):
    """The epochs and minibatches of ``_update_epochs`` (two epochs of two
    minibatches of 12 from 32 steps, the remainder dropped) equal, bitwise,
    the reference's loop written out over the port's pieces, with the
    minibatch order from ``jax.random.permutation`` of the reference's key
    stream."""
    _, pst = _states(scenarios["Grid4x4"])
    _, port = _both_ppo(scenarios["Grid4x4"], rollout_steps=32,
                        minibatch_size=12, num_epochs=2, entropy_coef=0.01,
                        max_grad_norm=0.5, lr_anneal_updates=3,
                        lr_anneal_start=1)
    pts = port.init(pst, p_rng.prng_key(0), torch.Generator().manual_seed(2))
    _, _, key, traj, last = port.collect_rollout(pts.params, pts.env,
                                                 pts.obs, pts.key)
    adv, ret = p_gae.gae(traj.reward, traj.value, last, traj.done, 0.98, 0.9)
    adv = p_gae.normalize(adv)
    (params, opt_state, key_out), stats = port._update_epochs(
        pts.params, pts.opt_state, traj, adv, ret, key)
    assert len(stats) == 4 and opt_state.count == 4

    want, want_state = pts.params, pts.opt_state
    jkey = jnp.asarray(key, jnp.uint32)
    for _ in range(2):
        jkey, k_perm = jax.random.split(jkey)
        perm = np.asarray(jax.random.permutation(k_perm, 32))
        for i in range(2):
            idx = torch.as_tensor(perm[i * 12:(i + 1) * 12].copy())
            batch = PortTransition(*(a[idx] for a in traj))
            _, grads = port._loss_and_grads(want, batch, adv[idx], ret[idx])
            want, want_state = port.optimizer.update(grads, want_state, want)
    assert key_out == tuple(int(k) for k in np.asarray(jkey))
    for part, sub in want.items():
        for k, v in sub.items():
            assert torch.equal(params[part][k], v), k
            assert torch.equal(opt_state.mu[part][k], want_state.mu[part][k])


# ---------------------------------------------------------------------------
TRAIN_COLUMNS = [
    "step", "loss/objective", "loss/value", "loss/entropy", "loss/total",
    "approx_kl", "clip_fraction", "grad_global_norm", "PPO/avg_reward",
    "PPO/avg_return", "transport/avg_on_network",
    "transport/avg_travel_time", "transport/avg_vc_ratio",
    "transport/std_vc_ratio", "eval/avg_return", "eval/episode_len",
    "eval/tstt", "eval/relative_nash_gap",
    "eval/avg_travel_time", "eval/computation_time_ms",
    "eval_stochastic/avg_return", "eval_stochastic/episode_len",
    "eval_stochastic/tstt", "eval_stochastic/relative_nash_gap",
    "eval_stochastic/avg_travel_time", "eval_stochastic/computation_time_ms",
]


def test_ppo_train_resumes_exactly(scenarios, tmp_path):
    _, pst = _states(scenarios["Braess"])
    rl = PortRLConfig(**EPISODE, rollout_steps=8, minibatch_size=4,
                      num_epochs=1, entropy_coef=0.01)
    _, port = _both_ppo(scenarios["Braess"], rollout_steps=8,
                        minibatch_size=4, num_epochs=1, entropy_coef=0.01)
    common = dict(rl=rl, key=p_rng.prng_key(3), verbose=False,
                  checkpoint_interval=1)
    full_dir = str(tmp_path / "full")
    full = ppo_train(port, pst, num_iterations=3, checkpoint_dir=full_dir,
                     log_dir=str(tmp_path / "logs"), eval_interval=1,
                     eval_steps=12, stochastic_eval=True,
                     stochastic_eval_samples=2,
                     track_best="eval/avg_travel_time", ema_decay=0.9,
                     generator=torch.Generator().manual_seed(4), **common)
    assert full.iteration == 3
    for name in ("ckpt_1", "ckpt_2", "ckpt_3", "best", "best.json",
                 "final_ema"):
        assert os.path.exists(os.path.join(full_dir, name)), name
    assert latest_checkpoint(full_dir).endswith("ckpt_3")
    best = json.load(open(os.path.join(full_dir, "best.json")))
    assert sorted(best) == ["iteration", "metric", "value"]
    assert best["metric"] == "eval/avg_travel_time"
    assert restore_checkpoint(os.path.join(full_dir, "best"),
                              "cpu")["iteration"] == best["iteration"]
    with open(tmp_path / "logs" / "metrics.csv") as f:
        rows = list(csv.DictReader(f))
    assert list(rows[0]) == TRAIN_COLUMNS
    assert len(rows) == 9 and all(np.isfinite(float(rows[0][c]))
                                  for c in TRAIN_COLUMNS[:14])

    # Resume from ckpt_2 alone; the initial draw must not matter.
    part_dir = str(tmp_path / "part")
    os.makedirs(part_dir)
    shutil.copy(os.path.join(full_dir, "ckpt_2"), part_dir)
    resumed = ppo_train(port, pst, num_iterations=3, checkpoint_dir=part_dir,
                        resume=True, generator=torch.Generator().manual_seed(
                            99), **common)
    assert resumed.iteration == 3 and resumed.key == full.key
    assert resumed.opt_state.count == full.opt_state.count == 6
    for tree in ("params",):
        for part, sub in getattr(full, tree).items():
            for k, v in sub.items():
                assert torch.equal(getattr(resumed, tree)[part][k], v), k
    for field in ("mu", "nu"):
        for part, sub in getattr(full.opt_state, field).items():
            for k, v in sub.items():
                assert torch.equal(getattr(resumed.opt_state, field)[part][k],
                                   v)
    assert torch.equal(resumed.env.sim.agents.done, full.env.sim.agents.done)
    saved = restore_checkpoint(os.path.join(part_dir, "ckpt_3"), "cpu")
    for k, v in full.params["policy"].items():
        assert torch.equal(saved["params"]["policy"][k], v)


def test_latest_checkpoint_sorts_numerically(tmp_path):
    assert latest_checkpoint(str(tmp_path / "none")) is None
    for name in ("ckpt_9", "ckpt_10", "ckpt_2", "best", "ckpt_11.tmp7"):
        (tmp_path / name).write_text("")
    assert latest_checkpoint(str(tmp_path)) == str(tmp_path / "ckpt_10")


def _moments_ok(x: np.ndarray, mean: float, var: float, what: str):
    """The pooled sample's mean and variance within 5 standard errors of
    ``mean`` and ``var`` (the variance's error bound takes a kurtosis of
    at most 3, the normal's; the truncated normal's is 2.54)."""
    n = x.size
    assert abs(x.mean() - mean) <= 5.0 * np.sqrt(var / n), what
    assert abs(x.var() / var - 1.0) <= 5.0 * np.sqrt(2.0 / n), what


@pytest.mark.parametrize("mode,graph", [("edge_mlp", False),
                                        ("embedding", True)])
def test_init_draws_the_references_law(scenarios, mode, graph):
    scen = scenarios["Grid4x4"]
    ref, port = _both_ppo(scen, mode=mode, graph=graph)
    st, pst = _states(scen)
    init = jax.jit(lambda k: ref.init(st, k).params)
    draws = {"ref": [_port_tree(init(jax.random.PRNGKey(s)))
                     for s in range(64)],
             "port": [port.init(pst, p_rng.prng_key(0),
                                torch.Generator().manual_seed(s)).params
                      for s in range(64)]}
    names = {part: sorted(sub) for part, sub in draws["ref"][0].items()}
    for part, keys in names.items():
        assert keys == sorted(draws["port"][0][part])
        for k in keys:
            pooled = {side: np.stack([d[part][k].numpy() for d in ds])
                      for side, ds in draws.items()}
            what = f"{mode} {part} {k}"
            if k.endswith(".bias"):
                for side, x in pooled.items():
                    assert not x.any(), f"{what}: {side} bias not zero"
            elif k.startswith("nodes_embedding"):
                for x in pooled.values():
                    _moments_ok(x, 0.0, 1.0, what)
                    assert np.abs(x).max() > 2.5, what   # not truncated
            else:
                fan_in = pooled["port"].shape[-1]
                var = 1.0 / fan_in
                bound = 2.0 * np.sqrt(var) / 0.87962566103423978
                for x in pooled.values():
                    _moments_ok(x, 0.0, var, what)
                    assert np.abs(x).max() <= bound * (1 + 1e-6), what
                    if x.size >= 1000:
                        assert np.abs(x).max() >= 0.95 * bound, what
                a, b = pooled["ref"], pooled["port"]
                se = np.sqrt(2.0 * var / a.size)
                assert abs(a.mean() - b.mean()) <= 5.0 * se, what
                assert abs(a.var() / b.var() - 1.0) <= 5.0 * np.sqrt(
                    4.0 / a.size), what
