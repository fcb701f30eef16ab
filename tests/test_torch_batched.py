"""The port's batched trainer (``parallel/shard.BatchedPPO``,
``parallel/mesh.make_mesh``, ``core.rng.fold_in``) against the JAX
reference, on the CPU.

* ``fold_in`` bitwise ``jax.random.fold_in``, data 0 and past 2**31
  included.
* ``make_mesh``: the reference's shapes over the devices there are (the
  CPU is one), and a refusal where a mesh asks for more.
* Grid4x4 and Braess, three replicas of 8 steps, one minibatch of 16 (the
  remainder of 8 dropped), parameters carried from the reference's
  ``init`` with ``convert``: ``init``'s rollout keys, simulation keys,
  update key and environments bitwise; one ``train_step``'s ``[B*T]``
  buffer (captured inside the reference's jitted step) with its actions,
  rewards, dones, contexts and times bitwise and its log-probs and values
  at 1e-5, the metrics at rtol 1e-5, the keys and final environments
  bitwise, and the parameters as ``test_torch_train.py::
  test_train_iteration_matches_the_reference`` holds them.
* One replica: bitwise the single-environment ``train_iteration``.
* The replicas' streams are decorrelated.
* ``ppo_train`` with a ``BatchedPPO``: a run resumed from ``ckpt_2`` ends
  bitwise where the uninterrupted run ends.
* ``main_torch.py --num-envs 3 --device cpu`` trains, writes the files a
  single-environment run writes, and its checkpoint evaluates.
"""
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from tarl_tpu.config import RLConfig
from tarl_tpu.core.step import Policy, init_sim_state
from tarl_tpu.models.mpnn import MPNNPolicyNet, MPNNValueNetSimple
from tarl_tpu.parallel.mesh import make_mesh as ref_make_mesh
from tarl_tpu.parallel.shard import BatchedPPO as RefBatchedPPO
from tarl_tpu.rl.ppo import PPO
from tarl_tpu.routing.policies import random_choice

from tarl_tpu_torch import convert
from tarl_tpu_torch import runner as runner_mod
from tarl_tpu_torch.config import RLConfig as PortRLConfig
from tarl_tpu_torch.core import rng as p_rng
from tarl_tpu_torch.core import step as p_step
from tarl_tpu_torch.models import mpnn as p_mpnn
from tarl_tpu_torch.parallel.mesh import make_mesh
from tarl_tpu_torch.parallel.shard import BatchedPPO, replica
from tarl_tpu_torch.rl.checkpoint import restore_checkpoint
from tarl_tpu_torch.rl.ppo import PPO as PortPPO
from tarl_tpu_torch.rl.trainer import ppo_train
from tarl_tpu_torch.routing.policies import random_choice as p_random_choice

from test_torch_cli import _bits
from test_torch_network import assert_tree_equal, load_both

torch.set_num_threads(1)

B, T, LR = 3, 8, 1e-3
RL_KW = dict(reward_mode="progress", gamma=0.98, gae_lambda=0.9,
             episode_start=21600, rollout_steps=T, minibatch_size=16,
             num_epochs=1, entropy_coef=0.01, learning_rate=LR,
             max_grad_norm=0.5)


def _key(k) -> tuple:
    return tuple(int(w) for w in np.asarray(k))


def _port_ppo(pnet, **kw):
    return PortPPO(pnet, p_mpnn.MPNNPolicyNet(
        pnet.num_nodes, pnet.num_roads + 1, use_distance_prior=True,
        prior_scale=30.0), p_mpnn.MPNNValueNetSimple(pnet.num_nodes),
        rl=PortRLConfig(**{**RL_KW, **kw}))


def _sim_tree(sim) -> dict:
    tree = convert.to_numpy(sim)
    tree.pop("key")
    return tree


@pytest.fixture(scope="module")
def scenarios(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_batched_scen"))
    return {name: load_both(root, name) for name in ("Grid4x4", "Braess")}


@pytest.fixture(scope="module")
def runs(scenarios):
    """Per scenario: the reference's and the port's trainers, states
    after ``init`` (the port's parameters carried from the reference's),
    one ``train_step`` of each and the reference's captured buffer."""
    out = {}
    for name, (net, agents, pnet, pagents) in scenarios.items():
        st = init_sim_state(net, agents, policy=Policy(choice=random_choice))
        pst = p_step.init_sim_state(
            pnet, pagents, policy=p_step.Policy(choice=p_random_choice))
        ppo = PPO(net, MPNNPolicyNet(num_nodes=net.num_nodes,
                                     num_node_embeddings=net.num_roads + 1,
                                     use_distance_prior=True,
                                     prior_scale=30.0),
                  MPNNValueNetSimple(), rl=RLConfig(**RL_KW))
        ref = RefBatchedPPO(ppo, ref_make_mesh(1), num_envs=B)
        captured = {}
        update = ppo._update_epochs

        def capture(params, opt_state, buffer, adv, ret, key, constrain=None,
                    _update=update):
            jax.debug.callback(
                lambda b, a, r: captured.update(buffer=b, adv=a, ret=r),
                buffer, adv, ret)
            return _update(params, opt_state, buffer, adv, ret, key,
                           constrain=constrain)

        ppo._update_epochs = capture
        ts = jax.jit(ref.init)(st, jax.random.PRNGKey(0))
        ts1, metrics = ref.train_step(ts)
        jax.block_until_ready(ts1)

        port = BatchedPPO(_port_ppo(pnet), make_mesh(1, device="cpu"),
                          num_envs=B)
        pts = port.init(pst, p_rng.prng_key(0), torch.Generator())
        params = convert.mpnn_params_from_numpy(
            jax.tree.map(np.asarray, ts.params), device="cpu")
        pts = pts._replace(params=params,
                           opt_state=port.ppo.optimizer.init(params))
        probe = {}
        p_update = port.ppo._update_epochs

        def p_capture(params, opt_state, buffer, adv, ret, key):
            probe.update(buffer=buffer, adv=adv, ret=ret)
            return p_update(params, opt_state, buffer, adv, ret, key)

        port.ppo._update_epochs = p_capture
        pts1, pmetrics = port.train_step(pts)
        port.ppo._update_epochs = p_update
        out[name] = dict(ref=ref, ts=ts, ts1=ts1, metrics=metrics,
                         captured=captured, port=port, pts=pts, pts1=pts1,
                         pmetrics=pmetrics, probe=probe, params=params,
                         pst=pst)
    return out


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("data", [0, 1, 7, 2 ** 31 + 5, 2 ** 32 - 1])
def test_fold_in_is_jax_bitwise(data):
    for key in (jax.random.PRNGKey(0), jax.random.PRNGKey(2 ** 31 - 1),
                jax.random.split(jax.random.PRNGKey(5))[1]):
        want = _key(jax.random.fold_in(key, np.uint32(data)))
        assert p_rng.fold_in(_key(key), data) == want


def test_make_mesh_shapes_and_refusal(monkeypatch):
    m = make_mesh(device="cpu")
    assert m.shape == {"dp": 1, "sp": 1}
    assert m.devices == [torch.device("cpu")]
    assert make_mesh(1, sp=1, device="cpu").shape == dict(
        ref_make_mesh(1, sp=1).shape)
    with pytest.raises(ValueError, match="devices"):
        make_mesh(2, device="cpu")
    # Four cards: the reference's defaults (sp = 2 from 4 even devices).
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert make_mesh().shape == dict(ref_make_mesh(4).shape) == {
        "dp": 2, "sp": 2}
    assert make_mesh(3).shape == {"dp": 3, "sp": 1}
    assert make_mesh(4, sp=1).shape == {"dp": 4, "sp": 1}
    assert make_mesh(2).devices == [torch.device("cuda", 0),
                                           torch.device("cuda", 1)]
    with pytest.raises(ValueError, match="mesh 1x2 != 3"):
        make_mesh(3, sp=2)
    with pytest.raises(ValueError, match="devices"):
        make_mesh(5)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="devices"):
        make_mesh()


def test_batched_ppo_refuses_other_meshes(scenarios, monkeypatch):
    ppo = _port_ppo(scenarios["Braess"][2])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="num_envs 3 % dp 2"):
        BatchedPPO(ppo, make_mesh(2, sp=1), num_envs=3)
    with pytest.raises(NotImplementedError, match="network's device"):
        BatchedPPO(ppo, make_mesh(2, sp=1), num_envs=2)
    with pytest.raises(NotImplementedError, match="network's device"):
        BatchedPPO(ppo, make_mesh(1), num_envs=2)


@pytest.mark.parametrize("name", ["Grid4x4", "Braess"])
def test_init_matches_the_reference(runs, name):
    r = runs[name]
    ts, pts, ref, port = r["ts"], r["pts"], r["ref"], r["port"]
    assert list(pts.keys) == [_key(k) for k in ts.keys]
    assert pts.update_key == _key(ts.update_key)
    assert pts.iteration == int(ts.iteration) == 0
    assert (port.minibatch_size, port.num_minibatches) == (
        ref.minibatch_size, ref.num_minibatches) == (16, 1)
    for i in range(B):
        env = jax.tree.map(lambda a: a[i], ts.envs)
        penv = replica(pts.envs, i)
        assert penv.sim.key == _key(env.sim.key)
        assert_tree_equal(_sim_tree(env.sim), _sim_tree(penv.sim),
                          f"{name} env {i}")
        assert_tree_equal(convert.to_numpy(jax.tree.map(lambda a: a[i],
                                                        ts.obss)),
                          convert.to_numpy(replica(pts.obss, i)),
                          f"{name} obs {i}")
    assert len({_key(k) for k in ts.envs.sim.key}) == B


@pytest.mark.parametrize("name", ["Grid4x4", "Braess"])
def test_train_step_matches_the_reference(runs, name):
    r = runs[name]
    buf, pbuf = r["captured"]["buffer"], r["probe"]["buffer"]
    for f in ("x", "time", "action", "reward", "done", "on_network"):
        got = getattr(pbuf, f).numpy()
        assert got.shape[0] == B * T, f
        np.testing.assert_array_equal(got, np.asarray(getattr(buf, f)), f)
    for f in ("log_prob", "value"):
        np.testing.assert_allclose(getattr(pbuf, f).numpy(),
                                   np.asarray(getattr(buf, f)), rtol=1e-5,
                                   atol=1e-5, err_msg=f)
    for f in ("adv", "ret"):
        np.testing.assert_allclose(r["probe"][f].numpy(),
                                   np.asarray(r["captured"][f]), rtol=1e-5,
                                   atol=1e-5, err_msg=f)
    for f in r["metrics"]._fields:
        np.testing.assert_allclose(float(getattr(r["pmetrics"], f)),
                                   float(getattr(r["metrics"], f)),
                                   rtol=1e-5, atol=1e-7, err_msg=f)
    ts1, pts1 = r["ts1"], r["pts1"]
    assert pts1.iteration == int(ts1.iteration) == 1
    assert list(pts1.keys) == [_key(k) for k in ts1.keys]
    assert pts1.update_key == _key(ts1.update_key)
    for i in range(B):
        assert_tree_equal(_sim_tree(jax.tree.map(lambda a: a[i],
                                                 ts1.envs).sim),
                          _sim_tree(replica(pts1.envs, i).sim),
                          f"{name} env {i} after the step")
    # One update: 24 steps, one minibatch of 16, the remainder dropped.
    assert pts1.opt_state.count == 1
    want = convert.mpnn_params_from_numpy(
        jax.tree.map(np.asarray, ts1.params), device="cpu")
    diffs = torch.cat([(want[p][k] - pts1.params[p][k]).abs().reshape(-1)
                       for p in want for k in want[p]])
    close = float((diffs <= 1e-5).to(torch.float64).mean())
    print(f"{name}: worst parameter difference {float(diffs.max()):.3g}, "
          f"{close:.4%} of {diffs.numel()} elements within 1e-5")
    assert close >= 0.99
    assert float(diffs.max()) <= 2 * LR
    params = r["params"]
    moved = torch.cat([(params[p][k] - pts1.params[p][k]).abs().reshape(-1)
                       for p in params for k in params[p]])
    assert float((moved > 0.5 * LR).to(torch.float64).mean()) > 0.25


def test_one_env_is_the_single_env_iteration(scenarios):
    pnet, pagents = scenarios["Grid4x4"][2:]
    pst = p_step.init_sim_state(pnet, pagents,
                                policy=p_step.Policy(choice=p_random_choice))
    ppo = _port_ppo(pnet, minibatch_size=4, num_epochs=2)
    port = BatchedPPO(ppo, make_mesh(1, device="cpu"), num_envs=1)
    bts = port.init(pst, p_rng.prng_key(4), torch.Generator().manual_seed(1))
    ts = ppo.init(pst, p_rng.prng_key(4), torch.Generator().manual_seed(1))
    # The single-environment state the batched one starts from: replica
    # 0's simulation key and the batched run's rollout and update keys.
    env0 = replica(bts.envs, 0)
    assert env0.sim.key == p_rng.fold_in(ts.env.sim.key, 0)
    ts = ts._replace(env=env0, obs=replica(bts.obss, 0), key=bts.keys[0])
    bts1, bm = port.train_step(bts)
    # The single-env iteration takes its update key from the rollout's.
    update = ppo._update_epochs
    ppo._update_epochs = lambda p, o, buf, adv, ret, key: update(
        p, o, buf, adv, ret, bts.update_key)
    ts1, m = ppo.train_iteration(ts)
    ppo._update_epochs = update
    for f in m._fields:
        assert torch.equal(getattr(m, f), getattr(bm, f)), f
    for part, sub in ts1.params.items():
        for k, v in sub.items():
            assert torch.equal(bts1.params[part][k], v), k
    assert bts1.update_key == ts1.key
    assert_tree_equal(convert.to_numpy(replica(bts1.envs, 0).sim),
                      convert.to_numpy(ts1.env.sim), "env")


def test_env_streams_are_decorrelated(runs):
    buf = runs["Grid4x4"]["probe"]["buffer"]
    actions = buf.action.reshape(B, T, -1)
    for i in range(B):
        for j in range(i + 1, B):
            assert not torch.equal(actions[i], actions[j]), (i, j)
    keys = runs["Grid4x4"]["pts1"].envs.sim.key
    assert len(set(keys)) == B


def test_batched_ppo_train_resumes_exactly(scenarios, tmp_path):
    pnet, pagents = scenarios["Braess"][2:]
    pst = p_step.init_sim_state(pnet, pagents,
                                policy=p_step.Policy(choice=p_random_choice))
    rl = PortRLConfig(**{**RL_KW, "minibatch_size": 8})
    port = BatchedPPO(_port_ppo(pnet, minibatch_size=8),
                      make_mesh(1, device="cpu"), num_envs=2)
    common = dict(rl=rl, key=p_rng.prng_key(3), verbose=False,
                  checkpoint_interval=1)
    full_dir = str(tmp_path / "full")
    full = ppo_train(port, pst, num_iterations=3, checkpoint_dir=full_dir,
                     generator=torch.Generator().manual_seed(4), **common)
    assert full.iteration == 3 and full.opt_state.count == 6
    saved = restore_checkpoint(os.path.join(full_dir, "ckpt_3"), "cpu")
    envs, obss, keys, update_key = saved["rollout"]
    assert envs.sim.agents.done.shape[0] == 2 and keys == full.keys
    assert update_key == full.update_key

    part_dir = str(tmp_path / "part")
    os.makedirs(part_dir)
    shutil.copy(os.path.join(full_dir, "ckpt_2"), part_dir)
    resumed = ppo_train(port, pst, num_iterations=3, checkpoint_dir=part_dir,
                        resume=True,
                        generator=torch.Generator().manual_seed(99), **common)
    assert resumed.iteration == 3
    assert resumed.keys == full.keys
    assert resumed.update_key == full.update_key
    for tree in (full.params, full.opt_state.mu, full.opt_state.nu):
        other = (resumed.params if tree is full.params else
                 resumed.opt_state.mu if tree is full.opt_state.mu
                 else resumed.opt_state.nu)
        for part, sub in tree.items():
            for k, v in sub.items():
                assert torch.equal(other[part][k], v), k
    for i in range(2):
        assert_tree_equal(convert.to_numpy(replica(resumed.envs, i).sim),
                          convert.to_numpy(replica(full.envs, i).sim),
                          f"env {i}")


def test_cli_num_envs_trains(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    common = ["--algo", "mpnn+ppo", "--scenario", "Braess",
              "--start-end-time", "21600", "21640", "--device", "cpu",
              "--mode", "train", "--iterations", "1", "--rollout-steps",
              "16"]
    one = runner_mod.main(common + ["--output-dir", "one"])
    three = runner_mod.main(common + ["--num-envs", "3", "--output-dir",
                                      "three"])
    assert isinstance(three.trainer, BatchedPPO)
    assert three.trainer.num_envs == 3
    assert three.train_state.envs.sim.agents.done.shape[0] == 3
    assert three.train_state.opt_state.count == 3  # 48 steps, mb 16
    def files(d):
        return sorted(f for f in os.listdir(d)
                      if not f.startswith("events.out.tfevents"))

    assert files("three") == files("one")
    assert os.listdir(os.path.join("three", "checkpoints")) == ["ckpt_1"]
    with open(os.path.join("three", "metrics.csv")) as f, \
            open(os.path.join("one", "metrics.csv")) as g:
        assert f.readline() == g.readline()
    restored = runner_mod.main(
        ["--algo", "mpnn+ppo", "--scenario", "Braess", "--start-end-time",
         "21600", "21640", "--device", "cpu", "--mode", "eval",
         "--checkpoint", os.path.join("three", "checkpoints"),
         "--output-dir", "eval"])
    assert_tree_equal(_bits(three.train_state.params),
                      _bits(restored.eval_params), "params")
    assert_tree_equal(_bits(three.sim.state), _bits(restored.sim.state),
                      "evaluated state")
