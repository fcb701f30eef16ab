"""The port's command line (``tarl_tpu_torch.runner``, ``main_torch.py``)
against the reference's (``tarl_tpu.runner``).

* The reference's CLI tests (``tests/test_cli.py``), on the port:
  setup/train/eval sequencing, argument forwarding, an unknown algorithm
  refused; and ``--num-envs`` above 1, refused until the batched trainer
  was ported, setting up a ``BatchedPPO`` on the one-device mesh for every
  learned algorithm (its training: ``test_torch_batched.py``).
* The README's evaluation, ``--algo dijkstra --scenario Easy --mode eval
  --start-end-time 21600 28800 --timestep_size 2``, through both CLIs (the
  port's with ``--device cpu``): the average travel time and the done
  count equal, ``node_metrics.csv`` byte-identical, and
  ``equilibrium_report.json`` within ``test_torch_equilibrium.py``'s
  tolerances (numbers rtol 1e-4, gaps near 0 atol 1e-6, Frank-Wolfe's flat
  L1 step ``msa_gap_ue`` on Easy within 5%; counts, flags and the method
  equal).
* ``--mode train`` (``mpnn+ppo``, one iteration on Braess) writes a
  checkpoint that ``--checkpoint`` restores bitwise, and whose evaluation
  equals the trained run's, bitwise.
* ``--checkpoint tarl_tpu_torch/weights/grid8x8_mpnn_best.npz``: the
  learned evaluation equals a direct ``PPO.eval_rollout`` call, bitwise.
* The transformer: ``--algo transformer+ppo --mode train`` (one iteration
  of 16 steps on Braess) writes its checkpoint and reports, and
  ``--checkpoint`` restores the trained parameters bitwise;
  ``--algo transformer --mode eval`` runs from an initial draw; and
  ``--checkpoint tarl_tpu_torch/weights/braess_transformer_best.npz``
  evaluates with the encoding the file carries, equal to a direct
  ``PPO.eval_rollout`` call with it, bitwise.
"""
import json
import os

import numpy as np
import pytest
import torch

from tarl_tpu import runner as ref_runner

from tarl_tpu_torch import convert
from tarl_tpu_torch import runner as runner_mod
from tarl_tpu_torch.config import RLConfig, SimConfig
from tarl_tpu_torch.core.rng import prng_key
from tarl_tpu_torch.core.step import Policy, init_sim_state
from tarl_tpu_torch.io.cache import (
    load_or_build_network, load_or_build_population)
from tarl_tpu_torch.models.mpnn import MPNNPolicyNet, MPNNValueNetSimple
from tarl_tpu_torch.parallel.shard import BatchedPPO
from tarl_tpu_torch.rl.ppo import PPO
from tarl_tpu_torch.routing.policies import random_choice

from test_torch_network import assert_tree_equal

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
README_EVAL = ["--algo", "dijkstra", "--scenario", "Easy", "--mode", "eval",
               "--start-end-time", "21600", "28800", "--timestep_size", "2"]
WEIGHTS = os.path.join(REPO, "tarl_tpu_torch", "weights",
                       "grid8x8_mpnn_best.npz")
GT_WEIGHTS = os.path.join(REPO, "tarl_tpu_torch", "weights",
                          "braess_transformer_best.npz")


@pytest.fixture
def recorded(monkeypatch):
    calls = []
    monkeypatch.setattr(runner_mod.Runner, "setup",
                        lambda self: calls.append("setup"))
    monkeypatch.setattr(runner_mod.Runner, "train",
                        lambda self: calls.append("train"))
    monkeypatch.setattr(runner_mod.Runner, "eval",
                        lambda self: calls.append("eval"))
    return calls


def test_eval_mode_sequencing(recorded):
    runner_mod.main(["--algo", "dijkstra", "--mode", "eval"])
    assert recorded == ["setup", "eval"]


def test_train_mode_sequencing(recorded):
    runner_mod.main(["--algo", "mpnn+ppo", "--mode", "train"])
    assert recorded == ["setup", "train", "eval"]


def test_args_forwarded(monkeypatch):
    captured = {}

    def fake_setup(self):
        captured.update(vars(self.args))

    monkeypatch.setattr(runner_mod.Runner, "setup", fake_setup)
    monkeypatch.setattr(runner_mod.Runner, "eval", lambda self: None)
    runner_mod.main([
        "--algo", "random", "--scenario", "Braess", "--timestep_size", "5",
        "--start-end-time", "21600", "28800", "--seed", "7",
        "--exec", "eager", "--device", "cpu",
    ])
    assert captured["algo"] == "random"
    assert captured["scenario"] == "Braess"
    assert captured["timestep_size"] == 5
    assert captured["start_end_time"] == (21600, 28800)
    assert captured["seed"] == 7
    assert captured["exec_mode"] == "eager"
    assert captured["device"] == "cpu"


def test_unknown_algo_rejected():
    with pytest.raises(SystemExit):
        runner_mod.main(["--algo", "nonsense"])


@pytest.mark.parametrize("argv", [
    ["--algo", "transformer", "--num-envs", "2"],
    ["--algo", "transformer+ppo", "--num-envs", "2"],
    ["--algo", "mpnn+ppo", "--num-envs", "2"]])
def test_not_ported_paths_refused(argv, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    args = runner_mod.build_parser().parse_args(argv + ["--device", "cpu"])
    r = runner_mod.Runner(runner_mod.RunnerArgs(
        algo=args.algo, scenario="Braess", num_envs=args.num_envs,
        device="cpu"))
    r.setup()
    assert isinstance(r.trainer, BatchedPPO) and r.trainer.ppo is r.ppo
    assert r.trainer.num_envs == 2
    assert r.trainer.mesh.shape == {"dp": 1, "sp": 1}
    assert r.trainer.mesh.devices == [torch.device("cpu")]


def test_device_defaults_to_the_card(monkeypatch):
    assert runner_mod.RunnerArgs().device == "cuda"
    assert runner_mod.build_parser().parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runner_mod.Runner(runner_mod.RunnerArgs()).setup()


def test_readme_evaluation_matches_the_reference(tmp_path, monkeypatch):
    captured = {}
    summary = ref_runner.Runner._summary

    def spy(self, sim):
        captured["sim"] = sim
        return summary(self, sim)

    monkeypatch.setattr(ref_runner.Runner, "_summary", spy)
    monkeypatch.chdir(tmp_path)
    ref_runner.main(README_EVAL + ["--output-dir", "ref"])
    port = runner_mod.main(README_EVAL + ["--output-dir", "port",
                                          "--device", "cpu"])
    ref_sim, port_sim = captured["sim"], port.sim
    assert port_sim.average_travel_time() == ref_sim.average_travel_time()
    assert int(port_sim.state.agents.done[1:].sum()) == int(
        np.asarray(ref_sim.state.agents.done[1:]).sum())
    with open("ref/node_metrics.csv", "rb") as a, \
            open("port/node_metrics.csv", "rb") as b:
        assert a.read() == b.read()
    want = json.load(open("ref/equilibrium_report.json"))
    got = json.load(open("port/equilibrium_report.json"))
    assert list(want) == list(got)
    for k, v in want.items():
        if isinstance(v, (bool, str, int)) and not isinstance(v, float):
            assert got[k] == v, k
        elif k.startswith("rel_gap"):
            np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-6,
                                       err_msg=k)
        elif k == "msa_gap_ue":
            np.testing.assert_allclose(got[k], v, rtol=0.05, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], v, rtol=1e-4, err_msg=k)
    for name in ("computation_time.png", "leg_histogram.png",
                 "road_optimality.png", "daily_counts.png",
                 "daily_counts.csv"):
        assert os.path.exists(os.path.join("port", name)), name


def _bits(tree):
    """Parameter dicts and port objects as nested numpy dicts."""
    if isinstance(tree, dict):
        return {k: _bits(v) for k, v in tree.items()}
    return convert.to_numpy(tree)


def test_train_checkpoint_restores_bitwise(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    common = ["--algo", "mpnn+ppo", "--scenario", "Braess",
              "--start-end-time", "21600", "21660", "--device", "cpu"]
    trained = runner_mod.main(common + ["--mode", "train", "--iterations",
                                        "1", "--output-dir", "train"])
    assert os.path.exists(os.path.join("train", "checkpoints", "ckpt_1"))
    restored = runner_mod.main(common + [
        "--mode", "eval", "--checkpoint", os.path.join("train",
                                                       "checkpoints"),
        "--output-dir", "eval"])
    assert_tree_equal(_bits(trained.train_state.params),
                      _bits(restored.eval_params), "params")
    assert_tree_equal(_bits(trained.sim.state), _bits(restored.sim.state),
                      "evaluated state")
    assert trained.sim.leg_histogram_values == \
        restored.sim.leg_histogram_values


def test_npz_evaluation_equals_eval_rollout(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(runner_mod.Runner, "_summary", lambda self, sim: None)
    start, steps = 21540, 240
    r = runner_mod.main(["--algo", "mpnn", "--scenario", "Grid8x8",
                         "--start-end-time", str(start), str(start + steps),
                         "--checkpoint", WEIGHTS, "--device", "cpu"])
    net = load_or_build_network("Grid8x8", device="cpu")
    agents = load_or_build_population("Grid8x8", device="cpu")
    rl = RLConfig(episode_start=start, reward_mode="progress", gamma=0.98,
                  gae_lambda=0.9, minibatch_size=32, entropy_coef=0.003)
    sim_cfg = SimConfig(timestep=1, start_time=start,
                        end_time=start + steps)
    ppo = PPO(net, MPNNPolicyNet(net.num_nodes, net.num_roads + 1,
                                 use_distance_prior=True, prior_scale=30.0),
              MPNNValueNetSimple(net.num_nodes), rl=rl, sim_cfg=sim_cfg)
    state = init_sim_state(net, agents, sim=sim_cfg,
                           policy=Policy(choice=random_choice))
    params = convert.mpnn_params_from_numpy(
        convert.load_params_npz(WEIGHTS), "cpu")
    env, _, _, logs = ppo.eval_rollout(params, state, prng_key(0), steps)
    assert_tree_equal(_bits(params), _bits(r.eval_params), "params")
    assert_tree_equal(_bits(env.sim), _bits(r.sim.state), "final state")
    assert [row[1:] for row in r.sim.leg_histogram_values] == [
        [float(a), float(o), float(t)] for a, o, t in zip(
            logs["arrivals"].tolist(), logs["on_network"].tolist(),
            logs["time"].tolist())]
    assert float(logs["on_network"][-1]) > 0


def test_transformer_train_writes_checkpoint_and_reports(tmp_path,
                                                         monkeypatch):
    monkeypatch.chdir(tmp_path)
    common = ["--algo", "transformer+ppo", "--scenario", "Braess",
              "--start-end-time", "21600", "21660", "--device", "cpu"]
    trained = runner_mod.main(common + [
        "--mode", "train", "--iterations", "1", "--rollout-steps", "16",
        "--output-dir", "train"])
    assert trained.ppo.value_uses_graph
    assert os.path.exists(os.path.join("train", "checkpoints", "ckpt_1"))
    for name in ("node_metrics.csv", "equilibrium_report.json",
                 "metrics.csv"):
        assert os.path.exists(os.path.join("train", name)), name
    report = json.load(open(os.path.join("train", "equilibrium_report.json")))
    assert np.isfinite(report["tstt_simulated"])
    restored = runner_mod.main(common + [
        "--mode", "eval", "--checkpoint", os.path.join("train",
                                                       "checkpoints"),
        "--output-dir", "eval"])
    assert_tree_equal(_bits(trained.train_state.params),
                      _bits(restored.eval_params), "params")
    # From an initial draw, with no checkpoint.
    fresh = runner_mod.main(["--algo", "transformer", "--scenario", "Braess",
                             "--mode", "eval", "--start-end-time", "21600",
                             "21660", "--device", "cpu", "--output-dir",
                             "fresh"])
    assert fresh.sim.leg_histogram_values
    assert os.path.exists(os.path.join("fresh", "equilibrium_report.json"))


def test_transformer_npz_evaluation_uses_its_encoding(tmp_path, monkeypatch):
    from tarl_tpu_torch.models.transformer.agent import (
        TransformerRoutePolicy,
        TransformerValueNet,
    )

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(runner_mod.Runner, "_summary", lambda self, sim: None)
    start, steps = 21600, 120
    r = runner_mod.main(["--algo", "transformer", "--scenario", "Braess",
                         "--start-end-time", str(start), str(start + steps),
                         "--checkpoint", GT_WEIGHTS, "--device", "cpu"])
    tree = convert.load_params_npz(GT_WEIGHTS)
    np.testing.assert_array_equal(r.policy_net.pe.numpy(), tree["pe"])
    np.testing.assert_array_equal(r.value_net.pe.numpy(), tree["pe"])
    net = load_or_build_network("Braess", device="cpu")
    agents = load_or_build_population("Braess", device="cpu")
    rl = RLConfig(episode_start=start, reward_mode="progress", gamma=0.98,
                  gae_lambda=0.9, minibatch_size=32, entropy_coef=0.003)
    sim_cfg = SimConfig(timestep=1, start_time=start, end_time=start + steps)
    ppo = PPO(net, TransformerRoutePolicy(tree["pe"]),
              TransformerValueNet(tree["pe"]), rl=rl, sim_cfg=sim_cfg,
              value_uses_graph=True)
    state = init_sim_state(net, agents, sim=sim_cfg,
                           policy=Policy(choice=random_choice))
    params = convert.mpnn_params_from_numpy(tree, "cpu")
    env, _, _, _ = ppo.eval_rollout(params, state, prng_key(0), steps)
    assert_tree_equal(_bits(params), _bits(r.eval_params), "params")
    assert_tree_equal(_bits(env.sim), _bits(r.sim.state), "final state")
