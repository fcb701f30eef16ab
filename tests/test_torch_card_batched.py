"""The batched trainer on a card, with no jax: on a card run

    python -m pytest --noconftest -m cuda tests/test_torch_card_batched.py

Marked ``cuda``; skips where no card is.  ``chip_smoke.py`` phase 28b at a
small size: one ``BatchedPPO.train_step`` at Grid4x4 (3 replicas of 32
steps, two epochs of three minibatches of 32) under deterministic
algorithms, once with the kernels in the collection and once with
``PLAIN`` and the plain K1: one K1, K11 and K10 launch a replica step with
the kernels, none with the plain versions and none in GAE or the update;
the ``[3, 32]`` actions, rewards, dones and values bitwise, log-probs
within rtol 1e-5, atol 1e-5; the parameters within twice the learning
rate times the updates (Adam's reach: ``chip_smoke.py`` phase 21 states
why).
"""
import os

import pytest
import torch

from tarl_tpu_torch.config import RLConfig
from tarl_tpu_torch.core import fused_winner, rng
from tarl_tpu_torch.core.step import Policy, init_sim_state
from tarl_tpu_torch.io.matsim import load_network, load_population
from tarl_tpu_torch.io.scenarios import ensure_scenario
from tarl_tpu_torch.models.mpnn import MPNNPolicyNet, MPNNValueNetSimple
from tarl_tpu_torch.ops import segment as seg
from tarl_tpu_torch.parallel.mesh import make_mesh
from tarl_tpu_torch.parallel.shard import BatchedPPO
from tarl_tpu_torch.rl.ppo import PPO
from tarl_tpu_torch.routing.policies import random_choice


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; chip_smoke.py phase 28 "
                    "runs the same path")
    return torch.device("cuda", 0)


def _counts():
    return {"K1": fused_winner.LAUNCHES, "K9": seg.SUM_LAUNCHES,
            "K10": seg.MAX_LAUNCHES, "K11": seg.ARGMAX_LAUNCHES}


def _reset():
    fused_winner.reset_launches()
    seg.reset_launches()


@pytest.mark.cuda
def test_batched_step_kernels_against_plain(card, tmp_path):
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    assert not torch.backends.cuda.matmul.allow_tf32
    base = ensure_scenario(str(tmp_path), "Grid4x4")
    net = load_network(os.path.join(base, "network"), device=card)
    agents, stats = load_population(os.path.join(base, "population"),
                                    os.path.join(base, "network"),
                                    device=card)
    assert stats.parser == "native"
    st = init_sim_state(net, agents, policy=Policy(choice=random_choice))
    lr, steps, envs = 1e-3, 32, 3
    rl = RLConfig(rollout_steps=steps, minibatch_size=32, num_epochs=2,
                  entropy_coef=0.003, learning_rate=lr,
                  reward_mode="progress", gamma=0.98, gae_lambda=0.9,
                  episode_start=21600)
    ppo = PPO(net, MPNNPolicyNet(net.num_nodes, net.num_roads + 1,
                                 use_distance_prior=True, prior_scale=30.0),
              MPNNValueNetSimple(net.num_nodes), rl=rl)
    trainer = BatchedPPO(ppo, make_mesh(1, device=card), envs)
    ts = trainer.init(st, rng.prng_key(0), torch.Generator().manual_seed(0))
    trajs, phases = {}, {}
    collect, update = ppo.collect_rollout, ppo._update_epochs

    def keep(*args, **kw):
        out = collect(*args, **kw)
        trajs.setdefault(label, []).append(out[3])
        return out

    def counted_update(*args, **kw):
        torch.cuda.synchronize()
        phases[label] = _counts()
        out = update(*args, **kw)
        torch.cuda.synchronize()
        phases[label] = {k: v - phases[label][k]
                         for k, v in _counts().items()}
        return out

    ppo.collect_rollout, ppo._update_epochs = keep, counted_update
    outs, launches = {}, {}
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        for label, ops, core in (
                ("kernels", seg.KERNELS, fused_winner.direction_confirm),
                ("plain", seg.PLAIN, fused_winner.direction_confirm_plain)):
            _reset()
            outs[label] = trainer.train_step(ts, ops, core)
            torch.cuda.synchronize()
            launches[label] = _counts()
    finally:
        torch.use_deterministic_algorithms(was)
    n = envs * steps
    assert launches["kernels"] == {"K1": n, "K9": 0, "K10": n, "K11": n}
    assert launches["plain"] == {"K1": 0, "K9": 0, "K10": 0, "K11": 0}
    assert phases["kernels"] == phases["plain"] == {
        "K1": 0, "K9": 0, "K10": 0, "K11": 0}
    for f in ("action", "reward", "done", "value", "log_prob"):
        k = torch.stack([getattr(t, f) for t in trajs["kernels"]])
        p = torch.stack([getattr(t, f) for t in trajs["plain"]])
        assert tuple(k.shape[:2]) == (envs, steps)
        if f == "log_prob":
            torch.testing.assert_close(k, p, rtol=1e-5, atol=1e-5)
        else:
            assert torch.equal(k, p), f
    for m in outs["kernels"][1]:
        assert bool(torch.isfinite(m))
    updates = outs["kernels"][0].opt_state.count
    assert updates == 2 * 3
    a, b = outs["kernels"][0].params, outs["plain"][0].params
    d = torch.cat([(a[q][k] - b[q][k]).abs().reshape(-1) for q in a
                   for k in a[q]])
    assert float(d.max()) <= 2 * lr * updates
