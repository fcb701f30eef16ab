"""The Graph Transformer policy on a card, with no jax: on a card run

    python -m pytest --noconftest -m cuda tests/test_torch_card_transformer.py

Marked ``cuda``; skips where no card is.

* ``chip_smoke.py`` phase 27a's first 300 steps: the committed Braess
  weights (``tarl_tpu_torch/weights/braess_transformer_best.npz``, with
  their encoding) through the greedy ``PPO.eval_rollout`` at
  ``scripts/train_rl_demo.py``'s settings, under
  ``torch.use_deterministic_algorithms(True)``, once with the kernels (K1
  and K11's action entry once a step) and once with ``PLAIN`` and the plain
  K1 (no launch): the two environments bitwise equal.
* The slot twin against the flat forward on the card, at atol/rtol 2e-5
  on every valid slot: the Braess weights on Braess and on Grid8x8 (the
  port's encoding of it), from seeded contexts.
"""
import os

import numpy as np
import pytest
import torch
from torch.func import functional_call

from tarl_tpu_torch.config import RLConfig
from tarl_tpu_torch.convert import (
    load_params_npz,
    to_numpy,
    mpnn_params_from_numpy,
)
from tarl_tpu_torch.core import fused_winner, rng
from tarl_tpu_torch.core.step import Policy, init_sim_state
from tarl_tpu_torch.io.matsim import load_network, load_population
from tarl_tpu_torch.io.scenarios import ensure_scenario
from tarl_tpu_torch.models.transformer.agent import (
    TransformerRoutePolicy,
    TransformerValueNet,
    network_positional_encoding,
)
from tarl_tpu_torch.models.transformer.slot_forward import (
    slot_edge_tables,
    slot_twin,
)
from tarl_tpu_torch.ops import segment as seg
from tarl_tpu_torch.rl.env import env_reset, env_step
from tarl_tpu_torch.rl.ppo import PPO
from tarl_tpu_torch.routing.policies import random_choice

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, "tarl_tpu_torch", "weights",
                       "braess_transformer_best.npz")
# scripts/train_rl_demo.py's RL settings.
RL = dict(rollout_steps=512, minibatch_size=128, num_epochs=4,
          entropy_coef=0.003, learning_rate=1e-3, reward_mode="progress",
          gamma=0.98, gae_lambda=0.9)
STEPS = 300


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; chip_smoke.py phase 27 "
                    "runs the same paths")
    return torch.device("cuda", 0)


def _load(card, root, name):
    base = ensure_scenario(root, name)
    net = load_network(os.path.join(base, "network"), device=card)
    agents, _ = load_population(os.path.join(base, "population"),
                                os.path.join(base, "network"), device=card)
    return net, agents


def _flat(tree, path="env"):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{path}.{k}")
    elif tree is not None:
        yield path, np.asarray(tree)


@pytest.mark.cuda
def test_braess_eval_kernels_equal_plain(card, tmp_path):
    net, agents = _load(card, str(tmp_path), "Braess")
    tree = load_params_npz(WEIGHTS)
    params = mpnn_params_from_numpy(tree, card)
    pe = tree["pe"]
    ppo = PPO(net, TransformerRoutePolicy(pe), TransformerValueNet(pe),
              rl=RLConfig(**RL), value_uses_graph=True)
    st = init_sim_state(net, agents, policy=Policy(choice=random_choice))
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        # The kernel run written out step by step, its actions kept.
        key = rng.prng_key(0)
        env, obs = env_reset(st, net, ppo.rl, ppo.physics, ppo._dist_ff)
        fused_winner.reset_launches()
        seg.reset_launches()
        actions = []
        for _ in range(STEPS):
            key, k = rng.split(key)
            action = ppo.act(params, env, obs, k)
            actions.append(action)
            env, obs, *_ = env_step(env, action, net, ppo.rl, ppo.sim_cfg,
                                    ppo.physics, dist_ff=ppo._dist_ff)
        torch.cuda.synchronize()
        kernel = (fused_winner.LAUNCHES, seg.ARGMAX_LAUNCHES)
        fused_winner.reset_launches()
        seg.reset_launches()
        plain, *_ = ppo.eval_rollout(
            params, st, rng.prng_key(0), STEPS, segment_ops=seg.PLAIN,
            core=fused_winner.direction_confirm_plain)
        torch.cuda.synchronize()
        assert (fused_winner.LAUNCHES, seg.ARGMAX_LAUNCHES) == (0, 0)
    finally:
        torch.use_deterministic_algorithms(was)
    assert kernel == (STEPS, STEPS)
    a = dict(_flat(to_numpy(env.sim)))
    b = dict(_flat(to_numpy(plain.sim)))
    for path, x in a.items():
        assert x.dtype == b[path].dtype and np.array_equal(x, b[path]), path
    assert torch.stack(actions).any(dim=1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["Braess", "Grid8x8"])
def test_slot_twin_equals_the_flat_forward(card, tmp_path, name):
    net, _ = _load(card, str(tmp_path), name)
    tree = load_params_npz(WEIGHTS)
    params = mpnn_params_from_numpy(tree, card)["policy"]
    pe = tree["pe"] if name == "Braess" else network_positional_encoding(
        net, 16)
    policy = TransformerRoutePolicy(pe).to(card)
    twin = slot_twin(policy)
    tables = slot_edge_tables(net)
    n = net.num_nodes
    cols = torch.arange(n, dtype=torch.int32, device=card)
    src = net.full_src.cpu().numpy()
    rank = np.array([np.sum(src[:i] == s) for i, s in enumerate(src)])
    g = np.random.default_rng(11)
    with torch.no_grad():
        for _ in range(3):
            x = torch.as_tensor((g.normal(size=(n, 16)) * 20.0)
                                .astype(np.float32), device=card)
            slot = functional_call(twin, params, (x, tables, cols))
            flat = functional_call(policy, params,
                                   (x, net.full_attr.reshape(-1, 1),
                                    net.full_src, net.full_dst))
            got = slot.cpu().numpy()[rank, src]
            np.testing.assert_allclose(got, flat.cpu().numpy(), rtol=2e-5,
                                       atol=2e-5)
