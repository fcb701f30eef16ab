"""Sharded and spatial PPO training on a card, with no jax: on a card run

    python -m pytest --noconftest -m cuda tests/test_torch_card_ppo_shard.py

Marked ``cuda``; skips where no card is.  ``chip_smoke.py`` phase 30 (a),
(c), (e) and (f) at Grid4x4 size (5,000 commuters over 06:00-08:00,
``chip_smoke.learned_ppo``'s settings with minibatches of 32, weights
drawn by ``PPO.init`` from a seed): ``ShardedPPO`` and ``SpatialPPO`` on 4
blocks against ``PPO.train_iteration`` (trajectories bitwise, every
update's gradients within 1e-5 of the unsharded ones at the same
parameters, parameters within Adam's reach, one K1, K11 and K10 launch a
collection step; K7 once a spatial step and K1 never), K7's kept
launches that move someone bitwise its plain version, ``dryrun_multichip(2,
"gloo")`` on the card, and the legacy confirm's K10 bare max bitwise the
plain max on captured states.
"""
import dataclasses
import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

from tarl_tpu_torch.config import SimConfig  # noqa: E402
from tarl_tpu_torch.core import rng  # noqa: E402
from tarl_tpu_torch.core.step import (  # noqa: E402
    Policy,
    init_sim_state,
    run_episode,
)
from tarl_tpu_torch.parallel.dryrun import dryrun_multichip  # noqa: E402
from tarl_tpu_torch.routing.policies import random_choice  # noqa: E402

SCENARIO = ("Grid4x4_5000", 4, 4, 5000)
STEPS = 256


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; chip_smoke.py phase 30 "
                    "runs the same paths")
    torch.backends.cuda.matmul.allow_tf32 = False
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def setup(card):
    net, agents = chip_smoke.load_scenario(*SCENARIO, card)
    st = init_sim_state(net, agents, policy=Policy(choice=random_choice))

    def make_ppo():
        ppo = chip_smoke.learned_ppo(net)
        ppo.rl = dataclasses.replace(ppo.rl, rollout_steps=STEPS,
                                     minibatch_size=32)
        return ppo

    ppo = make_ppo()
    ts = ppo.init(st, rng.prng_key(0), torch.Generator().manual_seed(0))
    return net, agents, make_ppo, ts


@pytest.mark.cuda
def test_sharded_and_spatial_training(setup):
    net, _, make_ppo, ts = setup
    a = chip_smoke.sharded_training("card 30a", make_ppo, ts, "test",
                                    relative=False)
    assert a["launches"]["K1"] == a["launches"]["K10"] == STEPS
    assert a["grad_err"] < 1e-5
    c = chip_smoke.spatial_training(
        make_ppo, ts, chip_smoke.traj_bits(a["rec_u"]["trajs"][0]),
        a["ts_u"], "test")
    assert c["launches"]["K7"] == STEPS and c["launches"]["K1"] == 0
    assert c["k7_err"] == 0 and c["grad_err"] < 1e-5


@pytest.mark.cuda
def test_dryrun_on_the_card(card):
    lines = dryrun_multichip(2, "gloo")
    assert len(lines) == 12


@pytest.mark.cuda
def test_response_step_bare_max(setup):
    net, agents, _, _ = setup
    sim = SimConfig(start_time=6 * 3600)
    policy = Policy(choice=random_choice)
    st = init_sim_state(net, agents, sim=sim, policy=policy)
    captured = []
    for _ in range(3):
        st, _ = run_episode(st, net, policy, 300, sim=sim)
        captured.append(st)
    f = chip_smoke.response_phase(net, captured, "test")
    assert f["launches"]["K10"] == 3 and f["accepted"] > 0
