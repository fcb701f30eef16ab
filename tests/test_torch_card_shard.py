"""Road blocks with a learned policy and across processes on a card, with
no jax: on a card run

    python -m pytest --noconftest -m cuda tests/test_torch_card_shard.py

Marked ``cuda``; skips where no card is.  ``chip_smoke.py`` phase 29 (a)
and (d) at Grid4x4 size (5,000 commuters over 06:00-08:00): a sampled
learned MPNN (numpy-seeded weights) for 300 ticks on 4 road blocks, and
the headline's exact mode for 300 ticks on 4 blocks in 2 spawned gloo
processes and one NCCL process of world size 1 on card 0, each against
the serial run bitwise, with one K7 launch a tick (every rank) and no K1;
the last gloo rank's K7 launches bitwise its plain version's at a nonzero
first column.
"""
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

from tarl_tpu_torch.config import SimConfig  # noqa: E402
from tarl_tpu_torch.core.step import (  # noqa: E402
    Policy,
    init_sim_state,
    run_episode,
)
from tarl_tpu_torch.models.mpnn import MPNNPolicyNet  # noqa: E402
from tarl_tpu_torch.rl.learned_policy import make_learned_choice  # noqa: E402
from tarl_tpu_torch.routing.policies import random_choice  # noqa: E402
from tarl_tpu_torch.state import sort_agents_by_departure  # noqa: E402

SCENARIO = ("Grid4x4_5000", 4, 4, 5000)
TICKS = 300


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; chip_smoke.py phase 29 "
                    "runs the same paths")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_learned_mpnn_on_blocks(card):
    net, agents = chip_smoke.load_scenario(*SCENARIO, card)
    pnet = MPNNPolicyNet(net.num_nodes, net.num_roads + 1)
    g = np.random.default_rng(17)
    params = {k: torch.as_tensor(
        (0.3 * g.standard_normal(tuple(v.shape))).astype(np.float32),
        device=card) for k, v in sorted(pnet.state_dict().items())}
    policy = make_learned_choice(pnet, params, net)
    sim = SimConfig(start_time=6 * 3600)
    res = chip_smoke.blocks_run("29a at Grid4x4", net,
                                init_sim_state(net, agents, sim=sim,
                                               policy=policy),
                                policy, sim, (TICKS,))
    assert res["launches"]["K7"] == TICKS and res["on_road"] > 0


@pytest.mark.cuda
def test_headline_blocks_across_processes(card):
    net, agents = chip_smoke.load_scenario(*SCENARIO, card)
    agents = sort_agents_by_departure(agents)
    sim, policy = chip_smoke.headline_sim(), Policy(choice=random_choice)
    want, _ = run_episode(init_sim_state(net, agents, sim=sim,
                                         policy=policy),
                          net, policy, TICKS, sim=sim)
    groups = (("gloo", 2, 4), ("nccl", 1, 4))
    res = chip_smoke.spawn_blocks(groups, TICKS, SCENARIO, "cuda:0")
    chip_smoke.check_processes(res, chip_smoke._state_bits(want), TICKS,
                               True)
    assert sorted(res) == [("gloo", 0), ("gloo", 1), ("nccl", 0)]
