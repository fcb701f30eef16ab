"""The dual routing backend's row on a card, with no jax: on a card run

    python -m pytest --noconftest -m cuda tests/test_torch_card_dual.py

Marked ``cuda``; skips where no card is.

The dual row of ``chip_smoke.py`` phase 24b (Grid16x16, 50,000 commuters
departing 06:00-08:00, sorted; ``make_policy("dijkstra")`` with the
default routing, the dual backend at N = 1,472; windowed insert W=1,024,
withdraw depth 2, no escalation) for its first 300 ticks of
``run_episode_periodic``, once with K1 and once with its plain version:
one K1 launch a tick in the first, none in the second, and the two final
states bitwise equal, the next-hop table included.
"""
import os

import numpy as np
import pytest
import torch

from tarl_tpu_torch.config import RoutingConfig, SimConfig
from tarl_tpu_torch.convert import to_numpy
from tarl_tpu_torch.core import fused_winner
from tarl_tpu_torch.core.step import init_sim_state, run_episode_periodic
from tarl_tpu_torch.io.matsim import load_network, load_population
from tarl_tpu_torch.io.scenarios import grid_scenario
from tarl_tpu_torch.simulator import make_policy
from tarl_tpu_torch.state import sort_agents_by_departure

TICKS = 300


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; chip_smoke.py phase 24 "
                    "runs the same path")
    return torch.device("cuda", 0)


def _flat(tree, path="state"):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{path}.{k}")
    elif tree is not None:
        yield path, np.asarray(tree)


@pytest.mark.cuda
def test_dual_row_k1_equals_plain_in_context(card, tmp_path):
    name = "Grid16x16_50000"
    grid_scenario(str(tmp_path), name, rows=16, cols=16, num_agents=50000,
                  peak_start=6 * 3600, peak_spread=2 * 3600)
    base = os.path.join(str(tmp_path), name)
    net = load_network(os.path.join(base, "network"), device=card)
    agents, _ = load_population(os.path.join(base, "population"),
                                os.path.join(base, "network"), device=card)
    agents = sort_agents_by_departure(agents)
    assert net.num_nodes == 1472
    policy = make_policy("dijkstra", RoutingConfig(), network=net)
    assert policy.needs_next_hop and policy.periodic_rate == 10
    sim = SimConfig(timestep=1, start_time=6 * 3600,
                    record_road_optimality=False, insert_window=1024,
                    withdraw_depth=2, sorted_population=True,
                    insert_escalate=False, withdraw_escalate=False)
    finals, launches = {}, {}
    for label, core in (("K1", fused_winner.direction_confirm),
                        ("plain", fused_winner.direction_confirm_plain)):
        state = init_sim_state(net, agents, sim=sim, policy=policy)
        fused_winner.reset_launches()
        final, _ = run_episode_periodic(state, net, policy, TICKS, sim=sim,
                                        core=core)
        torch.cuda.synchronize()
        launches[label] = fused_winner.LAUNCHES
        finals[label] = dict(_flat(to_numpy(final)))
    assert launches == {"K1": TICKS, "plain": 0}
    for path, a in finals["K1"].items():
        b = finals["plain"][path]
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b), path
    assert finals["K1"]["state.agents.inserted"].sum() > 0
