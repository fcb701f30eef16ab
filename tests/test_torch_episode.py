"""The port's slice as a whole against the JAX reference, bitwise.

Two episodes run on both packages from the same scenario files and seed:

* Grid8x8 in the headline's exact mode (departure-sorted population, per-SRC
  backlog insert with W=32 and Q=256, withdraw depth 2, both escalations,
  no per-tick road-optimality series) for 400 ticks from 06:00; the
  reference's overflow monitor must read 0 over the run;
* Grid4x4 with the default ``SimConfig`` apart from the start time (06:00,
  so that agents depart) for 300 ticks: whole-population insert, unbounded
  withdraw, per-tick road-optimality series on.

The final ``SimState`` (rings, heads, counts, agent columns, backlog
queues, pointer, metrics, key) and every ``TickLog`` field must be equal in
dtype, shape and value.  Each side draws its own Gumbel noise.
"""
import numpy as np
import pytest
import torch

from tarl_tpu.config import SimConfig
from tarl_tpu.core.step import (
    Policy,
    average_travel_time,
    init_sim_state,
    run_episode,
)
from tarl_tpu.routing.policies import random_choice
from tarl_tpu.state import sort_agents_by_departure

from tarl_tpu_torch import convert
from tarl_tpu_torch.config import SimConfig as PortSimConfig
from tarl_tpu_torch.core import step as p_step
from tarl_tpu_torch.routing.policies import random_choice as p_random_choice
from tarl_tpu_torch.state import sort_agents_by_departure as p_sort

from test_torch_network import assert_tree_equal, load_both

torch.set_num_threads(1)

START = 6 * 3600
CASES = {
    "grid8_exact": ("Grid8x8", 400, True, dict(
        start_time=START, end_time=START + 400,
        record_road_optimality=False, insert_window=32, insert_backlog=256,
        withdraw_depth=2, sorted_population=True, insert_escalate=True,
        withdraw_escalate=True)),
    "grid4_default": ("Grid4x4", 300, False, dict(start_time=START)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_episode_bitwise(tmp_path, case):
    scenario, steps, sort, cfg = CASES[case]
    net, agents, pnet, pagents = load_both(str(tmp_path), scenario)
    if sort:
        agents, pagents = sort_agents_by_departure(agents), p_sort(pagents)

    sim = SimConfig(**cfg)
    policy = Policy(choice=random_choice)
    state = init_sim_state(net, agents, sim=sim, policy=policy)
    final, logs = run_episode(state, net, policy, steps, sim=sim)

    psim = PortSimConfig(**cfg)
    ppolicy = p_step.Policy(choice=p_random_choice)
    pstate = p_step.init_sim_state(pnet, pagents, sim=psim, policy=ppolicy)
    assert_tree_equal(convert.to_numpy(state), convert.to_numpy(pstate),
                      "initial state")
    pfinal, plogs = p_step.run_episode(pstate, pnet, ppolicy, steps,
                                       sim=psim)

    assert_tree_equal(convert.to_numpy(final), convert.to_numpy(pfinal),
                      "final state")
    assert_tree_equal(convert.to_numpy(logs), convert.to_numpy(plogs), "logs")

    assert float(np.asarray(logs.window_saturated).sum()) == 0.0
    done = int(pfinal.agents.done.sum())
    assert done > 0
    assert int(pfinal.road.count.sum()) == int(pfinal.agents.on_way.sum())
    # A float32 mean over agents: the two sums add in different orders.
    np.testing.assert_allclose(
        float(p_step.average_travel_time(pfinal.agents)),
        float(np.asarray(average_travel_time(final.agents))), rtol=1e-6)
