"""The port's equilibrium metrics and static assignment against the JAX
reference, on the states of the reference's own dual dijkstra episodes
(Braess, Easy, Bottleneck).

Tolerances (float32 sums run in another order on each package):

* ``tstt``, ``nash_gap`` (its shortest paths are bitwise), ``bpr_cost``,
  ``bpr_marginal_cost`` and ``tstt_from_flows``: rtol 1e-5.
* ``solve_msa`` and ``solve_frank_wolfe``, UE and SO: the same iteration
  count and flows within rtol 1e-5, atol 1e-3; the final gaps within
  rtol 1e-4 or atol 1e-6 (gaps near 0).  Frank-Wolfe's UE and SO on Easy
  are the exception: the Beckmann objective is flat along the direction,
  the line search's derivative ``sum(d c(f + lam d))`` changes sign
  within the sum's rounding, and the two packages take steps that differ
  by up to 1% of a road's flow; there the test holds the objective's
  numbers (TSTT of the flows within rtol 1e-4, both relative gaps under
  the tolerance) and the iteration count.
* ``run_msa``: as the solver; ``run_msa_host`` (NumPy float64 on both):
  equal.
* ``equilibrium_report``: numbers within rtol 1e-4 (gaps near 0 at atol
  1e-6; on Easy the L1 step ``msa_gap_ue`` of the flat line search within
  5%), counts, flags and the method equal.
* ``ppo_train``'s ``eval/tstt`` and ``eval/relative_nash_gap`` at
  Grid8x8 against the reference's formula on the evaluation's final
  state: rtol 1e-5.

Run as a script, ``PYTHONPATH=. JAX_PLATFORMS=cpu python
tests/test_torch_equilibrium.py`` prints the reference's numbers for
``chip_smoke.py``'s classical rows.
"""
import csv
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tarl_tpu.algorithms import msa as ref_msa
from tarl_tpu.config import MSAConfig, SimConfig
from tarl_tpu.core.step import init_sim_state, run_episode
from tarl_tpu.metrics import equilibrium as ref_eq
from tarl_tpu.simulator import make_policy

from tarl_tpu_torch import convert
from tarl_tpu_torch.algorithms import msa as p_msa
from tarl_tpu_torch.config import MSAConfig as PortMSAConfig
from tarl_tpu_torch.metrics import equilibrium as p_eq

from test_torch_network import load_both

torch.set_num_threads(1)

START = 6 * 3600 - 60
# scenario: ticks of the reference's dual dijkstra episode
EPISODES = {"Braess": 900, "Easy": 1500, "Bottleneck": 600}
GAP_KEYS = ("rel_gap_ue", "rel_gap_so")


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_eq_scen"))
    out = {}
    for scenario, ticks in EPISODES.items():
        net, agents, pnet, _ = load_both(root, scenario)
        sim = SimConfig(start_time=START)
        policy = make_policy("dijkstra", network=net)
        state, _ = run_episode(init_sim_state(net, agents, sim=sim,
                                              policy=policy),
                               net, policy, ticks, sim=sim)
        pstate = convert.sim_state_from_numpy(convert.to_numpy(state), "cpu")
        out[scenario] = (net, state, pnet, pstate)
    return out


def _close(a, b, rtol=1e-5, atol=0.0, what=""):
    np.testing.assert_allclose(np.asarray(b, dtype=np.float64),
                               np.asarray(a, dtype=np.float64), rtol=rtol,
                               atol=atol, err_msg=what)


@pytest.mark.parametrize("scenario", sorted(EPISODES))
def test_tstt_nash_gap_and_bpr(cases, scenario):
    net, st, pnet, pst = cases[scenario]
    _close(ref_eq.tstt(st.agents, st.time), p_eq.tstt(pst.agents, pst.time))
    gap = ref_eq.nash_gap(st.agents, st.road, net)
    pgap = p_eq.nash_gap(pst.agents, pst.road, pnet)
    assert int(gap["num_agents"]) == int(pgap["num_agents"]) > 0
    for k in ("nash_gap", "relative_gap"):
        _close(gap[k], pgap[k], what=k)
    flow = np.random.default_rng(3).uniform(
        0, 2000, net.num_roads).astype(np.float32)
    for name in ("bpr_cost", "bpr_marginal_cost", "tstt_from_flows"):
        want = getattr(ref_eq, name)(jnp.asarray(flow), net.free_flow,
                                     net.max_flow)
        got = getattr(p_eq, name)(torch.as_tensor(flow), pnet.free_flow,
                                  pnet.max_flow)
        _close(want, got, what=name)
    _close(ref_eq.price_of_anarchy(jnp.float32(3.0), jnp.float32(2.0)),
           p_eq.price_of_anarchy(torch.tensor(3.0), torch.tensor(2.0)))


def _flat_objective(scenario, method):
    return scenario == "Easy" and method == "fw"


@pytest.mark.parametrize("scenario", sorted(EPISODES))
@pytest.mark.parametrize("method", ["fw", "msa"])
@pytest.mark.parametrize("system_optimal", [False, True])
def test_assignment(cases, scenario, method, system_optimal):
    net, st, pnet, pst = cases[scenario]
    od = ref_msa.build_od_demand(st.agents, net.num_nodes)
    pod = p_msa.build_od_demand(pst.agents, pnet.num_nodes)
    for a, b in zip(od, pod):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    cfg = dict(method=method, max_iter=200)
    want = ref_msa.solve_assignment(net, *od, msa=MSAConfig(**cfg),
                                    system_optimal=system_optimal)
    got = p_msa.solve_assignment(pnet, *pod, msa=PortMSAConfig(**cfg),
                                 system_optimal=system_optimal)
    assert int(want.iterations) == got.iterations
    assert bool(want.converged) == got.converged
    if _flat_objective(scenario, method):
        _close(ref_eq.tstt_from_flows(want.flow, net.free_flow, net.max_flow),
               p_eq.tstt_from_flows(got.flow, pnet.free_flow, pnet.max_flow),
               rtol=1e-4)
        assert float(want.rel_gap) < 1e-4 and float(got.rel_gap) < 1e-4
        return
    _close(want.flow, got.flow, atol=1e-3, what="flow")
    _close(want.gap, got.gap, rtol=1e-4, atol=1e-6, what="gap")
    if method == "fw":
        _close(want.rel_gap, got.rel_gap, rtol=1e-4, atol=1e-6)
    else:
        assert np.isinf(float(want.rel_gap)) and np.isinf(float(got.rel_gap))


@pytest.mark.parametrize("scenario", ["Braess", "Bottleneck"])
def test_run_msa_and_host_oracle(cases, scenario):
    net, st, pnet, pst = cases[scenario]
    want = ref_msa.run_msa(net, st.agents)
    got = p_msa.run_msa(pnet, pst.agents)
    assert sorted(want) == sorted(got) == list(range(net.num_roads))
    _close([want[k] for k in want], [got[k] for k in want], atol=1e-3)
    for method in ("fw", "msa"):
        cfg = dict(method=method, max_iter=30)
        assert ref_msa.run_msa_host(net, st.agents, MSAConfig(**cfg)) == \
            p_msa.run_msa_host(pnet, pst.agents, PortMSAConfig(**cfg))


@pytest.mark.parametrize("scenario", sorted(EPISODES))
def test_equilibrium_report(cases, scenario):
    net, st, pnet, pst = cases[scenario]
    want = ref_eq.equilibrium_report(st.agents, st.road, net, st.time)
    got = p_eq.equilibrium_report(pst.agents, pst.road, pnet, pst.time)
    assert list(want) == list(got)
    for k, v in want.items():
        if isinstance(v, (bool, int, str)):
            assert v == got[k], k
        elif k in GAP_KEYS:
            _close(v, got[k], rtol=1e-4, atol=1e-6, what=k)
        elif k == "msa_gap_ue" and scenario == "Easy":
            # The L1 step of the flat line search (see the module's notes).
            _close(v, got[k], rtol=0.05, what=k)
        else:
            _close(v, got[k], rtol=1e-4, what=k)


def test_ppo_train_eval_scalars(tmp_path):
    """The trainer's two equilibrium scalars equal the reference's formula
    on the evaluation rollout's final state."""
    from tarl_tpu.metrics.equilibrium import nash_gap, tstt
    from tarl_tpu.state import AgentState, RoadState

    from tarl_tpu_torch.config import RLConfig
    from tarl_tpu_torch.core.rng import prng_key
    from tarl_tpu_torch.core.step import Policy, init_sim_state as p_init
    from tarl_tpu_torch.models.mpnn import MPNNPolicyNet, MPNNValueNetSimple
    from tarl_tpu_torch.rl.ppo import PPO
    from tarl_tpu_torch.rl.trainer import ppo_train
    from tarl_tpu_torch.routing.policies import random_choice

    net, _, pnet, pagents = load_both(str(tmp_path / "scen"), "Grid8x8")
    rl = RLConfig(reward_mode="progress", gamma=0.98, gae_lambda=0.9,
                  episode_start=21600, rollout_steps=8, minibatch_size=8)
    ppo = PPO(pnet, MPNNPolicyNet(pnet.num_nodes, pnet.num_roads + 1,
                                  use_distance_prior=True, prior_scale=30.0),
              MPNNValueNetSimple(pnet.num_nodes), rl=rl)
    st = p_init(pnet, pagents, policy=Policy(choice=random_choice))
    ts = ppo_train(ppo, st, num_iterations=1, rl=rl, key=prng_key(5),
                   generator=torch.Generator().manual_seed(5),
                   log_dir=str(tmp_path / "logs"), eval_interval=1,
                   eval_steps=40, verbose=False)
    with open(tmp_path / "logs" / "metrics.csv") as f:
        row = [r for r in csv.DictReader(f) if r["eval/tstt"]][0]
    env, _, _, _ = ppo.eval_rollout(ts.params, st, prng_key(0), 40,
                                    deterministic=True)
    fsim = convert.to_numpy(env.sim)
    agents = AgentState(**{k: jnp.asarray(v)
                           for k, v in fsim["agents"].items()})
    road = RoadState(**{k: jnp.asarray(v) for k, v in fsim["road"].items()})
    gap = nash_gap(agents, road, net)
    assert int(agents.on_way.sum()) > 0
    _close(tstt(agents, jnp.asarray(fsim["time"])), float(row["eval/tstt"]))
    _close(gap["relative_gap"], float(row["eval/relative_nash_gap"]))


def reference_rows(rows: dict, root: str) -> dict:
    """The reference's numbers for ``chip_smoke.py``'s classical rows:
    ``{name: (average travel time, done, relative Nash gap)}``, each row
    through the reference facade and episode runner as the CLI runs it."""
    from tarl_tpu.algorithms.episode import run_episode as ref_runner
    from tarl_tpu.simulator import TransportationSimulator

    out = {}
    for name, (scenario, algo, start, timestep, ticks) in rows.items():
        sim = TransportationSimulator(
            sim=SimConfig(timestep=timestep, start_time=start,
                          end_time=start + timestep * ticks),
            data_root=root, save_root=os.path.join(root, "save"))
        sim.load_network(scenario)
        sim.load_population(scenario)
        sim.set_policy(make_policy(algo, network=sim.network))
        sim.config_parameters(timestep_size=timestep, start_time=start)
        ref_runner(sim, ticks, progress=False)
        st = sim.state
        gap = ref_eq.nash_gap(st.agents, st.road, sim.network)
        out[name] = (sim.average_travel_time(),
                     int(st.agents.done[1:].sum()),
                     float(gap["relative_gap"]))
    return out


if __name__ == "__main__":
    import tempfile

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke

    for name, values in reference_rows(chip_smoke.CLASSICAL_ROWS,
                                       tempfile.mkdtemp()).items():
        print(f"{name!r}: {values!r},")
