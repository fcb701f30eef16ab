"""The port's learned-policy slice against the JAX reference, on the CPU.

* ``GraphDistribution``: probs, log-probs and entropy at 1e-6 (``exp`` and
  ``log`` may round an ulp apart); mode and sample exactly for the same
  threefry key, each one ``ops.action`` call (K11's action entry; its
  plain version on the CPU); the log-prob of a valid and of invalid
  actions.
* The MPNN nets with parameters carried from a Flax ``init`` through
  ``convert.mpnn_params_from_numpy``: logits and values at rtol 1e-5
  (float32 matrix products summed in another order), both policy modes,
  with and without the distance prior; the conversion round trip.
* The environment: ``env_reset`` and ~50 ``env_step``s with the same
  random valid actions on TwoLink, Braess and Grid4x4, every reward mode;
  states, observations, done flags and the carried potential bitwise.
  Rewards bitwise, except that under ``jax.jit`` XLA rewrites the division
  by ``progress_scale`` into a multiplication by its reciprocal, so the
  ``system`` and ``progress`` rewards agree to one ulp.
* The slice: greedy and stochastic ``eval_rollout`` and
  ``collect_rollout`` for 40 steps on Braess and Grid4x4 with carried
  weights: actions, rewards and final states equal, log-probs and values
  at 1e-5.
* The trained weights: the committed ``.npz`` equals the Orbax restore of
  ``runs/learning/grid8x8_tpu/checkpoints/best``.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tarl_tpu.config import RLConfig
from tarl_tpu.core.step import Policy, init_sim_state
from tarl_tpu.models.mpnn import (
    MPNNPolicyNet,
    MPNNValueNet,
    MPNNValueNetSimple,
)
from tarl_tpu.rl import env as ref_env
from tarl_tpu.rl.distribution import GraphDistribution
from tarl_tpu.rl.ppo import PPO
from tarl_tpu.routing.bellman_ford import all_pairs_next_hop_nbr
from tarl_tpu.routing.policies import random_choice

from tarl_tpu_torch import convert
from tarl_tpu_torch.config import RLConfig as PortRLConfig
from tarl_tpu_torch.core import rng as p_rng
from tarl_tpu_torch.core import step as p_step
from tarl_tpu_torch.models import mpnn as p_mpnn
from tarl_tpu_torch.ops.segment import segment_layout
from tarl_tpu_torch.rl import env as p_env
from tarl_tpu_torch.rl.distribution import (
    GraphDistribution as PortGraphDistribution,
)
from tarl_tpu_torch.rl.ppo import PPO as PortPPO
from tarl_tpu_torch.routing import bellman_ford as p_bf
from tarl_tpu_torch.routing.policies import random_choice as p_random_choice

from test_torch_network import assert_tree_equal, load_both

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRIOR_SCALE = 30.0


@pytest.fixture(scope="module")
def scenarios(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_rl_scen"))
    return {name: load_both(root, name)
            for name in ("TwoLink", "Braess", "Grid4x4")}


def _states(scen):
    net, agents, pnet, pagents = scen
    st = init_sim_state(net, agents, policy=Policy(choice=random_choice))
    pst = p_step.init_sim_state(pnet, pagents,
                                policy=p_step.Policy(choice=p_random_choice))
    return st, pst


def _actions(full_src: np.ndarray, num_nodes: int, steps: int, seed: int):
    """Random valid multi-hot actions: one out-edge per node that has
    any."""
    g = np.random.default_rng(seed)
    groups = [np.nonzero(full_src == u)[0] for u in range(num_nodes)]
    out = []
    for _ in range(steps):
        act = np.zeros(full_src.shape[0], bool)
        for idx in groups:
            if len(idx):
                act[g.choice(idx)] = True
        out.append(act)
    return out


def _sim_tree(sim):
    d = convert.to_numpy(sim)
    d["time"] = np.float32(d["time"])
    d["key"] = np.asarray(d["key"]).astype(np.uint32)
    return d


# ---------------------------------------------------------------------------
def test_distribution(scenarios):
    net, _, pnet, _ = scenarios["Grid4x4"]
    src = np.asarray(net.full_src)
    n = net.num_nodes
    g = np.random.default_rng(0)
    logits = g.normal(size=src.shape[0]).astype(np.float32) * 3.0
    logits[::17] = -np.inf
    ref = GraphDistribution(jnp.asarray(logits), net.full_src, n,
                            temperature=0.7)
    port = PortGraphDistribution(torch.as_tensor(logits), pnet.full_src, n,
                                 temperature=0.7,
                                 layout=segment_layout(pnet.full_src, n))
    for name in ("probs", "log_probs", "entropy"):
        np.testing.assert_allclose(getattr(port, name)().numpy(),
                                   np.asarray(getattr(ref, name)()),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(port.mode().numpy(), np.asarray(ref.mode()))
    for s in range(4):
        got = port.sample(p_rng.prng_key(s))
        want = np.asarray(ref.sample(jax.random.PRNGKey(s)))
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_allclose(float(port.log_prob(got)),
                                   float(ref.log_prob(jnp.asarray(want))),
                                   rtol=1e-6)
    bad = np.asarray(ref.mode()).copy()
    bad[np.nonzero(src == src[0])[0]] = True          # two edges in a group
    empty = np.zeros_like(bad)                        # no edge anywhere
    for act in (bad, empty):
        assert float(port.log_prob(torch.as_tensor(act))) == -np.inf
        assert float(ref.log_prob(jnp.asarray(act))) == -np.inf


@pytest.mark.parametrize("temperature", [1.0, 0.7])
def test_distribution_mode_and_sample_are_one_action_call(scenarios,
                                                          temperature,
                                                          monkeypatch):
    """``mode`` and ``sample(key)`` are one ``ops.action`` call each, with
    the raw logits, the temperature and the key (None for the mode); on
    the CPU the kernels' wrapper takes ``segment_action_plain`` and counts
    no launch."""
    from tarl_tpu_torch.ops import segment as seg

    net, _, pnet, _ = scenarios["Grid4x4"]
    n = net.num_nodes
    logits = torch.as_tensor(np.random.default_rng(1).normal(
        size=pnet.full_src.shape[0]).astype(np.float32))
    layout = segment_layout(pnet.full_src, n)
    calls = []

    def action(*args):
        calls.append(args)
        return seg.PLAIN.action(*args)

    dist = PortGraphDistribution(logits, pnet.full_src, n, temperature,
                                 layout, seg.PLAIN._replace(action=action))
    key = p_rng.prng_key(3)
    mode, sample = dist.mode(), dist.sample(key)
    assert [(a[0] is logits, a[1] is pnet.full_src, a[2], a[3] is layout,
             a[4], a[5]) for a in calls] == [
        (True, True, n, True, temperature, None),
        (True, True, n, True, temperature, key)]

    plain_calls = []
    real = seg.segment_action_plain

    def spy(*args):
        plain_calls.append(args[5])
        return real(*args)

    monkeypatch.setattr(seg, "segment_action_plain", spy)
    before = seg.ARGMAX_LAUNCHES
    cpu = PortGraphDistribution(logits, pnet.full_src, n, temperature,
                                layout)
    assert torch.equal(cpu.mode(), mode)
    assert torch.equal(cpu.sample(key), sample)
    assert plain_calls == [None, key] and seg.ARGMAX_LAUNCHES == before
    ref = GraphDistribution(jnp.asarray(logits.numpy()), net.full_src, n,
                            temperature=temperature)
    np.testing.assert_array_equal(mode.numpy(), np.asarray(ref.mode()))
    np.testing.assert_array_equal(
        sample.numpy(), np.asarray(ref.sample(jax.random.PRNGKey(3))))


# ---------------------------------------------------------------------------
def _context(net, seed: int):
    """A node context x[N, 16] with integral road-index and destination
    columns, and the free-flow distance table."""
    g = np.random.default_rng(seed)
    n, r = net.num_nodes, net.num_roads
    x = (g.normal(size=(n, 16)) * 10.0).astype(np.float32)
    x[:, 6] = np.concatenate([np.arange(r), -np.ones(n - r)])
    x[:, 8] = g.integers(0, n, n)
    dist, _ = all_pairs_next_hop_nbr(net.nbr, net.nbr_ok, net.entry_cost())
    return x, np.array(dist)


@pytest.mark.parametrize("mode,prior", [("edge_mlp", False),
                                        ("edge_mlp", True),
                                        ("embedding", False),
                                        ("embedding", True)])
def test_policy_net_carried_from_flax(scenarios, mode, prior):
    net, _, pnet, _ = scenarios["Grid4x4"]
    x, dist = _context(net, 1)
    n, r = net.num_nodes, net.num_roads
    ef = np.array(net.full_attr).reshape(-1, 1)
    ref_net = MPNNPolicyNet(num_nodes=n, num_node_embeddings=r + 1, mode=mode,
                            use_distance_prior=prior,
                            prior_scale=PRIOR_SCALE)
    args = (jnp.asarray(x), jnp.asarray(ef), net.full_src, net.full_dst)
    flax_params = ref_net.init(jax.random.PRNGKey(2), *args)
    want = ref_net.apply(flax_params, *args, jnp.asarray(dist))

    tree = jax.tree.map(np.asarray, {"policy": flax_params,
                                     "value": {"params": {}}})
    params = convert.mpnn_params_from_numpy(tree, device="cpu")["policy"]
    model = p_mpnn.MPNNPolicyNet(n, r + 1, mode=mode,
                                 use_distance_prior=prior,
                                 prior_scale=PRIOR_SCALE)
    assert sorted(params) == sorted(model.state_dict())
    got = torch.func.functional_call(
        model, params, (torch.as_tensor(x), torch.as_tensor(ef),
                        pnet.full_src, pnet.full_dst, torch.as_tensor(dist)))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    back = convert.mpnn_params_to_numpy({"policy": params})["policy"]
    assert_tree_equal(tree["policy"], back, "policy params")


def test_value_nets_carried_from_flax(scenarios):
    net, _, pnet, _ = scenarios["Grid4x4"]
    x, _ = _context(net, 3)
    n = net.num_nodes
    ef = np.array(net.full_attr).reshape(-1, 1)
    t = np.asarray([21913.0], np.float32)
    full = MPNNValueNet(num_nodes=n)
    simple = MPNNValueNetSimple()
    fargs = (jnp.asarray(x), jnp.asarray(ef), net.full_src, net.full_dst,
             jnp.asarray(t))
    f_params = full.init(jax.random.PRNGKey(4), *fargs)
    s_params = simple.init(jax.random.PRNGKey(5), jnp.asarray(x),
                           jnp.asarray(t))
    tree = jax.tree.map(np.asarray, {"policy": f_params, "value": s_params})
    params = convert.mpnn_params_from_numpy(tree, device="cpu")
    tx, tt = torch.as_tensor(x), torch.as_tensor(t)
    got_full = torch.func.functional_call(
        p_mpnn.MPNNValueNet(n), params["policy"],
        (tx, torch.as_tensor(ef), pnet.full_src, pnet.full_dst, tt))
    got_simple = torch.func.functional_call(
        p_mpnn.MPNNValueNetSimple(n), params["value"], (tx, tt))
    np.testing.assert_allclose(float(got_full),
                               float(full.apply(f_params, *fargs)),
                               rtol=1e-5)
    np.testing.assert_allclose(
        float(got_simple),
        float(simple.apply(s_params, jnp.asarray(x), jnp.asarray(t))),
        rtol=1e-5)


# ---------------------------------------------------------------------------
ENV_CASES = [
    ("TwoLink", "individual", False),
    ("TwoLink", "throughput", False),
    ("Braess", "progress", False),
    ("Braess", "on_network", False),
    ("Grid4x4", "system", False),
    ("Grid4x4", "progress", True),
]


@pytest.mark.parametrize("scenario,mode,congested", ENV_CASES)
def test_env_steps_equal_the_reference(scenarios, scenario, mode, congested):
    net, _, pnet, _ = scenarios[scenario]
    st, pst = _states(scenarios[scenario])
    kw = dict(reward_mode=mode, episode_start=21595,
              congested_potential=congested)
    rl, prl = RLConfig(**kw), PortRLConfig(**kw)
    dff = pdff = None
    if mode == "progress":
        dff, _ = all_pairs_next_hop_nbr(net.nbr, net.nbr_ok, net.entry_cost())
        pdff, _ = p_bf.all_pairs_next_hop_nbr(pnet.nbr, pnet.nbr_ok,
                                              pnet.entry_cost())
    step = jax.jit(lambda e, a: ref_env.env_step(e, a, net, rl, dist_ff=dff))
    env, obs = ref_env.env_reset(st, net, rl, dist_ff=dff)
    penv, pobs = p_env.env_reset(pst, pnet, prl, dist_ff=pdff)
    rewards = []
    for i, act in enumerate(_actions(np.asarray(net.full_src),
                                     net.num_nodes, 50, seed=7)):
        env, obs, r, d, info = step(env, jnp.asarray(act))
        penv, pobs, pr, pd, pinfo = p_env.env_step(
            penv, torch.as_tensor(act), pnet, prl, dist_ff=pdff)
        where = f"{scenario}/{mode} step {i}"
        assert_tree_equal(_sim_tree(env.sim), _sim_tree(penv.sim), where)
        assert_tree_equal(convert.to_numpy(obs), convert.to_numpy(pobs),
                          where)
        assert bool(d) == bool(pd) and np.array_equal(
            np.asarray(env.old_counts), penv.old_counts.numpy())
        np.testing.assert_allclose(float(penv.phi), float(env.phi),
                                   rtol=1e-6, err_msg=where)
        for k in info:
            np.testing.assert_array_equal(float(pinfo[k]), float(info[k]))
        if mode in ("system", "progress"):
            np.testing.assert_array_max_ulp(np.float32(pr), np.float32(r), 1)
        else:
            assert float(pr) == float(r), where
        rewards.append(float(r))
    assert any(rewards), f"{scenario}/{mode}: every reward was 0"
    assert float(penv.sim.time) > kw["episode_start"] + 5


# ---------------------------------------------------------------------------
def _both_ppo(scen, steps):
    net, _, pnet, _ = scen
    kw = dict(reward_mode="progress", gamma=0.98, episode_start=21600,
              rollout_steps=steps)
    ref = PPO(net, MPNNPolicyNet(num_nodes=net.num_nodes,
                                 num_node_embeddings=net.num_roads + 1,
                                 use_distance_prior=True,
                                 prior_scale=PRIOR_SCALE),
              MPNNValueNetSimple(), rl=RLConfig(**kw))
    port = PortPPO(pnet, p_mpnn.MPNNPolicyNet(
        pnet.num_nodes, pnet.num_roads + 1, use_distance_prior=True,
        prior_scale=PRIOR_SCALE), p_mpnn.MPNNValueNetSimple(pnet.num_nodes),
        rl=PortRLConfig(**kw))
    return ref, port


@pytest.mark.parametrize("scenario", ["Braess", "Grid4x4"])
def test_rollouts_equal_the_reference(scenarios, scenario):
    steps = 40
    st, pst = _states(scenarios[scenario])
    ref, port = _both_ppo(scenarios[scenario], steps)
    ts = ref.init(st, jax.random.PRNGKey(0))
    params = convert.mpnn_params_from_numpy(jax.tree.map(np.asarray,
                                                         ts.params),
                                            device="cpu")
    for det in (True, False):
        env, r, d, logs = ref.eval_rollout(ts.params, st,
                                           jax.random.PRNGKey(3), steps,
                                           deterministic=det)
        penv, pr, pd, plogs = port.eval_rollout(params, pst,
                                                p_rng.prng_key(3), steps,
                                                deterministic=det)
        where = f"{scenario} eval deterministic={det}"
        assert_tree_equal(_sim_tree(env.sim), _sim_tree(penv.sim), where)
        np.testing.assert_array_equal(pr.numpy(), np.asarray(r))
        np.testing.assert_array_equal(pd.numpy(), np.asarray(d))
        for k in logs:
            np.testing.assert_array_equal(plogs[k].numpy(),
                                          np.asarray(logs[k]))
        assert float(plogs["on_network"].max()) > 0, where

    pts = port.init(pst, p_rng.prng_key(0), torch.Generator().manual_seed(0))
    key = tuple(int(k) for k in np.asarray(ts.key))
    env, obs, k_out, traj, last_value = jax.jit(ref._rollout)(
        ts.params, ts.env, ts.obs, ts.key)
    penv, pobs, pkey, ptraj, plast = port.collect_rollout(
        params, pts.env, pts.obs, key)
    assert tuple(int(k) for k in np.asarray(k_out)) == pkey
    assert_tree_equal(_sim_tree(env.sim), _sim_tree(penv.sim),
                      f"{scenario} collect")
    for f in ("x", "time", "action", "reward", "done", "on_network"):
        np.testing.assert_array_equal(getattr(ptraj, f).numpy(),
                                      np.asarray(getattr(traj, f)), f)
    for f in ("log_prob", "value"):
        np.testing.assert_allclose(getattr(ptraj, f).numpy(),
                                   np.asarray(getattr(traj, f)), rtol=1e-5,
                                   atol=1e-5, err_msg=f)
    np.testing.assert_allclose(float(plast), float(last_value), rtol=1e-5)
    assert np.isfinite(ptraj.log_prob.numpy()).all()


def test_collection_resets_where_an_episode_ends(scenarios):
    """An episode of ~15 s of clock inside a 40-step collection: the done
    step, the reset and the steps after it equal the reference's
    ``lax.cond`` reset."""
    st, pst = _states(scenarios["Braess"])
    net, _, pnet, _ = scenarios["Braess"]
    kw = dict(reward_mode="throughput", episode_start=21600,
              episode_end=21615, rollout_steps=40)
    ref = PPO(net, MPNNPolicyNet(num_nodes=net.num_nodes,
                                 num_node_embeddings=net.num_roads + 1),
              MPNNValueNetSimple(), rl=RLConfig(**kw))
    port = PortPPO(pnet, p_mpnn.MPNNPolicyNet(pnet.num_nodes,
                                              pnet.num_roads + 1),
                   p_mpnn.MPNNValueNetSimple(pnet.num_nodes),
                   rl=PortRLConfig(**kw))
    ts = ref.init(st, jax.random.PRNGKey(1))
    params = convert.mpnn_params_from_numpy(
        jax.tree.map(np.asarray, ts.params), device="cpu")
    pts = port.init(pst, p_rng.prng_key(1), torch.Generator())
    env, obs, _, traj, _ = jax.jit(ref._rollout)(ts.params, ts.env, ts.obs,
                                                 ts.key)
    penv, pobs, _, ptraj, _ = port.collect_rollout(
        params, pts.env, pts.obs, tuple(int(k) for k in np.asarray(ts.key)))
    done = np.asarray(traj.done)
    assert done.sum() >= 1 and not done[-1]
    np.testing.assert_array_equal(ptraj.done.numpy(), done)
    np.testing.assert_array_equal(ptraj.action.numpy(),
                                  np.asarray(traj.action))
    np.testing.assert_array_equal(ptraj.time.numpy(), np.asarray(traj.time))
    assert_tree_equal(_sim_tree(env.sim), _sim_tree(penv.sim), "reset env")
    assert_tree_equal(convert.to_numpy(obs), convert.to_numpy(pobs), "obs")


def test_port_init_is_seeded_and_complete(scenarios):
    _, pst = _states(scenarios["Braess"])
    _, port = _both_ppo(scenarios["Braess"], 8)
    a = port.init(pst, p_rng.prng_key(0), torch.Generator().manual_seed(5))
    b = port.init(pst, p_rng.prng_key(0), torch.Generator().manual_seed(5))
    for part, net in (("policy", port.policy_net), ("value", port.value_net)):
        assert sorted(a.params[part]) == sorted(net.state_dict())
        for k, v in a.params[part].items():
            assert torch.equal(v, b.params[part][k])
    assert a.key == p_rng.split(p_rng.prng_key(0), 3)[2]


def test_rollouts_refuse_tf32_and_leave_the_flag_alone(scenarios):
    _, pst = _states(scenarios["Braess"])
    _, port = _both_ppo(scenarios["Braess"], 4)
    ts = port.init(pst, p_rng.prng_key(0), torch.Generator().manual_seed(0))
    assert not torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="full float32"):
            port.act(ts.params, ts.env, ts.obs)
        with pytest.raises(RuntimeError, match="full float32"):
            port.collect_rollout(ts.params, ts.env, ts.obs, p_rng.prng_key(1))
        _both_ppo(scenarios["Braess"], 4)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


# ---------------------------------------------------------------------------
def test_committed_weights_equal_the_checkpoint():
    spec = importlib.util.spec_from_file_location(
        "export_mpnn_params",
        os.path.join(REPO, "scripts", "export_mpnn_params.py"))
    export = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(export)
    restored = export.restore_params()
    committed = convert.load_params_npz(export.OUT)
    assert_tree_equal(restored, committed, "params")
    assert_tree_equal(committed, restored, "params")
    params = convert.mpnn_params_from_numpy(committed, device="cpu")
    assert tuple(params["policy"]["edge_fc1.weight"].shape) == (64, 35)
    assert tuple(params["value"]["fc1.weight"].shape) == (64, 353)
