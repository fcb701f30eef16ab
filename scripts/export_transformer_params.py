"""Export the recorded Braess Graph Transformer run's best parameters, one
draw of its positional encoding, and the reference's own results with both.

Restores the Orbax checkpoint ``runs/learning/braess_transformer/
checkpoints/best`` on the CPU (``export_mpnn_params.restore_params``) and
writes ``tarl_tpu_torch/weights/braess_transformer_best.npz`` with:

* the policy and value parameters as flat ``policy/params/transformer/
  gt_0/WQ/kernel``-style keys, which ``tarl_tpu_torch.convert.
  load_params_npz`` reads back with numpy alone;
* ``pe``: one draw of Braess's Laplacian positional encoding ``[N, 16]``
  by the reference's ``network_positional_encoding``.  ARPACK starts from a
  random vector, so the draw is not a function of the network; it travels
  with the weights;
* ``reference/...``: the reference's greedy ``PPO.eval_rollout`` with
  exactly these weights and this encoding, from the Braess reset at
  ``scripts/train_rl_demo.py``'s settings (its ``RL`` dict, key 0), over
  ``EVAL_STEPS`` and ``CHECK_STEPS`` steps: the done count, the average
  travel time and the TSTT of each, and the first ``CHECK_STEPS`` steps'
  multi-hot actions; and the sampled evaluation over ``EVAL_STEPS`` from
  ``SAMPLED_KEY``, as ``train_rl_demo`` evaluates a stochastic policy.

    JAX_PLATFORMS=cpu python scripts/export_transformer_params.py [--out PATH]
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
CHECKPOINT = os.path.join(REPO, "runs", "learning", "braess_transformer",
                          "checkpoints", "best")
OUT = os.path.join(REPO, "tarl_tpu_torch", "weights",
                   "braess_transformer_best.npz")
PE_DIM = 16
EVAL_STEPS = 1800
CHECK_STEPS = 300
SAMPLED_KEY = 3


def braess_ppo(data_root: str):
    """``(ppo, sim_state, pe)``: the recorded run's PPO on Braess with a
    fresh draw of the encoding ``pe``, and the reset state
    ``train_rl_demo`` evaluates from."""
    import train_rl_demo
    from tarl_tpu.config import RLConfig
    from tarl_tpu.core.step import Policy, init_sim_state
    from tarl_tpu.io.matsim import load_network, load_population
    from tarl_tpu.io.scenarios import ensure_scenario
    from tarl_tpu.models.transformer.agent import (
        TransformerRoutePolicy,
        TransformerValueNet,
        network_positional_encoding,
    )
    from tarl_tpu.rl.ppo import PPO
    from tarl_tpu.routing.policies import random_choice

    base = ensure_scenario(data_root, "Braess")
    net = load_network(os.path.join(base, "network"))
    agents, _ = load_population(os.path.join(base, "population"),
                                os.path.join(base, "network"))
    st = init_sim_state(net, agents, policy=Policy(choice=random_choice))
    pe = network_positional_encoding(net, PE_DIM)
    ppo = PPO(net, TransformerRoutePolicy(pe=pe), TransformerValueNet(pe=pe),
              rl=RLConfig(**train_rl_demo.RL), value_uses_graph=True)
    return ppo, st, pe


def greedy_actions(ppo, params, st, key, steps: int):
    """``(env, actions [steps, Ef])`` of the greedy evaluation, step for
    step as ``PPO.eval_rollout`` takes it."""
    import jax

    from tarl_tpu.rl.env import env_reset, env_step

    @jax.jit
    def run(params, st, key):
        env, obs = env_reset(st, ppo.network, ppo.rl, ppo.physics,
                             ppo._dist_ff)

        def step(carry, _):
            env, obs, key = carry
            key, k = jax.random.split(key)
            action = ppo.act(params, env, obs, k, True)
            env, obs, *_ = env_step(env, action, ppo.network, ppo.rl,
                                    ppo.sim_cfg, ppo.physics,
                                    dist_ff=ppo._dist_ff)
            return (env, obs, key), action

        (env, _, _), actions = jax.lax.scan(step, (env, obs, key),
                                            length=steps)
        return env, actions

    return run(params, st, key)


def outcome(env) -> dict:
    """Done count, average travel time and TSTT of an evaluation's final
    state, as ``train_rl_demo.metrics_from`` counts them."""
    from tarl_tpu.core.step import average_travel_time
    from tarl_tpu.metrics.equilibrium import tstt

    a = env.sim.agents
    return {"done": np.int32(int(np.asarray(a.done[1:]).sum())),
            "avg_travel_time": np.float32(average_travel_time(a)),
            "tstt": np.float32(tstt(a, env.sim.time))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", default=CHECKPOINT)
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    sys.path.insert(0, REPO)
    import jax

    from export_mpnn_params import flatten, restore_params

    params = restore_params(args.checkpoint)
    flat = flatten(params)
    with tempfile.TemporaryDirectory() as root:
        ppo, st, pe = braess_ppo(root)
    key = jax.random.PRNGKey(0)
    env_full, *_ = ppo.eval_rollout(params, st, key, EVAL_STEPS)
    env_check, *_ = ppo.eval_rollout(params, st, key, CHECK_STEPS)
    env_sampled, *_ = ppo.eval_rollout(params, st,
                                       jax.random.PRNGKey(SAMPLED_KEY),
                                       EVAL_STEPS, deterministic=False)
    env_acts, actions = greedy_actions(ppo, params, st, key, CHECK_STEPS)
    if not jax.tree.all(jax.tree.map(
            lambda a, b: bool(np.array_equal(np.asarray(a), np.asarray(b))),
            env_acts, env_check)):
        raise AssertionError("the recorded actions do not reproduce "
                             "eval_rollout's state")
    flat["pe"] = np.asarray(pe, np.float32)
    flat[f"reference/actions_{CHECK_STEPS}"] = np.asarray(actions, bool)
    for name, env in ((f"eval_{EVAL_STEPS}", env_full),
                      (f"eval_{CHECK_STEPS}", env_check),
                      (f"sampled_{EVAL_STEPS}", env_sampled)):
        for k, v in outcome(env).items():
            flat[f"reference/{name}/{k}"] = v
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez(args.out, **flat)
    for k, v in sorted(flat.items()):
        if k.startswith(("reference/eval", "reference/sampled")):
            print(f"{k} {v}")
        else:
            print(f"{k} {v.shape} {v.dtype}")
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
