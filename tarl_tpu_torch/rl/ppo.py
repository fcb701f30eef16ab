"""PPO's forward half: policy and value evaluation, evaluation rollouts and
rollout collection (ports ``tarl_tpu/rl/ppo.py``: the constructor's edge
tables and distance tables, ``_context``, ``init``, ``act``,
``eval_rollout`` and ``_rollout`` as :meth:`PPO.collect_rollout`).

Parameters are ``{"policy": state_dict, "value": state_dict}``, applied
with ``torch.func.functional_call`` as the reference applies its Flax
trees, so the reference's trained parameters carry across through
``convert.mpnn_params_from_numpy``.  The rollouts are Python loops over
steps under ``torch.no_grad()``; the segment layout of ``full_src`` is
built once here.  Every step of a greedy evaluation launches K1 once and
K11's action entry once (the mode: the scaled argmax and the multi-hot
action in one kernel); a collection step launches K1, K11's action entry
(the sample, its Gumbel noise drawn inside), K10 and three K9 (the
log-probability).  Float32 matrix products must run in full
float32 (the reference's MLPs run in float32; TF32 would keep ~3 digits):
the rollouts raise if ``torch.backends.cuda.matmul.allow_tf32`` is on.
PyTorch leaves it off; the caller owns that process-wide flag.

Not here yet: the optimiser, GAE, the loss and ``train_iteration``.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.func import functional_call

from ..config import (
    DEFAULT_PHYSICS,
    DEFAULT_RL,
    DEFAULT_SIM,
    PhysicsConfig,
    RLConfig,
    SimConfig,
)
from ..core.rng import Key, split
from ..core.sync import host_read
from ..network import Network
from ..ops.segment import KERNELS, SegmentOps, segment_layout
from ..schema import agent_features_matrix
from .distribution import GraphDistribution
from .env import EnvState, Observation, env_reset, env_step


class Transition(NamedTuple):
    """Per-step rollout record; :meth:`PPO.collect_rollout` stacks them
    along a leading step axis."""

    x: torch.Tensor           # [N, C] node context
    time: torch.Tensor        # [1]
    action: torch.Tensor      # [Ef] bool multi-hot
    log_prob: torch.Tensor    # []
    value: torch.Tensor       # []
    reward: torch.Tensor      # []
    done: torch.Tensor        # [] bool
    on_network: torch.Tensor  # [] — occupancy after the step


class TrainState(NamedTuple):
    """What :meth:`PPO.init` returns: parameters, the environment, the
    threefry key and the iteration count (the optimiser state joins it
    with the training half)."""

    params: Any
    env: EnvState
    obs: Observation
    key: Key
    iteration: int


def init_params(module: torch.nn.Module,
                generator: torch.Generator) -> dict:
    """A state dict for ``module`` drawn from ``generator`` (a CPU
    generator, so the draw does not depend on the device): every Linear's
    weight and bias uniform in ``+-1/sqrt(fan_in)`` (PyTorch's default
    scheme), embeddings standard normal."""
    params = {}
    for name, sub in module.named_modules():
        prefix = f"{name}." if name else ""
        if isinstance(sub, torch.nn.Linear):
            bound = sub.in_features ** -0.5
            for p in ("weight", "bias"):
                t = torch.empty(getattr(sub, p).shape)
                params[prefix + p] = t.uniform_(-bound, bound,
                                                generator=generator)
        elif isinstance(sub, torch.nn.Embedding):
            params[prefix + "weight"] = torch.empty(
                sub.weight.shape).normal_(generator=generator)
    return params


def _require_full_f32() -> None:
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("PPO runs its matrix products in full float32: "
                           "set torch.backends.cuda.matmul.allow_tf32 = "
                           "False")


class PPO:
    """Binds the network and the two nets: ``init``, ``act``,
    ``eval_rollout`` and ``collect_rollout``."""

    # Agent-row columns kept at virtual (SRC/DEST) nodes: origin and
    # destination only.
    _VIRTUAL_KEEP = (1.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)

    def __init__(
        self,
        network: Network,
        policy_net: torch.nn.Module,
        value_net: torch.nn.Module,
        *,
        rl: RLConfig = DEFAULT_RL,
        sim_cfg: SimConfig = DEFAULT_SIM,
        physics: PhysicsConfig = DEFAULT_PHYSICS,
        value_uses_graph: bool = False,
    ):
        dev = network.device
        self.network = network
        self.policy_net = policy_net.to(dev)
        self.value_net = value_net.to(dev)
        self.rl = rl
        self.sim_cfg = sim_cfg
        self.physics = physics
        self.value_uses_graph = value_uses_graph
        self._edge_features = network.full_attr.reshape(-1, 1)
        self._edge_src = network.full_src
        self._edge_dst = network.full_dst
        self._num_nodes = network.num_nodes
        self._layout = segment_layout(network.full_src, network.num_nodes)
        self._keep = torch.tensor(self._VIRTUAL_KEEP, dtype=torch.float32,
                                  device=dev)

        # Free-flow all-pairs distances: the progress potential and/or the
        # policy's distance prior.
        prior = getattr(policy_net, "use_distance_prior", False)
        self._dist_ff = None
        if rl.reward_mode == "progress" or prior:
            from ..routing.bellman_ford import all_pairs_next_hop_nbr

            self._dist_ff, _ = all_pairs_next_hop_nbr(
                network.nbr, network.nbr_ok, network.entry_cost())
        self._policy_dist = self._dist_ff if prior else None

    # ------------------------------------------------------------------
    def _policy_logits(self, policy_params, x):
        args = (x, self._edge_features, self._edge_src, self._edge_dst)
        if self._policy_dist is not None:
            args += (self._policy_dist,)
        return functional_call(self.policy_net, policy_params, args)

    def _value(self, value_params, x, time):
        if self.value_uses_graph:
            return functional_call(
                self.value_net, value_params,
                (x, self._edge_features, self._edge_src, self._edge_dst,
                 time),
                {"layout": self._layout})
        return functional_call(self.value_net, value_params, (x, time))

    def _dist(self, logits, ops: SegmentOps = KERNELS) -> GraphDistribution:
        return GraphDistribution(logits, self._edge_src, self._num_nodes,
                                 layout=self._layout, ops=ops)

    def _context(self, env: EnvState, obs: Observation) -> torch.Tensor:
        """x[N, 16]: the observation columns and the FIFO-head agent's row
        (origin and destination only at virtual nodes); with
        ``rl.extra_obs`` the three congestion columns follow (x[N, 19])."""
        rows = agent_features_matrix(env.sim.agents)[obs.agent_index.long()]
        is_virtual = obs.node_features[:, 6:7] < 0
        rows = torch.where(is_virtual, rows * self._keep[None, :], rows)
        cols = [obs.node_features, rows]
        if self.rl.extra_obs:
            from .observation import extra_node_features

            cols.append(extra_node_features(env.sim, self.network,
                                            self.physics))
        return torch.cat(cols, dim=-1)

    # ------------------------------------------------------------------
    def init(self, sim_state, key: Key,
             generator: torch.Generator) -> TrainState:
        """Reset the environment and draw both nets' parameters from
        ``generator`` (a CPU generator; see :func:`init_params`)."""
        env, obs = env_reset(sim_state, self.network, self.rl, self.physics,
                             self._dist_ff)
        dev = self.network.device
        params = {
            name: {k: v.to(dev) for k, v in init_params(net, generator)
                   .items()}
            for name, net in (("policy", self.policy_net),
                              ("value", self.value_net))
        }
        return TrainState(params=params, env=env, obs=obs,
                          key=split(key, 3)[2], iteration=0)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def act(self, params, env: EnvState, obs: Observation, key: Key = None,
            deterministic: bool = True,
            segment_ops: SegmentOps = KERNELS) -> torch.Tensor:
        """Greedy (``mode``) or sampled multi-hot action."""
        _require_full_f32()
        x = self._context(env, obs)
        dist = self._dist(self._policy_logits(params["policy"], x),
                          segment_ops)
        return dist.mode() if deterministic else dist.sample(key)

    @torch.no_grad()
    def eval_rollout(self, params, sim_state, key: Key, num_steps: int,
                     deterministic: bool = True,
                     segment_ops: SegmentOps = KERNELS):
        """An evaluation episode of ``num_steps`` steps from the reset
        ``sim_state``, with no host read.  Returns ``(env, rewards [T],
        dones [T], logs)``, ``logs`` holding the per-step arrivals,
        occupancy and time.  ``segment_ops`` overrides the segment kernels
        (K9-K11), e.g. with their plain versions."""
        env, obs = env_reset(sim_state, self.network, self.rl, self.physics,
                             self._dist_ff)
        out = []
        for _ in range(num_steps):
            key, k = split(key)
            action = self.act(params, env, obs, k, deterministic,
                              segment_ops)
            env, obs, reward, done, info = env_step(
                env, action, self.network, self.rl, self.sim_cfg,
                self.physics, dist_ff=self._dist_ff)
            out.append((reward, done, info["arrivals"], info["on_network"],
                        env.sim.time))
        cols = ([torch.stack(col) for col in zip(*out)] if out
                else [torch.zeros(0, device=self.network.device)] * 5)
        rewards, dones, arrivals, on_net, times = cols
        logs = {"arrivals": arrivals, "on_network": on_net, "time": times}
        return env, rewards, dones, logs

    @torch.no_grad()
    def collect_rollout(self, params, env: EnvState, obs: Observation,
                        key: Key, segment_ops: SegmentOps = KERNELS):
        """``rl.rollout_steps`` sampled transitions, resetting the
        environment where an episode ends.  Returns ``(env, obs, key,
        traj, last_value)``, ``traj`` a :class:`Transition` of stacked
        steps.

        The done flag is read on the host only once an episode could have
        ended: the clock advances at most one timestep per step, so the
        host tracks an upper bound of it (one read at the start, then one
        per step past ``rl.episode_end``, each tightening the bound)."""
        _require_full_f32()
        rl = self.rl
        step_dt = self.sim_cfg.timestep
        t_high = host_read(torch.ceil(env.sim.time))[0]
        steps = []
        for _ in range(rl.rollout_steps):
            key, k_sample = split(key)
            x = self._context(env, obs)
            dist = self._dist(self._policy_logits(params["policy"], x),
                              segment_ops)
            action = dist.sample(k_sample)
            log_prob = dist.log_prob(action)
            value = self._value(params["value"], x, obs.time)
            env2, obs2, reward, done, info = env_step(
                env, action, self.network, rl, self.sim_cfg, self.physics,
                dist_ff=self._dist_ff)
            t_high += step_dt
            if t_high > rl.episode_end:
                ended, t_high = host_read(done, torch.ceil(env2.sim.time))
                if ended:
                    env2, obs2 = env_reset(env2.sim, self.network, rl,
                                           self.physics, self._dist_ff)
                    t_high = rl.episode_start
            steps.append(Transition(
                x=x, time=obs.time, action=action, log_prob=log_prob,
                value=value, reward=reward, done=done,
                on_network=info["on_network"]))
            env, obs = env2, obs2
        traj = Transition(*(torch.stack(col) for col in zip(*steps)))
        last_value = self._value(params["value"], self._context(env, obs),
                                 obs.time)
        return env, obs, key, traj, last_value
