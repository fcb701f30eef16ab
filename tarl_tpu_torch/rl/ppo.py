"""PPO on the port (ports ``tarl_tpu/rl/ppo.py``): the constructor's edge
and distance tables and optimiser, ``_context``, ``init``, ``act``,
``eval_rollout``, ``_rollout`` as :meth:`PPO.collect_rollout`, the loss,
``_update_epochs`` and ``train_iteration``.

Parameters are ``{"policy": state_dict, "value": state_dict}``, applied
with ``torch.func.functional_call`` as the reference applies its Flax
trees, so the reference's trained parameters carry across through
``convert.mpnn_params_from_numpy``.  The rollouts are Python loops over
steps under ``torch.no_grad()``; the segment layout of ``full_src`` is
built once here.  Every step of a greedy evaluation launches K1 once and
K11's action entry once (the mode: the scaled argmax and the multi-hot
action in one kernel); a collection step launches K1, K11's action entry
(the sample, its Gumbel noise drawn inside) and K10's log-prob entry once
each, and K9 never.

A training iteration (:meth:`PPO.train_iteration`) collects
``rl.rollout_steps`` transitions, computes GAE, then runs
``rl.num_epochs`` epochs of clipped minibatch updates with :class:`Adam`.
The loss runs inside ``ops.segment.plain_segments()``, as the reference's
runs under ``no_pallas()``: its segment ops are the plain, differentiable
versions, the minibatch one batched pass, and the update launches no
segment kernel.  Float32 matrix products must run in full float32 (the
reference's MLPs run in float32; TF32 would keep ~3 digits): the rollouts
and the iteration raise if ``torch.backends.cuda.matmul.allow_tf32`` is
on.  PyTorch leaves it off; the caller owns that process-wide flag.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import numpy as np
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
from ..core.fused_winner import direction_confirm
from ..core.rng import Key, permutation, split
from ..core.sync import host_read
from ..network import Network
from ..ops.segment import KERNELS, SegmentOps, plain_segments, segment_layout
from ..schema import agent_features_matrix
from .distribution import GraphDistribution, log_prob_and_entropy
from .env import EnvState, Observation, env_reset, env_step
from .gae import gae, normalize


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


class AdamState(NamedTuple):
    """Adam's state, as optax's ``ScaleByAdamState``: ``count`` the updates
    applied (a host int: the rate and the bias correction need no device
    read), ``mu`` and ``nu`` keyed like the parameters."""

    count: int
    mu: dict
    nu: dict


class TrainState(NamedTuple):
    """Parameters, optimiser state, the environment, the threefry key and
    the iteration count."""

    params: Any
    opt_state: AdamState
    env: EnvState
    obs: Observation
    key: Key
    iteration: int


class IterationMetrics(NamedTuple):
    """Scalars of one training iteration (0-d tensors on the rollout's
    device); the loss terms, ``approx_kl``, ``clip_fraction`` and
    ``grad_norm`` (the unclipped gradients' global norm) are means over
    the epochs' minibatches."""

    loss_objective: torch.Tensor
    loss_critic: torch.Tensor
    loss_entropy: torch.Tensor
    loss_total: torch.Tensor
    approx_kl: torch.Tensor
    clip_fraction: torch.Tensor
    grad_norm: torch.Tensor
    avg_reward: torch.Tensor
    avg_return: torch.Tensor
    avg_on_network: torch.Tensor


def iteration_metrics(stats: list, traj: Transition,
                      returns: torch.Tensor) -> IterationMetrics:
    """An iteration's metrics from :meth:`PPO._update_epochs`' per-update
    ``stats``, the collected ``traj`` and the ``returns``: the loss terms,
    ``approx_kl``, ``clip_fraction`` and ``grad_norm`` means over the
    updates, the rest means over the steps."""
    loss = torch.stack([s[0] for s in stats])
    aux = [torch.stack(col) for col in zip(*(s[1] for s in stats))]
    gnorm = torch.stack([s[2] for s in stats])
    return IterationMetrics(
        loss_objective=aux[0].mean(), loss_critic=aux[1].mean(),
        loss_entropy=aux[2].mean(), loss_total=loss.mean(),
        approx_kl=aux[3].mean(), clip_fraction=aux[4].mean(),
        grad_norm=gnorm.mean(), avg_reward=traj.reward.mean(),
        avg_return=returns.mean(), avg_on_network=traj.on_network.mean())


def tree_map(fn, *trees: dict) -> dict:
    """``fn`` over the leaves of ``{part: {name: tensor}}`` trees."""
    return {part: {k: fn(*(t[part][k] for t in trees)) for k in sub}
            for part, sub in trees[0].items()}


def global_norm(tree: dict) -> torch.Tensor:
    """``optax.global_norm``: the square root of the sum of every leaf's
    sum of squares."""
    return torch.sqrt(sum(torch.sum(t * t) for sub in tree.values()
                          for t in sub.values()))


class Adam:
    """``optax.adam`` (beta 0.9/0.999, eps 1e-8) over parameter trees, op
    for op in float32, after ``optax.clip_by_global_norm(rl.max_grad_norm)``
    where that is set, at the rate :meth:`rate` gives: ``rl.learning_rate``,
    or with ``rl.lr_anneal_updates`` that constant for ``lr_anneal_start``
    updates and then ``optax.cosine_decay_schedule(learning_rate,
    lr_anneal_updates, alpha=lr_anneal_floor)`` (``optax.join_schedules``).
    """

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, rl: RLConfig):
        self.rl = rl

    def init(self, params: dict) -> AdamState:
        return AdamState(0, tree_map(torch.zeros_like, params),
                         tree_map(torch.zeros_like, params))

    def rate(self, count: int) -> float:
        """The learning rate of the update after ``count`` updates, as a
        float32 value."""
        rl, f = self.rl, np.float32
        start = max(rl.lr_anneal_start, 0)
        if not rl.lr_anneal_updates or count < start:
            return float(f(rl.learning_rate))
        steps = f(rl.lr_anneal_updates)
        t = min(f(count - start), steps)
        cosine = f(0.5) * (f(1.0) + np.cos(f(np.pi) * t / steps))
        decayed = f(1 - rl.lr_anneal_floor) * cosine + f(rl.lr_anneal_floor)
        return float(f(rl.learning_rate) * decayed)

    @torch.no_grad()
    def update(self, grads: dict, state: AdamState,
               params: dict) -> tuple[dict, AdamState]:
        """One step: ``(new params, new state)``."""
        if self.rl.max_grad_norm is not None:
            g_norm, max_norm = global_norm(grads), self.rl.max_grad_norm
            grads = tree_map(lambda g: torch.where(
                g_norm < max_norm, g, (g / g_norm) * max_norm), grads)
        b1, b2 = self.b1, self.b2
        mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, state.mu)
        nu = tree_map(lambda g, v: (1 - b2) * (g * g) + b2 * v, grads,
                       state.nu)
        count = state.count + 1
        f = np.float32
        # The bias corrections as 0-d float32 tensors: optax divides by
        # them, and a CUDA tensor divided by a Python float is multiplied by
        # the reciprocal instead.
        dev = next(t for sub in mu.values() for t in sub.values()).device
        c1, c2 = (torch.full((), float(f(1.0) - f(b) ** f(count)),
                             dtype=torch.float32, device=dev)
                  for b in (b1, b2))
        step = -self.rate(state.count)
        params = tree_map(
            lambda p, m, v: p + (m / c1) / (torch.sqrt(v / c2) + self.eps)
            * step, params, mu, nu)
        return params, AdamState(count, mu, nu)


def init_params(module: torch.nn.Module,
                generator: torch.Generator) -> dict:
    """A state dict for ``module`` drawn from ``generator`` (a CPU
    generator, so the draw does not depend on the device) in Flax's default
    laws, which the reference's ``nn.Dense`` and ``nn.Embed`` layers take:
    every Linear's weight ``lecun_normal`` (a normal truncated to +-2
    standard deviations, scaled to variance 1/fan_in; the fan-in is the
    weight's second axis, the first of the Flax kernel it transposes) and
    its bias zero; embeddings standard normal.  Equal to the reference's
    draw in law, not in stream.  A LayerNorm takes Flax's scale 1 and bias
    0, and a Linear without bias (the transformer's embeddings and
    projections) only its weight."""
    params = {}
    for name, sub in module.named_modules():
        prefix = f"{name}." if name else ""
        if isinstance(sub, torch.nn.Linear):
            params[prefix + "weight"] = _lecun_normal(sub.weight.shape,
                                                      generator)
            if sub.bias is not None:
                params[prefix + "bias"] = torch.zeros(sub.bias.shape)
        elif isinstance(sub, torch.nn.Embedding):
            params[prefix + "weight"] = torch.empty(
                sub.weight.shape).normal_(generator=generator)
        elif isinstance(sub, torch.nn.LayerNorm):
            params[prefix + "weight"] = torch.ones(sub.weight.shape)
            params[prefix + "bias"] = torch.zeros(sub.bias.shape)
    return params


# jax.nn.initializers.variance_scaling's "truncated_normal": the standard
# deviation of a unit normal truncated to +-2.
_TRUNCATED_STD = 0.87962566103423978


def _lecun_normal(shape, generator: torch.Generator) -> torch.Tensor:
    """``lecun_normal`` for a ``[out, in]`` weight: a normal truncated to
    +-2 of its standard deviation ``sqrt(1 / in) / _TRUNCATED_STD``, drawn
    as ``jax.random.truncated_normal`` draws it, by the inverse CDF of a
    uniform between the bounds' CDF values."""
    std = math.sqrt(1.0 / shape[1]) / _TRUNCATED_STD
    lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))
    u = torch.empty(shape).uniform_(lo, hi, generator=generator)
    return torch.erfinv(u).mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0).mul_(std)


def _require_full_f32() -> None:
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("PPO runs its matrix products in full float32: "
                           "set torch.backends.cuda.matmul.allow_tf32 = "
                           "False")


class PPO:
    """Binds the network, the two nets and the optimiser: ``init``,
    ``act``, ``eval_rollout``, ``collect_rollout`` and
    ``train_iteration``."""

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
        self.optimizer = Adam(rl)
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
        """Reset the environment, draw both nets' parameters from
        ``generator`` (a CPU generator; see :func:`init_params`) and zero
        the optimiser's state."""
        env, obs = env_reset(sim_state, self.network, self.rl, self.physics,
                             self._dist_ff)
        dev = self.network.device
        params = {
            name: {k: v.to(dev) for k, v in init_params(net, generator)
                   .items()}
            for name, net in (("policy", self.policy_net),
                              ("value", self.value_net))
        }
        return TrainState(params=params,
                          opt_state=self.optimizer.init(params), env=env,
                          obs=obs, key=split(key, 3)[2], iteration=0)

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
                     segment_ops: SegmentOps = KERNELS,
                     core: Callable = direction_confirm):
        """An evaluation episode of ``num_steps`` steps from the reset
        ``sim_state``, with no host read.  Returns ``(env, rewards [T],
        dones [T], logs)``, ``logs`` holding the per-step arrivals,
        occupancy and time.  ``segment_ops`` overrides the segment kernels
        (K9-K11) and ``core`` the winner kernel (K1), e.g. with their
        plain versions."""
        env, obs = env_reset(sim_state, self.network, self.rl, self.physics,
                             self._dist_ff)
        out = []
        for _ in range(num_steps):
            key, k = split(key)
            action = self.act(params, env, obs, k, deterministic,
                              segment_ops)
            env, obs, reward, done, info = env_step(
                env, action, self.network, self.rl, self.sim_cfg,
                self.physics, dist_ff=self._dist_ff, core=core)
            out.append((reward, done, info["arrivals"], info["on_network"],
                        env.sim.time))
        cols = ([torch.stack(col) for col in zip(*out)] if out
                else [torch.zeros(0, device=self.network.device)] * 5)
        rewards, dones, arrivals, on_net, times = cols
        logs = {"arrivals": arrivals, "on_network": on_net, "time": times}
        return env, rewards, dones, logs

    @torch.no_grad()
    def collect_rollout(self, params, env: EnvState, obs: Observation,
                        key: Key, segment_ops: SegmentOps = KERNELS,
                        core: Callable = direction_confirm):
        """``rl.rollout_steps`` sampled transitions, resetting the
        environment where an episode ends.  Returns ``(env, obs, key,
        traj, last_value)``, ``traj`` a :class:`Transition` of stacked
        steps.  ``segment_ops`` and ``core`` as in :meth:`eval_rollout`.

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
                dist_ff=self._dist_ff, core=core)
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

    # ------------------------------------------------------------------
    def _loss(self, params, batch: Transition, advantages, returns):
        """PPO's clipped loss on a minibatch (a :class:`Transition` of B
        stacked steps) inside :func:`plain_segments`, as the reference's
        runs under ``no_pallas()``.  Returns ``(total, (loss_obj,
        loss_critic, loss_entropy, approx_kl, clip_frac))``."""
        with plain_segments():
            return self._loss_impl(params, batch, advantages, returns)

    def _loss_impl(self, params, batch: Transition, advantages, returns):
        # The nets and the distribution take the minibatch in one batched
        # pass where the reference vmaps them over it.
        logits = self._policy_logits(params["policy"], batch.x)
        new_log_prob, entropy = log_prob_and_entropy(
            logits, batch.action, self._edge_src, self._num_nodes)
        log_ratio = new_log_prob - batch.log_prob
        ratio = torch.exp(log_ratio)
        eps = self.rl.clip_epsilon
        obj = torch.minimum(ratio * advantages,
                            torch.clamp(ratio, 1.0 - eps, 1.0 + eps)
                            * advantages)
        loss_obj = -torch.mean(obj)
        values = self._value(params["value"], batch.x, batch.time)
        loss_critic = torch.mean((values - returns) ** 2)
        loss_entropy = -torch.mean(entropy)
        total = (loss_obj + self.rl.value_coef * loss_critic
                 + self.rl.entropy_coef * loss_entropy)
        approx_kl = torch.mean((ratio - 1.0) - log_ratio)
        clip_frac = torch.mean((torch.abs(ratio - 1.0) > eps)
                               .to(torch.float32))
        return total, (loss_obj, loss_critic, loss_entropy, approx_kl,
                       clip_frac)

    def _loss_and_grads(self, params, batch: Transition, advantages,
                        returns):
        """``((total, aux), grads)``: the loss and its gradients with
        respect to every parameter, keyed like ``params``."""
        leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
        with torch.enable_grad():
            total, aux = self._loss(leaves, batch, advantages, returns)
            flat = [t for sub in leaves.values() for t in sub.values()]
            grads = iter(torch.autograd.grad(total, flat,
                                             materialize_grads=True))
        return ((total.detach(), tuple(a.detach() for a in aux)),
                tree_map(lambda _: next(grads), leaves))

    def _update_epochs(self, params, opt_state: AdamState,
                       buffer: Transition, advantages, returns, key: Key,
                       grads_fn: Callable | None = None):
        """``rl.num_epochs`` epochs of clipped updates over permuted
        minibatches of the flat transition buffer; the remainder of
        ``n // minibatch_size`` is dropped, as the reference drops it.
        Returns ``((params, opt_state, key), stats)``, ``stats`` a list of
        ``(loss, aux, grad_norm)`` per update, ``grad_norm`` the global
        norm of the unclipped gradients.  ``grads_fn`` replaces
        :meth:`_loss_and_grads` (the sharded trainers' gradients)."""
        grads_fn = grads_fn or self._loss_and_grads
        n = advantages.shape[0]
        mb = min(self.rl.minibatch_size, n)
        n_mb = max(n // mb, 1)
        stats = []
        for _ in range(self.rl.num_epochs):
            key, k_perm = split(key)
            perm = permutation(k_perm, n, advantages.device)
            for i in range(n_mb):
                idx = perm[i * mb:(i + 1) * mb]
                batch = Transition(*(a[idx] for a in buffer))
                (loss, aux), grads = grads_fn(params, batch, advantages[idx],
                                              returns[idx])
                params, opt_state = self.optimizer.update(grads, opt_state,
                                                          params)
                stats.append((loss, aux, global_norm(grads)))
        return (params, opt_state, key), stats

    def train_iteration(self, ts: TrainState,
                        segment_ops: SegmentOps = KERNELS):
        """One PPO iteration: collect ``rl.rollout_steps`` transitions
        (``segment_ops`` in the collection, as in
        :meth:`collect_rollout`), GAE and normalised advantages, then the
        epochs of updates.  Returns ``(TrainState, IterationMetrics)``."""
        _require_full_f32()
        env, obs, key, traj, last_value = self.collect_rollout(
            ts.params, ts.env, ts.obs, ts.key, segment_ops)
        advantages, returns = gae(traj.reward, traj.value, last_value,
                                  traj.done, self.rl.gamma,
                                  self.rl.gae_lambda)
        advantages = normalize(advantages)
        (params, opt_state, key), stats = self._update_epochs(
            ts.params, ts.opt_state, traj, advantages, returns, key)
        ts = TrainState(params=params, opt_state=opt_state, env=env,
                        obs=obs, key=key, iteration=ts.iteration + 1)
        return ts, iteration_metrics(stats, traj, returns)
