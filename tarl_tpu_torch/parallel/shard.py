"""Multi-environment PPO on one card (ports ``tarl_tpu/parallel/shard.py``:
``BatchTrainState`` and ``BatchedPPO``).

``num_envs`` independent environment replicas collect a rollout each per
iteration; their ``[B, T]`` trajectories are flattened to ``[B*T]`` and
go through the single-environment update, permuted minibatches over the
flat buffer (:meth:`~tarl_tpu_torch.rl.ppo.PPO._update_epochs`), so the
clip-fraction and KL statistics compare across ``num_envs``.

The reference vmaps the rollout over a leading batch axis under
``no_pallas()`` and shards it over the mesh's ``dp`` axis.  Here the
replicas step in turn, each through :meth:`PPO.collect_rollout` with its
own key: the same function, since the replicas are independent and a vmap
is by definition the B single-environment rollouts.  Each replica's step
launches K1, K11's sample and K10's log-prob entry once, as the
single-environment collection does, so an iteration launches each ``B *
T`` times; GAE and the update launch none.

A mesh of one device must be the network's: every replica runs there.
The reference's runner builds ``make_mesh(min(device_count, num_envs),
sp=1)``, which on one card is that mesh.  A mesh over a ``torch.distributed``
group (``make_mesh(group=...)``) lays the trainer out as the reference
lays it over its devices: the replicas are split over ``dp``, the ranks of
one ``dp`` row collect the same replicas (replica i's keys are the
one-process run's, whichever rank steps it), their trajectories are
gathered over the group, GAE and the normalisation run on the full buffer
on every rank, each rank takes its ``1 / (dp sp)`` share of every
minibatch's rows, and one float all-reduce averages the shares' losses and
gradients.  The parameters and Adam are replicated.  Every replica's
actions, rewards and dones equal the one-process run's bitwise; the
parameters equal them to the order of the float additions.  A rank's
``BatchTrainState`` holds its row's replicas (:attr:`BatchedPPO.replicas`).

The replicas' states are stacked on a leading ``[B]`` axis: every tensor
of an ``EnvState`` or ``Observation`` as ``[B, ...]``, every host value
(the simulation's key, insert pointer and choice count) as a tuple of B
(:func:`stack_replicas`); the rollout keys are a tuple of B keys.
:func:`replica` reads one replica back, its tensors as views.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from ..core.fused_winner import direction_confirm
from ..core.rng import Key, fold_in, split
from ..ops.segment import KERNELS, SegmentOps
from ..rl.env import env_reset
from ..rl.gae import gae, normalize
from ..rl.ppo import PPO, Transition, iteration_metrics
from .mesh import DeviceMesh, Ranks


class BatchTrainState(NamedTuple):
    """Parameters and optimiser state, the replicas' stacked environments
    and observations, their keys, the minibatch order's key and the
    iteration count."""

    params: Any
    opt_state: Any
    envs: Any                # EnvState, stacked [B, ...]
    obss: Any                # Observation, stacked [B, ...]
    keys: tuple[Key, ...]    # one rollout key per replica
    update_key: Key          # minibatch permutations
    iteration: int


def _is_record(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def stack_replicas(items: list):
    """One tree from B trees of the same structure: each tensor stacked on
    a new leading axis, each other leaf a tuple of the B values."""
    first = items[0]
    if _is_record(first):
        return type(first)(*(stack_replicas([getattr(t, f) for t in items])
                             for f in first._fields))
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return torch.stack(items)
    return tuple(items)


def replica(tree, i: int):
    """Replica ``i`` of a tree :func:`stack_replicas` built."""
    if _is_record(tree):
        return type(tree)(*(replica(getattr(tree, f), i)
                            for f in tree._fields))
    return None if tree is None else tree[i]


class BatchedPPO:
    """``num_envs`` replicas of a single-environment :class:`PPO`, whose
    collection, loss and update it reuses.  ``num_envs`` must be a multiple
    of the mesh's ``dp`` size and ``rollout_steps * num_envs`` of ``dp *
    sp``; over a group, the minibatch too."""

    def __init__(self, ppo: PPO, mesh: DeviceMesh, num_envs: int):
        self.ppo = ppo
        self.mesh = mesh
        self.num_envs = num_envs
        dp, sp = mesh.shape["dp"], mesh.shape["sp"]
        if num_envs % dp:
            raise ValueError(f"num_envs {num_envs} % dp {dp} != 0")
        if (num_envs * ppo.rl.rollout_steps) % (dp * sp):
            raise ValueError(f"num_envs x rollout_steps "
                             f"{num_envs * ppo.rl.rollout_steps} % dp x sp "
                             f"{dp * sp} != 0")
        if mesh.devices != [ppo.network.device]:
            raise NotImplementedError(
                f"a mesh over {mesh.devices}: the batched trainer "
                f"runs every replica on the network's device, "
                f"{ppo.network.device}")
        bt = num_envs * ppo.rl.rollout_steps
        self.minibatch_size = min(ppo.rl.minibatch_size, bt)
        self.num_minibatches = max(bt // self.minibatch_size, 1)
        # The ranks' transport, the replicas this rank collects and its
        # rows of each minibatch.
        self._ranks = None
        per_row = num_envs // dp
        row = mesh.rank // sp
        self.replicas = range(row * per_row, (row + 1) * per_row)
        if mesh.group is not None:
            self._ranks = Ranks(mesh.group, mesh.devices[0])
            if self.minibatch_size % (dp * sp):
                raise ValueError(f"minibatch {self.minibatch_size} % dp x "
                                 f"sp {dp * sp} != 0")

    # ------------------------------------------------------------------
    def init(self, sim_state, key: Key,
             generator: torch.Generator) -> BatchTrainState:
        """:meth:`PPO.init`, then ``num_envs`` copies of the reset
        environment (over a group, this rank's :attr:`replicas`), replica
        i's simulation key ``fold_in(key0, i)``; the rollout keys
        ``split(key, num_envs)`` and the update key ``fold_in(key, 7)``."""
        ppo = self.ppo
        ts = ppo.init(sim_state, key, generator)
        env0, obs0 = env_reset(ts.env.sim, ppo.network, ppo.rl, ppo.physics,
                               ppo._dist_ff)
        envs = [env0._replace(sim=env0.sim._replace(
            key=fold_in(env0.sim.key, i))) for i in self.replicas]
        keys = split(key, self.num_envs)
        return BatchTrainState(
            params=ts.params, opt_state=ts.opt_state,
            envs=stack_replicas(envs),
            obss=stack_replicas([obs0] * len(self.replicas)),
            keys=tuple(keys[i] for i in self.replicas),
            update_key=fold_in(key, 7), iteration=0)

    def train_step(self, ts: BatchTrainState,
                   segment_ops: SegmentOps = KERNELS,
                   core: Callable = direction_confirm):
        """One iteration: a rollout per replica (``segment_ops`` and
        ``core`` in the collection, as in :meth:`PPO.collect_rollout`),
        GAE per replica, the advantages normalised over the flat buffer,
        then the epochs of updates.  Returns ``(BatchTrainState,
        IterationMetrics)``."""
        ppo, rl = self.ppo, self.ppo.rl
        b, t = self.num_envs, rl.rollout_steps
        outs = [ppo.collect_rollout(ts.params, replica(ts.envs, i),
                                    replica(ts.obss, i), ts.keys[i],
                                    segment_ops, core)
                for i in range(len(self.replicas))]
        envs, obss, keys, trajs, last_values = zip(*outs)
        traj = stack_replicas(list(trajs))            # [B, T, ...]
        last_values = torch.stack(last_values)
        if self._ranks is not None:
            traj = Transition(*(self._gather(a) for a in traj))
            last_values = self._gather(last_values)
        advantages, returns = gae(traj.reward, traj.value, last_values,
                                  traj.done, rl.gamma, rl.gae_lambda)
        flat = Transition(*(a.reshape((b * t,) + a.shape[2:])
                            for a in traj))
        returns = returns.reshape(b * t)
        args = (ts.params, ts.opt_state, flat,
                normalize(advantages.reshape(b * t)), returns, ts.update_key)
        if self._ranks is not None:
            args += (self._grads,)       # the ranks' share of each minibatch
        (params, opt_state, update_key), stats = ppo._update_epochs(*args)
        ts = BatchTrainState(
            params=params, opt_state=opt_state,
            envs=stack_replicas(list(envs)), obss=stack_replicas(list(obss)),
            keys=tuple(keys), update_key=update_key,
            iteration=ts.iteration + 1)
        return ts, iteration_metrics(stats, traj, returns)

    # The trainer's interface, as :class:`PPO`'s.
    train_iteration = train_step

    def _gather(self, a: torch.Tensor) -> torch.Tensor:
        """``[B/dp, ...]`` of this rank's row -> ``[B, ...]``, the rows in
        replica order (the gather over the group, one rank a row kept)."""
        dp, sp = self.mesh.shape["dp"], self.mesh.shape["sp"]
        raw = a.to(torch.uint8) if a.dtype == torch.bool else a
        full = self._ranks.gather(raw)
        full = full.view((dp, sp) + tuple(a.shape))[:, 0]
        return full.reshape((-1,) + tuple(a.shape[1:])).to(a.dtype)

    def _grads(self, params, batch: Transition, advantages, returns):
        """``PPO._loss_and_grads`` on this rank's share of the minibatch's
        rows, the loss terms and gradients averaged over the ranks in one
        all-reduce (equal shares: the mean of the shares' means is the
        minibatch's)."""
        ranks = self._ranks
        share = advantages.shape[0] // ranks.world
        rows = slice(ranks.rank * share, (ranks.rank + 1) * share)
        (loss, aux), grads = self.ppo._loss_and_grads(
            params, Transition(*(a[rows] for a in batch)),
            advantages[rows], returns[rows])
        leaves = [g for sub in grads.values() for g in sub.values()]
        summed = ranks.sum_tensors([torch.stack((loss,) + tuple(aux))]
                                   + leaves)
        scale = 1.0 / ranks.world
        terms = summed[0] * scale
        it = iter(summed[1:])
        return ((terms[0], tuple(terms[1:])),
                {part: {k: next(it) * scale for k in sub}
                 for part, sub in grads.items()})

    @property
    def network(self):
        return self.ppo.network

    @property
    def rl(self):
        return self.ppo.rl

    def eval_rollout(self, params, sim_state, key: Key, num_steps: int,
                     deterministic: bool = True, **kw):
        """A single-environment evaluation (:meth:`PPO.eval_rollout`)."""
        return self.ppo.eval_rollout(params, sim_state, key, num_steps,
                                     deterministic, **kw)
