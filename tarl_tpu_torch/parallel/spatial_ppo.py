"""Spatially sharded PPO training (ports ``tarl_tpu/parallel/spatial_ppo.py``:
``make_spatial_mesh`` and ``SpatialPPO`` with ``rollout`` and
``train_iteration``).

The environment's rings live on road blocks for the whole iteration and
the policy is scored on node-column blocks, both splits of one mesh of S
blocks (a :class:`~tarl_tpu_torch.parallel.shard_map_episode.RoadMesh`):

* roads: block ``i`` holds the padded rows ``[i Rp/S, (i+1) Rp/S)`` of the
  rings, the hourly metric columns and ``old_counts``, the inert padding of
  the sharded episode (:class:`~tarl_tpu_torch.parallel.shard_map_episode.
  RoadBlocks`);
* nodes: the slot-major out-edge tables with their edge ids, padded to
  ``Np`` columns (``parallel.sharded_ppo.node_tables``), virtual SRC/DEST
  columns included, block ``i`` the columns ``[i Np/S, (i+1) Np/S)``, for
  the policy forward, the sample, the log-prob and the update's loss;
* agents, parameters, the optimiser, the key: replicated; agent writes are
  disjoint over the blocks and merged by sums.

A rollout step follows ``rl.env.env_step``'s order: the sample and its
choice, the core, the withdraw, the insert, the reward, the clock, and the
auto-reset of ``PPO.collect_rollout``.  The sample draws the replicated
``[E]`` Gumbel vector of ``GraphDistribution.sample``'s key, scatters it
onto the slot table by edge id and takes the ascending-slot strict ``>``
on each column: the actions are bitwise the unsharded rollout's (on the
card, K11's action entry, whose noise is element ``e``'s).  The core is
the sharded episode's: one launch of K7 (``fused_shard_winner``) a step
for the held road blocks, from the halo's packed upstream words, its
direction noise drawn inside at the serial core's addresses, the winners
gathered to pop their heads.  The log-prob is the blocks' partial sums
added by a float ``psum``; the ``progress`` potential likewise over the
row-sharded free-flow distances.  The ``on_network`` and ``throughput``
totals and the clock's mismatch count are int32 sums, cast after the sum,
so the rewards of those modes, the dones and the clock are bitwise.

The update is ``ShardedPPO``'s: ``node_sharded_loss_fn`` on the trajectory
(``SpatialPPO`` takes edge-row-independent nets only, as the reference).

Refused, as the reference refuses them: a windowed insert (the env's is the
whole population's), reward modes other than ``on_network``, ``system``,
``throughput`` and ``progress``, and ``congested_potential``.  The halo
keeps ids as int32 where the reference stacked them as float32 (exact only
below 2**24 ids), as the sharded episode does.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..core import rng
from ..core.direction import road_delta
from ..core.fused_winner import fused_shard_winner
from ..core.rng import split
from ..core.step import reset_sim_state
from ..core.sync import host_read
from ..ops.scatter import scatter_set
from ..rl.env import EnvState, _observe
from ..rl.gae import gae, normalize
from ..rl.learned_policy import rollout_context
from ..rl.ppo import (
    PPO,
    TrainState,
    Transition,
    _require_full_f32,
    iteration_metrics,
)
from ..state import MetricState
from .shard_map_episode import RoadBlocks, RoadMesh, make_road_mesh
from .sharded_ppo import ShardedPPO, block_log_prob_entropy

REWARD_MODES = ("on_network", "system", "throughput", "progress")


# Each block a block of roads and one of node columns.
make_spatial_mesh = make_road_mesh


class SpatialPPO:
    """Spatially sharded training for an existing :class:`PPO`:
    :meth:`train_iteration` takes and returns the unsharded
    ``TrainState``, as ``PPO.train_iteration`` does; :meth:`rollout`
    returns the trajectory alone."""

    def __init__(self, ppo: PPO, mesh: RoadMesh):
        rl = ppo.rl
        if ppo.sim_cfg.insert_window is not None:
            raise ValueError("SpatialPPO runs the env's whole-population "
                             "insert; a windowed insert is an episode path")
        if rl.reward_mode not in REWARD_MODES:
            raise ValueError(f"reward_mode {rl.reward_mode!r} is not taken "
                             f"on road blocks: one of {REWARD_MODES}")
        if rl.congested_potential:
            raise ValueError("congested_potential recomputes a distance "
                             "table a step: train unsharded")
        if not getattr(ppo.policy_net, "edge_row_independent", True):
            raise ValueError("SpatialPPO takes edge-row-independent policy "
                             "nets only")
        self.ppo, self.mesh = ppo, mesh
        self.update = ShardedPPO(ppo, mesh)
        tables = self.update.tables
        lo, n = self.update._lo, self.update._n
        self._ok = tables.ok[:, lo:lo + n]
        self._dst = tables.dst[:, lo:lo + n]
        self._eid = tables.eid[:, lo:lo + n].long()
        net = ppo.network
        self._prev_cols = torch.clamp(torch.arange(lo, lo + n,
                                                   device=net.device),
                                      max=net.num_nodes - 1)

    # -- the state on the blocks ------------------------------------------
    def _local(self, kit: RoadBlocks, env: EnvState) -> EnvState:
        if env.sim.backlog is not None:
            raise ValueError("the RL path carries no insert backlog")
        return env._replace(sim=kit.local_state(env.sim),
                            old_counts=kit.rows(env.old_counts, 0))

    def _global(self, kit: RoadBlocks, env: EnvState) -> EnvState:
        return env._replace(sim=kit.global_state(env.sim),
                            old_counts=kit.gather_rows(env.old_counts))

    def _context(self, kit: RoadBlocks, sim, hl) -> torch.Tensor:
        ppo, r = self.ppo, kit.r
        return rollout_context(sim, ppo.network,
                               ppo.rl.observe_pending_entrants,
                               count=hl.count[:r], head_ids=hl.ids[:r],
                               extra_obs=ppo.rl.extra_obs,
                               physics=ppo.physics)

    def _potential(self, kit: RoadBlocks, ring, agents,
                   dist_rows) -> torch.Tensor:
        """float32 ``[held]``: each held block's part of ``fifo_potential``
        over the free-flow distances ``dist_rows``, the held rows of
        ``dist_ff``."""
        nmax = kit.nmax
        col = torch.arange(nmax, device=kit.dev)[None, :]
        valid = torch.remainder(col - ring.head[:, None], nmax) \
            < ring.count[:, None]
        ids = torch.where(valid, ring.fifo_ids, 0)
        rows = torch.arange(kit.n, device=kit.dev)[:, None]
        d = (dist_rows[rows, agents.dest[ids.long()].long()]
             + kit.tables.free_flow[:, None])
        d = torch.where(valid & (ids != 0) & (d < 1e17), d, 0.0)
        return d.view(self.mesh.held, -1).sum(dim=1)

    # -- one step -----------------------------------------------------------
    def _step(self, kit: RoadBlocks, env: EnvState, key, params,
              winner: Callable, dist_rows):
        ppo, mesh = self.ppo, self.mesh
        rl, sim_cfg, physics = ppo.rl, ppo.sim_cfg, ppo.physics
        net = ppo.network
        r, n_nodes, e = kit.r, net.num_nodes, net.full_src.shape[0]
        f32, i32 = torch.float32, torch.int32
        key, k_sample = split(key)
        sim = env.sim
        t = sim.time

        # --- observation (replicated, from the halo) and the policy on the
        # held node columns ---
        hl = kit.halo(sim.road)
        x = self._context(kit, sim, hl)
        time_o = t.reshape(1)
        logit = self.update._logits_fn(params["policy"], x)

        # --- sample: GraphDistribution.sample(k_sample)'s noise at each
        # slot's edge id, the ascending-slot strict > ---
        g = rng.gumbel(k_sample, (e,), kit.dev)
        g_pad = torch.cat([g, g.new_zeros(1)])
        ok, kf = self._ok, self._ok.shape[0]
        score = torch.where(ok & torch.isfinite(logit),
                            logit + g_pad[self._eid], float("-inf"))
        best, slot = score.max(dim=0)      # the first maximum: strict >
        has = torch.isfinite(best)
        at = slot[None, :]
        eid_sel = self._eid.gather(0, at)[0]
        act_local = scatter_set(torch.zeros(e + 1, dtype=i32, device=kit.dev),
                                eid_sel, 1, has)
        action = mesh.psum(act_local[None])[:e] > 0
        chosen = ((torch.arange(kf, device=kit.dev)[:, None] == slot[None, :])
                  & has)
        lp_blk, _ = block_log_prob_entropy(logit[None], ok, chosen[None],
                                           mesh.held)
        log_prob = mesh.psum(lp_blk[:, 0])
        value = ppo._value(params["value"], x, time_o)

        # --- choice: ExternalChoice(action) ---
        sel_cols = torch.where(has, self._dst.gather(0, at)[0],
                               sim.selected_road[self._prev_cols])
        sel = mesh.all_gather(sel_cols.view(mesh.held, -1))[:n_nodes]

        # --- core: K7 on the held road blocks ---
        key_sim, k_dir = split(sim.key)
        delta = (kit.rows(road_delta(hl.roads(r), net), 0.0)
                 if sim_cfg.record_road_optimality_hourly else None)
        ring, popped = kit.core(sim.road, hl, sel, t, k_dir, physics, winner)

        # --- withdraw, insert ---
        agents, ring, wcount = kit.withdraw(sim.agents, ring, t,
                                            sim_cfg.withdraw_depth,
                                            sim_cfg.withdraw_escalate)
        agents, ring = kit.insert(agents, ring, kit.halo(ring), sel, t,
                                  physics)

        # --- reward ---
        on_net = mesh.psum(kit.block_sums(ring.count)).to(f32)
        withdrew = mesh.psum(kit.block_sums(wcount)).to(f32)
        phi_after = env.phi
        if rl.reward_mode == "system":
            pending = torch.sum((agents.departure <= t)
                                & ~agents.inserted).to(f32)
            reward = -(on_net + pending) / rl.progress_scale
        elif rl.reward_mode == "throughput":
            reward = withdrew
        elif rl.reward_mode == "progress":
            phi_after = mesh.psum(self._potential(kit, ring, agents,
                                                  dist_rows))
            reward = (env.phi - phi_after) / rl.progress_scale
        else:  # "on_network"
            reward = -on_net

        # --- event-time clock, on the device ---
        mism = mesh.psum(kit.block_sums((env.old_counts != ring.count)
                                        .to(i32)))
        new_time = torch.where(mism == 0, t + sim_cfg.timestep, t)
        done = new_time > rl.episode_end

        # --- metric accumulators ---
        hour = torch.clamp((t / 3600.0).to(i32), 0,
                           sim_cfg.num_hours - 1).reshape(1).long()
        m = sim.metrics
        hourly = torch.index_add(m.hourly_counts, 0, hour,
                                 ((wcount > 0) | popped).to(i32)[None])
        delta_hourly = m.delta_tt_hourly
        if delta is not None:
            delta_hourly = torch.index_add(delta_hourly, 0, hour,
                                           delta[None])
        new_sim = sim._replace(
            road=ring, agents=agents, selected_road=sel, time=new_time,
            key=key_sim,
            metrics=MetricState(hourly_counts=hourly, on_way_before=on_net,
                                done_before=m.done_before + withdrew,
                                delta_tt_hourly=delta_hourly))
        env = EnvState(sim=new_sim, old_counts=ring.count, done=done,
                       phi=phi_after)
        tr = Transition(x=x, time=time_o, action=action, log_prob=log_prob,
                        value=value, reward=reward, done=done,
                        on_network=on_net)
        return env, key, tr

    def _reset(self, env: EnvState) -> EnvState:
        """``env_reset`` on the blocks: empty rings (potential 0)."""
        rl = self.ppo.rl
        sim = reset_sim_state(env.sim, rl.episode_start)
        dev = env.old_counts.device
        sim = sim._replace(time=torch.tensor(sim.time, dtype=torch.float32,
                                             device=dev))
        return EnvState(sim=sim, old_counts=sim.road.count,
                        done=torch.zeros((), dtype=torch.bool, device=dev),
                        phi=torch.zeros((), dtype=torch.float32, device=dev))

    @torch.no_grad()
    def _collect(self, ts: TrainState, winner: Callable):
        """``PPO.collect_rollout`` on the blocks: ``(env, obs, key, traj,
        last_value)``, ``env`` and ``obs`` unsharded."""
        _require_full_f32()
        ppo = self.ppo
        rl = ppo.rl
        kit = RoadBlocks(ppo.network, self.mesh, ts.env.sim.agents.num_agents)
        dist_rows = (None if rl.reward_mode != "progress"
                     else kit.rows(ppo._dist_ff[:kit.r], 1e18))
        env, key = self._local(kit, ts.env), ts.key
        t_high = host_read(torch.ceil(env.sim.time))[0]
        steps = []
        for _ in range(rl.rollout_steps):
            env2, key, tr = self._step(kit, env, key, ts.params, winner,
                                       dist_rows)
            t_high += ppo.sim_cfg.timestep
            if t_high > rl.episode_end:
                ended, t_high = host_read(tr.done,
                                          torch.ceil(env2.sim.time))
                if ended:
                    env2 = self._reset(env2)
                    t_high = rl.episode_start
            steps.append(tr)
            env = env2
        traj = Transition(*(torch.stack(col) for col in zip(*steps)))
        x_last = self._context(kit, env.sim, kit.halo(env.sim.road))
        last_value = ppo._value(ts.params["value"], x_last,
                                env.sim.time.reshape(1))
        env = self._global(kit, env)
        return env, _observe(env.sim, ppo.network, rl), key, traj, last_value

    def rollout(self, ts: TrainState,
                winner: Callable = fused_shard_winner) -> Transition:
        """The trajectory of ``rl.rollout_steps`` steps from ``ts`` on the
        blocks.  ``winner`` is the road-block winner (K7;
        ``fused_shard_winner_plain`` runs its plain version on the card)."""
        return self._collect(ts, winner)[3]

    def train_iteration(self, ts: TrainState,
                        winner: Callable = fused_shard_winner):
        """One iteration: the rollout on the blocks, GAE and the normalised
        advantages (replicated), then ``PPO._update_epochs`` over the
        node-sharded gradients.  ``(TrainState, IterationMetrics)``, the
        state unsharded."""
        ppo = self.ppo
        env, obs, key, traj, last_value = self._collect(ts, winner)
        advantages, returns = gae(traj.reward, traj.value, last_value,
                                  traj.done, ppo.rl.gamma, ppo.rl.gae_lambda)
        (params, opt_state, key), stats = ppo._update_epochs(
            ts.params, ts.opt_state, traj, normalize(advantages), returns,
            key, grads_fn=self.update._grads)
        ts = TrainState(params=params, opt_state=opt_state, env=env,
                        obs=obs, key=key, iteration=ts.iteration + 1)
        return ts, iteration_metrics(stats, traj, returns)
