"""The PPO training loop: logging, evaluation, checkpoints (ports
``tarl_tpu/rl/trainer.py``: ``MetricLogger`` and ``ppo_train``).

Each iteration is one :meth:`~tarl_tpu_torch.rl.ppo.PPO.train_iteration`
(or a :class:`~tarl_tpu_torch.parallel.shard.BatchedPPO`'s, over several
environments); this module is the host-side shell around it: the
reference's scalars (TensorBoard through ``torch.utils.tensorboard`` where
it imports, a CSV always), periodic greedy and stochastic evaluation
rollouts with each one's leg histogram as a TensorBoard figure (where
TensorBoard and matplotlib, both optional, import), and checkpoints with
resume.
"""
from __future__ import annotations

import csv
import json
import os
import time as _time
from typing import Optional

import numpy as np
import torch

from ..config import DEFAULT_RL, RLConfig
from ..core.rng import Key, prng_key
from ..core.step import average_travel_time
from ..metrics.equilibrium import nash_gap, tstt
from ..parallel.shard import BatchedPPO, replica
from .checkpoint import latest_checkpoint, restore_checkpoint, save_checkpoint
from .ppo import PPO, TrainState, tree_map


class MetricLogger:
    """Scalars to TensorBoard (when ``torch.utils.tensorboard`` imports)
    and always to ``<log_dir>/metrics.csv``."""

    def __init__(self, log_dir: Optional[str]):
        self.writer = None
        self.csv_path = None
        self._rows: list = []
        self._fields: list = ["step"]
        if log_dir is None:
            return
        os.makedirs(log_dir, exist_ok=True)
        self.csv_path = os.path.join(log_dir, "metrics.csv")
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return
        self.writer = SummaryWriter(log_dir)

    def scalars(self, step: int, values: dict) -> None:
        if self.writer is not None:
            for k, v in values.items():
                self.writer.add_scalar(k, float(v), step)
        if self.csv_path is not None:
            row = {"step": step, **{k: float(v) for k, v in values.items()}}
            # Train and eval rows carry different keys: the header is their
            # union, and the file is rewritten (O(iterations) rows).
            self._rows.append(row)
            for k in row:
                if k not in self._fields:
                    self._fields.append(k)
            with open(self.csv_path, "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=self._fields)
                w.writeheader()
                w.writerows(self._rows)

    def figure(self, step: int, tag: str, fig) -> None:
        """A matplotlib figure to TensorBoard (nothing without a writer or
        a figure)."""
        if self.writer is not None and fig is not None:
            self.writer.add_figure(tag, fig, step)

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()


def _log_leg_histogram(logger: MetricLogger, step: int, tag: str,
                       logs: dict) -> None:
    """An evaluation's leg histogram as the figure ``{tag}/leg_histogram``,
    from its per-step arrivals, occupancy and clock; nothing where
    TensorBoard or matplotlib (both optional) is missing."""
    if logger.writer is None:
        return
    from ..metrics.reporting import PlottingUnavailable, plot_leg_histogram

    arrivals, on_net, times = (logs[k].cpu().numpy().astype(np.float64)
                               for k in ("arrivals", "on_network", "time"))
    # [departures, arrivals, on the network, clock] a step: the departures
    # are the occupancy's change plus the arrivals.
    values = np.stack([np.diff(on_net, prepend=0.0) + arrivals, arrivals,
                       on_net, times], axis=1).tolist()
    try:
        fig = plot_leg_histogram(values, 1, output_dir=None)
    except PlottingUnavailable:
        return
    logger.figure(step, f"{tag}/leg_histogram", fig)
    if fig is not None:
        import matplotlib.pyplot as plt

        plt.close(fig)


# The reference's scalar names for the IterationMetrics fields.
_METRIC_FIELDS, _SCALAR_NAMES = zip(
    ("loss_objective", "loss/objective"), ("loss_critic", "loss/value"),
    ("loss_entropy", "loss/entropy"), ("loss_total", "loss/total"),
    ("approx_kl", "approx_kl"), ("clip_fraction", "clip_fraction"),
    ("grad_norm", "grad_global_norm"), ("avg_reward", "PPO/avg_reward"),
    ("avg_return", "PPO/avg_return"),
    ("avg_on_network", "transport/avg_on_network"))


def _rollout_fields(ts) -> tuple[str, ...]:
    """The fields of a trainer state that the next iteration collects
    from: a batched state's replicas, their keys and the update key, or
    the environment, observation and key."""
    if hasattr(ts, "envs"):
        return ("envs", "obss", "keys", "update_key")
    return ("env", "obs", "key")


def _transport_scalars(ppo: PPO | BatchedPPO, sim) -> dict:
    """The average travel time and the episode's V/C ratio (hourly
    traversals over flow capacity, mean and std over the hours with
    traffic), from the live simulation state."""
    out = {"transport/avg_travel_time": float(average_travel_time(
        sim.agents))}
    hc = sim.metrics.hourly_counts.to(torch.float64)
    active = hc.sum(dim=1) > 0
    if bool(active.any()):
        flow_cap = torch.clamp(ppo.network.max_flow.to(torch.float64),
                               min=1.0)
        vc = hc[active] / flow_cap[None, :]
        out["transport/avg_vc_ratio"] = float(vc.mean())
        out["transport/std_vc_ratio"] = float(vc.std(correction=0))
    else:
        out["transport/avg_vc_ratio"] = 0.0
        out["transport/std_vc_ratio"] = 0.0
    return out


def ppo_train(
    ppo: PPO | BatchedPPO,
    sim_state,
    *,
    num_iterations: int,
    key: Optional[Key] = None,
    generator: Optional[torch.Generator] = None,
    rl: RLConfig = DEFAULT_RL,
    log_dir: Optional[str] = None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_interval: int = 10,
    eval_interval: int = 0,
    eval_steps: Optional[int] = None,
    stochastic_eval: bool = False,
    stochastic_eval_samples: int = 1,
    resume: bool = False,
    verbose: bool = True,
    track_best: Optional[str] = None,
    ema_decay: Optional[float] = None,
) -> TrainState:
    """Train for ``num_iterations`` PPO iterations; returns the last
    :class:`TrainState` (a ``BatchTrainState`` for a :class:`BatchedPPO`,
    whose transport scalars are its first replica's, as the reference's).

    ``key`` (default ``prng_key(rl.episode_start)``) seeds the rollouts
    and minibatch orders, ``generator`` (a CPU ``torch.Generator``, default
    seeded with ``rl.episode_start``) the initial parameters.  With
    ``resume`` the latest ``ckpt_<iter>`` under ``checkpoint_dir`` replaces
    them: its parameters, optimiser state and iteration, and, where it
    holds them, the environment, observation and key (a batched run's
    replicas, their keys and the update key), so that the resumed run
    continues the uninterrupted one exactly.  A checkpoint is written
    every ``checkpoint_interval`` iterations and at the end.

    Every ``eval_interval`` iterations a greedy evaluation (and with
    ``stochastic_eval`` the mean of ``stochastic_eval_samples`` sampled
    ones) of ``eval_steps`` steps logs ``eval/avg_return``,
    ``eval/episode_len``, ``eval/tstt`` and ``eval/relative_nash_gap``
    (:mod:`~tarl_tpu_torch.metrics.equilibrium` on the rollout's final
    state and congested costs), ``eval/avg_travel_time`` and
    ``eval/computation_time_ms`` (``eval_stochastic/...`` for the sampled
    ones), from keys of their own (``prng_key(it + s * 7919)``), so the
    training trajectory does not depend on them, and the figure
    ``eval/leg_histogram`` (of the last sample) where TensorBoard and
    matplotlib import.  ``track_best`` names an
    eval scalar to minimise: each improvement writes ``<checkpoint_dir>/
    best`` and ``best.json``.  ``ema_decay`` keeps an exponential moving
    average of the parameters, which every evaluation and the best
    snapshot use (``final_ema`` is written at the end); the updates apply
    to the raw parameters.
    """
    if key is None:
        key = prng_key(rl.episode_start)
    if generator is None:
        generator = torch.Generator().manual_seed(rl.episode_start)
    ts = ppo.init(sim_state, key, generator)
    dev = ppo.network.device

    start_iter = 0
    if resume and checkpoint_dir:
        path = latest_checkpoint(checkpoint_dir)
        if path:
            restored = restore_checkpoint(path, dev)
            start_iter = restored["iteration"]
            ts = ts._replace(params=restored["params"],
                             opt_state=restored["opt_state"],
                             iteration=start_iter)
            if "rollout" in restored:
                ts = ts._replace(**dict(zip(_rollout_fields(ts),
                                            restored["rollout"])))
            if verbose:
                print(f"Resumed from {path} (iteration {start_iter})")

    logger = MetricLogger(log_dir)
    eval_steps = eval_steps or rl.rollout_steps
    best_metric = None
    ema_params = ts.params if ema_decay else None

    def checkpoint(name, params, iteration, rollout=False):
        save_checkpoint(os.path.join(checkpoint_dir, name), params,
                        ts.opt_state, iteration,
                        tuple(getattr(ts, f) for f in _rollout_fields(ts))
                        if rollout else None)

    t0 = _time.time()
    for it in range(start_iter, num_iterations):
        ts, metrics = ppo.train_iteration(ts)
        if ema_decay:
            ema_params = tree_map(
                lambda e, p: ema_decay * e + (1.0 - ema_decay) * p,
                ema_params, ts.params)
        step = (it + 1) * rl.rollout_steps
        # The iteration's scalars reach the host in one transfer.
        scalars = dict(zip(_SCALAR_NAMES, torch.stack(
            [getattr(metrics, f) for f in _METRIC_FIELDS]).tolist()))
        env = replica(ts.envs, 0) if hasattr(ts, "envs") else ts.env
        scalars.update(_transport_scalars(ppo, env.sim))
        logger.scalars(step, scalars)
        if verbose:
            print(f"iter {it + 1}/{num_iterations} "
                  f"reward {scalars['PPO/avg_reward']:.1f} "
                  f"kl {scalars['approx_kl']:.4f} "
                  f"loss {scalars['loss/total']:.3f} "
                  f"({_time.time() - t0:.1f}s)")

        if eval_interval and (it + 1) % eval_interval == 0:
            eval_params = ema_params if ema_decay else ts.params
            for det, tag in ((True, "eval"), (False, "eval_stochastic")):
                if not det and not stochastic_eval:
                    continue
                # Averaging a few sample keys makes a stochastic reading a
                # steadier selection metric; a greedy one is exact.
                n_samples = 1 if det else max(1, stochastic_eval_samples)
                t_eval = _time.time()
                acc: dict = {}
                for s in range(n_samples):
                    eval_env, rewards, _, logs = ppo.eval_rollout(
                        eval_params, sim_state, prng_key(it + s * 7919),
                        eval_steps, deterministic=det)
                    fsim = eval_env.sim
                    gap = nash_gap(fsim.agents, fsim.road, ppo.network)
                    sample = {
                        f"{tag}/avg_return": float(rewards.sum()),
                        f"{tag}/episode_len": int(rewards.shape[0]),
                        f"{tag}/tstt": float(tstt(fsim.agents, fsim.time)),
                        f"{tag}/relative_nash_gap": float(
                            gap["relative_gap"]),
                        f"{tag}/avg_travel_time": float(
                            average_travel_time(fsim.agents)),
                    }
                    for k, v in sample.items():
                        acc[k] = acc.get(k, 0.0) + v / n_samples
                acc[f"{tag}/computation_time_ms"] = (
                    (_time.time() - t_eval) * 1000.0 / n_samples)
                logger.scalars(step, acc)
                _log_leg_histogram(logger, step, tag, logs)
                if track_best and track_best in acc and checkpoint_dir:
                    v = float(acc[track_best])
                    if best_metric is None or v < best_metric:
                        best_metric = v
                        checkpoint("best", eval_params, it + 1)
                        with open(os.path.join(checkpoint_dir, "best.json"),
                                  "w") as f:
                            json.dump({"metric": track_best, "value": v,
                                       "iteration": it + 1}, f)
                        if verbose:
                            print(f"new best {track_best}={v:.2f} at "
                                  f"iteration {it + 1}")

        if checkpoint_dir and (it + 1) % checkpoint_interval == 0:
            checkpoint(f"ckpt_{it + 1}", ts.params, it + 1, rollout=True)

    if checkpoint_dir:
        checkpoint(f"ckpt_{num_iterations}", ts.params, num_iterations,
                   rollout=True)
        if ema_decay:
            checkpoint("final_ema", ema_params, num_iterations)
    logger.close()
    return ts
