"""The experiment runner and its command line (ports ``tarl_tpu/runner.py``:
``RunnerArgs``, ``Runner.setup/train/eval/_summary`` and ``main``).

``python main_torch.py --algo dijkstra --scenario Easy --mode eval ...``
takes the reference CLI's flags.  Where the reference's differ:

* ``--device`` places the run: ``cuda`` (the default, the card) or
  ``cpu``.  Without a card the runner refuses ``cuda``; it never carries
  on on the CPU unasked;
* ``--checkpoint`` takes a checkpoint of the port (a ``ckpt_<iter>`` file
  written by ``--mode train``, or its directory, whose latest is read), or
  an ``.npz`` of MPNN parameters as the JAX-side
  ``scripts/export_mpnn_params.py`` writes it;
* the per-tick road-optimality budgets are constants
  (:data:`PER_TICK_BUDGET`, :data:`PER_TICK_DEV_BUDGET`), and past the
  first the series is kept in the sparse store;
* ``--num-envs B`` above 1 trains with
  :class:`~tarl_tpu_torch.parallel.shard.BatchedPPO` over B environment
  replicas, all on the one device ``--device`` names (a one-device mesh,
  which is what the reference's runner builds on one card);
* ``--algo transformer|transformer+ppo`` draws its Laplacian positional
  encoding afresh, as the reference's does (not reproducible call to call:
  ``models.transformer.embedding``); an ``.npz`` of its parameters is
  evaluated with the encoding it carries, where it carries one.

Without matplotlib (the optional ``reports`` extra) the summary prints one
line naming the figures it did not draw, and still writes the CSV files
and ``equilibrium_report.json``.
"""
from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path

import torch

from .algorithms.episode import run_episode
from .algorithms.msa import run_msa
from .config import RLConfig, SimConfig
from .convert import load_params_npz, mpnn_params_from_numpy
from .core.rng import prng_key
from .core.step import Policy
from .device import resolve_device
from .io.cache import load_or_build_network
from .metrics import reporting
from .metrics.equilibrium import equilibrium_report
from .models.mpnn import MPNNPolicyNet, MPNNValueNetSimple
from .models.transformer.agent import (
    TransformerRoutePolicy,
    TransformerValueNet,
    network_positional_encoding,
)
from .parallel.mesh import make_mesh
from .parallel.shard import BatchedPPO
from .rl.checkpoint import latest_checkpoint, restore_checkpoint
from .rl.ppo import PPO
from .rl.trainer import ppo_train
from .routing.policies import random_choice
from .simulator import TransportationSimulator, make_policy

# Host elements of the dense per-tick road-optimality series (ticks x
# roads, ~800 MB of float32) past which it is kept in the sparse store;
# and device elements of a fused chunk's [chunk, R] log (200 MB), which
# cap the chunk.
PER_TICK_BUDGET = 2 * 10 ** 8
PER_TICK_DEV_BUDGET = 5 * 10 ** 7
# The transformer's positional encoding width.
PE_DIM = 16
# The equilibrium comparison solves an all-pairs assignment an iteration;
# past this many dual nodes the summary skips it.
MAX_REPORT_NODES = 4096

_CLASSICAL = ("dijkstra", "random", "so")
_LEARNED = ("mpnn", "mpnn+ppo", "transformer", "transformer+ppo")


@dataclasses.dataclass
class RunnerArgs:
    """The command line's arguments."""

    algo: str = "dijkstra"            # dijkstra | random | so | mpnn |
                                      # mpnn+ppo | transformer | transformer+ppo
    scenario: str = "Easy"
    mode: str = "eval"                # eval | train
    timestep_size: int = 1
    start_end_time: tuple = (0, 86400)
    epochs: int = 1
    rollout_steps: int = 32
    iterations: int = 10              # PPO iterations
    seed: int = 0
    device: str = "cuda"              # cuda | cpu
    output_dir: str = "runs"
    profile: bool = False
    exec_mode: str = "fused"          # fused | eager
    checkpoint: str = ""              # parameters to evaluate
    num_envs: int = 1
    reward_mode: str = "progress"
    distance_prior: bool = True
    gamma: float = 0.98
    entropy_coef: float = 0.003
    extra_obs: bool = False
    data_root: str = "data"
    save_root: str = "save"


class Runner:
    """Sets up a scenario and a policy, trains, evaluates and reports."""

    def __init__(self, args: RunnerArgs):
        self.args = args
        self.key = prng_key(args.seed)
        self.device = resolve_device(args.device)

    def _generator(self) -> torch.Generator:
        """The CPU generator the initial parameters are drawn from."""
        return torch.Generator().manual_seed(self.args.seed)

    # ------------------------------------------------------------------
    def setup(self) -> None:
        a = self.args
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("--device cuda: no CUDA device is available "
                               "(pass --device cpu to run on the CPU)")
        if a.algo not in _CLASSICAL + _LEARNED:
            raise ValueError(f"Unknown algorithm {a.algo!r}")
        # The per-tick road-optimality series: dense rows while ticks x
        # roads fits PER_TICK_BUDGET, else the sparse store; the fused
        # chunk is capped so that its [chunk, R] log fits
        # PER_TICK_DEV_BUDGET.
        n_ticks = ((a.start_end_time[1] - a.start_end_time[0])
                   // a.timestep_size)
        num_roads = load_or_build_network(a.scenario, a.data_root,
                                          a.save_root,
                                          self.device).num_roads
        per_tick_dense = n_ticks * num_roads <= PER_TICK_BUDGET
        if not per_tick_dense:
            print(f"{n_ticks} ticks x {num_roads} roads exceeds the "
                  f"{PER_TICK_BUDGET:.0e}-element dense per-tick budget: "
                  "road optimality kept at per-tick resolution in the "
                  "sparse store")
        self.sim = TransportationSimulator(
            sim=SimConfig(timestep=a.timestep_size,
                          start_time=a.start_end_time[0],
                          end_time=a.start_end_time[1], seed=a.seed,
                          record_road_optimality=True),
            data_root=a.data_root, save_root=a.save_root,
            device=self.device)
        if not per_tick_dense:
            self.sim.road_optimality_store = "sparse"
        self.episode_chunk = max(
            64, min(4096, PER_TICK_DEV_BUDGET // max(num_roads, 1)))
        self.sim.load_network(a.scenario)
        self.sim.load_population(a.scenario)

        if a.algo in _CLASSICAL:
            self.sim.set_policy(make_policy(a.algo,
                                            network=self.sim.network))
        else:
            net = self.sim.network
            self.rl_cfg = RLConfig(
                rollout_steps=a.rollout_steps,
                num_epochs=a.epochs,
                episode_start=a.start_end_time[0] or RLConfig.episode_start,
                reward_mode=a.reward_mode,
                gamma=a.gamma,
                gae_lambda=0.9 if a.reward_mode == "progress" else 0.95,
                minibatch_size=min(128, a.rollout_steps),
                entropy_coef=a.entropy_coef,
                extra_obs=a.extra_obs,
            )
            context_dim = 19 if a.extra_obs else 16
            transformer = a.algo.startswith("transformer")
            if transformer:
                pe = network_positional_encoding(net, PE_DIM)
                self.policy_net = TransformerRoutePolicy(
                    pe=pe, context_dim=context_dim)
                self.value_net = TransformerValueNet(
                    pe=pe, context_dim=context_dim)
            else:
                self.policy_net = MPNNPolicyNet(
                    num_nodes=net.num_nodes,
                    num_node_embeddings=net.num_roads + 1,
                    use_distance_prior=a.distance_prior,
                    prior_scale=30.0,
                    context_dim=context_dim,
                )
                self.value_net = MPNNValueNetSimple(net.num_nodes)
            self.ppo = PPO(net, self.policy_net, self.value_net,
                           rl=self.rl_cfg, sim_cfg=self.sim.sim,
                           value_uses_graph=transformer)
            self.trainer = self.ppo
            if a.num_envs > 1:
                self.trainer = BatchedPPO(
                    self.ppo, make_mesh(1, sp=1, device=self.device),
                    num_envs=a.num_envs)
            self.sim.set_policy(Policy(choice=random_choice))
        self.sim.config_parameters(timestep_size=a.timestep_size,
                                   start_time=a.start_end_time[0])

    # ------------------------------------------------------------------
    def train(self):
        a = self.args
        if not a.algo.endswith("+ppo") or a.mode != "train":
            raise RuntimeError("Training needs --algo mpnn+ppo or "
                               "transformer+ppo and --mode train")
        out = Path(a.output_dir)
        out.mkdir(parents=True, exist_ok=True)
        self.train_state = ppo_train(
            self.trainer, self.sim.state, num_iterations=a.iterations,
            key=self.key, generator=self._generator(), rl=self.rl_cfg,
            log_dir=str(out), checkpoint_dir=str(out / "checkpoints"),
            eval_interval=1)
        return self.train_state

    # ------------------------------------------------------------------
    def _restore(self, path: str) -> dict:
        """Policy and value parameters from ``path``: an ``.npz`` of the
        algorithm's parameters (a transformer's with the encoding it holds
        under ``pe``, where it holds one), a checkpoint file, or a
        directory of them (the latest)."""
        if path.endswith(".npz"):
            tree = load_params_npz(path)
            if self.args.algo.startswith("transformer") and "pe" in tree:
                self._set_encoding(tree["pe"])
            return mpnn_params_from_numpy(tree, self.device)
        if os.path.isdir(path):
            found = latest_checkpoint(path)
            if found is None:
                raise FileNotFoundError(f"no ckpt_<iter> under {path}")
            path = found
        return restore_checkpoint(path, self.device)["params"]

    def _set_encoding(self, pe) -> None:
        """Both transformer nets take the encoding ``pe``."""
        pe = torch.as_tensor(pe, dtype=torch.float32, device=self.device)
        if tuple(pe.shape) != tuple(self.policy_net.pe.shape):
            raise ValueError(f"encoding of shape {tuple(pe.shape)}, the "
                             f"network takes {tuple(self.policy_net.pe.shape)}")
        for m in (self.policy_net, self.value_net):
            m.pe = pe

    def eval(self):
        a = self.args
        n_timesteps = ((a.start_end_time[1] - a.start_end_time[0])
                       // a.timestep_size)
        if a.algo in _CLASSICAL:
            run_episode(
                self.sim, steps=n_timesteps, mode=a.exec_mode,
                chunk=self.episode_chunk, profile=a.profile,
                profile_output=(Path(a.output_dir) / "profile.txt"
                                if a.profile else None))
            return self._summary(self.sim)
        if getattr(self, "train_state", None) is not None:
            params = self.train_state.params
        elif a.checkpoint:
            params = self._restore(a.checkpoint)
            print(f"Loaded policy parameters from {a.checkpoint}")
        else:
            params = self.ppo.init(self.sim.state, self.key,
                                   self._generator()).params
        self.eval_params = params
        env, _, _, logs = self.ppo.eval_rollout(params, self.sim.state,
                                                self.key, n_timesteps)
        # The metric suite reads the rollout's final state; the leg
        # histogram is rebuilt from its logs.
        self.sim.state = env.sim
        cols = torch.stack([logs[k].to(self.device, torch.float64)
                            for k in ("arrivals", "on_network", "time")])
        arrivals, on_net, times = cols.cpu().numpy()
        prev_on = [0.0] + list(on_net[:-1])
        self.sim.leg_histogram_values = [
            [float(on_net[i] - prev_on[i] + arrivals[i]), float(arrivals[i]),
             float(on_net[i]), float(times[i])]
            for i in range(len(times))]
        return self._summary(self.sim)

    # ------------------------------------------------------------------
    def _summary(self, sim: TransportationSimulator):
        """Print the averages and timers, write the reports under
        ``--output-dir``, and, up to :data:`MAX_REPORT_NODES` dual nodes,
        the MSA comparison and ``equilibrium_report.json``.  Returns the
        report (None where skipped)."""
        out = self.args.output_dir
        t = sim.timers
        print("\n=== Simulation Summary ===")
        print(f"{'Average travel time:':25} "
              f"{sim.average_travel_time():10.2f} s")
        print(f"{'Agent Insertion time:':25} {t.inserting_time:10.2f} s")
        print(f"{'Route Choice time:':25} {t.choice_time:10.2f} s")
        print(f"{'Core Model time:':25} {t.core_time:10.2f} s")
        print(f"{'Agent Withdrawal time:':25} {t.withdraw_time:10.2f} s")
        print("-" * 42)
        print(f"{'Total simulation time:':25} {t.total:10.2f} s")

        print("\n=== Computing Metrics... ===")
        self.undrawn = []

        def draw(figure, fn, *args):
            try:
                fn(*args)
            except reporting.PlottingUnavailable:
                self.undrawn.append(figure)

        draw(reporting.COMPUTATION_TIME_PNG, sim.plot_computation_time, out)
        sim.compute_node_metrics(out)
        draw(reporting.LEG_HISTOGRAM_PNG, sim.plot_leg_histogram, out)
        draw(reporting.ROAD_OPTIMALITY_PNG, sim.plot_road_optimality, out)
        report = None
        if sim.network.num_nodes > MAX_REPORT_NODES:
            print("(skipping MSA comparison / equilibrium report: "
                  f"{sim.network.num_nodes} nodes > {MAX_REPORT_NODES})")
        else:
            expected = run_msa(sim.network, sim.state.agents)
            draw(reporting.DAILY_COUNTS_PNG, sim.plot_daily_counts,
                 expected, out)
            report = equilibrium_report(sim.state.agents, sim.state.road,
                                        sim.network, sim.state.time)
            print("\n=== Equilibrium Report (TSTT / Nash gap / PoA) ===")
            for k, v in report.items():
                print(f"{k:25} {v:12.4f}" if isinstance(v, float)
                      else f"{k:25} {v}")
            os.makedirs(out, exist_ok=True)
            with open(os.path.join(out, "equilibrium_report.json"),
                      "w") as f:
                json.dump(report, f, indent=2)
        if self.undrawn:
            print(f"did not draw {', '.join(self.undrawn)}: "
                  f"{reporting.MATPLOTLIB_MISSING}")
        return report


def build_parser():
    """The command line's ``argparse`` parser (the reference CLI's flags,
    ``--device`` choosing the device)."""
    import argparse

    parser = argparse.ArgumentParser(
        description="Unified runner for classical and RL traffic-assignment "
                    "experiments (PyTorch, one CUDA device)")
    parser.add_argument("--algo", choices=list(_CLASSICAL + _LEARNED),
                        default="dijkstra")
    parser.add_argument("--scenario", type=str, default="Easy",
                        help="Scenario directory under data/ (builtin "
                             "generators: TwoLink, Braess, Easy, Grid4x4, "
                             "Grid8x8)")
    parser.add_argument("--mode", choices=["eval", "train"], default="eval")
    parser.add_argument("--timestep_size", type=int, default=1)
    parser.add_argument("--start-end-time", type=int, nargs=2,
                        default=[0, 86400])
    parser.add_argument("--epochs", type=int, default=1)
    parser.add_argument("--rollout-steps", type=int, default=32)
    parser.add_argument("--iterations", type=int, default=10,
                        help="PPO training iterations")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="cuda (the card, the default) or cpu")
    parser.add_argument("--output-dir", type=str, default="runs")
    parser.add_argument("--profile", action="store_true")
    parser.add_argument("--exec", dest="exec_mode",
                        choices=["fused", "eager"], default="fused",
                        help="fused = the episode in refresh-aligned chunks; "
                             "eager = one tick at a time with phase timers")
    parser.add_argument("--checkpoint", type=str, default="",
                        help="Parameters to evaluate: a checkpoint written "
                             "by --mode train (a ckpt_<iter> file or its "
                             "directory) or an .npz of the algorithm's "
                             "parameters")
    parser.add_argument("--num-envs", type=int, default=1,
                        help="PPO environment replicas (BatchedPPO above "
                             "1, every replica on the --device)")
    parser.add_argument("--reward-mode", default="progress",
                        choices=["progress", "on_network", "individual",
                                 "throughput", "system"],
                        help="'progress' (default) = potential-based "
                             "shaping; 'on_network' = the live reward")
    parser.add_argument("--no-distance-prior", dest="distance_prior",
                        action="store_false",
                        help="Disable the shortest-path logit prior")
    parser.add_argument("--gamma", type=float, default=0.98)
    parser.add_argument("--entropy-coef", type=float, default=0.003,
                        help="PPO entropy bonus (0.03 = the equilibrium-"
                             "mixing recipe)")
    parser.add_argument("--extra-obs", action="store_true",
                        help="Append congestion-aware context columns (V/C, "
                             "congested delay, pending demand) to the "
                             "policy/value observation")
    return parser


def main(argv=None) -> Runner:
    """Parse ``argv``, set up, train (``--mode train``), evaluate; returns
    the :class:`Runner`."""
    args = build_parser().parse_args(argv)
    runner = Runner(RunnerArgs(
        algo=args.algo,
        scenario=args.scenario,
        mode=args.mode,
        timestep_size=args.timestep_size,
        start_end_time=tuple(args.start_end_time),
        epochs=args.epochs,
        rollout_steps=args.rollout_steps,
        iterations=args.iterations,
        seed=args.seed,
        device=args.device,
        output_dir=args.output_dir,
        profile=args.profile,
        exec_mode=args.exec_mode,
        checkpoint=args.checkpoint,
        num_envs=args.num_envs,
        reward_mode=args.reward_mode,
        distance_prior=args.distance_prior,
        gamma=args.gamma,
        entropy_coef=args.entropy_coef,
        extra_obs=args.extra_obs,
    ))
    runner.setup()
    if args.mode == "train":
        runner.train()
    runner.eval()
    return runner


if __name__ == "__main__":
    main()
