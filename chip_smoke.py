#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in the order they run (any failure raises and exits nonzero;
nothing is caught).  Every kernel's launch count is set to 0 just before
the path that uses it runs and read just after; comparisons of a kernel
with its plain version run outside those windows.  Phases 22, 23, 24a, 25
and 26 and 24b's report, which feed later phases only numbers, run in two
spawned processes (22, 23 and 26; 24a, 25 and the report) started after
phase 21, beside phases 24b-c and 27 in this one (their times are taken
with each other running); this process joins them before phase 28,
within ``SIDE_TIMEOUT`` seconds.  Every log line starts with the seconds
since the run began.

1. Card: name and power limit (``nvidia-smi``), torch and CUDA versions;
   build the CUDA kernels from ``tarl_tpu_torch/csrc`` (``fused_winner``,
   ``primal_relax``, ``segment``, ``fused_core`` and ``choice``, one nvcc
   each, started together),
   time the builds, and print each kernel's registers and spills
   (``nvcc -Xptxas -v``, run beside the builds).
2. The headline episode: Grid16x16, 50,000 agents departing over 06:00-08:00,
   7,200 ticks of 1 s in bitwise-exact mode (per-SRC backlog insert Q=256,
   W=32, withdraw depth 2, both escalations, random route choice).  Asserts
   a zero overflow monitor, conservation, arrivals, one K1 launch per
   tick (the kernel draws the tick's noise from its key: one launch and a
   memset) and one launch of the random choice's kernel per tick
   (``csrc/choice.cu``); prints agent-steps/s measured after a 64-tick
   warm-up.
3. K1 against plain: the fused-winner kernel must equal its plain PyTorch
   version bitwise on all five outputs, with the clock on the host and on
   the device, on road states captured every 600 ticks of phase 2 and on
   20 seeded random states of a Grid64x64 network, each with a fresh key;
   both timed per call with CUDA events, plain, kernel, kernel, plain, and
   the kernel's device time per call read from ``torch.profiler`` over as
   many calls, beside its bound on the timed input.
4. The episode in context: the first 600 ticks again with the plain K1,
   from the same key; the state must equal phase 2's at tick 600 bitwise.
5. The shortest-path row (``bench.py``'s second row) on the port:
   Grid64x64, 200,000 agents departing over 06:00-08:00, departure-sorted,
   ``make_policy("dijkstra", RoutingConfig(refresh_rate=10,
   max_bf_iters=8, backend="primal"))``, windowed insert W=1024, withdraw
   depth 2, no escalation, 1,020 ticks of ``run_episode_periodic`` timed
   after two warm-up periods.  Asserts conservation, arrivals, a finite
   table with a road for every pair, the relax kernel (K2) on each of the
   102 refreshes (the initial table's next-road pass counted apart) and
   K1 on every tick and no launch of the random choice's kernel; prints
   agent-steps/s, ms/tick, ms per refresh (CUDA
   events), the saturation monitor and host reads per tick.
6. K2 against plain, bitwise on distances and next roads: K2 mode (8
   sweeps + next road) on the refresh inputs captured at every 20th
   refresh of phase 5, on 5 seeded random-cost Grid64x64 warm starts and
   on one tie-heavy cold start; relax-only at 8 sweeps (K4's function)
   and at 1 (K6's); 13 and 4 destination columns of two of those warm
   starts (a column tail, and the zoned parts' D below the tile width) in
   K2 mode, relax only and uncapped; uncapped from the cold start on
   Grid16x16 (the device path of ``primal_table_init``), asserting that
   it makes no host read.  Past 4,096 rows the cluster form (K3's and
   K5's function), asserted by ``launch_cluster_plan``, in K2 mode, relax
   only and uncapped: Grid128x128 with 512 seeded destination columns
   (clusters of 4; the size at which the TPU needed the row-blocked
   K3/K5), Grid256x256 (65,536 intersections, built from
   ``grid_scenario``'s link arrays, kept for phase 15) with 16 columns at
   8 sweeps (clusters of 16), and a 50 x 100 grid whose 5,000
   intersections are relabelled by a seeded permutation (2 blocks; most
   successors lie in the other block), with tails of 13 and 3 columns in
   the width the card's capacity gives and at the full width of 7
   (masked tails).  The global form (one persistent launch, K6's
   kernel) forced past 4,096 rows: Grid128x128 with 512 columns in
   those three modes, Grid256x256 in K2 mode.  The next-road kernel
   (``primal_next_roads``) against the plain pass on phase 5's initial
   table, which it made there.  Times each TPU kernel's mode, plain, kernel,
   kernel, plain, with the device time per call from ``torch.profiler``,
   beside its bound: K2 mode, relax only (K4) and one sweep (K6) at
   Grid64x64, K2 mode at Grid256x256; and K2 mode (K3) and relax only (K5)
   at Grid128x128 with 512 columns in the cluster form and the global form
   (forced), plain, kernel, global, global, kernel, plain.  (Phase 22
   holds the cluster form on its own refresh inputs and times it at the
   million row's shape.)
7. The row in context: the first 200 ticks of phase 5 again with the plain
   relax; the state at tick 200 must equal the kernel run's bitwise, and
   K2 must not run.  Prints ms/tick over ticks 20-200 of both runs.
8. The learned policy, trained weights: the builtin Grid8x8 scenario (5,000
   commuters) with the recorded run's best parameters
   (``tarl_tpu_torch/weights/grid8x8_mpnn_best.npz``, carried by
   ``convert.mpnn_params_from_numpy``) and ``scripts/train_rl_demo.py``'s
   settings (progress reward, gamma 0.98, distance prior at scale 30,
   pending entrants observed); the greedy ``PPO.eval_rollout`` for 3,000
   steps, a quarter of the recorded run's 12,000 (cut to keep the script's
   time under its limit).  Asserts conservation, at least 1,500 of the
   5,000 done (1,789 arrive by then on the CPU; all 5,000 by 12,000 steps),
   an average travel time below 90 s, and one K1 and one K11 launch per step
   (K11's action entry: the
   mode's scaled argmax and multi-hot action in one kernel); prints
   ms/step, steps/s, agent rows x steps / s and host reads per step.
9. Rollout collection: 256 sampled steps of ``PPO.collect_rollout`` on the
   same scenario; asserts finite log-probs and values and the launches the
   step's calls imply (per step: K1 once, K11's action entry once, its
   Gumbel noise drawn inside, K10's log-prob entry once, K9 never).
10. Scale: the Grid16x16 scenario of phase 2 with weights drawn by
   ``PPO.init`` from a seed; greedy evaluation for 500 steps, with the
   asserts of phase 8 on conservation and launches.
11. Segment kernels (K9-K11) against plain, bitwise: on the inputs
   captured in phases 8-10 (Grid8x8 and Grid16x16 shapes; the bare
   argmax on the scores the action inputs give: scaled logits, and those
   plus a fresh key's noise; the bare max and sums on the inputs the
   parent's log-prob gave them, from the log-prob inputs captured in
   phase 9: the scaled logits, the shifted exponentials, the action and
   ones) and on seeded random cases with empty
   segments, +-inf, NaN, out-of-range ids, exact ties, 100,000 segments
   and ties of -0.0 with +0.0; each against the plain version on a CPU
   copy of the inputs (the plain sum on the card adds with atomics) and,
   for max and argmax, on the card (not for the +-0 ties, which the
   card's plain max resolves in its atomics' order).  K11's action entry
   against ``segment_action_plain`` on the card and on a CPU copy,
   bitwise, on the action inputs captured in phases 8-10 in both modes (a
   fresh key each) and on seeded random cases with temperatures other
   than 1, +-inf, NaN, empty segments, out-of-range ids and ties.  Times
   each at the Grid8x8 shape, plain, kernel, kernel, plain, beside the
   library call (``index_add_`` for the sum, ``scatter_reduce(...,
   "amax")`` for the max; none for the argmax), and the action entry in
   both modes against the parent's composed path (``PLAIN.action`` on the
   card: the division, the draw, the argmax, the zero fill and the
   scatter), with the device time and kernels per call of each from
   ``torch.profiler``.  K10's log-prob entry, with an action
   (``segment_log_prob``) and as the log-softmax (``segment_log_probs``),
   on the log-prob inputs captured in phase 9 and on seeded cases
   (temperatures 0.25-1.3, +-inf, a segment of only -inf, NaN, empty
   segments, ties; valid actions, two hot in a segment, none hot, one
   segment missing, a zero-probability element active; 100,000
   segments): bitwise against the parent's composition run with the bare
   kernels (``segment_log_prob_plain(..., ops=KERNELS)``: K10, then K9 on
   the exponentials, adding in element order as the entry does), and
   against the plain versions (``PLAIN``) on the card and on a CPU copy
   at rtol 1e-6, atol 1e-6 (the log-softmax) and rtol 1e-5, atol 1e-5
   (the joint log-prob: ``index_add_`` on the card adds with atomics,
   ``exp``/``log`` may round an ulp apart between libms, the CPU sums in
   another order), printing the largest absolute difference.  Times the
   entry and the parent's whole ``log_prob`` (the composition with K9 and
   K10), plain, kernel, kernel, plain, and the plain versions, with the
   device time and kernels per call of each, beside the entry's bound;
   likewise the log-softmax form.
12. The learned path in context: the first 200 steps of phase 8 again, once
   with the kernels and once with the plain segment versions forced
   (``segment_ops=PLAIN``); the final states must be equal bitwise and
   K9-K11 must not run in the plain one.  Then 200 collection steps three
   times: with the kernels (K10's entry once a step, K9 never), with the
   parent's composition on the bare kernels, and with ``PLAIN`` (no
   segment kernel): actions, rewards, values and the final environment
   states equal bitwise in all three, log-probs bitwise between the first
   two and within rtol 1e-5, atol 1e-5 of the plain run's.
13. The fused-core headline: phase 2's episode's first 1,800 ticks (half
   its depth, cut to keep the script's time under its limit)
   with ``SimConfig(fused_core=True)``: the eligibility, the logits and the
   per-downstream Gumbel-max over the turn edges in one launch (K12's
   fused entry, ``fused_core_sample``, noise drawn in the kernel) in place
   of K1.  Asserts a zero overflow monitor, conservation, arrivals, one
   K12 and one random-choice launch per tick and no K1; prints agent-steps/s after the warm-up
   and the average travel time beside phase 2's (the same law, another
   random stream).  Keeps K12's inputs (road state, selections, clock,
   key) every 600 ticks.
14. The fused core in context: the first 600 ticks of phase 13 again with
   the plain edge phase from the same key; the state at tick 600 must
   equal phase 13's bitwise, and K12 must not launch.
15. K1 at the size of the TPU's column-tiled winner (K8a/K8b): a Grid256x256
   network (R = 261,120) built from ``grid_scenario``'s link arrays with no
   population; K1 against plain, bitwise on all five outputs, on 3 seeded
   random road states, each with a fresh key and both clock forms; both
   timed, plain, kernel, kernel, plain.
16. K12 against plain, bitwise on both payloads.  The fused entry: on
   the states kept in phase 13, on phase 3's 20 random Grid64x64 states
   and on 4 random states of a 40-spoke hub (40 incoming turn edges a
   road: the lanes past 32), each with a fresh key.  The bare entry
   (``gumbel_argmax_payload``, logits in: the TPU kernel's function): on
   the logits of phase 13's states and on seeded random cases (the
   Grid64x64 and Grid256x256 edge lists, E = 63,752 and 1,041,416; random
   ids over 40,000 segments with a third of them empty; -inf logits and
   exact ties in each).  Both timed, plain, kernel, kernel, plain, with
   the device time per call from ``torch.profiler``: the fused entry at
   the headline shape and at Grid64x64, the bare one at the headline
   shape and at Grid256x256.
17. The sharded headline: the first 1,200 ticks of phase 2's episode
   through ``run_episode_shard_map`` on ``make_road_mesh(4)`` (four road
   blocks of 240 roads on the card, no padding; a sixth of the headline's
   depth, to leave the script's time to phases 22 and 27).  Asserts
   bitwise equality with
   phase 2's state at tick 1,200 and the integer-valued fields of its
   tick logs to there,
   ``road_delta_tt`` bitwise or within the reference's ``rtol=1e-5,
   atol=1e-3`` (printing which held), a zero overflow monitor,
   conservation, one K7 launch per tick and no K1, the random choice's
   kernel once a tick (on the whole network, with the halo's roads);
   prints agent-steps/s
   after the warm-up, ms/tick beside phase 2's and host reads per tick.
   Keeps K7's inputs every 600 ticks.
18. The padded mesh: the first 600 ticks of the same episode on
   ``make_road_mesh(7)`` (966 rows, six of them inert); the state must
   equal phase 2's at tick 600 bitwise.
19. K7 against plain, bitwise on all four outputs, for the whole device's
   launch and for its last block alone: on the inputs kept in phases 17
   and 18, on phase 3's 20 random Grid64x64 states and on phase 15's 3
   Grid256x256 states, each over 4 blocks, and on 4 random states of the
   40-spoke hub over 3 padded blocks, each with a fresh key (K7 draws its
   noise inside).  Timed at the headline shape and at Grid256x256,
   plain, kernel, kernel, plain, with the device time per call from
   ``torch.profiler``, beside the bound.
20. The sharded shortest-path row: the first 200 ticks of phase 5 on
   ``make_road_mesh(4)`` (4,032 roads a block); the state at tick 200 must
   equal phase 5's bitwise, with K2 once per refresh (not per block), K7
   once per tick and no K1; prints ms/tick beside phase 5's.
21. Training: ``rl.trainer.ppo_train`` for 3 iterations on phase 8's
   scenario at the recorded Grid8x8 run's configuration (``learned_ppo``:
   256 collection steps, 5 epochs of 2 minibatches of 128, entropy 0.003,
   learning rate 1e-3), from the committed weights (restored from a
   ``ckpt_0`` written beside them), a checkpoint every iteration, under
   ``torch.use_deterministic_algorithms(True)``.  Prints per iteration the
   ten ``IterationMetrics``, the collection, GAE and update in ms (CUDA
   events at their boundaries), the launches per collection step and in
   GAE and the update, and the host reads.  Asserts finite metrics,
   ``approx_kl`` >= 0, 10 updates an iteration, one K1, K11 and K10 launch
   per collection step (768 each) and none of K9 and none in GAE or the
   update.  Runs the first iteration again with ``PLAIN`` in the
   collection: actions, rewards, dones and values bitwise equal, log-probs
   within rtol 1e-5, atol 1e-5, the parameters after the 10 updates within
   twice the learning rate times the updates (Adam's reach: an element
   whose gradient is rounding noise steps by up to the rate either way),
   printed with the shares within 1e-5, 1e-4 and 1e-3.  Resumes from
   ``ckpt_2`` by ``ppo_train``: the parameters, Adam's state and the key
   after iteration 3 bitwise equal to the uninterrupted run's.
22. The million-agent row (``scripts/bench_million.py`` at full width):
   Grid128x128 (65,024 roads, 16,384 intersections) and 1,000,000
   commuters departing 06:00-09:00 to 256 zones, generated and parsed by
   the port (seconds printed), the successors' spread in the
   intersection order printed.  Its sp row: zoned tables over
   ``unique(_dest_inter(net, agents.dest))`` (D printed),
   ``RoutingConfig(refresh_rate=10, max_bf_iters=8, backend="primal")``,
   windowed insert W=4,096, withdraw depth 2, 1,020 ticks of
   ``run_episode_periodic`` timed from tick 20.  Asserts conservation
   (queued equals on the way; done plus on the way at most the
   commuters), arrivals, a finite table with a road for every pair, one
   relax call a refresh (102), every one and the uncapped table init in
   the cluster form, the table init (the relax and its next roads) in
   one launch with no host read, no global-form call, and K1 once a
   tick; prints agent-steps/s, ms/tick, ms per refresh and the
   relax call's ms in it (CUDA events), host reads per tick.  The row in
   context: its first 200 ticks again with the plain relax, the state at
   tick 200 bitwise the kernel run's, no relax kernel launched.  The
   cluster form against plain, bitwise, on the refresh inputs captured at
   every 20th refresh (8 sweeps with and without next roads, uncapped)
   and from the row's cold start (uncapped, no host read); the table
   init's table against the plain relax from the cold start, and the
   next-road kernel against the plain pass on it; K3 and K5
   mode timed there, plain, kernel, global, global, kernel, plain, with
   device times, beside the bound.  Its exact_random row: backlog insert
   Q=256, W=64, both escalations, random choice, 1,020 ticks timed the
   same way; asserts a zero overflow monitor, conservation and K1 and
   the random choice's kernel once a tick, prints the backlog's MB.  The
   random choice's kernel (``csrc/choice.cu``) against
   ``random_choice_plain`` on the row's states captured every 200 ticks,
   each with its own key and ``CHOICE_KEYS`` (words at and near 2**32 -
   1): the selection and the key written back bitwise, one launch a
   call; both timed on the middle state, plain, kernel, kernel, plain,
   with each one's device time and device activities a call by kind
   (kernels, memsets, copies), beside the kernel's bound by bytes.
23. The radial metro (``scripts/bench_radial.py`` at full width, the
   reference's non-grid row): 64 rings of 128 spokes around a centre of 8
   spurs (32,528 roads, 8,193 intersections of K = 8 out-slots) and
   200,000 commuters departing 06:00-08:00, every trip to the CBD (the
   centre and the first ring), generated and parsed by the port (seconds,
   rows by out-degree, the successors' spread and the global kernel's
   compact slots a row printed).  Its bounded row: zoned tables over
   ``unique(_dest_inter(net, agents.dest))`` (D printed), ``RoutingConfig(
   refresh_rate=10, max_bf_iters=8, backend="primal")``, windowed insert
   W=1,024, withdraw depth 2, no escalation, 1,020 ticks of
   ``run_episode_periodic`` timed from tick 20.  Both plans decline 8
   slots a row, so every relax runs the global form: asserts
   conservation, arrivals, a finite table with a road for every pair, 102
   relax calls, every one and the uncapped table init in the global form,
   one launch each (the profiler's device activities per refresh call),
   the table init with no host read, no resident or cluster launch, and
   K1 once a tick; prints agent-steps/s, ms/tick, ms per refresh, the
   relax call's ms in it (CUDA events) and host reads per tick.  The row
   in context: its first 200 ticks again with the plain relax, the state
   at tick 200 bitwise the kernel run's, no relax kernel launched.  The
   global form against plain, bitwise on distances and next roads: on the
   refresh inputs captured at every 20th refresh (8 sweeps with and
   without next roads, 1 sweep, uncapped), from the cold start (uncapped,
   with no host read), the table init's table and the next-road kernel on
   it, and a table whose padding is scattered (rows' slots in a seeded
   order, padding on three seeded roads, -BIG in the warm start so that
   every padding term counts).  Times the refresh's relax plain, kernel,
   kernel, plain, with its device time, beside its bound, and the
   uncapped table init.  Its exact row: both escalations, 510 ticks (cut
   from 1,020 for the script's time) timed the same way; asserts
   conservation, the launches and exactness: the state at tick 510
   bitwise that of a whole-population insert
   (with escalation the windowed insert's monitor counts its extra
   passes, printed).
24. The CLI's default evaluation (``python main.py`` runs dijkstra on
   Easy): (a) the classical rows ``CLASSICAL_ROWS`` (Easy dijkstra, 3,600
   ticks of 2 s from 06:00; Braess dijkstra and random, 3,000 ticks of
   1 s; Bottleneck dijkstra, 2,000 ticks: every agent has arrived by then,
   and the reference's numbers equal those at 9,000 and 4,000) each
   through a
   ``TransportationSimulator`` built from the port's caches under
   ``build/``, ``make_policy(algo, network=...)`` (the dual backend) and
   ``algorithms.episode.run_episode(mode="fused")``, then ``nash_gap``,
   ``tstt`` and ``equilibrium_report``.  Asserts conservation, the
   reference's done count, one K1 launch a tick, a refresh every 10 ticks
   under dijkstra, the average travel time within 0.5% and the relative
   gap within 10% or 0.005 of the reference's exact numbers
   (``CLASSICAL_REFERENCE``, from the reference on the CPU), and Braess's
   random row ranked worse than dijkstra; prints ms/tick, host reads per
   tick, refreshes and the report's seconds.  Braess's first 200 ticks
   again through the facade's eager ``run()``, with K1 and with its plain
   version: both bitwise the fused run's state; prints the phase timers.
   (b) The dual row: phase 2's scenario under ``make_policy("dijkstra")``
   with the default routing (N = 1,472 dual nodes, a refresh every 10
   ticks, uncapped), phase 5's windowed insert, 1,800 ticks of
   ``run_episode_periodic`` timed after two warm-up periods.  Asserts
   conservation, arrivals, one K1 launch a tick, no relax kernel, and a
   table with the node itself on its diagonal and a next hop from every
   road and SRC node toward every DEST node; prints agent-steps/s,
   ms/tick, ms per refresh (CUDA events), sweeps and host reads per
   refresh, host reads per tick and the table's bytes; the equilibrium
   report on the final state, timed (in the second spawned process, on
   the state this one writes).  Its first 600 ticks again with the
   plain K1 (bitwise, no K1 launch), and its first 1,200 under
   ``RoutingConfig(backend="primal")`` (uncapped: K2's resident form once
   a refresh): the same episode bitwise (the routing scratch and the
   selections aside).  (c) One free-flow ``all_pairs_next_hop_nbr`` on
   Grid36x36 (N = 7,632, the largest network on which "auto" picks the
   dual backend): ms (CUDA events), device ms (``torch.profiler``),
   sweeps, host reads, peak memory and the bound from the bytes each
   sweep moves.
25. The CLI, ``tarl_tpu_torch.runner.main(argv)`` in the spawned process
   on the card, from ``build/cli25`` (its ``data/``, ``save/`` and
   outputs).  (a)
   The README's evaluation, ``--algo dijkstra --scenario Easy --mode eval
   --start-end-time 21600 28800 --timestep_size 2``: its average travel
   time, done count and ``equilibrium_report.json`` must equal phase 24a's
   Easy row (the same configuration through the same facade; the report's
   floats within rtol 1e-5, printed whether bitwise), ``node_metrics.csv``
   and ``daily_counts.csv`` written, the four PNGs where matplotlib imports
   (printed whether it does) and none where it does not, and K1 launched
   once a tick.  (b) ``--algo mpnn+ppo --mode train --scenario Braess
   --iterations 2 --rollout-steps 32`` over 600 ticks from 06:00, then
   ``--mode eval --checkpoint`` of its checkpoint over the same window:
   the restored parameters bitwise the trained ones, the evaluated state
   bitwise the trained run's final evaluation's, the metrics (the
   trainer's CSV, the average travel time, the report) finite; K10 once a
   collection step, K11 and K1 once an environment step (collection, the
   trainer's greedy evaluations and the final evaluation), K9 never, and
   no plain segment version called outside the loss (which runs inside
   ``plain_segments()`` by design).
26. The irregular city (``scripts/bench_city.py`` at full size): 9,000
   target intersections, 250,000 commuters departing 06:00-08:00 to 256
   zones, seed 7, generated by ``io.city`` under ``build/scenarios``, the
   network built with the renumbering search and the population parsed,
   each timed (R, I, K, Nmax, ``renumbered`` and D printed).  The exact
   random row: backlog insert Q=8,192, W=32, withdraw depth 2, both
   escalations, 1,020 ticks timed from tick 20; asserts a zero overflow
   monitor, conservation, arrivals and K1 and the random choice's kernel
   once a tick; its first 300 ticks again with the plain K1, the state
   bitwise the kernel run's.  The random choice's kernel against its
   plain version on the row's states captured every 300 ticks, as in
   phase 22 (the renumbered city: KC = 7, ``road_order`` addressing).  The
   zoned sp row: ``RoutingConfig(refresh_rate=10, max_bf_iters=8,
   backend="primal")``, zoned tables over ``unique(_dest_inter(net,
   agents.dest))``, W=1,024, depth 2, no escalation, 1,020 ticks; K = 7
   slots a row, so every relax runs the global form (K6): asserts
   :func:`check_radial_sp`'s conditions (one global launch a refresh and
   for the table init, that with no host read, K1 once a tick, no
   random-choice launch); the relax
   against plain, bitwise, on the refresh inputs captured at every 20th
   refresh, the first included, and on the cold start (8 sweeps with and
   without next roads, 1 sweep).  Prints ms/tick, agent-steps/s, ms per refresh and host reads
   per tick.
27. The Graph Transformer policy, under
   ``torch.use_deterministic_algorithms(True)`` in (a).  (a) The committed
   Braess weights (``tarl_tpu_torch/weights/braess_transformer_best.npz``,
   with the positional encoding they carry) at
   ``scripts/train_rl_demo.py``'s settings (``GT_RL``): the first 600
   greedy steps written out as ``PPO.eval_rollout`` takes them (the
   forward timed by CUDA events), one K1 and one K11 launch a step, the
   first 300 actions equal to the reference's recorded ones and, at step
   300, the done count equal and the TSTT within 0.5% of the reference's;
   the same 600 steps with ``PLAIN`` and the plain K1: the environment at
   step 600 bitwise equal; the sampled ``PPO.eval_rollout`` of 1,800 steps
   from key 3: one K1 and one K11 launch a step, the done count equal and
   the TSTT within 0.5% of the reference's recorded ones (printed beside
   each other); the forward alone timed with and without deterministic
   algorithms, its device time and kernels a call from
   ``torch.profiler``.  (b) 256 collection steps from the same weights
   (K1, K11's sample and K10's log-prob entry once a step) and one
   ``train_iteration`` at the recorded run's settings (512 steps, 4
   epochs, minibatch 128), its collection, GAE and update in ms; the
   parameters finite and changed.  (c) ``runner.main`` with ``--algo
   transformer+ppo --mode train`` (2 iterations of 32 steps over 120
   ticks), its checkpoint evaluated (the parameters restored bitwise), and
   ``--algo transformer --mode eval --checkpoint`` of the committed weights
   over the reference's greedy window (300 ticks from 05:59): the
   encoding the file carries taken, the done count equal and the TSTT
   within 0.5% of the reference's; seconds and launches per command.  (d)
   The headline scenario in phase 2's exact mode with
   ``make_learned_choice`` of a ``TransformerRoutePolicy`` (the port's
   encoding of Grid16x16, the Braess weights), sampled, 1,020 ticks after
   the 64-tick warm-up: overflow 0, conservation, one K1 launch a tick and
   no segment kernel; agent-steps/s, ms/tick and the choice's ms/tick
   (CUDA events); on the states at ticks 400, 600 and 800 the slot twin's
   logits within atol/rtol 2e-5 of the flat forward's; the first 200 ticks
   again with the plain K1, cut into calls as the kernel run was (the
   64-tick warm-up, then 136), bitwise.
28. Batched training and the native parser.  (a) The headline's and the
   sp row's scenario files (Grid16x16 / 50,000 and Grid64x64 / 200,000)
   parsed by ``parser="python"`` and ``parser="native"``: rows, link
   arrays, intersection ids and positions bitwise equal, the seconds of
   each printed.  Every scenario phase parses with the native default
   and prints its network's and population's seconds and the parser;
   asserted: the native parser for the headline, the sp row, the million
   and the radial rows (their plans name links), the Python one for the
   city's population (its coordinate plans), as the reference's.  (b)
   ``parallel.shard.BatchedPPO`` of 4 replicas at phase 21's settings
   (256 steps each, 5 epochs of 8 minibatches of 128) from the committed
   weights, one ``train_step`` under deterministic algorithms, then the
   same step with ``PLAIN`` and the plain K1 in the collection: the ``[4,
   256]`` actions, rewards, dones and values bitwise, the log-probs
   within rtol 1e-5, the parameters within twice the learning rate times
   the 40 updates (shares printed), 1,024 launches each of K1, K11 and
   K10 and none in GAE or the update, none of the plain step; the ms of
   collection, GAE and update, and ms per replica step beside phase 21's
   single-environment ms per step.  (c) ``runner.main`` with phase 25's
   training command and ``--num-envs 4``, then its checkpoint's
   evaluation over 600 ticks: the parameters restored bitwise, the
   evaluated state the trained run's, the launches (K10 once a replica's
   collection step, K11 and K1 once an environment step), the seconds.
29. Every policy on road blocks, and blocks across processes, each on
   ``make_road_mesh(4)`` against its serial run, bitwise, with one K7
   launch a tick and no K1: (a) the trained Grid8x8 MPNN (committed
   weights, distance prior), sampled, 600 ticks of 5,000 commuters, the
   forward edge-sharded; (b) phase 27d's learned transformer on the
   headline scenario, its first 200 ticks cut as 27d's plain rerun (64,
   then 136), against that rerun; (c) phase 24b's dual row (N = 1,472),
   300 ticks, and Braess under ``strict_compat``, 300 ticks; (d) the
   headline (phase 2's exact mode) for 600 ticks in 2 spawned processes
   over gloo, 2 blocks each, and in 1 NCCL process of world size 1, all
   started together on the one card at the phase's start and running
   beside (a)-(c), whose times are taken with them running: every rank's
   state bitwise phase 2's
   at tick 600, K7 once a tick on every rank, and the last gloo rank's K7
   launches (first column 480) bitwise the plain version's on its kept
   inputs.  ms/tick beside the serial runs'; (d)'s is a protocol check,
   not a timing of work across cards.
30. Sharded and spatial PPO training, at phase 21's width (Grid8x8, 5,000
   commuters, ``learned_ppo``'s settings: 256 steps, 5 epochs of
   minibatches of 128, the committed weights, the distance prior) on 4
   blocks, each trainer against ``PPO.train_iteration`` from the same
   ``TrainState`` under deterministic algorithms.  (d)'s and (e)'s ranks
   are spawned at the phase's start and run beside (a)-(c) and (f), whose
   times are taken with them running.  Every update of every sharded
   trainer (here and on (d)'s ranks) has its gradients held against
   ``PPO._loss_and_grads`` on the same minibatch at the same parameters,
   after the timed iteration (``GradCheck``).  (a) ``ShardedPPO`` with the
   MPNN: the trajectory bitwise, every update's gradients within max |d|
   1e-5 (and the blocks' per-edge logits at the first minibatch's 128
   rows against the flat forward's, printed), the parameters within
   Adam's reach (twice the rate times the 10 updates, a sanity bound; the
   elements beyond the reference tests' rtol 1e-3, atol 5e-3 printed),
   K1, K11 and K10 once a collection step and none in the update.  (b)
   The same for the committed Braess transformer at ``GT_RL``, its
   collection cut to 128 steps (4 updates), the gradients within relative
   1e-3.  (c) One ``SpatialPPO.train_iteration``: its rollout of 256
   steps against the unsharded collection (actions, dones, clock,
   ``on_network``, contexts and values bitwise; log-probs within rtol
   1e-5; the ``progress`` rewards within rtol 1e-6 and ``progress_atol``,
   4e-6 of the largest potential over the scale, since a reward is the
   difference of two float32 potentials of ~1e4 summed in another order),
   K7 once a step and K1 none, K7's kept inputs (every eighth step, the
   last included) that move someone bitwise its plain version; every
   update's gradients within max |d| 1e-5; the iteration's environment
   bitwise but the potential, the parameters within Adam's reach.  (d)
   (a), ``SpatialPPO.rollout`` cut to 64 steps (against the first 64 of
   (c)) and phase 28b's batched step (4 replicas) in 2 gloo processes
   (``dp = 2``) and 1 NCCL process of world size 1, spawned together on
   the one card, each rank against the one-process runs.  (e)
   ``parallel.dryrun.dryrun_multichip(2, "gloo")``, its six paths on each
   rank.  (f) The legacy confirm ``core.response.response_step`` on phase
   2's captured states after the direction step's push: K10's bare max
   bitwise the plain max.  ms per iteration split into collection, GAE
   and update beside phase 21's.
31. The golden trace's path (``tests/test_torch_reference_trace.py``, which
   holds it against the upstream simulator's physics on the CPU): Braess
   under strict-compat Dijkstra (refresh every 10 ticks) from 06:00 at 1 s
   with the selections zeroed, 400 ticks of ``core.step.tick``, once with K1
   and once with its plain version: each tick's packed state
   (``schema.pack_state``) and agent rows and each refresh's table bitwise
   between the runs, 400 K1 launches in the first and none in the second.
   ``pack_state`` of phase 2's last state on the card bitwise the same state
   packed on the CPU; ``routing.bellman_ford.congested_next_hop`` on phase
   8's Grid8x8 evaluation state (mid-episode) on the card bitwise the CPU's.
32. Last: a JSON line of the kernels (``fused_winner``, ``primal_relax``,
   ``segment_sum``, ``segment_max``, ``segment_argmax``, ``fused_core``,
   ``fused_shard_winner``, and the K3-K6 and K8a/K8b rows covered by
   ``primal_relax`` and ``fused_winner``; K3's and K5's rows the cluster
   form at the million row's shape with their launches there, K6's the
   global form at the radial row's shape with its launches there (103)
   and at I = D = 4,096 for one sweep; ``device_ms`` beside ``ms`` for
   every kernel but K8a/K8b; K11's row times its action entry, the bare
   argmax beside it; K10's row its log-prob entry, the bare max beside
   it; K9's launches are 0: no main path runs the bare sum;
   ``launches_training`` beside K1's and K9-K11's launches; K1's launches
   in phase 24's rows and K2's in its primal cross-check beside them; K1's,
   K6's, K10's and K11's in phases 25 and 26 beside them, and K1's,
   K10's and K11's on phase 27's paths in ``launches_transformer`` and on
   phase 28's in ``launches_batched``, and on phase 30's in
   ``launches_ppo_blocks``; K7's on phase 29's paths in
   ``launches_blocks`` and on phase 30's in ``launches_spatial_ppo``;
   K10's bare max in phase 30f's ``bare_launches_response_step``; K1's on
   phase 31's path and in its plain run in ``launches_golden_trace`` and
   ``launches_golden_trace_plain``; and ``random_choice``, the kernel of
   ``csrc/choice.cu``, which replaces no ``pallas_call``: its launches on
   phase 2's headline, the fused-core and sharded headlines and the
   million and city exact random rows, none on the sp rows, its times at
   the million grid's shape and the city's (phases 22 and 26) and the
   device activities a call of it and of its plain version by kind),
   the card's name and power limit,
   then
   ``{"ok": true, "device": {...}}``.

Exits nonzero, printing no result, where no CUDA device is available or
the package is missing beside this script.  Scenario files are written
under ``build/scenarios``, phase 24's caches under ``build/save``, phase
21's checkpoints under ``build/train``, phase 25's files under
``build/cli25``, 27's and 28's under ``build/cli``, phases 22-26's
results under ``build/side_phases0.pkl`` and ``build/side_phases1.pkl``
(24b's report reads ``build/dual_report_state.pt``) and phase 29's and
30's ranks' results under ``build/blocks29`` and ``build/ppo30`` in the
checkout.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
KERNELS = ("fused_winner", "primal_relax", "segment", "fused_core",
           "choice")
HEADLINE_TICKS = 7200
WARMUP_TICKS = 64
CAPTURE_EVERY = 600
RANDOM_STATES = 20
TIMED_CALLS = 200
SP_TICKS = 1020
SP_WARMUP_TICKS = 20
SP_CONTEXT_TICKS = 200
SP_CAPTURE_EVERY = 20        # refreshes
SP_RANDOM_STATES = 5
RELAX_TIMED_CALLS = 20
BIG_DESTS = 512
# Phase 8's depth: a quarter of train_rl_demo.EVAL_STEPS["Grid8x8"]
# (12,000), by which 1,789 of the 5,000 commuters arrive on the CPU (3,658
# by 6,000 steps there, 3,629 on the card).
EVAL_STEPS = 3000
EVAL_MIN_DONE = 1500
COLLECT_STEPS = 256
SCALE_STEPS = 500
LEARNED_CONTEXT_STEPS = 200
CAPTURE_STEPS = 2000          # steps between captured segment inputs
PRIOR_SCALE = 30.0            # train_rl_demo.PRIOR_SCALE
TRAIN_ITERATIONS = 3
K8_STATES = 3                 # random Grid256x256 road states for K1
K8_GRID = 256                 # the TPU's tiled-winner record size
SHARD_BLOCKS = 4              # road blocks of the sharded phases
SHARD_TICKS = 1200            # the sharded headline's depth (phase 17)
FUSED_TICKS = 1800            # the fused-core headline's depth (phase 13)
TRACE_TICKS = 400             # the golden trace's depth (phase 31)
SIDE_TIMEOUT = 1000.0         # the longest wait for phases 22-26 after 27
PADDED_BLOCKS = 7             # 960 roads -> 7 blocks of 138, 6 rows inert
# Operations K7 (and K1) does for each valid in-slot: the eligibility's
# decode and compares, the score add and the running max.
K7_OPS_PER_SLOT = 20
# Operations K12's fused entry does for each turn edge: the eligibility's
# compares and subtractions, the weight's multiply and the compare.
K12_OPS_PER_EDGE = 20
HUB_SPOKES = 40               # a hub road's incoming turn edges: lanes past 32
HUB_STATES = 4
# Operations of one K12 (or K1) draw: the threefry block's 117 integer
# operations (key schedule, 20 rounds of add, rotate and xor), the xor,
# shift and scale of the uniform, and the Gumbel transform and compare,
# each log counted as one.
K12_OPS_PER_DRAW = 130
WEIGHTS = os.path.join("tarl_tpu_torch", "weights", "grid8x8_mpnn_best.npz")
# The H100 SXM data sheet's peaks (the card's own limit is printed beside).
# Phase 6's grid in a scattered order: 5,000 intersections, two blocks of
# the cluster form.
SCATTER_GRID = (50, 100)
SCATTER_SEED = 5
# scripts/bench_million.py's row (phase 22).
MILLION_GRID = 128
MILLION_AGENTS = 1_000_000
MILLION_ZONES = 256
MILLION_BACKLOG = 256         # exact_random's per-SRC queue depth
MILLION_EXACT_WINDOW = 64
# scripts/bench_radial.py's row (phase 23).
RADIAL_RINGS = 64
RADIAL_SPOKES = 128
RADIAL_AGENTS = 200_000
RADIAL_EXACT_TICKS = 510
# Phase 24a: the CLI's default classical rows through the facade, as
# ``python main.py --algo A --scenario S`` runs them: name -> (scenario,
# algorithm, start time, timestep, ticks).  Braess and Bottleneck run
# until every agent has arrived (the reference's numbers at 9,000 and 4,000
# ticks are the same).
CLASSICAL_ROWS = {
    "Easy dijkstra": ("Easy", "dijkstra", 21600, 2, 3600),
    "Braess dijkstra": ("Braess", "dijkstra", 21600, 1, 3000),
    "Braess random": ("Braess", "random", 21600, 1, 3000),
    "Bottleneck dijkstra": ("Bottleneck", "dijkstra", 21600, 1, 2000),
}
# The reference's numbers on those rows, (average travel time s, done,
# relative Nash gap), printed by
#   PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_equilibrium.py
CLASSICAL_REFERENCE = {
    "Easy dijkstra": (32.46500015258789, 200, 0.1309862583875656),
    "Braess dijkstra": (105.17500305175781, 200, 0.0016666667070239782),
    "Braess random": (139.72000122070312, 200, 0.3306666612625122),
    "Bottleneck dijkstra": (80.54444122314453, 720, 1.013611078262329),
}
# The card may differ from the reference only where two Gumbel scores lie
# within an ulp: the average travel time within 0.5%, the relative gap
# within 10% or 0.005, whichever is larger.
CLASSICAL_TT_RTOL = 0.005
CLASSICAL_GAP_RTOL = 0.10
CLASSICAL_GAP_ATOL = 0.005
EAGER_TICKS = 200            # Braess's ticks through the eager run()
# Phase 24b: the dual backend on phase 2's scenario.
DUAL_TICKS = 1800
DUAL_CONTEXT_TICKS = 600     # the plain-K1 cross-check's depth
DUAL_PRIMAL_TICKS = 1200     # the primal cross-check's depth
DUAL_BLOCKS_TICKS = 300      # phase 29c: the dual row on road blocks
DUAL_BIG_GRID = 36           # phase 24c: N = 7,632, the last dual size
# Phase 25: the CLI (``tarl_tpu_torch.runner.main``).  (a) The README's
# evaluation, phase 24a's Easy row; (b) training, then the evaluation of its
# checkpoint over CLI_WINDOW (600 ticks).
README_EVAL = ["--algo", "dijkstra", "--scenario", "Easy", "--mode", "eval",
               "--start-end-time", "21600", "28800", "--timestep_size", "2"]
CLI_TRAIN = ["--algo", "mpnn+ppo", "--scenario", "Braess", "--iterations",
             "2", "--rollout-steps", "32"]
CLI_WINDOW = (21600, 22200)
REPORT_FILES = ("node_metrics.csv", "daily_counts.csv",
                "equilibrium_report.json")
REPORT_PNGS = ("computation_time.png", "leg_histogram.png",
               "road_optimality.png", "daily_counts.png")
# Phase 26: ``scripts/bench_city.py``'s city at full size (seed 7).
CITY_INTERSECTIONS = 9000
CITY_AGENTS = 250_000
CITY_ZONES = 256
CITY_BACKLOG = 8192
CITY_CONTEXT_TICKS = 300     # the plain-K1 cross-check's depth
# Phase 27: the Graph Transformer.  The committed Braess weights, with the
# encoding they were evaluated with and the reference's results on the CPU
# (scripts/export_transformer_params.py), at scripts/train_rl_demo.py's RL
# settings, which the recorded run (runs/learning/braess_transformer) used.
GT_WEIGHTS = os.path.join("tarl_tpu_torch", "weights",
                          "braess_transformer_best.npz")
GT_RL = dict(rollout_steps=512, minibatch_size=128, num_epochs=4,
             entropy_coef=0.003, learning_rate=1e-3, reward_mode="progress",
             gamma=0.98, gae_lambda=0.9)
GT_EVAL_STEPS = 1800          # (a) the export's sampled evaluation
GT_SAMPLE_KEY = 3             # (a) its key, as train_rl_demo samples
GT_CHECK_STEPS = 300          # (a) the recorded greedy actions and outcome
GT_CONTEXT_STEPS = 600        # (a) the PLAIN / plain-K1 cross-check
GT_TSTT_RTOL = 0.005
GT_COLLECT_STEPS = 256        # (b)
GT_CLI_TRAIN = ["--algo", "transformer+ppo", "--scenario", "Braess",
                "--iterations", "2", "--rollout-steps", "32"]
GT_CLI_WINDOW = (21600, 21720)  # (c) train and the checkpoint's eval
# (c) the committed weights' eval: the reference's recorded greedy window
# (RLConfig's episode start, 06:00 less a minute, and GT_CHECK_STEPS).
GT_CLI_EVAL_WINDOW = (21540, 21540 + GT_CHECK_STEPS)
GT_TICKS = 1020               # (d) after WARMUP_TICKS
GT_CONTEXT_TICKS = 200        # (d) the plain-K1 cross-check
GT_CAPTURES = 3               # (d) states for the slot twin's check
GT_TIMED_CALLS = 20           # (a) the forward alone
# Phase 28: replicas of the batched trainer (b, c).
BATCH_ENVS = 4
# Phase 29: every policy on road blocks, and blocks across processes.
BLOCKS_TICKS = 600            # (a) and (d)
HEADLINE_SCENARIO = ("Grid16x16_50000", 16, 16, 50000)   # phase 2's, (d)
# (d): (backend, processes, blocks): 2 gloo ranks of 2 blocks each, and
# one NCCL rank holding all 4.
BLOCK_GROUPS = (("gloo", 2, SHARD_BLOCKS), ("nccl", 1, SHARD_BLOCKS))
SPAWN_TIMEOUT = 300           # (d): seconds for the spawned ranks in all
# Every scenario parse of the run (note_parse), for phase 28a.
PARSES: list = []
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Tick keys the random choice's kernel is held to its plain version with on
# every captured state of phases 22 and 26, besides the state's own: words
# at and near 2**32 - 1 among them.
CHOICE_KEYS = ((0, 0), (12345, 67890), (2 ** 32 - 1, 2 ** 32 - 1),
               (2 ** 32 - 1, 0), (0, 2 ** 32 - 2))


T0_ENV = "CHIP_SMOKE_T0"      # the run's start (epoch seconds), for log()


def log(msg: str) -> None:
    """Print ``msg`` after the seconds since the run began (the main
    process's start, which spawned processes inherit through ``T0_ENV``)."""
    t0 = float(os.environ.setdefault(T0_ENV, repr(time.time())))
    print(f"[{time.time() - t0:7.1f} s] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def load_scenario(name, rows, cols, num_agents, device):
    from tarl_tpu_torch.io.matsim import load_network, load_population
    from tarl_tpu_torch.io.scenarios import grid_scenario

    cache = os.path.join(ROOT, "build", "scenarios")
    base = os.path.join(cache, name)
    if not os.path.exists(os.path.join(base, "network.xml")):
        grid_scenario(cache, name, rows=rows, cols=cols,
                      num_agents=num_agents, peak_start=6 * 3600,
                      peak_spread=2 * 3600)
    t0 = time.perf_counter()
    net = load_network(os.path.join(base, "network"), device=device)
    t1 = time.perf_counter()
    agents, stats = load_population(os.path.join(base, "population"),
                                    os.path.join(base, "network"),
                                    device=device)
    note_parse(name, t1 - t0, time.perf_counter() - t1, stats)
    return net, agents


def random_road_state(net, seed: int, time_now: float):
    """A random ring state that respects the invariants: ``0 <= count <=
    capacity``, live slots hold distinct agents >= 1 with their DEST nodes,
    selections are valid choice edges (or -1)."""
    import numpy as np
    import torch

    from tarl_tpu_torch.state import RoadState

    rng = np.random.default_rng(seed)
    r, nmax = net.num_roads, net.nmax
    cap = net.capacity.cpu().numpy().astype(np.int64)
    count = rng.integers(0, cap + 1)
    head = rng.integers(0, nmax, size=r)
    logical = (np.arange(nmax)[None, :] - head[:, None]) % nmax
    live = logical < count[:, None]
    ids = np.where(live, (rng.permutation(r * nmax) + 1).reshape(r, nmax), 0)
    dep = np.where(live, time_now + rng.integers(-40, 40, (r, nmax)), 0.0)
    arr = np.where(live, dep - 30.0, 0.0)
    dst = np.where(live, net.num_roads + 2 * rng.integers(
        0, net.num_intersections, (r, nmax)) + 1, 0)
    ids, dst = ids.astype(np.int32), dst.astype(np.int32)
    dep, arr = dep.astype(np.float32), arr.astype(np.float32)
    ok = net.choice_ok.cpu().numpy()
    tab = net.choice_dst_tab.cpu().numpy()
    nslots = ok.sum(axis=0)
    pick = (rng.random(net.num_nodes) * np.maximum(nslots, 1)).astype(int)
    sel = np.where(nslots > 0, tab[pick, np.arange(net.num_nodes)], -1)
    sel[rng.random(net.num_nodes) < 0.02] = -1
    dev = net.device

    def t(a):
        return torch.as_tensor(a, device=dev)

    road_state = RoadState(
        fifo_ids=t(ids), fifo_arrival=t(arr), fifo_departure=t(dep),
        fifo_dest=t(dst), head=t(head.astype(np.int32)),
        count=t(count.astype(np.int32)),
    )
    return road_state, t(sel.astype(np.int32))


def compare_kernel(cases, net, physics):
    """Kernel vs plain on each (road, selected_road, time, key) case:
    bitwise on all five outputs, with the clock passed as a host float and
    as a device scalar (the RL environment's form).  Returns the largest
    absolute difference (0 when all match)."""
    import torch

    from tarl_tpu_torch.core.fused_winner import (
        direction_confirm, direction_confirm_plain)

    names = ("accept", "win_src", "agent", "dest", "popped")
    worst = 0
    runs = []
    for road, sel, t_now, key in cases:
        t_dev = torch.tensor(t_now, dtype=torch.float32,
                             device=road.count.device)
        runs += [(road, sel, t_now, key, t_now),
                 (road, sel, t_now, key, t_dev)]
    for i, (road, sel, t_now, key, t_arg) in enumerate(runs):
        got = direction_confirm(road, sel, net, t_arg, key, physics)
        want = direction_confirm_plain(road, sel, net, t_now, key, physics)
        torch.cuda.synchronize()
        for name, a, b in zip(names, got, want):
            if a.dtype != b.dtype or a.shape != b.shape:
                raise AssertionError(f"case {i}: {name} {a.dtype}{tuple(a.shape)}"
                                     f" vs {b.dtype}{tuple(b.shape)}")
            diff = int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
            worst = max(worst, diff)
            if not torch.equal(a, b):
                raise AssertionError(f"case {i}: kernel and plain differ in "
                                     f"{name} (max |diff| {diff})")
        if not bool(got[0].any()):
            raise AssertionError(f"case {i}: no transfer accepted; the "
                                 "comparison would be vacuous")
    return worst


def ptxas_lines(name: str) -> list[str]:
    """nvcc's ``-Xptxas -v`` report on ``csrc/<name>.cu`` (registers,
    spills, shared memory per kernel), compiled with the library's flags
    to an object that is then removed."""
    from tarl_tpu_torch import _build

    source = _build.PACKAGE_DIR / "csrc" / f"{name}.cu"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    obj = _build.BUILD_DIR / f"{name}.{os.getpid()}.ptxas.o"
    flags = [f for f in _build.NVCC_FLAGS if f != "-shared"]
    proc = subprocess.run([_build.nvcc_path(), *flags, "-Xptxas", "-v",
                           "-c", "-o", str(obj), str(source)],
                          capture_output=True, text=True)
    obj.unlink(missing_ok=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name}:\n{proc.stderr}")
    return [line.strip() for line in proc.stderr.splitlines()
            if line.strip()]


def build_kernels() -> tuple[dict, dict]:
    """Build every kernel library, and read each source's ptxas report,
    all in parallel; seconds per library and the reports."""
    from tarl_tpu_torch import _build

    def one(name):
        t0 = time.perf_counter()
        _build.load_library(name)
        return time.perf_counter() - t0

    with ThreadPoolExecutor(2 * len(KERNELS)) as pool:
        reports = pool.map(ptxas_lines, KERNELS)
        builds = dict(zip(KERNELS, pool.map(one, KERNELS)))
        return builds, dict(zip(KERNELS, reports))


def sp_row_config():
    """``bench.py``'s shortest-path row: ``(RoutingConfig, SimConfig)``."""
    from tarl_tpu_torch.config import RoutingConfig, SimConfig

    routing = RoutingConfig(refresh_rate=10, max_bf_iters=8,
                            backend="primal")
    sim = SimConfig(timestep=1, start_time=6 * 3600,
                    record_road_optimality=False, insert_window=1024,
                    withdraw_depth=2, sorted_population=True,
                    insert_escalate=False, withdraw_escalate=False)
    return routing, sim


def sp_row(net, agents, ticks=SP_TICKS, warmup=SP_WARMUP_TICKS,
           context=SP_CONTEXT_TICKS, capture_every=SP_CAPTURE_EVERY,
           config=None, dest_inters=None):
    """Phase 5 (and phases 22 and 23's sp rows): the shortest-path row through
    ``make_policy`` and ``run_episode_periodic``, at ``config``'s
    ``(RoutingConfig, SimConfig)`` (default :func:`sp_row_config`), with
    zoned tables over ``dest_inters`` where given.  Launch counts and host
    reads are reset just before the initial state is built, and read after
    it and at the end.  Returns a dict of results, with the initial state,
    the state at tick ``context``, the relax inputs (cost, warm start) of
    every ``capture_every``-th refresh and the relax's milliseconds per
    refresh (CUDA events around the call)."""
    import torch

    from tarl_tpu_torch.core import fused_winner, sync
    from tarl_tpu_torch.core.step import init_sim_state, run_episode_periodic
    from tarl_tpu_torch.routing import bellman_ford as bf
    from tarl_tpu_torch.routing import policies
    from tarl_tpu_torch.simulator import make_policy

    routing, sim = config or sp_row_config()
    on_card = net.device.type == "cuda"
    captured, relax_events = [], []

    def capturing_relax(cost, out_r, ok, road_to, dist0, max_iters,
                        relax_only=False):
        if len(refresh_events) % capture_every == 0:
            captured.append((cost, dist0))   # fresh tensors, never written
        if not on_card:
            return bf.primal_relax_next_roads(cost, out_r, ok, road_to,
                                              dist0, max_iters, relax_only)
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = bf.primal_relax_next_roads(cost, out_r, ok, road_to, dist0,
                                         max_iters, relax_only)
        ev[1].record()
        relax_events.append(ev)
        return out

    policy = make_policy("dijkstra", routing, network=net,
                         dest_inters=dest_inters, relax=capturing_relax)
    refresh_events = []
    refresh = policy.refresh
    table_init = policy.table_init
    init_counts = {}

    def counted_table_init(network):
        before = relax_counts()
        buf = table_init(network)
        init_counts.update({k: v - before[k]
                            for k, v in relax_counts().items()})
        return buf

    def timed_refresh(state, network):
        if not on_card:
            buf = refresh(state, network)
            refresh_events.append(None)
            return buf
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        buf = refresh(state, network)
        ev[1].record()
        refresh_events.append(ev)
        return buf

    policy = policy._replace(refresh=timed_refresh,
                             table_init=counted_table_init)

    def sync_dev():
        if on_card:
            torch.cuda.synchronize()

    fused_winner.reset_launches()
    bf.reset_launches()
    policies.reset_launches()
    sync.reset()
    t0 = time.perf_counter()
    state0 = init_sim_state(net, agents, sim=sim, policy=policy)
    sync_dev()
    init_s = time.perf_counter() - t0
    init_next_road = bf.NEXT_ROAD_LAUNCHES

    state, logs = run_episode_periodic(state0, net, policy, warmup, sim=sim)
    saturated = float(logs.window_saturated.sum())
    sync_dev()
    reads_before = sync.HOST_READS
    t0 = time.perf_counter()
    state, logs = run_episode_periodic(state, net, policy, context - warmup,
                                       sim=sim)
    at_context = state
    saturated += float(logs.window_saturated.sum())
    sync_dev()
    context_wall = time.perf_counter() - t0
    state, logs = run_episode_periodic(state, net, policy, ticks - context,
                                       sim=sim)
    sync_dev()
    wall = time.perf_counter() - t0
    saturated += float(logs.window_saturated.sum())
    measured = ticks - warmup
    refresh_ms = ([a.elapsed_time(b) for a, b in refresh_events]
                  if on_card else [])
    relax_ms = [a.elapsed_time(b) for a, b in relax_events]
    return {
        "state0": state0, "at_context": at_context, "final": state,
        "captured": captured, "init_s": init_s, "wall": wall,
        "context_wall": context_wall,
        "measured": measured,
        "rate": agents.num_agents * measured / wall,
        "saturated": saturated,
        "reads_per_tick": (sync.HOST_READS - reads_before) / measured,
        "refreshes": len(refresh_events),
        "refresh_ms": (sum(refresh_ms) / len(refresh_ms)
                       if refresh_ms else float("nan")),
        "relax_ms": (sum(relax_ms) / len(relax_ms)
                     if relax_ms else float("nan")),
        "table_init": init_counts,
        "forms": {k: v for k, v in relax_counts().items()
                  if k in ("resident", "cluster", "global")},
        "relax_launches": bf.LAUNCHES,
        "init_next_road_launches": init_next_road,
        "next_road_launches": bf.NEXT_ROAD_LAUNCHES,
        "winner_launches": fused_winner.LAUNCHES,
        "choice_launches": policies.LAUNCHES,
        "routing": routing, "sim": sim,
    }


def relax_counts() -> dict:
    """The relax's counts: its calls, each form's launches, the next-road
    kernel's and the host reads."""
    from tarl_tpu_torch.core import sync
    from tarl_tpu_torch.routing import bellman_ford as bf

    return {"relax": bf.LAUNCHES, "resident": bf.RESIDENT_LAUNCHES,
            "cluster": bf.CLUSTER_LAUNCHES, "global": bf.GLOBAL_LAUNCHES,
            "next_road": bf.NEXT_ROAD_LAUNCHES, "host_reads": sync.HOST_READS}


def check_sp_row(res, net, ticks=SP_TICKS) -> None:
    """Phase 5's asserts on the final state and the counts."""
    import torch

    from tarl_tpu_torch.routing import policies
    from tarl_tpu_torch.routing.bellman_ford import BIG

    final = res["final"]
    on_road = int(final.road.count.sum())
    on_way = int(final.agents.on_way.sum())
    if on_road != on_way:
        raise AssertionError(f"sp row conservation: {on_road} on roads, "
                             f"{on_way} inserted and not done")
    if int(final.agents.done.sum()) <= 0:
        raise AssertionError("sp row: no agent arrived")
    i_n = net.num_intersections
    dist, cost, road = policies._primal_unpack(final.next_hop, i_n, i_n,
                                               net.num_roads)
    if not (bool(torch.isfinite(final.next_hop).all())
            and float(dist.max()) < BIG and bool((road >= 0).all())):
        raise AssertionError("sp row: routing table not finite, or a pair "
                             "without a next road")
    refreshes = ticks // res["routing"].refresh_rate
    expected = {"refreshes": refreshes, "relax_launches": refreshes,
                "init_next_road_launches": 1, "next_road_launches": 1,
                "winner_launches": ticks, "choice_launches": 0}
    for name, want in expected.items():
        if res[name] != want:
            raise AssertionError(f"sp row: {name} = {res[name]}, expected "
                                 f"{want}")


# --- the random choice's kernel (phases 22 and 26) --------------------------

def choice_bound_ms(net) -> tuple[float, int]:
    """The random choice's least bytes and their time at the HBM peak, in
    ms: each slot's ok flag, each node's selection in and out, one
    destination for each node with an ok slot, and each road's
    ``road_order`` entry on a renumbered network."""
    kc, n = net.choice_dst_tab.shape
    with_slot = int(net.choice_ok.any(dim=0).sum())
    least = (kc * n + 8 * n + 4 * with_slot
             + (4 * net.num_roads if net.renumbered else 0))
    return least / HBM_BYTES_PER_S * 1e3, least


def choice_row(label: str, net, states, card: str,
               calls: int = TIMED_CALLS) -> dict:
    """The random choice's kernel (``csrc/choice.cu`` through
    ``policies.random_choice``) against ``random_choice_plain`` on a row's
    captured ``states``, each with its own key and with ``CHOICE_KEYS``:
    the selection and the key written back bitwise, one launch a call on
    the card (none on the CPU, where the wrapper is the plain version).
    On the card, both timed per call on the middle state, plain, kernel,
    kernel, plain (CUDA events), and each one's device time and device
    activities a call by kind (``torch.profiler``), beside the kernel's
    bound.  Returns the numbers the kernels line reads."""
    import torch

    from tarl_tpu_torch.routing import policies

    on_card = net.device.type == "cuda"
    kernel, plain = policies.random_choice, policies.random_choice_plain
    checked = 0
    for s in states:
        for key in (s.key, *CHOICE_KEYS):
            st = s._replace(key=key)
            before = policies.LAUNCHES
            got, _ = kernel(st, net)
            launched = policies.LAUNCHES - before
            want, _ = plain(st, net)
            if launched != int(on_card):
                raise AssertionError(f"{label}: the random choice launched "
                                     f"its kernel {launched} times in a "
                                     f"call")
            if got.key != want.key or not torch.equal(got.selected_road,
                                                      want.selected_road):
                diff = int((got.selected_road != want.selected_road).sum())
                raise AssertionError(
                    f"{label}: the random choice's kernel and plain version "
                    f"differ at key {key}: {diff} nodes, keys written back "
                    f"{got.key} and {want.key}")
            checked += 1
    kc, n = net.choice_dst_tab.shape
    bound_ms, least = choice_bound_ms(net)
    out = {"checked": checked, "n": n, "kc": kc,
           "renumbered": bool(net.renumbered),
           "ok_slots": int(net.choice_ok.sum()), "least_bytes": least,
           "bound_ms": bound_ms}
    log(f"random choice kernel vs plain, {label} (N={n}, KC={kc}, "
        f"renumbered {net.renumbered}, {out['ok_slots']} ok slots): "
        f"selection and key written back bitwise equal in {checked} calls "
        f"({len(states)} captured states, each with its own key and "
        f"{len(CHOICE_KEYS)} more), one launch a call ({card})")
    if not on_card:
        return out
    args = (states[len(states) // 2], net)
    p1, k1, k2, p2 = time_pair(kernel, plain, args, calls)
    for name, fn in (("", kernel), ("plain_", plain)):
        acts = device_activities(fn, args, calls)
        per_name, _ = name_times(acts, calls)
        out[f"{name}device_ms"] = (None if per_name is None
                                   else sum(per_name.values()))
        out[f"{name}activities"] = activity_kinds(acts, calls)
    out.update(ms=min(k1, k2), plain_ms=min(p1, p2),
               turns_ms=[p1, k1, k2, p2])
    log(f"random choice, {label}: kernel {k1 * 1e3:.2f} / {k2 * 1e3:.2f} us "
        f"per call, plain {p1 * 1e3:.2f} / {p2 * 1e3:.2f} us (plain, "
        f"kernel, kernel, plain; CUDA events over {calls} calls); device "
        f"{fmt_us(out['device_ms'])} per call in "
        f"{out['activities']}, plain {fmt_us(out['plain_device_ms'])} in "
        f"{out['plain_activities']} (torch.profiler, activities a call by "
        f"kind); bound {bound_ms * 1e3:.4f} us by bytes ({least} bytes at "
        f"3.35 TB/s) ({card})")
    return out


# --- the million-agent row (phase 22) ----------------------------------------

def million_scenario(device, grid=MILLION_GRID, num_agents=MILLION_AGENTS,
                     zones=MILLION_ZONES):
    """``scripts/bench_million.py``'s scenario through the port: a ``grid x
    grid`` network and ``num_agents`` commuters departing 06:00-09:00 to
    ``zones`` zones, generated under ``build/scenarios`` and parsed by
    ``io.matsim``; the population sorted by departure, and the zone list
    ``unique(_dest_inter(net, agents.dest))`` (the dummy agent's clamped
    intersection 0 among them, as the reference's row has it).  Returns
    ``(net, agents, dest_inters, seconds)``."""
    import numpy as np

    from tarl_tpu_torch.io.matsim import load_network, load_population
    from tarl_tpu_torch.io.scenarios import grid_scenario
    from tarl_tpu_torch.routing.policies import _dest_inter
    from tarl_tpu_torch.state import sort_agents_by_departure

    cache = os.path.join(ROOT, "build", "scenarios")
    name = f"MillionGrid{grid}_{num_agents}_z{zones}"
    base = os.path.join(cache, name)
    seconds = {"generate": 0.0}
    if not os.path.exists(os.path.join(base, "network.xml")):
        t0 = time.perf_counter()
        grid_scenario(cache, name, rows=grid, cols=grid,
                      num_agents=num_agents, peak_start=6 * 3600,
                      peak_spread=3 * 3600, num_dest_zones=zones)
        seconds["generate"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    net = load_network(os.path.join(base, "network"), device=device)
    seconds["network"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    agents, stats = load_population(os.path.join(base, "population"),
                                    os.path.join(base, "network"),
                                    device=device)
    agents = sort_agents_by_departure(agents)
    seconds["population"] = time.perf_counter() - t0
    note_parse("million", seconds["network"], seconds["population"], stats)
    dest = np.unique(_dest_inter(net, agents.dest).cpu().numpy())
    return net, agents, dest, seconds


def million_configs():
    """``scripts/bench_million.py``'s ``(RoutingConfig, sp SimConfig,
    exact_random SimConfig)``."""
    from tarl_tpu_torch.config import RoutingConfig, SimConfig

    routing = RoutingConfig(refresh_rate=10, max_bf_iters=8,
                            backend="primal")
    base = dict(timestep=1, start_time=6 * 3600,
                record_road_optimality=False, withdraw_depth=2,
                sorted_population=True)
    sp = SimConfig(**base, insert_window=4096)
    exact = SimConfig(**base, insert_window=MILLION_EXACT_WINDOW,
                      insert_backlog=MILLION_BACKLOG, insert_escalate=True,
                      withdraw_escalate=True)
    return routing, sp, exact


def successor_order(net) -> dict:
    """How far each out-slot's successor lies from its row in the
    network's intersection order: the bandwidth (the largest |s - i|), the
    cyclic bandwidth (modulo I) and the number of distinct offsets: what
    a row window with a halo would have to cover."""
    import torch

    i_n = net.num_intersections
    succ = net.road_to[net.inter_out_road.long()].long()
    rows = torch.arange(i_n, device=succ.device)[:, None]
    d = (succ - rows)[net.inter_out_ok]
    m = torch.remainder(d, i_n)
    return {"bandwidth": int(d.abs().max()),
            "cyclic": int(torch.minimum(m, i_n - m).max()),
            "offsets": int(torch.unique(m).numel())}


def zoned_table(buf, i_n: int, d_n: int, num_roads: int):
    """``(dist[I, D], road[I, D])`` of a zoned routing scratch (``dist ++
    cost ++ next_road ++`` the int8 slot table)."""
    n = i_n * d_n
    return (buf[:n].view(i_n, d_n),
            buf[n + num_roads:2 * n + num_roads].view(i_n, d_n))


def check_million_sp(res, net, agents, d_n: int, ticks: int) -> None:
    """Phase 22's asserts on its sp row: conservation, arrivals, a finite
    table with a road for every pair, one cluster relax a refresh, the
    uncapped table init in one cluster launch (its next roads included)
    with no host read, no global-form call, K1 once a tick and no launch
    of the random choice's kernel."""
    import torch

    from tarl_tpu_torch.routing.bellman_ford import BIG

    final = res["final"]
    on_road = int(final.road.count.sum())
    on_way = int(final.agents.on_way.sum())
    done = int(final.agents.done.sum())
    if on_road != on_way or done + on_way > agents.num_agents - 1:
        raise AssertionError(f"million sp row conservation: {on_road} on "
                             f"roads, {on_way} on the way, {done} done of "
                             f"{agents.num_agents - 1}")
    if done <= 0:
        raise AssertionError("million sp row: no agent arrived")
    dist, road = zoned_table(final.next_hop, net.num_intersections, d_n,
                             net.num_roads)
    if not (bool(torch.isfinite(dist).all()) and float(dist.max()) < BIG
            and bool((road >= 0).all())):
        raise AssertionError("million sp row: routing table not finite, or "
                             "a pair without a next road")
    refreshes = ticks // res["routing"].refresh_rate
    got = {"refreshes": res["refreshes"],
           "refresh relax calls": res["relax_launches"]
           - res["table_init"]["relax"],
           "forms": res["forms"], "table init": res["table_init"],
           "winner_launches": res["winner_launches"],
           "choice_launches": res["choice_launches"]}
    want = {"refreshes": refreshes, "refresh relax calls": refreshes,
            "forms": {"resident": 0, "cluster": refreshes + 1, "global": 0},
            "table init": {"relax": 1, "resident": 0, "cluster": 1,
                           "global": 0, "next_road": 0, "host_reads": 0},
            "winner_launches": ticks, "choice_launches": 0}
    if got != want:
        raise AssertionError(f"million sp row: {got}, expected {want}")


@contextlib.contextmanager
def forced_relax(form: str):
    """The relax in another form than its shape's: ``"global"`` (both
    plans decline) or ``"full width"`` (the cluster plan not told the
    card's capacity, so its tiles are 7 columns wide and a column count
    that is not a multiple of 7 leaves a masked tail)."""
    from tarl_tpu_torch.routing import bellman_ford as bf

    saved = (bf.resident_plan, bf.cluster_plan, bf._cluster_fit)
    if form == "global":
        bf.resident_plan = bf.cluster_plan = lambda *shape: None
    elif form == "full width":
        bf._cluster_fit = lambda *shape: None
    else:
        raise ValueError(form)
    try:
        yield
    finally:
        bf.resident_plan, bf.cluster_plan, bf._cluster_fit = saved


def time_relax_forms(args, calls: int = RELAX_TIMED_CALLS) -> dict:
    """The relax on ``args`` in the form its shape takes and in the global
    form (forced), beside the plain version: per call, CUDA events in the
    order plain, kernel, global, global, kernel, plain, and each form's
    device time and kernels per call from ``torch.profiler``."""
    from tarl_tpu_torch.routing import bellman_ford as bf

    kernel, plain = bf.primal_relax_next_roads, bf.primal_relax_next_roads_plain
    out = {"plain": [time_per_call(plain, args, calls)],
           "kernel": [time_per_call(kernel, args, calls)]}
    with forced_relax("global"):
        out["global"] = [time_per_call(kernel, args, calls)
                         for _ in range(2)]
    out["kernel"].append(time_per_call(kernel, args, calls))
    out["plain"].append(time_per_call(plain, args, calls))
    out["device"] = device_time_per_call(kernel, args, calls)
    with forced_relax("global"):
        out["global_device"] = device_time_per_call(kernel, args, calls)
    return out


def fmt_forms(t: dict) -> str:
    """:func:`time_relax_forms`'s numbers as a line."""
    k, g, p = t["kernel"], t["global"], t["plain"]
    return (f"kernel {k[0]:.4f} / {k[1]:.4f} ms per call, global form "
            f"{g[0]:.4f} / {g[1]:.4f}, plain {p[0]:.4f} / {p[1]:.4f} (plain, "
            f"kernel, global, global, kernel, plain; CUDA events); device "
            f"{fmt_us(t['device'][0])} in {t['device'][1]:.1f} kernels, "
            f"global form {fmt_us(t['global_device'][0])} in "
            f"{t['global_device'][1]:.1f} (torch.profiler)")


def million_phase(dev, card: str, grid=MILLION_GRID,
                  num_agents=MILLION_AGENTS, zones=MILLION_ZONES,
                  ticks=SP_TICKS, warmup=SP_WARMUP_TICKS,
                  context=SP_CONTEXT_TICKS,
                  timed_calls=RELAX_TIMED_CALLS) -> dict:
    """Phase 22, the million-agent row (``scripts/bench_million.py``) on
    the port: its scenario, its sp row (zoned tables, ``cluster_plan``'s
    form past 4,096 rows) and the row in context with the plain relax, the
    cluster form against plain on the row's own refresh inputs and cold
    start, the relax timed in both forms at the row's shape, and its
    exact_random row.  Returns the numbers the kernels line reads."""
    import torch

    from tarl_tpu_torch.core.step import Policy, run_episode_periodic
    from tarl_tpu_torch.routing import bellman_ford as bf
    from tarl_tpu_torch.routing.bellman_ford import BIG
    from tarl_tpu_torch.routing.policies import random_choice
    from tarl_tpu_torch.simulator import make_policy

    def sync_dev():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    net, agents, dest, secs = million_scenario(dev, grid, num_agents, zones)
    i_n, k_n = net.inter_out_road.shape
    d_n = len(dest)
    order = successor_order(net)
    log(f"million row Grid{grid}x{grid}: {net.num_roads} roads, {i_n} "
        f"intersections, {agents.num_agents} agent rows, D={d_n} destination "
        f"columns; generated in {secs['generate']:.1f} s, network parsed in "
        f"{secs['network']:.1f} s, population parsed and sorted in "
        f"{secs['population']:.1f} s; successors up to {order['bandwidth']} "
        f"rows away (cyclic {order['cyclic']}, {order['offsets']} distinct "
        f"offsets); cluster_plan at 8 sweeps "
        f"{bf.cluster_plan(i_n, d_n, k_n, 8)}")
    routing, sim_sp, sim_ex = million_configs()
    sp = sp_row(net, agents, ticks, warmup, context,
                config=(routing, sim_sp), dest_inters=dest)
    check_million_sp(sp, net, agents, d_n, ticks)
    final = sp["final"]
    log(f"million sp row: {sp['rate']:.1f} agent-steps/s ({sp['measured']} "
        f"ticks in {sp['wall']:.2f} s, "
        f"{sp['wall'] / sp['measured'] * 1e3:.3f} ms/tick), "
        f"{sp['refresh_ms']:.3f} ms per refresh and {sp['relax_ms']:.4f} ms "
        f"of it in the relax call (CUDA events, {sp['refreshes']} "
        f"refreshes), done {int(final.agents.done.sum())}, on the way "
        f"{int(final.agents.on_way.sum())}, host reads per tick "
        f"{sp['reads_per_tick']:.3f}, saturation monitor sum "
        f"{sp['saturated']}; relax calls {sp['forms']} (the uncapped table "
        f"init {sp['table_init']}, in {sp['init_s']:.2f} s with the "
        f"initial state), fused_winner calls {sp['winner_launches']} "
        f"({card})")

    plain_policy = make_policy("dijkstra", routing, network=net,
                               dest_inters=dest,
                               relax=bf.primal_relax_next_roads_plain)
    before = (bf.LAUNCHES, bf.NEXT_ROAD_LAUNCHES)
    plain, _ = run_episode_periodic(sp["state0"], net, plain_policy, warmup,
                                    sim=sim_sp)
    sync_dev()
    t0 = time.perf_counter()
    plain, _ = run_episode_periodic(plain, net, plain_policy,
                                    context - warmup, sim=sim_sp)
    sync_dev()
    plain_wall = time.perf_counter() - t0
    if (bf.LAUNCHES, bf.NEXT_ROAD_LAUNCHES) != before:
        raise AssertionError("the plain million row launched a relax kernel")
    mismatched = _diff_paths(_state_bits(sp["at_context"]),
                             _state_bits(plain))
    if mismatched:
        raise AssertionError(f"kernel and plain million rows differ at tick "
                             f"{context}: {mismatched}")
    span = context - warmup
    log(f"million row in context: kernel and plain-relax states equal "
        f"bitwise at tick {context}, packed table included; ticks "
        f"{warmup}-{context}: kernel "
        f"{sp['context_wall'] / span * 1e3:.3f} ms/tick, plain relax "
        f"{plain_wall / span * 1e3:.3f} ms/tick ({card})")

    tables = relax_tables(net)
    cases = [(f"million refresh {j * SP_CAPTURE_EVERY}", c, tables, d)
             for j, (c, d) in enumerate(sp["captured"])]
    anchor = (torch.arange(i_n, device=dev)[:, None]
              == torch.as_tensor(dest, device=dev).long()[None, :])
    cold = torch.where(anchor, 0.0, BIG).contiguous()
    errs = {"refresh inputs": compare_relax(
        cases, [(routing.max_bf_iters, False), (routing.max_bf_iters, True),
                (None, False)]),
            "cold start, uncapped": compare_relax(
        [("million cold start", net.free_flow, tables, cold)],
        [(None, True), (None, False)])}
    # The table init's table (the kernel's, the start of both runs above)
    # against the plain relax from the cold start, and the global form's
    # next-road kernel on that table.
    want = bf.primal_relax_next_roads_plain(net.free_flow, *tables, cold,
                                            None)
    init = zoned_table(sp["state0"].next_hop, i_n, d_n, net.num_roads)
    errs["table init"] = assert_bitwise(
        "million table init", zip(("dist", "next road"), init, want))
    errs["next-road kernel"] = compare_next_roads(
        "million uncapped table", want[0], net.free_flow, tables)
    log(f"primal_relax cluster form vs plain: bitwise equal on {len(cases)} "
        f"captured million-row refresh inputs (8 sweeps with and without "
        f"next roads, uncapped) and its cold start (uncapped, with and "
        f"without next roads); the table init's table (one cluster launch, "
        f"no host read) equals the plain relax's, and primal_next_roads "
        f"(the global form's next-road kernel) the plain pass's on it "
        f"({card})")

    timed = {}
    if dev.type == "cuda":
        _, c, tabs, d0 = cases[len(cases) // 2]
        for mode, only in (("K3", False), ("K5", True)):
            t = time_relax_forms((c, *tabs, d0, routing.max_bf_iters, only),
                                 timed_calls)
            t["bound"] = relax_bound_ms(net, routing.max_bf_iters, d_n, only)
            timed[mode] = t
            log(f"primal_relax {mode} mode at the million row's shape "
                f"(I={i_n}, D={d_n}, {routing.max_bf_iters} sweeps"
                f"{'' if only else ' + next road'}, a captured refresh; "
                f"(tile width, blocks) "
                f"{bf.launch_cluster_plan(dev, i_n, d_n, k_n, 8)}): "
                f"{fmt_forms(t)}; bound {t['bound'][0]:.4f} ms by "
                f"{t['bound'][1]} ({card})")

    ex = headline_run(net, agents, sim_ex, Policy(choice=random_choice),
                      ticks=ticks, warmup=warmup, capture_every=context)
    backlog = ex["final"].backlog
    if ex["overflow"] != 0.0:
        raise AssertionError(f"million exact_random: overflow monitor "
                             f"{ex['overflow']}, not 0")
    if (ex["on_road"] != ex["on_way"]
            or ex["done"] + ex["on_way"] > agents.num_agents - 1):
        raise AssertionError(f"million exact_random conservation: "
                             f"{ex['on_road']} on roads, {ex['on_way']} on "
                             f"the way, {ex['done']} done")
    if dev.type == "cuda" and (ex["launches"]["K1"],
                               ex["launches"]["choice"]) != (ticks, ticks):
        raise AssertionError(f"million exact_random: launches "
                             f"{ex['launches']}")
    backlog_mb = backlog.qpack.numel() * 4 / 2 ** 20
    log(f"million exact_random: {ex['rate']:.1f} agent-steps/s "
        f"({ex['measured']} ticks in {ex['wall']:.2f} s, "
        f"{ex['wall'] / ex['measured'] * 1e3:.3f} ms/tick), done "
        f"{ex['done']}, on the way {ex['on_way']}, overflow "
        f"{ex['overflow']}, host reads per tick {ex['syncs_per_tick']:.3f}, "
        f"backlog {backlog_mb:.1f} MB, launches {ex['launches']} ({card})")
    choice = choice_row("million grid", net, ex["captured"], card)
    return {"sp": sp, "errs": errs, "timed": timed, "i_n": i_n,
            "d_n": d_n, "choice": choice, "exact_launches": ex["launches"]}


# --- the radial metro (phase 23) ---------------------------------------------

def radial_scenario_on(device, rings=RADIAL_RINGS, spokes=RADIAL_SPOKES,
                       num_agents=RADIAL_AGENTS):
    """``scripts/bench_radial.py``'s scenario through the port: ``rings``
    rings of ``spokes`` intersections around a centre of 8 spurs and
    ``num_agents`` commuters departing 06:00-08:00, every trip ending in
    the CBD (``cbd_fraction=1.0``: the centre and the first ring),
    generated under ``build/scenarios`` and parsed by ``io.matsim``; the
    population sorted by departure, and the zone list
    ``unique(_dest_inter(net, agents.dest))``.  Returns ``(net, agents,
    dest_inters, seconds)``."""
    import numpy as np

    from tarl_tpu_torch.io.matsim import load_network, load_population
    from tarl_tpu_torch.io.scenarios import radial_scenario
    from tarl_tpu_torch.routing.policies import _dest_inter
    from tarl_tpu_torch.state import sort_agents_by_departure

    cache = os.path.join(ROOT, "build", "scenarios")
    name = f"RadialBench{rings}x{spokes}_{num_agents}"
    base = os.path.join(cache, name)
    seconds = {"generate": 0.0}
    if not os.path.exists(os.path.join(base, "network.xml")):
        t0 = time.perf_counter()
        radial_scenario(cache, name, rings=rings, spokes=spokes,
                        num_agents=num_agents, cbd_fraction=1.0,
                        peak_start=6 * 3600, peak_spread=2 * 3600)
        seconds["generate"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    net = load_network(os.path.join(base, "network"), device=device)
    seconds["network"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    agents, stats = load_population(os.path.join(base, "population"),
                                    os.path.join(base, "network"),
                                    device=device)
    agents = sort_agents_by_departure(agents)
    seconds["population"] = time.perf_counter() - t0
    note_parse("radial", seconds["network"], seconds["population"], stats)
    dest = np.unique(_dest_inter(net, agents.dest).cpu().numpy())
    return net, agents, dest, seconds


def radial_configs():
    """``scripts/bench_radial.py``'s ``(RoutingConfig, bounded SimConfig,
    exact SimConfig)``: windowed insert W=1,024, withdraw depth 2, without
    and with both escalations."""
    from tarl_tpu_torch.config import RoutingConfig, SimConfig

    routing = RoutingConfig(refresh_rate=10, max_bf_iters=8,
                            backend="primal")
    base = dict(timestep=1, start_time=6 * 3600,
                record_road_optimality=False, insert_window=1024,
                withdraw_depth=2, sorted_population=True)
    bounded = SimConfig(**base, insert_escalate=False,
                        withdraw_escalate=False)
    exact = SimConfig(**base, insert_escalate=True, withdraw_escalate=True)
    return routing, bounded, exact


def check_radial_sp(res, net, agents, d_n: int, ticks: int,
                    label: str = "radial row") -> None:
    """Phase 23's (and phase 26's) asserts on a zoned row of more than 4
    slots a row: conservation, arrivals, a finite table with a road for
    every pair (the network is strongly connected), one relax call a
    refresh, every one and the uncapped table init in the global form (one
    launch each), the table init with no host read, no resident or cluster
    launch, K1 once a tick and no launch of the random choice's kernel."""
    import torch

    from tarl_tpu_torch.routing.bellman_ford import BIG

    final = res["final"]
    on_road = int(final.road.count.sum())
    on_way = int(final.agents.on_way.sum())
    done = int(final.agents.done.sum())
    if on_road != on_way or done + on_way > agents.num_agents - 1:
        raise AssertionError(f"{label} conservation: {on_road} on roads, "
                             f"{on_way} on the way, {done} done of "
                             f"{agents.num_agents - 1}")
    if done <= 0:
        raise AssertionError(f"{label}: no agent arrived")
    dist, road = zoned_table(final.next_hop, net.num_intersections, d_n,
                             net.num_roads)
    if not (bool(torch.isfinite(dist).all()) and float(dist.max()) < BIG
            and bool((road >= 0).all())):
        raise AssertionError(f"{label}: routing table not finite, or a "
                             "pair without a next road")
    refreshes = ticks // res["routing"].refresh_rate
    got = {"refreshes": res["refreshes"],
           "refresh relax calls": res["relax_launches"]
           - res["table_init"]["relax"],
           "forms": res["forms"], "table init": res["table_init"],
           "winner_launches": res["winner_launches"],
           "choice_launches": res["choice_launches"]}
    want = {"refreshes": refreshes, "refresh relax calls": refreshes,
            "forms": {"resident": 0, "cluster": 0, "global": refreshes + 1},
            "table init": {"relax": 1, "resident": 0, "cluster": 0,
                           "global": 1, "next_road": 0, "host_reads": 0},
            "winner_launches": ticks, "choice_launches": 0}
    if got != want:
        raise AssertionError(f"{label}: {got}, expected {want}")


def scattered_slots(net, seed: int):
    """The network's slot tables with every row's slots in a seeded order
    and each padding slot on one of three seeded roads: padding neither on
    road 0 nor last, repeating within some rows and not within others.
    ``(inter_out_road, inter_out_ok, road_to)``."""
    import numpy as np
    import torch

    g = np.random.default_rng(seed)
    i_n, k_n = net.inter_out_road.shape
    dev = net.device
    order = torch.as_tensor(np.argsort(g.random((i_n, k_n)), axis=1),
                            device=dev)
    pads = g.choice(net.num_roads, 3, replace=False)
    pad = torch.as_tensor(pads[g.integers(0, 3, (i_n, k_n))],
                          dtype=torch.int32, device=dev)
    ok = net.inter_out_ok.gather(1, order).contiguous()
    out_road = torch.where(ok, net.inter_out_road.gather(1, order),
                           pad).contiguous()
    return out_road, ok, net.road_to


def radial_phase(dev, card: str, rings=RADIAL_RINGS, spokes=RADIAL_SPOKES,
                 num_agents=RADIAL_AGENTS, ticks=SP_TICKS,
                 warmup=SP_WARMUP_TICKS, context=SP_CONTEXT_TICKS,
                 exact_ticks=RADIAL_EXACT_TICKS,
                 timed_calls=RELAX_TIMED_CALLS) -> dict:
    """Phase 23, the radial metro (``scripts/bench_radial.py``) on the
    port: its scenario, its bounded row (zoned tables of 8 out-slots a
    row, the relax's global form) and the row in context with the plain
    relax, the global form against plain on the row's own refresh inputs,
    its cold start and a table of scattered padding, the relax timed at
    the row's shape, and its exact row.  Returns the numbers the kernels
    line reads."""
    import numpy as np
    import torch

    from tarl_tpu_torch.core import sync
    from tarl_tpu_torch.core.step import init_sim_state, run_episode_periodic
    from tarl_tpu_torch.routing import bellman_ford as bf
    from tarl_tpu_torch.routing.bellman_ford import BIG
    from tarl_tpu_torch.simulator import make_policy

    on_card = dev.type == "cuda"

    def sync_dev():
        if on_card:
            torch.cuda.synchronize()

    net, agents, dest, secs = radial_scenario_on(dev, rings, spokes,
                                                 num_agents)
    i_n, k_n = net.inter_out_road.shape
    d_n = len(dest)
    order = successor_order(net)
    degree = torch.bincount(net.inter_out_ok.sum(dim=1)).tolist()
    kept = bf.compact_slots(net.inter_out_road, net.inter_out_ok).sum(dim=1)
    log(f"radial row {rings}x{spokes}: {net.num_roads} roads, {i_n} "
        f"intersections, K={k_n} out-slots (rows by out-degree "
        f"{ {d: n for d, n in enumerate(degree) if n} }), "
        f"{agents.num_agents} agent rows, D={d_n} destination columns; "
        f"generated in {secs['generate']:.1f} s, network parsed in "
        f"{secs['network']:.1f} s, population parsed and sorted in "
        f"{secs['population']:.1f} s; successors up to {order['bandwidth']} "
        f"rows away (cyclic {order['cyclic']}, {order['offsets']} distinct "
        f"offsets); the global kernel's compact slot lists "
        f"{float(kept.float().mean()):.3f} slots a row (of {k_n}); "
        f"resident_plan {bf.resident_plan(i_n, d_n, k_n, 8)}, cluster_plan "
        f"{bf.cluster_plan(i_n, d_n, k_n, 8)} at 8 sweeps")
    routing, sim_b, sim_ex = radial_configs()
    sp = sp_row(net, agents, ticks, warmup, context,
                config=(routing, sim_b), dest_inters=dest)
    check_radial_sp(sp, net, agents, d_n, ticks)
    final = sp["final"]
    log(f"radial bounded row: {sp['rate']:.1f} agent-steps/s "
        f"({sp['measured']} ticks in {sp['wall']:.2f} s, "
        f"{sp['wall'] / sp['measured'] * 1e3:.3f} ms/tick), "
        f"{sp['refresh_ms']:.3f} ms per refresh and {sp['relax_ms']:.4f} ms "
        f"of it in the relax call (CUDA events, {sp['refreshes']} "
        f"refreshes), done {int(final.agents.done.sum())}, on the way "
        f"{int(final.agents.on_way.sum())}, host reads per tick "
        f"{sp['reads_per_tick']:.3f}, saturation monitor sum "
        f"{sp['saturated']}; relax calls {sp['forms']} (the uncapped table "
        f"init {sp['table_init']}, in {sp['init_s']:.2f} s with the "
        f"initial state), fused_winner calls {sp['winner_launches']} "
        f"({card})")

    plain_policy = make_policy("dijkstra", routing, network=net,
                               dest_inters=dest,
                               relax=bf.primal_relax_next_roads_plain)
    before = relax_counts()
    plain, _ = run_episode_periodic(sp["state0"], net, plain_policy, warmup,
                                    sim=sim_b)
    sync_dev()
    t0 = time.perf_counter()
    plain, _ = run_episode_periodic(plain, net, plain_policy,
                                    context - warmup, sim=sim_b)
    sync_dev()
    plain_wall = time.perf_counter() - t0
    launched = {k: v - before[k] for k, v in relax_counts().items()
                if k != "host_reads"}
    if any(launched.values()):
        raise AssertionError(f"the plain radial row launched a relax "
                             f"kernel: {launched}")
    mismatched = _diff_paths(_state_bits(sp["at_context"]),
                             _state_bits(plain))
    if mismatched:
        raise AssertionError(f"kernel and plain radial rows differ at tick "
                             f"{context}: {mismatched}")
    span = context - warmup
    log(f"radial row in context: kernel and plain-relax states equal "
        f"bitwise at tick {context}, packed table included; ticks "
        f"{warmup}-{context}: kernel "
        f"{sp['context_wall'] / span * 1e3:.3f} ms/tick, plain relax "
        f"{plain_wall / span * 1e3:.3f} ms/tick ({card})")

    tables = relax_tables(net)
    iters = routing.max_bf_iters
    cases = [(f"radial refresh {j * SP_CAPTURE_EVERY}", c, tables, d)
             for j, (c, d) in enumerate(sp["captured"])]
    anchor = (torch.arange(i_n, device=dev)[:, None]
              == torch.as_tensor(dest, device=dev).long()[None, :])
    cold = torch.where(anchor, 0.0, BIG).contiguous()
    errs = {"refresh inputs": compare_relax(
        cases, [(iters, False), (iters, True), (1, True), (None, False)])}
    reads = sync.HOST_READS
    errs["cold start, uncapped"] = compare_relax(
        [("radial cold start", net.free_flow, tables, cold)],
        [(None, True), (None, False)])
    plain_reads = sync.HOST_READS - reads
    # The plain relax reads its convergence test every sweep; the kernel
    # must read nothing.
    reads = sync.HOST_READS
    bf.primal_relax_next_roads(net.free_flow, *tables, cold, None)
    sync_dev()
    if on_card and sync.HOST_READS != reads:
        raise AssertionError(f"the uncapped global form read the host "
                             f"{sync.HOST_READS - reads} times")
    want = bf.primal_relax_next_roads_plain(net.free_flow, *tables, cold,
                                            None)
    init = zoned_table(sp["state0"].next_hop, i_n, d_n, net.num_roads)
    errs["table init"] = assert_bitwise(
        "radial table init", zip(("dist", "next road"), init, want))
    errs["next-road kernel"] = compare_next_roads(
        "radial uncapped table", want[0], net.free_flow, tables)
    # A table with its padding scattered, and entries of -BIG in the warm
    # start, so that every padding term counts (BIG + -BIG = 0).
    scattered = scattered_slots(net, 23)
    keep = bf.compact_slots(*scattered[:2])
    if not (bool((~keep).any()) and bool((keep & ~scattered[1]).any())):
        raise AssertionError("the scattered table drops no padding slot, or "
                             "keeps none")
    _, c_mid, _, d_mid = cases[len(cases) // 2]
    g = np.random.default_rng(23)
    d_neg = torch.where(torch.as_tensor(g.random(tuple(d_mid.shape)) < 0.01,
                                        device=dev), -BIG, d_mid).contiguous()
    errs["scattered padding"] = compare_relax(
        [("radial scattered padding", c_mid, scattered, d_neg)],
        [(iters, False), (iters, True), (1, True), (None, False)])
    log(f"primal_relax global form vs plain: bitwise equal on {len(cases)} "
        f"captured radial refresh inputs (8 sweeps with and without next "
        f"roads, 1 sweep, uncapped), its cold start (uncapped, with and "
        f"without next roads; the plain version's convergence tests made "
        f"{plain_reads} host reads, the kernel none) and a table of "
        f"scattered padding ({int((~keep).sum())} of {keep.numel()} slots "
        f"dropped, {int((keep & ~scattered[1]).sum())} padding slots kept); "
        f"the table init's table (one global launch, no host read) equals "
        f"the plain relax's, and primal_next_roads the plain pass's on it "
        f"({card})")

    timed = {}
    if on_card:
        args = (c_mid, *tables, d_mid, iters, False)
        plain1, kern1, kern2, plain2 = time_pair(
            bf.primal_relax_next_roads, bf.primal_relax_next_roads_plain,
            args, timed_calls)
        dev_ms, acts = device_time_per_call(bf.primal_relax_next_roads, args,
                                            timed_calls)
        if round(acts) != 1:
            raise AssertionError(f"a radial refresh's relax call ran {acts} "
                                 f"device activities, not one launch")
        cold_args = (net.free_flow, *tables, cold, None, False)
        cold_ms = time_per_call(bf.primal_relax_next_roads, cold_args,
                                timed_calls)
        cold_dev, cold_acts = device_time_per_call(
            bf.primal_relax_next_roads, cold_args, timed_calls)
        bound = relax_bound_ms(net, iters, d_n, False)
        timed = {"ms": min(kern1, kern2), "plain_ms": min(plain1, plain2),
                 "device_ms": dev_ms, "bound": bound,
                 "init_ms": cold_ms, "init_device_ms": cold_dev}
        log(f"primal_relax global form at the radial shape (I={i_n}, "
            f"D={d_n}, K={k_n}, {iters} sweeps + next road, a captured "
            f"refresh): kernel {kern1:.4f} / {kern2:.4f} ms per call, plain "
            f"{plain1:.4f} / {plain2:.4f} (plain, kernel, kernel, plain; "
            f"CUDA events), device {fmt_us(dev_ms)} in {acts:.1f} kernels "
            f"(torch.profiler); bound {bound[0]:.4f} ms by {bound[1]}; the "
            f"uncapped table init from the cold start {cold_ms:.4f} ms, "
            f"device {fmt_us(cold_dev)} in {cold_acts:.1f} kernels; "
            f"{bf._global_fit(dev)} blocks of the global kernel at once "
            f"({card})")

    policy = make_policy("dijkstra", routing, network=net, dest_inters=dest)

    def periodic(state, n):
        return run_episode_periodic(state, net, policy, n, sim=sim_ex)

    before = relax_counts()
    ex = headline_run(net, agents, sim_ex, policy, ticks=exact_ticks,
                      warmup=warmup, capture_every=exact_ticks,
                      runner=periodic)
    ex_relax = {k: v - before[k] for k, v in relax_counts().items()
                if k != "host_reads"}
    if (ex["on_road"] != ex["on_way"]
            or ex["done"] + ex["on_way"] > agents.num_agents - 1):
        raise AssertionError(f"radial exact row conservation: "
                             f"{ex['on_road']} on roads, {ex['on_way']} on "
                             f"the way, {ex['done']} done")
    if on_card and (ex["launches"]["K1"] != exact_ticks
                    or ex["launches"]["choice"] != 0
                    or ex_relax["global"] != exact_ticks // 10 + 1):
        raise AssertionError(f"radial exact row: launches {ex['launches']}, "
                             f"relax {ex_relax}")
    # With escalation the windowed insert's monitor counts its extra
    # passes, the escalation that makes the row exact; exact means equal
    # to the whole-population insert, bitwise, which is held here.
    sim_whole = dataclasses.replace(sim_ex, insert_window=None)
    t0 = time.perf_counter()
    whole = init_sim_state(net, agents, sim=sim_whole, policy=policy)
    whole, _ = run_episode_periodic(whole, net, policy, exact_ticks,
                                    sim=sim_whole)
    sync_dev()
    whole_wall = time.perf_counter() - t0
    mismatched = [p for p in _diff_paths(_state_bits(ex["final"]),
                                         _state_bits(whole))
                  if p != "state.insert_ptr"]
    if mismatched:
        raise AssertionError(f"radial exact row and the whole-population "
                             f"insert differ at tick {exact_ticks}: "
                             f"{mismatched}")
    log(f"radial exact row (both escalations), {exact_ticks} ticks: "
        f"{ex['rate']:.1f} agent-steps/s ({ex['measured']} ticks in "
        f"{ex['wall']:.2f} s, {ex['wall'] / ex['measured'] * 1e3:.3f} "
        f"ms/tick), done {ex['done']}, on the way {ex['on_way']}, "
        f"escalation passes (the monitor) {ex['overflow']}, host reads per "
        f"tick {ex['syncs_per_tick']:.3f}, launches {ex['launches']}, relax "
        f"{ex_relax}; its state at tick {exact_ticks} equals the "
        f"whole-population insert's bitwise (that run "
        f"{whole_wall / exact_ticks * 1e3:.3f} ms/tick) ({card})")
    return {"sp": sp, "errs": errs, "timed": timed, "i_n": i_n, "d_n": d_n,
            "k_n": k_n}


def _relax_bits(out):
    """The relax outputs as int32 views (bitwise comparison)."""
    import torch

    return [None if t is None else t.view(torch.int32) for t in out]


def assert_bitwise(label: str, pairs) -> float:
    """Each ``(name, got, want)`` of ``pairs`` equal bit for bit (``None``
    where the other is ``None``); the largest absolute difference."""
    import torch

    worst = 0.0
    for name, a, b in pairs:
        if (a is None) != (b is None):
            raise AssertionError(f"{label}: {name} missing")
        if a is None:
            continue
        diff = float((a.double() - b.double()).abs().max())
        worst = max(worst, diff)
        if a.shape != b.shape or not torch.equal(*_relax_bits((a, b))):
            raise AssertionError(f"{label}: kernel and plain differ in "
                                 f"{name} (max |diff| {diff})")
    return worst


def compare_next_roads(label: str, dist, cost, tables, want=None) -> float:
    """``primal_next_roads`` (the global form's next-road kernel) against
    the plain pass on a finished table, and ``want`` (a table's next roads
    made on the main path) against the plain pass where given: bitwise."""
    from tarl_tpu_torch.routing import bellman_ford as bf

    plain = bf._next_roads_plain(dist, *bf._slot_tables(cost, *tables),
                                 tables[0])
    pairs = [("primal_next_roads", bf.primal_next_roads(dist, cost, *tables),
              plain)]
    if want is not None:
        pairs.append(("the main path's next roads", want, plain))
    return assert_bitwise(label, pairs)


def compare_relax(cases, modes) -> float:
    """Kernel against plain on each ``(label, cost, tables, dist0)`` case in
    each ``(max_iters, relax_only)`` mode: bitwise on distances and next
    roads.  Returns the largest absolute difference (0 when all match)."""
    import torch

    from tarl_tpu_torch.routing import bellman_ford as bf

    worst = 0.0
    changed = {mode: False for mode in modes}
    for label, cost, tables, dist0 in cases:
        for iters, relax_only in modes:
            got = bf.primal_relax_next_roads(cost, *tables, dist0, iters,
                                             relax_only)
            want = bf.primal_relax_next_roads_plain(cost, *tables, dist0,
                                                    iters, relax_only)
            if dist0.device.type == "cuda":
                torch.cuda.synchronize()
            worst = max(worst, assert_bitwise(
                f"{label}, {iters} sweeps, relax_only={relax_only}",
                zip(("dist", "next road"), got, want)))
            changed[(iters, relax_only)] |= not torch.equal(got[0], dist0)
    if not all(changed.values()):
        raise AssertionError("a mode changed no input; the comparison "
                             "would be vacuous")
    return worst


def relax_tables(net):
    return (net.inter_out_road, net.inter_out_ok, net.road_to)


def grid64_relax_cases(net, captured, seeds=SP_RANDOM_STATES):
    """Phase 6's Grid64x64 inputs: the captured refresh inputs, seeded
    random costs warm-started from the free-flow table as a refresh would,
    and the tie-heavy cold start at free flow."""
    import numpy as np
    import torch

    from tarl_tpu_torch.routing import policies
    from tarl_tpu_torch.routing.bellman_ford import BIG

    tables = relax_tables(net)
    cases = [(f"refresh {j * SP_CAPTURE_EVERY}", c, tables, d)
             for j, (c, d) in enumerate(captured)]
    i_n = net.num_intersections
    ff = net.free_flow
    ff_dist = torch.as_tensor(policies._host_dijkstra(net), device=net.device)
    for seed in range(seeds):
        g = np.random.default_rng(seed)
        cost = ff * torch.as_tensor(
            g.uniform(1.0, 4.0, net.num_roads).astype(np.float32),
            device=net.device)
        dist0 = policies._warm_start(ff_dist, ff, cost)
        dist0.diagonal().fill_(0.0)
        cases.append((f"random {seed}", cost, tables, dist0))
    if not bool((ff == ff[0]).all()):
        raise AssertionError("grid roads differ in free flow: no tie case")
    cold = torch.full((i_n, i_n), BIG, device=net.device)
    cold.diagonal().fill_(0.0)
    cases.append(("ties, cold", ff.clone(), tables, cold))
    return cases


def big_dest_cases(net, dests=BIG_DESTS):
    """Phase 6's Grid128x128 (and Grid256x256) inputs: ``dests`` seeded
    destination columns, random costs, from the anchored cold start and
    from a random warm start."""
    import numpy as np
    import torch

    from tarl_tpu_torch.routing.bellman_ford import BIG

    g = np.random.default_rng(128)
    i_n, dev = net.num_intersections, net.device
    cols = torch.as_tensor(np.sort(g.choice(i_n, dests, replace=False)),
                           device=dev)
    anchor = torch.arange(i_n, device=dev)[:, None] == cols[None, :]
    cost = net.free_flow * torch.as_tensor(
        g.uniform(1.0, 4.0, net.num_roads).astype(np.float32), device=dev)
    warm = torch.as_tensor(
        g.uniform(0.0, 4000.0, (i_n, dests)).astype(np.float32), device=dev)
    tables = relax_tables(net)
    return [(f"I={i_n} cold", cost, tables,
             torch.where(anchor, 0.0, BIG).contiguous()),
            (f"I={i_n} warm", cost, tables,
             torch.where(anchor, 0.0, warm).contiguous())]


def time_per_call(fn, args, calls: int = TIMED_CALLS) -> float:
    """Milliseconds per call, CUDA events around back-to-back calls after a
    warm-up."""
    import torch

    for _ in range(10):
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def device_time_per_call(fn, args, calls: int = TIMED_CALLS,
                         attempts: int = 5) -> tuple:
    """The device's milliseconds per call, and its kernels and memsets per
    call, over ``calls`` back-to-back calls after a warm-up, from the
    device activities ``torch.profiler`` records: for each activity name,
    its mean duration times its whole number of occurrences per call.
    The profiler now and then drops activities from a window, or records
    none: a window whose count is not a whole number per call is taken
    again, up to ``attempts`` times, and the estimate above holds through
    a few drops (the count per call printed beside it shows them).
    ``(None, 0.0)`` where no window recorded anything: not measured."""
    per_name, acts = device_time_by_name(fn, args, calls, attempts)
    if per_name is None:
        return None, 0.0
    return sum(per_name.values()), acts


def device_time_by_name(fn, args, calls: int = TIMED_CALLS,
                        attempts: int = 5) -> tuple:
    """:func:`device_time_per_call`'s estimate per activity name: ``({name:
    ms per call}, activities per call)``, ``(None, 0.0)`` where nothing
    was recorded."""
    return name_times(device_activities(fn, args, calls, attempts), calls)


def name_times(activities, calls: int) -> tuple:
    """``({name: ms per call}, activities per call)`` of the ``(name, us)``
    records of ``calls`` calls: for each name, its mean duration times its
    whole number of occurrences per call; ``(None, 0.0)`` where there are
    none."""
    import collections

    if not activities:
        return None, 0.0
    by_name = collections.defaultdict(list)
    for name, us in activities:
        by_name[name].append(us)
    return ({name: sum(d) / len(d) * max(1, round(len(d) / calls)) / 1e3
             for name, d in by_name.items()}, len(activities) / calls)


def device_activities(fn, args, calls: int = TIMED_CALLS,
                      attempts: int = 5) -> list:
    """The device activities ``torch.profiler`` records over ``calls``
    back-to-back calls after a warm-up, ``(name, us)`` each, from the
    fullest of up to ``attempts`` windows (the first whose count is a
    whole number per call); empty where no window recorded anything."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(10):
        fn(*args)
    torch.cuda.synchronize()
    best = []
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn(*args)
            torch.cuda.synchronize()
        # The profiler's raw records: ``prof.events()`` would build the
        # host-side event tree first, tens of seconds for a plain
        # version's 200 calls of ~230 kernels.
        events = [(e.name(), e.duration_ns() / 1e3)
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() == torch.autograd.DeviceType.CUDA
                  and not e.is_hidden_event()]
        if len(events) > len(best):
            best = events
        if events and len(events) % calls == 0:
            break
    return best


def activity_kinds(activities, calls: int) -> dict:
    """Device activities per call by kind, as the benchmark's trace reader
    tells them apart: ``Memcpy ...`` a copy, ``Memset ...`` a memset,
    anything else a kernel."""
    kinds = {"kernel": 0, "memset": 0, "memcpy": 0}
    for name, _ in activities:
        kind = ("memcpy" if name.startswith("Memcpy") else
                "memset" if name.startswith("Memset") else "kernel")
        kinds[kind] += 1
    return {k: v / calls for k, v in kinds.items()}


def fmt_us(ms) -> str:
    """A device time in microseconds, or "not measured"."""
    return "not measured" if ms is None else f"{ms * 1e3:.3f} us"


# --- the headline episode (phases 2 and 13) --------------------------------

def headline_sim(fused_core: bool = False, ticks: int = HEADLINE_TICKS):
    """The headline's exact mode (``bench.py``'s first row)."""
    from tarl_tpu_torch.config import SimConfig

    return SimConfig(
        timestep=1, start_time=6 * 3600, end_time=6 * 3600 + ticks,
        record_road_optimality=False, insert_window=32, insert_backlog=256,
        withdraw_depth=2, sorted_population=True, insert_escalate=True,
        withdraw_escalate=True, fused_core=fused_core,
    )


def headline_run(net, agents, sim, policy, payload=None,
                 ticks=HEADLINE_TICKS, warmup=WARMUP_TICKS,
                 capture_every=CAPTURE_EVERY, runner=None) -> dict:
    """The headline episode through ``run_episode`` from a fresh state:
    ``warmup`` ticks, then runs ending at every multiple of
    ``capture_every``, timed from the end of the warm-up to a synchronise.
    Launch counts are set to 0 just before the run and read just after.
    ``payload`` replaces the fused core's edge phase; ``runner(state, n) ->
    (state, logs)`` replaces ``run_episode`` (the sharded headline).
    Returns the state at each run's end, the logs of every tick and the
    numbers; :func:`check_headline` asserts."""
    import torch

    from tarl_tpu_torch.core import fused_core, sync
    from tarl_tpu_torch.core.step import (
        average_travel_time, init_sim_state, run_episode)
    from tarl_tpu_torch.state import TickLog

    payload = payload or fused_core.fused_core_sample
    if runner is None:
        def runner(state, n):
            return run_episode(state, net, policy, n, sim=sim,
                               payload=payload)
    on_card = net.device.type == "cuda"
    state = init_sim_state(net, agents, sim=sim, policy=policy)
    if on_card:
        torch.cuda.synchronize()
    reset_counts()
    state, logs = runner(state, warmup)
    all_logs = [logs]
    if on_card:
        torch.cuda.synchronize()
    reads_before = sync.HOST_READS
    t0 = time.perf_counter()
    done_ticks, captured = warmup, []
    while done_ticks < ticks:
        n = min(capture_every - done_ticks % capture_every,
                ticks - done_ticks)
        state, logs = runner(state, n)
        all_logs.append(logs)
        done_ticks += n
        captured.append(state)
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    measured = ticks - warmup
    logs = TickLog(*(torch.cat([getattr(lg, f) for lg in all_logs])
                     for f in TickLog._fields))
    return {
        "captured": captured, "final": state, "logs": logs,
        "overflow": float(logs.window_saturated.sum()),
        "wall": wall, "measured": measured, "launches": launches,
        "rate": agents.num_agents * measured / wall,
        "syncs_per_tick": (sync.HOST_READS - reads_before) / measured,
        "on_road": int(state.road.count.sum()),
        "on_way": int(state.agents.on_way.sum()),
        "done": int(state.agents.done.sum()),
        "avg_tt": float(average_travel_time(state.agents)),
    }


def check_headline(res, label: str, want_launches: dict) -> None:
    """A headline run's asserts: overflow monitor 0, conservation,
    arrivals, a finite average travel time and the launch counts."""
    import numpy as np

    if res["overflow"] != 0.0:
        raise AssertionError(f"{label}: overflow monitor read "
                             f"{res['overflow']}, not 0")
    if res["on_road"] != res["on_way"]:
        raise AssertionError(f"{label}: conservation: {res['on_road']} on "
                             f"roads, {res['on_way']} inserted and not done")
    if res["done"] <= 0:
        raise AssertionError(f"{label}: no agent arrived")
    if not (np.isfinite(res["avg_tt"]) and res["avg_tt"] > 0):
        raise AssertionError(f"{label}: average travel time {res['avg_tt']}")
    got = {k: res["launches"][k] for k in want_launches}
    if got != want_launches:
        raise AssertionError(f"{label}: launches {got}, expected "
                             f"{want_launches}")


class CapturePayload:
    """The fused core's edge phase through K12's fused entry, keeping a
    copy of the inputs of every ``every``-th call (the last tick of each
    run of :func:`headline_run`): ``(label, net, road, sel, time,
    key)``."""

    def __init__(self, every: int):
        self.every, self.calls, self.inputs = every, 0, []

    def __call__(self, road, sel, net, time_now, key, physics):
        from tarl_tpu_torch.core import fused_core
        from tarl_tpu_torch.state import RoadState

        self.calls += 1
        if self.calls % self.every == 0:
            self.inputs.append((f"tick {self.calls}", net,
                                RoadState(*(t.clone() for t in road)),
                                sel.clone(), time_now, key))
        return fused_core.fused_core_sample(road, sel, net, time_now, key,
                                            physics)


class CaptureWinner:
    """The road-block winner (K7) through its kernel wrapper, keeping a
    copy of the inputs of every ``every``-th call."""

    def __init__(self, every: int, label: str):
        self.every, self.label, self.calls, self.inputs = every, label, 0, []

    def __call__(self, *args):
        from tarl_tpu_torch.core import fused_winner

        self.calls += 1
        if self.calls % self.every == 0:
            self.inputs.append((f"{self.label} tick {self.calls}",
                                tuple(a.clone() if hasattr(a, "clone") else a
                                      for a in args)))
        return fused_winner.fused_shard_winner(*args)


def shard_winner_args(net, road, sel, t_now, key, blocks, physics):
    """K7's arguments for one device holding all ``blocks`` road blocks of
    ``net``, built from a ring state as the sharded tick builds them: the
    padded halo vectors and packed words, the direction key, the blocks'
    ``ShardTables`` (in-slot columns, capacities, ``road_order``) and
    float32 counts."""
    import torch

    from tarl_tpu_torch.core.direction import (pack_upstream,
                                               upstream_pack_layout)
    from tarl_tpu_torch.core.fused_winner import ShardTables

    r, nmax = net.num_roads, net.nmax
    rp = -(-r // blocks) * blocks

    def pad(x, fill):
        tail = torch.full((rp - r,) + tuple(x.shape[1:]), fill,
                          dtype=x.dtype, device=x.device)
        return torch.cat([x, tail])

    def cols(x, fill):
        return pad(x.t(), fill).t().contiguous()

    s = sel[:r]
    sel_enc = pad(torch.where((s >= 0) & (s < r), s, r), r)
    count = pad(road.count, 0)
    cap = pad(net.capacity, 0.0)
    pack = pack_upstream(pad(road.head_departure(), 0.0), count, cap,
                         sel_enc, t_now, physics, r, nmax)
    tables = ShardTables(in_src=cols(net.in_src_tab, 0),
                         in_logit=cols(net.in_logit_tab, 0.0),
                         in_ok=cols(net.in_edge_ok, False), capacity=cap,
                         road_order=net.road_order)
    return (pack, pad(road.head_ids(), 0), pad(road.head_dests(), 0), key,
            tables, count.to(torch.float32), 0, rp, physics,
            upstream_pack_layout(r, nmax))


def last_block(args, blocks: int):
    """``args`` of a whole device's K7 launch cut to its last block."""
    from tarl_tpu_torch.core.fused_winner import ShardTables

    pack, hid, hdst, key, tables, count_f, col0, rp, phys, layout = args
    n = count_f.shape[0]
    rl = n // blocks
    cut = slice(n - rl, n)
    local = ShardTables(
        *(t[:, cut].contiguous()
          for t in (tables.in_src, tables.in_logit, tables.in_ok)),
        capacity=tables.capacity[cut].contiguous(),
        road_order=tables.road_order)
    return (pack, hid, hdst, key, local, count_f[cut].contiguous(),
            col0 + n - rl, rp, phys, layout)


def compare_shard_winner(cases) -> int:
    """K7 against its plain version on the card, bitwise on all four
    outputs, for each ``(label, args, blocks)`` case and for its last
    block alone.  Returns the largest absolute difference (0 when all
    match)."""
    import torch

    from tarl_tpu_torch.core import fused_winner

    worst = 0
    for label, args, blocks in cases:
        for part, a in (("all blocks", args),
                        ("last block", last_block(args, blocks))):
            got = fused_winner.fused_shard_winner(*a)
            want = fused_winner.fused_shard_winner_plain(*a)
            if a[0].device.type == "cuda":
                torch.cuda.synchronize()
            for name, x, y in zip(("accept", "win", "agent", "dest"), got,
                                  want):
                diff = int((x.to(torch.int64) - y.to(torch.int64)).abs()
                           .max())
                worst = max(worst, diff)
                if x.dtype != y.dtype or not torch.equal(x, y):
                    raise AssertionError(f"K7 {label}, {part}: kernel and "
                                         f"plain differ in {name} (max "
                                         f"|diff| {diff})")
            if a is args and not bool(got[0].any()):
                raise AssertionError(f"K7 {label}: no transfer accepted; "
                                     "the comparison would be vacuous")
    return worst


def k7_bound_ms(args) -> tuple[float, str]:
    """K7's least time on these inputs and what bounds it: per road its
    count and capacity read and its four outputs written (8 + 13 bytes),
    every in-slot's valid flag (1 byte), each valid in-slot's source (4
    bytes), the packed word of each distinct source once (4 bytes), the
    logit and the column's ``road_order`` entry of the eligible in-slots
    only (8 bytes: the kernel reads them after the packed word's mask),
    and the winner's head id and dest (8 bytes a winning road), against
    the card's memory rate; ``K7_OPS_PER_SLOT`` operations for each valid
    in-slot and a threefry draw (``K12_OPS_PER_DRAW``) for each eligible
    one, against its float32 rate."""
    import torch

    from tarl_tpu_torch.core import fused_winner

    pack, tables, count_f, col0 = args[0], args[4], args[5], args[6]
    ok, src = tables.in_ok, tables.in_src
    n, valid = count_f.shape[0], int(ok.sum())
    sources = int(torch.unique(src[ok]).numel())
    eligible = int(fused_winner.shard_slot_mask(
        pack, tables, count_f, col0, *args[8:]).sum())
    wins = int(fused_winner.fused_shard_winner_plain(*args)[0].sum())
    by_bytes = (21 * n + ok.numel() + 4 * valid + 4 * sources + 8 * eligible
                + 8 * wins) / HBM_BYTES_PER_S
    by_ops = (K7_OPS_PER_SLOT * valid
              + K12_OPS_PER_DRAW * eligible) / F32_OPS_PER_S
    return (max(by_bytes, by_ops) * 1e3,
            "bytes" if by_bytes >= by_ops else "operations")


def hub_network(spokes: int, device):
    """A hub intersection with ``spokes`` two-way spokes (links as
    :func:`grid_network`'s): each road out of the hub has an incoming turn
    edge, and an in-slot, for every road into it."""
    import numpy as np

    from tarl_tpu_torch.network import build_network

    frm = [i for s in range(1, spokes + 1) for i in (s, 0)]
    to = [i for s in range(1, spokes + 1) for i in (0, s)]
    n = len(frm)
    return build_network(
        length=np.full(n, 200.0), max_flow=np.full(n, 600.0),
        free_speed=np.full(n, 13.9), perm_lanes=np.ones(n),
        from_inter=np.asarray(frm), to_inter=np.asarray(to),
        num_intersections=spokes + 1, device=device)


def grid_network(rows: int, cols: int, device, seed=None):
    """``grid_scenario``'s ``rows x cols`` network (links of 200 m, 600
    veh/h, 13.9 m/s, one lane, in its link order) built from the link
    arrays through ``build_network``: no XML, no population.  With
    ``seed``, the intersections are relabelled by a seeded permutation, so
    that a row's successors lie anywhere in the order."""
    import numpy as np

    from tarl_tpu_torch.network import build_network

    frm, to = [], []
    for r in range(rows):
        for c in range(cols):
            k = r * cols + c
            if c + 1 < cols:
                frm += [k, k + 1]
                to += [k + 1, k]
            if r + 1 < rows:
                frm += [k, k + cols]
                to += [k + cols, k]
    frm, to = np.asarray(frm), np.asarray(to)
    if seed is not None:
        label = np.random.default_rng(seed).permutation(rows * cols)
        frm, to = label[frm], label[to]
    n = len(frm)
    return build_network(
        length=np.full(n, 200.0), max_flow=np.full(n, 600.0),
        free_speed=np.full(n, 13.9), perm_lanes=np.ones(n),
        from_inter=frm, to_inter=to, num_intersections=rows * cols,
        device=device)


def random_payload_cases(nets, dev) -> list:
    """Seeded K12 inputs ``(label, logits, ids, pay_a, pay_b, key, n)``:
    each network's turn-edge list with random logits (30% -inf, a third of
    the rest rounded to exact ties), random agents and the edge sources as
    payloads; and random ids over 40,000 segments of which a third receive
    no element."""
    import numpy as np
    import torch

    from tarl_tpu_torch.core import rng

    g = np.random.default_rng(12)

    def logits_for(e):
        x = g.normal(size=e).astype(np.float32)
        x[::3] = np.round(x[::3] * 2.0) / 2.0
        x[g.random(e) < 0.3] = -np.inf
        return torch.as_tensor(x, device=dev)

    def t(a):
        return torch.as_tensor(a, device=dev)

    cases = []
    for i, (label, net) in enumerate(nets):
        e = net.edge_dst.shape[0]
        cases.append((f"{label} edges (E={e})", logits_for(e), net.edge_dst,
                      t(g.integers(1, 1 << 30, e).astype(np.int32)),
                      net.edge_src, rng.prng_key(3000 + i), net.num_roads))
    e, n = 100_000, 40_000
    live = g.choice(n, size=2 * n // 3, replace=False)
    ids = t(live[g.integers(0, live.size, e)].astype(np.int32))
    cases.append((f"random ids (E={e}, {n} segments)", logits_for(e), ids,
                  t(g.integers(1, 1 << 30, e).astype(np.int32)),
                  t(g.integers(0, n, e).astype(np.int32)),
                  rng.prng_key(3100), n))
    return cases


def compare_payload(cases) -> int:
    """K12 against its plain version on the same device, bitwise on both
    payloads, for each ``(label, logits, ids, pay_a, pay_b, key, n)``
    case.  Returns the largest absolute difference (0 when all match)."""
    import torch

    from tarl_tpu_torch.core import fused_core
    from tarl_tpu_torch.ops.segment import segment_layout

    worst = 0
    for label, logits, ids, pay_a, pay_b, key, n in cases:
        got = fused_core.gumbel_argmax_payload(
            logits, ids, pay_a, pay_b, key, n, segment_layout(ids, n))
        want = fused_core.gumbel_argmax_payload_plain(logits, ids, pay_a,
                                                      pay_b, key, n)
        if logits.device.type == "cuda":
            torch.cuda.synchronize()
        for name, a, b in zip(("a", "b"), got, want):
            diff = int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
            worst = max(worst, diff)
            if a.dtype != b.dtype or not torch.equal(a, b):
                raise AssertionError(f"K12 {label}: kernel and plain differ "
                                     f"in payload {name} (max |diff| "
                                     f"{diff})")
        if not bool((got[0] != 0).any()) or bool((got[0] != 0).all()):
            raise AssertionError(f"K12 {label}: every segment or none has a "
                                 "winner; the comparison would be vacuous")
    return worst


def bare_payload_cases(states, physics) -> list:
    """The bare K12's inputs ``(label, logits, ids, pay_a, pay_b, key,
    n)`` on fused-entry states ``(label, net, road, sel, time, key)``: the
    edge logits the fused entry computes, the upstreams' head agents and
    the upstreams."""
    from tarl_tpu_torch.core import fused_core

    out = []
    for label, net, road, sel, t_now, key in states:
        logits = fused_core.edge_logits(road, sel, net, t_now, physics)
        out.append((f"{label} logits", logits, net.edge_dst,
                    road.head_ids()[net.edge_src.long()], net.edge_src, key,
                    net.num_roads))
    return out


def compare_fused_sample(cases, physics) -> int:
    """K12's fused entry against its plain version on the same device,
    bitwise on both payloads, for each ``(label, net, road, sel, time,
    key)`` case.  Returns the largest absolute difference (0 when all
    match)."""
    import torch

    from tarl_tpu_torch.core import fused_core

    worst = 0
    for label, net, road, sel, t_now, key in cases:
        got = fused_core.fused_core_sample(road, sel, net, t_now, key,
                                           physics)
        want = fused_core.fused_core_sample_plain(road, sel, net, t_now, key,
                                                  physics)
        if road.count.device.type == "cuda":
            torch.cuda.synchronize()
        for name, a, b in zip(("agent", "src"), got, want):
            diff = int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
            worst = max(worst, diff)
            if a.dtype != b.dtype or not torch.equal(a, b):
                raise AssertionError(f"K12 fused {label}: kernel and plain "
                                     f"differ in {name} (max |diff| "
                                     f"{diff})")
        if not bool((got[0] != 0).any()) or bool((got[0] != 0).all()):
            raise AssertionError(f"K12 fused {label}: every road or none has "
                                 "a winner; the comparison would be "
                                 "vacuous")
    return worst


def k12_fused_bound_ms(net, road, sel, t_now, key,
                       physics) -> tuple[float, str]:
    """K12's fused entry's least time on these inputs and what bounds it:
    per turn edge its source, weight and CSR order (12 bytes); the road
    fields of each distinct source once (count, selection, capacity, head
    slot, head departure: 20 bytes); per downstream road its count,
    capacity and offset (12 bytes) and its two outputs (8 bytes); the head
    agent of each winning road (4 bytes); against the card's memory rate.
    ``K12_OPS_PER_EDGE`` operations for each edge and a draw
    (``K12_OPS_PER_DRAW``) for each eligible one, against its float32
    rate."""
    import torch

    from tarl_tpu_torch.core import fused_core

    e, r = net.edge_src.shape[0], net.num_roads
    sources = int(torch.unique(net.edge_src).numel())
    logits = fused_core.edge_logits(road, sel, net, t_now, physics)
    draws = int(torch.isfinite(logits).sum())
    wins = int((fused_core.fused_core_sample_plain(
        road, sel, net, t_now, key, physics)[0] != 0).sum())
    by_bytes = (12 * e + 20 * sources + 20 * r + 4 + 4 * wins) \
        / HBM_BYTES_PER_S
    by_ops = (K12_OPS_PER_EDGE * e + K12_OPS_PER_DRAW * draws) \
        / F32_OPS_PER_S
    return (max(by_bytes, by_ops) * 1e3,
            "bytes" if by_bytes >= by_ops else "operations")


def k12_bound_ms(logits, ids, n: int) -> tuple[float, str]:
    """K12's least time on these inputs and what bounds it: the logits and
    the CSR order read once (8 bytes an edge), the offsets read once, the
    two payloads read for each segment's winner only (8 bytes a segment
    with a drawing edge), both payload rows written once (8 bytes a
    segment), against the card's memory rate; ``K12_OPS_PER_DRAW``
    operations for each edge this run draws for (finite logit above
    NEG_LARGE), against its float32 rate."""
    import torch

    from tarl_tpu_torch.ops.segment import NEG_LARGE

    e = logits.shape[0]
    drawn = (logits > NEG_LARGE) & (logits < float("inf"))
    draws = int(drawn.sum())
    winners = int(torch.unique(ids[drawn]).numel())
    by_bytes = (8 * e + 4 * (n + 1) + 8 * winners + 8 * n) / HBM_BYTES_PER_S
    by_ops = K12_OPS_PER_DRAW * draws / F32_OPS_PER_S
    return (max(by_bytes, by_ops) * 1e3,
            "bytes" if by_bytes >= by_ops else "operations")


def time_pair(kernel, plain, args, calls: int = TIMED_CALLS) -> tuple:
    """ms per call of a kernel wrapper and its plain version, timed plain,
    kernel, kernel, plain."""
    p1 = time_per_call(plain, args, calls)
    k1 = time_per_call(kernel, args, calls)
    k2 = time_per_call(kernel, args, calls)
    p2 = time_per_call(plain, args, calls)
    return p1, k1, k2, p2


# --- the learned policy (phases 8-12) ---------------------------------------

def learned_ppo(net, collect_steps: int = COLLECT_STEPS):
    """A ``PPO`` with ``scripts/train_rl_demo.py``'s Grid8x8 settings: the
    prior-equipped edge-MLP policy and the simple critic."""
    from tarl_tpu_torch.config import RLConfig
    from tarl_tpu_torch.models.mpnn import MPNNPolicyNet, MPNNValueNetSimple
    from tarl_tpu_torch.rl.ppo import PPO

    rl = RLConfig(rollout_steps=collect_steps, minibatch_size=128,
                  num_epochs=5, entropy_coef=0.003, learning_rate=1e-3,
                  reward_mode="progress", gamma=0.98, gae_lambda=0.9)
    policy = MPNNPolicyNet(net.num_nodes, net.num_roads + 1,
                           use_distance_prior=True, prior_scale=PRIOR_SCALE)
    return PPO(net, policy, MPNNValueNetSimple(net.num_nodes), rl=rl)


class Capture:
    """Segment ops that go through the kernel wrappers and keep a copy of
    the inputs of every ``every``-th call of the action and the log-prob,
    as ``(logits, ids, n, temperature, key)`` and ``(logits, action, ids,
    n, temperature)`` (the learned paths call no bare sum, max or
    argmax)."""

    def __init__(self, every: int):
        from tarl_tpu_torch.ops import segment as seg

        names = ("action", "log_prob")
        self.every = every
        self.calls = {name: 0 for name in names}
        self.inputs = {name: [] for name in names}
        self.ops = seg.KERNELS._replace(
            action=self._wrap("action", seg.segment_action, 0),
            log_prob=self._wrap("log_prob", seg.segment_log_prob, 1))

    def _wrap(self, name, fn, at):
        """``fn`` keeping its inputs but the layout, which follows the
        ids at position ``at + 1``."""
        import torch

        def op(*args):
            if self.calls[name] % self.every == 0:
                kept = args[:at + 3] + args[at + 4:]
                self.inputs[name].append(tuple(
                    a.clone() if isinstance(a, torch.Tensor) and i <= at
                    else a for i, a in enumerate(kept)))
            self.calls[name] += 1
            return fn(*args)
        return op


def counts() -> dict:
    from tarl_tpu_torch.core import fused_core, fused_winner
    from tarl_tpu_torch.ops import segment as seg
    from tarl_tpu_torch.routing import policies

    return {"K1": fused_winner.LAUNCHES, "K9": seg.SUM_LAUNCHES,
            "K10": seg.MAX_LAUNCHES, "K11": seg.ARGMAX_LAUNCHES,
            "K12": fused_core.LAUNCHES, "K7": fused_winner.SHARD_LAUNCHES,
            "choice": policies.LAUNCHES}


def reset_counts() -> None:
    from tarl_tpu_torch.core import fused_core, fused_winner, sync
    from tarl_tpu_torch.ops import segment as seg
    from tarl_tpu_torch.routing import policies

    fused_winner.reset_launches()
    fused_core.reset_launches()
    seg.reset_launches()
    policies.reset_launches()
    sync.reset()


def check_eval(env, agents_total: int, steps: int, launches: dict,
               label: str, want_done=None, max_att=None,
               on_card: bool = True, min_done=None) -> dict:
    """Asserts of an evaluation run: conservation, agents on the network
    or arrived, ``want_done`` (or at least ``min_done``) arrivals and an
    average travel time below ``max_att`` where given, and on the card one
    K1 and one K11 launch per step and no K7/K9/K10/K12; returns the
    outcome."""
    from tarl_tpu_torch.core.step import average_travel_time

    a = env.sim.agents
    on_road = int(env.sim.road.count.sum())
    on_way = int(a.on_way.sum())
    done = int(a.done.sum())
    att = float(average_travel_time(a))
    if on_road != on_way:
        raise AssertionError(f"{label}: conservation: {on_road} on roads, "
                             f"{on_way} inserted and not done")
    if done + on_road <= 0:
        raise AssertionError(f"{label}: no agent entered the network")
    if want_done is not None and done != want_done:
        raise AssertionError(f"{label}: {done} done, expected {want_done}")
    if min_done is not None and done < min_done:
        raise AssertionError(f"{label}: {done} done, expected at least "
                             f"{min_done}")
    if max_att is not None and not att < max_att:
        raise AssertionError(f"{label}: average travel time {att} s, not "
                             f"below {max_att} s")
    want = {"K1": steps, "K11": steps, "K9": 0, "K10": 0, "K12": 0, "K7": 0,
            "choice": 0}
    if on_card and launches != want:
        raise AssertionError(f"{label}: launches {launches}, expected "
                             f"{want}")
    return {"done": done, "on_road": on_road, "att": att,
            "time": float(env.sim.time), "agents": agents_total}


def random_segment_cases(dev):
    """Seeded ``(label, data, ids, n, card_ref)`` cases on the card: empty
    segments, +-inf, NaN, out-of-range ids, exact ties, 100,000 segments,
    and ties of -0.0 with +0.0.  ``card_ref`` is false for the last: the
    plain max on the card resolves a +-0 tie in its atomics' order, so that
    case is held against the plain version on the CPU only, whose
    sequential max keeps the first value, as the kernel's strict ``>``
    does."""
    import numpy as np
    import torch

    g = np.random.default_rng(11)
    cases = []
    for i, (e, n) in enumerate([(1256, 352), (5000, 4000), (700, 37),
                                (300000, 100000), (64, 1000)]):
        data = g.normal(size=e).astype(np.float32)
        if i % 2 == 0:
            # Exact ties; the shift leaves no -0.0 (see the last case).
            data = np.round(data * 2.0) / 2.0 + 0.25
        ids = g.integers(-2, n + 2, size=e).astype(np.int32)
        k = g.integers(0, e, size=6)
        data[k[:2]], data[k[2:4]], data[k[4]] = np.inf, -np.inf, np.nan
        cases.append((f"random {e}x{n}", torch.as_tensor(data, device=dev),
                      torch.as_tensor(ids, device=dev), n, True))
    e, n = 1256, 352
    zeros = np.where(g.random(e) < 0.5, np.float32(-0.0), np.float32(0.0))
    data = np.where(g.random(e) < 0.8, zeros,
                    np.float32(-1.0)).astype(np.float32)
    ids = g.integers(0, n, size=e).astype(np.int32)
    cases.append((f"signed-zero ties {e}x{n}",
                  torch.as_tensor(data, device=dev),
                  torch.as_tensor(ids, device=dev), n, False))
    return cases


def compare_segments(cases) -> dict:
    """Each segment kernel against its plain version on a CPU copy of the
    inputs, bitwise (NaN bits included); max and argmax also against the
    plain version on the card where the case's ``card_ref`` is true.  The
    sum takes the finite part of the data (a sum with inf is not a
    comparison of the adds).  Returns the largest absolute difference per
    kernel (0 when all match)."""
    import torch

    from tarl_tpu_torch.ops import segment as seg

    worst = {"sum": 0.0, "max": 0.0, "argmax": 0.0}
    pairs = {"sum": (seg.segment_sum, seg.segment_sum_plain),
             "max": (seg.segment_max, seg.segment_max_plain),
             "argmax": (seg.segment_argmax, seg.segment_argmax_plain)}
    for label, data, ids, n, card_ref in cases:
        layout = seg.segment_layout(ids, n)
        for name, (fn, plain) in pairs.items():
            x = (torch.where(torch.isfinite(data), data, 0.0)
                 if name == "sum" else data)
            got = fn(x, ids, n, layout)
            torch.cuda.synchronize()
            refs = [("CPU", plain(x.cpu(), ids.cpu(), n))]
            if name != "sum" and card_ref:
                refs.append(("card", plain(x, ids, n).cpu()))
            for where, want in refs:
                g = got.cpu()
                diff = float((g.double() - want.double()).abs().nan_to_num(
                    0.0).max()) if g.numel() else 0.0
                worst[name] = max(worst[name], diff)
                if not torch.equal(g.view(torch.int32),
                                   want.view(torch.int32)):
                    raise AssertionError(f"{label}: segment {name} kernel "
                                         f"and plain on the {where} differ "
                                         f"(max |diff| {diff})")
    return worst


def segment_bound_ms(e: int, n: int) -> float:
    """The least time for one segment reduction: E data and E ids read, N
    results written, against the card's memory rate (the E adds or
    compares take far less at the float32 rate)."""
    return max((8 * e + 4 * n) / HBM_BYTES_PER_S,
               e / F32_OPS_PER_S) * 1e3


def time_segments(data, ids, n) -> dict:
    """ms per call of each segment kernel, its plain version and the
    library call, plain, kernel, kernel, plain (CUDA events); and the
    device time per call of the kernel and the library call
    (``torch.profiler``)."""
    import torch

    from tarl_tpu_torch.ops import segment as seg

    layout = seg.segment_layout(ids, n)
    key = ids.long()
    expd = torch.exp(data - data.max())

    def lib_sum(x):
        return torch.zeros(n, device=x.device).index_add_(0, key, x)

    def lib_max(x):
        return torch.full((n,), seg.NEG_LARGE, device=x.device) \
            .scatter_reduce_(0, key, x, "amax")

    out = {}
    for name, fn, plain, lib, x in (
            ("sum", seg.segment_sum, seg.segment_sum_plain, lib_sum, expd),
            ("max", seg.segment_max, seg.segment_max_plain, lib_max, data),
            ("argmax", seg.segment_argmax, seg.segment_argmax_plain, None,
             data)):
        args = (x, ids, n, layout)
        p1, k1, k2, p2 = time_pair(fn, plain, args)
        dev_ms, acts = device_time_per_call(fn, args)
        lib_ms = lib_dev = None
        if lib is not None:
            lib_ms = time_per_call(lib, (x,))
            lib_dev, _ = device_time_per_call(lib, (x,))
        out[name] = {"ms": min(k1, k2), "plain_ms": min(p1, p2),
                     "device_ms": dev_ms, "device_acts": acts,
                     "library_ms": lib_ms, "library_device_ms": lib_dev,
                     "all": (p1, k1, k2, p2)}
    return out


def argmax_inputs(actions, key0: int) -> list:
    """The bare argmax's inputs that the captured action inputs ``(logits,
    ids, n, temperature, key)`` stand for: the scaled logits (the mode's
    scores) and, with a fresh key each, those plus the key's noise where
    finite (the sample's).  ``(data, ids, n)`` each."""
    import torch

    from tarl_tpu_torch.core import rng
    from tarl_tpu_torch.ops import segment as seg

    out = []
    for i, (logits, ids, n, temperature, _) in enumerate(actions):
        x = seg.scale_logits(logits, temperature)
        g = rng.gumbel(rng.prng_key(key0 + i), tuple(x.shape), x.device)
        out += [(x, ids, n),
                (torch.where(torch.isfinite(x), x + g, float("-inf")), ids,
                 n)]
    return out


def random_action_cases(dev) -> list:
    """Seeded ``(label, logits, ids, n, temperature)`` cases of K11's
    action entry on the card: temperatures other than 1, +-inf and NaN
    logits, segments of only -inf, empty segments, out-of-range ids and
    exact ties; one case of 100,000 segments."""
    import numpy as np
    import torch

    g = np.random.default_rng(81)
    cases = []
    for i, (e, n, t) in enumerate([(1256, 352, 0.7), (3656, 960, 1.0),
                                   (5000, 4000, 1.3), (700, 37, 0.25),
                                   (300000, 100000, 0.9)]):
        logits = (g.normal(size=e) * 3.0).astype(np.float32)
        if i % 2 == 0:
            logits = (np.round(logits * 2.0) / 2.0).astype(np.float32)
        ids = g.integers(-2, n + 2, size=e).astype(np.int32)
        k = g.integers(0, e, size=9)
        logits[k[:3]], logits[k[3:6]], logits[k[6:]] = np.inf, -np.inf, np.nan
        logits[ids == 1] = -np.inf
        cases.append((f"random {e}x{n}, t={t}",
                      torch.as_tensor(logits, device=dev),
                      torch.as_tensor(ids, device=dev), n, t))
    return cases


def compare_actions(cases, key0: int) -> tuple[float, int]:
    """K11's action entry against ``segment_action_plain`` on the card and
    on a CPU copy, bitwise, on each ``(label, logits, ids, n,
    temperature)`` case in both modes (the sample with a fresh key).
    Returns the most elements of one call that differ (0 when all match)
    and the calls compared."""
    import torch

    from tarl_tpu_torch.core import rng
    from tarl_tpu_torch.ops import segment as seg

    worst, calls = 0, 0
    for i, (label, logits, ids, n, t) in enumerate(cases):
        layout = seg.segment_layout(ids, n)
        for key in (None, rng.prng_key(key0 + i)):
            got = seg.segment_action(logits, ids, n, layout, t, key)
            torch.cuda.synchronize()
            if not bool(got.any()):
                raise AssertionError(f"{label}: an empty action; the "
                                     "comparison would be vacuous")
            for where, want in (
                    ("card", seg.segment_action_plain(logits, ids, n, None,
                                                      t, key)),
                    ("CPU", seg.segment_action_plain(logits.cpu(),
                                                     ids.cpu(), n, None, t,
                                                     key))):
                diff = int((got.cpu() != want.cpu()).sum())
                worst = max(worst, diff)
                if diff:
                    raise AssertionError(
                        f"{label}, key {key}: segment_action and its plain "
                        f"version on the {where} differ in {diff} elements")
            calls += 1
    return float(worst), calls


def action_bound_ms(logits, ids, n: int, temperature: float,
                    drawn: bool) -> tuple[float, str]:
    """The action entry's least time on these inputs and what bounds it:
    the logits and the CSR order read once (8 bytes an element), the
    offsets once, the bool action written once (1 byte an element), against
    the card's memory rate; a division and a compare for each element of a
    segment, and ``K12_OPS_PER_DRAW`` for each finite scaled logit that
    the sample draws for, against its float32 rate."""
    import torch

    from tarl_tpu_torch.ops import segment as seg

    e = logits.shape[0]
    in_range = int(((ids >= 0) & (ids < n)).sum())
    draws = (int(torch.isfinite(seg.scale_logits(logits, temperature)).sum())
             if drawn else 0)
    by_bytes = (9 * e + 4 * (n + 1)) / HBM_BYTES_PER_S
    by_ops = (2 * in_range + K12_OPS_PER_DRAW * draws) / F32_OPS_PER_S
    return (max(by_bytes, by_ops) * 1e3,
            "bytes" if by_bytes >= by_ops else "operations")


def time_actions(logits, ids, n, temperature, key) -> dict:
    """ms per call of K11's action entry and of the parent's composed
    path (``PLAIN.action`` on the card), plain, kernel, kernel, plain,
    in both modes, with the device time and kernels per call of each
    (``torch.profiler``) and the entry's bound."""
    from tarl_tpu_torch.ops import segment as seg

    layout = seg.segment_layout(ids, n)
    out = {}
    for mode, k in (("mode", None), ("sample", key)):
        args = (logits, ids, n, layout, temperature, k)
        p1, k1, k2, p2 = time_pair(seg.segment_action,
                                   seg.segment_action_plain, args)
        dev_ms, acts = device_time_per_call(seg.segment_action, args)
        plain_dev, plain_acts = device_time_per_call(
            seg.segment_action_plain, args)
        out[mode] = {"ms": min(k1, k2), "plain_ms": min(p1, p2),
                     "device_ms": dev_ms, "device_acts": acts,
                     "plain_device_ms": plain_dev,
                     "plain_device_acts": plain_acts,
                     "bound": action_bound_ms(logits, ids, n, temperature,
                                              k is not None),
                     "all": (p1, k1, k2, p2)}
    return out


def bare_log_prob_inputs(log_probs) -> list:
    """The bare max's and sums' inputs that the captured log-prob inputs
    ``(logits, action, ids, n, temperature)`` stand for in the parent's
    composition: the scaled logits (the max), the shifted exponentials
    (the denominators' sum), the action as float32 and ones (the per-group
    counts).  ``(data, ids, n)`` each."""
    import torch

    from tarl_tpu_torch.ops import segment as seg

    out = []
    for logits, action, ids, n, temperature in log_probs:
        x = seg.scale_logits(logits, temperature)
        m = seg.segment_max_plain(x, ids, n)
        m = torch.where(torch.isfinite(m), m, 0.0)
        act = action.to(torch.float32)
        out += [(x, ids, n), (torch.exp(x - m[ids.long()]), ids, n),
                (act, ids, n), (torch.ones_like(act), ids, n)]
    return out


def _one_per_segment(g, logits, ids):
    """A bool[E] with one element of every non-empty segment, a finite
    logit where the segment has one (as the sampler picks), chosen by
    ``g``; and the elements in segment order (the chosen first)."""
    import numpy as np

    score = g.random(ids.shape[0]) + np.isfinite(logits)
    order = np.lexsort((-score, ids))
    first = np.r_[True, ids[order][1:] != ids[order][:-1]]
    hot = np.zeros(ids.shape[0], dtype=bool)
    hot[order[first]] = True
    return hot, order, first


def random_log_prob_cases(dev) -> list:
    """Seeded ``(label, logits, action, ids, n, temperature)`` cases of
    K10's entry on the card, every id in range: temperatures 0.25-1.3,
    exact ties, +-inf, a segment of only -inf, NaN, empty segments; each
    with no action (the log-softmax), a valid action, two hot in a
    segment, none hot, one segment missing and a zero-probability element
    active; one case of 100,000 segments."""
    import numpy as np
    import torch

    g = np.random.default_rng(91)
    cases = []
    for i, (e, n, t) in enumerate([(1256, 352, 0.7), (3656, 960, 1.0),
                                   (5000, 4000, 1.3), (700, 37, 0.25),
                                   (300000, 100000, 0.9)]):
        logits = (g.normal(size=e) * 3.0).astype(np.float32)
        if i % 2 == 0:
            logits = (np.round(logits * 2.0) / 2.0).astype(np.float32)
        ids = g.integers(0, n, size=e).astype(np.int32)
        k = g.integers(0, e, size=6)
        logits[g.random(e) < 0.02] = -np.inf
        if i in (1, 3):
            logits[k[:3]] = np.inf
            logits[ids == 1] = -np.inf
        if i in (2, 3):
            logits[k[3:]] = np.nan
        valid, order, first = _one_per_segment(g, logits, ids)
        two = valid.copy()
        two[order[np.nonzero(~first)[0][0]]] = True
        missing = valid.copy()
        missing[order[np.nonzero(~first)[0][0] - 1]] = False
        zero_p = valid.copy()
        neg = np.nonzero(np.isneginf(logits[order]) & ~first)[0][0]
        zero_p[order[neg]] = True
        zero_p[order[np.nonzero(first[:neg + 1])[0][-1]]] = False
        tl, ti = (torch.as_tensor(logits, device=dev),
                  torch.as_tensor(ids, device=dev))
        for kind, hot in (("log-softmax", None), ("valid", valid),
                          ("two hot", two),
                          ("none hot", np.zeros(e, dtype=bool)),
                          ("one missing", missing),
                          ("zero-probability hot", zero_p)):
            act = None if hot is None else torch.as_tensor(hot, device=dev)
            cases.append((f"random {e}x{n}, t={t}, {kind}", tl, act, ti, n,
                          t))
    return cases


def _max_abs_diff(got, want) -> float:
    """The largest |got - want| over the elements where they differ
    (equal infinities and NaN beside NaN count as 0)."""
    import torch

    g, w = got.cpu().double(), want.cpu().double()
    same = (g == w) | (torch.isnan(g) & torch.isnan(w))
    d = torch.where(same, 0.0, (g - w).abs())
    return float(d.max()) if d.numel() else 0.0


def compare_log_probs(cases) -> dict:
    """K10's log-prob entry on each ``(label, logits, action, ids, n,
    temperature)`` case (``action`` None: the log-softmax form) against
    the parent's composition on the bare kernels bitwise (NaN bits
    included), and against the plain version on the card and on a CPU
    copy at rtol 1e-6, atol 1e-6 (the log-softmax) or rtol 1e-5, atol
    1e-5 (the joint).  Returns the largest absolute difference from the
    plain versions per form and the calls compared."""
    import torch

    from tarl_tpu_torch.ops import segment as seg

    worst = {"log_probs": 0.0, "log_prob": 0.0, "calls": 0}
    for label, logits, action, ids, n, t in cases:
        layout = seg.segment_layout(ids, n)
        if action is None:
            form, tol = "log_probs", 1e-6
            got = seg.segment_log_probs(logits, ids, n, layout, t)
            composed = seg.segment_log_probs_plain(logits, ids, n, layout, t,
                                                   seg.KERNELS)
            plain = [seg.segment_log_probs_plain(logits, ids, n, None, t),
                     seg.segment_log_probs_plain(logits.cpu(), ids.cpu(), n,
                                                 None, t)]
        else:
            form, tol = "log_prob", 1e-5
            got = seg.segment_log_prob(logits, action, ids, n, layout, t)
            composed = seg.segment_log_prob_plain(logits, action, ids, n,
                                                  layout, t, seg.KERNELS)
            plain = [seg.segment_log_prob_plain(logits, action, ids, n, None,
                                                t),
                     seg.segment_log_prob_plain(logits.cpu(), action.cpu(),
                                                ids.cpu(), n, None, t)]
        torch.cuda.synchronize()
        if not torch.equal(got.cpu().view(torch.int32),
                           composed.cpu().view(torch.int32)):
            raise AssertionError(
                f"{label}: K10's {form} entry and the composed kernel path "
                f"differ (max |diff| {_max_abs_diff(got, composed)})")
        for where, want in zip(("card", "CPU"), plain):
            diff = _max_abs_diff(got, want)
            worst[form] = max(worst[form], diff)
            if not torch.allclose(got.cpu(), want.cpu(), rtol=tol, atol=tol,
                                  equal_nan=True):
                raise AssertionError(
                    f"{label}: K10's {form} entry and the plain version on "
                    f"the {where} differ beyond rtol {tol}, atol {tol} "
                    f"(max |diff| {diff})")
        worst["calls"] += 1
    return worst


def log_prob_bound_ms(e: int, n: int, action: bool) -> tuple[float, str]:
    """K10's entry's least time and what bounds it: the logits and the CSR
    order read once (8 bytes an element) and the offsets once; without an
    action the log-probs written once (4 bytes an element), with one the
    action read once (1 byte an element) and the joint log-prob, one
    float32, written once; against the card's memory rate.  ~10
    operations an element (the division, the compares, ``expf``, the sums
    and subtractions, the select), a compare and ``logf`` a segment,
    against its float32 rate."""
    by_bytes = ((9 * e + 4 if action else 12 * e) + 4 * (n + 1)) \
        / HBM_BYTES_PER_S
    by_ops = (10 * e + 2 * n) / F32_OPS_PER_S
    return (max(by_bytes, by_ops) * 1e3,
            "bytes" if by_bytes >= by_ops else "operations")


def time_log_prob(logits, action, ids, n, temperature) -> dict:
    """ms per call of K10's entry and of the parent's whole ``log_prob``
    (the composition on the bare kernels), plain, kernel, kernel, plain,
    and of the plain version (``PLAIN``) on the card, with the device
    time and kernels per call of each (``torch.profiler``) and the entry's
    bound; likewise the log-softmax form."""
    from tarl_tpu_torch.ops import segment as seg

    layout = seg.segment_layout(ids, n)
    out = {}
    for form, entry, plain, args in (
            ("log_prob", seg.segment_log_prob, seg.segment_log_prob_plain,
             (logits, action, ids, n, layout, temperature)),
            ("log_probs", seg.segment_log_probs, seg.segment_log_probs_plain,
             (logits, ids, n, layout, temperature))):
        def parent(*a, plain=plain):
            return plain(*a, seg.KERNELS)

        p1, k1, k2, p2 = time_pair(entry, parent, args)
        plain_ms = time_per_call(plain, args)
        per_name, acts = device_time_by_name(entry, args)
        dev_ms = None if per_name is None else sum(per_name.values())
        kernel_ms = (None if per_name is None else sum(
            ms for name, ms in per_name.items() if "seg_log_prob" in name))
        parent_dev, parent_acts = device_time_per_call(parent, args)
        plain_dev, plain_acts = device_time_per_call(plain, args)
        out[form] = {"ms": min(k1, k2), "parent_ms": min(p1, p2),
                     "plain_ms": plain_ms, "device_ms": dev_ms,
                     "device_acts": acts, "kernel_device_ms": kernel_ms,
                     "parent_device_ms": parent_dev,
                     "parent_device_acts": parent_acts,
                     "plain_device_ms": plain_dev,
                     "plain_device_acts": plain_acts,
                     "bound": log_prob_bound_ms(logits.shape[0], n,
                                                form == "log_prob"),
                     "all": (p1, k1, k2, p2)}
    return out


def learned_paths(dev, net, agents, card: str, eval_steps=EVAL_STEPS,
                  collect_steps=COLLECT_STEPS, scale_steps=SCALE_STEPS):
    """Phases 8-10 on ``dev``, with ``net, agents`` the Grid16x16 headline
    scenario.  Launch counts are reset just before each path and read just
    after (on the card; the CPU takes the plain versions and counts
    nothing).  Returns the objects and numbers the later phases and the
    results line use."""
    import torch

    from tarl_tpu_torch.convert import load_params_npz, mpnn_params_from_numpy
    from tarl_tpu_torch.core import rng, sync
    from tarl_tpu_torch.core.step import Policy, init_sim_state
    from tarl_tpu_torch.io.matsim import load_network, load_population
    from tarl_tpu_torch.io.scenarios import ensure_scenario
    from tarl_tpu_torch.routing.policies import random_choice

    policy = Policy(choice=random_choice)
    on_card = dev.type == "cuda"

    def sync_dev():
        if on_card:
            torch.cuda.synchronize()

    # --- 8. the learned policy, trained weights ----------------------------
    t0 = time.perf_counter()
    base = ensure_scenario(os.path.join(ROOT, "build", "scenarios"),
                           "Grid8x8")
    net8 = load_network(os.path.join(base, "network"), device=dev)
    agents8, _ = load_population(os.path.join(base, "population"),
                                 os.path.join(base, "network"), device=dev)
    st8 = init_sim_state(net8, agents8, policy=policy)
    ppo8 = learned_ppo(net8, collect_steps)
    trained = mpnn_params_from_numpy(load_params_npz(
        os.path.join(ROOT, WEIGHTS)), device=dev)
    sync_dev()
    log(f"learned Grid8x8: {net8.num_roads} roads, {net8.num_nodes} nodes, "
        f"{net8.full_src.shape[0]} full edges, {agents8.num_agents} agent "
        f"rows; set-up {time.perf_counter() - t0:.2f} s (scenario, free-flow "
        f"all-pairs table, weights)")
    cap8 = Capture(CAPTURE_STEPS)
    reset_counts()
    t0 = time.perf_counter()
    env8, rewards8, _, logs8 = ppo8.eval_rollout(
        trained, st8, rng.prng_key(0), eval_steps, segment_ops=cap8.ops)
    sync_dev()
    eval_wall = time.perf_counter() - t0
    eval_launches = counts()
    eval_reads = sync.HOST_READS
    full = eval_steps == EVAL_STEPS
    ev = check_eval(env8, agents8.num_agents, eval_steps, eval_launches,
                    "learned eval",
                    min_done=EVAL_MIN_DONE if full else None,
                    max_att=90.0 if full else None, on_card=on_card)
    if not bool(torch.isfinite(rewards8).all()):
        raise AssertionError("learned eval: a reward is not finite")
    log(f"learned eval (trained, greedy): {eval_steps} steps in "
        f"{eval_wall:.2f} s, {eval_wall / eval_steps * 1e3:.3f} ms/step, "
        f"{eval_steps / eval_wall:.1f} steps/s, "
        f"{agents8.num_agents * eval_steps / eval_wall:.1f} agent rows x "
        f"steps/s, host reads per step {eval_reads / eval_steps:.3f}; done "
        f"{ev['done']}, on roads {ev['on_road']}, average travel time "
        f"{ev['att']:.3f} s, clock {ev['time']:.0f} s; launches "
        f"{eval_launches} ({card})")

    # --- 9. rollout collection --------------------------------------------
    ts8 = ppo8.init(st8, rng.prng_key(0), torch.Generator().manual_seed(0))
    cap_c = Capture(64)
    reset_counts()
    t0 = time.perf_counter()
    _, _, _, traj, last_value = ppo8.collect_rollout(
        trained, ts8.env, ts8.obs, ts8.key, segment_ops=cap_c.ops)
    sync_dev()
    collect_wall = time.perf_counter() - t0
    collect_launches = counts()
    collect_reads = sync.HOST_READS
    want = {"K1": collect_steps, "K9": 0, "K10": collect_steps,
            "K11": collect_steps, "K12": 0, "K7": 0, "choice": 0}
    if on_card and collect_launches != want:
        raise AssertionError(f"collection launches {collect_launches}, "
                             f"expected {want}")
    if not (bool(torch.isfinite(traj.log_prob).all())
            and bool(torch.isfinite(traj.value).all())
            and bool(torch.isfinite(last_value))):
        raise AssertionError("collection: a log-prob or value is not finite")
    if tuple(traj.action.shape) != (collect_steps, net8.full_src.shape[0]):
        raise AssertionError(f"collection: action shape "
                             f"{tuple(traj.action.shape)}")
    log(f"rollout collection: {collect_steps} steps in {collect_wall:.2f} "
        f"s, {collect_wall / collect_steps * 1e3:.3f} ms/step, host reads "
        f"{collect_reads}; mean log-prob "
        f"{float(traj.log_prob.mean()):.4f}, mean value "
        f"{float(traj.value.mean()):.4f}, on network at the end "
        f"{float(traj.on_network[-1]):.0f}; launches {collect_launches} "
        f"({card})")

    # --- 10. scale: Grid16x16, 50,000 commuters ----------------------------
    t0 = time.perf_counter()
    st16 = init_sim_state(net, agents, policy=policy)
    ppo16 = learned_ppo(net, collect_steps)
    params16 = ppo16.init(st16, rng.prng_key(1),
                          torch.Generator().manual_seed(16)).params
    sync_dev()
    setup16 = time.perf_counter() - t0
    cap16 = Capture(scale_steps // 2)
    reset_counts()
    t0 = time.perf_counter()
    env16, _, _, _ = ppo16.eval_rollout(params16, st16, rng.prng_key(2),
                                        scale_steps, segment_ops=cap16.ops)
    sync_dev()
    scale_wall = time.perf_counter() - t0
    scale_launches = counts()
    scale_reads = sync.HOST_READS
    ev16 = check_eval(env16, agents.num_agents, scale_steps, scale_launches,
                      "scale eval", on_card=on_card)
    log(f"scale eval (Grid16x16, {agents.num_agents} agent rows, seeded "
        f"weights, greedy): {scale_steps} steps in {scale_wall:.2f} s, "
        f"{scale_wall / scale_steps * 1e3:.3f} ms/step, "
        f"{agents.num_agents * scale_steps / scale_wall:.1f} agent rows x "
        f"steps/s, host reads per step {scale_reads / scale_steps:.3f}; "
        f"done {ev16['done']}, on roads {ev16['on_road']}; set-up "
        f"{setup16:.2f} s; launches {scale_launches} ({card})")
    return {"net8": net8, "st8": st8, "ppo8": ppo8, "trained": trained,
            "mid8": env8.sim, "cap8": cap8, "cap_c": cap_c, "cap16": cap16,
            "eval_launches": eval_launches,
            "collect_launches": collect_launches,
            "scale_launches": scale_launches}


def learned_in_context(ppo8, trained, st8, steps=LEARNED_CONTEXT_STEPS):
    """Phase 12: ``steps`` greedy evaluation steps with the kernels and
    again with the plain segment versions forced; the final environment
    states must be equal bitwise, and on the card the plain run must
    launch no segment kernel.  Returns the plain run's launch counts."""
    from tarl_tpu_torch.core import rng
    from tarl_tpu_torch.ops import segment as seg

    on_card = st8.road.count.device.type == "cuda"
    reset_counts()
    env_k, _, _, _ = ppo8.eval_rollout(trained, st8, rng.prng_key(0), steps)
    kernel_counts = counts()
    reset_counts()
    env_p, _, _, _ = ppo8.eval_rollout(trained, st8, rng.prng_key(0), steps,
                                       segment_ops=seg.PLAIN)
    plain_counts = counts()
    if on_card and kernel_counts["K11"] != steps:
        raise AssertionError(f"learned in context: kernel run launches "
                             f"{kernel_counts}")
    if plain_counts["K9"] or plain_counts["K10"] or plain_counts["K11"]:
        raise AssertionError(f"learned in context: the plain run launched "
                             f"a segment kernel: {plain_counts}")
    mismatched = _diff_paths(_env_bits(env_k), _env_bits(env_p))
    if mismatched:
        raise AssertionError(f"learned in context: kernel and plain runs "
                             f"differ at step {steps}: {mismatched}")
    log(f"learned in context: kernel and plain-segment runs equal bitwise "
        f"at step {steps} (plain run launches {plain_counts})")
    return plain_counts


def collection_in_context(net8, trained, st8, steps=LEARNED_CONTEXT_STEPS):
    """Phase 12's collection: ``steps`` sampled steps of
    ``PPO.collect_rollout`` with the kernels, with the parent's
    composition on the bare kernels (``segment_log_prob_plain(...,
    ops=KERNELS)``) and with ``PLAIN``.  Actions, rewards, values and the
    final environment states must be equal bitwise in all three, the
    log-probs bitwise between the first two and within rtol 1e-5, atol
    1e-5 of the plain run's; on the card the kernel run launches K10's
    entry once a step and K9 never, the plain run no segment kernel.
    Returns the launch counts of each run and the log-probs' largest
    absolute difference from the plain run's."""
    import torch

    from tarl_tpu_torch.core import rng
    from tarl_tpu_torch.ops import segment as seg

    on_card = st8.road.count.device.type == "cuda"
    ppo = learned_ppo(net8, steps)
    ts = ppo.init(st8, rng.prng_key(0), torch.Generator().manual_seed(0))

    def composed_log_probs(logits, ids, n, layout=None, t=1.0):
        return seg.segment_log_probs_plain(logits, ids, n, layout, t,
                                           seg.KERNELS)

    def composed_log_prob(logits, action, ids, n, layout=None, t=1.0):
        return seg.segment_log_prob_plain(logits, action, ids, n, layout, t,
                                          seg.KERNELS)

    composed = seg.KERNELS._replace(log_probs=composed_log_probs,
                                    log_prob=composed_log_prob)
    runs = {}
    for label, ops in (("kernels", seg.KERNELS), ("composed", composed),
                       ("plain", seg.PLAIN)):
        reset_counts()
        env, _, _, traj, _ = ppo.collect_rollout(trained, ts.env, ts.obs,
                                                 ts.key, segment_ops=ops)
        runs[label] = (env, traj, counts())
    want = {"kernels": {"K9": 0, "K10": steps, "K11": steps},
            "composed": {"K9": 3 * steps, "K10": steps, "K11": steps},
            "plain": {"K9": 0, "K10": 0, "K11": 0}}
    for label, (_, _, got) in runs.items():
        seen = {k: got[k] for k in ("K9", "K10", "K11")}
        if on_card and seen != want[label]:
            raise AssertionError(f"collection in context, {label} run: "
                                 f"launches {got}, expected {want[label]}")
    env_k, traj_k, _ = runs["kernels"]
    for label in ("composed", "plain"):
        env_o, traj_o, _ = runs[label]
        mismatched = _diff_paths(_env_bits(env_k), _env_bits(env_o))
        for field in ("action", "reward", "value", "done"):
            a, b = getattr(traj_k, field), getattr(traj_o, field)
            if not torch.equal(a.cpu().view(torch.uint8),
                               b.cpu().view(torch.uint8)):
                mismatched.append(f"traj.{field}")
        if mismatched:
            raise AssertionError(f"collection in context: the kernel and "
                                 f"{label} runs differ after {steps} steps: "
                                 f"{mismatched}")
    lp_k, lp_c = traj_k.log_prob, runs["composed"][1].log_prob
    if not torch.equal(lp_k.cpu().view(torch.int32),
                       lp_c.cpu().view(torch.int32)):
        raise AssertionError("collection in context: the kernel and "
                             "composed runs' log-probs differ (max |diff| "
                             f"{_max_abs_diff(lp_k, lp_c)})")
    lp_p = runs["plain"][1].log_prob
    err = _max_abs_diff(lp_k, lp_p)
    if not torch.allclose(lp_k.cpu(), lp_p.cpu(), rtol=1e-5, atol=1e-5,
                          equal_nan=True):
        raise AssertionError(f"collection in context: the kernel and plain "
                             f"runs' log-probs differ beyond rtol 1e-5, "
                             f"atol 1e-5 (max |diff| {err})")
    log(f"collection in context: {steps} steps with the kernels, with the "
        f"parent's composition on the bare kernels and with PLAIN: actions, "
        f"rewards, values and final states equal bitwise, log-probs bitwise "
        f"equal to the composition's and within max |diff| {err:.3g} of "
        f"PLAIN's (mean {float(lp_k.mean()):.4f}); launches "
        f"{ {k: v[2] for k, v in runs.items()} }")
    return {k: v[2] for k, v in runs.items()}, err


# --- the CLI's default evaluation (phase 24) ---------------------------------

def classical_sim(name: str, dev, root: str = None):
    """A :class:`TransportationSimulator` set up for ``CLASSICAL_ROWS[name]``
    as the reference CLI sets it up: scenarios generated and cached under
    ``build/`` (or ``root``), ``make_policy(algo, network=...)`` (backend
    "auto": the dual one), the clock at the row's start."""
    from tarl_tpu_torch.config import SimConfig
    from tarl_tpu_torch.simulator import TransportationSimulator, make_policy

    scenario, algo, start, timestep, ticks = CLASSICAL_ROWS[name]
    root = root or os.path.join(ROOT, "build")
    sim = TransportationSimulator(
        sim=SimConfig(timestep=timestep, start_time=start,
                      end_time=start + timestep * ticks),
        data_root=os.path.join(root, "scenarios"),
        save_root=os.path.join(root, "save"), device=dev)
    sim.load_network(scenario)
    sim.load_population(scenario)
    sim.set_policy(make_policy(algo, network=sim.network))
    sim.config_parameters(timestep_size=timestep, start_time=start)
    return sim


def classical_row(name: str, dev, root: str = None) -> dict:
    """One row of phase 24a: ``algorithms.episode.run_episode(mode="fused")``
    on :func:`classical_sim`, then ``nash_gap``, ``tstt`` and
    ``equilibrium_report`` on the final state.  Counts (K1's launches, the
    host reads, the refreshes) are set to 0 just before the episode and
    read just after."""
    import torch

    from tarl_tpu_torch.algorithms.episode import run_episode
    from tarl_tpu_torch.core import fused_winner, sync
    from tarl_tpu_torch.metrics.equilibrium import (
        equilibrium_report, nash_gap, tstt)

    sim = classical_sim(name, dev, root)
    ticks = CLASSICAL_ROWS[name][4]
    refreshes = []
    if sim.policy.refresh is not None:
        refresh = sim.policy.refresh

        def counted(state, network):
            refreshes.append(1)
            return refresh(state, network)

        sim.policy = sim.policy._replace(refresh=counted)
    on_card = sim.network.device.type == "cuda"
    fused_winner.reset_launches()
    sync.reset()
    t0 = time.perf_counter()
    run_episode(sim, ticks, mode="fused", progress=False)
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, reads = fused_winner.LAUNCHES, sync.HOST_READS
    st = sim.state
    t0 = time.perf_counter()
    gap = nash_gap(st.agents, st.road, sim.network)
    total_tt = float(tstt(st.agents, st.time))
    report = equilibrium_report(st.agents, st.road, sim.network, st.time)
    report_s = time.perf_counter() - t0
    return {
        "name": name, "sim": sim, "ticks": ticks, "wall": wall,
        "launches": launches, "reads_per_tick": reads / ticks,
        "refreshes": len(refreshes),
        "avg_tt": sim.average_travel_time(),
        "done": int(st.agents.done[1:].sum()),
        "on_road": int(st.road.count.sum()),
        "on_way": int(st.agents.on_way.sum()),
        "rel_gap": float(gap["relative_gap"]), "tstt": total_tt,
        "report": report, "report_s": report_s,
    }


def check_classical_row(res) -> None:
    """Phase 24a's asserts: conservation, the reference's done count, one
    K1 launch a tick, a refresh every 10 ticks under dijkstra, and the
    reference's average travel time and relative gap within the margins."""
    name = res["name"]
    want_tt, want_done, want_gap = CLASSICAL_REFERENCE[name]
    if res["on_road"] != res["on_way"]:
        raise AssertionError(f"{name}: conservation, {res['on_road']} on "
                             f"roads, {res['on_way']} on the way")
    if res["done"] != want_done:
        raise AssertionError(f"{name}: {res['done']} done, the reference "
                             f"{want_done}")
    # The CPU's wrappers take the plain versions and count nothing.
    on_card = res["sim"].network.device.type == "cuda"
    if on_card and res["launches"] != res["ticks"]:
        raise AssertionError(f"{name}: {res['launches']} K1 launches in "
                             f"{res['ticks']} ticks")
    want_refresh = (res["ticks"] // 10 if CLASSICAL_ROWS[name][1]
                    == "dijkstra" else 0)
    if res["refreshes"] != want_refresh:
        raise AssertionError(f"{name}: {res['refreshes']} refreshes, "
                             f"expected {want_refresh}")
    if abs(res["avg_tt"] - want_tt) > CLASSICAL_TT_RTOL * want_tt:
        raise AssertionError(f"{name}: average travel time "
                             f"{res['avg_tt']!r}, the reference {want_tt!r}")
    slack = max(CLASSICAL_GAP_RTOL * want_gap, CLASSICAL_GAP_ATOL)
    if abs(res["rel_gap"] - want_gap) > slack:
        raise AssertionError(f"{name}: relative gap {res['rel_gap']!r}, "
                             f"the reference {want_gap!r}")
    if abs(res["report"]["relative_nash_gap"] - res["rel_gap"]) > 1e-6:
        raise AssertionError(f"{name}: the report's gap differs from "
                             "nash_gap's")


def eager_in_context(dev, root: str = None,
                     ticks: int = EAGER_TICKS) -> dict:
    """Braess's dual dijkstra row for ``ticks`` ticks three ways: fused
    (``run_fast``), and through the facade's eager ``run()`` with K1 and
    with its plain version.  The three states must be equal bitwise; K1
    launches once a tick in the eager run with it and never with the plain
    one.  Returns the eager runs' phase timers."""
    from tarl_tpu_torch.core import fused_winner

    fused = classical_sim("Braess dijkstra", dev, root)
    fused.run_fast(ticks)
    want = _state_bits(fused.state)
    timers, launches = {}, {}
    for label, core in (("K1", fused_winner.direction_confirm),
                        ("plain", fused_winner.direction_confirm_plain)):
        eager = classical_sim("Braess dijkstra", dev, root)
        fused_winner.reset_launches()
        for _ in range(ticks):
            eager.run(core=core)
        launches[label] = fused_winner.LAUNCHES
        bad = _diff_paths(want, _state_bits(eager.state))
        if bad:
            raise AssertionError(f"eager run() with {label} and the fused "
                                 f"run differ at tick {ticks}: {bad}")
        timers[label] = eager.timers
    if dev.type == "cuda" and launches != {"K1": ticks, "plain": 0}:
        raise AssertionError(f"eager launches {launches}")
    return {"timers": timers, "launches": launches}


def dual_row_config():
    """Phase 24b: ``(RoutingConfig, SimConfig)`` of the dual row: the
    default routing (the dual backend at N = 1,472, a refresh every 10
    ticks, uncapped), phase 5's windowed insert."""
    from tarl_tpu_torch.config import RoutingConfig

    _, sim = sp_row_config()
    return RoutingConfig(), sim


def dual_row(net, agents, ticks=DUAL_TICKS, warmup=SP_WARMUP_TICKS,
             keep=(DUAL_BLOCKS_TICKS, DUAL_CONTEXT_TICKS, DUAL_PRIMAL_TICKS),
             routing=None,
             core=None) -> dict:
    """Phase 24b's row: ``make_policy("dijkstra", routing, network=net)``
    and ``run_episode_periodic`` for ``ticks`` ticks, timed after
    ``warmup``; keeps the states at the ticks in ``keep``.  Each refresh is
    timed with CUDA events and its sweeps counted; the counts are set to 0
    just before the initial state and read at the end."""
    import torch

    from tarl_tpu_torch.core import fused_winner, sync
    from tarl_tpu_torch.core.step import init_sim_state, run_episode_periodic
    from tarl_tpu_torch.routing import bellman_ford as bf
    from tarl_tpu_torch.simulator import make_policy

    default_routing, sim = dual_row_config()
    policy = make_policy("dijkstra", routing or default_routing,
                         network=net)
    on_card = net.device.type == "cuda"
    events, sweeps = [], []
    refresh = policy.refresh

    def timed_refresh(state, network):
        before = bf.DUAL_SWEEPS
        if on_card:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        buf = refresh(state, network)
        if on_card:
            ev[1].record()
            events.append(ev)
        sweeps.append(bf.DUAL_SWEEPS - before)
        return buf

    policy = policy._replace(refresh=timed_refresh)
    kw = {} if core is None else {"core": core}

    def sync_dev():
        if on_card:
            torch.cuda.synchronize()

    fused_winner.reset_launches()
    bf.reset_launches()
    sync.reset()
    t0 = time.perf_counter()
    state0 = init_sim_state(net, agents, sim=sim, policy=policy)
    sync_dev()
    init_s = time.perf_counter() - t0
    init_reads = sync.HOST_READS
    init_sweeps = bf.DUAL_SWEEPS
    state, _ = run_episode_periodic(state0, net, policy, warmup, sim=sim,
                                    **kw)
    sync_dev()
    reads_before = sync.HOST_READS
    kept, done = {}, warmup
    t0 = time.perf_counter()
    for stop in sorted(k for k in keep if warmup < k <= ticks) + [ticks]:
        if stop > done:
            state, _ = run_episode_periodic(state, net, policy, stop - done,
                                            sim=sim, **kw)
            done = stop
        kept[stop] = state
    sync_dev()
    wall = time.perf_counter() - t0
    measured = ticks - warmup
    refresh_ms = [a.elapsed_time(b) for a, b in events]
    return {
        "state0": state0, "final": state, "kept": kept, "init_s": init_s,
        "init_reads": init_reads, "init_sweeps": init_sweeps,
        "wall": wall, "measured": measured,
        "rate": agents.num_agents * measured / wall,
        "reads_per_tick": (sync.HOST_READS - reads_before) / measured,
        "refreshes": len(sweeps),
        "sweeps_per_refresh": sum(sweeps) / max(len(sweeps), 1),
        "reads_per_refresh": (sum(sweeps) / bf.CHECK_EVERY
                              / max(len(sweeps), 1)),
        "refresh_ms": (sum(refresh_ms) / len(refresh_ms) if refresh_ms
                       else float("nan")),
        "winner_launches": fused_winner.LAUNCHES,
        "relax_launches": bf.LAUNCHES,
        "resident_launches": bf.RESIDENT_LAUNCHES,
        "sim": sim, "policy": policy,
    }


def check_dual_row(res, net, ticks=DUAL_TICKS) -> None:
    """Phase 24b's asserts: conservation, arrivals, a refresh every 10
    ticks, K1 once a tick, no relax kernel, and the next-hop table: the
    node itself on the diagonal, and from every road and SRC node a next
    hop toward every DEST node (the grid is strongly connected)."""
    import torch

    final = res["final"]
    on_road = int(final.road.count.sum())
    on_way = int(final.agents.on_way.sum())
    if on_road != on_way:
        raise AssertionError(f"dual row conservation: {on_road} on roads, "
                             f"{on_way} on the way")
    if int(final.agents.done.sum()) <= 0:
        raise AssertionError("dual row: no agent arrived")
    want = {"refreshes": ticks // 10, "relax_launches": 0}
    if net.device.type == "cuda":
        want["winner_launches"] = ticks
    for name, value in want.items():
        if res[name] != value:
            raise AssertionError(f"dual row: {name} = {res[name]}, "
                                 f"expected {value}")
    nh = final.next_hop
    n, r, i_n = net.num_nodes, net.num_roads, net.num_intersections
    if tuple(nh.shape) != (n, n) or nh.dtype != torch.int32:
        raise AssertionError(f"dual table {nh.dtype}{tuple(nh.shape)}")
    iota = torch.arange(n, dtype=torch.int32, device=nh.device)
    if not bool((nh.diagonal() == iota).all()):
        raise AssertionError("dual table: a diagonal entry is not the node")
    rows = torch.cat([torch.arange(r, device=nh.device),
                      r + 2 * torch.arange(i_n, device=nh.device)])
    dests = r + 2 * torch.arange(i_n, device=nh.device) + 1
    sub = nh[rows][:, dests]
    off = rows[:, None] != dests[None, :]
    if not bool(((sub >= 0) & (sub < n) | ~off).all()):
        raise AssertionError("dual table: a road or SRC node without a next "
                             "hop toward a DEST node")


def _same_episode(a, b) -> list:
    """Fields at which two states of one episode under the two routing
    backends differ: everything but the routing scratch and the
    selections (an empty road routes the dummy agent, differently on each
    table, and no one follows)."""
    da, db = _state_bits(a), _state_bits(b)
    for d in (da, db):
        for k in ("next_hop", "sel_dest", "selected_road"):
            d.pop(k)
    return _diff_paths(da, db)


def free_flow_table_ok(net, dist, nh) -> bool:
    """A grid's free-flow dual tables: the node itself on the diagonal, and
    every road and DEST node reachable from every road (no SRC node is:
    none has an incoming edge)."""
    import torch

    from tarl_tpu_torch.routing.bellman_ford import BIG

    n, r = net.num_nodes, net.num_roads
    cols = torch.cat([torch.arange(r, device=dist.device),
                      r + 1 + 2 * torch.arange(net.num_intersections,
                                               device=dist.device)])
    iota = torch.arange(n, dtype=torch.int32, device=nh.device)
    return (bool((nh.diagonal() == iota).all())
            and float(dist[:r][:, cols].max()) < BIG
            and bool((nh[:r][:, cols] >= 0).all()))


def big_dual_relax(dev, card: str, grid: int = DUAL_BIG_GRID) -> dict:
    """Phase 24c: one free-flow ``all_pairs_next_hop_nbr`` on a ``grid`` x
    ``grid`` network (Grid36x36: the largest on which ``make_policy``'s
    "auto" picks the dual backend), after a warm-up call: its milliseconds
    (CUDA events), device time (``torch.profiler``), sweeps, host reads,
    peak memory above the tables' and the bound."""
    import torch

    from tarl_tpu_torch.core import sync
    from tarl_tpu_torch.routing import bellman_ford as bf

    net = grid_network(grid, grid, dev)
    n, d = net.nbr.shape
    cost = net.entry_cost()
    args = (net.nbr, net.nbr_ok, cost)
    bf.all_pairs_next_hop_nbr(*args)    # warm-up: the allocator's blocks
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    bf.reset_launches()
    sync.reset()
    ev = (torch.cuda.Event(enable_timing=True),
          torch.cuda.Event(enable_timing=True))
    ev[0].record()
    dist, nh = bf.all_pairs_next_hop_nbr(*args)
    ev[1].record()
    torch.cuda.synchronize()
    ms = ev[0].elapsed_time(ev[1])
    sweeps, reads = bf.DUAL_SWEEPS, sync.HOST_READS
    peak = torch.cuda.max_memory_allocated() - base
    if not free_flow_table_ok(net, dist, nh):
        raise AssertionError(f"Grid{grid}x{grid} dual table: a road cannot "
                             "reach a road or DEST node, or the diagonal is "
                             "wrong")
    del dist, nh
    dev_ms, acts = device_time_per_call(bf.all_pairs_next_hop_nbr, args,
                                        calls=2)
    # One sweep reads the distances and writes them once, and reads the
    # slot weights and neighbours; an add and a min per slot and pair.
    sweep_bytes = 2 * 4 * n * n + 9 * n * d
    sweep_ops = 2 * d * n * n
    by_bytes = sweep_bytes / HBM_BYTES_PER_S
    by_ops = sweep_ops / F32_OPS_PER_S
    # The next-hop pass: the distances read, the table written.
    bound_ms = (sweeps * max(by_bytes, by_ops)
                + 2 * 4 * n * n / HBM_BYTES_PER_S) * 1e3
    return {"n": n, "d": d, "ms": ms, "device_ms": dev_ms,
            "device_acts": acts, "sweeps": sweeps, "reads": reads,
            "peak_bytes": peak, "table_bytes": 4 * n * n,
            "sweep_bound_ms": max(by_bytes, by_ops) * 1e3,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "card": card}


def classical_phase(dev, root: str = None) -> dict:
    """Phase 24a: the CLI's classical rows through the facade, and Braess
    in the eager tick.  Returns the rows and the eager run's numbers."""
    out = {"rows": {}}
    for name in CLASSICAL_ROWS:
        res = classical_row(name, dev, root)
        check_classical_row(res)
        out["rows"][name] = res
        want_tt, want_done, want_gap = CLASSICAL_REFERENCE[name]
        rep = res["report"]
        log(f"{name}: {res['ticks']} ticks in {res['wall']:.2f} s "
            f"({res['wall'] / res['ticks'] * 1e3:.3f} ms/tick), average "
            f"travel time {res['avg_tt']:.3f} s (reference {want_tt:.3f}), "
            f"done {res['done']} (reference {want_done}), relative gap "
            f"{res['rel_gap']:.5f} (reference {want_gap:.5f}), TSTT "
            f"{res['tstt']:.0f} s, K1 launches {res['launches']}, host "
            f"reads per tick {res['reads_per_tick']:.3f}, refreshes "
            f"{res['refreshes']}; report in {res['report_s']:.2f} s (PoA "
            f"{rep['price_of_anarchy']:.4f}, FW iterations "
            f"{rep['msa_iterations_ue']}, converged "
            f"{rep['converged_ue']}/{rep['converged_so']})")
    rows = out["rows"]
    if not rows["Braess random"]["rel_gap"] > rows["Braess dijkstra"][
            "rel_gap"] or not rows["Braess random"]["avg_tt"] > rows[
            "Braess dijkstra"]["avg_tt"]:
        raise AssertionError("Braess: the metrics do not rank random below "
                             "dijkstra")
    eager = eager_in_context(dev, root)
    out["eager"] = eager
    for label, t in eager["timers"].items():
        log(f"Braess eager run() with {label}: {EAGER_TICKS} ticks bitwise "
            f"the fused run's; phase timers insert {t.inserting_time:.3f} "
            f"s, withdraw {t.withdraw_time:.3f} s, choice "
            f"{t.choice_time:.3f} s, core {t.core_time:.3f} s, total "
            f"{t.total:.3f} s; K1 launches {eager['launches'][label]}")
    return out


def cli_default_phase(dev, card: str, report_path: str,
                      dual_ticks: int = DUAL_TICKS,
                      dual_agents: tuple = None) -> dict:
    """Phase 24b-c, the rest of the CLI's default path on the card: (b) the
    dual row and its cross-checks with the plain K1 and the primal
    backend, its last state written to ``report_path`` for
    :func:`dual_report_phase`; (c) the dual relax at the largest dual
    size.  Returns the numbers for the results line."""
    import torch

    from tarl_tpu_torch.config import RoutingConfig
    from tarl_tpu_torch.core import fused_winner
    from tarl_tpu_torch.state import sort_agents_by_departure

    on_card = dev.type == "cuda"
    out = {}
    # --- b. the dual row ---
    if dual_agents is None:
        net, agents = load_scenario("Grid16x16_50000", 16, 16, 50000, dev)
    else:
        net, agents = dual_agents
    agents = sort_agents_by_departure(agents)
    dual = dual_row(net, agents, ticks=dual_ticks)
    check_dual_row(dual, net, dual_ticks)
    final = dual["final"]
    n = net.num_nodes
    log(f"dual row: {net.num_roads} roads, N={n} dual nodes, "
        f"{agents.num_agents} agent "
        f"rows; initial table in {dual['init_s']:.2f} s "
        f"({dual['init_sweeps']} sweeps, {dual['init_reads']} host reads)")
    log(f"dual row: {dual['rate']:.1f} agent-steps/s ({dual['measured']} "
        f"ticks in {dual['wall']:.2f} s, "
        f"{dual['wall'] / dual['measured'] * 1e3:.3f} ms/tick), "
        f"{dual['refresh_ms']:.3f} ms per refresh (CUDA events, "
        f"{dual['refreshes']} refreshes), {dual['sweeps_per_refresh']:.1f} "
        f"sweeps and {dual['reads_per_refresh']:.2f} host reads per "
        f"refresh, host reads per tick {dual['reads_per_tick']:.3f}, done "
        f"{int(final.agents.done.sum())}, on roads "
        f"{int(final.road.count.sum())}, table {4 * n * n} bytes, "
        f"fused_winner calls {dual['winner_launches']} ({card})")
    # Written whole, then renamed: the reader waits for the name.
    torch.save({"agents": {k: v.cpu() for k, v in
                           final.agents._asdict().items()},
                "road": {k: v.cpu() for k, v in final.road._asdict().items()},
                "time": final.time}, report_path + ".part")
    os.replace(report_path + ".part", report_path)
    # In context: the plain K1 from the same start.
    fused_winner.reset_launches()
    plain = dual_row(net, agents, ticks=DUAL_CONTEXT_TICKS,
                     keep=(), core=fused_winner.direction_confirm_plain)
    if plain["winner_launches"] != 0:
        raise AssertionError("the plain-K1 dual row launched K1")
    bad = _diff_paths(_state_bits(dual["kept"][DUAL_CONTEXT_TICKS]),
                      _state_bits(plain["final"]))
    if bad:
        raise AssertionError(f"dual row with K1 and with the plain K1 differ "
                             f"at tick {DUAL_CONTEXT_TICKS}: {bad}")
    log(f"dual row in context: K1 and plain K1 states equal bitwise at "
        f"tick {DUAL_CONTEXT_TICKS}")
    # The primal backend, uncapped: K2's resident form, once a refresh and
    # once for the table init's relax.
    primal = dual_row(net, agents, ticks=DUAL_PRIMAL_TICKS, keep=(),
                      routing=RoutingConfig(backend="primal"))
    want = {"refreshes": DUAL_PRIMAL_TICKS // 10,
            "relax_launches": DUAL_PRIMAL_TICKS // 10 + 1,
            "resident_launches": DUAL_PRIMAL_TICKS // 10 + 1}
    for k, v in want.items():
        if on_card and primal[k] != v:
            raise AssertionError(f"primal cross-check: {k} = {primal[k]}, "
                                 f"expected {v}")
    bad = _same_episode(dual["kept"][DUAL_PRIMAL_TICKS], primal["final"])
    if bad:
        raise AssertionError(f"dual and primal rows differ at tick "
                             f"{DUAL_PRIMAL_TICKS}: {bad}")
    keep = ("winner_launches", "relax_launches", "resident_launches",
            "refreshes", "wall", "measured")
    out.update(dual={k: dual[k] for k in keep},
               primal={k: primal[k] for k in keep}, net_n=n,
               dual_blocks={"net": net, "state0": dual["state0"],
                            "policy": dual["policy"], "sim": dual["sim"],
                            "want": dual["kept"][DUAL_BLOCKS_TICKS],
                            "ms_tick": dual["wall"] / dual["measured"] * 1e3})
    log(f"dual row against the primal backend: states equal bitwise at tick "
        f"{DUAL_PRIMAL_TICKS} (routing scratch and selections aside); "
        f"primal {primal['wall'] / primal['measured'] * 1e3:.3f} ms/tick, "
        f"{primal['relax_launches']} relax calls "
        f"({primal['resident_launches']} resident launches)")
    del dual, plain, primal, final

    # --- c. the largest dual network ---
    if on_card:
        big = big_dual_relax(dev, card)
        out["big"] = big
        log(f"dual relax Grid{DUAL_BIG_GRID}x{DUAL_BIG_GRID}: N={big['n']}, "
            f"D={big['d']} slots, {big['ms']:.3f} ms (CUDA events), device "
            f"{fmt_us(big['device_ms'])} in {big['device_acts']:.1f} "
            f"kernels (torch.profiler over 2 calls), {big['sweeps']} sweeps, "
            f"{big['reads']} host reads, peak memory "
            f"{big['peak_bytes'] / 2 ** 20:.1f} MiB above the start (dist "
            f"and next_hop {big['table_bytes'] / 2 ** 20:.1f} MiB each), "
            f"bound {big['bound_ms']:.3f} ms by {big['bound_by']} "
            f"({big['sweep_bound_ms']:.4f} ms a sweep) ({card})")
    return out


def dual_report_phase(dev, report_path: str,
                      wait: float = SIDE_TIMEOUT) -> dict:
    """Phase 24b's equilibrium report (the CLI's, as ``python main.py``
    writes it) on the dual row's last state, which
    :func:`cli_default_phase` writes to ``report_path`` in the main
    process; waits for it up to ``wait`` seconds."""
    import torch

    from tarl_tpu_torch.metrics.equilibrium import equilibrium_report
    from tarl_tpu_torch.state import AgentState, RoadState

    deadline = time.monotonic() + wait
    while not os.path.exists(report_path):
        if time.monotonic() > deadline:
            raise AssertionError(f"no dual row state at {report_path} "
                                 f"within {wait:.0f} s")
        time.sleep(0.5)
    saved = torch.load(report_path)
    net, _ = load_scenario("Grid16x16_50000", 16, 16, 50000, dev)
    agents = AgentState(**{k: v.to(dev) for k, v in saved["agents"].items()})
    road = RoadState(**{k: v.to(dev) for k, v in saved["road"].items()})
    t0 = time.perf_counter()
    report = equilibrium_report(agents, road, net, saved["time"])
    seconds = time.perf_counter() - t0
    log(f"dual row equilibrium report in {seconds:.2f} s (beside 24b-c, 27 "
        f"and 22, 23 and 26): "
        + ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                    for k, v in report.items()))
    return {"report": report, "seconds": seconds}


# --- the CLI (phase 25) --------------------------------------------------------

def _report_diffs(got: dict, want: dict) -> tuple[list, bool]:
    """The keys at which two equilibrium reports differ (floats beyond
    rtol 1e-5), and whether every float is bitwise equal."""
    bad, bitwise = [], list(got) == list(want)
    for k in want:
        a, b = got.get(k), want[k]
        if isinstance(b, float) and isinstance(a, float):
            bitwise &= a == b
            if abs(a - b) > 1e-5 * abs(b):
                bad.append(k)
        elif a != b:
            bad.append(k)
    return bad, bitwise


def _plain_segment_spy():
    """Counting wrappers around the plain segment versions, recording the
    calls made outside ``plain_segments()`` (on a CUDA tensor such a call
    would be a fallback; the training loss runs inside it by design).
    Returns ``(calls, restore)``."""
    from tarl_tpu_torch.ops import segment as seg

    calls: dict = {}
    names = ("segment_sum_plain", "segment_max_plain",
             "segment_argmax_plain", "segment_action_plain",
             "segment_log_probs_plain", "segment_log_prob_plain")
    originals = {n: getattr(seg, n) for n in names}

    def counting(name, fn):
        def wrapped(*args, **kwargs):
            if not seg._PLAIN_SEGMENTS.get():
                calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kwargs)
        return wrapped

    for n, fn in originals.items():
        setattr(seg, n, counting(n, fn))

    def restore():
        for n, fn in originals.items():
            setattr(seg, n, fn)

    return calls, restore


def cli_phase(dev, card: str, easy_row: dict, root: str = None,
              window=CLI_WINDOW) -> dict:
    """Phase 25: the port's CLI, ``tarl_tpu_torch.runner.main(argv)``, in
    this process on ``dev``, from ``root`` (default ``build/cli``: its
    ``data/``, ``save/`` and output directories).  (a) The README's
    evaluation, held to phase 24a's Easy row ``easy_row``; (b) ``--mode
    train`` for ``mpnn+ppo`` on Braess, then ``--mode eval --checkpoint``
    of its checkpoint over ``window``.  Returns the counts for the results
    line."""
    import importlib.util
    import math

    import torch

    from tarl_tpu_torch import runner

    on_card = dev.type == "cuda"
    matplotlib_found = importlib.util.find_spec("matplotlib") is not None
    root = root or os.path.join(ROOT, "build", "cli")
    os.makedirs(root, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(root)
    try:
        dev_args = ["--device", dev.type]
        # --- a. the README's evaluation ---
        reset_counts()
        t0 = time.perf_counter()
        easy = runner.main(README_EVAL + ["--output-dir", "easy"]
                           + dev_args)
        easy_s = time.perf_counter() - t0
        easy_counts = counts()
        st = easy.sim.state
        got = {"avg_tt": easy.sim.average_travel_time(),
               "done": int(st.agents.done[1:].sum())}
        with open(os.path.join("easy", "equilibrium_report.json")) as f:
            report = json.load(f)
        want_report = json.loads(json.dumps(easy_row["report"]))
        bad, bitwise = _report_diffs(report, want_report)
        moved = {k: (got[k], easy_row[k]) for k in got
                 if got[k] != easy_row[k]}
        if moved or bad:
            raise AssertionError(
                f"the CLI's Easy evaluation differs from phase 24a's row "
                f"(the runner sets record_road_optimality=True, seed 0, "
                f"chunks of {easy.episode_chunk}): {moved}, report keys "
                f"{bad}")
        written = sorted(os.listdir("easy"))
        missing = [f for f in REPORT_FILES if f not in written]
        pngs = [f for f in REPORT_PNGS if f in written]
        if missing or pngs != (list(REPORT_PNGS) if matplotlib_found
                               else []):
            raise AssertionError(f"the CLI's reports: {written} "
                                 f"(matplotlib found: {matplotlib_found})")
        ticks = easy_row["ticks"]
        if on_card and easy_counts["K1"] != ticks:
            raise AssertionError(f"the CLI's Easy evaluation: K1 launches "
                                 f"{easy_counts['K1']}, expected {ticks}")
        log(f"CLI (a) {' '.join(README_EVAL)}: {easy_s:.2f} s in all "
            f"(episode, reports, MSA and the equilibrium report); average "
            f"travel time {got['avg_tt']:.3f} s and done {got['done']} equal "
            f"phase 24a's Easy row, equilibrium_report.json equal to its "
            f"report ({'bitwise' if bitwise else 'floats within rtol 1e-5'}); "
            f"matplotlib found: {matplotlib_found}; wrote "
            f"{', '.join(written)}; K1 launches {easy_counts['K1']} "
            f"({card})")

        # --- b. training, then the checkpoint's evaluation ---
        win = ["--start-end-time", str(window[0]), str(window[1])]
        steps = window[1] - window[0]
        rollout = int(CLI_TRAIN[CLI_TRAIN.index("--rollout-steps") + 1])
        iters = int(CLI_TRAIN[CLI_TRAIN.index("--iterations") + 1])
        calls, restore = _plain_segment_spy()
        try:
            reset_counts()
            t0 = time.perf_counter()
            trained = runner.main(CLI_TRAIN + win + [
                "--mode", "train", "--output-dir", "train"] + dev_args)
            train_s = time.perf_counter() - t0
            train_counts, train_calls = counts(), dict(calls)
            calls.clear()
            reset_counts()
            t0 = time.perf_counter()
            restored = runner.main(CLI_TRAIN[:4] + win + [
                "--mode", "eval", "--checkpoint",
                os.path.join("train", "checkpoints"),
                "--output-dir", "eval"] + dev_args)
            eval_s = time.perf_counter() - t0
            eval_counts, eval_calls = counts(), dict(calls)
        finally:
            restore()
        # The collection samples (K11) and takes its log-probs (K10) once
        # a step; ppo_train's greedy evaluation after each iteration and
        # the final evaluation take the mode (K11) once a step; K1 once an
        # environment step.
        env_steps = iters * rollout * 2 + steps
        want_train = {"K1": env_steps, "K9": 0, "K10": iters * rollout,
                      "K11": env_steps}
        want_eval = {"K1": steps, "K9": 0, "K10": 0, "K11": steps}
        if on_card:
            for label, have, want, plain in (
                    ("train", train_counts, want_train, train_calls),
                    ("eval", eval_counts, want_eval, eval_calls)):
                if {k: have[k] for k in want} != want or plain:
                    raise AssertionError(
                        f"the CLI's {label} run: launches {have}, expected "
                        f"{want}; plain segment calls outside the loss "
                        f"{plain}")
        p_a, p_b = trained.train_state.params, restored.eval_params
        same = all(torch.equal(p_a[part][k], p_b[part][k])
                   and p_a[part][k].dtype == p_b[part][k].dtype
                   for part in p_a for k in p_a[part])
        if not same or p_a.keys() != p_b.keys():
            raise AssertionError("the restored parameters are not the "
                                 "trained ones bitwise")
        bad = _diff_paths(_state_bits(trained.sim.state),
                          _state_bits(restored.sim.state))
        if bad:
            raise AssertionError(f"the checkpoint's evaluation differs from "
                                 f"the trained run's: {bad}")
        att = restored.sim.average_travel_time()
        with open(os.path.join("eval", "equilibrium_report.json")) as f:
            eval_report = json.load(f)
        with open(os.path.join("train", "metrics.csv")) as f:
            rows = [line.split(",") for line in f.read().split()[1:]]
        numbers = [att] + [v for v in eval_report.values()
                           if isinstance(v, float)] + [
            float(x) for row in rows for x in row if x]
        if not all(math.isfinite(v) for v in numbers):
            raise AssertionError(f"the CLI's learned runs: a metric is not "
                                 f"finite (average travel time {att}, "
                                 f"report {eval_report})")
        done = int(restored.sim.state.agents.done[1:].sum())
        log(f"CLI (b) {' '.join(CLI_TRAIN)} --mode train: {train_s:.2f} s "
            f"({len(rows)} metric rows), launches {train_counts}; then "
            f"--mode eval --checkpoint train/checkpoints over {steps} ticks: "
            f"{eval_s:.2f} s, launches {eval_counts}; parameters restored "
            f"bitwise, the evaluated state bitwise the trained run's; "
            f"average travel time {att:.3f} s, done {done}, relative gap "
            f"{eval_report['relative_nash_gap']:.5f}; plain segment calls "
            f"outside the loss: train {train_calls}, eval {eval_calls} "
            f"({card})")
    finally:
        os.chdir(cwd)
    return {"easy": easy_counts, "train": train_counts, "eval": eval_counts,
            "matplotlib": matplotlib_found, "easy_s": easy_s,
            "train_s": train_s, "eval_s": eval_s}


# --- the irregular city (phase 26) -------------------------------------------

def city_scenario_on(device, num_intersections=CITY_INTERSECTIONS,
                     num_agents=CITY_AGENTS, zones=CITY_ZONES):
    """``scripts/bench_city.py``'s city through the port: generated by
    ``io.city`` under ``build/scenarios`` (seed 7), the network built (with
    the renumbering search) and the population parsed, each timed; the
    population sorted by departure and the zone list ``unique(_dest_inter(
    net, agents.dest))``.  Returns ``(net, agents, dest_inters,
    seconds)``."""
    import numpy as np

    from tarl_tpu_torch.io.city import city_scenario
    from tarl_tpu_torch.io.matsim import load_network, load_population
    from tarl_tpu_torch.routing.policies import _dest_inter
    from tarl_tpu_torch.state import sort_agents_by_departure

    cache = os.path.join(ROOT, "build", "scenarios")
    name = f"CityBench{num_intersections}_{num_agents}"
    base = os.path.join(cache, name)
    seconds = {"generate": 0.0}
    if not os.path.exists(os.path.join(base, "network.xml.gz")):
        t0 = time.perf_counter()
        city_scenario(cache, name, num_intersections=num_intersections,
                      num_agents=num_agents, num_dest_zones=zones,
                      peak_start=6 * 3600, peak_spread=2 * 3600)
        seconds["generate"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    net = load_network(os.path.join(base, "network"), device=device)
    seconds["network"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    agents, stats = load_population(os.path.join(base, "population"),
                                    os.path.join(base, "network"),
                                    device=device)
    seconds["population"] = time.perf_counter() - t0
    note_parse("city", seconds["network"], seconds["population"], stats)
    agents = sort_agents_by_departure(agents)
    dest = np.unique(_dest_inter(net, agents.dest).cpu().numpy())
    return net, agents, dest, seconds


def city_configs():
    """``scripts/bench_city.py``'s ``(RoutingConfig, sp SimConfig, exact
    random SimConfig)``: the sp row's windowed insert W=1,024, depth 2, no
    escalation; the random row's backlog Q=8,192, W=32, depth 2, both
    escalations."""
    from tarl_tpu_torch.config import RoutingConfig, SimConfig

    routing = RoutingConfig(refresh_rate=10, max_bf_iters=8,
                            backend="primal")
    base = dict(timestep=1, start_time=6 * 3600,
                record_road_optimality=False, sorted_population=True,
                withdraw_depth=2)
    sp = SimConfig(**base, insert_window=1024, insert_escalate=False,
                   withdraw_escalate=False)
    exact = SimConfig(**base, insert_window=32, insert_backlog=CITY_BACKLOG,
                      insert_escalate=True, withdraw_escalate=True)
    return routing, sp, exact


def city_phase(dev, card: str, num_intersections=CITY_INTERSECTIONS,
               num_agents=CITY_AGENTS, zones=CITY_ZONES, ticks=SP_TICKS,
               warmup=SP_WARMUP_TICKS, context=CITY_CONTEXT_TICKS) -> dict:
    """Phase 26, the irregular city (``scripts/bench_city.py``) on the port:
    its scenario, the exact random row and its first ``context`` ticks
    again with the plain K1, the zoned sp row (the relax's global form, K6)
    and the relax against plain on the row's refresh inputs.  Returns the
    numbers the kernels line reads."""
    import torch

    from tarl_tpu_torch.config import RoutingConfig
    from tarl_tpu_torch.convert import to_numpy
    from tarl_tpu_torch.core import fused_winner
    from tarl_tpu_torch.core.step import init_sim_state, run_episode
    from tarl_tpu_torch.routing import bellman_ford as bf
    from tarl_tpu_torch.simulator import make_policy

    on_card = dev.type == "cuda"
    net, agents, dest, secs = city_scenario_on(dev, num_intersections,
                                               num_agents, zones)
    i_n, k_n = net.inter_out_road.shape
    d_n = len(dest)
    degree = torch.bincount(net.inter_out_ok.sum(dim=1)).tolist()
    log(f"city row: {net.num_roads} roads (R), {i_n} intersections (I), "
        f"K={k_n} out-slots (rows by out-degree "
        f"{ {d: n for d, n in enumerate(degree) if n} }), Nmax {net.nmax}, "
        f"renumbered {net.renumbered}, {agents.num_agents} agent rows, "
        f"D={d_n} destination columns; generated in {secs['generate']:.1f} "
        f"s, network built (renumbering search included) in "
        f"{secs['network']:.1f} s, population parsed in "
        f"{secs['population']:.1f} s; resident_plan "
        f"{bf.resident_plan(i_n, d_n, k_n, 8)}, cluster_plan "
        f"{bf.cluster_plan(i_n, d_n, k_n, 8)} at 8 sweeps")
    routing, sim_sp, sim_ex = city_configs()

    # --- the exact random row ---
    random_policy = make_policy("random", RoutingConfig())
    ex = headline_run(net, agents, sim_ex, random_policy, ticks=ticks,
                      warmup=warmup, capture_every=context)
    check_headline(ex, "city exact random row",
                   {"K1": ticks, "choice": ticks} if on_card else {})
    log(f"city exact random row (Q={CITY_BACKLOG}, W=32, depth 2, both "
        f"escalations), {ticks} ticks: {ex['rate']:.1f} agent-steps/s "
        f"({ex['measured']} ticks in {ex['wall']:.2f} s, "
        f"{ex['wall'] / ex['measured'] * 1e3:.3f} ms/tick), overflow "
        f"{ex['overflow']}, done {ex['done']}, on the way {ex['on_way']} "
        f"(on roads {ex['on_road']}), average travel time "
        f"{ex['avg_tt']:.3f} s, host reads per tick "
        f"{ex['syncs_per_tick']:.3f}, launches {ex['launches']} ({card})")
    # K1 in context: the first ticks again with the plain K1.
    plain = init_sim_state(net, agents, sim=sim_ex, policy=random_policy)
    before = fused_winner.LAUNCHES
    plain, _ = run_episode(plain, net, random_policy, context, sim=sim_ex,
                           core=fused_winner.direction_confirm_plain)
    if fused_winner.LAUNCHES != before:
        raise AssertionError("the plain-K1 city row launched K1")
    bad = _diff_paths(to_numpy(ex["captured"][0]), to_numpy(plain))
    if bad:
        raise AssertionError(f"city row with K1 and with the plain K1 differ "
                             f"at tick {context}: {bad}")
    log(f"city row in context: K1 and plain-K1 states equal bitwise at tick "
        f"{context}")
    exact = {k: ex[k] for k in ("wall", "measured", "rate", "overflow",
                                "done", "syncs_per_tick", "launches")}
    choice = choice_row("city", net, ex["captured"], card)
    del ex, plain

    # --- the zoned sp row ---
    sp = sp_row(net, agents, ticks, warmup, config=(routing, sim_sp),
                dest_inters=dest)
    check_radial_sp(sp, net, agents, d_n, ticks, label="city sp row")
    final = sp["final"]
    log(f"city sp row: {sp['rate']:.1f} agent-steps/s ({sp['measured']} "
        f"ticks in {sp['wall']:.2f} s, "
        f"{sp['wall'] / sp['measured'] * 1e3:.3f} ms/tick), "
        f"{sp['refresh_ms']:.3f} ms per refresh and {sp['relax_ms']:.4f} ms "
        f"of it in the relax call (CUDA events, {sp['refreshes']} "
        f"refreshes), done {int(final.agents.done.sum())}, on the way "
        f"{int(final.agents.on_way.sum())}, host reads per tick "
        f"{sp['reads_per_tick']:.3f}, saturation monitor sum "
        f"{sp['saturated']}; relax calls {sp['forms']} (the uncapped table "
        f"init {sp['table_init']}, in {sp['init_s']:.2f} s with the "
        f"initial state), fused_winner calls {sp['winner_launches']} "
        f"({card})")
    tables = relax_tables(net)
    cases = [(f"city refresh {j * SP_CAPTURE_EVERY}", c, tables, d)
             for j, (c, d) in enumerate(sp["captured"])]
    # A warm start near its fixpoint may change nothing in a mode; the cold
    # start changes every one.
    anchor = (torch.arange(i_n, device=dev)[:, None]
              == torch.as_tensor(dest, device=dev).long()[None, :])
    cold = torch.where(anchor, 0.0, bf.BIG).contiguous()
    err = compare_relax(cases + [("city cold start", net.free_flow, tables,
                                  cold)],
                        [(routing.max_bf_iters, False),
                         (routing.max_bf_iters, True), (1, True)])
    log(f"primal_relax global form vs plain: bitwise equal on the city "
        f"row's refresh inputs captured at refreshes "
        f"{', '.join(str(j * SP_CAPTURE_EVERY) for j in range(len(cases)))} "
        f"and on its cold start (8 sweeps with and without next roads, 1 "
        f"sweep) ({card})")
    timed = {}
    if on_card:
        _, c_mid, _, d_mid = cases[len(cases) // 2]
        args = (c_mid, *tables, d_mid, routing.max_bf_iters, False)
        plain1, kern1, kern2, plain2 = time_pair(
            bf.primal_relax_next_roads, bf.primal_relax_next_roads_plain,
            args, RELAX_TIMED_CALLS)
        dev_ms, acts = device_time_per_call(bf.primal_relax_next_roads, args,
                                            RELAX_TIMED_CALLS)
        if round(acts) != 1:
            raise AssertionError(f"a city refresh's relax call ran {acts} "
                                 f"device activities, not one launch")
        bound = relax_bound_ms(net, routing.max_bf_iters, d_n, False)
        timed = {"ms": min(kern1, kern2), "plain_ms": min(plain1, plain2),
                 "device_ms": dev_ms, "bound": bound}
        log(f"primal_relax global form at the city shape (I={i_n}, D={d_n}, "
            f"K={k_n}, 8 sweeps + next road, a captured refresh): kernel "
            f"{kern1:.4f} / {kern2:.4f} ms per call, plain {plain1:.4f} / "
            f"{plain2:.4f} (plain, kernel, kernel, plain; CUDA events), "
            f"device {fmt_us(dev_ms)} in {acts:.1f} kernels "
            f"(torch.profiler); bound {bound[0]:.4f} ms by {bound[1]} "
            f"({card})")
    sp_out = {k: sp[k] for k in ("wall", "measured", "rate", "refresh_ms",
                                 "relax_ms", "refreshes", "forms",
                                 "table_init", "winner_launches",
                                 "choice_launches", "reads_per_tick")}
    return {"exact": exact, "sp": sp_out, "err": err, "seconds": secs,
            "timed": timed, "choice": choice,
            "r": net.num_roads, "i_n": i_n, "d_n": d_n, "k_n": k_n,
            "nmax": net.nmax, "renumbered": net.renumbered}


# --- the Graph Transformer (phase 27) ----------------------------------------

def gt_braess(dev):
    """``(net, agents, state, ppo, params, tree)``: Braess on ``dev``, the
    recorded transformer run's PPO (``GT_RL``, ``value_uses_graph``) with
    the committed weights and the encoding they carry, the reset state the
    reference evaluated from, and the ``.npz`` tree (its ``reference``
    results)."""
    from tarl_tpu_torch.config import RLConfig
    from tarl_tpu_torch.convert import (
        load_params_npz, mpnn_params_from_numpy)
    from tarl_tpu_torch.core.step import Policy, init_sim_state
    from tarl_tpu_torch.io.matsim import load_network, load_population
    from tarl_tpu_torch.io.scenarios import ensure_scenario
    from tarl_tpu_torch.models.transformer.agent import (
        TransformerRoutePolicy, TransformerValueNet)
    from tarl_tpu_torch.rl.ppo import PPO
    from tarl_tpu_torch.routing.policies import random_choice

    base = ensure_scenario(os.path.join(ROOT, "build", "scenarios"),
                           "Braess")
    net = load_network(os.path.join(base, "network"), device=dev)
    agents, _ = load_population(os.path.join(base, "population"),
                                os.path.join(base, "network"), device=dev)
    st = init_sim_state(net, agents, policy=Policy(choice=random_choice))
    tree = load_params_npz(os.path.join(ROOT, GT_WEIGHTS))
    pe = tree["pe"]
    ppo = PPO(net, TransformerRoutePolicy(pe), TransformerValueNet(pe),
              rl=RLConfig(**GT_RL), value_uses_graph=True)
    return net, agents, st, ppo, mpnn_params_from_numpy(tree, dev), \
        tree


def _outcome(sim) -> tuple[int, float, float]:
    """Done count, average travel time and TSTT of an evaluation's final
    ``SimState``, as the reference's export script counts them."""
    from tarl_tpu_torch.core.step import average_travel_time
    from tarl_tpu_torch.metrics.equilibrium import tstt

    a = sim.agents
    return (int(a.done[1:].sum()), float(average_travel_time(a)),
            float(tstt(a, sim.time)))


def _check_outcome(label: str, got: tuple, ref: dict) -> str:
    """Asserts the done count equal to the reference's recorded ``ref`` and
    the TSTT within ``GT_TSTT_RTOL`` of it; returns both side by side."""
    done, att, tstt = got
    r_done, r_att, r_tstt = (int(ref["done"]), float(ref["avg_travel_time"]),
                             float(ref["tstt"]))
    text = (f"done {done} (reference {r_done}), average travel time "
            f"{att:.3f} s (reference {r_att:.3f} s), TSTT {tstt:.1f} s "
            f"(reference {r_tstt:.1f} s)")
    if done != r_done or abs(tstt - r_tstt) > GT_TSTT_RTOL * r_tstt:
        raise AssertionError(f"{label}: {text}: not within "
                             f"{GT_TSTT_RTOL:.1%}")
    return text


def gt_greedy_steps(ppo, params, st, steps: int, on_card: bool,
                    check_at: int = GT_CHECK_STEPS):
    """``steps`` greedy steps as ``PPO.eval_rollout`` takes them, written
    out to record each action and to time the policy's forward with CUDA
    events.  Returns ``(env, actions [steps, Ef] numpy, forward ms, the
    outcome after check_at steps)``."""
    import torch

    from tarl_tpu_torch.core import rng
    from tarl_tpu_torch.rl.env import env_reset, env_step

    key = rng.prng_key(0)
    env, obs = env_reset(st, ppo.network, ppo.rl, ppo.physics, ppo._dist_ff)
    actions, marks, at_check = [], [], None
    with torch.no_grad():
        for i in range(steps):
            key, _k = rng.split(key)
            x = ppo._context(env, obs)
            m0 = _stamp(on_card)
            logits = ppo._policy_logits(params["policy"], x)
            marks.append((m0, _stamp(on_card)))
            action = ppo._dist(logits).mode()
            actions.append(action)
            env, obs, *_ = env_step(env, action, ppo.network, ppo.rl,
                                    ppo.sim_cfg, ppo.physics,
                                    dist_ff=ppo._dist_ff)
            if i + 1 == check_at:
                at_check = _outcome(env.sim)
    if on_card:
        torch.cuda.synchronize()
    forward_ms = sum(_ms_between(a, b) for a, b in marks)
    return env, torch.stack(actions).cpu().numpy(), forward_ms, at_check


def gt_recorded_eval(dev, card: str, steps=GT_EVAL_STEPS,
                     context=GT_CONTEXT_STEPS) -> dict:
    """Phase 27a: the committed Braess weights against the reference's
    recorded results: the first ``context`` greedy steps written out (the
    first ``GT_CHECK_STEPS`` actions and the outcome there), again with
    ``PLAIN`` and the plain K1, and the sampled evaluation of ``steps``
    steps from key ``GT_SAMPLE_KEY``."""
    import numpy as np
    import torch

    from tarl_tpu_torch.core import rng
    from tarl_tpu_torch.core.fused_winner import direction_confirm_plain
    from tarl_tpu_torch.ops import segment as seg

    on_card = dev.type == "cuda"
    net, agents, st, ppo, params, tree = gt_braess(dev)
    rec = tree["reference"]

    # The first `context` greedy steps written out (actions and the
    # forward's time), then with the plain versions: bitwise at step
    # `context`.
    reset_counts()
    t0 = time.perf_counter()
    env_k, actions, fwd_ms, at_check = gt_greedy_steps(ppo, params, st,
                                                       context, on_card)
    loop_wall = time.perf_counter() - t0
    loop_counts = counts()
    want = {"K1": context, "K11": context, "K9": 0, "K10": 0, "K12": 0,
            "K7": 0, "choice": 0}
    if on_card and loop_counts != want:
        raise AssertionError(f"27a: greedy launches {loop_counts}, "
                             f"expected {want}")
    recorded = rec[f"actions_{GT_CHECK_STEPS}"]
    parted = [i for i in range(GT_CHECK_STEPS)
              if not np.array_equal(actions[i], recorded[i])]
    if parted:
        raise AssertionError(
            f"27a: the greedy actions part from the reference's at step "
            f"{parted[0]} ({len(parted)} of {GT_CHECK_STEPS} steps differ)")
    greedy = _check_outcome(f"27a greedy at step {GT_CHECK_STEPS}",
                            at_check, rec[f"eval_{GT_CHECK_STEPS}"])
    reset_counts()
    env_p, _, _, _ = ppo.eval_rollout(params, st, rng.prng_key(0), context,
                                      segment_ops=seg.PLAIN,
                                      core=direction_confirm_plain)
    plain_counts = counts()
    if any(plain_counts[k] for k in ("K1", "K9", "K10", "K11")):
        raise AssertionError(f"27a: the plain run launched a kernel: "
                             f"{plain_counts}")
    bad = _diff_paths(_env_bits(env_k), _env_bits(env_p))
    if bad:
        raise AssertionError(f"27a: kernel and plain runs differ at step "
                             f"{context}: {bad}")

    # The sampled evaluation through the entry point.
    reset_counts()
    t0 = time.perf_counter()
    env, rewards, _, _ = ppo.eval_rollout(params, st,
                                          rng.prng_key(GT_SAMPLE_KEY), steps,
                                          deterministic=False)
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    want = {"K1": steps, "K11": steps, "K9": 0, "K10": 0, "K12": 0, "K7": 0,
            "choice": 0}
    if on_card and launches != want:
        raise AssertionError(f"27a: launches {launches}, expected {want}")
    if not bool(torch.isfinite(rewards).all()):
        raise AssertionError("27a: a reward is not finite")
    sampled = _check_outcome(f"27a sampled, {steps} steps",
                             _outcome(env.sim), rec[f"sampled_{steps}"])

    # The forward alone on the reset's context, with and without
    # deterministic algorithms (this phase runs under them).
    from tarl_tpu_torch.rl.env import env_reset

    env0, obs0 = env_reset(st, net, ppo.rl, ppo.physics, ppo._dist_ff)
    x0 = ppo._context(env0, obs0)

    def forward(x):
        with torch.no_grad():
            return ppo._policy_logits(params["policy"], x)

    fwd = {}
    if on_card:
        fwd["det"] = time_per_call(forward, (x0,), GT_TIMED_CALLS)
        torch.use_deterministic_algorithms(False)
        try:
            fwd["free"] = time_per_call(forward, (x0,), GT_TIMED_CALLS)
            fwd["device"], fwd["acts"] = device_time_per_call(
                forward, (x0,), GT_TIMED_CALLS)
        finally:
            torch.use_deterministic_algorithms(True)
    log(f"27a recorded Braess transformer, sampled (key {GT_SAMPLE_KEY}): "
        f"{steps} steps in {wall:.2f} s, {wall / steps * 1e3:.3f} ms/step; "
        f"{sampled}; launches {launches}; greedy, the first {context} steps "
        f"written out in {loop_wall:.2f} s, {loop_wall / context * 1e3:.3f} "
        f"ms/step, the forward {fwd_ms / context:.3f} ms/step (CUDA events), "
        f"launches {loop_counts}: the first {GT_CHECK_STEPS} actions equal "
        f"the reference's, at step {GT_CHECK_STEPS} {greedy}; with PLAIN "
        f"and the plain K1 the state at step {context} is bitwise the "
        f"kernels' (plain launches {plain_counts}) ({card})")
    if fwd:
        log(f"27a the policy's forward alone (Braess, E "
            f"{net.full_src.shape[0]}): {fwd['det']:.3f} ms a call under "
            f"deterministic algorithms, {fwd['free']:.3f} ms without (CUDA "
            f"events, {GT_TIMED_CALLS} calls); device "
            f"{fmt_us(fwd['device'])} in {fwd['acts']:.1f} kernels a call "
            f"(torch.profiler) ({card})")
    return {"launches": launches, "ms_step": wall / steps * 1e3,
            "greedy_ms_step": loop_wall / context * 1e3,
            "forward_ms_step": fwd_ms / context, "forward": fwd,
            "ppo": ppo, "params": params, "st": st}


def gt_training(ppo, params, st, card: str, collect=GT_COLLECT_STEPS
                ) -> dict:
    """Phase 27b: ``collect`` collection steps from the committed weights,
    then one ``train_iteration`` at the recorded run's settings
    (``GT_RL``: 512 steps, 4 epochs of minibatches of 128), its
    collection, GAE and update timed by CUDA events."""
    import math

    import torch

    from tarl_tpu_torch.core import rng

    on_card = st.road.count.device.type == "cuda"
    ts = ppo.init(st, rng.prng_key(0), torch.Generator().manual_seed(0))
    ts = ts._replace(params=params, opt_state=ppo.optimizer.init(params))
    steps = ppo.rl.rollout_steps
    ppo.rl = dataclasses.replace(ppo.rl, rollout_steps=collect)
    try:
        reset_counts()
        t0 = time.perf_counter()
        _, _, _, traj, last = ppo.collect_rollout(params, ts.env, ts.obs,
                                                  ts.key)
        if on_card:
            torch.cuda.synchronize()
        c_wall = time.perf_counter() - t0
        c_counts = counts()
    finally:
        ppo.rl = dataclasses.replace(ppo.rl, rollout_steps=steps)
    want = {"K1": collect, "K9": 0, "K10": collect, "K11": collect,
            "K12": 0, "K7": 0, "choice": 0}
    if on_card and c_counts != want:
        raise AssertionError(f"27b: collection launches {c_counts}, "
                             f"expected {want}")
    if not (bool(torch.isfinite(traj.log_prob).all())
            and bool(torch.isfinite(traj.value).all())
            and bool(torch.isfinite(last))):
        raise AssertionError("27b: a log-prob or value is not finite")
    probe = TrainProbe(ppo, on_card)
    reset_counts()
    ts1, metrics = ppo.train_iteration(ts)
    rec = probe.records[-1]
    n_mb = max(steps // min(ppo.rl.minibatch_size, steps), 1)
    updates = ppo.rl.num_epochs * n_mb
    col = rec["collection_launches"]
    if on_card and ({k: col[k] for k in ("K1", "K10", "K11", "K9")}
                    != {"K1": steps, "K10": steps, "K11": steps, "K9": 0}
                    or any(rec["gae_launches"].values())
                    or any(rec["update_launches"].values())):
        raise AssertionError(f"27b: iteration launches: collection {col}, "
                             f"GAE {rec['gae_launches']}, update "
                             f"{rec['update_launches']}")
    if rec["updates"] != updates:
        raise AssertionError(f"27b: {rec['updates']} updates, expected "
                             f"{updates}")
    values = [float(v) for v in metrics]
    finite = all(bool(torch.isfinite(t).all()) for sub in ts1.params.values()
                 for t in sub.values())
    changed = sum(int((ts1.params[p][k] != params[p][k]).sum())
                  for p in params for k in params[p])
    total = sum(t.numel() for sub in params.values() for t in sub.values())
    if not (finite and all(map(math.isfinite, values)) and changed > 0):
        raise AssertionError(f"27b: parameters finite {finite}, changed "
                             f"{changed}, metrics {values}")
    log(f"27b transformer training (Braess): {collect} collection steps in "
        f"{c_wall:.2f} s, {c_wall / collect * 1e3:.3f} ms/step, launches "
        f"{c_counts}; one train_iteration ({steps} steps, "
        f"{ppo.rl.num_epochs} epochs, minibatch {ppo.rl.minibatch_size}, "
        f"{updates} updates) in {rec['wall_ms']:.1f} ms: collection "
        f"{rec['collection_ms']:.1f} ms, GAE {rec['gae_ms']:.2f} ms, update "
        f"{rec['update_ms']:.1f} ms (CUDA events); collection launches "
        f"{col}; loss {float(metrics.loss_total):.5g}, approx_kl "
        f"{float(metrics.approx_kl):.4g}, grad_norm "
        f"{float(metrics.grad_norm):.4g}; {changed} of {total} parameters "
        f"changed, all finite ({card})")
    return {"collect": c_counts, "iteration": col,
            "collect_ms_step": c_wall / collect * 1e3,
            "iteration_ms": rec["wall_ms"],
            "split_ms": (rec["collection_ms"], rec["gae_ms"],
                         rec["update_ms"])}


def gt_cli(dev, card: str, root: str = None, window=GT_CLI_WINDOW,
           eval_window=GT_CLI_EVAL_WINDOW) -> dict:
    """Phase 27c: ``runner.main`` with ``--algo transformer+ppo --mode
    train`` (``GT_CLI_TRAIN``) over ``window``, its checkpoint evaluated
    there, and ``--algo transformer --mode eval`` of the committed weights
    over ``eval_window``, against the reference's recorded greedy outcome;
    from ``root`` (default ``build/cli``)."""
    import numpy as np
    import torch

    from tarl_tpu_torch import runner
    from tarl_tpu_torch.convert import load_params_npz

    on_card = dev.type == "cuda"
    root = root or os.path.join(ROOT, "build", "cli")
    os.makedirs(root, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(root)
    try:
        dev_args = ["--device", dev.type]
        steps = window[1] - window[0]
        eval_steps = eval_window[1] - eval_window[0]
        rollout = int(GT_CLI_TRAIN[GT_CLI_TRAIN.index("--rollout-steps") + 1])
        iters = int(GT_CLI_TRAIN[GT_CLI_TRAIN.index("--iterations") + 1])
        runs, seconds, launches = {}, {}, {}
        for label, argv, win in (
                ("train", GT_CLI_TRAIN + ["--mode", "train"], window),
                ("checkpoint", GT_CLI_TRAIN[:4] + [
                    "--mode", "eval", "--checkpoint",
                    os.path.join("gt_train", "checkpoints")], window),
                ("eval", ["--algo", "transformer", "--scenario", "Braess",
                          "--mode", "eval", "--checkpoint",
                          os.path.join(ROOT, GT_WEIGHTS)], eval_window)):
            reset_counts()
            t0 = time.perf_counter()
            runs[label] = runner.main(argv + [
                "--start-end-time", str(win[0]), str(win[1]),
                "--output-dir", f"gt_{label}"] + dev_args)
            seconds[label] = time.perf_counter() - t0
            launches[label] = counts()
    finally:
        os.chdir(cwd)
    env_steps = iters * rollout * 2 + steps
    want = {"train": {"K1": env_steps, "K9": 0, "K10": iters * rollout,
                      "K11": env_steps},
            "checkpoint": {"K1": steps, "K9": 0, "K10": 0, "K11": steps},
            "eval": {"K1": eval_steps, "K9": 0, "K10": 0,
                     "K11": eval_steps}}
    if on_card:
        for label, w in want.items():
            have = {k: launches[label][k] for k in w}
            if have != w:
                raise AssertionError(f"27c {label}: launches {have}, "
                                     f"expected {w}")
    p_a = runs["train"].train_state.params
    p_b = runs["checkpoint"].eval_params
    if not all(torch.equal(p_a[p][k], p_b[p][k]) for p in p_a for k in p_a[p]):
        raise AssertionError("27c: the restored parameters are not the "
                             "trained ones bitwise")
    same_state = not _diff_paths(_state_bits(runs["train"].sim.state),
                                 _state_bits(runs["checkpoint"].sim.state))
    tree = load_params_npz(os.path.join(ROOT, GT_WEIGHTS))
    if not np.array_equal(runs["eval"].policy_net.pe.cpu().numpy(),
                          tree["pe"]):
        raise AssertionError("27c: the eval did not take the encoding the "
                             "weights carry")
    outcome = _check_outcome("27c eval", _outcome(runs["eval"].sim.state),
                             tree["reference"][f"eval_{eval_steps}"])
    log(f"27c the CLI, {' '.join(GT_CLI_TRAIN)} over {steps} ticks: train "
        f"{seconds['train']:.2f} s (launches {launches['train']}); its "
        f"checkpoint evaluated {seconds['checkpoint']:.2f} s (parameters "
        f"restored bitwise; the evaluated state "
        f"{'bitwise' if same_state else 'not'} the trained run's, the "
        f"encoding drawn afresh, R4); --algo transformer --mode eval "
        f"--checkpoint {GT_WEIGHTS} over {eval_window[0]}-{eval_window[1]} "
        f"{seconds['eval']:.2f} s: {outcome} ({card})")
    return {"launches": launches, "seconds": seconds}


def gt_learned_episode(dev, card: str, net, agents, params,
                       ticks=GT_TICKS, warmup=WARMUP_TICKS,
                       context=GT_CONTEXT_TICKS) -> dict:
    """Phase 27d: the learned transformer on ``net, agents`` (the
    headline scenario) in phase 2's exact mode: ``make_learned_choice``
    (sampled) of a ``TransformerRoutePolicy`` with the port's encoding of
    ``net`` and the Braess weights ``params``, ``ticks`` ticks after
    ``warmup``.  The slot twin against the flat forward on three captured
    states; the first ``context`` ticks again with the plain K1."""
    import numpy as np
    import torch
    from torch.func import functional_call

    from tarl_tpu_torch.core.fused_winner import direction_confirm_plain
    from tarl_tpu_torch.core.step import init_sim_state, run_episode
    from tarl_tpu_torch.models.transformer.agent import (
        TransformerRoutePolicy, network_positional_encoding)
    from tarl_tpu_torch.rl.learned_policy import (
        make_learned_choice, rollout_context)

    on_card = dev.type == "cuda"
    t0 = time.perf_counter()
    pe = network_positional_encoding(net, 16)
    pe_s = time.perf_counter() - t0
    policy_net = TransformerRoutePolicy(pe).to(dev)
    policy = make_learned_choice(policy_net, params["policy"], net)
    marks = []

    def timed_choice(state, network):
        m0 = _stamp(on_card)
        out = policy.choice(state, network)
        marks.append((m0, _stamp(on_card)))
        return out

    timed = policy._replace(choice=timed_choice)
    sim = headline_sim(ticks=warmup + ticks)
    res = headline_run(net, agents, sim, timed, ticks=warmup + ticks,
                       warmup=warmup, capture_every=context)
    choice_ms = sum(_ms_between(a, b) for a, b in marks[warmup:]) / ticks
    check_headline(res, "27d", {"K1": warmup + ticks, "K9": 0, "K10": 0,
                                "K11": 0, "K12": 0, "K7": 0, "choice": 0}
                   if on_card else {})
    # The slot twin against the flat forward on captured states.
    spec = policy.learned
    tables = spec.slot_tables
    cols = torch.arange(net.num_nodes, dtype=torch.int32, device=dev)
    src = net.full_src.cpu().numpy()
    rank = np.zeros(len(src), np.int64)
    seen = np.zeros(net.num_nodes, np.int64)
    for e, s in enumerate(src):
        rank[e], seen[s] = seen[s], seen[s] + 1
    worst = 0.0
    with torch.no_grad():
        for state in res["captured"][1:1 + GT_CAPTURES]:
            x = rollout_context(state, net)
            slot = functional_call(spec.slot_net, spec.params,
                                   (x, tables, cols))
            flat = functional_call(policy_net, spec.params,
                                   (x, net.full_attr.reshape(-1, 1),
                                    net.full_src, net.full_dst))
            got = slot[torch.as_tensor(rank, device=dev), net.full_src.long()]
            bad = ~torch.isclose(got, flat, rtol=2e-5, atol=2e-5)
            if bool(bad.any()):
                raise AssertionError(
                    f"27d: the slot twin and the flat forward differ on "
                    f"{int(bad.sum())} edges, worst "
                    f"{float((got - flat).abs().max()):.3g}")
            worst = max(worst, float((got - flat).abs().max()))
    # The first `context` ticks again with the plain K1, cut into calls
    # as the kernel run was (warm-up, then the rest): backlog mode keeps
    # the inserted flag lazily within a call, so a learned episode depends
    # on its cut (the reference's fault R5).
    state0 = init_sim_state(net, agents, sim=sim, policy=policy)
    cuts = (warmup, context - warmup)
    plain = state0
    reset_counts()
    for n in cuts:
        plain, _ = run_episode(plain, net, policy, n, sim=sim,
                               core=direction_confirm_plain)
    if counts()["K1"]:
        raise AssertionError("27d: the plain run launched K1")
    bad = _diff_paths(_state_bits(res["captured"][0]), _state_bits(plain))
    if bad:
        raise AssertionError(f"27d: K1 and the plain K1 differ at tick "
                             f"{context}: {bad}")
    ms_tick = res["wall"] / res["measured"] * 1e3
    log(f"27d learned transformer on {net.num_roads} roads, "
        f"{net.num_nodes} nodes, {net.full_src.shape[0]} full edges, "
        f"{agents.num_agents} agent rows (encoding drawn in {pe_s:.2f} s; "
        f"slot tables KA {tables.in_ok.shape[0]}, KF "
        f"{tables.out_ok.shape[0]}): {res['rate']:.1f} agent-steps/s, "
        f"{ms_tick:.3f} ms/tick over {res['measured']} ticks after "
        f"{warmup}, the choice {choice_ms:.3f} ms/tick (CUDA events), done "
        f"{res['done']}, on roads {res['on_road']}, average travel time "
        f"{res['avg_tt']:.3f} s, overflow {res['overflow']}, host reads per "
        f"tick {res['syncs_per_tick']:.3f}, launches {res['launches']}; the "
        f"slot twin within 2e-5 of the flat forward on {GT_CAPTURES} "
        f"captured states (worst {worst:.3g}); the first {context} ticks "
        f"bitwise with the plain K1 ({card})")
    return {"launches": res["launches"], "ms_tick": ms_tick,
            "choice_ms": choice_ms, "rate": res["rate"],
            "done": res["done"], "policy": policy, "sim": sim,
            "net": net, "state0": state0, "cuts": cuts, "want": plain}


def transformer_phase(dev, card: str, net, agents, cli_root: str = None,
                      eval_steps=GT_EVAL_STEPS, context=GT_CONTEXT_STEPS,
                      collect=GT_COLLECT_STEPS, ticks=GT_TICKS,
                      warmup=WARMUP_TICKS, tick_context=GT_CONTEXT_TICKS
                      ) -> dict:
    """Phase 27: (a) the recorded Braess weights, under
    ``torch.use_deterministic_algorithms(True)`` (the flat forward's
    segment sums are ``index_add_``, whose atomics would otherwise order
    the sums anew in each run, and (a) compares two runs bitwise); (b)
    training, (c) the CLI, (d) a learned episode on ``net, agents``."""
    import torch

    t0 = time.perf_counter()
    was_det = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        a = gt_recorded_eval(dev, card, eval_steps, context)
    finally:
        torch.use_deterministic_algorithms(was_det)
    b = gt_training(a["ppo"], a["params"], a["st"], card, collect)
    c = gt_cli(dev, card, cli_root)
    d = gt_learned_episode(dev, card, net, agents, a["params"], ticks,
                           warmup, tick_context)
    return {"a": a, "b": b, "c": c, "d": d,
            "seconds": time.perf_counter() - t0}


# --- training (phase 21) -----------------------------------------------------

def _stamp(on_card: bool):
    """A point on the device's timeline (a recorded CUDA event) or, on the
    CPU, the host clock."""
    import torch

    if not on_card:
        return time.perf_counter()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _ms_between(a, b) -> float:
    return a.elapsed_time(b) if hasattr(a, "elapsed_time") else (b - a) * 1e3


@contextlib.contextmanager
def deterministic():
    """``torch.use_deterministic_algorithms(True)`` (uninitialised memory
    left unfilled) for the block, restored after it."""
    import torch

    was_det = torch.are_deterministic_algorithms_enabled()
    was_fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was_det)
        torch.utils.deterministic.fill_uninitialized_memory = was_fill


class TrainProbe:
    """Wraps a ``PPO``'s ``collect_rollout`` (or ``collector``'s method
    ``collect_name`` of the same signature and result) and
    ``_update_epochs`` and a trainer's ``train_iteration`` (the ``PPO``'s
    own, or a ``BatchedPPO``'s, ``ShardedPPO``'s or ``SpatialPPO``'s over
    it) on the instances and keeps, per iteration, the state in and out,
    the metrics, the trajectories (one per replica) and their last values,
    the number of
    updates, and at each boundary (the first collection's start, the last
    one's end, the update's start and end) a device stamp, the launch
    counts and the host reads (read, never reset, so the counts of the
    whole run stay whole).  The only work between the collections' end and
    the update's start is GAE and the advantages' normalisation."""

    def __init__(self, ppo, on_card: bool, trainer=None, collector=None,
                 collect_name: str = "collect_rollout"):
        trainer = trainer or ppo
        collector = collector or ppo
        self.on_card = on_card
        self.records = []
        self._collect = getattr(collector, collect_name)
        self._update = ppo._update_epochs
        self._iterate = trainer.train_iteration
        setattr(collector, collect_name, self.collect_rollout)
        ppo._update_epochs = self.update_epochs
        trainer.train_iteration = self.train_iteration

    def _mark(self, name: str) -> None:
        from tarl_tpu_torch.core import sync

        self.rec[name] = (_stamp(self.on_card), counts(), sync.HOST_READS)

    def collect_rollout(self, *args, **kw):
        if "collect0" not in self.rec:
            self._mark("collect0")
        out = self._collect(*args, **kw)
        self._mark("collect1")
        self.rec["trajs"].append(out[3])
        self.rec["lasts"].append(out[4])
        return out

    def update_epochs(self, *args, **kw):
        self._mark("update0")
        out = self._update(*args, **kw)
        self._mark("update1")
        self.rec["updates"] = len(out[1])
        return out

    def train_iteration(self, ts, *args, **kw):
        import torch

        self.rec = {"ts_in": ts, "trajs": [], "lasts": []}
        t0 = time.perf_counter()
        ts_out, metrics = self._iterate(ts, *args, **kw)
        if self.on_card:
            torch.cuda.synchronize()
        rec = self.rec
        rec.update(ts_out=ts_out, metrics=metrics,
                   wall_ms=(time.perf_counter() - t0) * 1e3)
        for name, (a, b) in (("collection", ("collect0", "collect1")),
                             ("gae", ("collect1", "update0")),
                             ("update", ("update0", "update1"))):
            rec[f"{name}_ms"] = _ms_between(rec[a][0], rec[b][0])
            rec[f"{name}_launches"] = {k: rec[b][1][k] - rec[a][1][k]
                                       for k in rec[a][1]}
            rec[f"{name}_reads"] = rec[b][2] - rec[a][2]
        self.records.append(rec)
        return ts_out, metrics


def _tree_diff(a: dict, b: dict) -> tuple[float, dict, int]:
    """The largest absolute difference between two parameter trees, the
    share of elements within 1e-5, 1e-4 and 1e-3, and the element count."""
    import torch

    d = torch.cat([(a[p][k] - b[p][k]).abs().reshape(-1).cpu()
                   for p in a for k in a[p]])
    shares = {tol: float((d <= tol).to(torch.float64).mean())
              for tol in (1e-5, 1e-4, 1e-3)}
    return float(d.max()), shares, d.numel()


def _trees_equal(a: dict, b: dict) -> bool:
    import torch

    return all(torch.equal(a[p][k], b[p][k]) for p in a for k in a[p])


def training_phase(net8, trained, st8, card: str,
                   iterations: int = TRAIN_ITERATIONS) -> dict:
    """Phase 21: ``ppo_train`` for ``iterations`` iterations from the
    committed weights (restored from a ``ckpt_0`` written beside them),
    with a checkpoint every iteration, under
    ``torch.use_deterministic_algorithms(True)``; then the first iteration
    again with ``PLAIN`` in the collection, and the last again from
    ``ckpt_2`` by ``ppo_train``'s resume.  Asserts finite metrics,
    ``approx_kl`` >= 0, the updates per iteration, one K1, K11 and K10
    launch per collection step and none in GAE or the update, bitwise equal
    trajectories with and without the kernels (log-probs within rtol 1e-5,
    atol 1e-5), the parameters of the two within twice the learning rate
    times the updates (printed with the shares within 1e-5, 1e-4 and
    1e-3), and the resumed run bitwise equal to the uninterrupted one.  Returns
    the numbers for the results line."""
    import shutil

    import torch

    from tarl_tpu_torch.core import rng, sync
    from tarl_tpu_torch.ops import segment as seg
    from tarl_tpu_torch.rl.checkpoint import save_checkpoint
    from tarl_tpu_torch.rl.trainer import ppo_train

    on_card = st8.road.count.device.type == "cuda"
    root = os.path.join(ROOT, "build", "train")
    shutil.rmtree(root, ignore_errors=True)
    dir_a, dir_b = os.path.join(root, "run"), os.path.join(root, "resumed")
    ppo = learned_ppo(net8)
    rl = ppo.rl
    steps = rl.rollout_steps
    n_mb = max(steps // min(rl.minibatch_size, steps), 1)
    updates = rl.num_epochs * n_mb
    probe = TrainProbe(ppo, on_card)
    save_checkpoint(os.path.join(dir_a, "ckpt_0"), trained,
                    ppo.optimizer.init(trained), 0)
    kw = dict(key=rng.prng_key(0), generator=torch.Generator().manual_seed(0),
              rl=rl, checkpoint_interval=1, eval_interval=0, resume=True,
              verbose=False)
    with deterministic():
        reset_counts()
        t0 = time.perf_counter()
        ts_a = ppo_train(ppo, st8, num_iterations=iterations,
                         checkpoint_dir=dir_a, **kw)
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        run_counts = counts()
        run_reads = sync.HOST_READS
        records = list(probe.records)
        ppo.train_iteration(records[0]["ts_in"], seg.PLAIN)
        plain = probe.records[-1]
        os.makedirs(dir_b)
        shutil.copy(os.path.join(dir_a, f"ckpt_{iterations - 1}"), dir_b)
        ts_b = ppo_train(ppo, st8, num_iterations=iterations,
                         checkpoint_dir=dir_b, **kw)

    want_run = {"K1": iterations * steps, "K9": 0, "K10": iterations * steps,
                "K11": iterations * steps, "K12": 0, "K7": 0, "choice": 0}
    if on_card and run_counts != want_run:
        raise AssertionError(f"training: launches {run_counts}, expected "
                             f"{want_run}")
    want_collect = {k: v // iterations for k, v in want_run.items()}
    idle = {k: 0 for k in want_run}
    for i, rec in enumerate(records, 1):
        m = rec["metrics"]
        values = {f: float(getattr(m, f)) for f in m._fields}
        bad = [f for f, v in values.items() if v != v or abs(v) == float(
            "inf")]
        if bad:
            raise AssertionError(f"training iteration {i}: not finite: {bad}")
        if values["approx_kl"] < -1e-6:
            raise AssertionError(f"training iteration {i}: approx_kl "
                                 f"{values['approx_kl']}")
        if rec["updates"] != updates:
            raise AssertionError(f"training iteration {i}: {rec['updates']} "
                                 f"updates, expected {updates}")
        if on_card and (rec["collection_launches"] != want_collect
                        or rec["gae_launches"] != idle
                        or rec["update_launches"] != idle):
            raise AssertionError(
                f"training iteration {i}: launches, collection "
                f"{rec['collection_launches']}, GAE {rec['gae_launches']}, "
                f"update {rec['update_launches']}")
        per_step = {k: v / steps for k, v in rec["collection_launches"].items()
                    if k in ("K1", "K9", "K10", "K11")}
        log(f"training iteration {i}/{iterations}: collection "
            f"{rec['collection_ms']:.3f} ms ({steps} steps, "
            f"{rec['collection_ms'] / steps:.3f} ms/step), GAE "
            f"{rec['gae_ms']:.3f} ms, update {rec['update_ms']:.3f} ms "
            f"({rec['updates']} updates, "
            f"{rec['update_ms'] / rec['updates']:.3f} ms each), iteration "
            f"{rec['wall_ms']:.3f} ms (host clock; device stamps: "
            f"{'CUDA events' if on_card else 'host clock'}); launches per "
            f"collection step {per_step}, in GAE "
            f"{sum(rec['gae_launches'].values())}, in the update "
            f"{sum(rec['update_launches'].values())}; host reads: "
            f"collection {rec['collection_reads']}, GAE {rec['gae_reads']}, "
            f"update {rec['update_reads']}; metrics "
            + ", ".join(f"{f} {v:.6g}" for f, v in values.items())
            + f" ({card})")
    if ts_a.opt_state.count != iterations * updates:
        raise AssertionError(f"training: {ts_a.opt_state.count} updates in "
                             f"all, expected {iterations * updates}")

    # The kernels against their plain versions on the training path.
    kern, first = records[0]["trajs"][0], plain["trajs"][0]
    mismatched = [f for f in ("action", "reward", "done", "value")
                  if not torch.equal(getattr(kern, f).cpu().view(torch.uint8),
                                     getattr(first, f).cpu().view(
                                         torch.uint8))]
    if mismatched:
        raise AssertionError(f"training: the KERNELS and PLAIN collections "
                             f"differ in {mismatched}")
    lp_err = _max_abs_diff(kern.log_prob, first.log_prob)
    if not torch.allclose(kern.log_prob.cpu(), first.log_prob.cpu(),
                          rtol=1e-5, atol=1e-5):
        raise AssertionError(f"training: log-probs differ beyond rtol 1e-5, "
                             f"atol 1e-5 (max |diff| {lp_err})")
    if on_card and any(plain["collection_launches"][k]
                       for k in ("K9", "K10", "K11")):
        raise AssertionError(f"training: the PLAIN collection launched "
                             f"{plain['collection_launches']}")
    # Adam divides each element's gradient by its own RMS: an element whose
    # gradient is rounding noise (the per-node softmax is invariant to a
    # shift shared by a node's out-edges) steps by up to the rate either
    # way, and the updates after it start from parameters that differ.
    # The tolerance is Adam's reach: twice the rate times the updates.
    worst, shares, numel = _tree_diff(records[0]["ts_out"].params,
                                      plain["ts_out"].params)
    bound = 2 * rl.learning_rate * updates
    if not worst <= bound:
        raise AssertionError(
            f"training: parameters after the KERNELS and PLAIN iterations "
            f"differ by up to {worst}, beyond {bound}")
    log(f"training, KERNELS against PLAIN in the collection of iteration 1: "
        f"actions, rewards, dones and values bitwise equal, log-probs within "
        f"max |diff| {lp_err:.3g}; parameters after the {updates} updates "
        f"within {worst:.3g} of each other (tolerance {bound:g}, 2 x "
        f"learning rate x updates), of {numel} elements "
        + ", ".join(f"{v:.4%} within {t:g}" for t, v in shares.items())
        + f"; PLAIN launches {plain['collection_launches']}")

    # The checkpoint's round trip: iteration 3 from ckpt_2.
    resumed = (_trees_equal(ts_b.params, ts_a.params)
               and _trees_equal(ts_b.opt_state.mu, ts_a.opt_state.mu)
               and _trees_equal(ts_b.opt_state.nu, ts_a.opt_state.nu)
               and ts_b.opt_state.count == ts_a.opt_state.count
               and ts_b.key == ts_a.key and ts_b.iteration == iterations)
    if not resumed:
        worst_b = _tree_diff(ts_b.params, ts_a.params)[0]
        raise AssertionError(f"training: the run resumed from ckpt_"
                             f"{iterations - 1} differs from the "
                             f"uninterrupted one (parameters by up to "
                             f"{worst_b})")
    log(f"training: {iterations} iterations of ppo_train in {wall:.2f} s "
        f"({iterations * steps} collection steps, {iterations * updates} "
        f"Adam updates, deterministic algorithms on); host reads "
        f"{run_reads}; launches {run_counts}; the run resumed from ckpt_"
        f"{iterations - 1} ends bitwise equal to the uninterrupted one "
        f"(parameters, Adam state, key) ({card})")
    return {"launches": run_counts, "records": records, "wall": wall,
            "param_worst": worst, "param_shares": shares,
            "log_prob_err": lp_err}


# --- batched training and the native parser (phase 28) ----------------------

def note_parse(label: str, net_s: float, pop_s: float, stats) -> None:
    """Keep (and print) a scenario's parse: the network's and the
    population's seconds and which parser read the population."""
    why = f", {stats.fallback}" if stats.fallback else ""
    PARSES.append({"scenario": label, "network_s": net_s,
                   "population_s": pop_s, "parser": stats.parser,
                   "fallback": stats.fallback})
    log(f"scenario {label}: network parsed and built in {net_s:.3f} s, "
        f"population parsed in {pop_s:.3f} s ({stats.parser} parser{why}; "
        f"{stats.total_trips} trips)")


def compare_parsers(label: str, base: str) -> dict:
    """The scenario under ``base`` parsed by the Python and the native
    parser (network and population each): the rows, link arrays,
    intersection ids and positions bitwise equal.  Returns the seconds."""
    import numpy as np

    from tarl_tpu_torch.io.matsim import (parse_network_xml,
                                          parse_population_xml)

    out, secs = {}, {}
    for parser in ("python", "native"):
        net = parse_network_xml(os.path.join(base, "network"), parser)
        rows, stats = parse_population_xml(os.path.join(base, "population"),
                                           net, parser)
        if (net.parser, stats.parser) != (parser, parser):
            raise AssertionError(f"{label}: asked for the {parser} parser, "
                                 f"got {net.parser} and {stats.parser}")
        out[parser] = (net, rows)
        secs[parser] = (net.seconds, stats.seconds)
    (py, py_rows), (nat, nat_rows) = out["python"], out["native"]
    bad = [f for f in ("length", "max_flow", "free_speed", "perm_lanes",
                       "from_inter", "to_inter")
           if getattr(py, f).dtype != getattr(nat, f).dtype
           or not np.array_equal(getattr(py, f), getattr(nat, f))]
    if py_rows.dtype != nat_rows.dtype or not np.array_equal(py_rows,
                                                             nat_rows):
        bad.append("rows")
    if py.sorted_intersections != nat.sorted_intersections:
        bad.append("intersection ids")
    if any(py.node_positions.get(i, (0.0, 0.0)) != nat.node_positions[i]
           for i in nat.sorted_intersections):
        bad.append("positions")
    if bad:
        raise AssertionError(f"{label}: the native and Python parses differ "
                             f"in {bad}")
    log(f"parsers on {label}: {py_rows.shape[0] - 1} trips, "
        f"{py.num_roads} links, {py.num_intersections} intersections, rows, "
        f"link arrays, ids and positions bitwise equal; Python "
        f"{secs['python'][0]:.3f} s network + {secs['python'][1]:.3f} s "
        f"population, native {secs['native'][0]:.3f} s + "
        f"{secs['native'][1]:.3f} s")
    return secs


# Phase 28a: the parser each scenario phase's population must take.
PARSERS_EXPECTED = {"Grid16x16_50000": "native", "Grid64x64_200000": "native",
                    "million": "native", "radial": "native",
                    "city": "python"}


def parser_phase(card: str, compared=("Grid16x16_50000", "Grid64x64_200000"),
                 want=PARSERS_EXPECTED) -> dict:
    """Phase 28a: the ``compared`` scenarios' files (by default the
    headline's and the sp row's) through both parsers, bitwise; every
    scenario phase's parse as kept by :func:`note_parse` held to ``want``:
    the native parser wherever the plans name links (the headline, the sp
    row, the million and radial rows), the Python one for the city's
    coordinate plans."""
    secs = {}
    for label in compared:
        secs[label] = compare_parsers(
            label, os.path.join(ROOT, "build", "scenarios", label))
    seen = {p["scenario"]: p for p in PARSES}
    bad = {k: seen.get(k) for k, v in want.items()
           if k not in seen or seen[k]["parser"] != v
           or (v == "python") != (seen[k]["fallback"] == "coordinate plans")}
    if bad:
        raise AssertionError(f"parsers: expected {want} (the Python parser "
                             f"for coordinate plans), got {bad}")
    log("parsers in the scenario phases: " + "; ".join(
        f"{p['scenario']} {p['parser']} (network {p['network_s']:.3f} s, "
        f"population {p['population_s']:.3f} s)" for p in PARSES)
        + f" ({card})")
    return {"compare": secs, "parses": list(PARSES)}


def batched_phase(net8, trained, st8, card: str, single: list,
                  num_envs: int = BATCH_ENVS,
                  collect_steps: int = COLLECT_STEPS) -> dict:
    """Phase 28b: one ``BatchedPPO.train_step`` of ``num_envs`` replicas at
    the recorded Grid8x8 run's settings (``learned_ppo``) from the
    committed weights, under ``torch.use_deterministic_algorithms(True)``,
    then the same step with ``PLAIN`` and the plain K1 in the collection.
    Asserts one K1, K11 and K10 launch per replica step and none in GAE
    or the update, the ``[B, T]`` actions, rewards, dones and values
    bitwise and the log-probs within rtol 1e-5 between the two, the
    parameters within twice the learning rate times the updates, finite
    metrics.  Prints the split beside phase 21's single-environment
    iterations (``single``, its probe records).  Returns the numbers for
    the results line."""
    import torch

    from tarl_tpu_torch.core import rng
    from tarl_tpu_torch.core.fused_winner import direction_confirm_plain
    from tarl_tpu_torch.ops import segment as seg
    from tarl_tpu_torch.parallel.mesh import make_mesh
    from tarl_tpu_torch.parallel.shard import BatchedPPO

    dev = st8.road.count.device
    on_card = dev.type == "cuda"
    ppo = learned_ppo(net8, collect_steps)
    rl = ppo.rl
    trainer = BatchedPPO(ppo, make_mesh(1, sp=1, device=dev), num_envs)
    steps = num_envs * rl.rollout_steps
    updates = rl.num_epochs * trainer.num_minibatches
    ts = trainer.init(st8, rng.prng_key(0),
                      torch.Generator().manual_seed(0))
    ts = ts._replace(params=trained, opt_state=ppo.optimizer.init(trained))
    probe = TrainProbe(ppo, on_card, trainer)
    with deterministic():
        reset_counts()
        trainer.train_iteration(ts)
        run_counts = counts()
        reset_counts()
        trainer.train_iteration(ts, seg.PLAIN, direction_confirm_plain)
        plain_counts = counts()
    kern, plain = probe.records
    want = {"K1": steps, "K9": 0, "K10": steps, "K11": steps, "K12": 0,
            "K7": 0, "choice": 0}
    idle = {k: 0 for k in want}
    if on_card and (run_counts != want or kern["gae_launches"] != idle
                    or kern["update_launches"] != idle
                    or plain_counts != idle):
        raise AssertionError(
            f"batched training: launches {run_counts} (GAE "
            f"{kern['gae_launches']}, update {kern['update_launches']}), "
            f"expected {want} and none in GAE or the update; the plain run "
            f"{plain_counts}")
    if kern["updates"] != updates or kern["ts_out"].opt_state.count != \
            updates:
        raise AssertionError(f"batched training: {kern['updates']} "
                             f"updates, expected {updates}")
    values = {f: float(getattr(kern["metrics"], f))
              for f in kern["metrics"]._fields}
    bad = [f for f, v in values.items() if v != v or abs(v) == float("inf")]
    if bad or values["approx_kl"] < -1e-6:
        raise AssertionError(f"batched training: metrics {values}")
    stacked = {name: {f: torch.stack([getattr(t, f) for t in rec["trajs"]])
                      for f in ("action", "reward", "done", "value",
                                "log_prob")}
               for name, rec in (("kern", kern), ("plain", plain))}
    shape = tuple(stacked["kern"]["action"].shape[:2])
    if shape != (num_envs, rl.rollout_steps):
        raise AssertionError(f"batched training: trajectories {shape}")
    mismatched = [f for f in ("action", "reward", "done", "value")
                  if not torch.equal(stacked["kern"][f].cpu().view(
                      torch.uint8), stacked["plain"][f].cpu().view(
                      torch.uint8))]
    if mismatched:
        raise AssertionError(f"batched training: the kernels' and the plain "
                             f"versions' collections differ in {mismatched}")
    lp_k, lp_p = stacked["kern"]["log_prob"], stacked["plain"]["log_prob"]
    lp_err = _max_abs_diff(lp_k, lp_p)
    if not torch.allclose(lp_k.cpu(), lp_p.cpu(), rtol=1e-5, atol=1e-5):
        raise AssertionError(f"batched training: log-probs differ beyond "
                             f"rtol 1e-5, atol 1e-5 (max |diff| {lp_err})")
    worst, shares, numel = _tree_diff(kern["ts_out"].params,
                                      plain["ts_out"].params)
    bound = 2 * rl.learning_rate * updates
    if not worst <= bound:
        raise AssertionError(f"batched training: parameters after the "
                             f"kernel and plain steps differ by up to "
                             f"{worst}, beyond {bound}")
    single_ms = [r["collection_ms"] / rl.rollout_steps for r in single]
    per_step = kern["collection_ms"] / steps
    log(f"batched training, {num_envs} replicas x {rl.rollout_steps} steps "
        f"({updates} updates of {trainer.minibatch_size}): collection "
        f"{kern['collection_ms']:.3f} ms ({per_step:.3f} ms per replica "
        f"step; phase 21's single environment "
        + ", ".join(f"{m:.3f}" for m in single_ms)
        + f" ms per step), GAE {kern['gae_ms']:.3f} ms, update "
        f"{kern['update_ms']:.3f} ms ({kern['update_ms'] / updates:.3f} ms "
        f"each), iteration {kern['wall_ms']:.3f} ms (host clock); the plain "
        f"run's collection {plain['collection_ms']:.3f} ms; launches "
        f"{run_counts}, in GAE {sum(kern['gae_launches'].values())}, in the "
        f"update {sum(kern['update_launches'].values())}; host reads: "
        f"collection {kern['collection_reads']}, GAE {kern['gae_reads']}, "
        f"update {kern['update_reads']}; metrics "
        + ", ".join(f"{f} {v:.6g}" for f, v in values.items()) + f" ({card})")
    log(f"batched training, kernels against PLAIN and the plain K1: "
        f"[{num_envs}, {rl.rollout_steps}] actions, rewards, dones and "
        f"values bitwise equal, log-probs within max |diff| {lp_err:.3g}; "
        f"parameters after the {updates} updates within {worst:.3g} "
        f"(tolerance {bound:g}), of {numel} elements "
        + ", ".join(f"{v:.4%} within {t:g}" for t, v in shares.items())
        + f"; plain launches {plain_counts}")
    return {"launches": run_counts, "record": kern, "per_step_ms": per_step,
            "single_ms": single_ms, "param_worst": worst,
            "log_prob_err": lp_err, "plain_collection_ms":
            plain["collection_ms"]}


def batched_cli(dev, card: str, root: str = None, window=CLI_WINDOW,
                num_envs: int = BATCH_ENVS) -> dict:
    """Phase 28c: ``runner.main`` with ``--algo mpnn+ppo --num-envs
    num_envs`` (phase 25's training command) over ``window``, then
    ``--mode eval --checkpoint`` of its checkpoint: the parameters restored
    bitwise, the evaluated state the trained run's, metrics finite; K10
    once a replica's collection step, K11 and K1 once an environment step,
    K9 never and no plain segment version outside the loss.  Returns the
    launch counts and seconds."""
    import math

    import torch

    from tarl_tpu_torch import runner

    on_card = dev.type == "cuda"
    root = root or os.path.join(ROOT, "build", "cli")
    os.makedirs(root, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(root)
    win = ["--start-end-time", str(window[0]), str(window[1])]
    argv = CLI_TRAIN + win + ["--num-envs", str(num_envs), "--device",
                              dev.type]
    steps = window[1] - window[0]
    rollout = int(CLI_TRAIN[CLI_TRAIN.index("--rollout-steps") + 1])
    iters = int(CLI_TRAIN[CLI_TRAIN.index("--iterations") + 1])
    calls, restore = _plain_segment_spy()
    try:
        reset_counts()
        t0 = time.perf_counter()
        trained = runner.main(argv + ["--mode", "train", "--output-dir",
                                      "train_batched"])
        train_s = time.perf_counter() - t0
        train_counts, train_calls = counts(), dict(calls)
        calls.clear()
        reset_counts()
        t0 = time.perf_counter()
        restored = runner.main(CLI_TRAIN[:4] + win + [
            "--mode", "eval", "--checkpoint",
            os.path.join("train_batched", "checkpoints"), "--output-dir",
            "eval_batched", "--device", dev.type])
        eval_s = time.perf_counter() - t0
        eval_counts, eval_calls = counts(), dict(calls)
        with open(os.path.join("train_batched", "metrics.csv")) as f:
            rows = [line.split(",") for line in f.read().split()[1:]]
    finally:
        restore()
        os.chdir(cwd)
    collect = iters * rollout * num_envs
    env_steps = collect + iters * rollout + steps
    want_train = {"K1": env_steps, "K9": 0, "K10": collect,
                  "K11": env_steps}
    want_eval = {"K1": steps, "K9": 0, "K10": 0, "K11": steps}
    if on_card:
        for label, have, want, plain in (
                ("train", train_counts, want_train, train_calls),
                ("eval", eval_counts, want_eval, eval_calls)):
            if {k: have[k] for k in want} != want or plain:
                raise AssertionError(
                    f"the batched CLI's {label} run: launches {have}, "
                    f"expected {want}; plain segment calls outside the "
                    f"loss {plain}")
    envs = trained.train_state.envs
    if envs.sim.agents.arrival.shape[0] != num_envs:
        raise AssertionError(f"the batched CLI trained "
                             f"{envs.sim.agents.arrival.shape[0]} replicas")
    p_a, p_b = trained.train_state.params, restored.eval_params
    if not all(torch.equal(p_a[part][k], p_b[part][k])
               for part in p_a for k in p_a[part]):
        raise AssertionError("the batched CLI's restored parameters are not "
                             "the trained ones bitwise")
    bad = _diff_paths(_state_bits(trained.sim.state),
                      _state_bits(restored.sim.state))
    numbers = [restored.sim.average_travel_time()] + [
        float(x) for row in rows for x in row if x]
    if bad or not all(math.isfinite(v) for v in numbers):
        raise AssertionError(f"the batched CLI: the checkpoint's evaluation "
                             f"differs in {bad}, or a metric is not finite")
    log(f"CLI (28c) {' '.join(argv)} --mode train: {train_s:.2f} s "
        f"({len(rows)} metric rows), launches {train_counts}; --mode eval "
        f"--checkpoint over {steps} ticks: {eval_s:.2f} s, launches "
        f"{eval_counts}; parameters restored bitwise, the evaluated state "
        f"the trained run's; average travel time "
        f"{restored.sim.average_travel_time():.3f} s ({card})")
    return {"train": train_counts, "eval": eval_counts, "train_s": train_s,
            "eval_s": eval_s}


def batched_parser_phase(net8, trained, st8, card: str, train: dict) -> dict:
    """Phase 28: (a) the parsers, (b) batched training, (c) the batched
    CLI; each timed."""
    out, secs = {}, {}
    for name, fn in (("a", lambda: parser_phase(card)),
                     ("b", lambda: batched_phase(net8, trained, st8, card,
                                                 train["records"])),
                     ("c", lambda: batched_cli(st8.road.count.device,
                                               card))):
        t0 = time.perf_counter()
        out[name] = fn()
        secs[name] = time.perf_counter() - t0
    log("phase 28 in " + ", ".join(f"({k}) {v:.1f} s"
                                   for k, v in secs.items()))
    out["seconds"] = secs
    return out


# --- every policy on road blocks, and blocks across processes (phase 29) ----

def blocks_run(label: str, net, state0, policy, sim, cuts, want=None,
               routing=None, blocks: int = SHARD_BLOCKS) -> dict:
    """``cuts`` ``run_episode`` calls of ``policy`` from ``state0``, serially
    (unless ``want``, the serial state at their end, is given) and then
    through ``run_episode_shard_map`` on ``make_road_mesh(blocks)``, each
    timed to a synchronise.  Asserts the sharded state equal to the serial
    one bitwise and, on the card, one K7 launch a tick and no K1 (the
    counts set to 0 just before the sharded run and read just after)."""
    import torch

    from tarl_tpu_torch.config import DEFAULT_ROUTING
    from tarl_tpu_torch.core.step import run_episode
    from tarl_tpu_torch.parallel.shard_map_episode import (
        make_road_mesh, run_episode_shard_map)

    on_card = net.device.type == "cuda"

    def sync_dev():
        if on_card:
            torch.cuda.synchronize()

    ticks = sum(cuts)
    out = {"ticks": ticks, "serial_ms": None}
    if want is None:
        want = state0
        sync_dev()
        t0 = time.perf_counter()
        for n in cuts:
            want, _ = run_episode(want, net, policy, n, sim=sim)
        sync_dev()
        out["serial_ms"] = (time.perf_counter() - t0) / ticks * 1e3
    mesh = make_road_mesh(blocks, net.device)
    state = state0
    sync_dev()
    reset_counts()
    t0 = time.perf_counter()
    for n in cuts:
        state, _ = run_episode_shard_map(state, net, policy, n, mesh,
                                         sim=sim,
                                         routing=routing or DEFAULT_ROUTING)
    sync_dev()
    out["blocks_ms"] = (time.perf_counter() - t0) / ticks * 1e3
    out["launches"] = counts()
    if on_card and (out["launches"]["K7"], out["launches"]["K1"]) != (
            ticks, 0):
        raise AssertionError(f"{label}: launches {out['launches']}, "
                             f"expected K7 {ticks}, K1 0")
    bad = _diff_paths(_state_bits(want), _state_bits(state))
    if bad:
        raise AssertionError(f"{label}: {blocks} blocks and the serial run "
                             f"differ at tick {ticks}: {bad}")
    out["done"] = int(state.agents.done.sum())
    out["on_road"] = int(state.road.count.sum())
    return out


def _blocks_rank(rank: int, world: int, backend: str, store: str,
                 blocks: int, ticks: int, out_dir: str, scenario: tuple,
                 device: str) -> None:
    """A spawned rank of phase 29d: the headline episode (phase 2's exact
    mode, random choice) on ``scenario`` (``load_scenario``'s arguments)
    for ``ticks`` ticks on ``blocks`` road blocks split over the
    ``backend`` group of ``world`` processes on ``device``, K7's inputs
    kept at the middle and the end; the last rank holds its launches
    bitwise against the plain version on them.  Writes its state and
    numbers to ``out_dir``."""
    import pickle

    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from tarl_tpu_torch.core.step import Policy, init_sim_state
    from tarl_tpu_torch.parallel.shard_map_episode import (
        make_road_mesh, run_episode_shard_map)
    from tarl_tpu_torch.routing.policies import random_choice
    from tarl_tpu_torch.state import sort_agents_by_departure

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{store}",
                            world_size=world, rank=rank)
    try:
        net, agents = load_scenario(*scenario, dev)
        agents = sort_agents_by_departure(agents)
        sim, policy = headline_sim(), Policy(choice=random_choice)
        mesh = make_road_mesh(blocks, dev, group=dist.group.WORLD)
        state = init_sim_state(net, agents, sim=sim, policy=policy)
        cap = CaptureWinner(ticks // 2, f"{backend} rank {rank}")
        if on_card:
            torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        state, _ = run_episode_shard_map(state, net, policy, ticks, mesh,
                                         sim=sim, winner=cap)
        if on_card:
            torch.cuda.synchronize()
        res = {"wall": time.perf_counter() - t0, "launches": counts(),
               "first": mesh.first, "held": mesh.held,
               "col0": [args[6] for _, args in cap.inputs],
               "state": _state_bits(state)}
        if rank == world - 1:
            res["k7_err"] = compare_shard_winner(
                [(lb, args, mesh.held) for lb, args in cap.inputs])
        with open(os.path.join(out_dir, f"{backend}{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def spawn_blocks(groups, ticks: int, scenario=HEADLINE_SCENARIO,
                 device: str = "cuda:0", timeout: float = SPAWN_TIMEOUT
                 ) -> dict:
    """Phase 29d's processes: for each ``(backend, world, blocks)`` group,
    ``world`` spawned ranks of :func:`_blocks_rank` (a ``FileStore`` of
    their own, no port), all started together and joined within
    ``timeout`` seconds; a rank that hangs is killed and fails the phase,
    as does a nonzero exit.  Returns ``{(backend, rank): result}``."""
    import multiprocessing
    import pickle
    import shutil

    out_dir = os.path.join(ROOT, "build", "blocks29")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    ctx = multiprocessing.get_context("spawn")
    procs = {}
    for backend, world, blocks in groups:
        store = os.path.join(out_dir, f"{backend}.store")
        for rank in range(world):
            procs[backend, rank] = ctx.Process(target=_blocks_rank, args=(
                rank, world, backend, store, blocks, ticks, out_dir,
                scenario, device))
    for p in procs.values():
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs.values():
            p.join(max(deadline - time.monotonic(), 0.0))
    finally:
        hung = [key for key, p in procs.items() if p.is_alive()]
        for p in procs.values():
            if p.is_alive():
                p.kill()
                p.join()
    if hung:
        raise AssertionError(f"29d: ranks {hung} did not end within "
                             f"{timeout:.0f} s")
    failed = {key: p.exitcode for key, p in procs.items() if p.exitcode}
    if failed:
        raise AssertionError(f"29d: ranks exited with {failed}")
    out = {}
    for backend, rank in procs:
        with open(os.path.join(out_dir, f"{backend}{rank}.pkl"), "rb") as f:
            out[backend, rank] = pickle.load(f)
    return out


def check_processes(results, want, ticks: int, on_card: bool) -> None:
    """Phase 29d's asserts: every rank's state equal to ``want`` (phase
    2's at the same tick) bitwise, on the card K7 once a tick on every rank
    and no K1, the last gloo rank's K7 inputs at a nonzero first column and
    its launches bitwise the plain version's."""
    for (backend, rank), res in results.items():
        bad = _diff_paths(want, res["state"])
        if bad:
            raise AssertionError(f"29d {backend} rank {rank}: the state at "
                                 f"tick {ticks} differs from phase 2's: "
                                 f"{bad}")
        got = (res["launches"]["K7"], res["launches"]["K1"])
        if on_card and got != (ticks, 0):
            raise AssertionError(f"29d {backend} rank {rank}: launches "
                                 f"{res['launches']}")
    last = max(rank for backend, rank in results if backend == "gloo")
    res = results["gloo", last]
    if not res["col0"] or min(res["col0"]) <= 0 or res["k7_err"] != 0:
        raise AssertionError(f"29d: K7 on gloo rank {last}: first columns "
                             f"{res['col0']}, error {res['k7_err']}")


def road_blocks_phase(dev, card: str, want600, learned8, gt_d,
                      dual_blocks, ticks: int = BLOCKS_TICKS,
                      scenario=HEADLINE_SCENARIO, groups=BLOCK_GROUPS
                      ) -> dict:
    """Phase 29: (a) the trained MPNN sampled on Grid8x8 (``learned8``:
    ``(net8, agents8, ppo8, trained)``), (b) phase 27d's transformer
    (``gt_d``), (c) phase 24b's dual row (``dual_blocks``) and Braess under
    ``strict_compat``, each on 4 road blocks against its serial run; (d)
    the headline ``scenario`` on 4 blocks in the spawned process
    ``groups`` (gloo ranks and one NCCL rank), started first and running
    beside (a)-(c), against phase 2's state ``want600`` (state bits) at
    tick ``ticks``."""
    t_phase = time.perf_counter()
    out = {}
    with ThreadPoolExecutor(max_workers=1) as pool:
        # --- d. spawned first, joined after (c) ---
        ranks = pool.submit(spawn_blocks, groups, ticks, scenario, str(dev))
        _blocks_in_process(dev, card, learned8, gt_d, dual_blocks, ticks,
                           out)
        d = out["d"] = ranks.result()
    check_processes(d, want600, ticks, dev.type == "cuda")
    last = max(k for b, k in d if b == "gloo")
    log(f"29d the headline on {SHARD_BLOCKS} blocks across processes ("
        + ", ".join(f"{w} {b} rank(s) of {n} blocks" for b, w, n in groups)
        + f"; gloo host-staged) started together on the one card at the "
        f"phase's start, beside 29a-c, and joined "
        f"{time.perf_counter() - t_phase:.1f} s after it: every "
        f"rank's state bitwise phase 2's at tick {ticks}; K7 once a tick on "
        f"every rank; the last gloo rank's K7 (first columns "
        f"{d['gloo', last]['col0']}) bitwise its "
        f"plain version on its kept inputs.  ms/tick, a protocol check and "
        f"not a timing of work across cards: "
        + ", ".join(f"{b} rank {k} (blocks {r['first']}-"
                    f"{r['first'] + r['held'] - 1}) "
                    f"{r['wall'] / ticks * 1e3:.3f}"
                    for (b, k), r in sorted(d.items()))
        + f" ({card})")
    out["seconds"] = time.perf_counter() - t_phase
    return out


def _blocks_in_process(dev, card: str, learned8, gt_d, dual_blocks,
                       ticks: int, out: dict) -> None:
    """Phase 29a-c in this process (see :func:`road_blocks_phase`), their
    results into ``out``; 29d's ranks run beside them."""
    from tarl_tpu_torch.config import RoutingConfig, SimConfig
    from tarl_tpu_torch.core.step import init_sim_state
    from tarl_tpu_torch.io.matsim import load_network, load_population
    from tarl_tpu_torch.io.scenarios import ensure_scenario
    from tarl_tpu_torch.rl.learned_policy import make_learned_choice
    from tarl_tpu_torch.simulator import make_policy

    # --- a. the learned MPNN ---
    net8, agents8, ppo8, trained = learned8
    sim = SimConfig(start_time=6 * 3600)
    policy = make_learned_choice(ppo8.policy_net, trained["policy"], net8,
                                 dist=ppo8._policy_dist)
    state0 = init_sim_state(net8, agents8, sim=sim, policy=policy)
    a = out["a"] = blocks_run("29a", net8, state0, policy, sim, (ticks,))
    log(f"29a the trained MPNN, sampled, on {SHARD_BLOCKS} blocks of "
        f"Grid8x8 ({net8.num_roads} roads, {agents8.num_agents} agent rows, "
        f"edge-sharded forward): state bitwise the serial run's at tick "
        f"{ticks} (done {a['done']}, on roads {a['on_road']}); "
        f"{a['blocks_ms']:.3f} ms/tick on blocks, serial "
        f"{a['serial_ms']:.3f}; launches {a['launches']} ({card})")
    # --- b. the learned transformer on the headline scenario ---
    b = out["b"] = blocks_run("29b", gt_d["net"], gt_d["state0"],
                              gt_d["policy"], gt_d["sim"], gt_d["cuts"],
                              want=gt_d["want"])
    log(f"29b the learned transformer on {SHARD_BLOCKS} blocks of the "
        f"headline scenario, cut {gt_d['cuts']} as phase 27d's plain rerun: "
        f"state bitwise that rerun's at tick {b['ticks']} (done "
        f"{b['done']}, on roads {b['on_road']}); {b['blocks_ms']:.3f} "
        f"ms/tick on blocks (phase 27d serial {gt_d['ms_tick']:.3f}); "
        f"launches {b['launches']} ({card})")
    # --- c. the dual row and strict-compat ---
    dual_ms = dual_blocks["ms_tick"]
    c = out["c_dual"] = blocks_run(
        "29c dual", dual_blocks["net"], dual_blocks["state0"],
        dual_blocks["policy"], dual_blocks["sim"], (DUAL_BLOCKS_TICKS,),
        want=dual_blocks["want"])
    log(f"29c the dual row (N = {dual_blocks['net'].num_nodes}) on "
        f"{SHARD_BLOCKS} blocks: state bitwise phase 24b's at tick "
        f"{c['ticks']}, next-hop table included; {c['blocks_ms']:.3f} "
        f"ms/tick on blocks (phase 24b {dual_ms:.3f}); launches "
        f"{c['launches']} ({card})")
    base = ensure_scenario(os.path.join(ROOT, "build", "scenarios"),
                           "Braess")
    netb = load_network(os.path.join(base, "network"), device=dev)
    agentsb, _ = load_population(os.path.join(base, "population"),
                                 os.path.join(base, "network"), device=dev)
    routing = RoutingConfig(strict_compat=True)
    policy = make_policy("dijkstra", routing, network=netb)
    simb = SimConfig(start_time=6 * 3600)
    c = out["c_strict"] = blocks_run(
        "29c strict", netb, init_sim_state(netb, agentsb, sim=simb,
                                           policy=policy),
        policy, simb, (DUAL_BLOCKS_TICKS,), routing=routing)
    log(f"29c Braess under strict_compat on {SHARD_BLOCKS} blocks "
        f"({netb.num_roads} roads, padded): state bitwise the serial run's "
        f"at tick {c['ticks']} (done {c['done']}); {c['blocks_ms']:.3f} "
        f"ms/tick on blocks, serial {c['serial_ms']:.3f}; launches "
        f"{c['launches']} ({card})")


# --- sharded and spatial training (phase 30) ---------------------------------

PPO_BLOCKS = 4                # node-column and road blocks of phase 30
GT_BLOCKS_COLLECT = 128       # (b): GT_RL's collection, cut from 512
PPO_GROUPS = (("gloo", 2), ("nccl", 1))   # (d): backend, processes
PPO_SPAWN_TIMEOUT = 300       # (d): seconds for the spawned ranks in all
GRAD_BAR = {"mpnn": 1e-5, "transformer": 1e-3}   # (a) max |d|, (b) relative
PARAM_RTOL, PARAM_ATOL = 1e-3, 5e-3
PPO_RANK_SPATIAL_STEPS = 64   # (d): the ranks' spatial rollout, cut from 256


class GradCheck:
    """Wraps a trainer's minibatch gradients (``owner._grads``, which its
    iteration hands ``PPO._update_epochs``) and keeps every update's
    parameters, minibatch and gradients; :meth:`run`, after the iteration
    (so its timings hold no check), holds each update's gradients against
    ``ppo._loss_and_grads`` on the same minibatch at the same parameters
    (``grad_diff``, relative for an attention net, the reference's bar)."""

    def __init__(self, owner, ppo, relative: bool):
        self.kept, self.relative = [], relative
        self._grads, self._ppo = owner._grads, ppo
        owner._grads = self

    def __call__(self, params, batch, advantages, returns):
        out = self._grads(params, batch, advantages, returns)
        kept = {p: {k: v.detach().clone() for k, v in sub.items()}
                for p, sub in params.items()}
        self.kept.append((kept, batch, advantages, returns, out[1]))
        return out

    @property
    def first(self):
        """The first update's minibatch."""
        return self.kept[0][1]

    def run(self) -> list:
        """Each kept update's gradient difference, in update order."""
        from tarl_tpu_torch.parallel.dryrun import grad_diff

        errs = []
        for params, batch, adv, ret, got in self.kept:
            _, want = self._ppo._loss_and_grads(params, batch, adv, ret)
            errs.append(grad_diff(want, got, self.relative))
        return errs


def check_grads(label: str, errs: list, updates: int,
                relative: bool) -> float:
    """Asserts ``updates`` gradient checks (``GradCheck.run``'s), each below
    ``GRAD_BAR``; returns the largest."""
    bar = GRAD_BAR["transformer" if relative else "mpnn"]
    if len(errs) != updates or not max(errs, default=0.0) < bar:
        raise AssertionError(f"{label}: {len(errs)} of {updates} updates' "
                             f"gradients checked, differences {errs} "
                             f"({'relative ' if relative else ''}bar {bar})")
    return max(errs)


def params_close(label: str, want: dict, got: dict, reach: float) -> tuple:
    """Asserts two parameter trees within ``reach`` (Adam's: twice the
    learning rate times the updates; an element whose gradient is rounding
    noise steps by up to the rate either way each update, as phases 21 and
    28 hold theirs); returns the largest absolute difference and the
    number of elements beyond rtol ``PARAM_RTOL``, atol ``PARAM_ATOL``
    (the reference tests' bar at 4 updates)."""
    import torch

    worst = _tree_diff(want, got)[0]
    if not worst <= reach:
        raise AssertionError(f"{label}: parameters differ by up to {worst}, "
                             f"beyond Adam's reach {reach}")
    beyond = sum(int((~torch.isclose(got[p][k], want[p][k], rtol=PARAM_RTOL,
                                     atol=PARAM_ATOL)).sum())
                 for p in want for k in want[p])
    return worst, beyond


def adam_reach(ppo, updates: int) -> float:
    return 2 * ppo.rl.learning_rate * updates


def traj_bits(traj) -> dict:
    from tarl_tpu_torch.convert import to_numpy

    return to_numpy(traj)


def progress_atol(traj: dict, phi0: float, scale: float) -> float:
    """The absolute tolerance of a rollout's ``progress`` rewards
    (``traj_bits``) from a state of potential ``phi0``: a reward is the
    difference of two float32 potentials, each a sum over the queued
    agents that the blocks add in another order, held to 2e-6 of its
    value; every potential of the rollout lies within ``|phi0| + scale *
    sum |r|`` of 0 (a reset restarts it at 0).  At Grid8x8's potential,
    ~1e4, one float32 ulp of it is ~1e-5 of a reward."""
    import numpy as np

    bound = abs(phi0) + scale * float(np.abs(
        traj["reward"].astype(np.float64)).sum())
    return 4e-6 * bound / scale


def compare_traj(label: str, want, got, exact=("action", "done", "time",
                                                "on_network", "x", "value",
                                                "reward"),
                 reward_atol: float | None = None) -> float:
    """Asserts two trajectories (``traj_bits``) bitwise in ``exact`` and the
    log-probs within rtol 1e-5, atol 1e-6, and, with ``reward_atol``, the
    ``progress`` rewards within rtol 1e-6 and it; returns the log-probs'
    largest difference."""
    import numpy as np

    bad = _diff_paths({f: want[f] for f in exact},
                      {f: got[f] for f in exact}, label)
    if bad:
        raise AssertionError(f"{label}: trajectories differ at {bad}")
    if reward_atol is not None and not np.allclose(
            got["reward"], want["reward"], rtol=1e-6, atol=reward_atol):
        worst = float(np.abs(got["reward"].astype(np.float64)
                             - want["reward"]).max())
        raise AssertionError(f"{label}: progress rewards differ by up to "
                             f"{worst}, beyond rtol 1e-6, atol "
                             f"{reward_atol:.3g}")
    if not np.allclose(got["log_prob"], want["log_prob"], rtol=1e-5,
                       atol=1e-6):
        raise AssertionError(f"{label}: log-probs beyond rtol 1e-5, atol "
                             f"1e-6")
    return float(np.abs(got["log_prob"].astype(np.float64)
                        - want["log_prob"]).max())


def fmt_params(res: dict) -> str:
    return (f"within {res['param_worst']:.3g} of the unsharded iteration's "
            f"(Adam's reach {res['reach']:g}), {res['param_beyond']} "
            f"element(s) beyond rtol {PARAM_RTOL}, atol {PARAM_ATOL}")


def fmt_split(rec: dict) -> str:
    steps = rec["trajs"][0].action.shape[0] * len(rec["trajs"])
    col = rec["collection_ms"]
    return (f"iteration {rec['wall_ms']:.1f} ms: collection {col:.1f} ms "
            f"({col / steps:.3f} ms/step), GAE {rec['gae_ms']:.2f} ms, update "
            f"{rec['update_ms']:.1f} ms ({rec['updates']} updates)")


def sharded_training(label: str, make_ppo, ts, card: str,
                     relative: bool) -> dict:
    """30a/30b: ``PPO.train_iteration`` and ``ShardedPPO.train_iteration``
    on ``PPO_BLOCKS`` node-column blocks from ``ts``, each on its own
    ``make_ppo()``, under deterministic algorithms.  Asserts the
    trajectories bitwise, one K1, K11 and K10 launch a collection step and
    none in the update, every update's gradients within ``GRAD_BAR`` of
    the unsharded gradients at the same parameters (:class:`GradCheck`)
    and the parameters within Adam's reach of the unsharded iteration's."""
    import torch

    from tarl_tpu_torch.parallel.sharded_ppo import (
        ShardedPPO, make_node_mesh)

    ppo_u, ppo_s = make_ppo(), make_ppo()
    dev = ppo_u.network.device
    on_card = dev.type == "cuda"
    steps = ppo_u.rl.rollout_steps
    sharded = ShardedPPO(ppo_s, make_node_mesh(PPO_BLOCKS, dev))
    grads = GradCheck(sharded, ppo_s, relative)
    probe_u = TrainProbe(ppo_u, on_card)
    probe_s = TrainProbe(ppo_s, on_card, sharded)
    with deterministic():
        reset_counts()
        ts_u, _ = ppo_u.train_iteration(ts)
        u_counts = counts()
        reset_counts()
        ts_s, metrics = sharded.train_iteration(ts)
        s_counts = counts()
        rec_u, rec_s = probe_u.records[-1], probe_s.records[-1]
        errs = grads.run()
        row_err = None
        if not relative:
            # A per-edge row's product at the minibatch's row count on the
            # blocks' columns against the flat edge list's.
            x = grads.first.x
            with torch.no_grad():
                flat = ppo_u._policy_logits(ts.params["policy"], x)
                blk = sharded._logits_fn(ts.params["policy"], x)
            ok = sharded.tables.ok[:, sharded._lo:sharded._lo + sharded._n]
            eid = sharded.tables.eid[:, sharded._lo:sharded._lo + sharded._n]
            want_blk = flat[:, torch.where(ok, eid, 0).long()]
            row_err = _max_abs_diff(torch.where(ok, blk, 0.0),
                                    torch.where(ok, want_blk, 0.0))
    want = {"K1": steps, "K9": 0, "K10": steps, "K11": steps, "K12": 0,
            "K7": 0, "choice": 0}
    idle = {k: 0 for k in want}
    for name, c, rec in (("unsharded", u_counts, rec_u),
                         ("sharded", s_counts, rec_s)):
        if on_card and (c != want or rec["update_launches"] != idle
                        or rec["gae_launches"] != idle):
            raise AssertionError(f"{label} {name}: launches {c} (update "
                                 f"{rec['update_launches']}), expected "
                                 f"{want} and none in the update")
    lp_err = compare_traj(label, traj_bits(rec_u["trajs"][0]),
                          traj_bits(rec_s["trajs"][0]),
                          exact=("action", "done", "time", "on_network", "x",
                                 "value", "reward", "log_prob"))
    err = check_grads(label, errs, rec_s["updates"], relative)
    reach = adam_reach(ppo_u, rec_u["updates"])
    worst, beyond = params_close(label, ts_u.params, ts_s.params, reach)
    if not all(bool(torch.isfinite(v)) for v in metrics):
        raise AssertionError(f"{label}: metrics {metrics}")
    return {"launches": s_counts, "rec_u": rec_u, "rec_s": rec_s,
            "ts_u": ts_u, "ts_s": ts_s, "grad_err": err,
            "grad_first": errs[0], "row_err": row_err,
            "param_worst": worst, "param_beyond": beyond, "reach": reach,
            "log_prob_err": lp_err, "traj": traj_bits(rec_s["trajs"][0])}


def spatial_training(make_ppo, ts, want_traj, ts_u, card: str) -> dict:
    """30c: ``SpatialPPO.train_iteration`` on ``PPO_BLOCKS`` road and
    node-column blocks from ``ts`` (K7 through ``CaptureWinner``): its
    rollout against ``want_traj``, the unsharded collection from ``ts``,
    K7's kept inputs against the plain version, every update's gradients
    against the unsharded gradients at the same parameters
    (:class:`GradCheck`), and the iteration's state against the unsharded
    iteration's ``ts_u``."""
    import torch

    from tarl_tpu_torch.core.fused_winner import fused_shard_winner_plain
    from tarl_tpu_torch.parallel.spatial_ppo import (
        SpatialPPO, make_spatial_mesh)

    ppo = make_ppo()
    dev = ppo.network.device
    on_card = dev.type == "cuda"
    steps = ppo.rl.rollout_steps
    spat = SpatialPPO(ppo, make_spatial_mesh(PPO_BLOCKS, dev))
    cap = CaptureWinner(max(steps // 8, 1), "30c")
    probe = TrainProbe(ppo, on_card, spat, collector=spat,
                       collect_name="_collect")
    grads = GradCheck(spat.update, ppo, relative=False)
    with deterministic():
        reset_counts()
        ts_c, metrics = spat.train_iteration(ts, winner=cap)
        errs = grads.run()
    rec = probe.records[-1]
    traj = rec["trajs"][0]
    want = {"K1": 0, "K9": 0, "K10": 0, "K11": 0, "K12": 0, "K7": steps,
            "choice": 0}
    if on_card and (rec["collection_launches"] != want
                    or any(rec["update_launches"].values())):
        raise AssertionError(f"30c: launches {rec['collection_launches']} "
                             f"(rollout), {rec['update_launches']} (update), "
                             f"expected {want} and none")
    atol = progress_atol(want_traj, float(ts.env.phi), ppo.rl.progress_scale)
    lp_err = compare_traj("30c rollout", want_traj, traj_bits(traj),
                          exact=("action", "done", "time", "on_network", "x",
                                 "value"), reward_atol=atol)
    rew_err = float(abs(traj.reward.cpu().double()
                        - torch.as_tensor(want_traj["reward"]).double())
                    .max())
    # K7's kept launches (every eighth step, the last included) that move
    # someone, bitwise the plain version's.
    moving = [(label, args, PPO_BLOCKS) for label, args in cap.inputs
              if bool(fused_shard_winner_plain(*args)[0].any())]
    if not moving:
        raise AssertionError("30c: no kept K7 launch moves anyone")
    err7 = compare_shard_winner(moving)
    want_env, got_env = _env_bits(ts_u.env), _env_bits(ts_c.env)
    # The progress potential is a float sum over the blocks.
    phi = (want_env.pop("phi"), got_env.pop("phi"))
    bad = _diff_paths(want_env, got_env, "env")
    if bad or not torch.allclose(torch.as_tensor(phi[1]),
                                 torch.as_tensor(phi[0]), rtol=1e-6,
                                 atol=1e-5):
        raise AssertionError(f"30c: the iteration's environment differs "
                             f"from the unsharded one at {bad}, potential "
                             f"{phi}")
    grad_err = check_grads("30c", errs, rec["updates"], relative=False)
    reach = adam_reach(ppo, rec["updates"])
    worst, beyond = params_close("30c", ts_u.params, ts_c.params, reach)
    if not all(bool(torch.isfinite(v)) for v in metrics):
        raise AssertionError(f"30c: metrics {metrics}")
    return {"launches": rec["collection_launches"],
            "iteration_launches": {k: rec["collection_launches"][k]
                                   + rec["update_launches"][k]
                                   for k in want},
            "rollout_ms_step": rec["collection_ms"] / steps, "rec": rec,
            "log_prob_err": lp_err, "reward_err": rew_err,
            "reward_atol": atol, "k7_err": err7,
            "k7_steps": [label.split()[-1] for label, _, _ in moving],
            "grad_err": grad_err, "param_worst": worst,
            "param_beyond": beyond, "reach": reach, "traj": traj_bits(traj)}


def _ppo_rank(rank: int, world: int, backend: str, store: str, out_dir: str,
              device: str) -> None:
    """A spawned rank of phase 30d: ``ShardedPPO.train_iteration`` and
    ``SpatialPPO.rollout`` on ``PPO_BLOCKS`` blocks and
    ``BatchedPPO.train_step`` of ``BATCH_ENVS`` replicas on
    ``make_mesh(group=...)``, over the ``backend`` group of ``world``
    processes on ``device``, from the committed Grid8x8 weights, as phases
    30a, 30c and 28b run them in one process, every update's gradients
    kept beside the unsharded ones at the same parameters
    (:class:`GradCheck`).  Writes its results to ``out_dir``."""
    import pickle

    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from tarl_tpu_torch.convert import load_params_npz, mpnn_params_from_numpy
    from tarl_tpu_torch.core import rng
    from tarl_tpu_torch.core.step import Policy, init_sim_state
    from tarl_tpu_torch.io.matsim import load_network, load_population
    from tarl_tpu_torch.io.scenarios import ensure_scenario
    from tarl_tpu_torch.parallel.mesh import make_mesh
    from tarl_tpu_torch.parallel.shard import BatchedPPO, replica
    from tarl_tpu_torch.parallel.sharded_ppo import (
        ShardedPPO, make_node_mesh)
    from tarl_tpu_torch.parallel.spatial_ppo import SpatialPPO
    from tarl_tpu_torch.routing.policies import random_choice

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group(backend, init_method=f"file://{store}",
                            world_size=world, rank=rank)
    try:
        group = dist.group.WORLD
        base = ensure_scenario(os.path.join(ROOT, "build", "scenarios"),
                               "Grid8x8")
        net8 = load_network(os.path.join(base, "network"), device=dev)
        agents8, _ = load_population(os.path.join(base, "population"),
                                     os.path.join(base, "network"),
                                     device=dev)
        st8 = init_sim_state(net8, agents8,
                             policy=Policy(choice=random_choice))
        trained = mpnn_params_from_numpy(
            load_params_npz(os.path.join(ROOT, WEIGHTS)), dev)
        res = {}

        def timed(name, fn):
            if on_card:
                torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            out = fn()
            if on_card:
                torch.cuda.synchronize()
            res[f"{name}_s"] = time.perf_counter() - t0
            res[f"{name}_launches"] = counts()
            return out

        with deterministic():
            ppo = learned_ppo(net8)
            ts = ppo.init(st8, rng.prng_key(0),
                          torch.Generator().manual_seed(0))
            ts = ts._replace(params=trained,
                             opt_state=ppo.optimizer.init(trained))
            mesh = make_node_mesh(PPO_BLOCKS, dev, group=group)
            sharded = ShardedPPO(ppo, mesh)
            s_grads = GradCheck(sharded, ppo, relative=False)
            ts_s, _ = timed("sharded", lambda: sharded.train_iteration(ts))
            ppo_sp = learned_ppo(net8, PPO_RANK_SPATIAL_STEPS)
            traj = timed("spatial", lambda: SpatialPPO(ppo_sp, mesh)
                         .rollout(ts))
            ppo_b = learned_ppo(net8)
            trainer = BatchedPPO(ppo_b, make_mesh(group=group, device=dev),
                                 BATCH_ENVS)
            tb = trainer.init(st8, rng.prng_key(0),
                              torch.Generator().manual_seed(0))
            tb = tb._replace(params=trained,
                             opt_state=ppo_b.optimizer.init(trained))
            b_grads = GradCheck(trainer, ppo_b, relative=False)
            tb1, _ = timed("batched", lambda: trainer.train_step(tb))
            # Checked after the timed runs; a rank reports, the parent
            # asserts (a rank that raised would leave the others waiting
            # in a collective).
            res.update(sharded_grads=s_grads.run(),
                       batched_grads=b_grads.run())
        res.update(
            blocks=(mesh.first, mesh.held), replicas=list(trainer.replicas),
            shape=dict(trainer.mesh.shape),
            sharded_params=_tree_numpy(ts_s.params),
            sharded_env=_env_bits(ts_s.env), spatial_traj=traj_bits(traj),
            batched_params=_tree_numpy(tb1.params),
            batched_envs=[_env_bits(replica(tb1.envs, j))
                          for j in range(len(trainer.replicas))])
        with open(os.path.join(out_dir, f"{backend}{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def _tree_cpu(tree: dict) -> dict:
    return {p: {k: v.detach().cpu() for k, v in sub.items()}
            for p, sub in tree.items()}


def _tree_numpy(tree: dict) -> dict:
    return {p: {k: v.detach().cpu().numpy() for k, v in sub.items()}
            for p, sub in tree.items()}


def spawn_ppo_ranks(groups=PPO_GROUPS, device: str = "cuda:0",
                    timeout: float = PPO_SPAWN_TIMEOUT) -> dict:
    """Phase 30d's processes: for each ``(backend, world)`` group, ``world``
    spawned ranks of :func:`_ppo_rank` (a ``FileStore`` of their own), all
    started together and joined within ``timeout`` seconds; a rank that
    hangs is killed and fails the phase, as does a nonzero exit.  Returns
    ``{(backend, rank): result}``."""
    import multiprocessing
    import pickle
    import shutil

    out_dir = os.path.join(ROOT, "build", "ppo30")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    ctx = multiprocessing.get_context("spawn")
    procs = {}
    for backend, world in groups:
        store = os.path.join(out_dir, f"{backend}.store")
        for rank in range(world):
            procs[backend, rank] = ctx.Process(target=_ppo_rank, args=(
                rank, world, backend, store, out_dir, device))
    for p in procs.values():
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs.values():
            p.join(max(deadline - time.monotonic(), 0.0))
    finally:
        hung = [key for key, p in procs.items() if p.is_alive()]
        for p in procs.values():
            if p.is_alive():
                p.kill()
                p.join()
    if hung:
        raise AssertionError(f"30d: ranks {hung} did not end within "
                             f"{timeout:.0f} s")
    failed = {key: p.exitcode for key, p in procs.items() if p.exitcode}
    if failed:
        raise AssertionError(f"30d: ranks exited with {failed}")
    out = {}
    for backend, rank in procs:
        with open(os.path.join(out_dir, f"{backend}{rank}.pkl"), "rb") as f:
            out[backend, rank] = pickle.load(f)
    return out


def check_ppo_ranks(results, a: dict, c: dict, batched, on_card: bool,
                    steps: int) -> None:
    """Phase 30d's asserts: every rank's sharded iteration, spatial rollout
    and batched step against the one-process runs (``a``, ``c`` and phase
    28b's record ``batched``): the environments, trajectories and replicas
    bitwise where discrete, every update's gradients within ``GRAD_BAR``
    of the unsharded ones at the same parameters, the parameters within
    Adam's reach; on the card the launches of each."""
    import torch

    from tarl_tpu_torch.parallel.shard import replica

    rate = a["reach"] / (2 * a["rec_s"]["updates"])

    def close(name, want, got, updates):
        got = {p: {k: torch.as_tensor(v) for k, v in sub.items()}
               for p, sub in got.items()}
        res[f"{name}_worst"] = params_close(f"{label} {name}", want, got,
                                            2 * rate * updates)[0]

    for (backend, rank), res in results.items():
        label = f"30d {backend} rank {rank}"
        for name, updates in (("sharded", a["rec_s"]["updates"]),
                              ("batched", batched["updates"])):
            res[f"{name}_grad_err"] = check_grads(
                f"{label} {name}", res[f"{name}_grads"], updates, False)
        close("sharded", _tree_cpu(a["ts_s"].params), res["sharded_params"],
              a["rec_s"]["updates"])
        bad = _diff_paths(_env_bits(a["ts_s"].env), res["sharded_env"])
        if bad:
            raise AssertionError(f"{label}: the sharded iteration's "
                                 f"environment differs at {bad}")
        # The ranks' rollout is the first steps of 30c's.
        head = {f: v[:PPO_RANK_SPATIAL_STEPS] for f, v in c["traj"].items()}
        compare_traj(f"{label} spatial", head, res["spatial_traj"],
                     exact=("action", "done", "time", "on_network", "x",
                            "value"), reward_atol=c["reward_atol"])
        envs = batched["ts_out"].envs
        for j, i in enumerate(res["replicas"]):
            bad = _diff_paths(_env_bits(replica(envs, i)),
                              res["batched_envs"][j], f"replica {i}")
            if bad:
                raise AssertionError(f"{label} batched: {bad}")
        close("batched", _tree_cpu(batched["ts_out"].params),
              res["batched_params"], batched["updates"])
        n_rep = len(res["replicas"])
        want = {"sharded": {"K1": steps, "K10": steps, "K11": steps,
                            "K7": 0},
                "spatial": {"K1": 0, "K10": 0, "K11": 0,
                            "K7": PPO_RANK_SPATIAL_STEPS},
                "batched": {"K1": n_rep * steps, "K10": n_rep * steps,
                            "K11": n_rep * steps, "K7": 0}}
        for name, w in want.items():
            got = {k: res[f"{name}_launches"][k] for k in w}
            if on_card and got != w:
                raise AssertionError(f"{label} {name}: launches {got}, "
                                     f"expected {w}")


def response_phase(net, captured, card: str) -> dict:
    """30f: ``core.response.response_step`` (the legacy confirm) on phase
    2's captured states after the direction step's push (the winners at
    the tails, no pop), with K10's bare max and with the plain version
    (``plain_segments()``), bitwise; one K10 launch a call."""
    import torch

    from tarl_tpu_torch.core import rng
    from tarl_tpu_torch.core.direction import direction_step
    from tarl_tpu_torch.core.response import response_step
    from tarl_tpu_torch.ops import segment as seg
    from tarl_tpu_torch.routing.policies import random_choice

    on_card = net.device.type == "cuda"
    pops = confirms = 0
    reset_counts()
    for i, st in enumerate(captured):
        st, _ = random_choice(st, net)
        road, _, accept, _ = direction_step(
            st.road, st.selected_road, net, st.time,
            rng.direction_gumbel(rng.prng_key(3000 + i), net))
        before = seg.MAX_LAUNCHES
        got_road, got = response_step(road, net)
        if on_card and seg.MAX_LAUNCHES != before + 1:
            raise AssertionError("30f: response_step did not launch K10 once")
        with seg.plain_segments():
            want_road, want = response_step(road, net)
        bad = _diff_paths(_state_bits(st._replace(road=want_road)),
                          _state_bits(st._replace(road=got_road)), "road")
        if bad or not torch.equal(got, want):
            raise AssertionError(f"30f: K10's bare max and the plain max "
                                 f"differ on captured state {i}: {bad}")
        pops += int(got.sum())
        confirms += int(accept.sum())
    launches = counts()
    if on_card and launches["K10"] != len(captured):
        raise AssertionError(f"30f: launches {launches}")
    if confirms == 0:
        raise AssertionError("30f: no transfer on the captured states; the "
                             "comparison would be vacuous")
    return {"launches": launches, "states": len(captured), "pops": pops,
            "accepted": confirms}


def ppo_blocks_phase(dev, card: str, net8, st8, trained, single: list,
                     batched, captured, net16, groups=PPO_GROUPS) -> dict:
    """Phase 30: (a) ``ShardedPPO`` with the trained MPNN and (b) with the
    committed Braess transformer (its collection cut to
    ``GT_BLOCKS_COLLECT``), each against ``PPO.train_iteration``; (c)
    ``SpatialPPO``; (d) (a), (c) and phase 28b's batched step across
    processes; (e) ``dryrun_multichip(2, "gloo")``; (f) ``response_step`` on
    phase 2's ``captured`` states of ``net16``.  (d)'s and (e)'s ranks are
    spawned first and run beside (a)-(c) and (f); (d) is checked once (a)
    and (c) are done.  ``single`` is phase 21's probe records, ``batched``
    phase 28b's record; ``groups`` (d)'s process groups."""
    import torch

    from tarl_tpu_torch.config import RLConfig
    from tarl_tpu_torch.core import rng
    from tarl_tpu_torch.models.transformer.agent import (
        TransformerRoutePolicy, TransformerValueNet)
    from tarl_tpu_torch.parallel.dryrun import dryrun_multichip
    from tarl_tpu_torch.rl.ppo import PPO

    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"
    out = {}
    single_ms = ", ".join(f"{r['wall_ms']:.1f}" for r in single)
    beside = (f"{sum(w for _, w in groups) + 2} ranks of 30d-e running "
              f"beside")
    with ThreadPoolExecutor(max_workers=2) as pool:
        # --- d./e. spawned first; each joins its ranks within its timeout ---
        ranks = pool.submit(spawn_ppo_ranks, groups, str(dev))
        dry = pool.submit(dryrun_multichip, 2, "gloo",
                          None if on_card else "cpu")
        # --- a. ShardedPPO, the trained MPNN ---
        ppo8 = learned_ppo(net8)
        ts = ppo8.init(st8, rng.prng_key(0),
                       torch.Generator().manual_seed(0))
        ts = ts._replace(params=trained,
                         opt_state=ppo8.optimizer.init(trained))
        a = out["a"] = sharded_training("30a", lambda: learned_ppo(net8), ts,
                                        card, relative=False)
        log(f"30a ShardedPPO, the trained MPNN on {PPO_BLOCKS} node-column "
            f"blocks of Grid8x8 (N = {net8.num_nodes}): trajectory bitwise "
            f"the unsharded iteration's, every update's gradients "
            f"({a['rec_s']['updates']}) within max |d| {a['grad_err']:.3g} "
            f"of the unsharded ones at the same parameters (the first "
            f"{a['grad_first']:.3g}; the blocks' per-edge logits at its "
            f"{ppo8.rl.minibatch_size} rows against the flat forward's: max "
            f"|diff| {a['row_err']:.3g}), the parameters after the update "
            f"{fmt_params(a)}; launches {a['launches']}; sharded "
            f"{fmt_split(a['rec_s'])}; unsharded {fmt_split(a['rec_u'])} "
            f"({beside}); phase 21's single-environment iterations "
            f"{single_ms} ms ({card})")
        # --- b. ShardedPPO, the committed Braess transformer ---
        netb, _, stb, ppob, paramsb, tree = gt_braess(dev)
        rl_b = RLConfig(**{**GT_RL, "rollout_steps": GT_BLOCKS_COLLECT})
        pe = tree["pe"]

        def gt_ppo():
            return PPO(netb, TransformerRoutePolicy(pe),
                       TransformerValueNet(pe), rl=rl_b,
                       value_uses_graph=True)

        tsb = gt_ppo().init(stb, rng.prng_key(0),
                            torch.Generator().manual_seed(0))
        tsb = tsb._replace(params=paramsb,
                           opt_state=ppob.optimizer.init(paramsb))
        b = out["b"] = sharded_training("30b", gt_ppo, tsb, card,
                                        relative=True)
        log(f"30b ShardedPPO, the committed Braess transformer at GT_RL "
            f"(collection cut to {GT_BLOCKS_COLLECT} steps) on {PPO_BLOCKS} "
            f"node-column blocks (N = {netb.num_nodes}, padded to "
            f"{-(-netb.num_nodes // PPO_BLOCKS) * PPO_BLOCKS}; the twin's "
            f"node rows gathered each layer): trajectory bitwise, every "
            f"update's gradients ({b['rec_s']['updates']}) within relative "
            f"{b['grad_err']:.3g} of the unsharded ones at the same "
            f"parameters (the first {b['grad_first']:.3g}), the parameters "
            f"{fmt_params(b)}; launches {b['launches']}; sharded "
            f"{fmt_split(b['rec_s'])}; unsharded {fmt_split(b['rec_u'])} "
            f"({beside}; {card})")
        # --- c. SpatialPPO ---
        c = out["c"] = spatial_training(lambda: learned_ppo(net8), ts,
                                        traj_bits(a["rec_u"]["trajs"][0]),
                                        a["ts_u"], card)
        log(f"30c SpatialPPO, the trained MPNN on {PPO_BLOCKS} road and "
            f"node-column blocks of Grid8x8, one train_iteration: its "
            f"rollout of {ppo8.rl.rollout_steps} steps in "
            f"{c['rollout_ms_step']:.3f} ms/step, actions, dones, clock, "
            f"on_network, contexts and values bitwise the unsharded "
            f"collection's, progress rewards within {c['reward_err']:.3g} "
            f"(tolerance {c['reward_atol']:.3g}: 4e-6 of the largest "
            f"potential over the scale), log-probs within "
            f"{c['log_prob_err']:.3g}; launches {c['launches']}; K7's "
            f"launches at steps {', '.join(c['k7_steps'])} (every eighth "
            f"that moved someone) bitwise its plain version (max |diff| "
            f"{c['k7_err']}); every update's gradients "
            f"({c['rec']['updates']}) within max |d| {c['grad_err']:.3g} of "
            f"the unsharded ones at the same parameters; the iteration's "
            f"environment bitwise but its potential (within rtol 1e-6), "
            f"parameters {fmt_params(c)}, {fmt_split(c['rec'])} ({beside}; "
            f"{card})")
        # --- f. the legacy confirm ---
        f = out["f"] = response_phase(net16, captured, card)
        log(f"30f response_step on {f['states']} captured headline states "
            f"after the push ({f['accepted']} transfers, {f['pops']} pops "
            f"with the double fire): K10's bare max bitwise the plain max; "
            f"launches {f['launches']} ({card})")
        d = out["d"] = ranks.result()
        lines = dry.result()
    out["de_seconds"] = time.perf_counter() - t_phase
    # --- d. across processes ---
    check_ppo_ranks(d, a, c, batched, on_card, ppo8.rl.rollout_steps)
    log(f"30d ShardedPPO, SpatialPPO and BatchedPPO ({BATCH_ENVS} replicas) "
        f"across processes (the spatial rollout cut to "
        f"{PPO_RANK_SPATIAL_STEPS} steps; " + ", ".join(
            f"{w} {bk} rank(s)" for bk, w in groups)
        + f", all on the one card; gloo host-staged), "
        f"{out['de_seconds']:.1f} s from their spawn at the phase's start "
        f"(30e's two ranks and 30a-c and f beside them): every "
        f"rank's results equal the one-process runs (environments, "
        f"trajectories and replicas bitwise; every update's gradients "
        f"within max |d| {GRAD_BAR['mpnn']:g} of the unsharded ones at the "
        f"same parameters; parameters within Adam's reach).  Seconds, a "
        f"protocol check and not a timing of work across cards: " + "; ".join(
            f"{bk} rank {k} (blocks {r['blocks'][0]}-"
            f"{r['blocks'][0] + r['blocks'][1] - 1}, replicas "
            f"{r['replicas'][0]}-{r['replicas'][-1]}, mesh {r['shape']}) "
            f"sharded {r['sharded_s']:.2f}, spatial {r['spatial_s']:.2f}, "
            f"batched {r['batched_s']:.2f} (gradients within "
            f"{r['sharded_grad_err']:.3g} over {len(r['sharded_grads'])} "
            f"updates and {r['batched_grad_err']:.3g} over "
            f"{len(r['batched_grads'])}; parameters within "
            f"{r['sharded_worst']:.3g} and {r['batched_worst']:.3g})"
            for (bk, k), r in sorted(d.items()))
        + f" ({card})")
    # --- e. the dry run ---
    if len(lines) != 12:
        raise AssertionError(f"30e: {len(lines)} lines")
    log(f"30e dryrun_multichip(2, 'gloo'): 12 lines, six paths on each "
        f"rank, run beside 30a-d ({card})")
    out["seconds"] = time.perf_counter() - t_phase
    return out


# --- phases 22, 23, 24a, 25 and 26 in a spawned process ----------------------

_DROPPED = object()


def _plain_data(x):
    """``x`` with only its plain data kept (numbers, strings, None, and
    dicts, lists and tuples of them; a one-element tensor as its number),
    everything else dropped: what the results line reads of a phase run in
    another process."""
    import numpy as np
    import torch

    if isinstance(x, dict):
        return {k: v for k, v in ((k, _plain_data(v)) for k, v in x.items())
                if v is not _DROPPED}
    if isinstance(x, (list, tuple)):
        items = [_plain_data(v) for v in x]
        return _DROPPED if _DROPPED in items else items
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, torch.Tensor) and x.numel() == 1:
        return x.item()
    return _DROPPED


REPORT_INPUT = os.path.join(ROOT, "build", "dual_report_state.pt")
# The two spawned processes: phases 22, 23 and 26; 24a, 25 and 24b's
# report.
SIDE_LANES = (("mil", "rad", "city"), ("classical", "cli_run", "report"))


def _side_phases(device: str, card: str, out_path: str, keys) -> None:
    """A spawned process of phases 22, 23, 24a, 25 and 26 and 24b's
    report (none of them feeds a later phase but through numbers), the
    ones ``keys`` names: each as the main process would run it, with its
    log lines; writes their numbers and its parses (:func:`note_parse`)
    to ``out_path``."""
    import pickle

    import torch

    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    out = {}
    for key, label, fn in (
            ("mil", "million row", lambda: million_phase(dev, card)),
            ("rad", "radial row", lambda: radial_phase(dev, card)),
            ("classical", "classical rows",
             lambda: classical_phase(dev)),
            ("cli_run", "CLI", lambda: cli_phase(
                dev, card, out["classical"]["rows"]["Easy dijkstra"],
                root=os.path.join(ROOT, "build", "cli25"))),
            ("city", "city row", lambda: city_phase(dev, card)),
            ("report", "dual row report",
             lambda: dual_report_phase(dev, REPORT_INPUT))):
        if key not in keys:
            continue
        t0 = time.perf_counter()
        out[key] = fn()
        log(f"{label} phase in {time.perf_counter() - t0:.1f} s")
    out = _plain_data(out)
    out["parses"] = list(PARSES)
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


def spawn_side_phases(device: str, card: str) -> list:
    """Start :func:`_side_phases` once for each of ``SIDE_LANES``; returns
    their ``(process, out_path)``.  The scenarios that several processes
    read are written first, and the report's input of an earlier run is
    removed."""
    import multiprocessing

    from tarl_tpu_torch.io.scenarios import ensure_scenario

    for name in ("Braess", "Easy", "Bottleneck"):
        ensure_scenario(os.path.join(ROOT, "build", "scenarios"), name)
    if os.path.exists(REPORT_INPUT):
        os.remove(REPORT_INPUT)
    sides = []
    for i, keys in enumerate(SIDE_LANES):
        out_path = os.path.join(ROOT, "build", f"side_phases{i}.pkl")
        if os.path.exists(out_path):
            os.remove(out_path)
        proc = multiprocessing.get_context("spawn").Process(
            target=_side_phases, args=(device, card, out_path, keys))
        proc.start()
        sides.append((proc, out_path))
    return sides


def join_side_phases(sides, timeout: float = SIDE_TIMEOUT) -> dict:
    """Join :func:`spawn_side_phases`'s processes within ``timeout``
    seconds in all (killed and failing the run past it, as on a nonzero
    exit) and return their numbers, the parses in one list."""
    import pickle

    deadline = time.monotonic() + timeout
    out = {"parses": []}
    for proc, out_path in sides:
        proc.join(max(deadline - time.monotonic(), 0.0))
    for proc, _ in sides:
        if proc.is_alive():
            proc.kill()
            proc.join()
            raise AssertionError(f"phases 22-26 did not end within "
                                 f"{timeout:.0f} s")
        if proc.exitcode:
            raise AssertionError(f"phases 22-26 exited with {proc.exitcode}")
    for _, out_path in sides:
        with open(out_path, "rb") as f:
            res = pickle.load(f)
        out["parses"] += res.pop("parses")
        out.update(res)
    return out


# --- the golden trace's path and the packed view (phase 31) -----------------

def golden_trace_run(net, agents, core, ticks: int = TRACE_TICKS) -> dict:
    """``tests/test_torch_reference_trace.py``'s path on ``net``'s device:
    strict-compat Dijkstra (refresh every 10 ticks) from 06:00 at 1 s, the
    selections zeroed at the start, ``ticks`` of ``core.step.tick`` with
    ``core`` as the winner; each tick's packed state and agent rows and the
    table at each refresh kept on the device.  Launch counts are set to 0
    just before the ticks and read just after."""
    import torch

    from tarl_tpu_torch.config import RoutingConfig, SimConfig
    from tarl_tpu_torch.core.step import init_sim_state, tick
    from tarl_tpu_torch.schema import agent_features_matrix, pack_state
    from tarl_tpu_torch.simulator import make_policy

    routing = RoutingConfig(strict_compat=True, refresh_rate=10)
    sim = SimConfig(start_time=6 * 3600, timestep=1)
    policy = make_policy("dijkstra", routing=routing)
    state = init_sim_state(net, agents, sim=sim, policy=policy)
    state = state._replace(
        selected_road=torch.zeros_like(state.selected_road))
    xs, rows, tables = [], [], []
    torch.cuda.synchronize()
    reset_counts()
    relax0 = relax_counts()
    t0 = time.perf_counter()
    for t in range(ticks):
        state, _ = tick(state, net, policy, sim=sim, core=core)
        xs.append(pack_state(state.road, net, state.selected_road))
        rows.append(agent_features_matrix(state.agents))
        if t % routing.refresh_rate == 0:
            tables.append(state.next_hop)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    relax = {k: v - relax0[k] for k, v in relax_counts().items()}
    return {"x": torch.stack(xs), "rows": torch.stack(rows),
            "tables": torch.stack(tables), "launches": counts(),
            "relax": relax, "wall": wall,
            "done": int(state.agents.done[1:].sum()),
            "traversals": int(state.metrics.hourly_counts.sum())}


def golden_trace_phase(dev, card: str, headline, net16, mid8,
                       net8) -> dict:
    """Phase 31.  (a) The golden trace's path on Braess twice, with K1 and
    with its plain version: every tick's packed state and agent rows and
    every refresh's table bitwise, 400 K1 launches in the kernel run and
    none in the plain one.  (b) ``pack_state`` of the headline's last state
    on the card against the same state packed on the CPU.  (c)
    ``congested_next_hop`` on a mid-episode Grid8x8 state on the card
    against the CPU's."""
    import torch

    from tarl_tpu_torch.core import fused_winner
    from tarl_tpu_torch.io.matsim import load_network, load_population
    from tarl_tpu_torch.io.scenarios import ensure_scenario
    from tarl_tpu_torch.routing.bellman_ford import congested_next_hop
    from tarl_tpu_torch.schema import pack_state

    t_phase = time.perf_counter()
    base = ensure_scenario(os.path.join(ROOT, "build", "scenarios"),
                           "Braess")
    net = load_network(os.path.join(base, "network"), device=dev)
    agents, _ = load_population(os.path.join(base, "population"),
                                os.path.join(base, "network"), device=dev)
    kern = golden_trace_run(net, agents, fused_winner.direction_confirm)
    plain = golden_trace_run(net, agents,
                             fused_winner.direction_confirm_plain)
    if (kern["launches"]["K1"], plain["launches"]["K1"]) != (TRACE_TICKS, 0):
        raise AssertionError(f"golden trace: K1 launched "
                             f"{kern['launches']['K1']} / "
                             f"{plain['launches']['K1']} times (kernel / "
                             f"plain run), expected {TRACE_TICKS} / 0")
    for k in ("x", "rows", "tables"):
        if not torch.equal(kern[k], plain[k]):
            raise AssertionError(f"golden trace: the kernel and plain runs' "
                                 f"{k} differ")
    if kern["done"] <= 0 or kern["traversals"] <= 0:
        raise AssertionError(f"golden trace: {kern['done']} arrived, "
                             f"{kern['traversals']} traversals")
    log(f"golden trace path (Braess, strict-compat dijkstra, "
        f"{TRACE_TICKS} ticks): K1 {kern['launches']['K1']} launches, plain "
        f"run {plain['launches']['K1']}; packed states "
        f"{tuple(kern['x'].shape)}, agent rows {tuple(kern['rows'].shape)} "
        f"and {kern['tables'].shape[0]} refresh tables bitwise between the "
        f"runs; other launches {kern['launches']}, relax {kern['relax']}; "
        f"done {kern['done']}; {kern['wall']:.2f} s kernel run, "
        f"{plain['wall']:.2f} s plain run ({card})")

    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    road16, sel16 = headline.road, headline.selected_road
    x_card = pack_state(road16, net16, sel16)
    x_cpu = pack_state(type(road16)(*(t.to(cpu) for t in road16)),
                       net16.to(cpu), sel16.to(cpu))
    if x_card.device.type != "cuda" or not torch.equal(x_card.cpu(), x_cpu):
        raise AssertionError("pack_state on the card differs from the CPU's")
    log(f"pack_state of the headline's last state: {tuple(x_card.shape)} on "
        f"the card bitwise the CPU's, {int(road16.count.sum())} agents "
        f"queued; {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    road8 = mid8.road
    dist, table = congested_next_hop(road8, net8)
    dist_c, table_c = congested_next_hop(
        type(road8)(*(t.to(cpu) for t in road8)), net8.to(cpu))
    if not (torch.equal(dist.cpu(), dist_c)
            and torch.equal(table.cpu(), table_c)):
        raise AssertionError("congested_next_hop on the card differs from "
                             "the CPU's")
    log(f"congested_next_hop on a mid-episode Grid8x8 state "
        f"({int(road8.count.sum())} agents queued, N={net8.num_nodes}): "
        f"distances and table on the card bitwise the CPU's; "
        f"{time.perf_counter() - t0:.2f} s")
    seconds = time.perf_counter() - t_phase
    log(f"golden trace phase in {seconds:.1f} s")
    return {"kernel": kern["launches"], "plain": plain["launches"],
            "seconds": seconds}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs an NVIDIA GPU")
    # cuBLAS reads this before its first call; the training phase runs
    # under torch.use_deterministic_algorithms(True), which requires it.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    # The learned policy's matrix products in full float32 (PPO checks).
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, ROOT)
    import numpy as np

    from tarl_tpu_torch import _build
    from tarl_tpu_torch.config import DEFAULT_PHYSICS
    from tarl_tpu_torch.convert import to_numpy
    from tarl_tpu_torch.core import fused_core, fused_winner, rng, sync
    from tarl_tpu_torch.core.step import Policy, init_sim_state, run_episode
    from tarl_tpu_torch.routing.policies import random_choice
    from tarl_tpu_torch.state import sort_agents_by_departure

    dev = torch.device("cuda", 0)
    physics = DEFAULT_PHYSICS
    t_start = time.perf_counter()
    os.environ[T0_ENV] = repr(time.time())

    # --- 1. card ------------------------------------------------------------
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    builds, ptxas = build_kernels()
    log("kernel build: " + ", ".join(f"{k} {s:.2f} s"
                                     for k, s in builds.items())
        + f", {time.perf_counter() - t0:.2f} s in all (nvcc "
        f"{' '.join(_build.ARCH_FLAGS)})")
    for name, lines in ptxas.items():
        log(f"ptxas -v, {name}.cu:")
        for line in lines:
            log(f"  {line}")

    # --- 2. the headline episode (captures phase 3's states) -------------
    t0 = time.perf_counter()
    net, agents = load_scenario("Grid16x16_50000", 16, 16, 50000, dev)
    agents = sort_agents_by_departure(agents)
    log(f"scenario Grid16x16: {net.num_roads} roads, Nmax {net.nmax}, "
        f"{net.edge_src.shape[0]} turn edges, {agents.num_agents} agent "
        f"rows, set-up {time.perf_counter() - t0:.1f} s")
    sim = headline_sim()
    policy = Policy(choice=random_choice)
    head = headline_run(net, agents, sim, policy)
    check_headline(head, "headline", {"K1": HEADLINE_TICKS, "K12": 0,
                                      "K7": 0, "choice": HEADLINE_TICKS})
    captured = head["captured"]
    launches = head["launches"]["K1"]
    log(f"headline: {head['rate']:.1f} agent-steps/s ({head['measured']} "
        f"ticks in {head['wall']:.2f} s, "
        f"{head['wall'] / head['measured'] * 1e3:.3f} ms/tick), done "
        f"{head['done']}, on roads {head['on_road']}, average travel time "
        f"{head['avg_tt']:.3f} s, host syncs per tick "
        f"{head['syncs_per_tick']:.3f}, overflow {head['overflow']}, "
        f"fused_winner calls {launches}")

    # --- 3. kernel against plain ----------------------------------------
    r = net.num_roads
    cases = [(s.road, s.selected_road, s.time, rng.prng_key(1000 + i))
             for i, s in enumerate(captured)]
    err16 = compare_kernel(cases, net, physics)
    big, _ = load_scenario("Grid64x64_10", 64, 64, 10, dev)
    r64 = big.num_roads
    big_cases = []
    for i in range(RANDOM_STATES):
        t_now = 6 * 3600.0 + 37 * i
        road64, sel64 = random_road_state(big, i, t_now)
        big_cases.append((road64, sel64, t_now, rng.prng_key(2000 + i)))
    err64 = compare_kernel(big_cases, big, physics)
    log(f"kernel vs plain: bitwise equal on {len(cases)} headline states "
        f"(R={r}) and {len(big_cases)} random Grid64x64 states (R={r64}), "
        f"each with the clock on the host and on the device")

    timings = {}   # label: (kernel ms, plain ms, device ms, bound ms)
    for label, g, (road_c, sel_c, t_c, key_c) in (
            ("Grid16x16", net, cases[len(cases) // 2]),
            ("Grid64x64", big, big_cases[0])):
        args = (road_c, sel_c, g, t_c, key_c, physics)
        plain1, kern1, kern2, plain2 = time_pair(
            fused_winner.direction_confirm,
            fused_winner.direction_confirm_plain, args)
        dev_ms, acts = device_time_per_call(fused_winner.direction_confirm,
                                            args)
        bound = k1_bound_ms(g, road_c, sel_c, t_c, key_c, physics)
        timings[label] = (min(kern1, kern2), min(plain1, plain2), dev_ms,
                          bound)
        log(f"fused_winner {label} (R={g.num_roads}): kernel "
            f"{kern1 * 1e3:.2f} / {kern2 * 1e3:.2f} us per call, plain "
            f"{plain1 * 1e3:.2f} / {plain2 * 1e3:.2f} us per call "
            f"(plain, kernel, kernel, plain; CUDA events over "
            f"{TIMED_CALLS} calls); device {fmt_us(dev_ms)} per call "
            f"in {acts:.1f} kernels and memsets (torch.profiler over "
            f"{TIMED_CALLS} calls); bound {bound[0] * 1e3:.4f} us by "
            f"{bound[1]} ({card})")

    # --- 4. the episode in context ----------------------------------------
    ref = captured[0]
    plain_state = init_sim_state(net, agents, sim=sim, policy=policy)
    launches_before = fused_winner.LAUNCHES
    plain_state, _ = run_episode(plain_state, net, policy, CAPTURE_EVERY,
                                 sim=sim,
                                 core=fused_winner.direction_confirm_plain)
    if fused_winner.LAUNCHES != launches_before:
        raise AssertionError("the plain episode launched the kernel")
    mismatched = _diff_paths(to_numpy(ref), to_numpy(plain_state))
    if mismatched:
        raise AssertionError(f"kernel and plain episodes differ at tick "
                             f"{CAPTURE_EVERY}: {mismatched}")
    log(f"episode in context: kernel and plain states equal bitwise at tick "
        f"{CAPTURE_EVERY}")

    # --- 5. the shortest-path row -------------------------------------------
    t0 = time.perf_counter()
    net64, agents64 = load_scenario("Grid64x64_200000", 64, 64, 200000, dev)
    agents64 = sort_agents_by_departure(agents64)
    load_s = time.perf_counter() - t0
    sp = sp_row(net64, agents64)
    check_sp_row(sp, net64)
    final = sp["final"]
    log(f"sp row Grid64x64: {net64.num_roads} roads, "
        f"{net64.num_intersections} intersections, {agents64.num_agents} "
        f"agent rows; set-up {load_s:.1f} s scenario + {sp['init_s']:.2f} s "
        f"initial table (scipy Dijkstra + next-road kernel)")
    log(f"sp row: {sp['rate']:.1f} agent-steps/s ({sp['measured']} ticks in "
        f"{sp['wall']:.2f} s, {sp['wall'] / sp['measured'] * 1e3:.3f} "
        f"ms/tick), {sp['refresh_ms']:.3f} ms per refresh (CUDA events, "
        f"{sp['refreshes']} refreshes), done "
        f"{int(final.agents.done.sum())}, on roads "
        f"{int(final.road.count.sum())}, saturation monitor sum "
        f"{sp['saturated']}, host reads per tick "
        f"{sp['reads_per_tick']:.3f}, primal_relax calls "
        f"{sp['relax_launches']} (+{sp['init_next_road_launches']} "
        f"next-road pass of the initial table), fused_winner calls "
        f"{sp['winner_launches']}")

    # --- 6. relax kernel against plain --------------------------------------
    from tarl_tpu_torch.routing import bellman_ford as bf, policies
    from tarl_tpu_torch.routing.bellman_ford import BIG

    iters = sp["routing"].max_bf_iters
    cases64 = grid64_relax_cases(net64, sp["captured"])
    errs = {}
    errs["K2 mode"] = compare_relax(cases64, [(iters, False)])
    errs["relax only, 8 sweeps"] = compare_relax(cases64, [(iters, True)])
    errs["relax only, 1 sweep"] = compare_relax(cases64, [(1, True)])
    # Which form each shape takes: the resident kernel at the sp row (8
    # sweeps, uncapped) and on Grid16x16; the global form at one sweep, at
    # Grid128x128 and at Grid256x256.
    forms = {}
    for label, g, d_n, n_it in (
            ("Grid64, 8 sweeps", net64, net64.num_intersections, iters),
            ("Grid64, 1 sweep", net64, net64.num_intersections, 1),
            ("Grid16, uncapped", net, net.num_intersections, None)):
        forms[label] = bf.resident_plan(g.num_intersections, d_n,
                                        g.inter_out_road.shape[1], n_it)
    width64 = forms["Grid64, 8 sweeps"]
    if width64 is None or forms["Grid16, uncapped"] is None \
            or forms["Grid64, 1 sweep"] is not None:
        raise AssertionError(f"resident_plan chose {forms}")
    # A column tail (13 columns: tiles of 8 and 5) and the zoned parts'
    # D below the tile width (4 columns), from two random warm starts.
    tail_cases = [(f"{label}, {d} columns", c, tabs, d0[:, :d].contiguous())
                  for d in (13, 4)
                  for label, c, tabs, d0 in cases64[-3:-1]]
    errs["13 and 4 columns"] = compare_relax(
        tail_cases, [(iters, False), (iters, True), (None, False)])
    cold16 = torch.full((net.num_intersections,) * 2, BIG, device=dev)
    cold16.diagonal().fill_(0.0)
    g16 = np.random.default_rng(16)
    cost16 = net.free_flow * torch.as_tensor(
        g16.uniform(1.0, 4.0, net.num_roads).astype(np.float32), device=dev)
    cases16 = [("Grid16 ties, cold", net.free_flow, relax_tables(net),
                cold16),
               ("Grid16 random, cold", cost16, relax_tables(net), cold16)]
    errs["uncapped, cold"] = compare_relax(cases16, [(None, False)])
    reads16 = sync.HOST_READS
    uncapped16 = [bf.primal_relax_next_roads(c, *tabs, d0, None)[0]
                  for _, c, tabs, d0 in cases16]
    reads16 = sync.HOST_READS - reads16
    if reads16:
        raise AssertionError(f"the uncapped Grid16x16 relax made {reads16} "
                             "host reads; the resident kernel makes none")
    for d in uncapped16:
        if float(d.max()) >= BIG:
            raise AssertionError("uncapped relax left a pair unreached")
    # Past 4,096 rows the cluster form: Grid128x128 (clusters of 4),
    # Grid256x256 (16, the card's non-portable size) and a grid of 5,000
    # intersections in a scattered order (2 blocks, most successors in the
    # other one), with tails of 13 and 3 columns in the tile width the
    # card's capacity gives and at the full width of 7 (masked tails).
    net128, _ = load_scenario("Grid128x128_10", 128, 128, 10, dev)
    cases128 = big_dest_cases(net128)
    t0 = time.perf_counter()
    net256 = grid_network(K8_GRID, K8_GRID, dev)   # phase 15 reuses it
    build256 = time.perf_counter() - t0
    cases256r = big_dest_cases(net256, dests=16)
    net5k = grid_network(*SCATTER_GRID, dev, seed=SCATTER_SEED)
    cases5k = big_dest_cases(net5k, dests=64)
    plans = {}
    for label, g, d_n, blocks in (("Grid128", net128, BIG_DESTS, 4),
                                  ("Grid256", net256, 16, 16),
                                  ("scattered", net5k, 64, 2)):
        i_n, k_n = g.inter_out_road.shape
        plans[label] = bf.launch_cluster_plan(dev, i_n, d_n, k_n, iters)
        if (bf.resident_plan(i_n, d_n, k_n, iters) is not None
                or plans[label] is None or plans[label][1] != blocks):
            raise AssertionError(f"{label} took another form than clusters "
                                 f"of {blocks}: {plans[label]}")
    modes3 = [(iters, False), (iters, True), (None, False)]
    errs["Grid128, 512 dests, cluster form"] = compare_relax(cases128,
                                                             modes3)
    errs["Grid256, 16 dests, clusters of 16"] = compare_relax(
        cases256r, [(iters, False)])
    # The global form past 4,096 rows (several sweeps, the next-road pass),
    # forced: no main path of this script takes it.
    with forced_relax("global"):
        errs["Grid128, 512 dests, global form"] = compare_relax(cases128,
                                                                modes3)
        errs["Grid256, 16 dests, global form"] = compare_relax(
            cases256r, [(iters, False)])
    # Phase 5's initial table: scipy's Dijkstra, then the next-road kernel.
    dist5, _, road5 = policies._primal_unpack(
        sp["state0"].next_hop, net64.num_intersections,
        net64.num_intersections, net64.num_roads)
    errs["next-road kernel, sp row's initial table"] = compare_next_roads(
        "sp row's initial table", dist5, net64.free_flow,
        relax_tables(net64), want=road5)
    errs["scattered 5,000, cluster form"] = compare_relax(cases5k, modes3)
    tails5k = [(f"{label}, {d} columns", c, tabs, d0[:, :d].contiguous())
               for d in (13, 3) for label, c, tabs, d0 in cases5k]
    errs["13 and 3 columns, cluster form"] = compare_relax(tails5k, modes3)
    with forced_relax("full width"):
        errs["13 and 3 columns, full-width tiles"] = compare_relax(tails5k,
                                                                   modes3)
    succ5k = net5k.road_to[net5k.inter_out_road.long()].long()
    half = -(-net5k.num_intersections // 2)
    rows5k = torch.arange(net5k.num_intersections, device=dev)[:, None]
    remote = float((((succ5k >= half) != (rows5k >= half))
                    & net5k.inter_out_ok).sum() / net5k.inter_out_ok.sum())
    log(f"primal_relax vs plain: bitwise equal in every mode ("
        + "; ".join(errs) + f") on {len(cases64)} Grid64x64 inputs "
        f"({len(sp['captured'])} captured refreshes; the resident form in "
        f"tiles of {width64} columns, the global form at one sweep), "
        f"{len(tail_cases)} of 13 and 4 columns, 2 Grid16x16 (uncapped, "
        f"resident, no host read); the cluster form (tile width, blocks) "
        f"{plans} on 2 Grid128x128 (I={net128.num_intersections}), 2 "
        f"Grid256x256 (I={net256.num_intersections}) and 2 scattered "
        f"(I={net5k.num_intersections}, {remote:.1%} of its successors in "
        f"the other block) inputs and {len(tails5k)} tails, each also at "
        f"full width ({card})")

    # Timed in the modes the TPU kernels K2-K6 computed: K2 mode, relax only
    # (K4) and one sweep (K6) on a captured Grid64x64 refresh, and K2 mode
    # at Grid256x256 (16 columns, clusters of 16); K2 mode (K3) and relax
    # only (K5) at Grid128x128 with 512 destination columns in the cluster
    # form and in the global form (phase 22 times both at the million
    # row's shape).
    relax_t = {}
    label, c, tabs, d0 = cases64[len(sp["captured"]) // 2]
    for mode, g, (c_m, d_m), (n_it, only) in (
            ("K2 mode", net64, (c, d0), (iters, False)),
            ("relax only (K4)", net64, (c, d0), (iters, True)),
            ("one sweep (K6)", net64, (c, d0), (1, True)),
            ("Grid256 K2 mode", net256, cases256r[1][1::2],
             (iters, False))):
        args = (c_m, *relax_tables(g), d_m, n_it, only)
        plain1, kern1, kern2, plain2 = time_pair(
            bf.primal_relax_next_roads, bf.primal_relax_next_roads_plain,
            args, RELAX_TIMED_CALLS)
        dev_ms, acts = device_time_per_call(bf.primal_relax_next_roads,
                                            args, RELAX_TIMED_CALLS)
        bound, by = relax_bound_ms(g, n_it, d_m.shape[1], only)
        relax_t[mode] = (min(kern1, kern2), min(plain1, plain2), bound, by,
                         dev_ms)
        log(f"primal_relax {mode} (I={g.num_intersections}, "
            f"D={d_m.shape[1]}, {label if g is net64 else 'warm'}): kernel "
            f"{kern1:.4f} / {kern2:.4f} ms per call, plain {plain1:.4f} / "
            f"{plain2:.4f} ms per call (plain, kernel, kernel, plain), "
            f"device {fmt_us(dev_ms)} per call in {acts:.1f} kernels "
            f"(torch.profiler), bound {bound:.4f} ms by {by} ({card})")
    relax128 = {}
    for mode, only in (("K3", False), ("K5", True)):
        t = time_relax_forms((cases128[1][1], *relax_tables(net128),
                              cases128[1][3], iters, only))
        t["bound"] = relax_bound_ms(net128, iters, BIG_DESTS, only)
        relax128[mode] = t
        log(f"primal_relax {mode} mode at Grid128x128 (I="
            f"{net128.num_intersections}, D={BIG_DESTS}, warm, tile "
            f"{plans['Grid128']}): {fmt_forms(t)}; bound "
            f"{t['bound'][0]:.4f} ms by {t['bound'][1]} ({card})")

    # --- 7. the row in context ---------------------------------------------
    from tarl_tpu_torch.core.step import run_episode_periodic
    from tarl_tpu_torch.simulator import make_policy

    plain_policy = make_policy("dijkstra", sp["routing"], network=net64,
                               relax=bf.primal_relax_next_roads_plain)
    launches_before = bf.LAUNCHES
    plain_sp, _ = run_episode_periodic(sp["state0"], net64, plain_policy,
                                       SP_WARMUP_TICKS, sim=sp["sim"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain_sp, _ = run_episode_periodic(plain_sp, net64, plain_policy,
                                       SP_CONTEXT_TICKS - SP_WARMUP_TICKS,
                                       sim=sp["sim"])
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    if bf.LAUNCHES != launches_before:
        raise AssertionError("the plain sp episode launched the relax kernel")
    mismatched = _diff_paths(_state_bits(sp["at_context"]),
                             _state_bits(plain_sp))
    if mismatched:
        raise AssertionError(f"kernel and plain sp episodes differ at tick "
                             f"{SP_CONTEXT_TICKS}: {mismatched}")
    span = SP_CONTEXT_TICKS - SP_WARMUP_TICKS
    log(f"sp row in context: kernel and plain-relax states equal bitwise at "
        f"tick {SP_CONTEXT_TICKS}, packed table included; ticks "
        f"{SP_WARMUP_TICKS}-{SP_CONTEXT_TICKS}: kernel "
        f"{sp['context_wall'] / span * 1e3:.3f} ms/tick, plain relax "
        f"{plain_wall / span * 1e3:.3f} ms/tick")

    res = learned_paths(dev, net, agents, card)
    net8, st8, ppo8, trained = (res[k] for k in ("net8", "st8", "ppo8",
                                                  "trained"))
    cap8, cap_c, cap16 = res["cap8"], res["cap_c"], res["cap16"]
    eval_launches = res["eval_launches"]
    collect_launches = res["collect_launches"]

    # --- 11. segment kernels against plain ---------------------------------
    captured_cases, action_cases = [], []
    for j, (label, cap) in enumerate((("Grid8x8 eval", cap8),
                                      ("Grid8x8 collect", cap_c),
                                      ("Grid16x16 eval", cap16))):
        for i, (data, ids, n) in enumerate(bare_log_prob_inputs(
                cap.inputs["log_prob"])):
            captured_cases.append((f"{label} log-prob input {i}", data, ids,
                                   n, True))
        for i, (data, ids, n) in enumerate(argmax_inputs(
                cap.inputs["action"], 5100 + 100 * j)):
            captured_cases.append((f"{label} argmax {i}", data, ids, n,
                                   True))
        for i, (logits, ids, n, t, _) in enumerate(cap.inputs["action"]):
            action_cases.append((f"{label} action {i}", logits, ids, n, t))
    if not action_cases:
        raise AssertionError("no action input was captured")
    seg_cases = captured_cases + random_segment_cases(dev)
    seg_err = compare_segments(seg_cases)
    n_captured_actions = len(action_cases)
    action_cases += random_action_cases(dev)
    action_err, action_calls = compare_actions(action_cases, 5500)
    e8, n8 = net8.full_src.shape[0], net8.num_nodes
    timed_act = cap8.inputs["action"][len(cap8.inputs["action"]) // 2]
    timed_in = argmax_inputs([timed_act], 0)[0]
    seg_t = time_segments(*timed_in)
    seg_t16 = time_segments(*argmax_inputs(cap16.inputs["action"][-1:],
                                           0)[0])
    act_t = time_actions(*timed_act[:4], rng.prng_key(5999))
    lp_cases = [(f"Grid8x8 collect {form} {i}", logits, act, ids, n, t)
                for i, (logits, action, ids, n, t) in enumerate(
                    cap_c.inputs["log_prob"])
                for form, act in (("log-softmax", None),
                                  ("log-prob", action))]
    if not lp_cases:
        raise AssertionError("no log-prob input was captured")
    n_captured_lp = len(lp_cases)
    lp_cases += random_log_prob_cases(dev)
    lp_err = compare_log_probs(lp_cases)
    timed_lp = cap_c.inputs["log_prob"][len(cap_c.inputs["log_prob"]) // 2]
    lp_t = time_log_prob(*timed_lp)
    log(f"segment kernels vs plain: bitwise equal on {len(captured_cases)} "
        f"captured inputs (Grid8x8 E={e8}, N={n8}; Grid16x16 "
        f"E={net.full_src.shape[0]}, N={net.num_nodes}) and "
        f"{len(seg_cases) - len(captured_cases)} seeded random cases "
        f"({card})")
    log(f"segment_action (K11's action entry) vs plain: bitwise equal on "
        f"the card and on a CPU copy in {action_calls} calls: "
        f"{n_captured_actions} captured action inputs and "
        f"{len(action_cases) - n_captured_actions} seeded random cases, "
        f"each as mode and as sample with a fresh key ({card})")
    log(f"K10's log-prob entry vs the parent's composition on the bare "
        f"kernels: bitwise equal in {lp_err['calls']} calls "
        f"({n_captured_lp} on the log-prob inputs captured in phase 9, "
        f"{len(lp_cases) - n_captured_lp} seeded cases; both forms); vs "
        f"the plain versions on the card and on a CPU copy: max |diff| "
        f"{lp_err['log_probs']:.3g} (log-softmax, rtol 1e-6, atol 1e-6), "
        f"{lp_err['log_prob']:.3g} (joint, rtol 1e-5, atol 1e-5) ({card})")
    for form, r in lp_t.items():
        p1, k1, k2, p2 = r["all"]
        name = ("segment_log_prob (log_prob)" if form == "log_prob"
                else "segment_log_probs (log_probs)")
        log(f"{name} Grid8x8 (temperature {timed_lp[4]}): kernel "
            f"{k1 * 1e3:.2f} / {k2 * 1e3:.2f} us per call, the parent's "
            f"whole call (the composition on K9 and K10) {p1 * 1e3:.2f} / "
            f"{p2 * 1e3:.2f} us (plain, kernel, kernel, plain; CUDA "
            f"events), PLAIN {r['plain_ms'] * 1e3:.2f} us; device "
            f"{fmt_us(r['device_ms'])} per call in {r['device_acts']:.1f} "
            f"kernels or memsets (the entry's kernel "
            f"{fmt_us(r['kernel_device_ms'])}), the parent's "
            f"{fmt_us(r['parent_device_ms'])}"
            f" in {r['parent_device_acts']:.1f}, PLAIN "
            f"{fmt_us(r['plain_device_ms'])} in "
            f"{r['plain_device_acts']:.1f} (torch.profiler); bound "
            f"{r['bound'][0] * 1e3:.4f} us by {r['bound'][1]} ({card})")
    for mode, r in act_t.items():
        p1, k1, k2, p2 = r["all"]
        log(f"segment_action {mode} Grid8x8 (temperature {timed_act[3]}): "
            f"kernel {k1 * 1e3:.2f} / {k2 * 1e3:.2f} us per call, the "
            f"parent's composed path (PLAIN.action on the card) "
            f"{p1 * 1e3:.2f} / {p2 * 1e3:.2f} us (plain, kernel, kernel, "
            f"plain; CUDA events); device {fmt_us(r['device_ms'])} per "
            f"call in {r['device_acts']:.1f} kernels against "
            f"{fmt_us(r['plain_device_ms'])} in "
            f"{r['plain_device_acts']:.1f} (torch.profiler); bound "
            f"{r['bound'][0] * 1e3:.4f} us by {r['bound'][1]} ({card})")
    for label, tt in (("Grid8x8", seg_t), ("Grid16x16", seg_t16)):
        for name, r in tt.items():
            p1, k1, k2, p2 = r["all"]
            lib = ("none" if r["library_ms"] is None
                   else f"{r['library_ms'] * 1e3:.2f} us (device "
                        f"{fmt_us(r['library_device_ms'])})")
            log(f"segment {name} {label}: kernel {k1 * 1e3:.2f} / "
                f"{k2 * 1e3:.2f} us per call, plain {p1 * 1e3:.2f} / "
                f"{p2 * 1e3:.2f} us (plain, kernel, kernel, plain; CUDA "
                f"events), device {fmt_us(r['device_ms'])} per call in "
                f"{r['device_acts']:.1f} kernels (torch.profiler); library "
                f"{lib} ({card})")

    # --- 12. the learned path in context -----------------------------------
    learned_in_context(ppo8, trained, st8)
    collect_ctx, collect_ctx_err = collection_in_context(net8, trained, st8)

    # --- 13. the fused-core headline -------------------------------------
    sim_fc = headline_sim(fused_core=True, ticks=FUSED_TICKS)
    cap12 = CapturePayload(CAPTURE_EVERY)
    fc = headline_run(net, agents, sim_fc, policy, payload=cap12,
                      ticks=FUSED_TICKS)
    check_headline(fc, "fused-core headline", {"K12": FUSED_TICKS,
                                               "K1": 0, "K7": 0,
                                               "choice": FUSED_TICKS})
    from tarl_tpu_torch.core.step import average_travel_time

    at_fc = captured[FUSED_TICKS // CAPTURE_EVERY - 1].agents
    log(f"fused-core headline: {fc['rate']:.1f} agent-steps/s "
        f"({fc['measured']} ticks in {fc['wall']:.2f} s, "
        f"{fc['wall'] / fc['measured'] * 1e3:.3f} ms/tick; phase 2 "
        f"{head['wall'] / head['measured'] * 1e3:.3f}), done {fc['done']} "
        f"(phase 2 at tick {FUSED_TICKS}: {int(at_fc.done.sum())}), on "
        f"roads {fc['on_road']}, average travel time {fc['avg_tt']:.3f} s "
        f"(phase 2 {float(average_travel_time(at_fc)):.3f} s; "
        f"same law, another stream), host syncs per tick "
        f"{fc['syncs_per_tick']:.3f}, overflow {fc['overflow']}, launches "
        f"{fc['launches']} ({card})")

    # --- 14. the fused core in context ---------------------------------
    reset_counts()
    plain_fc = init_sim_state(net, agents, sim=sim_fc, policy=policy)
    plain_fc, _ = run_episode(plain_fc, net, policy, CAPTURE_EVERY,
                              sim=sim_fc,
                              payload=fused_core.fused_core_sample_plain)
    plain_counts = counts()
    if plain_counts["K12"] or plain_counts["K1"]:
        raise AssertionError(f"the plain fused-core episode launched a "
                             f"kernel: {plain_counts}")
    mismatched = _diff_paths(to_numpy(fc["captured"][0]), to_numpy(plain_fc))
    if mismatched:
        raise AssertionError(f"kernel and plain fused-core episodes differ "
                             f"at tick {CAPTURE_EVERY}: {mismatched}")
    log(f"fused core in context: kernel and plain edge-phase states equal "
        f"bitwise at tick {CAPTURE_EVERY} (plain run launches "
        f"{plain_counts})")

    # --- 15. K1 at the tiled winner's size (K8a/K8b) ----------------------
    kin256, r256 = net256.in_src_tab.shape
    cases256 = []
    for i in range(K8_STATES):
        t_now = 6 * 3600.0 + 53 * i
        road256, sel256 = random_road_state(net256, 256 + i, t_now)
        cases256.append((road256, sel256, t_now, rng.prng_key(4000 + i)))
    reset_counts()
    err256 = compare_kernel(cases256, net256, physics)
    k8_launches = counts()["K1"]
    road_c, sel_c, t_c, key_c = cases256[0]
    k8_t = time_pair(fused_winner.direction_confirm,
                     fused_winner.direction_confirm_plain,
                     (road_c, sel_c, net256, t_c, key_c, physics))
    k8_bound = k1_bound_ms(net256, road_c, sel_c, t_c, key_c, physics)
    log(f"fused_winner at Grid256x256 (R={r256}, {kin256} in-slots; network "
        f"built from arrays in {build256:.1f} s): bitwise equal to plain on "
        f"{K8_STATES} random states, clock on the host and on the device "
        f"({k8_launches} K1 launches); kernel {k8_t[1]:.4f} / {k8_t[2]:.4f} ms per call, plain "
        f"{k8_t[0]:.4f} / {k8_t[3]:.4f} ms (plain, kernel, kernel, plain; "
        f"{card})")

    # --- 16. K12 against plain --------------------------------------------
    from tarl_tpu_torch.ops.segment import segment_layout

    hub = hub_network(HUB_SPOKES, dev)
    hub_cases = []
    for i in range(HUB_STATES):
        t_now = 6 * 3600.0 + 7 * i
        road_h, sel_h = random_road_state(hub, 500 + i, t_now)
        hub_cases.append((road_h, sel_h, t_now, rng.prng_key(5000 + i)))
    fused_cases = (
        cap12.inputs
        + [(f"Grid64x64 random {i}", big, road_c, sel_c, t_c,
            rng.prng_key(6000 + i))
           for i, (road_c, sel_c, t_c, _) in enumerate(big_cases)]
        + [(f"hub {HUB_SPOKES} random {i}", hub, road_c, sel_c, t_c, key_c)
           for i, (road_c, sel_c, t_c, key_c) in enumerate(hub_cases)])
    err12f = compare_fused_sample(fused_cases, physics)
    k12f_t = {}   # label: (kernel ms, plain ms, device ms, bound ms, by)
    for label, (_, g, road_c, sel_c, t_c, key_c) in (
            ("Grid16x16", cap12.inputs[len(cap12.inputs) // 2]),
            ("Grid64x64", fused_cases[len(cap12.inputs)])):
        args = (road_c, sel_c, g, t_c, key_c, physics)
        p1, k1, k2, p2 = time_pair(fused_core.fused_core_sample,
                                   fused_core.fused_core_sample_plain, args)
        dev_ms, acts = device_time_per_call(fused_core.fused_core_sample,
                                            args)
        bound, by = k12_fused_bound_ms(g, road_c, sel_c, t_c, key_c, physics)
        k12f_t[label] = (min(k1, k2), min(p1, p2), dev_ms, bound, by)
        log(f"fused_core K12 fused entry {label} (E={g.edge_src.shape[0]}, "
            f"R={g.num_roads}): kernel {k1 * 1e3:.2f} / {k2 * 1e3:.2f} us "
            f"per call, plain {p1 * 1e3:.2f} / {p2 * 1e3:.2f} us (plain, "
            f"kernel, kernel, plain; CUDA events over {TIMED_CALLS} calls); "
            f"device {fmt_us(dev_ms)} per call in {acts:.1f} kernels "
            f"(torch.profiler); bound {bound * 1e3:.4f} us by {by} ({card})")
    log(f"fused_core K12 fused entry vs plain: bitwise equal on both "
        f"payloads on {len(cap12.inputs)} states kept in phase 13, "
        f"{len(big_cases)} random Grid64x64 states and {len(hub_cases)} "
        f"random states of a {HUB_SPOKES}-spoke hub "
        f"({hub.in_src_tab.shape[0]} in-slots), each with its own key")

    rand12 = random_payload_cases([("Grid64x64", big),
                                   ("Grid256x256", net256)], dev)
    bare_kept = bare_payload_cases(cap12.inputs, physics)
    k12_cases = bare_kept + rand12
    err12 = compare_payload(k12_cases)
    k12_t = {}    # label: (kernel ms, plain ms, device ms, bound ms, by)
    for label, (_, logits, ids, pay_a, pay_b, key, n) in (
            ("Grid16x16", bare_kept[len(bare_kept) // 2]),
            ("Grid256x256", rand12[1])):
        args = (logits, ids, pay_a, pay_b, key, n, segment_layout(ids, n))
        p1, k1, k2, p2 = time_pair(fused_core.gumbel_argmax_payload,
                                   fused_core.gumbel_argmax_payload_plain,
                                   args)
        dev_ms, acts = device_time_per_call(fused_core.gumbel_argmax_payload,
                                            args)
        bound, by = k12_bound_ms(logits, ids, n)
        k12_t[label] = (min(k1, k2), min(p1, p2), dev_ms, bound, by)
        log(f"fused_core K12 bare {label} (E={logits.shape[0]}, S={n}): "
            f"kernel {k1 * 1e3:.2f} / {k2 * 1e3:.2f} us per call, plain "
            f"{p1 * 1e3:.2f} / {p2 * 1e3:.2f} us (plain, kernel, kernel, "
            f"plain); device {fmt_us(dev_ms)} per call in {acts:.1f} "
            f"kernels; bound {bound * 1e3:.4f} us by {by} ({card})")
    log(f"fused_core K12 bare vs plain: bitwise equal on both payloads on "
        f"the logits of {len(bare_kept)} states kept in phase 13 and seeded "
        f"random cases: " + "; ".join(case[0] for case in rand12))

    # --- 17. the sharded headline (keeps phase 19's inputs) ---------------
    from tarl_tpu_torch.parallel.shard_map_episode import (
        make_road_mesh, run_episode_shard_map)

    mesh = make_road_mesh(SHARD_BLOCKS, dev)
    cap7 = CaptureWinner(CAPTURE_EVERY, "sharded headline")

    def sharded(state, n):
        return run_episode_shard_map(state, net, policy, n, mesh, sim=sim,
                                     winner=cap7)

    sh = headline_run(net, agents, sim, policy, runner=sharded,
                      ticks=SHARD_TICKS)
    check_headline(sh, "sharded headline",
                   {"K7": SHARD_TICKS, "K1": 0, "K12": 0,
                    "choice": SHARD_TICKS})
    mismatched = _diff_paths(
        to_numpy(head["captured"][SHARD_TICKS // CAPTURE_EVERY - 1]),
        to_numpy(sh["final"]))
    if mismatched:
        raise AssertionError(f"sharded and serial headlines differ at tick "
                             f"{SHARD_TICKS}: {mismatched}")
    logs_a = {f: a[:SHARD_TICKS] for f, a in to_numpy(head["logs"]).items()}
    logs_b = to_numpy(sh["logs"])
    exact = ("departures", "arrivals", "on_way", "time", "window_saturated")
    mismatched = _diff_paths({f: logs_a[f] for f in exact},
                             {f: logs_b[f] for f in exact}, "logs")
    if mismatched:
        raise AssertionError(f"sharded and serial headline logs differ: "
                             f"{mismatched}")
    da, db = logs_a["road_delta_tt"], logs_b["road_delta_tt"]
    if da.shape != db.shape:
        raise AssertionError(f"road_delta_tt shapes {da.shape}, {db.shape}")
    if np.array_equal(da, db):
        delta_held = f"bitwise (shape {da.shape})"
    elif np.allclose(db, da, rtol=1e-5, atol=1e-3):
        delta_held = "within rtol 1e-5, atol 1e-3, not bitwise"
    else:
        raise AssertionError("sharded road_delta_tt outside rtol 1e-5, "
                             "atol 1e-3")
    log(f"sharded headline ({SHARD_BLOCKS} blocks of "
        f"{net.num_roads // SHARD_BLOCKS} roads): {sh['rate']:.1f} "
        f"agent-steps/s ({sh['measured']} ticks in {sh['wall']:.2f} s, "
        f"{sh['wall'] / sh['measured'] * 1e3:.3f} ms/tick; phase 2 "
        f"{head['wall'] / head['measured'] * 1e3:.3f}), done {sh['done']}, "
        f"on roads {sh['on_road']}, host reads per tick "
        f"{sh['syncs_per_tick']:.3f}, overflow {sh['overflow']}, launches "
        f"{sh['launches']}; state at tick {SHARD_TICKS} and the logs' "
        f"integer fields bitwise equal to phase 2's, road_delta_tt "
        f"{delta_held} ({card})")

    # --- 18. the padded mesh ----------------------------------------------
    cap7p = CaptureWinner(CAPTURE_EVERY // 2, "padded mesh")
    reset_counts()
    padded, _ = run_episode_shard_map(
        init_sim_state(net, agents, sim=sim, policy=policy), net, policy,
        CAPTURE_EVERY, make_road_mesh(PADDED_BLOCKS, dev), sim=sim,
        winner=cap7p)
    padded_counts = counts()
    if padded_counts["K7"] != CAPTURE_EVERY or padded_counts["K1"]:
        raise AssertionError(f"padded mesh: launches {padded_counts}")
    mismatched = _diff_paths(to_numpy(captured[0]), to_numpy(padded))
    if mismatched:
        raise AssertionError(f"padded mesh and phase 2 differ at tick "
                             f"{CAPTURE_EVERY}: {mismatched}")
    rp7 = -(-net.num_roads // PADDED_BLOCKS) * PADDED_BLOCKS
    log(f"padded mesh ({PADDED_BLOCKS} blocks, {rp7} rows, "
        f"{rp7 - net.num_roads} inert): state bitwise equal to phase 2's at "
        f"tick {CAPTURE_EVERY}; launches {padded_counts}")

    # --- 19. K7 against plain ---------------------------------------------
    k7_cases = ([(lb, a, SHARD_BLOCKS) for lb, a in cap7.inputs]
                + [(lb, a, PADDED_BLOCKS) for lb, a in cap7p.inputs])
    for label, g, states, blocks, key0 in (
            ("Grid64x64", big, big_cases, SHARD_BLOCKS, 7000),
            ("Grid256x256", net256, cases256, SHARD_BLOCKS, 7100),
            (f"hub {HUB_SPOKES}", hub, hub_cases, 3, 7200)):
        k7_cases += [(f"{label} random {i}",
                      shard_winner_args(g, road_c, sel_c, t_c,
                                        rng.prng_key(key0 + i), blocks,
                                        physics), blocks)
                     for i, (road_c, sel_c, t_c, _) in enumerate(states)]
    err7 = compare_shard_winner(k7_cases)
    k7_t = {}    # label: (kernel ms, plain ms, device ms, bound ms, by)
    for label, args in (("Grid16x16", cap7.inputs[len(cap7.inputs) // 2][1]),
                        ("Grid256x256",
                         k7_cases[-1 - HUB_STATES][1])):
        p1, k1, k2, p2 = time_pair(fused_winner.fused_shard_winner,
                                   fused_winner.fused_shard_winner_plain,
                                   args)
        dev_ms, acts = device_time_per_call(fused_winner.fused_shard_winner,
                                            args)
        bound, by = k7_bound_ms(args)
        k7_t[label] = (min(k1, k2), min(p1, p2), dev_ms, bound, by)
        log(f"fused_shard_winner K7 {label} (n={args[5].shape[0]} roads in "
            f"{SHARD_BLOCKS} blocks, {args[4].in_src.shape[0]} in-slots): "
            f"kernel {k1 * 1e3:.2f} / {k2 * 1e3:.2f} us per call, plain "
            f"{p1 * 1e3:.2f} / {p2 * 1e3:.2f} us (plain, kernel, kernel, "
            f"plain); device {fmt_us(dev_ms)} per call in {acts:.1f} "
            f"kernels (torch.profiler); bound {bound * 1e3:.4f} us by {by} "
            f"({card})")
    log(f"fused_shard_winner K7 vs plain: bitwise equal on all four outputs, "
        f"whole device and last block, on {len(cap7.inputs)} + "
        f"{len(cap7p.inputs)} inputs kept in phases 17 and 18, "
        f"{len(big_cases)} random Grid64x64, {len(cases256)} random "
        f"Grid256x256 and {len(hub_cases)} random {HUB_SPOKES}-spoke hub "
        f"states, each with its own key")

    # --- 20. the sharded shortest-path row -------------------------------
    sp_policy = make_policy("dijkstra", sp["routing"], network=net64)
    sp_mesh = make_road_mesh(SHARD_BLOCKS, dev)
    reset_counts()
    bf.reset_launches()
    sp_sh, _ = run_episode_shard_map(sp["state0"], net64, sp_policy,
                                     SP_WARMUP_TICKS, sp_mesh, sim=sp["sim"],
                                     routing=sp["routing"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sp_sh, _ = run_episode_shard_map(sp_sh, net64, sp_policy,
                                     SP_CONTEXT_TICKS - SP_WARMUP_TICKS,
                                     sp_mesh, sim=sp["sim"],
                                     routing=sp["routing"])
    torch.cuda.synchronize()
    sp_sh_wall = time.perf_counter() - t0
    sp_sh_counts = counts()
    sp_sh_counts["K2"] = bf.LAUNCHES
    refreshes = SP_CONTEXT_TICKS // sp["routing"].refresh_rate
    if (sp_sh_counts["K2"], sp_sh_counts["K7"], sp_sh_counts["K1"]) != (
            refreshes, SP_CONTEXT_TICKS, 0):
        raise AssertionError(f"sharded sp row: launches {sp_sh_counts}, "
                             f"expected K2 {refreshes}, K7 "
                             f"{SP_CONTEXT_TICKS}, K1 0")
    mismatched = _diff_paths(_state_bits(sp["at_context"]),
                             _state_bits(sp_sh))
    if mismatched:
        raise AssertionError(f"sharded and serial sp rows differ at tick "
                             f"{SP_CONTEXT_TICKS}: {mismatched}")
    span = SP_CONTEXT_TICKS - SP_WARMUP_TICKS
    log(f"sharded sp row ({SHARD_BLOCKS} blocks of "
        f"{net64.num_roads // SHARD_BLOCKS} roads): state bitwise equal to "
        f"phase 5's at tick {SP_CONTEXT_TICKS}, packed table included; ticks "
        f"{SP_WARMUP_TICKS}-{SP_CONTEXT_TICKS}: "
        f"{sp_sh_wall / span * 1e3:.3f} ms/tick (phase 5 "
        f"{sp['context_wall'] / span * 1e3:.3f}); launches {sp_sh_counts} "
        f"({card})")

    # --- 21. training ------------------------------------------------------
    train = training_phase(net8, trained, st8, card)

    # --- 22, 23, 24a, 25, 26: the million-agent row, the radial metro, the
    # classical rows, the CLI and the irregular city, and 24b's report, in
    # two spawned processes beside 24b-c and 27 ---------------------------
    t_side = time.perf_counter()
    side = spawn_side_phases(str(dev), card)

    # --- 24b-c. the dual row and the largest dual network ----------------
    t0 = time.perf_counter()
    cli = cli_default_phase(dev, card, REPORT_INPUT)
    log(f"CLI default phase (b, c) in {time.perf_counter() - t0:.1f} s")

    # --- 27. the Graph Transformer ------------------------------------------
    gt = transformer_phase(dev, card, net, agents)
    log(f"transformer phase in {gt['seconds']:.1f} s")

    side = join_side_phases(side)
    log(f"phases 22-26's processes joined {time.perf_counter() - t_side:.1f} "
        f"s after their start")
    PARSES.extend(side["parses"])
    mil, rad, city, cli_run = (side[k] for k in ("mil", "rad", "city",
                                                 "cli_run"))
    mil_sp = mil["sp"]
    rad_sp, rad_t = rad["sp"], rad["timed"]
    cli.update(rows=side["classical"]["rows"],
               eager=side["classical"]["eager"])
    gt_launches = {key: {
        "eval_braess": gt["a"]["launches"][key],
        "collection_braess": gt["b"]["collect"][key],
        "training_iteration": gt["b"]["iteration"][key],
        "cli_train": gt["c"]["launches"]["train"][key],
        "cli_checkpoint_eval": gt["c"]["launches"]["checkpoint"][key],
        "cli_eval": gt["c"]["launches"]["eval"][key],
        "learned_episode": gt["d"]["launches"][key]}
        for key in ("K1", "K10", "K11")}

    # --- 28. batched training and the native parser -----------------------
    bat = batched_parser_phase(net8, trained, st8, card, train)
    bat_launches = {key: {"training_step": bat["b"]["launches"][key],
                          "cli_train": bat["c"]["train"][key],
                          "cli_checkpoint_eval": bat["c"]["eval"][key]}
                    for key in ("K1", "K10", "K11")}

    # --- 29. every policy on road blocks, blocks across processes --------
    blk = road_blocks_phase(dev, card, _state_bits(captured[0]),
                            (net8, st8.agents, ppo8, trained), gt["d"],
                            cli["dual_blocks"])
    log(f"road blocks phase in {blk['seconds']:.1f} s")
    blk_launches = {
        "29a_mpnn": blk["a"]["launches"]["K7"],
        "29b_transformer": blk["b"]["launches"]["K7"],
        "29c_dual": blk["c_dual"]["launches"]["K7"],
        "29c_strict": blk["c_strict"]["launches"]["K7"],
        **{f"29d_{b}_rank{k}": r["launches"]["K7"]
           for (b, k), r in sorted(blk["d"].items())}}

    # --- 30. sharded and spatial training, the dry run, the legacy confirm
    ppo_blk = ppo_blocks_phase(dev, card, net8, st8, trained,
                               train["records"], bat["b"]["record"],
                               captured, net)
    log(f"sharded and spatial training phase in {ppo_blk['seconds']:.1f} s")
    ppo_launches = {key: {
        "30a_sharded_mpnn": ppo_blk["a"]["launches"][key],
        "30b_sharded_transformer": ppo_blk["b"]["launches"][key],
        **{f"30d_{b}_rank{k}_{name}": r[f"{name}_launches"][key]
           for (b, k), r in sorted(ppo_blk["d"].items())
           for name in ("sharded", "batched")}}
        for key in ("K1", "K10", "K11")}
    spatial_launches = {
        "30c_rollout": ppo_blk["c"]["launches"]["K7"],
        "30c_iteration": ppo_blk["c"]["iteration_launches"]["K7"],
        **{f"30d_{b}_rank{k}": r["spatial_launches"]["K7"]
           for (b, k), r in sorted(ppo_blk["d"].items())}}

    # --- 31. the golden trace's path and the packed view ------------------
    gold = golden_trace_phase(dev, card, head["final"], net, res["mid8"],
                              net8)

    # --- 32. results ------------------------------------------------------
    log(f"all phases in {time.perf_counter() - t_start:.1f} s")
    train_launches = train["launches"]
    kern_ms, plain_ms, kern_dev_ms, k1_bound = timings["Grid16x16"]
    seg_entries = []
    for name, key, line in (("sum", "K9", 66), ("max", "K10", 121),
                            ("argmax", "K11", 169)):
        launches_seg = (eval_launches[key] if key == "K11"
                        else collect_launches[key])
        seg_entries.append({
            "name": f"segment_{name}",
            "route": "cuda",
            "source": "tarl_tpu_torch/csrc/segment.cu",
            "replaces": f"tarl_tpu/ops/pallas_segment.py:{line}",
            "launches": launches_seg,
            "launches_from": ("learned eval (phase 8)" if key == "K11"
                              else "rollout collection (phase 9)")
            + "; the CLI's training and checkpoint evaluation (phase 25) in "
              "launches_cli_train and launches_cli_eval; the transformer's "
              "paths (phase 27) in launches_transformer; batched training "
              "and its CLI (phase 28) in launches_batched",
            "max_abs_err": seg_err[name],
            "ms": seg_t[name]["ms"],
            "device_ms": seg_t[name]["device_ms"],
            "plain_ms": seg_t[name]["plain_ms"],
            "bound_ms": segment_bound_ms(e8, n8),
            "bound_by": "bytes",
            "library_ms": seg_t[name]["library_ms"],
            "library_device_ms": seg_t[name]["library_device_ms"],
            "shape": f"E={e8}, N={n8}",
            "ms_grid16": seg_t16[name]["ms"],
            "launches_training": train_launches[key],
            "launches_cli_train": cli_run["train"][key],
            "launches_cli_eval": cli_run["eval"][key],
        })
        if key in gt_launches:
            seg_entries[-1]["launches_transformer"] = gt_launches[key]
            seg_entries[-1]["launches_batched"] = bat_launches[key]
            seg_entries[-1]["launches_ppo_blocks"] = ppo_launches[key]
    # K10's row: the log-prob entry, which the collection launches; the bare
    # max (the TPU kernel's own function) beside it.
    lp, lps = lp_t["log_prob"], lp_t["log_probs"]
    seg_entries[1].update({
        "entry": "segment_log_prob (the scale, the segment max, the "
                 "log-softmax, the action's validity and masked log-probs "
                 "in one launch after a memset; torch.sum and masked_fill_ "
                 "make the joint); segment_log_probs, the log-softmax, in "
                 "one launch",
        "max_abs_err": max(seg_err["max"], lp_err["log_prob"],
                           lp_err["log_probs"]),
        "ms": lp["ms"], "device_ms": lp["device_ms"],
        "device_kernels": lp["device_acts"],
        "kernel_device_ms": lp["kernel_device_ms"],
        "plain_ms": lp["plain_ms"], "plain_device_ms": lp["plain_device_ms"],
        "plain_device_kernels": lp["plain_device_acts"],
        "parent_ms": lp["parent_ms"],
        "parent_device_ms": lp["parent_device_ms"],
        "parent_device_kernels": lp["parent_device_acts"],
        "bound_ms": lp["bound"][0], "bound_by": lp["bound"][1],
        "library_ms": None, "library_device_ms": None,
        "log_softmax_ms": lps["ms"],
        "log_softmax_device_ms": lps["device_ms"],
        "log_softmax_parent_ms": lps["parent_ms"],
        "log_softmax_parent_device_ms": lps["parent_device_ms"],
        "log_softmax_plain_ms": lps["plain_ms"],
        "log_softmax_bound_ms": lps["bound"][0],
        "launches_collection_in_context": collect_ctx["kernels"]["K10"],
        "collection_log_prob_max_abs_err": collect_ctx_err,
        "bare_ms": seg_t["max"]["ms"],
        "bare_device_ms": seg_t["max"]["device_ms"],
        "bare_plain_ms": seg_t["max"]["plain_ms"],
        "bare_library_ms": seg_t["max"]["library_ms"],
        "bare_bound_ms": segment_bound_ms(e8, n8),
        "bare_launches_response_step": ppo_blk["f"]["launches"]["K10"],
    })
    # K11's row: the action entry, which the learned paths launch; the
    # bare argmax (the TPU kernel's own function) beside it.
    k11 = seg_entries[2]
    mode_t, sample_t = act_t["mode"], act_t["sample"]
    k11.update({
        "entry": "segment_action (mode: scale, argmax and the multi-hot "
                 "action in one launch; sample: the Gumbel noise drawn "
                 "inside too)",
        "max_abs_err": max(seg_err["argmax"], action_err),
        "ms": mode_t["ms"], "device_ms": mode_t["device_ms"],
        "plain_ms": mode_t["plain_ms"],
        "plain_device_ms": mode_t["plain_device_ms"],
        "plain_device_kernels": mode_t["plain_device_acts"],
        "bound_ms": mode_t["bound"][0], "bound_by": mode_t["bound"][1],
        "library_ms": None, "library_device_ms": None,
        "sample_ms": sample_t["ms"],
        "sample_device_ms": sample_t["device_ms"],
        "sample_plain_ms": sample_t["plain_ms"],
        "sample_plain_device_ms": sample_t["plain_device_ms"],
        "sample_plain_device_kernels": sample_t["plain_device_acts"],
        "sample_bound_ms": sample_t["bound"][0],
        "sample_launches": collect_launches["K11"],
        "bare_ms": seg_t["argmax"]["ms"],
        "bare_device_ms": seg_t["argmax"]["device_ms"],
        "bare_plain_ms": seg_t["argmax"]["plain_ms"],
        "bare_bound_ms": segment_bound_ms(e8, n8),
    })
    print(json.dumps({"kernels": [{
        "name": "fused_winner",
        "route": "cuda",
        "source": "tarl_tpu_torch/csrc/fused_winner.cu",
        "replaces": "tarl_tpu/core/fused_winner.py:96",
        "launches": launches,
        "max_abs_err": float(max(err16, err64)),
        "ms": kern_ms,
        "device_ms": kern_dev_ms,
        "plain_ms": plain_ms,
        "bound_ms": k1_bound[0],
        "bound_by": k1_bound[1],
        "library_ms": None,
        "ms_grid64": timings["Grid64x64"][0],
        "device_ms_grid64": timings["Grid64x64"][2],
        "plain_ms_grid64": timings["Grid64x64"][1],
        "bound_ms_grid64": timings["Grid64x64"][3][0],
        "launches_sp_row": sp["winner_launches"],
        "launches_training": train_launches["K1"],
        "launches_classical_rows": {name: r["launches"]
                                    for name, r in cli["rows"].items()},
        "launches_eager_braess": cli["eager"]["launches"]["K1"],
        "launches_dual_row": cli["dual"]["winner_launches"],
        "launches_dual_primal_cross_check":
            cli["primal"]["winner_launches"],
        "launches_cli_easy": cli_run["easy"]["K1"],
        "launches_cli_train": cli_run["train"]["K1"],
        "launches_cli_eval": cli_run["eval"]["K1"],
        "launches_city_random": city["exact"]["launches"]["K1"],
        "launches_city_sp": city["sp"]["winner_launches"],
        "launches_transformer": gt_launches["K1"],
        "launches_batched": bat_launches["K1"],
        "launches_ppo_blocks": ppo_launches["K1"],
        "launches_golden_trace": gold["kernel"]["K1"],
        "launches_golden_trace_plain": gold["plain"]["K1"],
        "launches_from": "headline (phase 2); beside it the sp row (5), "
                         "training (21), the classical and dual rows (24), "
                         "the CLI (25), the city rows (26), the "
                         "transformer's paths (27), batched training "
                         "(28), sharded training (30) and the golden "
                         "trace's path (31, its plain run beside it)",
    }, {
        "name": "primal_relax",
        "route": "cuda",
        "source": "tarl_tpu_torch/csrc/primal_relax.cu",
        "replaces": "tarl_tpu/routing/bellman_ford.py:644",
        "launches": sp["relax_launches"],
        "next_road_launches": sp["next_road_launches"],
        "max_abs_err": max(errs.values()),
        "ms": relax_t["K2 mode"][0],
        "device_ms": relax_t["K2 mode"][4],
        "plain_ms": relax_t["K2 mode"][1],
        "bound_ms": relax_t["K2 mode"][2],
        "bound_by": relax_t["K2 mode"][3],
        "library_ms": None,
        "modes": list(errs),
        "tile_columns": width64,
        "launches_dual_primal_cross_check": cli["primal"]["relax_launches"],
        "resident_launches_dual_primal_cross_check":
            cli["primal"]["resident_launches"],
        "ms_grid256_cluster16": relax_t["Grid256 K2 mode"][0],
        "device_ms_grid256_cluster16": relax_t["Grid256 K2 mode"][4],
        "plain_ms_grid256_cluster16": relax_t["Grid256 K2 mode"][1],
        "bound_ms_grid256_cluster16": relax_t["Grid256 K2 mode"][2],
    }] + [{
        "name": name,
        "route": "cuda",
        "source": "tarl_tpu_torch/csrc/primal_relax.cu",
        "replaces": f"tarl_tpu/routing/bellman_ford.py:{line}",
        "entry": "pr_cluster_kernel (tarl_primal_cluster): a tile of all "
                 "rows across a cluster's shared memory, read through DSMEM",
        "launches": launches,
        "launches_from": launches_from,
        "max_abs_err": max(max(errs.values()), *mil["errs"].values()),
        "ms": min(t["kernel"]),
        "device_ms": t["device"][0],
        "plain_ms": min(t["plain"]),
        "bound_ms": t["bound"][0],
        "bound_by": t["bound"][1],
        "library_ms": None,
        "shape": f"I={mil['i_n']}, D={mil['d_n']}, 8 sweeps{tail}",
        "global_ms": min(t["global"]),
        "global_device_ms": t["global_device"][0],
        "ms_grid128_d512": min(t128["kernel"]),
        "device_ms_grid128_d512": t128["device"][0],
        "global_ms_grid128_d512": min(t128["global"]),
        "global_device_ms_grid128_d512": t128["global_device"][0],
        "plain_ms_grid128_d512": min(t128["plain"]),
        "bound_ms_grid128_d512": t128["bound"][0],
    } for name, line, tail, t, t128, launches, launches_from in (
        ("multisweep_nr_rowblock", 518, " + next road", mil["timed"]["K3"],
         relax128["K3"],
         mil_sp["relax_launches"] - mil_sp["table_init"]["relax"],
         "million row's refreshes (phase 22), the cluster form"),
        ("multisweep_rowblock", 486, "", mil["timed"]["K5"], relax128["K5"],
         mil_sp["table_init"]["cluster"],
         "million row's uncapped table init (phase 22): K5's function, the "
         "relax, uncapped in the cluster form with its next roads in the "
         "same launch, no host read"))] + [{
        "name": "multisweep",
        "route": "cuda",
        "source": "tarl_tpu_torch/csrc/primal_relax.cu",
        "replaces": "tarl_tpu/routing/bellman_ford.py:436",
        "covered_by": "primal_relax",
        "launches": sp["relax_launches"],
        "launches_from": "sp row (phase 5), K2's kernels",
        "max_abs_err": max(errs.values()),
        "ms": relax_t["relax only (K4)"][0],
        "device_ms": relax_t["relax only (K4)"][4],
        "plain_ms": relax_t["relax only (K4)"][1],
        "bound_ms": relax_t["relax only (K4)"][2],
        "bound_by": relax_t["relax only (K4)"][3],
        "library_ms": None,
        "mode": "relax only (K4)",
    }, {
        "name": "sweep",
        "route": "cuda",
        "source": "tarl_tpu_torch/csrc/primal_relax.cu",
        "replaces": "tarl_tpu/routing/bellman_ford.py:408",
        "entry": "pr_global_kernel (tarl_primal_global): the relax's global "
                 "form, every sweep, the early exit and the next roads in "
                 "one cooperative launch",
        "launches": rad_sp["forms"]["global"],
        "launches_from": "the radial row's 102 refreshes and its uncapped "
                         "table init (phase 23), one launch each; the sp "
                         f"row {sp['forms']['global']} and the million row "
                         f"{mil_sp['forms']['global']}; the city sp row's "
                         "(phase 26) in launches_city",
        "launches_city": city["sp"]["forms"]["global"],
        "max_abs_err_city": city["err"],
        "shape_city": f"I={city['i_n']}, D={city['d_n']}, K={city['k_n']}, "
                      "8 sweeps + next road, a captured city refresh",
        "ms_city": city["timed"]["ms"],
        "device_ms_city": city["timed"]["device_ms"],
        "plain_ms_city": city["timed"]["plain_ms"],
        "bound_ms_city": city["timed"]["bound"][0],
        "max_abs_err": max(max(errs.values()), *rad["errs"].values()),
        "ms": rad_t["ms"],
        "device_ms": rad_t["device_ms"],
        "plain_ms": rad_t["plain_ms"],
        "bound_ms": rad_t["bound"][0],
        "bound_by": rad_t["bound"][1],
        "library_ms": None,
        "shape": f"I={rad['i_n']}, D={rad['d_n']}, K={rad['k_n']}, 8 sweeps "
                 "+ next road, a captured radial refresh",
        "init_ms": rad_t["init_ms"],
        "init_device_ms": rad_t["init_device_ms"],
        "ms_grid64_one_sweep": relax_t["one sweep (K6)"][0],
        "device_ms_grid64_one_sweep": relax_t["one sweep (K6)"][4],
        "plain_ms_grid64_one_sweep": relax_t["one sweep (K6)"][1],
        "bound_ms_grid64_one_sweep": relax_t["one sweep (K6)"][2],
    }] + seg_entries + [{
        "name": "fused_core",
        "route": "cuda",
        "source": "tarl_tpu_torch/csrc/fused_core.cu",
        "replaces": "tarl_tpu/core/fused_core.py:53",
        "entry": "fused_core_sample (eligibility, logits and Gumbel-max "
                 "in one launch)",
        "launches": fc["launches"]["K12"],
        "launches_from": "fused-core headline (phase 13)",
        "max_abs_err": max(err12f, err12),
        "ms": k12f_t["Grid16x16"][0],
        "device_ms": k12f_t["Grid16x16"][2],
        "plain_ms": k12f_t["Grid16x16"][1],
        "bound_ms": k12f_t["Grid16x16"][3],
        "bound_by": k12f_t["Grid16x16"][4],
        "library_ms": None,
        "shape": f"E={net.edge_src.shape[0]}, R={net.num_roads}",
        "ms_grid64": k12f_t["Grid64x64"][0],
        "device_ms_grid64": k12f_t["Grid64x64"][2],
        "plain_ms_grid64": k12f_t["Grid64x64"][1],
        "bound_ms_grid64": k12f_t["Grid64x64"][3],
        "bare_ms": k12_t["Grid16x16"][0],
        "bare_device_ms": k12_t["Grid16x16"][2],
        "bare_plain_ms": k12_t["Grid16x16"][1],
        "bare_bound_ms": k12_t["Grid16x16"][3],
        "bare_ms_grid256": k12_t["Grid256x256"][0],
        "bare_plain_ms_grid256": k12_t["Grid256x256"][1],
        "bare_bound_ms_grid256": k12_t["Grid256x256"][3],
    }, {
        "name": "tile_winner+tile_confirm",
        "route": "cuda",
        "source": "tarl_tpu_torch/csrc/fused_winner.cu",
        "replaces": "tarl_tpu/core/fused_winner.py:418",
        "also_replaces": "tarl_tpu/core/fused_winner.py:494",
        "covered_by": "fused_winner",
        "launches": k8_launches,
        "launches_from": ("K1's comparison calls at R=261,120 (phase 15); "
                          "no main path of the port reaches this size"),
        "max_abs_err": float(err256),
        "ms": min(k8_t[1:3]),
        "plain_ms": min(k8_t[0], k8_t[3]),
        "bound_ms": k8_bound[0],
        "bound_by": k8_bound[1],
        "library_ms": None,
        "shape": f"R={r256} (winner and confirm timed as one call)",
    }, {
        "name": "fused_shard_winner",
        "route": "cuda",
        "source": "tarl_tpu_torch/csrc/fused_winner.cu",
        "replaces": "tarl_tpu/core/fused_winner.py:647",
        "launches": sh["launches"]["K7"],
        "launches_from": "sharded headline (phase 17); every policy on "
                         "blocks and the ranks across processes (phase 29) "
                         "in launches_blocks; spatial training (phase 30) "
                         "in launches_spatial_ppo",
        "launches_padded_mesh": padded_counts["K7"],
        "launches_sp_row": sp_sh_counts["K7"],
        "launches_blocks": blk_launches,
        "launches_spatial_ppo": spatial_launches,
        "max_abs_err": max(err7, ppo_blk["c"]["k7_err"]),
        "ms": k7_t["Grid16x16"][0],
        "device_ms": k7_t["Grid16x16"][2],
        "plain_ms": k7_t["Grid16x16"][1],
        "bound_ms": k7_t["Grid16x16"][3],
        "bound_by": k7_t["Grid16x16"][4],
        "library_ms": None,
        "shape": f"n={net.num_roads} roads in {SHARD_BLOCKS} blocks",
        "ms_grid256": k7_t["Grid256x256"][0],
        "device_ms_grid256": k7_t["Grid256x256"][2],
        "plain_ms_grid256": k7_t["Grid256x256"][1],
        "bound_ms_grid256": k7_t["Grid256x256"][3],
    }, {
        "name": "random_choice",
        "route": "cuda",
        "source": "tarl_tpu_torch/csrc/choice.cu",
        "replaces": "no pallas_call: tarl_tpu/routing/policies.py:44 "
                    "draws the noise in plain jnp, which XLA fuses",
        "launches": head["launches"]["choice"],
        "launches_from": "phase 2's headline, one launch a tick; the "
                         "fused-core and sharded headlines, the million and "
                         "city exact random rows beside it, and the sp rows "
                         "(phases 5, 22, 23 and 26), none",
        "launches_fused_core": fc["launches"]["choice"],
        "launches_sharded": sh["launches"]["choice"],
        "launches_million_exact": mil["exact_launches"]["choice"],
        "launches_city_exact": city["exact"]["launches"]["choice"],
        "launches_sp_rows": [sp["choice_launches"],
                             mil_sp["choice_launches"],
                             rad_sp["choice_launches"],
                             city["sp"]["choice_launches"]],
        "max_abs_err": 0.0,
        "checked_calls": mil["choice"]["checked"] + city["choice"]["checked"],
        "ms": mil["choice"]["ms"],
        "device_ms": mil["choice"]["device_ms"],
        "plain_ms": mil["choice"]["plain_ms"],
        "plain_device_ms": mil["choice"]["plain_device_ms"],
        "bound_ms": mil["choice"]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "shape": f"N={mil['choice']['n']}, KC={mil['choice']['kc']}, a "
                 "captured state of the million exact_random row",
        "activities": mil["choice"]["activities"],
        "plain_activities": mil["choice"]["plain_activities"],
        "ms_city": city["choice"]["ms"],
        "device_ms_city": city["choice"]["device_ms"],
        "plain_ms_city": city["choice"]["plain_ms"],
        "plain_device_ms_city": city["choice"]["plain_device_ms"],
        "bound_ms_city": city["choice"]["bound_ms"],
        "shape_city": f"N={city['choice']['n']}, KC={city['choice']['kc']}, "
                      "renumbered, a captured state of the city exact "
                      "random row",
        "activities_city": city["choice"]["activities"],
        "plain_activities_city": city["choice"]["plain_activities"],
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


def k1_bound_ms(net, road, sel, t_now, key, physics) -> tuple[float, str]:
    """K1's least time on this input and what bounds it: each road's count
    and capacity (8 bytes) and each in-slot's valid flag (1 byte); each
    valid slot's source (4 bytes), and each distinct source's head,
    selection and ring departure once (12 bytes); each eligible slot's
    logit (4 bytes) and, once per road with one, its canonical position
    (4 bytes); each winner's id and dest (8 bytes); the clock; and the
    five outputs written (14 bytes a road), against the card's memory
    rate.  ``K7_OPS_PER_SLOT`` operations for each valid slot's
    eligibility and score and ``K12_OPS_PER_DRAW`` for each eligible
    slot's noise, against its float32 rate."""
    from tarl_tpu_torch.core.direction import eligible_slots
    from tarl_tpu_torch.core.fused_winner import direction_confirm_plain

    r = net.num_roads
    ok = net.in_edge_ok
    valid = int(ok.sum())
    sources = int(net.in_src_tab[ok].unique().numel())
    eligible = eligible_slots(road, sel, net, t_now, physics)
    drawn = int(eligible.sum())
    roads_drawing = int(eligible.any(dim=0).sum())
    wins = int(direction_confirm_plain(road, sel, net, t_now, key,
                                       physics)[0].sum())
    moved = (8 * r + ok.numel() + 4 * valid + 12 * sources + 4 * drawn
             + 4 * roads_drawing + 8 * wins + 4 + 14 * r)
    by_bytes = moved / HBM_BYTES_PER_S
    by_ops = (K7_OPS_PER_SLOT * valid + K12_OPS_PER_DRAW * drawn) \
        / F32_OPS_PER_S
    return (max(by_bytes, by_ops) * 1e3,
            "bytes" if by_bytes >= by_ops else "operations")


def relax_bound_ms(net, sweeps: int, dests: int,
                   relax_only: bool) -> tuple[float, str]:
    """The relax's least time on I x ``dests`` distances and what bounds
    it: costs, tables, the road-to map and the warm start read once,
    distances (and next roads, in K2 mode) written once; the operations
    are an add and a min per slot, sweep and column, plus the next-road
    pass in K2 mode."""
    r, (i_n, k_n) = net.num_roads, net.inter_out_road.shape
    tables = 4 * r + 5 * i_n * k_n + 4 * r
    moved = tables + (2 if relax_only else 3) * 4 * i_n * dests
    ops = 2 * (sweeps + (0 if relax_only else 1)) * i_n * k_n * dests
    by_bytes, by_ops = moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (max(by_bytes, by_ops) * 1e3,
            "bytes" if by_bytes >= by_ops else "operations")


def _env_bits(env) -> dict:
    """An environment state as nested numpy dicts (the clock as float32)."""
    from tarl_tpu_torch.convert import to_numpy

    d = {"sim": to_numpy(env.sim), "old_counts": to_numpy(env.old_counts),
         "done": to_numpy(env.done), "phi": to_numpy(env.phi)}
    d["sim"]["next_hop"] = d["sim"]["next_hop"].view("uint32")
    return d


def _state_bits(state) -> dict:
    """``to_numpy`` of a state with the routing scratch as raw bits."""
    from tarl_tpu_torch.convert import to_numpy

    d = to_numpy(state)
    d["next_hop"] = d["next_hop"].view("uint32")
    return d


def _diff_paths(a, b, path="state") -> list[str]:
    """Paths of the nested numpy dicts at which ``a`` and ``b`` differ in
    dtype, shape or any element."""
    import numpy as np

    if isinstance(a, dict):
        out = []
        for k in a:
            out += _diff_paths(a[k], b[k], f"{path}.{k}")
        return out
    if a is None or b is None:
        return [] if a is None and b is None else [path]
    a, b = np.asarray(a), np.asarray(b)
    same = a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    return [] if same else [path]


if __name__ == "__main__":
    sys.exit(main())
