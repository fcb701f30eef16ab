"""Node-sharded PPO updates (ports ``tarl_tpu/parallel/sharded_ppo.py``:
``make_node_mesh``, ``_out_tables_with_ids``, ``node_sharded_loss_fn`` and
``ShardedPPO``).

The policy loss factorises over source-node groups: ``log_prob(action) =
sum_g (logit_chosen_g - logsumexp_g)`` and ``entropy = sum_g H_g``.  So
each block of node columns of the slot-major out-edge table (``[KF, Np]``,
``Np`` the nodes padded to a multiple of the S blocks; groups are columns
and never split) scores only its columns, sums its log-prob and entropy
partials, and one float ``psum`` of each gives the global values.  The
clipped-ratio arithmetic then runs on every block.  The gradient of the
global values is routed through the block's own partial (``lp_loc +
(psum(lp_loc) - lp_loc).detach()``), the replicated critic term is scaled
by ``1/S``, and the gradients are summed over the blocks: in one process
one backward of the sum of the held blocks' losses, across ranks one float
all-reduce of the gradients after it (:meth:`RoadMesh.psum_tensors`).
The sum equals the unsharded loss's gradient up to the order of the float
additions.

The virtual SRC/DEST nodes are columns like any other and lie in exactly
one block, so no log-prob is counted twice.  An edge-row-independent net
(the MPNN, with its distance prior) scores a block's flattened padded
columns on its own.  An attention net (``edge_row_independent = False``,
the transformer) runs through its slot-major twin
(``models.transformer.slot_forward``) on the held columns, its node
encoding and slot tables padded to ``Np``, each layer's node rows joined
across blocks by the mesh's ``all_gather``, which carries the gradients
back to the block that made each row.

The rollout is the port's own :meth:`~tarl_tpu_torch.rl.ppo.PPO.
collect_rollout` (on the card K1, K11's action entry and K10's log-prob
entry once a step); the loss runs plain, inside ``plain_segments()``, as
``PPO._loss`` does, and launches no kernel.  A mesh is a
:class:`~tarl_tpu_torch.parallel.shard_map_episode.RoadMesh` whose blocks
are node-column blocks: every block in one process, or the blocks split
over the ranks of a ``torch.distributed`` group, each rank then running
the same rollout and update on its own copy of the state.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch.func import functional_call

from ..core.fused_winner import direction_confirm
from ..network import Network
from ..ops.segment import KERNELS, SegmentOps, plain_segments
from ..rl.gae import gae, normalize
from ..rl.learned_policy import out_tables_with_ids
from ..rl.ppo import (
    PPO,
    TrainState,
    _require_full_f32,
    iteration_metrics,
    tree_map,
)
from .shard_map_episode import RoadMesh, make_road_mesh


# A mesh of node-column blocks: the road mesh's two forms, all blocks in this
# process or split over the ranks of a group.
make_node_mesh = make_road_mesh


class NodeTables(NamedTuple):
    """The slot-major out-edge tables with each slot's edge id, ``[KF,
    Np]`` with the columns padded to a multiple of the blocks (padded
    slots: not ok, target 0, feature 0, edge id ``E``)."""

    ok: torch.Tensor
    dst: torch.Tensor
    attr: torch.Tensor
    eid: torch.Tensor


def node_tables(network: Network, num_blocks: int) -> NodeTables:
    """:class:`NodeTables` of ``network`` for ``num_blocks`` blocks."""
    ok, dst, attr, eid = out_tables_with_ids(network)
    kf, n = ok.shape
    npad = -(-n // num_blocks) * num_blocks - n

    def pad(a, v):
        return torch.cat([a, torch.full((kf, npad), v, dtype=a.dtype,
                                        device=a.device)], dim=1)

    e = network.full_src.shape[0]
    return NodeTables(pad(ok, False), pad(dst, 0), pad(attr, 0.0),
                      pad(eid, e))


def held_columns(mesh: RoadMesh, tables: NodeTables) -> tuple[int, int]:
    """``(lo, n)``: the held blocks' node columns ``[lo, lo + n)``."""
    nb = tables.ok.shape[1] // mesh.num_blocks
    return mesh.first * nb, mesh.held * nb


def block_log_prob_entropy(logits: torch.Tensor, ok: torch.Tensor,
                           action: torch.Tensor, held: int):
    """Per block, the log-prob of ``action`` and the entropy summed over its
    columns: ``logits [B, KF, n]`` of ``held`` blocks' columns, ``ok [KF,
    n]``, bool ``action [B, KF, n]``; two float32 ``[held, B]``.  A column
    with no edge counts 0."""
    neg_inf = float("-inf")
    b, kf, n = logits.shape
    masked = torch.where(ok, logits, neg_inf)
    has_edge = ok.any(dim=0)
    m = torch.where(has_edge, masked.amax(dim=-2), 0.0).detach()
    lse = m + torch.log(torch.exp(masked - m[:, None, :]).sum(dim=-2)
                        + torch.where(has_edge, 0.0, 1.0))
    lp_edge = torch.where(ok, masked - lse[:, None, :], 0.0)
    per_block = (b, kf, held, n // held)
    lp = torch.where(action & ok, lp_edge, 0.0).view(per_block).sum((1, 3))
    p = torch.where(ok, torch.exp(lp_edge), 0.0)
    ent = torch.where(p > 0, -p * lp_edge, 0.0).view(per_block).sum((1, 3))
    return lp.t(), ent.t()


def mpnn_block_logits(ppo: PPO, tables: NodeTables, lo: int,
                      n: int) -> Callable:
    """``logits_fn(policy_params, x [B, N, C]) -> [B, KF, n]``: an
    edge-row-independent net (with ``ppo``'s distance prior) on the
    flattened padded columns ``[lo, lo + n)`` (padded columns clamped to
    the last node; their slots are masked)."""
    kf = tables.ok.shape[0]
    dev = tables.ok.device
    cols = torch.clamp(torch.arange(lo, lo + n, dtype=torch.int32,
                                    device=dev), max=ppo.network.num_nodes - 1)
    args = (tables.attr[:, lo:lo + n].reshape(-1, 1),
            cols[None, :].expand(kf, n).reshape(-1),
            tables.dst[:, lo:lo + n].reshape(-1))
    if ppo._policy_dist is not None:
        args += (ppo._policy_dist,)

    def logits_fn(policy_params, x):
        flat = functional_call(ppo.policy_net, policy_params, (x,) + args)
        return flat.reshape(x.shape[:-2] + (kf, n))

    return logits_fn


def node_sharded_loss_fn(ppo: PPO, mesh: RoadMesh, tables: NodeTables,
                         act_tab, x, time, old_lp, adv, ret,
                         logits_fn: Callable | None = None) -> Callable:
    """``loss_fn(params) -> (total_local, aux)``: the clipped PPO loss on
    the minibatch (``x [B, N, C]``, ``time [B, 1]``, ``old_lp``, ``adv``,
    ``ret [B]``) with the policy scored on the held node columns only
    (``act_tab [B, KF, n]``, bool, the action on those columns).
    ``total_local`` is the held blocks' losses summed, each with the
    gradient routing of the module docstring; its gradient summed over the
    ranks is ``PPO._loss``'s gradient to float tolerance.  ``aux =
    (total, loss_obj, loss_critic, loss_entropy, approx_kl,
    clip_fraction)``, the global values.  ``logits_fn(policy_params, x) ->
    [B, KF, n]`` replaces the edge-row-independent forward (the attention
    net's twin).  Differentiable code: run it inside ``plain_segments()``."""
    lo, n = held_columns(mesh, tables)
    ok = tables.ok[:, lo:lo + n]
    if logits_fn is None:
        logits_fn = mpnn_block_logits(ppo, tables, lo, n)
    rl = ppo.rl
    s_blocks = mesh.num_blocks

    def loss_fn(params):
        logits = logits_fn(params["policy"], x)
        lp_loc, ent_loc = block_log_prob_entropy(logits, ok, act_tab,
                                                 mesh.held)
        # The global sums' values, with each block's gradient flowing only
        # through its own partial.
        lp_glob = mesh.psum(lp_loc.detach())
        ent_glob = mesh.psum(ent_loc.detach())
        new_lp = lp_loc + (lp_glob - lp_loc).detach()
        entropy = ent_loc + (ent_glob - ent_loc).detach()
        log_ratio = new_lp - old_lp
        ratio = torch.exp(log_ratio)
        eps = rl.clip_epsilon
        obj = torch.minimum(ratio * adv,
                            torch.clamp(ratio, 1.0 - eps, 1.0 + eps) * adv)
        loss_obj = -obj.mean(dim=-1)
        values = ppo._value(params["value"], x, time)
        loss_critic = torch.mean((values - ret) ** 2)
        loss_entropy = -entropy.mean(dim=-1)
        # The critic is replicated: 1/S on every block sums to one.
        total_local = (loss_obj + rl.value_coef * loss_critic / s_blocks
                       + rl.entropy_coef * loss_entropy)
        total = (loss_obj[0] + rl.value_coef * loss_critic
                 + rl.entropy_coef * loss_entropy[0])
        approx_kl = torch.mean((ratio[0] - 1.0) - log_ratio[0])
        clip_frac = torch.mean((torch.abs(ratio[0] - 1.0) > eps)
                               .to(torch.float32))
        return total_local.sum(), (total, loss_obj[0], loss_critic,
                                   loss_entropy[0], approx_kl, clip_frac)

    return loss_fn


class ShardedPPO:
    """Node-sharded gradient steps for an existing :class:`PPO`:
    :meth:`train_iteration` is ``PPO.train_iteration`` (the same rollout,
    GAE, permuted minibatches and Adam) with every minibatch's gradients
    from :meth:`_grads`, so the parameters track the unsharded iteration's
    to float tolerance.  ``mesh`` is :func:`make_node_mesh`'s, on the
    network's device."""

    def __init__(self, ppo: PPO, mesh: RoadMesh):
        net = ppo.network
        if mesh.device.type != net.device.type or (
                mesh.device.index is not None
                and net.device.index != mesh.device.index):
            raise ValueError(f"the mesh lies on {mesh.device}, the network "
                             f"on {net.device}")
        self.ppo = ppo
        self.mesh = mesh
        self.S = mesh.num_blocks
        self.tables = node_tables(net, self.S)
        self._kf, self._np = self.tables.ok.shape
        self._lo, self._n = held_columns(mesh, self.tables)
        self._attention = not getattr(ppo.policy_net,
                                      "edge_row_independent", True)
        self._logits_fn = (self._attention_logits_fn() if self._attention
                           else mpnn_block_logits(ppo, self.tables,
                                                  self._lo, self._n))

    def _attention_logits_fn(self) -> Callable:
        """The transformer's twin on the held columns, its encoding and
        slot tables padded to ``Np``, each layer's node rows gathered over
        the blocks."""
        from ..models.transformer.slot_forward import (
            SlotEdgeTables,
            slot_edge_tables,
            slot_twin,
        )

        net, mesh, npad = self.ppo.network, self.mesh, self._np
        extra = npad - net.num_nodes

        def pad(a, v):
            shape = a.shape[:1] + (extra,) + a.shape[2:]
            return torch.cat([a, torch.full(shape, v, dtype=a.dtype,
                                            device=a.device)], dim=1)

        tabs = slot_edge_tables(net)
        tabs = SlotEdgeTables(pad(tabs.in_ok, False), pad(tabs.in_src, 0),
                              pad(tabs.in_attr, 0.0), pad(tabs.out_ok, False),
                              pad(tabs.out_dst, 0), pad(tabs.out_attr, 0.0))
        twin = slot_twin(self.ppo.policy_net, npad)
        cols = torch.arange(self._lo, self._lo + self._n, dtype=torch.int32,
                            device=net.device)
        nb = npad // self.S

        def sync(h_cols):
            rows = h_cols.movedim(-2, 0)
            full = mesh.all_gather(rows.reshape((mesh.held, nb)
                                                + rows.shape[1:]))
            return full.movedim(0, -2)

        def logits_fn(policy_params, x):
            x_p = torch.cat([x, x.new_zeros(x.shape[:-2] + (
                extra, x.shape[-1]))], dim=-2)
            return functional_call(twin, policy_params, (x_p, tabs, cols),
                                   {"sync": sync})

        return logits_fn

    # -- slot-major action view -----------------------------------------
    def _action_table(self, action: torch.Tensor) -> torch.Tensor:
        """bool ``[..., E]`` multi-hot -> bool ``[..., KF, n]`` on the held
        columns."""
        pad = torch.zeros(action.shape[:-1] + (1,), dtype=torch.bool,
                          device=action.device)
        eid = self.tables.eid[:, self._lo:self._lo + self._n]
        return torch.cat([action, pad], dim=-1)[..., eid.long()]

    # -- the sharded loss -----------------------------------------------
    def _grads(self, params, batch, advantages, returns):
        """``((total, aux), grads)`` as ``PPO._loss_and_grads``: the
        gradients of the held blocks' losses, summed over the ranks."""
        leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss_fn = node_sharded_loss_fn(
            self.ppo, self.mesh, self.tables,
            self._action_table(batch.action), batch.x, batch.time,
            batch.log_prob, advantages, returns, logits_fn=self._logits_fn)
        with torch.enable_grad(), plain_segments():
            total_local, aux = loss_fn(leaves)
            flat = [t for sub in leaves.values() for t in sub.values()]
            grads = torch.autograd.grad(total_local, flat,
                                        materialize_grads=True)
        grads = iter(self.mesh.psum_tensors(list(grads)))
        return ((aux[0].detach(), tuple(a.detach() for a in aux[1:])),
                tree_map(lambda _: next(grads), leaves))

    # -- the iteration ---------------------------------------------------
    def train_iteration(self, ts: TrainState,
                        segment_ops: SegmentOps = KERNELS,
                        core: Callable = direction_confirm):
        """One PPO iteration with node-sharded minibatch gradients:
        ``PPO.collect_rollout`` (``segment_ops`` and ``core`` there), GAE,
        the normalised advantages, then ``PPO._update_epochs`` over
        :meth:`_grads`.  Returns ``(TrainState, IterationMetrics)``."""
        _require_full_f32()
        ppo = self.ppo
        env, obs, key, traj, last_value = ppo.collect_rollout(
            ts.params, ts.env, ts.obs, ts.key, segment_ops, core)
        advantages, returns = gae(traj.reward, traj.value, last_value,
                                  traj.done, ppo.rl.gamma, ppo.rl.gae_lambda)
        (params, opt_state, key), stats = ppo._update_epochs(
            ts.params, ts.opt_state, traj, normalize(advantages), returns,
            key, grads_fn=self._grads)
        ts = TrainState(params=params, opt_state=opt_state, env=env,
                        obs=obs, key=key, iteration=ts.iteration + 1)
        return ts, iteration_metrics(stats, traj, returns)
