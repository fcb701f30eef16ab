"""A trained neural route choice as a classical-episode ``Policy`` (ports
``tarl_tpu/rl/learned_policy.py``).

:func:`make_learned_choice` wraps a trained policy net and its parameters
(a state dict) into a :class:`~tarl_tpu_torch.core.step.Policy` for
``core.step.run_episode``.  Per tick: the node context ``x[N, 16]``
(:func:`rollout_context`, the formulas of ``PPO._context`` computed from a
``SimState``), per-edge logits over the slot-major out-edge table
``[KF, N]``, a Gumbel-max draw per node (``rng.gumbel(key, [KF, N])``,
bitwise ``jax.random.gumbel``; none where ``deterministic``) and the
ascending-slot strict ``>`` argmax written to ``selected_road``.  No
segment op runs.

An edge-row-independent net (the MPNN: a per-edge MLP) runs on the padded
table flattened (:func:`slot_logits`); its padded rows are masked after
the fact.  An attention net (``edge_row_independent = False``, the
transformer) would mix padded rows into its softmax sums, so it runs
through its masked slot-major twin (``models.transformer.slot_forward``)
with the same parameters.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.func import functional_call

from ..config import DEFAULT_PHYSICS, PhysicsConfig
from ..core import rng
from ..network import Network
from ..schema import agent_features_matrix
from ..state import SimState
from .observation import agent_index, extra_node_features, node_features

# Agent-row columns kept for the virtual (SRC/DEST) nodes in the context:
# origin and destination only, as PPO._context keeps them.
VIRTUAL_KEEP = (1.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)


class LearnedSpec:
    """What an episode driver needs to redo the forward pass: the net,
    its parameters and the options, and for an attention net its slot twin
    and tables.  Hashed by identity."""

    def __init__(self, policy_net, params, *, deterministic: bool = False,
                 pending_entrants: bool = False,
                 dist: Optional[torch.Tensor] = None,
                 extra_obs: bool = False, slot_net=None, slot_tables=None):
        self.policy_net = policy_net
        self.params = params
        self.deterministic = deterministic
        self.pending_entrants = pending_entrants
        self.dist = dist            # [N, N] distance-prior table, or None
        self.extra_obs = extra_obs  # append observation.extra_node_features
        self.slot_net = slot_net
        self.slot_tables = slot_tables


def rollout_context(state: SimState, network: Network,
                    pending_entrants: bool = False,
                    count: torch.Tensor | None = None,
                    head_ids: torch.Tensor | None = None,
                    extra_obs: bool = False,
                    physics: PhysicsConfig = DEFAULT_PHYSICS) -> torch.Tensor:
    """x[N, 16] node context, value-identical to ``PPO._context``;
    ``count`` and ``head_ids`` override the road state's (a road-sharded
    driver's gathered globals).  With ``extra_obs`` the three congestion
    columns under ``physics`` follow (x[N, 19])."""
    nf = node_features(state, network, count=count)
    ai = agent_index(state, network, pending_entrants, head_ids=head_ids)
    rows = agent_features_matrix(state.agents)[ai.long()]
    is_virtual = nf[:, 6:7] < 0
    keep = torch.tensor(VIRTUAL_KEEP, dtype=torch.float32, device=nf.device)
    rows = torch.where(is_virtual, rows * keep[None, :], rows)
    cols = [nf, rows]
    if extra_obs:
        cols.append(extra_node_features(state, network, physics,
                                        count=count))
    return torch.cat(cols, dim=-1)


def full_out_tables(network: Network):
    """``(ok[KF, N], dst[KF, N], attr[KF, N])``: the full out-edge list
    grouped by source node, slot order = increasing edge id, on the
    network's device."""
    from ..models.transformer.slot_forward import group_slots

    ok, dst, attr = group_slots(network.full_src.cpu().numpy(),
                                network.full_dst.cpu().numpy(),
                                network.full_attr.cpu().numpy(),
                                network.num_nodes)
    dev = network.device
    return (torch.as_tensor(ok, device=dev), torch.as_tensor(dst, device=dev),
            torch.as_tensor(attr, device=dev))


def out_tables_with_ids(network: Network):
    """:func:`full_out_tables` and the edge id of each slot beside them:
    ``(ok, dst, attr, eid)``, each ``[KF, N]``, ``eid`` int32 with ``E`` on
    the padding slots."""
    from ..models.transformer.slot_forward import group_slots

    e = network.full_src.shape[0]
    ok, eid, _ = group_slots(network.full_src.cpu().numpy(),
                             np.arange(e, dtype=np.int32),
                             np.zeros(e, dtype=np.float32),
                             network.num_nodes)
    eid = torch.as_tensor(np.where(ok, eid, e).astype(np.int32),
                          device=network.device)
    return full_out_tables(network) + (eid,)


def slot_logits(spec: LearnedSpec, x: torch.Tensor, network: Network,
                dst_tab: torch.Tensor, attr_tab: torch.Tensor,
                cols: torch.Tensor) -> torch.Tensor:
    """``[KF, M]`` logits of the out-edge table's columns ``cols``: the
    policy net on the flattened padded edge list.  Every row is computed
    alone, so a column subset gives the full table's logits bitwise."""
    kf, m = dst_tab.shape[0], cols.shape[0]
    src_flat = cols[None, :].expand(kf, m).reshape(-1)
    dst_flat = dst_tab[:, cols].reshape(-1)
    attr_flat = attr_tab[:, cols].reshape(-1, 1)
    args = (x, attr_flat, src_flat, dst_flat)
    if spec.dist is not None:
        args += (spec.dist,)
    return functional_call(spec.policy_net, spec.params, args).reshape(kf, m)


def _slot_argmax(score: torch.Tensor, dst_tab: torch.Tensor,
                 prev_sel: torch.Tensor) -> torch.Tensor:
    """Ascending-slot strict ``>`` argmax over ``score[KF, M]``: the
    winning slot's destination, ``prev_sel`` where every slot is masked
    (the tie-break of ``random_choice``)."""
    best = torch.full(score.shape[1:], float("-inf"), dtype=torch.float32,
                      device=score.device)
    sel = prev_sel
    for k in range(score.shape[0]):
        take = score[k] > best
        best = torch.where(take, score[k], best)
        sel = torch.where(take, dst_tab[k], sel)
    return sel.to(torch.int32)


def make_learned_choice(policy_net, params: dict, network: Network, *,
                        deterministic: bool = False,
                        pending_entrants: bool = False,
                        dist: Optional[torch.Tensor] = None,
                        extra_obs: bool = False):
    """A ``Policy`` that routes with the trained ``policy_net`` under the
    state dict ``params`` (see the module docstring): the Gumbel-max
    sample per node, or the argmax where ``deterministic``; the key is
    split first and its first half written back."""
    from ..core.step import Policy

    policy_net = policy_net.to(network.device)
    attention = not getattr(policy_net, "edge_row_independent", True)
    if attention:
        from ..models.transformer.slot_forward import (
            slot_edge_tables,
            slot_twin,
        )

        spec = LearnedSpec(policy_net, params, deterministic=deterministic,
                           pending_entrants=pending_entrants, dist=dist,
                           extra_obs=extra_obs,
                           slot_net=slot_twin(policy_net),
                           slot_tables=slot_edge_tables(network))
        ok = spec.slot_tables.out_ok
        dst_tab = spec.slot_tables.out_dst
        attr_tab = spec.slot_tables.out_attr[..., 0]
    else:
        spec = LearnedSpec(policy_net, params, deterministic=deterministic,
                           pending_entrants=pending_entrants, dist=dist,
                           extra_obs=extra_obs)
        ok, dst_tab, attr_tab = full_out_tables(network)
    all_cols = torch.arange(network.num_nodes, dtype=torch.int32,
                            device=network.device)

    @torch.no_grad()
    def choice(state: SimState, network: Network):
        x = rollout_context(state, network, spec.pending_entrants,
                            extra_obs=spec.extra_obs)
        if attention:
            logits = functional_call(spec.slot_net, spec.params,
                                     (x, spec.slot_tables, all_cols))
        else:
            logits = slot_logits(spec, x, network, dst_tab, attr_tab,
                                 all_cols)
        key, sub = rng.split(state.key)
        if not spec.deterministic:
            logits = logits + rng.gumbel(sub, tuple(logits.shape),
                                         logits.device)
        score = torch.where(ok, logits, float("-inf"))
        sel = _slot_argmax(score, dst_tab, state.selected_road)
        return state._replace(selected_road=sel, key=key), None

    return Policy(choice=choice, learned=spec)
