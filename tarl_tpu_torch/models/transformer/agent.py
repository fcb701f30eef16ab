"""Transformer route-choice policy and value net (ports
``tarl_tpu/models/transformer/agent.py``).

:class:`TransformerRoutePolicy` gives per-edge logits from a
:class:`GraphTransformerNet` over the full dual graph, with the signature
of ``models.mpnn.MPNNPolicyNet`` so that it drops into ``rl.ppo.PPO``;
:class:`TransformerValueNet` the pooled value plus a time head.  The
Laplacian positional encoding is computed once per network on the host
(:func:`network_positional_encoding`, over the roads, zero rows for the
virtual SRC/DEST nodes) and held as a buffer, outside the state dict.
Unlike Flax, the context width is given up front: 16, or 19 with
``RLConfig.extra_obs``.

:func:`make_transformer_choice` adapts the policy to the classical loop:
one sampled out-edge per node through ``GraphDistribution.sample`` (K11's
action entry on the card) and the ``selected_road`` write.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from ...network import Network
from .embedding import laplacian_positional_encoding
from .model import GraphTransformerNet


def network_positional_encoding(network: Network,
                                dim: int = 16) -> np.ndarray:
    """float32 ``[N, dim]`` Laplacian encoding over the road-only turn
    graph, zero rows for the virtual nodes (not reproducible call to call:
    see ``embedding``)."""
    return laplacian_positional_encoding(
        network.edge_src.cpu().numpy(), network.edge_dst.cpu().numpy(),
        network.num_roads, dim, total_num_nodes=network.num_nodes)


class _TransformerTrunk(nn.Module):
    """The encoding buffer and the ``transformer`` trunk shared by the
    policy and the value net."""

    # The trunk's class; the slot-major twin substitutes its own.
    net_class = GraphTransformerNet

    def __init__(self, pe, hidden_dim: int, num_layers: int, num_heads: int,
                 gate: bool, dropout: float, context_dim: int,
                 edge_dim: int):
        super().__init__()
        pe = torch.as_tensor(np.asarray(pe, dtype=np.float32))
        self.register_buffer("pe", pe, persistent=False)
        self.hidden_dim, self.num_layers = hidden_dim, num_layers
        self.num_heads, self.gate, self.dropout = num_heads, gate, dropout
        self.context_dim, self.edge_dim = context_dim, edge_dim
        self.transformer = self.net_class(
            node_dim_in=context_dim, edge_dim_in=edge_dim,
            pe_in_dim=pe.shape[-1], hidden_dim=hidden_dim, gate=gate,
            num_gt_layers=num_layers, num_heads=num_heads, dropout=dropout)

    def trunk(self, x, edge_features, edge_src, edge_dst):
        xs = x / (1.0 + torch.abs(x))
        return self.transformer(xs, edge_src, edge_dst, edge_features,
                                self.pe, raw=True)


class TransformerRoutePolicy(_TransformerTrunk):
    """Per-edge logits ``[..., E]`` from the trunk's edge head."""

    # Attention sums over the whole edge list, so a padded edge table's
    # rows are not independent: the slot-major paths
    # (rl.learned_policy.make_learned_choice) run the masked twin of
    # slot_forward.py instead, with the same parameters.
    edge_row_independent = False

    def __init__(self, pe, hidden_dim: int = 16, num_layers: int = 2,
                 num_heads: int = 4, gate: bool = True,
                 dropout: float = 0.0, context_dim: int = 16,
                 edge_dim: int = 1):
        super().__init__(pe, hidden_dim, num_layers, num_heads, gate,
                         dropout, context_dim, edge_dim)

    def forward(self, x: torch.Tensor, edge_features: torch.Tensor,
                edge_src: torch.Tensor, edge_dst: torch.Tensor,
                dist: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.trunk(x, edge_features, edge_src, edge_dst)[1]


class TransformerValueNet(_TransformerTrunk):
    """The pooled ``mu`` plus ``time_head(time / 3600)``: ``[...]``."""

    def __init__(self, pe, hidden_dim: int = 16, num_layers: int = 2,
                 num_heads: int = 4, gate: bool = True,
                 context_dim: int = 16, edge_dim: int = 1):
        super().__init__(pe, hidden_dim, num_layers, num_heads, gate, 0.0,
                         context_dim, edge_dim)
        self.time_head = nn.Linear(1, 1)

    def forward(self, x: torch.Tensor, edge_features: torch.Tensor,
                edge_src: torch.Tensor, edge_dst: torch.Tensor,
                time: torch.Tensor, layout=None) -> torch.Tensor:
        mu, _ = self.trunk(x, edge_features, edge_src, edge_dst)
        return (mu + self.time_head(time / 3600.0))[..., 0]


def make_transformer_choice(policy_net: TransformerRoutePolicy,
                            params: dict, network: Network):
    """``choice(state, network) -> (state, None)``: one out-edge sampled per
    node from the policy's logits (``params`` its state dict), written to
    ``selected_road``, the key split first as the reference splits it."""
    from ...core.rng import split
    from ...ops.scatter import scatter_set
    from ...ops.segment import segment_layout
    from ...rl.distribution import GraphDistribution
    from ...rl.observation import observe
    from ...schema import agent_features_matrix

    policy_net = policy_net.to(network.device)
    layout = segment_layout(network.full_src, network.num_nodes)

    @torch.no_grad()
    def choice(state, net: Network):
        key, sub = split(state.key)
        nf, ef, _, ai = observe(state, net)
        x = torch.cat([nf, agent_features_matrix(state.agents)[ai.long()]],
                      dim=-1)
        logits = functional_call(policy_net, params,
                                 (x, ef, net.full_src, net.full_dst))
        action = GraphDistribution(logits, net.full_src, net.num_nodes,
                                   layout=layout).sample(sub)
        sel = scatter_set(state.selected_road, net.full_src, net.full_dst,
                          action)
        return state._replace(selected_road=sel, key=key), None

    return choice
