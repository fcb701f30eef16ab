"""Graph Transformer network (ports ``tarl_tpu/models/transformer/model.py``).

Node, positional and edge embeddings (``node_emb``, ``pe_emb``,
``edge_emb``, no bias), ``num_gt_layers`` :class:`GTConv` layers
``gt_{i}``, the node states pooled (``sum|mean|max`` concatenated) into the
``mu_mlp`` and ``log_var_mlp`` heads (both always built, as Flax's init
traces both), and the per-edge score head ``edge_linear``.  ``raw=True``
returns ``(mu, edge_scores)``; otherwise ``(mu, std)``, or a draw ``mu +
std * eps`` and ``std`` where ``deterministic=False`` and a
``torch.Generator`` is given (the reference's ``rng``; another stream).
Inputs take leading batch axes as :class:`GTConv` does.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from .gt_conv import GTConv
from .mlp import MLP


class GraphTransformerNet(nn.Module):
    # The layer class; the slot-major twin substitutes its own.
    conv_class = GTConv

    def __init__(self, node_dim_in: int, edge_dim_in: Optional[int] = None,
                 pe_in_dim: Optional[int] = None, hidden_dim: int = 128,
                 norm: str = "ln", gate: bool = False,
                 qkv_bias: bool = False, num_gt_layers: int = 4,
                 num_heads: int = 8,
                 gt_aggregators: Sequence[str] = ("sum",),
                 aggregators: Sequence[str] = ("sum",), act: str = "relu",
                 dropout: float = 0.0):
        super().__init__()
        for agg in aggregators:
            if agg not in ("sum", "mean", "max"):
                raise ValueError(f"Unknown aggregator {agg!r}")
        self.aggregators = tuple(aggregators)
        self.num_gt_layers = num_gt_layers
        self.node_emb = nn.Linear(node_dim_in, hidden_dim, bias=False)
        if pe_in_dim:
            self.pe_emb = nn.Linear(pe_in_dim, hidden_dim, bias=False)
        if edge_dim_in:
            self.edge_emb = nn.Linear(edge_dim_in, hidden_dim, bias=False)
        for i in range(num_gt_layers):
            setattr(self, f"gt_{i}", self.conv_class(
                node_dim=hidden_dim, hidden_dim=hidden_dim,
                edge_dim=hidden_dim if edge_dim_in else None,
                num_heads=num_heads, gate=gate, qkv_bias=qkv_bias,
                dropout=dropout, norm=norm, act=act,
                aggregators=gt_aggregators))
        pooled = len(self.aggregators) * hidden_dim
        self.mu_mlp = MLP(pooled, 1, hidden_dim, 1, 0.0, act)
        self.log_var_mlp = MLP(pooled, 1, hidden_dim, 1, 0.0, act)
        if edge_dim_in:
            self.edge_linear = nn.Linear(hidden_dim, 1)

    def layers(self):
        return [getattr(self, f"gt_{i}") for i in range(self.num_gt_layers)]

    def embed_nodes(self, x: torch.Tensor,
                    pe: Optional[torch.Tensor]) -> torch.Tensor:
        h = self.node_emb(x)
        if pe is not None and hasattr(self, "pe_emb"):
            h = h + self.pe_emb(pe)
        return h

    def forward(self, x: torch.Tensor, edge_src: torch.Tensor,
                edge_dst: torch.Tensor,
                edge_attr: Optional[torch.Tensor] = None,
                pe: Optional[torch.Tensor] = None, *, raw: bool = True,
                zero_var: bool = False, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        h = self.embed_nodes(x, pe)
        e = None
        if edge_attr is not None and hasattr(self, "edge_emb"):
            e = self.edge_emb(edge_attr)
        for layer in self.layers():
            h, e = layer(h, edge_src, edge_dst, e,
                         deterministic=deterministic)

        pooled = []
        for agg in self.aggregators:
            if agg == "sum":
                pooled.append(h.sum(dim=-2))
            elif agg == "mean":
                pooled.append(h.mean(dim=-2))
            else:
                pooled.append(h.amax(dim=-2))
        g = torch.cat(pooled, dim=-1)
        mu = self.mu_mlp(g)
        log_var = self.log_var_mlp(g)
        edge_scores = None
        if e is not None:
            edge_scores = self.edge_linear(e)[..., 0]
        if raw:
            return mu, edge_scores

        std = (torch.zeros_like(log_var) if zero_var
               else torch.exp(0.5 * log_var))
        if not deterministic and generator is not None:
            eps = torch.randn(std.shape, generator=generator,
                              device=generator.device).to(std.device)
            return mu + std * eps, std
        return mu, std
