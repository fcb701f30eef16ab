"""Graph Transformer convolution (ports
``tarl_tpu/models/transformer/gt_conv.py``): multi-head QKV attention over
the edge list, scores softmax-normalised per target node (a segment
softmax, no dense ``[N, N]`` matrix), edge features modulating the scores,
optional sigmoid gates on the values, and the edge features' own update.

Layer names are the reference's Flax module names (``WQ``, ``WK``, ``WV``,
``WE``, ``e_gate``, ``n_gate``, ``WO``, ``norm1``, ``ffn``, ``norm2``,
``WOe``, ``norm1e``, ``ffn_e``, ``norm2e``), so one converted parameter
tree serves both packages.  ``x[..., N, C]`` takes leading batch axes,
which PPO's loss uses where the reference vmaps: gathers run on the node
axis ``-2`` and the segment reductions over the edge axis moved to the
front, the batch trailing.  The reductions are ``[E, ..., H]`` and
``[E, ..., H * dk]`` data, which the segment ops take plain on every
device, as the reference leaves them to XLA.

Every norm is ``nn.LayerNorm(eps=1e-6)``, Flax's epsilon; ``norm="bn"``
maps to it, as in the reference.  Flax computes the variance as ``E[x^2] -
E[x]^2`` (``use_fast_variance``), torch in two passes; over 16 float32
features of order one the two differ by a few ulps of the larger moment,
so the forwards agree to about 1e-6 and are compared at atol/rtol 2e-5.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from ...ops.segment import segment_max, segment_softmax, segment_sum
from .mlp import MLP

# Flax's LayerNorm epsilon.
LN_EPS = 1e-6


def layer_norm(dim: int, kind: str = "ln") -> nn.LayerNorm:
    """The reference's stat-free norm: LayerNorm for ``"ln"`` and
    ``"bn"`` alike."""
    if kind not in ("ln", "bn"):
        raise ValueError(f"Unknown norm {kind!r}")
    return nn.LayerNorm(dim, eps=LN_EPS)


def segment_reduce_edges(data: torch.Tensor, edge_dst: torch.Tensor,
                         n: int, reduce) -> torch.Tensor:
    """The segment op ``reduce`` over the edge axis of ``data[..., E, C]``
    by target node, the batch axes trailing inside the op: ``[..., N, C]``
    for a reduction, ``[..., E, C]`` for the softmax."""
    return reduce(data.movedim(-2, 0), edge_dst, n).movedim(0, -2)


class GTConv(nn.Module):
    """One graph-transformer layer; returns the updated ``(nodes,
    edges)``, ``edges`` None without edge features."""

    def __init__(self, node_dim: int, hidden_dim: int,
                 edge_dim: Optional[int] = None, num_heads: int = 8,
                 gate: bool = False, qkv_bias: bool = False,
                 dropout: float = 0.0, norm: str = "ln", act: str = "relu",
                 aggregators: Sequence[str] = ("sum",)):
        super().__init__()
        if "sum" not in aggregators:
            raise ValueError("aggregators must include 'sum'")
        for agg in aggregators:
            if agg not in ("sum", "mean", "max"):
                raise ValueError(f"Unknown aggregator {agg!r}")
        if gate and edge_dim is None:
            raise ValueError("the gates need edge features (edge_dim)")
        self.node_dim, self.hidden_dim = node_dim, hidden_dim
        self.edge_dim, self.num_heads = edge_dim, num_heads
        self.gate, self.dropout = gate, dropout
        self.aggregators = tuple(aggregators)
        self.WQ = nn.Linear(node_dim, hidden_dim, bias=qkv_bias)
        self.WK = nn.Linear(node_dim, hidden_dim, bias=qkv_bias)
        self.WV = nn.Linear(node_dim, hidden_dim, bias=qkv_bias)
        if edge_dim is not None:
            self.WE = nn.Linear(edge_dim, hidden_dim)
        if gate:
            self.e_gate = nn.Linear(edge_dim, hidden_dim)
            self.n_gate = nn.Linear(node_dim, hidden_dim)
        self.WO = nn.Linear(len(self.aggregators) * hidden_dim, node_dim)
        self.norm1 = layer_norm(node_dim, norm)
        self.ffn = MLP(node_dim, node_dim, hidden_dim, 1, dropout, act)
        self.norm2 = layer_norm(node_dim, norm)
        if edge_dim is not None:
            self.WOe = nn.Linear(hidden_dim, edge_dim)
            self.norm1e = layer_norm(edge_dim, norm)
            self.ffn_e = MLP(edge_dim, edge_dim, hidden_dim, 1, dropout, act)
            self.norm2e = layer_norm(edge_dim, norm)

    @property
    def head_dim(self) -> int:
        return self.hidden_dim // self.num_heads

    def heads(self, t: torch.Tensor) -> torch.Tensor:
        """``[..., hidden]`` as ``[..., H, dk]``."""
        return t.unflatten(-1, (self.num_heads, self.head_dim))

    def edge_scores(self, e: torch.Tensor, q_dst: torch.Tensor,
                    k_src: torch.Tensor):
        """Per-edge attention scores ``[..., H]`` and the modulated
        ``e_ij [..., H, dk]`` from edge features ``e`` and the gathered
        queries and keys."""
        scale = math.sqrt(float(self.head_dim))
        qk = q_dst * k_src
        e_ij = self.heads(self.WE(e)) * qk / scale
        scores = qk.sum(-1) / scale
        if self.gate:
            scores = scores * torch.sigmoid(self.heads(self.e_gate(e))) \
                .mean(-1)
        return scores, e_ij

    def _drop(self, t: torch.Tensor, deterministic: bool) -> torch.Tensor:
        if self.dropout > 0.0 and not deterministic:
            return F.dropout(t, self.dropout, training=True)
        return t

    def node_out(self, agg: torch.Tensor, h: torch.Tensor,
                 deterministic: bool = True) -> torch.Tensor:
        """Projection, residual, norm, FFN, residual, norm."""
        out = self.norm1(self.WO(self._drop(agg, deterministic)) + h)
        return self.norm2(out + self.ffn(out, deterministic=deterministic))

    def edge_out(self, e_ij: torch.Tensor, e: torch.Tensor,
                 deterministic: bool = True) -> torch.Tensor:
        """The edge features' update from ``e_ij``: the same steps through
        ``WOe``, ``norm1e``, ``ffn_e`` and ``norm2e``."""
        oe = self._drop(e_ij.flatten(-2), deterministic)
        oe = self.norm1e(self.WOe(oe) + e)
        return self.norm2e(oe + self.ffn_e(oe, deterministic=deterministic))

    def forward(self, x: torch.Tensor, edge_src: torch.Tensor,
                edge_dst: torch.Tensor,
                edge_attr: Optional[torch.Tensor] = None, *,
                deterministic: bool = True):
        n = x.shape[-2]
        src, dst = edge_src.long(), edge_dst.long()
        q = self.heads(self.WQ(x))
        k = self.heads(self.WK(x))
        v = self.heads(self.WV(x))
        q_dst, k_src = q[..., dst, :, :], k[..., src, :, :]
        if self.edge_dim is not None:
            if edge_attr is None:
                raise ValueError("this layer takes edge features")
            edge_attr = edge_attr.expand(x.shape[:-2] + edge_attr.shape[-2:])
            scores, e_ij = self.edge_scores(edge_attr, q_dst, k_src)
        else:
            scale = math.sqrt(float(self.head_dim))
            scores, e_ij = (q_dst * k_src).sum(-1) / scale, None

        alpha = segment_reduce_edges(scores, edge_dst, n, segment_softmax)
        vals = v[..., src, :, :]
        if self.gate:
            vals = vals * torch.sigmoid(self.heads(self.n_gate(x))
                                        [..., src, :, :])
        flat = (alpha[..., None] * vals).flatten(-2)

        aggs = []
        for agg in self.aggregators:
            if agg == "max":
                aggs.append(segment_reduce_edges(flat, edge_dst, n,
                                                 segment_max))
                continue
            total = segment_reduce_edges(flat, edge_dst, n, segment_sum)
            if agg == "mean":
                ones = torch.ones((flat.shape[-2], 1), dtype=flat.dtype,
                                  device=flat.device)
                deg = segment_sum(ones, edge_dst, n)
                total = total / torch.clamp(deg, min=1.0)
            aggs.append(total)
        out = self.node_out(torch.cat(aggs, dim=-1), x, deterministic)

        out_e = None
        if e_ij is not None:
            out_e = self.edge_out(e_ij, edge_attr, deterministic)
        return out, out_e
