"""MPNN policy and value networks (ports ``tarl_tpu/models/mpnn.py``).

* :class:`MPNNPolicyNet`: per-edge logits over the full edge list, in the
  reference's two modes (``"edge_mlp"``: an MLP over squashed endpoint
  contexts, the edge attribute and two indicators; ``"embedding"``: a 1-d
  embedding gathered at each edge's target road) and with the optional
  shortest-path distance prior.
* :class:`MPNNValueNet`: message MLP, mean aggregation per source node
  (a segment sum, K9 on the card), node MLP and a time embedding.
* :class:`MPNNValueNetSimple`: occupancy per node concatenated with the
  time, through a 3-layer MLP.

Layer names are the reference's Flax module names, so a Flax ``Dense``
kernel ``[in, out]`` becomes ``<name>.weight`` ``[out, in]``
(``convert.mpnn_params_from_numpy``).  Unlike Flax, a ``Linear`` needs its
input width up front: the policy takes the context width (16, or 19 with
``RLConfig.extra_obs``), the value nets the node count.  ``x[..., N, C]``
is the node context, unbatched as in the reference or with leading batch
axes (``time[..., 1]`` beside it), which PPO's loss takes where the
reference vmaps the nets; the edge tables are shared.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.segment import segment_sum

# Column indices into the node context.
COL_NUMBER_OF_AGENT = 1
COL_ROAD_INDEX = 6
COL_DESTINATION = 8


class MPNNPolicyNet(nn.Module):
    """Edge-logit policy over the dual graph."""

    def __init__(self, num_nodes: int, num_node_embeddings: int,
                 mode: str = "edge_mlp", hidden: int = 64,
                 use_distance_prior: bool = False,
                 prior_scale: float = 600.0, context_dim: int = 16):
        super().__init__()
        if mode not in ("edge_mlp", "embedding"):
            raise ValueError(f"Unknown policy mode {mode!r}")
        self.num_nodes = num_nodes
        self.num_node_embeddings = num_node_embeddings
        self.mode = mode
        self.use_distance_prior = use_distance_prior
        self.prior_scale = prior_scale
        if mode == "embedding":
            self.nodes_embedding = nn.Embedding(num_node_embeddings, 1)
        else:
            self.edge_fc1 = nn.Linear(2 * context_dim + 3, hidden)
            self.edge_fc2 = nn.Linear(hidden, hidden // 2)
            self.edge_out = nn.Linear(hidden // 2, 1)

    def forward(self, x: torch.Tensor, edge_features: torch.Tensor,
                edge_src: torch.Tensor, edge_dst: torch.Tensor,
                dist: Optional[torch.Tensor] = None) -> torch.Tensor:
        src, dst = edge_src.long(), edge_dst.long()
        if self.mode == "embedding":
            road_index = x[..., COL_ROAD_INDEX].to(torch.int64)
            road_index = torch.where(road_index < 0,
                                     self.num_node_embeddings - 1, road_index)
            logits = self.nodes_embedding(road_index)[..., dst, 0]
        else:
            xs = x / (1.0 + torch.abs(x))
            dest = x[..., COL_DESTINATION].to(torch.int32)
            is_virtual = (x[..., COL_ROAD_INDEX] < 0.0).to(torch.float32)
            match = (edge_dst == dest[..., src]).to(torch.float32)
            e_in = torch.cat([xs[..., src, :], xs[..., dst, :],
                              edge_features.expand(x.shape[:-2]
                                                   + edge_features.shape),
                              match[..., None], is_virtual[..., dst, None]],
                             dim=-1)
            h = torch.relu(self.edge_fc1(e_in))
            h = torch.relu(self.edge_fc2(h))
            logits = self.edge_out(h)[..., 0]

        if self.use_distance_prior and dist is not None:
            # Total remaining time through the edge's target: the target
            # road's own free-flow time (context column 2) plus the
            # shortest distance onward.
            dest = x[..., COL_DESTINATION].to(torch.int64)
            d = dist[dst, dest[..., src]]
            d = torch.where(torch.isfinite(d) & (d < 1e17), d, 1e6)
            d = d + x[..., dst, 2]
            logits = logits - d / self.prior_scale
        return logits


class MPNNValueNet(nn.Module):
    """Full MPNN critic: per-edge message MLP, mean aggregation at the
    source node, node MLP, time embedding, and a final linear over all
    node values."""

    def __init__(self, num_nodes: int, hidden: int = 32,
                 context_dim: int = 16):
        super().__init__()
        self.num_nodes = num_nodes
        self.message_fc = nn.Linear(context_dim + 1, 1)
        self.node_fc = nn.Linear(1, 1)
        self.time_fc1 = nn.Linear(1, hidden)
        self.time_fc2 = nn.Linear(hidden, hidden)
        self.time_out = nn.Linear(hidden, 1)
        self.final = nn.Linear(num_nodes + 1, 1)

    def forward(self, x, edge_features, edge_src, edge_dst, time,
                layout=None):
        xs = x / (1.0 + torch.abs(x))
        msg_in = torch.cat([xs[..., edge_dst.long(), :],
                            edge_features.expand(x.shape[:-2]
                                                 + edge_features.shape)],
                           dim=-1)
        msg = torch.tanh(self.message_fc(msg_in))
        ones = torch.ones(edge_src.shape[0], dtype=torch.float32,
                          device=x.device)
        deg = segment_sum(ones, edge_src, self.num_nodes, layout)
        # The segment sum runs over the edge axis, the batch trailing.
        agg = (segment_sum(msg[..., 0].movedim(-1, 0).contiguous(), edge_src,
                           self.num_nodes, layout).movedim(0, -1)
               / torch.clamp(deg, min=1.0))
        v = torch.tanh(self.node_fc(agg[..., None]))[..., 0]
        t = torch.relu(self.time_fc1(time / 86400.0))
        t = torch.relu(self.time_fc2(t))
        t_emb = self.time_out(t)
        return self.final(torch.cat([v, t_emb], dim=-1))[..., 0]


class MPNNValueNetSimple(nn.Module):
    """Occupancy per node concatenated with the time -> MLP(64, 64) ->
    scalar value."""

    def __init__(self, num_nodes: int, hidden: int = 64):
        super().__init__()
        self.fc1 = nn.Linear(num_nodes + 1, hidden)
        self.fc2 = nn.Linear(hidden, hidden)
        self.out = nn.Linear(hidden, 1)

    def forward(self, x: torch.Tensor, time: torch.Tensor) -> torch.Tensor:
        inp = torch.cat([x[..., COL_NUMBER_OF_AGENT], time / 3600.0],
                        dim=-1)
        h = torch.relu(self.fc1(inp))
        h = torch.relu(self.fc2(h))
        return self.out(h)[..., 0]
