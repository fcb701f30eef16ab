"""The slot-major Graph Transformer forward for classical rollouts (ports
``tarl_tpu/models/transformer/slot_forward.py``).

:class:`~.agent.TransformerRoutePolicy` aggregates attention with segment
ops over the flat edge list; padded rows of a slot table would enter its
softmax sums, so the padded-table paths (``rl.learned_policy.
make_learned_choice``) cannot run that forward on the table.  The twin here
computes the same forward in the slot-major layout:

* the out-edge table ``[KF, N]`` (grouped by source) is joined by an
  in-edge table ``[KA, N]`` (grouped by target); the per-target segment
  softmax becomes a masked softmax over the slot axis, a fixed-order
  reduction;
* edges do not interact given the node states, so the edge features evolve
  independently in the two tables: the in-entries feed the node update,
  the out-entries the per-edge logit head;
* the node update takes a per-layer ``sync`` hook, the identity on one
  device (a road-sharded run would gather the node block there).

The twin's classes subclass the flat ones, so its module names are theirs
and one state dict (``transformer.{node_emb, pe_emb, edge_emb, gt_i.*,
edge_linear, mu_mlp, log_var_mlp}``) serves both forms; the pooled heads
go unused.  Against the flat forward only the order of the softmax sums
differs: the logits agree to about 1e-6 (compared at atol/rtol 2e-5).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .agent import TransformerRoutePolicy
from .gt_conv import GTConv
from .model import GraphTransformerNet


class SlotEdgeTables(NamedTuple):
    """Slot-major views of the full dual-graph edge list, built once on the
    host: IN tables group edges by target node (attention), OUT tables by
    source (route-choice logits); slot order = increasing edge id."""

    in_ok: torch.Tensor     # bool[KA, N]
    in_src: torch.Tensor    # int32[KA, N]: source node per in-slot (0 pad)
    in_attr: torch.Tensor   # float32[KA, N, 1]: edge features
    out_ok: torch.Tensor    # bool[KF, N]
    out_dst: torch.Tensor   # int32[KF, N]: target node per out-slot (0 pad)
    out_attr: torch.Tensor  # float32[KF, N, 1]


def group_slots(by: np.ndarray, other: np.ndarray, attr: np.ndarray,
                n: int):
    """``(ok[K, n], other[K, n], attr[K, n])`` numpy tables of the edges
    grouped by ``by``, each group's slots in increasing edge id, K the
    largest group (at least 1)."""
    by = np.asarray(by, dtype=np.int64)
    order = np.argsort(by, kind="stable")
    counts = np.bincount(by, minlength=n)
    k = max(1, int(counts.max(initial=0)))
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(len(by)) - starts[by[order]]
    ok = np.zeros((k, n), dtype=bool)
    oth = np.zeros((k, n), dtype=np.int32)
    att = np.zeros((k, n), dtype=np.float32)
    ok[slot, by[order]] = True
    oth[slot, by[order]] = np.asarray(other)[order]
    att[slot, by[order]] = np.asarray(attr, dtype=np.float32)[order]
    return ok, oth, att


def slot_edge_tables(network) -> SlotEdgeTables:
    """Both slot-major edge tables of ``network.full_*``, on its device."""
    src = network.full_src.cpu().numpy()
    dst = network.full_dst.cpu().numpy()
    attr = network.full_attr.cpu().numpy()
    n = network.num_nodes
    dev = network.device
    in_ok, in_src, in_attr = group_slots(dst, src, attr, n)
    out_ok, out_dst, out_attr = group_slots(src, dst, attr, n)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    return SlotEdgeTables(t(in_ok), t(in_src), t(in_attr[..., None]),
                          t(out_ok), t(out_dst), t(out_attr[..., None]))


class _SlotGTConv(GTConv):
    """:class:`GTConv` over slot tables: the same parameters, the segment
    ops replaced by masked slot-axis reductions.  Takes the full node
    state and updates the columns ``cols``."""

    def forward(self, h: torch.Tensor, cols: torch.Tensor,
                in_ok: torch.Tensor, in_src: torch.Tensor,
                e_in: torch.Tensor, out_dst: torch.Tensor,
                e_out: torch.Tensor):
        """``h[..., N, D]`` (leading axes a batch), ``cols[M]``, the
        in-tables ``[KA, M]`` with their edge states ``e_in[..., KA, M,
        hidden]``, the out-tables likewise; returns ``(h_cols [..., M, D],
        e_in, e_out)`` after the layer."""
        q = self.heads(self.WQ(h))
        k = self.heads(self.WK(h))
        v = self.heads(self.WV(h))
        cols, in_src = cols.long(), in_src.long()

        # In-entries: attention at the column (target) nodes.  The masked
        # slot softmax is the segment softmax per target: stabilised by the
        # finite masked max, its denominator clamped.
        scores, e_ij_in = self.edge_scores(e_in, q[..., None, cols, :, :],
                                           k[..., in_src, :, :])
        ok = in_ok[..., None]
        smax = torch.where(ok, scores, float("-inf")).amax(dim=-3)
        smax = torch.where(torch.isfinite(smax), smax, 0.0)
        expd = torch.where(ok, torch.exp(scores - smax[..., None, :, :]),
                           0.0)
        alpha = expd / torch.clamp(expd.sum(dim=-3),
                                   min=1e-30)[..., None, :, :]

        vals = v[..., in_src, :, :]
        if self.gate:
            g = self.heads(self.n_gate(h))
            vals = vals * torch.sigmoid(g[..., in_src, :, :])
        agg = (alpha[..., None] * vals).sum(dim=-4).flatten(-2)
        h_cols = self.node_out(agg, h[..., cols, :])

        # The edge states of both tables; on the out-entries the column is
        # the source (masked lanes carry values no valid logit reads).
        e_in_next = self.edge_out(e_ij_in, e_in)
        _, e_ij_out = self.edge_scores(e_out, q[..., out_dst.long(), :, :],
                                       k[..., None, cols, :, :])
        return h_cols, e_in_next, self.edge_out(e_ij_out, e_out)


class _SlotGTNet(GraphTransformerNet):
    """:class:`GraphTransformerNet` over slot tables, the per-edge score
    head only (the route choice's path)."""

    conv_class = _SlotGTConv

    def forward(self, xs: torch.Tensor, pe: torch.Tensor,
                tables: SlotEdgeTables, cols: torch.Tensor, sync=None):
        h = self.embed_nodes(xs, pe)
        in_ok, in_src = tables.in_ok[:, cols], tables.in_src[:, cols]
        out_dst = tables.out_dst[:, cols]
        e_in = self.edge_emb(tables.in_attr[:, cols])
        e_out = self.edge_emb(tables.out_attr[:, cols])
        for layer in self.layers():
            h_cols, e_in, e_out = layer(h, cols, in_ok, in_src, e_in,
                                        out_dst, e_out)
            h = sync(h_cols) if sync is not None else h_cols
        return self.edge_linear(e_out)[..., 0]


class SlotTransformerRoutePolicy(TransformerRoutePolicy):
    """The twin of :class:`TransformerRoutePolicy` over slot tables: the
    trained policy's state dict applies verbatim.  Build one with
    :func:`slot_twin`."""

    net_class = _SlotGTNet

    def forward(self, x: torch.Tensor, tables: SlotEdgeTables,
                cols: torch.Tensor, sync=None) -> torch.Tensor:
        """``x[..., N, C]`` the full node context (leading axes a batch),
        ``cols`` int32[M] the source columns to score; ``[..., KF, M]``
        out-slot logits.  ``sync`` takes each layer's updated rows ``[...,
        M, D]`` of the columns to the next layer's node state ``[..., N,
        D]`` (the columns must then be every node, as without it)."""
        xs = x / (1.0 + torch.abs(x))
        return self.transformer(xs, self.pe, tables, cols, sync=sync)


def slot_twin(policy_net: TransformerRoutePolicy,
              num_nodes: int | None = None) -> SlotTransformerRoutePolicy:
    """The slot-major twin of ``policy_net`` (the same hyperparameters and
    encoding, on its device), its encoding padded with zero rows to
    ``num_nodes`` where that is given (node-column blocks padded to a
    multiple of the blocks).  Deterministic rollouts only: raises where
    the policy has dropout."""
    if float(policy_net.dropout) != 0.0:
        raise ValueError("slot forward supports deterministic rollouts only")
    pe = policy_net.pe.cpu().numpy()
    if num_nodes is not None:
        pe = np.concatenate([pe, np.zeros((num_nodes - pe.shape[0],
                                           pe.shape[1]), pe.dtype)])
    twin = SlotTransformerRoutePolicy(
        pe=pe, hidden_dim=policy_net.hidden_dim,
        num_layers=policy_net.num_layers, num_heads=policy_net.num_heads,
        gate=policy_net.gate, context_dim=policy_net.context_dim,
        edge_dim=policy_net.edge_dim)
    return twin.to(policy_net.pe.device)
