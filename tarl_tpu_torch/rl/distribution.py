"""Graph action distribution: one outgoing edge per source node, jointly
(ports ``tarl_tpu/rl/distribution.py``).

A :class:`GraphDistribution` over multi-hot edge actions groups the edges
by source node; every method runs on unbatched ``logits[E]``.  ``mode``
and ``sample(key)`` are ``ops.action``: on the card one launch of K11's
action entry each, which scales the logits, draws the sample's Gumbel
noise from the key, takes the per-segment argmax and writes the multi-hot
action (no separate draw, zero fill or scatter).  ``log_probs`` and
``log_prob(action)`` are ``ops.log_probs`` and ``ops.log_prob``: on the
card one launch of K10's entry each (the scale, the segment max, the
log-softmax and, for an action, its validity and masked log-probs; the
joint sum is ``torch.sum``).  ``probs`` launches K10 and K9.  It carries the
:class:`~tarl_tpu_torch.ops.segment.SegmentLayout` of ``edge_src``, built
once by its owner, and the segment ops it calls (``ops.segment.KERNELS``
unless the caller forces ``PLAIN``).

:func:`log_prob_and_entropy` is ``log_prob`` and ``entropy`` over a batch
of logits in one differentiable pass of the plain segment ops, for PPO's
loss (the reference vmaps the two methods there).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.rng import Key
from ..ops.segment import (
    KERNELS,
    PLAIN,
    SegmentLayout,
    SegmentOps,
    scale_logits,
    segment_log_probs_plain,
    segment_softmax,
    segment_sum_plain,
)


class GraphDistribution(NamedTuple):
    """Distribution over multi-hot edge actions grouped by source node.

    ``logits`` float32[E]; ``edge_src`` int32[E], the grouping key;
    ``num_nodes`` the segment count; ``temperature`` the logit scale."""

    logits: torch.Tensor
    edge_src: torch.Tensor
    num_nodes: int
    temperature: float = 1.0
    layout: Optional[SegmentLayout] = None
    ops: SegmentOps = KERNELS

    @property
    def _scaled(self) -> torch.Tensor:
        return scale_logits(self.logits, self.temperature)

    def probs(self) -> torch.Tensor:
        """Per-edge probability within its source node's group."""
        return segment_softmax(self._scaled, self.edge_src, self.num_nodes,
                               self.layout, self.ops)

    def log_probs(self) -> torch.Tensor:
        return self.ops.log_probs(self.logits, self.edge_src, self.num_nodes,
                                  self.layout, self.temperature)

    def sample(self, key: Key) -> torch.Tensor:
        """Multi-hot bool[E]: one edge per node that has outgoing edges,
        by the Gumbel-max trick with ``jax.random.gumbel(key, (E,))``."""
        return self.ops.action(self.logits, self.edge_src, self.num_nodes,
                               self.layout, self.temperature, key)

    def mode(self) -> torch.Tensor:
        """Deterministic multi-hot: the per-group argmax."""
        return self.ops.action(self.logits, self.edge_src, self.num_nodes,
                               self.layout, self.temperature, None)

    def log_prob(self, action: torch.Tensor) -> torch.Tensor:
        """Joint log-probability of a multi-hot bool action; ``-inf``
        unless every group with outgoing edges activates exactly one
        edge (a chosen zero-probability edge gives ``-inf`` too)."""
        return self.ops.log_prob(self.logits, action, self.edge_src,
                                 self.num_nodes, self.layout,
                                 self.temperature)

    def entropy(self) -> torch.Tensor:
        """Sum of the per-group categorical entropies."""
        p = self.probs()
        lp = self.log_probs()
        return torch.sum(torch.where(p > 0, -p * lp, 0.0))


def log_prob_and_entropy(logits: torch.Tensor, action: torch.Tensor,
                         edge_src: torch.Tensor, num_nodes: int,
                         temperature: float = 1.0
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """``GraphDistribution(logits[b], ...).log_prob(action[b])`` and
    ``.entropy()`` for every row b of float32 ``logits [B, E]`` and bool
    ``action [B, E]``: the plain segment ops over the edge axis with the
    batch as a trailing axis, in one pass, differentiable.  Returns two
    float32 ``[B]``."""
    x = scale_logits(logits, temperature).T
    act = action.T.to(torch.float32)
    lp = segment_log_probs_plain(x, edge_src, num_nodes)
    per_group = segment_sum_plain(act, edge_src, num_nodes)
    group_sizes = segment_sum_plain(torch.ones_like(act), edge_src,
                                    num_nodes)
    valid = torch.all(torch.where(group_sizes > 0, per_group == 1.0,
                                  per_group == 0.0), dim=0)
    total = torch.sum(torch.where(act > 0, lp, 0.0), dim=0)
    log_prob = torch.where(valid, total, float("-inf"))
    p = segment_softmax(x, edge_src, num_nodes, ops=PLAIN)
    entropy = torch.sum(torch.where(p > 0, -p * lp, 0.0), dim=0)
    return log_prob, entropy
