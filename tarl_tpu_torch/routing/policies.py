"""Route-choice policies (ports ``tarl_tpu/routing/policies.py``:
``random_choice`` only; the shortest-path policies wait for the routing
slice).

A policy is a function ``choice(state, network) -> (state, entry_road)``
that updates ``state.selected_road`` and optionally returns per-agent entry
roads for insertion.
"""
from __future__ import annotations

import torch

from ..core.rng import choice_gumbel, split


def random_choice(state, network, gumbel: torch.Tensor | None = None):
    """Uniform next-road choice for every road and SRC node: Gumbel-max over
    each node's choice slots (slot-major ``[KC, N]`` noise, ascending slot,
    strict ``>``).

    The key is split first and the first half written back, as in the
    reference.  ``gumbel`` (optional) replaces the ``[KC, N]`` draw from
    the second half, e.g. with the reference's own matrix in a test."""
    key, sub = split(state.key)
    scores = choice_gumbel(sub, network) if gumbel is None else gumbel
    neg_inf = torch.tensor(float("-inf"), device=scores.device)
    best = torch.full((network.num_nodes,), float("-inf"),
                      dtype=torch.float32, device=scores.device)
    sel = state.selected_road
    for k in range(network.choice_dst_tab.shape[0]):
        s_k = torch.where(network.choice_ok[k], scores[k], neg_inf)
        take = s_k > best
        best = torch.where(take, s_k, best)
        sel = torch.where(take, network.choice_dst_tab[k], sel)
    return state._replace(selected_road=sel, key=key), None
