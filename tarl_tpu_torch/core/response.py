"""Response step: confirm accepted transfers and pop upstream heads (ports
``tarl_tpu/core/response.py``: ``confirm_step`` on the plain path; the
legacy ``response_step`` is not ported).

The direction step knows which upstream won each road, so the pop mask is
exactly the set of winning upstreams; each upstream wins at most once per
tick because its head proposes to a single selected downstream.
"""
from __future__ import annotations

import torch

from ..ops.scatter import scatter_set
from ..state import RoadState


def popped_mask(accept: torch.Tensor, win_src: torch.Tensor) -> torch.Tensor:
    """bool[R]: road u pops iff it won some downstream road."""
    r = accept.shape[0]
    popped = torch.zeros(r, dtype=torch.bool, device=accept.device)
    return scatter_set(popped, win_src, True, accept & (win_src < r))


def pop_heads(road: RoadState, popped: torch.Tensor) -> RoadState:
    """Advance the head and shrink the count of every popped road."""
    p = popped.to(torch.int32)
    return road._replace(
        head=torch.remainder(road.head + p, road.nmax).to(torch.int32),
        count=road.count - p,
    )


def confirm_step(road: RoadState, accept: torch.Tensor,
                 win_src: torch.Tensor) -> tuple[RoadState, torch.Tensor]:
    """Pop the head of every road that won a transfer this step.  Returns
    ``(road, popped_mask)``."""
    popped = popped_mask(accept, win_src)
    return pop_heads(road, popped), popped
