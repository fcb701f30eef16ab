"""Generalized Advantage Estimation (ports ``tarl_tpu/rl/gae.py``).

The reference's reverse ``lax.scan`` is a reverse Python loop over the T
steps here, on the rollout's device: the per-step terms are computed for
all steps at once, op for op as the scan computes each, and only the
recursion runs step by step (two small launches a step, no host read).
"""
from __future__ import annotations

import torch


def gae(rewards: torch.Tensor, values: torch.Tensor,
        last_value: torch.Tensor, dones: torch.Tensor, gamma: float,
        lam: float) -> tuple[torch.Tensor, torch.Tensor]:
    """``(advantages [T], returns [T])`` from float32 ``rewards [T]``,
    ``values [T]``, ``last_value []`` and bool ``dones [T]`` (terminal
    after step t)."""
    not_done = 1.0 - dones.to(torch.float32)
    next_values = torch.cat([values[1:], last_value[None]])
    delta = rewards + gamma * next_values * not_done - values
    decay = gamma * lam * not_done
    adv = torch.zeros((), dtype=rewards.dtype, device=rewards.device)
    out = []
    for t in range(rewards.shape[0] - 1, -1, -1):
        adv = delta[t] + decay[t] * adv
        out.append(adv)
    advantages = (torch.stack(out[::-1]) if out
                  else torch.zeros_like(rewards))
    return advantages, advantages + values


def normalize(advantages: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Standardise the advantages over the batch with the population std
    (``jnp.std``'s)."""
    return ((advantages - advantages.mean())
            / (advantages.std(correction=0) + eps))
