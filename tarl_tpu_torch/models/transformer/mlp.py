"""MLP building block (ports ``tarl_tpu/models/transformer/mlp.py``).

``num_hidden_layers`` ``Linear`` + activation layers named ``hidden_{i}``,
then a linear head named ``out``: the reference's Flax module names, so a
Dense kernel ``[in, out]`` becomes ``<name>.weight [out, in]``.  Unlike
Flax, the input width is given up front.  ``gelu`` is Flax's default, the
tanh approximation.  Dropout applies only where the caller passes
``deterministic=False`` (a torch draw, not the reference's stream); no
path of the reference does.
"""
from __future__ import annotations

from typing import Sequence, Union

import torch
from torch import nn
from torch.nn import functional as F

_ACTS = {
    "relu": torch.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "tanh": torch.tanh,
    "silu": F.silu,
}


class MLP(nn.Module):
    """``num_hidden_layers`` of Linear + activation (+ dropout), then a
    linear head."""

    def __init__(self, in_dim: int, output_dim: int,
                 hidden_dims: Union[int, Sequence[int]] = 128,
                 num_hidden_layers: int = 1, dropout: float = 0.0,
                 act: str = "relu"):
        super().__init__()
        dims = hidden_dims
        if isinstance(dims, int):
            dims = [dims] * num_hidden_layers
        if len(dims) != num_hidden_layers:
            raise ValueError(f"{len(dims)} hidden widths for "
                             f"{num_hidden_layers} hidden layers")
        if act not in _ACTS:
            raise ValueError(f"Unknown activation {act!r}")
        self.act = act
        self.dropout = dropout
        self.num_hidden_layers = len(dims)
        prev = in_dim
        for i, d in enumerate(dims):
            setattr(self, f"hidden_{i}", nn.Linear(prev, d))
            prev = d
        self.out = nn.Linear(prev, output_dim)

    def forward(self, x: torch.Tensor, *,
                deterministic: bool = True) -> torch.Tensor:
        act = _ACTS[self.act]
        for i in range(self.num_hidden_layers):
            x = act(getattr(self, f"hidden_{i}")(x))
            if self.dropout > 0.0 and not deterministic:
                x = F.dropout(x, self.dropout, training=True)
        return self.out(x)
