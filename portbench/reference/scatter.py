"""Scatters that drop out-of-range indices (a frozen copy of the
program's ``ops/scatter.py``).

Torch has no drop mode, and an out-of-range index reaching ``index_put_``
on a CUDA tensor is a device-side assert.  These helpers copy the target
into a buffer one element longer, send every masked-out index to that
spare element, scatter, and return the first ``numel`` elements viewed in
the target's shape.  No host sync: the mask is applied with ``where``,
never by boolean indexing.  The target itself is left untouched.
"""
from __future__ import annotations

import torch


def _padded(dst: torch.Tensor) -> torch.Tensor:
    buf = torch.empty(dst.numel() + 1, dtype=dst.dtype, device=dst.device)
    buf[:-1].copy_(dst.reshape(-1))
    return buf


def _safe_index(flat_idx: torch.Tensor, valid: torch.Tensor,
                n: int) -> torch.Tensor:
    return torch.where(valid, flat_idx.to(torch.int64), n)


def scatter_set(dst: torch.Tensor, flat_idx: torch.Tensor,
                values, valid: torch.Tensor) -> torch.Tensor:
    """``dst.flat[flat_idx[i]] = values[i]`` where ``valid[i]``.  The
    caller guarantees that valid indices are distinct (a ``.set`` scatter
    with repeated indices has no defined winner)."""
    n = dst.numel()
    buf = _padded(dst)
    idx = _safe_index(flat_idx, valid, n)
    if not isinstance(values, torch.Tensor):
        values = torch.full(idx.shape, values, dtype=dst.dtype,
                            device=dst.device)
    buf.index_put_((idx,), values.to(dst.dtype).expand(idx.shape))
    return buf[:n].view(dst.shape)


def scatter_add(dst: torch.Tensor, flat_idx: torch.Tensor,
                values: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """``dst.flat[flat_idx[i]] += values[i]`` where ``valid[i]``; repeated
    indices accumulate."""
    n = dst.numel()
    buf = _padded(dst)
    idx = _safe_index(flat_idx, valid, n)
    buf.index_add_(0, idx, values.to(dst.dtype).expand(idx.shape))
    return buf[:n].view(dst.shape)
