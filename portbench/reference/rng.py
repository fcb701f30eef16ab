"""Threefry-2x32 key schedule and Gumbel streams (a frozen copy of the
program's ``core/rng.py``, which reproduces JAX's partitionable threefry
stream bit for bit).  Words are carried in int64 and masked to 32 bits
after each add and shift."""
from __future__ import annotations

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_ONE_BITS = int(np.float32(1.0).view(np.uint32))
_F32_TINY = float(np.finfo(np.float32).tiny)

Key = tuple[int, int]


def prng_key(seed: int) -> Key:
    return (0, int(seed) & _MASK)


def _rotl(x, r: int):
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k1: int, k2: int, x1, x2):
    """The Threefry-2x32 block (20 rounds) on key words ``k1, k2`` and
    counter words ``x1, x2`` (ints or int64 tensors holding uint32
    values)."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x1, x2


def split(key: Key, num: int = 2) -> list[Key]:
    return [threefry2x32(key[0], key[1], 0, i) for i in range(num)]


def _bits_at(key: Key, q: torch.Tensor) -> torch.Tensor:
    b1, b2 = threefry2x32(key[0], key[1], q >> 32, q & _MASK)
    return b1 ^ b2


def random_bits(key: Key, shape: tuple[int, ...], device) -> torch.Tensor:
    n = int(np.prod(shape))
    q = torch.arange(n, dtype=torch.int64, device=device)
    return _bits_at(key, q).reshape(shape)


def _gumbel_from_bits(bits: torch.Tensor) -> torch.Tensor:
    float_bits = (bits >> 9) | _F32_ONE_BITS
    floats = float_bits.to(torch.int32).view(torch.float32) - 1.0
    tiny = torch.tensor(_F32_TINY, dtype=torch.float32, device=bits.device)
    one_minus_tiny = 1.0 - tiny
    u = torch.maximum(tiny, floats * one_minus_tiny + tiny)
    return -torch.log(-torch.log(u))


def gumbel(key: Key, shape: tuple[int, ...], device) -> torch.Tensor:
    return _gumbel_from_bits(random_bits(key, shape, device))


def gumbel_at_positions(key: Key, q: torch.Tensor) -> torch.Tensor:
    return _gumbel_from_bits(_bits_at(key, q.to(torch.int64)))


def direction_positions(network) -> torch.Tensor:
    """int64 ``[KIN, R]``: the canonical stream position ``k * R +
    road_order[v]`` of in-slot ``k`` of road ``v``."""
    kin, r = network.in_src_tab.shape
    return (torch.arange(kin, dtype=torch.int64, device=network.device)
            [:, None] * r + network.road_order.to(torch.int64)[None, :])


def choice_gumbel(key: Key, network) -> torch.Tensor:
    """The random choice's ``[KC, N]`` node-slot-major Gumbel matrix,
    addressed by canonical position on a renumbered network."""
    kc, n = network.choice_dst_tab.shape
    if not network.renumbered:
        return gumbel(key, (kc, n), network.device)
    dev = network.device
    r = network.num_roads
    canon = torch.cat([network.road_order.to(torch.int64),
                       torch.arange(r, n, dtype=torch.int64, device=dev)])
    q = torch.arange(kc, dtype=torch.int64, device=dev)[:, None] * n \
        + canon[None, :]
    return gumbel_at_positions(key, q)
