"""Threefry-2x32 key schedule and Gumbel streams (ports
``tarl_tpu/core/rng.py`` and the parts of JAX's default PRNG it relies on).

The port reproduces JAX's partitionable threefry stream bit for bit:

* ``prng_key(seed)`` is ``(0, seed mod 2**32)`` for a 32-bit seed;
* ``split(key)[i] = threefry2x32(key, (0, i))``;
* ``fold_in(key, d) = threefry2x32(key, (0, d mod 2**32))``;
* element i (row-major flat index) of ``random_bits(key, shape)`` is
  ``b1 ^ b2`` of ``threefry2x32(key, (hi32(i), lo32(i)))``;
* uniform and Gumbel follow ``jax.random`` op for op: mantissa fill,
  ``minval = tiny``, then ``-log(-log(u))``.  Only ``log`` may round
  differently from XLA's (one ulp at most).

The fused edge-phase core (``tarl_tpu/core/fused_core.py``) draws its noise
from the TPU's hardware generator, which no other machine has.  The port
takes the bits of turn edge e from this threefry instead,
``random_bits(k_dir, (E,))[e]``, and applies that kernel's own transform
(:func:`payload_gumbel`).  ``csrc/threefry.cuh`` is the same block for
kernels that draw their noise on the card.

Torch has no full uint32 arithmetic, so words are carried in int64 and
masked to 32 bits after each add and shift.  :func:`threefry2x32` takes
Python ints or int64 tensors alike: the key schedule runs on the host on
ints (a handful of microseconds, no device work), the counter blocks of a
Gumbel matrix run on the device.
"""
from __future__ import annotations

import math
import operator

import numpy as np
import torch

from ..device import resolve_device

__all__ = [
    "prng_key", "threefry2x32", "split", "fold_in", "random_bits", "gumbel",
    "gumbel_at_positions", "direction_positions", "direction_gumbel",
    "choice_gumbel",
    "payload_gumbel", "key_words", "permutation",
]

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_ONE_BITS = int(np.float32(1.0).view(np.uint32))
_F32_TINY = float(np.finfo(np.float32).tiny)

Key = tuple[int, int]


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` for a seed in int32 range."""
    return (0, int(seed) & _MASK)


def key_words(key) -> Key:
    """The key's two words as ints in ``[0, 2**32)``, as a kernel takes
    them; raises on anything else."""
    if len(key) != 2:
        raise ValueError(f"key has {len(key)} words, expected 2")
    k1, k2 = operator.index(key[0]), operator.index(key[1])
    if not (0 <= k1 <= _MASK and 0 <= k2 <= _MASK):
        raise ValueError(f"key words {k1}, {k2} lie outside [0, 2**32)")
    return k1, k2


def _rotl(x, r: int):
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k1: int, k2: int, x1, x2):
    """The Threefry-2x32 block (20 rounds) on key words ``k1, k2`` and
    counter words ``x1, x2`` (ints or int64 tensors holding uint32 values).
    Returns the two output words in the type of ``x1``."""
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
    """``jax.random.split(key, num)`` under ``jax_threefry_partitionable``."""
    return [threefry2x32(key[0], key[1], 0, i) for i in range(num)]


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)``: the block on the counter ``(0,
    data)``, ``data`` taken as a uint32 (JAX casts it so)."""
    return threefry2x32(key[0], key[1], 0, operator.index(data) & _MASK)


def _bits_at(key: Key, q: torch.Tensor) -> torch.Tensor:
    """``b1 ^ b2`` of ``threefry2x32(key, (hi32(q), lo32(q)))`` for int64
    flat positions ``q``."""
    b1, b2 = threefry2x32(key[0], key[1], q >> 32, q & _MASK)
    return b1 ^ b2


def random_bits(key: Key, shape: tuple[int, ...],
                device: torch.device | str | None = None) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as int64 values."""
    n = int(np.prod(shape))
    q = torch.arange(n, dtype=torch.int64, device=resolve_device(device))
    return _bits_at(key, q).reshape(shape)


def _gumbel_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """``jax.random.gumbel``'s transform of 32 random bits, op for op."""
    float_bits = (bits >> 9) | _F32_ONE_BITS   # < 2**31: exact in int32
    floats = float_bits.to(torch.int32).view(torch.float32) - 1.0
    tiny = torch.tensor(_F32_TINY, dtype=torch.float32, device=bits.device)
    one_minus_tiny = 1.0 - tiny               # rounds to 1.0f, as in JAX
    u = torch.maximum(tiny, floats * one_minus_tiny + tiny)
    return -torch.log(-torch.log(u))


def permutation(key: Key, n: int,
                device: torch.device | str | None = None) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` as int64: JAX's ``_shuffle`` of
    ``arange(n)``, ``ceil(3 ln n / ln(2**32 - 1))`` rounds (one up to
    n = 1,625, two from 1,626), each ``key, sub = split(key)`` and a stable
    sort by ``random_bits(sub, (n,))`` (uint32 values, sorted as int64)."""
    dev = resolve_device(device)
    x = torch.arange(n, dtype=torch.int64, device=dev)
    rounds = math.ceil(3 * math.log(max(1, n)) / math.log(_MASK))
    for _ in range(rounds):
        key, sub = split(key)
        x = x[torch.sort(random_bits(sub, (n,), dev), stable=True).indices]
    return x


def gumbel(key: Key, shape: tuple[int, ...],
           device: torch.device | str | None = None) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, float32)``."""
    return _gumbel_from_bits(random_bits(key, shape, device))


def gumbel_at_positions(key: Key, q: torch.Tensor) -> torch.Tensor:
    """``gumbel_at_positions(key, q)[i] == gumbel(key, (M,))[q[i]]`` for any
    flat positions ``q``: each element is a pure function of
    ``(key, position)``."""
    return _gumbel_from_bits(_bits_at(key, q.to(torch.int64)))


def direction_positions(network) -> torch.Tensor:
    """int64 ``[KIN, R]``: the canonical stream position ``k * R +
    road_order[v]`` of in-slot ``k`` of road ``v`` (the direction winner's
    kernel draws its noise there)."""
    kin, r = network.in_src_tab.shape
    return (torch.arange(kin, dtype=torch.int64, device=network.device)
            [:, None] * r + network.road_order.to(torch.int64)[None, :])


def direction_gumbel(key: Key, network) -> torch.Tensor:
    """The direction step's ``[KIN, R]`` slot-major Gumbel matrix; a
    renumbered network addresses the same stream by canonical position
    (:func:`direction_positions`)."""
    if not network.renumbered:
        return gumbel(key, tuple(network.in_src_tab.shape), network.device)
    return gumbel_at_positions(key, direction_positions(network))


def payload_gumbel(bits: torch.Tensor) -> torch.Tensor:
    """The fused core's noise from 32 random bits (int64 values), op for op
    as ``_argmax_payload_kernel`` computes it: ``u = (bits >> 8) * 2**-24``,
    then ``-log(-log(u + 1e-7) + 1e-7)`` in float32.  Zero bits give the
    constant that the reference's interpret mode draws."""
    u = (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return -torch.log(-torch.log(u + 1e-7) + 1e-7)


def choice_gumbel(key: Key, network) -> torch.Tensor:
    """The random choice's ``[KC, N]`` node-slot-major Gumbel matrix,
    canonical-addressed like :func:`direction_gumbel`."""
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
