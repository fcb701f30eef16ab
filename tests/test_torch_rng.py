"""The port's threefry stream against JAX's.

Threefry words, ``split`` and the ``random_bits`` words must be bitwise
equal to ``threefry2x32_p``, ``jax.random.split`` and ``jax.random.bits``.
The Gumbel floats go through two ``log``s, where PyTorch's and XLA's libm
may each round differently by one ulp: they must agree to one float32 ulp
at the scale of max(|g|, 1) — the spread of one ulp in ``-log(u)``
propagated through the outer log — and the share that matches bitwise is
checked to be the majority.  ``gumbel_at_positions`` must reproduce the
port's own stream under permuted addressing exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.prng import threefry2x32_p

from tarl_tpu.core.rng import gumbel_at_positions as ref_gumbel_at_positions
from tarl_tpu_torch.core import rng

torch.set_num_threads(1)

SEEDS = [0, 1, 42, 2 ** 31 - 1]


def _key(seed):
    return tuple(int(w) for w in np.asarray(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seed", SEEDS + [-1, -12345])
def test_prng_key(seed):
    assert rng.prng_key(seed) == _key(seed)


@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_words_bitwise(seed):
    r = np.random.default_rng(seed)
    k1, k2 = (int(x) for x in r.integers(0, 2 ** 32, size=2))
    x1 = r.integers(0, 2 ** 32, size=4096, dtype=np.uint64).astype(np.uint32)
    x2 = r.integers(0, 2 ** 32, size=4096, dtype=np.uint64).astype(np.uint32)
    b1, b2 = threefry2x32_p.bind(
        jnp.uint32(k1), jnp.uint32(k2), jnp.asarray(x1), jnp.asarray(x2))
    p1, p2 = rng.threefry2x32(
        k1, k2, torch.as_tensor(x1.astype(np.int64)),
        torch.as_tensor(x2.astype(np.int64)))
    np.testing.assert_array_equal(np.asarray(b1).astype(np.int64), p1.numpy())
    np.testing.assert_array_equal(np.asarray(b2).astype(np.int64), p2.numpy())
    # The host path on Python ints gives the same words.
    assert rng.threefry2x32(k1, k2, int(x1[7]), int(x2[7])) == (
        int(np.asarray(b1)[7]), int(np.asarray(b2)[7]))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [2, 3])
def test_split_chain_bitwise(seed, num):
    key = jax.random.PRNGKey(seed)
    pkey = rng.prng_key(seed)
    for _ in range(5):
        ref = [tuple(int(w) for w in np.asarray(k))
               for k in jax.random.split(key, num)]
        assert rng.split(pkey, num) == ref
        key = jax.random.split(key, num)[-1]
        pkey = rng.split(pkey, num)[-1]


@pytest.mark.parametrize("shape", [(5,), (4, 37), (3, 8, 11)])
def test_random_bits_bitwise(shape):
    key = jax.random.PRNGKey(3)
    ref = np.asarray(jax.random.bits(key, shape, jnp.uint32))
    got = rng.random_bits(_key(3), shape, "cpu").numpy()
    np.testing.assert_array_equal(ref.astype(np.int64), got)


@pytest.mark.parametrize("seed", [0, 5])
def test_gumbel_within_one_ulp(seed):
    key = jax.random.PRNGKey(seed)
    shape = (8, 4096)
    ref = np.asarray(jax.random.gumbel(key, shape, jnp.float32))
    got = rng.gumbel(_key(seed), shape, "cpu").numpy()
    assert got.dtype == np.float32 and got.shape == shape
    scale = np.maximum(np.abs(ref), 1.0).astype(np.float32)
    ulp = np.spacing(scale).astype(np.float64)
    err = np.abs(ref.astype(np.float64) - got.astype(np.float64))
    assert (err <= ulp).all(), f"worst {(err / ulp).max()} ulp"
    bitwise = float((ref == got).mean())
    print(f"gumbel bitwise-equal share: {bitwise:.4f}")
    assert bitwise > 0.5


def test_uniform_before_the_logs_bitwise():
    """Everything before the two logs is op for op: the uniform ``u`` that
    feeds them matches JAX's transform bitwise."""
    bits = rng.random_bits(_key(9), (4096,), "cpu")
    ref_bits = np.asarray(jax.random.bits(jax.random.PRNGKey(9), (4096,),
                                          jnp.uint32))
    fb = (ref_bits >> 9) | np.uint32(0x3F800000)
    tiny = np.finfo(np.float32).tiny
    u_ref = np.maximum(tiny, (fb.view(np.float32) - np.float32(1.0))
                       + np.float32(tiny))
    float_bits = (bits >> 9) | 0x3F800000
    u = torch.maximum(torch.tensor(tiny),
                      float_bits.to(torch.int32).view(torch.float32) - 1.0
                      + tiny)
    np.testing.assert_array_equal(u_ref, u.numpy())


@pytest.mark.parametrize("n", [257, 4096])
def test_gumbel_at_positions_permuted(n):
    key = _key(11)
    full = rng.gumbel(key, (n,), "cpu")
    perm = np.random.RandomState(0).permutation(n)
    got = rng.gumbel_at_positions(key, torch.as_tensor(perm))
    np.testing.assert_array_equal(full.numpy()[perm], got.numpy())
    # Same addressing as the reference's canonical stream, to one ulp.
    ref = np.asarray(ref_gumbel_at_positions(
        jax.random.PRNGKey(11), jnp.asarray(perm, jnp.uint32)))
    ulp = np.spacing(np.maximum(np.abs(ref), 1.0).astype(np.float32))
    assert (np.abs(ref.astype(np.float64) - got.numpy()) <= ulp).all()
