// Threefry-2x32 (20 rounds) on the card, equal to
// tarl_tpu_torch/core/rng.py::threefry2x32 and to jax.random's default
// generator: element q of jax.random.bits(key, shape, uint32) is
// threefry_bits(key, q), the XOR of the two output words of the block on
// the counter (hi32(q), lo32(q)).  A header, so that any kernel can draw
// its noise from a tick key and an element index without a Gumbel matrix
// in device memory.  gumbel_from_bits is jax.random.gumbel's float32
// transform of those bits, shared by every kernel that draws its own
// Gumbel noise (K1, K7, K11 and the random choice of choice.cu).
#pragma once

#include <cfloat>
#include <stdint.h>

namespace tarl {

__host__ __device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// The block on key words (k1, k2) and counter words (x1, x2), in place.
__host__ __device__ __forceinline__ void threefry2x32(uint32_t k1, uint32_t k2,
                                                     uint32_t& x1,
                                                     uint32_t& x2) {
  const uint32_t ks[3] = {k1, k2, k1 ^ k2 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x1 += ks[0];
  x2 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x1 += x2;
      x2 = rotl32(x2, rot[i % 2][j]) ^ x1;
    }
    x1 += ks[(i + 1) % 3];
    x2 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
}

// 32 random bits of flat position q under key (k1, k2).
__host__ __device__ __forceinline__ uint32_t threefry_bits(uint32_t k1,
                                                          uint32_t k2,
                                                          uint64_t q) {
  uint32_t x1 = static_cast<uint32_t>(q >> 32);
  uint32_t x2 = static_cast<uint32_t>(q);
  threefry2x32(k1, k2, x1, x2);
  return x1 ^ x2;
}

// jax.random.gumbel's float32 transform of 32 random bits, op for op as
// core/rng.py::_gumbel_from_bits computes it: mantissa fill
// (bits >> 9) | 0x3F800000 minus 1.0f, u = max(tiny, f * (1 - tiny) + tiny)
// where 1 - tiny rounds to 1.0f, then -log(-log(u)).  Exact with
// --fmad=false and without fast math; logf may round an ulp apart from
// XLA's log.
__device__ __forceinline__ float gumbel_from_bits(uint32_t bits) {
  constexpr float kTiny = FLT_MIN;  // jnp.finfo(float32).tiny
  const float f = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  const float one_minus_tiny = 1.0f - kTiny;  // rounds to 1.0f, as in JAX
  const float u = fmaxf(kTiny, f * one_minus_tiny + kTiny);
  return -logf(-logf(u));
}

}  // namespace tarl
