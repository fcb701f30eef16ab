// Per-segment Gumbel-max with two payloads, its noise drawn in the kernel:
// the sampler of the fused edge-phase core.
//
// Replaces tarl_tpu/core/fused_core.py::_argmax_payload_kernel (K12), the
// Pallas TPU kernel of gumbel_argmax_payload.  The TPU kernel streamed the
// turn-edge list through VMEM in tiles of 512, seeded the TPU's hardware
// generator per tile, and reduced each tile against a one-hot [tile,
// segments] block on the vector unit, carrying the best score and the two
// payloads (as float32) across the sequential grid.  Here each segment (a
// downstream road) is one thread that walks its run of a CSR of the
// segment ids (tarl_tpu_torch/ops/segment.py::SegmentLayout, built once per
// network): ascending edge index, strict >, so ties go to the lowest edge
// index as in the TPU kernel.  No atomics, no shared memory.
//
// Noise: the TPU's hardware bits exist on no other machine, so edge e takes
// threefry_bits(key, e) (threefry.cuh; jax.random.bits(key, (E,))[e]) and
// the TPU kernel's own transform, u = (bits >> 8) * 2^-24 and
// g = -log(-log(u + 1e-7) + 1e-7), in float32.  Only edges with a finite
// logit above NEG_LARGE draw it; others cannot win.
//
// Semantics (held bitwise against the plain PyTorch version,
// tarl_tpu_torch/core/fused_core.py::gumbel_argmax_payload_plain):
//   score(e) = logit(e) + g(e) where logit(e) is finite and > NEG_LARGE;
//   the winner of a segment is its first element of largest score above
//   NEG_LARGE; out_a / out_b are its payloads (int32, not float32: exact at
//   any size); a segment without one gives a = 0 and b = num_segments.
// Compiled without fast math and with --fmad=false: logf is the precise
// library function, the one PyTorch's float32 log calls on the card.
//
// Bound: bytes.  The function reads the logits and the CSR order (8 bytes
// an edge), the offsets, and the two payloads of each segment's winner
// only, and writes 8 bytes a segment: ~48 KB at the headline Grid16x16
// (E = 3,656, R = 960), ~15 ns at 3.35 TB/s; the ~130 integer and float
// operations of a draw per eligible edge take less.
// At that size the launch is the whole cost, so this simple form spends
// nothing on bandwidth or on balancing segments of unequal length.

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr float kNegLarge = -3.4e38f;

__global__ void fc_payload_kernel(const float* __restrict__ logits,
                                  const int* __restrict__ pay_a,
                                  const int* __restrict__ pay_b,
                                  const int* __restrict__ order,
                                  const int* __restrict__ offsets, int n,
                                  uint32_t k1, uint32_t k2,
                                  int* __restrict__ out_a,
                                  int* __restrict__ out_b) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n) return;
  float best = kNegLarge;
  int a = 0, b = n;
  for (int j = offsets[s]; j < offsets[s + 1]; ++j) {
    const int e = order[j];
    const float logit = logits[e];
    if (!(isfinite(logit) && logit > kNegLarge)) continue;
    const uint32_t bits = tarl::threefry_bits(k1, k2, static_cast<uint64_t>(e));
    const float u = static_cast<float>(static_cast<int>(bits >> 8)) *
                    (1.0f / 16777216.0f);
    const float g = -logf(-logf(u + 1e-7f) + 1e-7f);
    const float score = logit + g;
    if (score > best) {
      best = score;
      a = pay_a[e];
      b = pay_b[e];
    }
  }
  out_a[s] = a;
  out_b[s] = b;
}

}  // namespace

extern "C" int tarl_gumbel_argmax_payload(const float* logits,
                                          const int* pay_a, const int* pay_b,
                                          const int* order, const int* offsets,
                                          int n, uint32_t k1, uint32_t k2,
                                          int* out_a, int* out_b,
                                          void* stream) {
  if (n == 0) return 0;
  const int threads = 128;
  fc_payload_kernel<<<(n + threads - 1) / threads, threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      logits, pay_a, pay_b, order, offsets, n, k1, k2, out_a, out_b);
  return static_cast<int>(cudaGetLastError());
}
