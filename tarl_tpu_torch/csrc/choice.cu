// The random route choice for one tick in one launch: every road and SRC
// node picks its next road by Gumbel-max over its choice slots, the noise
// drawn in the kernel.
//
// Replaces no Pallas kernel: the reference draws the [KC, N] Gumbel matrix
// of tarl_tpu/routing/policies.py::random_choice in plain jnp and XLA
// fuses the draw, the transform and the slot loop into one loop.  The
// port's plain version (tarl_tpu_torch/routing/policies.py::
// random_choice_plain) runs the same function as about 210 PyTorch
// launches a tick: the 20 rounds of threefry as int64 tensor ops on the
// [KC, N] matrix, the Gumbel transform, and four ops a slot for the
// argmax.  This kernel is that function in one launch.
//
// rc_choice_kernel gives each dual-graph node v < N one thread (roads
// first, then the SRC and DEST nodes, as choice_dst_tab is laid out).  The
// thread walks the KC slots in ascending order; a slot with choice_ok[k, v]
// draws threefry_bits(key, k*N + canon(v)) (threefry.cuh), canon(v) =
// road_order[v] for a road of a renumbered network and v otherwise, the
// canonical address of core/rng.py::choice_gumbel, and applies
// jax.random.gumbel's transform op for op (threefry.cuh::gumbel_from_bits,
// shared with K1, K7 and K11).  A slot that is not ok draws nothing: its
// score is -inf in the plain version and never wins.  The running best
// starts at -inf with the node's incoming selection and takes a slot only
// on a strictly greater score, so the lowest slot wins a tie and a node
// with no ok slot keeps its selection, as the plain loop does.  The new
// selection goes to a fresh output.
//
// Arithmetic is float32 multiplies, adds, a max and logf, compiled without
// fast math and with --fmad=false, so the noise and the winners are
// bitwise those of the plain version on the card.
//
// Bound: not bytes.  The function reads each slot's ok flag, each road's
// road_order entry, each node's selection, and the destination of each
// slot that takes the lead, and writes N selections: at the million grid
// (N = 97,792, KC = 4) at least 1.5 MB, 0.45 us at 3.35 TB/s.  Each ok
// slot does one threefry block (~117 integer operations) and two logf:
// 323,592 slots there, ~38 M integer operations.  The tables are
// slot-major [KC, N], so the threads of a warp read neighbouring bytes of
// each slot row.  Measured on an NVIDIA H100 80GB HBM3 (700 W), plain,
// kernel, kernel, plain (chip_smoke.py's phases 22 and 26 time it on the
// million grid's and the city's captured states): 4.3 us of device time a
// call on that grid and on the city9k network (N = 37,508, KC = 7, 82,097
// ok slots) alike, so the launch and one thread's chain of dependent
// threefry blocks set it, not the integer rate; against 413-419 us in 209
// launches (grid) and 386-387 us in 226 (city) for the plain version.  A
// call costs 37-62 us of host time, the plain version's 2.9-4.7 ms.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void rc_choice_kernel(const unsigned char* __restrict__ ok,
                                 const int* __restrict__ dst,
                                 const int* __restrict__ road_order,
                                 const int* __restrict__ sel_in, uint32_t k1,
                                 uint32_t k2, int n, int r, int kc,
                                 int renumbered, int* __restrict__ sel_out) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= n) return;
  const uint32_t canon =
      static_cast<uint32_t>((renumbered && v < r) ? road_order[v] : v);
  float best = -CUDART_INF_F;
  int sel = sel_in[v];
  for (int k = 0; k < kc; ++k) {
    const long long idx = static_cast<long long>(k) * n + v;
    if (!ok[idx]) continue;               // score -inf: never wins
    const uint64_t q = static_cast<uint64_t>(k) * static_cast<uint64_t>(n)
                       + canon;
    const float s = tarl::gumbel_from_bits(tarl::threefry_bits(k1, k2, q));
    if (s > best) {
      best = s;
      sel = dst[idx];
    }
  }
  sel_out[v] = sel;
}

}  // namespace

extern "C" int tarl_random_choice(const unsigned char* ok, const int* dst,
                                  const int* road_order, const int* sel_in,
                                  uint32_t k1, uint32_t k2, int n, int r,
                                  int kc, int renumbered, int* sel_out,
                                  void* stream) {
  if (n == 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  rc_choice_kernel<<<blocks, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      ok, dst, road_order, sel_in, k1, k2, n, r, kc, renumbered, sel_out);
  return static_cast<int>(cudaGetLastError());
}
