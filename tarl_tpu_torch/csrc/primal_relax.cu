// Bellman-Ford relaxation and the next-road argmin on the primal
// (intersection) graph, for the shortest-path routing refresh.
//
// Replaces tarl_tpu/routing/bellman_ford.py::_multisweep_nr_kernel_body
// (K2: capped warm-started sweeps plus the next-road epilogue, one Pallas
// launch per refresh).  The same two kernels compute the functions of the
// reference's other relax kernels: the row-blocked K2
// (_multisweep_nr_rb_kernel_body, K3), the relax without the epilogue
// (_multisweep_kernel_body, K4; row-blocked _multisweep_rb_kernel_body,
// K5) and the single dynamic-shift sweep (_sweep_kernel_body, K6).  The
// TPU kernels turned row gathers into sublane rotations (delta buckets, a
// coordinate row permutation, per-bucket representative road tables) to
// fit VMEM; none of that is needed here.  Both kernels read the out-slot
// tables directly, which is the gather form the reference's own fallback
// (_primal_relax's gather sweep and primal_next_roads) evaluates.
//
//   pr_sweep_kernel, one thread per (i, d), d fastest so that a warp reads
//     consecutive columns of one row:
//       new[i,d] = min(dist[i,d], min over k of
//                      w[i,k] + dist[road_to[out_road[i,k]], d])
//     with w[i,k] = cost[out_road[i,k]] where out_ok[i,k], else BIG.
//     Invalid slots are included with weight BIG, exactly as the plain
//     version writes it, so no bound on the inputs is assumed.  Jacobi:
//     each sweep reads the previous table and writes the other of two
//     buffers.  An in-place (Gauss-Seidel) sweep would converge faster
//     and give a different capped table.  When asked, the last sweep of
//     a call sets a device flag if any entry dropped (the wrapper's
//     convergence test for the uncapped relax).
//   pr_next_road_kernel, one thread per (i, d): ascending k, strict <,
//     from best = BIG; the road id as float where best < BIG, else -1.
//     The ascending-slot strict-< loop is the (value, slot rank) tie-break
//     the TPU epilogue reproduced.
//
// Arithmetic is float32 adds and compares only, built without fast math
// and without FMA contraction, so results equal the PyTorch plain version
// (tarl_tpu_torch/routing/bellman_ford.py::primal_relax_next_roads_plain)
// bit for bit.
//
// Bound: memory bandwidth.  At Grid64x64 (I = D = 4096, K = 4) the table
// is 4096^2 x 4 B = 64 MiB.  Each sweep reads it K + 1 = 5 times (with row
// reuse in the 50 MB L2) and writes it once: roughly 0.1 ms a sweep at the
// data sheet's 3.35 TB/s, an estimate, not a measurement.  This simple
// form does nothing about that bound yet: every sweep is a launch that
// goes through device memory.  The design that would: a block owning a
// column tile of all I rows in shared memory (4 columns x 2 buffers x
// 4096 rows x 4 B = 128 KB of the 227 KB), running every sweep without
// leaving the SM, with a per-tile early exit, and the next-road pass on
// the resident tile.

#include <cuda_runtime.h>

namespace {

constexpr float kBig = 1e18f;  // bellman_ford.BIG, the float32 of 1e18
constexpr int kThreads = 256;

__global__ void pr_sweep_kernel(
    const float* __restrict__ src, float* __restrict__ dst,
    const float* __restrict__ cost, const int* __restrict__ out_road,
    const unsigned char* __restrict__ out_ok,
    const int* __restrict__ road_to, int I, int D, int K,
    int* __restrict__ changed) {
  const long long n = static_cast<long long>(I) * D;
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  bool lowered = false;
  if (t < n) {
    const int i = static_cast<int>(t / D);
    const int d = static_cast<int>(t - static_cast<long long>(i) * D);
    const float old = src[t];
    float best = old;
    for (int k = 0; k < K; ++k) {
      const int slot = i * K + k;
      const int r = out_road[slot];
      const float w = out_ok[slot] ? cost[r] : kBig;
      const float cand =
          w + src[static_cast<long long>(road_to[r]) * D + d];
      best = fminf(best, cand);
    }
    dst[t] = best;
    lowered = best < old;
  }
  // Every thread of the warp reaches the vote: none returned early.
  if (changed != nullptr && __any_sync(0xffffffffu, lowered) &&
      (threadIdx.x & 31) == 0) {
    *changed = 1;
  }
}

__global__ void pr_next_road_kernel(
    const float* __restrict__ dist, const float* __restrict__ cost,
    const int* __restrict__ out_road,
    const unsigned char* __restrict__ out_ok,
    const int* __restrict__ road_to, int I, int D, int K,
    float* __restrict__ road_out) {
  const long long n = static_cast<long long>(I) * D;
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const int i = static_cast<int>(t / D);
  const int d = static_cast<int>(t - static_cast<long long>(i) * D);
  float best = kBig;
  float road = -1.0f;
  for (int k = 0; k < K; ++k) {
    const int slot = i * K + k;
    const int r = out_road[slot];
    const float w = out_ok[slot] ? cost[r] : kBig;
    const float cand = w + dist[static_cast<long long>(road_to[r]) * D + d];
    if (cand < best) {
      best = cand;
      road = static_cast<float>(r);
    }
  }
  road_out[t] = best < kBig ? road : -1.0f;
}

unsigned int num_blocks(int I, int D) {
  const long long n = static_cast<long long>(I) * D;
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

}  // namespace

// `sweeps` Jacobi sweeps from `src`: sweep s writes buf_a for even s and
// buf_b for odd s, reading the previous sweep's buffer (src for s = 0), so
// the result is in buf_a when `sweeps` is odd and in buf_b when it is
// even.  buf_a must differ from src; buf_b may be src.  With `changed`
// non-null, it is zeroed before the last sweep, which sets it to 1 if any
// entry dropped.  Returns the first CUDA error, or 0.
extern "C" int tarl_primal_sweeps(
    const float* src, float* buf_a, float* buf_b, const float* cost,
    const int* out_road, const unsigned char* out_ok, const int* road_to,
    int I, int D, int K, int sweeps, int* changed, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned int blocks = num_blocks(I, D);
  const float* in = src;
  for (int sweep = 0; sweep < sweeps; ++sweep) {
    float* out = (sweep % 2 == 0) ? buf_a : buf_b;
    int* flag = nullptr;
    if (changed != nullptr && sweep == sweeps - 1) {
      cudaError_t err = cudaMemsetAsync(changed, 0, sizeof(int), s);
      if (err != cudaSuccess) return static_cast<int>(err);
      flag = changed;
    }
    pr_sweep_kernel<<<blocks, kThreads, 0, s>>>(
        in, out, cost, out_road, out_ok, road_to, I, D, K, flag);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    in = out;
  }
  return 0;
}

extern "C" int tarl_primal_next_road(
    const float* dist, const float* cost, const int* out_road,
    const unsigned char* out_ok, const int* road_to, int I, int D, int K,
    float* road_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  pr_next_road_kernel<<<num_blocks(I, D), kThreads, 0, s>>>(
      dist, cost, out_road, out_ok, road_to, I, D, K, road_out);
  return static_cast<int>(cudaGetLastError());
}
