// Bellman-Ford relaxation and the next-road argmin on the primal
// (intersection) graph, for the shortest-path routing refresh.
//
// Replaces tarl_tpu/routing/bellman_ford.py::_multisweep_nr_kernel_body
// (K2: capped warm-started sweeps plus the next-road epilogue, one Pallas
// launch per refresh).  The same kernels compute the functions of the
// reference's other relax kernels: the row-blocked K2
// (_multisweep_nr_rb_kernel_body, K3), the relax without the epilogue
// (_multisweep_kernel_body, K4; row-blocked _multisweep_rb_kernel_body,
// K5) and the single dynamic-shift sweep (_sweep_kernel_body, K6).  The
// TPU kernels turned row gathers into sublane rotations (delta buckets, a
// coordinate row permutation, per-bucket representative road tables) to
// fit VMEM; none of that is needed here.  The kernels read the out-slot
// tables directly, which is the gather form the reference's own fallback
// (_primal_relax's gather sweep and primal_next_roads) evaluates.
//
// The function, per destination column d and intersection row i:
//   new[i,d] = min(dist[i,d], min over k of
//                  w[i,k] + dist[road_to[out_road[i,k]], d])
// with w[i,k] = cost[out_road[i,k]] where out_ok[i,k], else BIG (invalid
// slots are included with weight BIG, exactly as the plain version writes
// it, so no bound on the inputs is assumed), in Jacobi sweeps: each sweep
// reads the previous table.  An in-place (Gauss-Seidel) sweep would
// converge faster and give a different capped table.  Then the next road:
// ascending k, strict <, from best = BIG; the road id as float where
// best < BIG, else -1 (the (value, slot rank) tie-break of the TPU
// epilogue).
//
// pr_resident_kernel, one launch for the whole relax and its next-road
// pass (tarl_primal_resident).  Columns are independent (new[i,d] reads
// only column d), so block b owns the column tile [b*C, b*C + C), C = 8,
// across all I rows and keeps it in shared memory, column-major
// (tile[c*S + i], S = round_up(I, 32) + 4 so that a warp's 32 lanes fall
// on 32 banks): 128 KB at I = 4,096.  It loads the tile once, runs every
// sweep on it, and stops at the first sweep that lowers nothing in the
// tile (__syncthreads_or): min-plus relaxation is idempotent at its
// fixpoint, so the table is bitwise the one all the capped sweeps give,
// and the uncapped relax (up to I - 1 sweeps) needs no host read.  This is
// the TPU kernel's per-tile while_loop.  The next-road pass runs on the
// resident final tile, and the distances and next roads are written once
// each.
//   A thread owns whole rows (tid, tid + T, ...; at most 4 of 1,024
// threads): a warp takes 32 consecutive rows of one column, so a grid's
// successors (i +- 1, i +- cols) fall in distinct banks, and each row's
// slot tables (succ, w), loaded once into registers, serve every column
// and sweep.  One buffer: each sweep's new values are held in registers
// across a barrier, two columns at a time (the columns are independent, so
// writing one group back cannot disturb the next group's reads), which is
// Jacobi; Gauss-Seidel would give another capped table.  Device memory is
// read and written in whole 32-byte rows of the tile (two float4 a row,
// eight loads in flight a thread); a column tail (D not a multiple of 8, or
// D < 8) is masked, never padded.  TMA and wgmma have nothing to do here:
// the tile is loaded once, and the arithmetic is min-plus on the CUDA
// cores.
//   Where it runs (bellman_ford.resident_plan, by shape): at most 4,096
// rows of at most 4 slots, so that the tables stay in registers, and at
// least two sweeps (or uncapped).  Past 4,096 rows a block would reread
// its slot tables from L2 on every sweep for only one or two columns
// (the tile no longer fits eight), which was slower on the card than the
// global form's passes, whose table fits in the 50 MB L2 at Grid128x128;
// and a single sweep costs the global form one pass, less than the
// resident form's whole-tile load and store (scripts/time_k1_k9.py times
// both forms at the sp row's shape).
//
// pr_sweep_kernel and pr_next_road_kernel, the global form: one thread per
// (i, d), d fastest, one launch per sweep through device memory, then a
// launch of the next-road pass; when asked, the last sweep of a call sets
// a device flag if any entry dropped (the wrapper's convergence test for
// the uncapped relax).  It serves every other shape, e.g. Grid128x128 and
// Grid256x256 (the TPU's row-blocked K3/K5 sizes) and a single sweep (K6);
// pr_next_road_kernel alone also serves primal_next_roads after the host's
// Dijkstra.
//
// Arithmetic is float32 adds and compares only, built without fast math
// and without FMA contraction, so results equal the PyTorch plain version
// (tarl_tpu_torch/routing/bellman_ford.py::primal_relax_next_roads_plain)
// bit for bit.
//
// Bound: memory bandwidth.  At Grid64x64 (I = D = 4,096, K = 4) the warm
// start is 4096^2 x 4 B = 64 MiB, read once; the distances and next roads
// are written once: 192 MiB, 0.060 ms at the data sheet's 3.35 TB/s.  The
// global form moves the table through device memory on every sweep; the
// resident form moves it once and runs its sweeps on shared memory.
// Measured with scripts/time_k1_k9.py on an NVIDIA H100 80GB HBM3 (700 W)
// from a random-cost warm start at that shape: the resident form 0.574 ms
// of device time for 8 sweeps and the next roads in one kernel (0.503 ms
// relax only), against the global form's 1.428 ms in 9 kernels (1.276 ms
// in 8); at one sweep 0.263 ms against 0.159 ms, hence the global form
// there.  The resident form is still 9.5x its bound: its sweeps run at
// ~35 us each (one block of 1,024 threads an SM, held values and tables
// filling the 64 registers a thread may have), and its tile's load and
// store take ~0.25 ms, each block reading 32 bytes of every row.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr float kBig = 1e18f;  // bellman_ford.BIG, the float32 of 1e18
constexpr int kThreads = 256;
// The resident form: kResThreads threads a block, each owning at most
// kCachedRows rows of at most kRegSlots slots (so I <= 4,096), a tile of
// at most kMaxCols columns, and each sweep's new values held kGroupCols at
// a time.  Mirrored by tarl_tpu_torch/routing/bellman_ford.py
// (resident_plan).
constexpr int kResThreads = 1024;
constexpr int kCachedRows = 4;
constexpr int kRegSlots = 4;
constexpr int kMaxCols = 8;

// Columns whose new values a thread of RPT rows holds across a barrier:
// the held values and the cached tables share the 64 registers a thread
// of 1024 may have.
template <int RPT>
constexpr int kGroupCols = RPT >= kCachedRows ? 2 : 4;

// Slot k of row i: the weight of its road (BIG where the slot is padding)
// and the row the road leads to.
__device__ __forceinline__ void load_slot(
    const float* __restrict__ cost, const int* __restrict__ out_road,
    const unsigned char* __restrict__ out_ok,
    const int* __restrict__ road_to, int slot, float& w, int& succ) {
  const int r = out_road[slot];
  w = out_ok[slot] ? cost[r] : kBig;
  succ = road_to[r];
}

// Slot (w, s) into the running minima of n columns of row i, column c at
// col[c * S + i]: the plain version's torch.minimum in slot order, with
// `lowered` set where a value drops.
template <int N>
__device__ __forceinline__ void relax_slot(const float* col, int S, int n,
                                           float w, int s, float (&best)[N],
                                           bool& lowered) {
#pragma unroll
  for (int c = 0; c < N; ++c) {
    if (c < n) {
      const float cand = w + col[c * S + s];
      if (cand < best[c]) {
        best[c] = cand;
        lowered = true;
      }
    }
  }
}

// Slot (w, s) of road r into the next-road pass of n columns of row i
// (ascending slot, strict <, from best = BIG).
template <int N>
__device__ __forceinline__ void road_slot(const float* col, int S, int n,
                                          float w, int s, int r,
                                          float (&best)[N],
                                          float (&road)[N]) {
#pragma unroll
  for (int c = 0; c < N; ++c) {
    if (c < n) {
      const float cand = w + col[c * S + s];
      if (cand < best[c]) {
        best[c] = cand;
        road[c] = static_cast<float>(r);
      }
    }
  }
}

// The tile and device memory, coalesced and with many loads in flight:
// consecutive threads take consecutive pieces of a row, so a warp moves
// whole 32-byte sectors at C = 8, and each thread has kInFlight loads
// outstanding before it writes any to shared memory.  Full aligned tiles
// move as float4 (two a row), the rest as floats.  In shared memory column
// c of the tile is tile[c * S + i], and S = 4 (mod 32) keeps a warp's
// lanes on distinct banks.
constexpr int kInFlight = 8;

__device__ __forceinline__ bool vector_tile(const float* g, int D, int d0,
                                            int C, int cw) {
  return C == 8 && cw == 8 && D % 4 == 0 &&
         (reinterpret_cast<uintptr_t>(g + d0) & 15) == 0;
}

__device__ __forceinline__ void load_tile(const float* __restrict__ g,
                                          float* tile, int I, int D, int d0,
                                          int C, int cw, int S) {
  const int T = blockDim.x;
  if (vector_tile(g, D, d0, C, cw)) {
    const int n = 2 * I;  // float4 pieces: row e / 2, columns 4 * (e % 2)
    for (int e0 = threadIdx.x; e0 < n; e0 += kInFlight * T) {
      float4 v[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int e = e0 + u * T;
        if (e < n) {
          v[u] = __ldg(reinterpret_cast<const float4*>(
              g + static_cast<size_t>(e >> 1) * D + d0 + 4 * (e & 1)));
        }
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int e = e0 + u * T;
        if (e < n) {
          float* t = tile + 4 * (e & 1) * S + (e >> 1);
          t[0] = v[u].x;
          t[S] = v[u].y;
          t[2 * S] = v[u].z;
          t[3 * S] = v[u].w;
        }
      }
    }
    return;
  }
  const int n = I * C;
  for (int e0 = threadIdx.x; e0 < n; e0 += kInFlight * T) {
    float v[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int e = e0 + u * T;
      const int i = e / C;
      const int c = e - i * C;
      if (e < n && c < cw) v[u] = g[static_cast<size_t>(i) * D + d0 + c];
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int e = e0 + u * T;
      const int i = e / C;
      const int c = e - i * C;
      if (e < n && c < cw) tile[c * S + i] = v[u];
    }
  }
}

__device__ __forceinline__ void store_tile(const float* tile,
                                           float* __restrict__ g, int I,
                                           int D, int d0, int C, int cw,
                                           int S) {
  const int T = blockDim.x;
  if (vector_tile(g, D, d0, C, cw)) {
    for (int e = threadIdx.x; e < 2 * I; e += T) {
      const float* t = tile + 4 * (e & 1) * S + (e >> 1);
      *reinterpret_cast<float4*>(g + static_cast<size_t>(e >> 1) * D + d0 +
                                 4 * (e & 1)) =
          make_float4(t[0], t[S], t[2 * S], t[3 * S]);
    }
    return;
  }
  for (int e = threadIdx.x; e < I * C; e += T) {
    const int i = e / C;
    const int c = e - i * C;
    if (c < cw) g[static_cast<size_t>(i) * D + d0 + c] = tile[c * S + i];
  }
}

// Each thread owns at most RPT rows (tid + j * blockDim.x) and keeps their
// slot tables in registers.  One tile buffer: each sweep's new values are
// held in registers across a barrier, kGroupCols columns at a time (the
// columns are independent, so a group's write-back cannot disturb the next
// group's reads).
template <int RPT>
__global__ void __launch_bounds__(kResThreads, 1)
    pr_resident_kernel(const float* __restrict__ dist0,
                       float* __restrict__ dist_out,
                       float* __restrict__ road_out,
                       const float* __restrict__ cost,
                       const int* __restrict__ out_road,
                       const unsigned char* __restrict__ out_ok,
                       const int* __restrict__ road_to, int I, int D, int K,
                       int C, int S, int max_sweeps) {
  constexpr int kGroup = kGroupCols<RPT>;
  extern __shared__ float tile[];
  const int d0 = blockIdx.x * C;
  const int cw = min(C, D - d0);
  const int T = blockDim.x;
  const int tid = threadIdx.x;

  float w[RPT][kRegSlots];
  int succ[RPT][kRegSlots];
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const int i = tid + j * T;
#pragma unroll
    for (int k = 0; k < kRegSlots; ++k) {
      w[j][k] = kBig;
      succ[j][k] = 0;
      if (i < I && k < K) {
        load_slot(cost, out_road, out_ok, road_to, i * K + k, w[j][k],
                  succ[j][k]);
      }
    }
  }
  load_tile(dist0, tile, I, D, d0, C, cw, S);
  __syncthreads();

  for (int sweep = 0; sweep < max_sweeps; ++sweep) {
    bool lowered = false;
    int any = 0;
    for (int g0 = 0; g0 < cw; g0 += kGroup) {
      const int gw = min(kGroup, cw - g0);
      float* col = tile + g0 * S;
      float held[RPT][kGroup];
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const int i = tid + j * T;
#pragma unroll
        for (int c = 0; c < kGroup; ++c) {
          held[j][c] = (i < I && c < gw) ? col[c * S + i] : 0.0f;
        }
        if (i < I) {
#pragma unroll
          for (int k = 0; k < kRegSlots; ++k) {
            if (k < K) relax_slot(col, S, gw, w[j][k], succ[j][k], held[j],
                                  lowered);
          }
        }
      }
      // Every thread has read this group's columns.
      if (g0 + kGroup >= cw) {
        any = __syncthreads_or(lowered);
      } else {
        __syncthreads();
      }
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const int i = tid + j * T;
#pragma unroll
        for (int c = 0; c < kGroup; ++c) {
          if (i < I && c < gw) col[c * S + i] = held[j][c];
        }
      }
    }
    __syncthreads();  // the write-back before the next sweep's reads
    if (!any) break;  // a fixpoint: the remaining sweeps change nothing
  }

  store_tile(tile, dist_out, I, D, d0, C, cw, S);
  if (road_out == nullptr) return;
  // The next roads of a row from the resident final tile, written by its
  // thread straight to device memory, four columns at a time (one float4
  // of the row's 32 bytes at C = 8): no barrier and no staging.
  const bool vec = vector_tile(road_out, D, d0, C, cw);
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const int i = tid + j * T;
    if (i >= I) continue;
    float* g = road_out + static_cast<size_t>(i) * D + d0;
    for (int g0 = 0; g0 < cw; g0 += 4) {
      const int gw = min(4, cw - g0);
      float best[4];
      float road[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        best[c] = kBig;
        road[c] = -1.0f;
      }
#pragma unroll
      for (int k = 0; k < kRegSlots; ++k) {
        if (k < K) road_slot(tile + g0 * S, S, gw, w[j][k], succ[j][k],
                             out_road[i * K + k], best, road);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (!(best[c] < kBig)) road[c] = -1.0f;
      }
      if (vec) {
        *reinterpret_cast<float4*>(g + g0) =
            make_float4(road[0], road[1], road[2], road[3]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (c < gw) g[g0 + c] = road[c];
        }
      }
    }
  }
}

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

template <int RPT>
int launch_resident(const float* dist0, float* dist_out, float* road_out,
                    const float* cost, const int* out_road,
                    const unsigned char* out_ok, const int* road_to, int I,
                    int D, int K, int C, int S, int max_sweeps, int threads,
                    size_t smem, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      pr_resident_kernel<RPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned int blocks = static_cast<unsigned int>((D + C - 1) / C);
  pr_resident_kernel<RPT><<<blocks, threads, smem, s>>>(
      dist0, dist_out, road_out, cost, out_road, out_ok, road_to, I, D, K, C,
      S, max_sweeps);
  return static_cast<int>(cudaGetLastError());
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

// The resident form: up to `max_sweeps` Jacobi sweeps from dist0 with a
// per-tile early exit, then (road_out non-null) the next-road pass, in one
// launch of ceil(D / C) blocks of C columns; dist_out and road_out are
// written in full and must differ from dist0.  Takes I <= kResThreads *
// kCachedRows rows of K <= kRegSlots slots and 1 <= C <= kMaxCols columns
// (bellman_ford.resident_plan; cudaErrorInvalidValue otherwise).  Returns
// the first CUDA error, or 0.
extern "C" int tarl_primal_resident(
    const float* dist0, float* dist_out, float* road_out, const float* cost,
    const int* out_road, const unsigned char* out_ok, const int* road_to,
    int I, int D, int K, int C, int max_sweeps, void* stream) {
  if (I > kResThreads * kCachedRows || K > kRegSlots || C < 1 ||
      C > kMaxCols) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (I == 0 || D == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int S = (I + 31) / 32 * 32 + 4;
  const size_t smem = static_cast<size_t>(C) * S * sizeof(float);
  const int threads = std::min(kResThreads, (I + 31) / 32 * 32);
  const int rows = (I + threads - 1) / threads;
  if (rows <= 1)
    return launch_resident<1>(dist0, dist_out, road_out, cost, out_road,
                              out_ok, road_to, I, D, K, C, S, max_sweeps,
                              threads, smem, s);
  if (rows <= 2)
    return launch_resident<2>(dist0, dist_out, road_out, cost, out_road,
                              out_ok, road_to, I, D, K, C, S, max_sweeps,
                              threads, smem, s);
  return launch_resident<4>(dist0, dist_out, road_out, cost, out_road,
                            out_ok, road_to, I, D, K, C, S, max_sweeps,
                            threads, smem, s);
}
