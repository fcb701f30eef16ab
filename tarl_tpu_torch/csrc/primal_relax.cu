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
// least two sweeps (or uncapped).  Past 4,096 rows one block's shared
// memory no longer holds the tile of 8 columns (narrower tiles there
// reread the slot tables from L2 on every sweep, slower than the global
// form), and a single sweep costs the global form one pass, less than the
// resident form's whole-tile load and store.
//
// pr_cluster_kernel, the cluster form (tarl_primal_cluster; replaces the
// row-blocked K3, _multisweep_nr_rb_kernel_body, and K5,
// _multisweep_rb_kernel_body): the resident form's tile spread over a
// thread-block cluster.  Cluster y of B blocks (B a power of two, 2-16;
// past 8 the card's non-portable cluster size) owns the column tile [y*C,
// y*C + C), C <= 7, of all I rows; block rank b keeps rows [b*R, b*R +
// R), R = ceil(I / B) <= 4,096, in its shared memory, laid out as the
// resident form's tile.  A thread owns whole rows of its block, and each slot's
// weight and its successor's shared::cluster address (mapa) sit in
// registers, so a successor's value is one ld.shared::cluster wherever its
// row lies: the TPU's row windows needed an order of small bandwidth,
// which the port's Grid128x128 lacks (successors up to 16,000 rows away,
// cyclic bandwidth 4,992, 28 distinct offsets).  Jacobi: a group's new
// values are held in registers across a cluster barrier (every block has
// read the group) before they are written back, and a cluster barrier
// ends the sweep; a second buffer would not fit beside a tile of 4,096
// rows.  The early exit is the tile's: each block's __syncthreads_or goes
// into rank 0's flag word for the sweep (two words, alternating, each
// cleared a sweep ahead), read by every block after the last group's
// barrier, so all blocks leave at the same sweep; the uncapped relax is
// one launch with no host read.  The next roads are computed from the
// final tile through DSMEM, staged in a second tile in shared memory (two
// tiles of 7 columns fit at R = 4,096, hence C <= 7) and stored in whole
// rows of the tile.  A last cluster barrier keeps every block's shared
// memory alive while others may read it.  Where it runs
// (bellman_ford.cluster_plan): 4,096 < I <= 65,536 rows of at most 4
// slots, at least two sweeps or uncapped; bellman_ford.launch_cluster_plan
// narrows C so that the tiles fill the last wave of the clusters the card
// holds at once (cudaOccupancyMaxActiveClusters: 30 clusters of 4 on the
// H100; it raises where the card holds none).
//
// pr_global_kernel, the global form (tarl_primal_global; replaces K6,
// _sweep_kernel_body, the single dynamic-shift sweep): every other shape,
// a single sweep, more than 4 slots, more than 65,536 rows; the radial
// metro's zoned tables (K = 8) on the main path.  One cooperative launch a
// call, whatever the sweeps: as many blocks as the card holds at once
// (bellman_ford._global_fit asks cudaOccupancyMaxActiveBlocksPerMultiprocessor
// once per card), each thread taking the same (row, group of 4 columns)
// items in every pass, float4 where the rows allow it.  A prologue compacts
// each row's slots into (successor, weight) words and road ids, dropping a
// padding slot whose road repeats an earlier padding slot of the row
// (build_network pads with road 0, so a padded row keeps one padding term:
// 4-5 slots in place of 8 on the radial); the slot words are loaded once
// per item, not once per slot and column.  The sweeps ping-pong between
// dist_out and a scratch table in device memory (L2: the radial's table
// is 4.2 MB of the card's 50 MB) with a grid barrier of its own (a
// counter and a generation word, release and acquire at gpu scope, no
// relocatable device code) between sweeps; the early exit is a device
// flag read after each barrier, so every block leaves at the same sweep and
// the uncapped relax makes no host read.  The next-road pass runs in the
// same launch.  pr_next_road_kernel, a thread per (i, d), serves
// primal_next_roads after the host's Dijkstra.

// Arithmetic is float32 adds and compares only, built without fast math
// and without FMA contraction, so results equal the PyTorch plain version
// (tarl_tpu_torch/routing/bellman_ford.py::primal_relax_next_roads_plain)
// bit for bit.
//
// Bound: memory bandwidth.  At Grid64x64 (I = D = 4,096, K = 4) the warm
// start is 4096^2 x 4 B = 64 MiB, read once; the distances and next roads
// are written once: 192 MiB, 0.060 ms at the data sheet's 3.35 TB/s; at
// the million-agent row (I = 16,384, D = 257) 48 MiB, 0.0153 ms; at the
// radial metro's (I = 8,193, D = 154, K = 8) 12.9 MB, 0.0047 ms.  The
// global form moves the table through L2 or device memory on every
// sweep; the resident and cluster forms move it once and run their sweeps
// on shared memory.  Measured with scripts/time_k1_k9.py on an NVIDIA
// H100 80GB HBM3 (700 W), device time.  The global form in one launch at
// the radial shape: ~7.3-7.9 us a sweep (the parent's launch a sweep
// ~14.9 us), a refresh's 8 sweeps and next roads from its warm start
// 0.086-0.092 ms (0.133 ms in 9 launches), the uncapped table init 1.30-
// 1.41 ms (2.87-2.89 ms in 266 launches and memsets); one sweep at
// I = D = 4,096 0.066 ms (0.160 ms).  Tried and slower there: ld.global.cg
// in place of L1-cached loads (14-17 us a sweep: the successor rows'
// reuse is in L1), every other sweep through dist_out's unaligned rows in
// scalar loads (D = 154: 37 us a sweep), slot chunks of 8 (spills at 64
// registers, or 2 blocks an SM of 256 threads: 0.103 ms at one sweep).
// Earlier, before the persistent launch: at Grid64x64 the resident form
// 0.574 ms for 8 sweeps and the next roads in one kernel (0.503 ms relax
// only), against the per-sweep global form's 1.428 ms in 9 kernels
// (1.276 ms in 8); at one sweep 0.263 ms against 0.159 ms, hence the
// global form there.  At Grid128x128 with 256 columns the cluster form
// (tiles of 5, two waves) 0.290 ms for 8 sweeps and the next roads
// (0.231 ms relax only) against the per-sweep global form's 0.349 ms
// (0.312 ms); at 512 columns (tiles of 6) 0.470 ms (0.380 ms) against
// 0.724 ms (0.644 ms).  Tried and slower: tiles of 8 at 256 columns (0.365 ms; 32 tiles
// leave 2 clusters alone in a second wave), the next roads stored by each
// row's thread at tiles of 5 (0.326 ms), and ld.shared in place of DSMEM
// for the rows of the block's own (0.323 ms; 97% of Grid128x128's reads
// stay in their block).  The cluster form is still 19x its bound: a
// sweep takes ~12 us a block at tiles of 5, and the kernel with 4 rows a
// thread spills ~200 bytes a thread at 64 registers.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace cg = cooperative_groups;

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
// The cluster form: a cluster of at most kMaxCluster blocks (a power of
// two; past 8 the card's non-portable cluster size), each holding at most
// kResThreads * kCachedRows rows of a tile of at most kClusterCols
// columns: the widest tile whose next roads' staging tile fits beside it
// at 4,096 rows.  Mirrored by bellman_ford.py (cluster_plan).
constexpr int kMaxCluster = 16;
constexpr int kClusterCols = 7;
// The shared memory a block may have (static and dynamic) on sm_90.
constexpr size_t kMaxSmem = 232448;
// The global form: kGlobalThreads threads a block, at least
// kGlobalBlocksPerSM blocks an SM (64 registers a thread), kSlotChunk
// slots' loads in flight at a time, and the barrier's state in
// kSyncWords 4-byte words: the arrival count and the generation on lines
// of their own, then three early-exit flags.  Mirrored by bellman_ford.py
// (GLOBAL_SYNC_WORDS).
constexpr int kGlobalThreads = 512;
constexpr int kGlobalBlocksPerSM = 2;
constexpr int kSlotChunk = 4;
constexpr int kSyncCount = 0;
constexpr int kSyncGen = 32;
constexpr int kSyncFlag = 64;
constexpr int kSyncWords = 96;

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

// --- the cluster form --------------------------------------------------------

// A shared-memory address of this block as a 32-bit shared::cta address.
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The shared::cluster address of the same offset in block `rank`'s shared
// memory (DSMEM).
__device__ __forceinline__ unsigned map_rank(unsigned addr, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

// Loads and stores through shared::cluster addresses.  Volatile with a
// memory clobber: the compiler must neither cache a value across a cluster
// barrier nor move an access over one.
__device__ __forceinline__ float ld_cluster(unsigned addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];"
               : "=f"(v)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned ld_cluster_u32(unsigned addr) {
  unsigned v;
  asm volatile("ld.shared::cluster.u32 %0, [%1];"
               : "=r"(v)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_cluster_u32(unsigned addr, unsigned v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;" ::"r"(addr), "r"(v)
               : "memory");
}

// The cluster form: cluster y of B blocks owns the column tile [y*C,
// y*C + C) for all I rows; block rank b keeps rows [b*R, b*R + R) of it
// in its shared memory (R = ceil(I / B), column-major with stride S, as
// the resident form keeps the whole tile).  A thread owns whole rows of
// its block, and their slot tables sit in registers: each slot's weight
// and its successor's shared::cluster address (the successor's row in
// the shared memory of the block that owns it, column 0 of the tile), so
// a read of any row costs one ld.shared::cluster wherever the row lies.
// Jacobi as in the resident form: a group's new values are held in
// registers across a cluster barrier (every block has read the group)
// before they are written back, and a cluster barrier ends the sweep.  The
// early exit is the tile's: each block ORs its __syncthreads_or into rank
// 0's flag word for the sweep (two words, alternating, each cleared by
// rank 0 a sweep ahead of its use), and every block reads it after the
// last group's barrier, so all blocks leave the loop at the same sweep.
template <int RPT>
__global__ void __launch_bounds__(kResThreads, 1)
    pr_cluster_kernel(const float* __restrict__ dist0,
                      float* __restrict__ dist_out,
                      float* __restrict__ road_out,
                      const float* __restrict__ cost,
                      const int* __restrict__ out_road,
                      const unsigned char* __restrict__ out_ok,
                      const int* __restrict__ road_to, int I, int D, int K,
                      int C, int S, int R, int max_sweeps) {
  constexpr int kGroup = kGroupCols<RPT>;
  extern __shared__ float tile[];
  __shared__ unsigned flags[2];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const int row0 = static_cast<int>(rank) * R;
  const int rows = max(0, min(R, I - row0));
  const int d0 = blockIdx.y * C;
  const int cw = min(C, D - d0);
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const unsigned col_bytes = static_cast<unsigned>(S) * sizeof(float);
  const unsigned tile_u32 = smem_u32(tile);

  float w[RPT][kRegSlots];
  unsigned src[RPT][kRegSlots];
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const int i = tid + j * T;
#pragma unroll
    for (int k = 0; k < kRegSlots; ++k) {
      w[j][k] = kBig;
      src[j][k] = 0;
      if (i < rows && k < K) {
        int succ;
        load_slot(cost, out_road, out_ok, road_to, (row0 + i) * K + k,
                  w[j][k], succ);
        const int owner = succ / R;
        src[j][k] = map_rank(
            tile_u32 + static_cast<unsigned>(succ - owner * R) * 4u,
            static_cast<unsigned>(owner));
      }
    }
  }
  if (rank == 0 && tid == 0) {
    flags[0] = 0;
    flags[1] = 0;
  }
  load_tile(dist0 + static_cast<size_t>(row0) * D, tile, rows, D, d0, C, cw,
            S);
  // Every block has started and loaded its rows before any remote read.
  cluster.sync();
  const unsigned flag0 = map_rank(smem_u32(flags), 0);

  for (int sweep = 0; sweep < max_sweeps; ++sweep) {
    // The next sweep's word: its last readers finished before the barrier
    // that ended the previous sweep, its writers start after this one's.
    if (rank == 0 && tid == 0) flags[(sweep + 1) & 1] = 0;
    const unsigned flag = flag0 + static_cast<unsigned>(sweep & 1) * 4u;
    bool lowered = false;
    unsigned any = 0;
    for (int g0 = 0; g0 < cw; g0 += kGroup) {
      const int gw = min(kGroup, cw - g0);
      float* col = tile + g0 * S;
      const unsigned goff = static_cast<unsigned>(g0) * col_bytes;
      float held[RPT][kGroup];
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const int i = tid + j * T;
#pragma unroll
        for (int c = 0; c < kGroup; ++c) {
          held[j][c] = (i < rows && c < gw) ? col[c * S + i] : 0.0f;
        }
        if (i < rows) {
          // Every load of the row first, then the minima: the loads are
          // in flight together.
          float v[kRegSlots][kGroup];
#pragma unroll
          for (int k = 0; k < kRegSlots; ++k) {
#pragma unroll
            for (int c = 0; c < kGroup; ++c) {
              v[k][c] = (k < K && c < gw)
                            ? ld_cluster(src[j][k] + goff + c * col_bytes)
                            : kBig;
            }
          }
#pragma unroll
          for (int k = 0; k < kRegSlots; ++k) {
#pragma unroll
            for (int c = 0; c < kGroup; ++c) {
              if (k < K && c < gw) {
                const float cand = w[j][k] + v[k][c];
                if (cand < held[j][c]) {
                  held[j][c] = cand;
                  lowered = true;
                }
              }
            }
          }
        }
      }
      if (g0 + kGroup >= cw) {
        if (__syncthreads_or(lowered) && tid == 0) st_cluster_u32(flag, 1u);
        cluster.sync();  // every block has read the group and set the flag
        any = ld_cluster_u32(flag);
      } else {
        cluster.sync();  // every block has read this group's columns
      }
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const int i = tid + j * T;
#pragma unroll
        for (int c = 0; c < kGroup; ++c) {
          if (i < rows && c < gw) col[c * S + i] = held[j][c];
        }
      }
    }
    cluster.sync();  // the write-back before the next sweep's reads
    if (!any) break;  // a fixpoint of the whole tile
  }

  store_tile(tile, dist_out + static_cast<size_t>(row0) * D, rows, D, d0, C,
             cw, S);
  if (road_out != nullptr) {
    // The next roads go to a second tile in shared memory and leave in
    // whole rows of the tile, as the distances do.
    float* staged = tile + C * S;
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const int i = tid + j * T;
      if (i >= rows) continue;
      float rid[kRegSlots];
#pragma unroll
      for (int k = 0; k < kRegSlots; ++k) {
        rid[k] = k < K ? static_cast<float>(out_road[(row0 + i) * K + k])
                       : -1.0f;
      }
      for (int g0 = 0; g0 < cw; g0 += 4) {
        const int gw = min(4, cw - g0);
        float best[4];
        float road[4];
        // Two columns of every slot in flight at a time: the slot tables
        // of every row stay live here, so four would not fit the
        // registers.
#pragma unroll
        for (int h = 0; h < 4; h += 2) {
          const unsigned goff = static_cast<unsigned>(g0 + h) * col_bytes;
          float v[kRegSlots][2];
#pragma unroll
          for (int k = 0; k < kRegSlots; ++k) {
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              v[k][c] = (k < K && h + c < gw)
                            ? ld_cluster(src[j][k] + goff + c * col_bytes)
                            : kBig;
            }
          }
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            best[h + c] = kBig;
            road[h + c] = -1.0f;
#pragma unroll
            for (int k = 0; k < kRegSlots; ++k) {
              const float cand = w[j][k] + v[k][c];
              if (k < K && cand < best[h + c]) {
                best[h + c] = cand;
                road[h + c] = rid[k];
              }
            }
          }
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (c < gw) staged[(g0 + c) * S + i] = best[c] < kBig ? road[c]
                                                                : -1.0f;
        }
      }
    }
    __syncthreads();
    store_tile(staged, road_out + static_cast<size_t>(row0) * D, rows, D, d0,
               C, cw, S);
  }
  // No block leaves while another may still read its shared memory.
  cluster.sync();
}

// --- the global form: one persistent launch --------------------------------

// Acquire and release at gpu scope, for the grid barrier.
__device__ __forceinline__ unsigned ld_relaxed(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ unsigned atom_add_acq_rel(unsigned* p,
                                                     unsigned v) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

__device__ __forceinline__ void red_release_add(unsigned* p, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// A barrier of the whole grid, which must be resident at once (a
// cooperative launch).  Every thread votes `lowered`; thread 0 of a block
// in which one did sets `flag_set` before it arrives; after the barrier
// every thread gets the value of `flag_get` (0 where it is null).  The
// last block to arrive resets the count and opens the next generation,
// the others spin on the generation: the arrival releases and the
// generation's read acquires at gpu scope, and the block barriers on either
// side carry that to every thread, so every write before the barrier is
// seen by every read after it.  The state is left as it was found (count
// 0), so the next launch on the stream reuses it.
__device__ unsigned grid_barrier(unsigned* sync, int lowered,
                                 unsigned* flag_set,
                                 const unsigned* flag_get) {
  __shared__ unsigned value;
  const int any = __syncthreads_or(lowered);
  if (threadIdx.x == 0) {
    if (any && flag_set != nullptr) st_relaxed(flag_set, 1u);
    unsigned* gen = sync + kSyncGen;
    const unsigned g = ld_relaxed(gen);
    if (atom_add_acq_rel(sync + kSyncCount, 1u) == gridDim.x - 1) {
      st_relaxed(sync + kSyncCount, 0u);
      red_release_add(gen, 1u);
    } else {
      while (ld_acquire(gen) == g) {
      }
    }
    value = flag_get == nullptr ? 0u : ld_relaxed(flag_get);
  }
  __syncthreads();
  return value;
}

// Four columns [c0, c0 + 4) of row i of a table with row stride `stride`:
// one float4 where `vec` (16-byte rows with room for the whole group),
// else the columns below D one by one and BIG past them.  Plain loads,
// cached in L1 (a row is read by its own items and its predecessors'):
// the grid barrier's acquire, carried to every thread by the block
// barrier, orders them after every write before the barrier (the PTX
// memory model), so a table written in the launch is never read stale.
// Never the read-only path (ld.global.nc), which the model exempts.
__device__ __forceinline__ float4 load_cols(const float* base, int stride,
                                            bool vec, int i, int c0,
                                            int D) {
  const float* p = base + static_cast<size_t>(i) * stride + c0;
  if (vec) return *reinterpret_cast<const float4*>(p);
  float4 v = make_float4(p[0], kBig, kBig, kBig);
  if (c0 + 1 < D) v.y = p[1];
  if (c0 + 2 < D) v.z = p[2];
  if (c0 + 3 < D) v.w = p[3];
  return v;
}

__device__ __forceinline__ void store_cols(float* base, int stride,
                                           bool vec, int i, int c0, int D,
                                           float4 v) {
  float* p = base + static_cast<size_t>(i) * stride + c0;
  if (vec) {
    *reinterpret_cast<float4*>(p) = v;
    return;
  }
  p[0] = v.x;
  if (c0 + 1 < D) p[1] = v.y;
  if (c0 + 2 < D) p[2] = v.z;
  if (c0 + 3 < D) p[3] = v.w;
}

// The slot's candidate w + v into the running minima of four columns.
__device__ __forceinline__ void relax_cols(float4& best, float w, float4 v) {
  float c = w + v.x;
  if (c < best.x) best.x = c;
  c = w + v.y;
  if (c < best.y) best.y = c;
  c = w + v.z;
  if (c < best.z) best.z = c;
  c = w + v.w;
  if (c < best.w) best.w = c;
}

// The candidate into the next-road pass of four columns (strict <).
__device__ __forceinline__ void road_cols(float4& best, float4& road,
                                          float w, float rid, float4 v) {
  float c = w + v.x;
  if (c < best.x) {
    best.x = c;
    road.x = rid;
  }
  c = w + v.y;
  if (c < best.y) {
    best.y = c;
    road.y = rid;
  }
  c = w + v.z;
  if (c < best.z) {
    best.z = c;
    road.z = rid;
  }
  c = w + v.w;
  if (c < best.w) {
    best.w = c;
    road.w = rid;
  }
}

// Whether any of the first n columns dropped.
__device__ __forceinline__ bool dropped(float4 b, float4 o, int n) {
  return b.x < o.x || (n > 1 && b.y < o.y) || (n > 2 && b.z < o.z) ||
         (n > 3 && b.w < o.w);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The global form in one launch.  Items are (row i, group of four columns
// [c0, c0 + 4)), the group fastest; each thread takes the items
// blockIdx.x * T + tid + k * gridDim.x * T, the same in every pass.
//   Prologue: each row's slots in ascending order as (successor, weight)
// words and road ids, a row's padding slot dropped where an earlier
// padding slot of the row has the same road (the same candidate again,
// which can neither lower a minimum nor win a strict <, so the result is
// the padded loop's for any table); a grid barrier.
//   Sweeps: sweep s reads the previous table (dist0 for s = 0) and writes
// one of two tables whose rows take float4, dist_out and `scratch` where
// D is a multiple of 4, else two scratch tables of row stride
// round_up(D, 4); the last capped sweep writes dist_out where it can.
// Each sweep ends in a grid barrier that carries its early-exit flag
// (three words in turn: sweep s sets word s % 3 and clears word (s + 1) %
// 3 for the next, whose last readers passed a barrier before); every
// block leaves at the first sweep that lowers nothing, whose table equals
// the one it read.  The barrier after the last capped sweep is skipped
// where that sweep wrote dist_out and no next roads follow.
//   Final pass: the final table copied to dist_out where it lies
// elsewhere, and (road_out non-null) the next roads from it, as the plain
// pass.
__global__ void __launch_bounds__(kGlobalThreads, kGlobalBlocksPerSM)
    pr_global_kernel(const float* __restrict__ dist0, float* dist_out,
                     float* __restrict__ road_out, float* scratch,
                     int* work, unsigned* sync,
                     const float* __restrict__ cost,
                     const int* __restrict__ out_road,
                     const unsigned char* __restrict__ out_ok,
                     const int* __restrict__ road_to, int I, int D, int K,
                     int max_sweeps) {
  const int G = (D + 3) / 4;
  const long long items = static_cast<long long>(I) * G;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t slots_n = static_cast<size_t>(I) * K;
  int2* slots = reinterpret_cast<int2*>(work);
  int* slot_road = work + 2 * slots_n;
  int* slot_count = slot_road + slots_n;
  unsigned* flags = sync + kSyncFlag;

  if (first == 0) st_relaxed(flags, 0u);
  for (long long i = first; i < I; i += step) {
    const size_t row = static_cast<size_t>(i) * K;
    int n = 0;
    for (int k = 0; k < K; ++k) {
      const int r = out_road[row + k];
      const bool ok = out_ok[row + k] != 0;
      bool repeat = false;
      for (int j = 0; j < k && !ok && !repeat; ++j) {
        repeat = !out_ok[row + j] && out_road[row + j] == r;
      }
      if (repeat) continue;
      slots[row + n] = make_int2(road_to[r], __float_as_int(ok ? cost[r]
                                                              : kBig));
      slot_road[row + n] = r;
      ++n;
    }
    slot_count[i] = n;
  }
  grid_barrier(sync, 0, nullptr, nullptr);

  // The sweeps ping-pong between two tables whose rows take float4:
  // dist_out and scratch where dist_out's rows do, else two scratch
  // tables.  Sweep s writes the first where max_sweeps - 1 - s is even,
  // so the last capped sweep writes dist_out where it can.
  const int Dp = 4 * G;
  const bool vec0 = D % 4 == 0 && aligned16(dist0);
  const bool vec_out = D % 4 == 0 && aligned16(dist_out);
  float* buf0 = vec_out ? dist_out : scratch;
  float* buf1 = vec_out ? scratch : scratch + static_cast<size_t>(I) * Dp;
  const int stride0 = vec_out ? D : Dp;
  const float* in = dist0;
  int in_stride = D;
  bool in_vec = vec0;
  for (int sweep = 0; sweep < max_sweeps; ++sweep) {
    const bool first_buf = ((max_sweeps - 1 - sweep) & 1) == 0;
    float* out = first_buf ? buf0 : buf1;
    const int out_stride = first_buf ? stride0 : Dp;
    if (first == 0) st_relaxed(flags + (sweep + 1) % 3, 0u);
    bool lowered = false;
    for (long long t = first; t < items; t += step) {
      const int i = static_cast<int>(t / G);
      const int c0 = 4 * static_cast<int>(t - static_cast<long long>(i) * G);
      const float4 old = load_cols(in, in_stride, in_vec, i, c0, D);
      float4 best = old;
      const int n = slot_count[i];
      const int2* sl = slots + static_cast<size_t>(i) * K;
      for (int j0 = 0; j0 < n; j0 += kSlotChunk) {
        // The chunk's slot words (loaded up to K, so that they need not
        // wait for the row's count), then its successor rows, in flight
        // together; the minima in slot order.
        int2 e[kSlotChunk];
        float4 v[kSlotChunk];
#pragma unroll
        for (int j = 0; j < kSlotChunk; ++j) {
          if (j0 + j < K) e[j] = sl[j0 + j];
        }
#pragma unroll
        for (int j = 0; j < kSlotChunk; ++j) {
          if (j0 + j < n) v[j] = load_cols(in, in_stride, in_vec, e[j].x,
                                           c0, D);
        }
#pragma unroll
        for (int j = 0; j < kSlotChunk; ++j) {
          if (j0 + j < n) relax_cols(best, __int_as_float(e[j].y), v[j]);
        }
      }
      lowered |= dropped(best, old, D - c0);
      store_cols(out, out_stride, true, i, c0, D, best);
    }
    // Nothing reads the table after the last capped sweep where it went
    // to dist_out and no next roads follow.
    const bool last = sweep == max_sweeps - 1 && road_out == nullptr &&
                      out == dist_out;
    const bool any = last || grid_barrier(sync, lowered, flags + sweep % 3,
                                          flags + sweep % 3) != 0;
    // At a fixpoint the table read equals the one written: keep dist_out
    // if it is either.
    if (any || in != dist_out) {
      in = out;
      in_stride = out_stride;
      in_vec = true;
    }
    if (!any || last) break;
  }
  // The final pass: the final table copied to dist_out where it lies
  // elsewhere (no sweep, a scratch table, an exit after a first sweep into
  // scratch), element by element so that a warp's stores are contiguous
  // whatever D, and the next roads from it.
  if (in != dist_out) {
    const long long n = static_cast<long long>(I) * D;
    for (long long e = first; e < n; e += step) {
      const long long i = e / D;
      dist_out[e] = in[i * in_stride + (e - i * D)];
    }
  }
  if (road_out == nullptr) return;
  const bool vec_road = D % 4 == 0 && aligned16(road_out);
  for (long long t = first; t < items; t += step) {
    const int i = static_cast<int>(t / G);
    const int c0 = 4 * static_cast<int>(t - static_cast<long long>(i) * G);
    float4 best = make_float4(kBig, kBig, kBig, kBig);
    float4 road = make_float4(-1.0f, -1.0f, -1.0f, -1.0f);
    const int n = slot_count[i];
    const size_t row = static_cast<size_t>(i) * K;
    for (int j0 = 0; j0 < n; j0 += kSlotChunk) {
      int2 e[kSlotChunk];
      float4 v[kSlotChunk];
#pragma unroll
      for (int j = 0; j < kSlotChunk; ++j) {
        if (j0 + j < K) e[j] = slots[row + j0 + j];
      }
#pragma unroll
      for (int j = 0; j < kSlotChunk; ++j) {
        if (j0 + j < n) v[j] = load_cols(in, in_stride, in_vec, e[j].x, c0,
                                         D);
      }
#pragma unroll
      for (int j = 0; j < kSlotChunk; ++j) {
        if (j0 + j < n) {
          road_cols(best, road, __int_as_float(e[j].y),
                    static_cast<float>(slot_road[row + j0 + j]), v[j]);
        }
      }
    }
    if (!(best.x < kBig)) road.x = -1.0f;
    if (!(best.y < kBig)) road.y = -1.0f;
    if (!(best.z < kBig)) road.z = -1.0f;
    if (!(best.w < kBig)) road.w = -1.0f;
    store_cols(road_out, D, vec_road, i, c0, D, road);
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

// The cluster form's launch (clusters of B blocks along x, one cluster a
// column tile along y), or with `fit` non-null the number of such clusters
// the card can hold at once (cudaOccupancyMaxActiveClusters) in place of
// the launch.
template <int RPT>
int launch_cluster(const float* dist0, float* dist_out, float* road_out,
                   const float* cost, const int* out_road,
                   const unsigned char* out_ok, const int* road_to, int I,
                   int D, int K, int C, int S, int R, int max_sweeps,
                   int threads, size_t smem, int B, cudaStream_t s,
                   int* fit) {
  auto kernel = pr_cluster_kernel<RPT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(B),
                        static_cast<unsigned>((D + C - 1) / C), 1);
  config.blockDim = dim3(static_cast<unsigned>(threads), 1, 1);
  config.dynamicSmemBytes = smem;
  config.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(B);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  if (fit != nullptr) {
    return static_cast<int>(
        cudaOccupancyMaxActiveClusters(fit, kernel, &config));
  }
  err = cudaLaunchKernelEx(&config, kernel, dist0, dist_out, road_out, cost,
                           out_road, out_ok, road_to, I, D, K, C, S, R,
                           max_sweeps);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The cluster form's shape: rows a block, its threads, its tile stride
// and shared memory (with `roads`, a second tile stages the next roads),
// and the rows a thread owns; false where the form does not take the
// shape.
bool cluster_shape(int I, int K, int C, int B, bool roads, int& R,
                   int& threads, int& S, size_t& smem, int& rpt) {
  if (B < 2 || B > kMaxCluster || (B & (B - 1)) != 0 || K > kRegSlots ||
      C < 1 || C > kClusterCols || I < 1) {
    return false;
  }
  R = (I + B - 1) / B;
  if (R > kResThreads * kCachedRows) return false;
  threads = std::min(kResThreads, (R + 31) / 32 * 32);
  S = (R + 31) / 32 * 32 + 4;
  smem = static_cast<size_t>(roads ? 2 : 1) * C * S * sizeof(float);
  rpt = (R + threads - 1) / threads;
  return smem + 2 * sizeof(unsigned) <= kMaxSmem;
}

int dispatch_cluster(const float* dist0, float* dist_out, float* road_out,
                     const float* cost, const int* out_road,
                     const unsigned char* out_ok, const int* road_to, int I,
                     int D, int K, int C, int B, int max_sweeps,
                     bool roads, cudaStream_t s, int* fit) {
  int R, threads, S, rpt;
  size_t smem;
  if (!cluster_shape(I, K, C, B, roads, R, threads, S, smem, rpt)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rpt <= 1)
    return launch_cluster<1>(dist0, dist_out, road_out, cost, out_road,
                             out_ok, road_to, I, D, K, C, S, R, max_sweeps,
                             threads, smem, B, s, fit);
  if (rpt <= 2)
    return launch_cluster<2>(dist0, dist_out, road_out, cost, out_road,
                             out_ok, road_to, I, D, K, C, S, R, max_sweeps,
                             threads, smem, B, s, fit);
  return launch_cluster<4>(dist0, dist_out, road_out, cost, out_road, out_ok,
                           road_to, I, D, K, C, S, R, max_sweeps, threads,
                           smem, B, s, fit);
}

}  // namespace

// The global form: up to `max_sweeps` Jacobi sweeps from dist0, stopping
// at the first that lowers nothing, then (road_out non-null) the next-road
// pass, in one cooperative launch of min(blocks, the blocks the items
// fill) blocks (`blocks` from tarl_primal_global_fit).  dist_out and
// road_out are written in full and must differ from dist0; `scratch` holds
// I * round_up(D, 4) floats where D is a multiple of 4 and dist_out is
// 16-byte aligned, else twice that; `work` I * (3 * K + 1) ints (8-byte
// aligned), and `sync` kSyncWords words, zero before the first launch on the stream
// and left so by every launch.  Returns the first CUDA error, or 0.
extern "C" int tarl_primal_global(
    const float* dist0, float* dist_out, float* road_out, float* scratch,
    int* work, unsigned* sync, const float* cost, const int* out_road,
    const unsigned char* out_ok, const int* road_to, int I, int D, int K,
    int max_sweeps, int blocks, void* stream) {
  if (I == 0 || D == 0) return 0;
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long items = static_cast<long long>(I) * ((D + 3) / 4);
  const long long fill = (items + kGlobalThreads - 1) / kGlobalThreads;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(std::min<long long>(blocks,
                                                                  fill)),
                        1, 1);
  config.blockDim = dim3(kGlobalThreads, 1, 1);
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &config, pr_global_kernel, dist0, dist_out, road_out, scratch, work,
      sync, cost, out_road, out_ok, road_to, I, D, K, max_sweeps);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The blocks of the global form that card `device` holds at once (its SMs
// times cudaOccupancyMaxActiveBlocksPerMultiprocessor), into *blocks; 0
// means it cannot schedule one.  The kernel's resources do not depend on
// the shape.  Returns the first CUDA error, or 0.
extern "C" int tarl_primal_global_fit(int device, int* blocks) {
  *blocks = 0;
  int sms = 0;
  int per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, pr_global_kernel, kGlobalThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  *blocks = sms * per_sm;
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

// The cluster form: up to `max_sweeps` Jacobi sweeps from dist0 with an
// early exit per column tile, then (road_out non-null) the next-road pass,
// in one launch of ceil(D / C) clusters of B blocks; dist_out and road_out
// are written in full and must differ from dist0.  Takes B a power of two
// in [2, kMaxCluster] with ceil(I / B) <= kResThreads * kCachedRows rows a
// block, K <= kRegSlots and 1 <= C <= kClusterCols
// (bellman_ford.cluster_plan; cudaErrorInvalidValue otherwise).  Returns
// the first CUDA error, or 0.
extern "C" int tarl_primal_cluster(
    const float* dist0, float* dist_out, float* road_out, const float* cost,
    const int* out_road, const unsigned char* out_ok, const int* road_to,
    int I, int D, int K, int C, int B, int max_sweeps, void* stream) {
  if (D == 0) return 0;
  return dispatch_cluster(dist0, dist_out, road_out, cost, out_road, out_ok,
                          road_to, I, D, K, C, B, max_sweeps,
                          road_out != nullptr,
                          static_cast<cudaStream_t>(stream), nullptr);
}

// How many clusters of the cluster form's shape (I, K, C, B), with its
// next roads' staging tile, the card can hold at once
// (cudaOccupancyMaxActiveClusters), into *clusters; 0 means it cannot
// schedule one.  Returns the first CUDA error, or 0.
extern "C" int tarl_primal_cluster_fit(int I, int K, int C, int B,
                                       int* clusters) {
  *clusters = 0;
  return dispatch_cluster(nullptr, nullptr, nullptr, nullptr, nullptr,
                          nullptr, nullptr, I, C, K, C, B, 1, true, nullptr,
                          clusters);
}
